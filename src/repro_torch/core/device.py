"""Device models and device resolution.

PM2Lat is per-device by construction: every device gets its own profiled
throughput tables (``core/calibrate.py``).  The analytical constants below
describe the card the port targets (an H100 SXM, NVIDIA's data sheet) and
are what the kernels' roofline bounds are computed from.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings

import torch

STRICT_DTYPE_ENV = "REPRO_STRICT_DTYPE"


def resolve(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.  Asking for the card
    where there is none raises: nothing silently carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch finds no "
                           f"CUDA device; pass device='cpu' to run on the host")
    return dev


def peak_lookup(peak_flops: dict, dtype: str, owner: str,
                strict: bool | None = None) -> float:
    """Per-dtype peak lookup with a LOUD fallback: an unknown dtype falls back
    to the best peak (usually the low-precision one), which silently inflates
    compute-bound predictions — so warn, and raise when strict (arg or
    REPRO_STRICT_DTYPE=1)."""
    dt = str(dtype)
    if dt in peak_flops:
        return peak_flops[dt]
    if strict is None:
        strict = os.environ.get(STRICT_DTYPE_ENV, "") not in ("", "0")
    msg = (f"{owner}: no peak-FLOPs entry for dtype {dt!r} "
           f"(known: {sorted(peak_flops)})")
    if strict:
        raise KeyError(msg)
    warnings.warn(f"{msg}; falling back to max(peak_flops) — predictions for "
                  f"this dtype may be inflated", stacklevel=3)
    return max(peak_flops.values())


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    peak_flops: dict          # dtype -> FLOP/s per chip
    hbm_bw: float             # bytes/s per chip
    ici_bw: float             # bytes/s per link
    ici_links: int            # links per chip contributing to collectives
    hbm_bytes: int
    vmem_bytes: int           # on-chip memory one kernel block can use
    chips_per_pod: int = 256

    def peak(self, dtype: str, *, strict: bool | None = None) -> float:
        return peak_lookup(self.peak_flops, dtype, f"DeviceModel({self.name})",
                           strict)


# Dense peaks without sparsity at the 700 W limit; float32 is the CUDA-core
# FFMA rate (true f32, what the hand kernels and cuBLAS f32 GEMMs run at).
H100_SXM = DeviceModel(
    name="h100_sxm",
    peak_flops={"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
                "float32": 67e12, "fp8": 1979e12, "int8": 1979e12},
    hbm_bw=3.35e12,
    ici_bw=450e9,
    ici_links=1,
    hbm_bytes=80 * 10 ** 9,
    vmem_bytes=232448,        # 227 KB of shared memory per block
    chips_per_pod=8,
)


def _measure_host_flops(n: int = 512, reps: int = 10,
                        device="cuda") -> float:
    """One-point float32 matmul rate of ``device`` (a fallback default; the
    real per-kernel tables come from core/calibrate.py)."""
    dev = resolve(device)
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    b = torch.ones((n, n), dtype=torch.float32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    a @ b
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        a @ b
    sync()
    dt = (time.perf_counter() - t0) / reps
    return 2 * n ** 3 / dt
