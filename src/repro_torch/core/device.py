"""Device resolution and the per-dtype peak lookup.

PM2Lat is per-device by construction: every device gets its own profiled
throughput tables (``core/calibrate.py``).  The analytical datasheets of
the card the port targets and of the rest of the fleet are the
``DeviceProfile``s in ``core/devices/profiles.py``.
"""
from __future__ import annotations

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
