"""Device calibration: run the PM2Lat data-collection pass on a device and
persist the throughput tables + memory model (paper §III-C protocol).

The paper's stance is per-device profiling ("for newer devices we rerun the
full data-collection on the target hardware").  The TableStore schema is
the JAX package's.  Collected kernel families (each a selection-oracle
candidate, core/oracle.py), per dtype:

  - matmul|cublas@<m0>x<n0>         ``torch.matmul`` (cuBLAS on the card),
                                    one table per reference grid
  - bmm|cublas@<b0>x<m0>x<n0>       ``torch.bmm``, one table per grid
  - attention|fa_model              the model's attention entry point
                                    (``kernels.ops.flash_attention``)
  - matmul|mm_<cfg>                 each hand-written matmul config
  - attention|fa_<cfg>              each hand-written flash config
  - memory model                    (utility ops, linear regression)

``fa_model`` is not a kernel of its own: the entry point runs the hand
flash kernel at the config ``select_config`` picks (``fa_128x128`` or
``fa_64x64``), so it is a second profile of that kernel, at the reference's
b*h of 8 (``fa_jnp``'s geometry) where the ``fa_*`` tables use 4.

"float32" tables are true f32: TF32 is switched off for the whole pass.
The hand-kernel tables are profiled only on the card — on the CPU the
wrappers run the kernels' plain versions, which are not the kernels.
"""
from __future__ import annotations

import os
import re
import time
from typing import Iterable, Optional

import torch

from repro_torch.core import memory_model as mm
from repro_torch.core import profiler
from repro_torch.core.device import resolve
from repro_torch.core.table import KernelKey, TableStore, ThroughputTable
from repro_torch.kernels import flash_attention as fkern
from repro_torch.kernels import matmul as mkern
from repro_torch.kernels import ops

DEFAULT_K_ANCHORS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
REF_GRIDS = ((64, 256), (256, 256), (512, 512), (1024, 1024))
BMM_REF_GRIDS = ((8, 256, 256), (32, 64, 64), (2, 512, 512))
BMM_K_ANCHORS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
ATTN_S_ANCHORS = (128, 256, 512, 1024, 2048, 4096)
HAND_MM_K_ANCHORS = (128, 256, 512, 1024, 2048)
HAND_FA_S_ANCHORS = (128, 256, 512, 1024)


def device_name(device="cuda") -> str:
    """Store name of a device: the card's own name, slugged (e.g.
    ``nvidia_h100_80gb_hbm3``), or ``torch_cpu_host`` — never the JAX
    package's ``cpu_host``."""
    dev = resolve(device)
    if dev.type == "cpu":
        return "torch_cpu_host"
    name = torch.cuda.get_device_name(dev)
    return re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")


def card_sizes(device="cuda") -> dict:
    """The card's SM count and memory sizes (bytes) as calibration records
    them in the store's ``meta`` (``devices.host_profile_from_store`` reads
    them back); empty for the CPU."""
    dev = resolve(device)
    if dev.type != "cuda":
        return {}
    p = torch.cuda.get_device_properties(dev)
    return {"sm_count": p.multi_processor_count, "hbm_bytes": p.total_memory,
            "l2_bytes": p.L2_cache_size,
            "smem_bytes": p.shared_memory_per_multiprocessor}


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _table_from_measurements(key, anchors_dur, m0, n0, batch=1,
                             ref_tiles=1) -> ThroughputTable:
    anchors = {k: 2.0 * batch * m0 * n0 * k / d for k, d in anchors_dur.items()}
    k_max = max(anchors_dur)
    return ThroughputTable(key=key, anchors=anchors,
                           org_dur=anchors_dur[k_max], k_max=k_max,
                           ref_grid=(m0, n0), ref_tiles=ref_tiles,
                           ref_batch=batch)


def _attention_table(key, durs, bh, hd) -> ThroughputTable:
    anchors = {s: 4.0 * bh * s * s * hd / d for s, d in durs.items()}
    s_max = max(durs)
    return ThroughputTable(key=key, anchors=anchors, org_dur=durs[s_max],
                           k_max=s_max, ref_grid=(bh * s_max, s_max),
                           ref_tiles=1, ref_head_dim=hd)


def calibrate_matmul(store: TableStore, *, dtype="float32", device="cuda",
                     grids=REF_GRIDS,
                     k_anchors: Iterable[int] = DEFAULT_K_ANCHORS,
                     verbose=False):
    """One table per reference (M0,N0) grid: cuBLAS picks different kernels
    for skinny vs square GEMMs, so each grid regime is its own kernel."""
    dev, dt = resolve(device), _dtype(dtype)
    for m0, n0 in grids:
        durs = {}
        for k in k_anchors:
            a = torch.ones((m0, k), dtype=dt, device=dev)
            b = torch.ones((k, n0), dtype=dt, device=dev)
            durs[k] = profiler.measure(torch.matmul, a, b, device=dev)
            if verbose:
                print(f"  matmul {_dtype_name(dt)} {m0}x{n0} K={k}: "
                      f"{durs[k]*1e3:.3f} ms")
        key = KernelKey("matmul", f"cublas@{m0}x{n0}", _dtype_name(dt),
                        device_name(dev))
        store.add(_table_from_measurements(key, durs, m0, n0))


def calibrate_bmm(store: TableStore, *, dtype="float32", device="cuda",
                  grids=BMM_REF_GRIDS, k_anchors=BMM_K_ANCHORS,
                  verbose=False):
    """One table per (B0, M0, N0) reference grid; the profiled batch is
    recorded as ``ref_batch`` (oracle metadata)."""
    dev, dt = resolve(device), _dtype(dtype)
    for b0, m0, n0 in grids:
        durs = {}
        for k in k_anchors:
            a = torch.ones((b0, m0, k), dtype=dt, device=dev)
            b = torch.ones((b0, k, n0), dtype=dt, device=dev)
            durs[k] = profiler.measure(torch.bmm, a, b, device=dev)
            if verbose:
                print(f"  bmm {_dtype_name(dt)} {b0}x{m0}x{n0} K={k}: "
                      f"{durs[k]*1e3:.3f} ms")
        key = KernelKey("bmm", f"cublas@{b0}x{m0}x{n0}", _dtype_name(dt),
                        device_name(dev))
        store.add(_table_from_measurements(key, durs, m0, n0, batch=b0))


def calibrate_attention(store: TableStore, *, dtype="float32", device="cuda",
                        b0=2, h0=4, hd0=64, s_anchors=ATTN_S_ANCHORS,
                        verbose=False):
    """The model's attention entry point (``fa_model``); swept dim =
    sequence length (the attention analogue of the paper's K sweep)."""
    dev, dt = resolve(device), _dtype(dtype)
    f = lambda q, k, v: ops.flash_attention(q, k, v, causal=True)
    durs = {}
    for s in s_anchors:
        q = torch.ones((b0, s, h0, hd0), dtype=dt, device=dev)
        durs[s] = profiler.measure(f, q, q, q, device=dev)
        if verbose:
            print(f"  fa_model {_dtype_name(dt)} S={s}: {durs[s]*1e3:.3f} ms")
    key = KernelKey("attention", "fa_model", _dtype_name(dt), device_name(dev))
    store.add(_attention_table(key, durs, b0 * h0, hd0))


def calibrate_hand_matmul(store: TableStore, configs=mkern.CONFIGS, *,
                          dtype="float32", device="cuda",
                          k_anchors=HAND_MM_K_ANCHORS, verbose=False):
    """Each hand-written matmul config is its own kernel with its own table
    (kernel differentiation, Table VI).  The reference grid is PROPORTIONAL
    to the block config (2x2 tiles), so the oracle's nearest-grid rule can
    tell the configs apart."""
    dev, dt = resolve(device), _dtype(dtype)
    for cfg in configs:
        m0, n0 = 2 * cfg.bm, 2 * cfg.bn
        f = lambda a, b, cfg=cfg: mkern.matmul_kernel(a, b, cfg)
        durs = {}
        for k in k_anchors:
            kk = (max(k, cfg.bk) // cfg.bk) * cfg.bk
            a = torch.ones((m0, kk), dtype=dt, device=dev)
            b = torch.ones((kk, n0), dtype=dt, device=dev)
            durs[kk] = profiler.measure(f, a, b, device=dev)
            if verbose:
                print(f"  {cfg.name} {_dtype_name(dt)} K={kk}: "
                      f"{durs[kk]*1e3:.3f} ms")
        key = KernelKey("matmul", cfg.name, _dtype_name(dt), device_name(dev))
        tiles = (m0 // cfg.bm) * (n0 // cfg.bn)
        store.add(_table_from_measurements(key, durs, m0, n0, ref_tiles=tiles))


def calibrate_hand_attention(store: TableStore, configs=fkern.CONFIGS, *,
                             dtype="float32", device="cuda",
                             s_anchors=HAND_FA_S_ANCHORS, verbose=False):
    """Each hand-written flash config is its own PM2Lat kernel (Table VI)."""
    dev, dt = resolve(device), _dtype(dtype)
    bh, hd = 4, 64
    for cfg in configs:
        f = lambda q, k, v, cfg=cfg: fkern.flash_attention_kernel(
            q, k, v, cfg, causal=True)
        durs = {}
        for s in s_anchors:
            ss = max(s, cfg.bq, cfg.bk)
            q = torch.ones((bh, ss, hd), dtype=dt, device=dev)
            durs[ss] = profiler.measure(f, q, q, q, device=dev)
            if verbose:
                print(f"  {cfg.name} {_dtype_name(dt)} S={ss}: "
                      f"{durs[ss]*1e3:.3f} ms")
        key = KernelKey("attention", cfg.name, _dtype_name(dt), device_name(dev))
        store.add(_attention_table(key, durs, bh, hd))


def calibrate_memory_model(store: TableStore, *, device="cuda",
                           verbose=False):
    samples = mm.collect_utility_samples(device=device)
    model = mm.fit_memory_model(samples)
    store.memory_model = model.to_json()
    if verbose:
        print(f"  memory model: train rel err {model.train_rel_err:.3f}, "
              f"coef={model.coef}")
    return model


def calibrate_device(path: Optional[str] = None, *, device="cuda",
                     dtypes=("float32", "bfloat16"),
                     verbose: bool = True) -> TableStore:
    """Full calibration pass on ``device``; the hand-kernel tables only on
    a CUDA device."""
    dev = resolve(device)
    t0 = time.time()
    store = TableStore()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dt in dtypes:
            if verbose:
                print(f"[calibrate] matmul/bmm/attention dtype={dt}")
            calibrate_matmul(store, dtype=dt, device=dev, verbose=verbose)
            calibrate_bmm(store, dtype=dt, device=dev, verbose=verbose)
            calibrate_attention(store, dtype=dt, device=dev, verbose=verbose)
            if dev.type == "cuda":
                calibrate_hand_matmul(store, dtype=dt, device=dev,
                                      verbose=verbose)
                calibrate_hand_attention(store, dtype=dt, device=dev,
                                         verbose=verbose)
        if verbose:
            print("[calibrate] memory model")
        calibrate_memory_model(store, device=dev, verbose=verbose)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    store.meta = {"device": device_name(dev), "seconds": time.time() - t0,
                  **card_sizes(dev)}
    if path:
        store.save(path)
    if verbose:
        print(f"[calibrate] done in {store.meta['seconds']:.1f}s -> {path}")
    return store


def artifacts_dir() -> str:
    """The port's artifacts: ``artifacts/torch/`` of the checkout, or
    ``$REPRO_ARTIFACTS/torch``."""
    root = os.environ.get("REPRO_ARTIFACTS",
                          os.path.join(os.path.dirname(__file__), "..", "..",
                                       "..", "artifacts"))
    return os.path.abspath(os.path.join(root, "torch"))


def default_store_path(device="cuda") -> str:
    return os.path.join(artifacts_dir(),
                        f"calibration_{device_name(device)}.json")


def load_or_calibrate(path: Optional[str] = None, *, device="cuda",
                      **kw) -> TableStore:
    path = path or default_store_path(device)
    if os.path.exists(path):
        return TableStore.load(path)
    return calibrate_device(path, device=device, **kw)
