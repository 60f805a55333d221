"""Empirical DeviceProfile of the calibrated device.

Cross-device transfer needs a SOURCE roofline to divide out of the measured
throughputs (``core/transfer.py``).  For the calibrated device that roofline
comes from the calibration itself: peak := best observed matmul throughput
per dtype, bandwidth := the inverse bytes-coefficient of the memory model.
Deriving both from the store keeps the profile consistent with the tables
it anchors, so calibrated-device -> same-device transfer is the identity by
construction.

The sizes that transfer does not read (SM count, memory, L2) come from the
store's ``meta`` where calibration recorded them (``core/calibrate.py`` does
on a card); a store without them gets the JAX package's CPU-host profile.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from repro_torch.core.collectives import DEFAULT_INTERCONNECT
from repro_torch.core.devices.profiles import GiB, KiB, MiB, DeviceProfile
from repro_torch.core.table import TableStore

_FALLBACK_BW = 2e10          # bytes/s
_FALLBACK_PEAK = 5e10


def host_profile_from_store(store: TableStore,
                            name: Optional[str] = None) -> DeviceProfile:
    """Derive the calibrated device's analytical profile from its tables."""
    meta = store.meta or {}
    name = name or meta.get("device") or "cpu_host"
    peaks: Dict[str, float] = {}
    for t in store.tables.values():
        if t.key.op != "matmul" or t.key.device != name:
            continue
        peaks[t.key.dtype] = max(peaks.get(t.key.dtype, 0.0),
                                 max(t.anchors.values()))
    if not peaks:
        peaks = {"float32": _FALLBACK_PEAK}
    mm = store.memory_model
    coef = (mm["coef"] if isinstance(mm, dict)
            else (mm.coef if mm is not None else None))
    bw = 1.0 / coef[0] if coef is not None and coef[0] > 0 else _FALLBACK_BW
    card = "sm_count" in meta
    return DeviceProfile(
        name=name, kind="gpu" if card else "cpu",
        peak_flops=peaks, hbm_bw=bw,
        hbm_bytes=int(meta["hbm_bytes"]) if card else 32 * GiB,
        l2_bytes=int(meta["l2_bytes"]) if card else 32 * MiB,
        smem_bytes=int(meta["smem_bytes"]) if card else 64 * KiB,
        sm_count=int(meta["sm_count"]) if card else os.cpu_count() or 1,
        link_bw=1e9,
        # exactly the unregistered-device default, so collective predictions
        # are identical whether or not the lazy registration in
        # BatchPredictor.host_profile() has run yet
        interconnect=DEFAULT_INTERCONNECT,
        notes="empirical: peaks from matmul anchors, bw from memory-model "
              "bytes coefficient")
