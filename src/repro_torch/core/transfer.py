"""Cross-device table transfer: re-anchor a calibrated ``TableStore`` onto
another device's roofline (paper §III-C's "rerun or re-anchor" protocol,
re-anchor path).  A numpy copy of the JAX package's module.

The paper's first-choice answer to a new device is to rerun the full
data-collection pass on it.  When the target is not attached (fleet
planning, procurement what-ifs, admission control across a heterogeneous
pool) the calibrated tables are rescaled by roofline ratios, per anchor:

    eff      = thr_src(K) / min(peak_src, AI(K) * bw_src)     # src efficiency
    thr_dst(K) = eff      * min(peak_dst, AI(K) * bw_dst)     # dst attainable

``AI(K)`` is the kernel family's arithmetic intensity at anchor ``K`` for
the profiled reference shape.  Three invariants follow:

* **identity** — src == dst reproduces the source table exactly;
* **compute-bound** entries (AI above both knees) scale by the peak-FLOPs
  ratio; **memory-bound** entries (below both) by the bandwidth ratio;
* the **knee is re-derived on the target**: an anchor that is compute-bound
  on the source but memory-bound on the target is clamped by the target's
  ``AI * bw`` leg, not blindly ratio-scaled.

Memory-bound utility ops carry no throughput table; their linear
coefficients rescale directly (bytes ~ 1/bandwidth, flops and
transcendentals ~ 1/peak, intercept = launch overhead kept as measured).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core.collectives import dtype_bytes
from repro_torch.core.devices.profiles import DeviceProfile
from repro_torch.core.memory_model import MemoryModel
from repro_torch.core.table import TableStore, ThroughputTable


def arithmetic_intensity(t: ThroughputTable, k: int) -> float:
    """FLOP/byte of table ``t``'s reference op at sweep position ``k``.

    matmul/bmm: the profiled batch of (M0, N0) x K GEMMs (``ref_batch``
    repeats every operand, so intensity is the single-GEMM value).
    attention: flash attention streams K/V once, so intensity grows linearly
    with the swept sequence length — ``O(s)`` FLOPs per byte moved.
    """
    isz = dtype_bytes(t.key.dtype)
    if t.key.op in ("matmul", "bmm"):
        m0, n0 = t.ref_grid
        b0 = t.ref_batch
        flops = 2.0 * b0 * m0 * n0 * k
        byts = isz * b0 * (m0 * k + k * n0 + m0 * n0)
        return flops / byts
    # attention (and any future swept family): seq-linear intensity
    return float(k) / isz


def transfer_table(t: ThroughputTable, src: DeviceProfile,
                   dst: DeviceProfile) -> ThroughputTable:
    """Re-anchor one throughput table from ``src`` onto ``dst``."""
    key = dataclasses.replace(t.key, device=dst.name)
    if src == dst:
        return dataclasses.replace(t, key=key, anchors=dict(t.anchors))
    dtype = t.key.dtype
    anchors = {}
    for k, thr in t.anchors.items():
        ai = arithmetic_intensity(t, k)
        eff = thr / src.roofline_throughput(ai, dtype)
        anchors[k] = eff * dst.roofline_throughput(ai, dtype)
    org_dur = t.org_dur * (t.anchors[t.k_max] / anchors[t.k_max])
    return dataclasses.replace(t, key=key, anchors=anchors, org_dur=org_dur)


def _ratio_dtype(src: DeviceProfile, dst: DeviceProfile,
                 prefer: str = "float32") -> str:
    """Dtype whose peak ratio scales the utility-op compute coefficients:
    float32 when both sides quote it (the dtype the memory model is fit on),
    else any dtype both sides quote — never a fallback peak on one side
    against a genuine one on the other."""
    shared = set(src.peak_flops) & set(dst.peak_flops)
    if prefer in shared or not shared:
        return prefer
    return sorted(shared)[0]


def transfer_memory_model(mm: Union[dict, MemoryModel], src: DeviceProfile,
                          dst: DeviceProfile, *,
                          dtype: Optional[str] = None) -> dict:
    """Rescale the utility-op linear model: features are [bytes, flops,
    transcendentals, 1], so each coefficient is seconds-per-unit on the
    SOURCE — divide out the source rate, multiply in the target's.  The
    intercept is per-kernel launch overhead, kept as measured."""
    d = mm.to_json() if isinstance(mm, MemoryModel) else dict(mm)
    if src == dst:
        return d
    dtype = dtype or _ratio_dtype(src, dst)
    bw_ratio = src.hbm_bw / dst.hbm_bw
    pk_ratio = src.peak(dtype) / dst.peak(dtype)
    scale = (bw_ratio, pk_ratio, pk_ratio, 1.0)

    def _scale(coef):
        return [c * s for c, s in zip(coef, scale)]

    d["coef"] = _scale(d["coef"])
    if d.get("class_coef"):
        d["class_coef"] = {cls: _scale(c) for cls, c in d["class_coef"].items()}
    if d.get("cache"):
        # the L2 correction re-anchors structurally: hit rate and speedup
        # travel, the capacity knee moves to the TARGET's L2 size; a target
        # with no (or unknown) L2 drops the correction
        if dst.l2_bytes > 0:
            d["cache"] = {**d["cache"], "l2_bytes": float(dst.l2_bytes)}
        else:
            d.pop("cache")
    return d


def transfer_store(store: TableStore, src: DeviceProfile,
                   dst: DeviceProfile) -> TableStore:
    """Re-anchor every table (and the memory model) onto ``dst``.  Only
    tables calibrated on ``src`` move; tables keyed to other devices are
    dropped (one store == one device, as in calibration)."""
    out = TableStore()
    for t in store.tables.values():
        if t.key.device != src.name:
            continue
        out.add(transfer_table(t, src, dst))
    if store.memory_model is not None:
        out.memory_model = transfer_memory_model(store.memory_model, src, dst)
    out.meta = {**(store.meta or {}), "device": dst.name,
                "transferred_from": src.name, "transfer": "roofline-ratio"}
    return out
