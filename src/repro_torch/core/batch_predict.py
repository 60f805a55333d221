"""Vectorized batch-prediction engine + prediction cache (paper §IV-D2).

``PM2Lat`` (``core/predictor.py``) predicts one op at a time; that is fine
for a single model report but orders of magnitude too slow for the paper's
flagship application — precomputing a latency cache over a NAS grid of
hundreds of millions of configs (``core/nas.py``) — and for the search
loops behind partition planning and serving admission control.
``BatchPredictor`` vectorizes every op family over numpy arrays:

* **matmul / bmm** — the kernel-selection oracle (``core/oracle.py``,
  shared with the scalar predictor) scored for all configs at once against
  the stacked metadata of every profiled reference grid, then Eq(2)/Eq(1)
  interpolation evaluated per selected table with masked numpy ops.
* **attention** — the same oracle selects among the profiled attention
  kernels per (skv, head_dim); Eq(2) piecewise-linear interpolation over
  ``skv`` is evaluated for all configs at once, then ``flops / throughput``.
* **memory-bound ops** — one matrix product of the stacked proxy-feature
  rows through the per-class ``MemoryModel`` linear coefficients.
* **collectives** — one α–β evaluation per collective type
  (``core/collectives.py``).

``predict_model_grid`` enumerates the op graph ONCE symbolically — a numpy
mirror of ``opgraph.enumerate_ops`` whose shape arithmetic takes ``batch``
and ``seq`` as arrays — and broadcasts the vectorized families over the
full (batch, seq) grid.  Memory-bound ops keep the scalar path's EXACT
proxy features, counted by ``core/cost.py`` on meta tensors per unique
(snippet, shape, dtype): the first sweep over new shapes pays that count,
later sweeps are pure numpy (``_feat_cache``).

``PredictionCache`` is an LRU + JSON-persistent prediction cache keyed on
``(model, device, dtype, batch, seq)``; ``predict_model_cached`` sits on
top of it.

Parallel, training-step, strategy-sweep and serving-table prediction go
through ``core/schedule.py``, priced by this engine.  Every vectorized path
reproduces the scalar predictor's floating-point operation ORDER, so
results match ``PM2Lat.predict_op`` to ~ulp, and the JAX package's engine
bit for bit on the same store and feature rows.  The JAX engine's
spec-keyed, dict-valued cache entries and its multi-dtype model grid serve
only its latency service, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import base as C
from repro_torch.core import collectives as CC
from repro_torch.core import devices as D
from repro_torch.core import opgraph as og
from repro_torch.core import oracle as O
from repro_torch.core.memory_model import class_of, feature_vector
from repro_torch.core.predictor import PM2Lat, PredictionRow
from repro_torch.core.table import TableStore, ThroughputTable
from repro_torch.core.transfer import transfer_store
from repro_torch.models.layers import is_gated, pad_vocab


def _f64(x):
    return np.asarray(x, np.float64)


class _TableInterp:
    """Anchor arrays for one ``ThroughputTable`` + vectorized Eq(1)/Eq(2)
    with the scalar code's exact branch structure (clamp at both anchor
    ends, left-closed segment selection)."""

    def __init__(self, t: ThroughputTable):
        self.t = t
        self.ks = np.array(sorted(t.anchors), dtype=np.float64)
        self.thr = np.array([t.anchors[int(k)] for k in self.ks])
        self.org_thr = t.anchors[t.k_max]
        m0, n0 = t.ref_grid
        self.ref_area = float(m0 * n0 * t.ref_batch)

    def throughput(self, k) -> np.ndarray:
        """``ThroughputTable.interpolate_throughput``, vectorized."""
        k = _f64(k)
        j = np.searchsorted(self.ks, k, side="left").clip(1, len(self.ks) - 1)
        k1, k3 = self.ks[j - 1], self.ks[j]
        t1, t3 = self.thr[j - 1], self.thr[j]
        out = (k - k1) / (k3 - k1) * (t3 - t1) + t1
        out = np.where(k <= self.ks[0], self.thr[0], out)
        return np.where(k >= self.ks[-1], self.thr[-1], out)

    def predict(self, m, n, k, batch=1) -> np.ndarray:
        """``ThroughputTable.predict`` (XLA-chosen-tile path), vectorized.
        The one-full-tile floor mirrors the scalar path in lockstep (the
        paper's partial-block rule: sub-reference shapes never cost a
        fraction of the reference wave)."""
        m, n, k = _f64(m), _f64(n), _f64(k)
        dur_ref = (self.t.org_dur * (k / self.t.k_max)
                   * (self.org_thr / self.throughput(k)))
        tiles_new = m * n * _f64(batch) / self.ref_area
        return dur_ref * np.maximum(tiles_new, 1.0)


# ---------------------------------------------------------------------------
# Symbolic grid op graph: opgraph.enumerate_ops with (batch, seq) as arrays
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _GMat:
    name: str
    kind: str                    # 'matmul' | 'bmm'
    m: object
    n: object
    k: object
    batch: object = 1
    count: object = 1
    dtype: str = "float32"


@dataclasses.dataclass
class _GAttn:
    name: str
    flops: object                # already includes count (as AttentionOp.flops)
    skv: object
    dtype: str = "float32"
    hd: object = None            # head dim (kernel-selection oracle input)


@dataclasses.dataclass
class _GMem:
    name: str
    snippet: str
    shape: tuple                 # entries: int or (G,) int array
    count: object = 1
    dtype: str = "float32"


def enumerate_grid_ops(cfg: C.ModelConfig, batch: np.ndarray, seq: np.ndarray,
                       dtype: Optional[str] = None) -> List:
    """Numpy mirror of ``opgraph.enumerate_ops``: same op list, same shape
    arithmetic (including the MoE capacity floor and the mLSTM chunking),
    with every batch/seq-dependent field an array over the grid.  Kept in
    lockstep with the scalar enumeration by the all-arch equivalence tests
    in tests/test_torch_batch_predict.py."""
    b = np.asarray(batch, np.int64)
    s = np.asarray(seq, np.int64)
    dt = dtype or "float32"
    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)
    T = b * s
    Vp = pad_vocab(cfg.vocab_size)
    ops: List = [_GMem("embed", "embed_gather", (Vp, d), 1, dt)]
    kind_counts = Counter(cfg.layer_kinds)

    def attn_flops(bt, heads, sq, skv, hdim, count):
        return 4.0 * _f64(bt) * heads * _f64(sq) * _f64(skv) * hdim * count

    def attn_ops(n_layers: int, kind: str, prefix: str):
        skv = s  # full-seq masked (flash path), as in the scalar enumeration
        return [
            _GMem(f"{prefix}.ln", "rmsnorm", (T, d), n_layers, dt),
            _GMat(f"{prefix}.wq", "matmul", T, hq * hd, d, 1, n_layers, dt),
            _GMat(f"{prefix}.wk", "matmul", T, hkv * hd, d, 1, n_layers, dt),
            _GMat(f"{prefix}.wv", "matmul", T, hkv * hd, d, 1, n_layers, dt),
            _GMem(f"{prefix}.rope", "rope", (T, hq, hd), n_layers, dt),
            _GAttn(f"{prefix}.attn", attn_flops(b, hq, s, skv, hd, n_layers),
                   skv, dt, hd=hd),
            _GMat(f"{prefix}.wo", "matmul", T, d, hq * hd, 1, n_layers, dt),
            _GMem(f"{prefix}.residual", "add", (T, d), n_layers, dt),
        ]

    def _mlp_ops(prefix: str, n_layers: int, dff: int):
        gated = is_gated(cfg.mlp_act)
        return [
            _GMat(f"{prefix}.w_in", "matmul", T, dff, d, 1,
                  n_layers * (2 if gated else 1), dt),
            _GMem(f"{prefix}.act", "silu_mul" if gated else "gelu",
                  (T, dff), n_layers, dt),
            _GMat(f"{prefix}.w_out", "matmul", T, d, dff, 1, n_layers, dt),
            _GMem(f"{prefix}.residual", "add", (T, d), n_layers, dt),
        ]

    def ffn_ops(n_layers: int, prefix: str):
        out = [_GMem(f"{prefix}.ln2", "rmsnorm", (T, d), n_layers, dt)]
        if cfg.moe is not None:
            m = cfg.moe
            G = b
            Sg = T // G
            cap = np.maximum(
                np.floor(m.capacity_factor * _f64(Sg) * m.top_k
                         / m.num_experts).astype(np.int64),
                max(m.top_k, 4))
            gated = is_gated(cfg.mlp_act)
            out += [
                _GMat(f"{prefix}.router", "matmul", T, m.num_experts, d, 1,
                      n_layers, dt),
                _GMem(f"{prefix}.gate", "softmax", (T, m.num_experts),
                      n_layers, dt),
                _GMat(f"{prefix}.dispatch", "bmm", m.num_experts * cap, d, Sg,
                      G, n_layers, dt),
                _GMat(f"{prefix}.expert_in", "bmm", cap, m.d_ff_expert, d,
                      G * m.num_experts, n_layers * (2 if gated else 1), dt),
                _GMem(f"{prefix}.expert_act", "silu_mul",
                      (G * m.num_experts * cap, m.d_ff_expert), n_layers, dt),
                _GMat(f"{prefix}.expert_out", "bmm", cap, d, m.d_ff_expert,
                      G * m.num_experts, n_layers, dt),
                _GMat(f"{prefix}.combine", "bmm", Sg, d, m.num_experts * cap,
                      G, n_layers, dt),
            ]
            for i in range(m.num_shared_experts):
                out += _mlp_ops(f"{prefix}.shared{i}", n_layers, m.d_ff_expert)
        elif ff > 0:
            out += _mlp_ops(prefix, n_layers, ff)
        return out

    for kind, n in sorted(kind_counts.items()):
        if kind in (C.ATTN, C.LOCAL_ATTN):
            ops += attn_ops(n, kind, kind)
            ops += ffn_ops(n, kind)
        elif kind == C.CROSS_ATTN:
            ops += attn_ops(n, C.ATTN, "self")
            Lx = cfg.cross_attn_context_len or (
                cfg.encoder.n_frames if cfg.encoder else 0)
            Tx = b * Lx
            ops += [
                _GMat("cross.wq", "matmul", T, hq * hd, d, 1, n, dt),
                _GMat("cross.wk", "matmul", Tx, hkv * hd, d, 1, n, dt),
                _GMat("cross.wv", "matmul", Tx, hkv * hd, d, 1, n, dt),
                _GAttn("cross.attn", attn_flops(b, hq, s, Lx, hd, n), Lx, dt,
                       hd=hd),
                _GMat("cross.wo", "matmul", T, d, hq * hd, 1, n, dt),
            ]
            ops += ffn_ops(n, "decoder")
        elif kind == C.RGLRU:
            dl = cfg.lru_dim or d
            ops += [
                _GMem("rglru.ln", "rmsnorm", (T, d), n, dt),
                _GMat("rglru.wx", "matmul", T, dl, d, 1, 2 * n, dt),
                _GMem("rglru.conv", "conv1d4", (b, s, dl), n, dt),
                _GMat("rglru.gates", "matmul", T, dl, dl, 1, 2 * n, dt),
                _GMem("rglru.scan", "assoc_scan", (b, s, dl), n, dt),
                _GMem("rglru.gate_mul", "silu_mul", (T, dl), n, dt),
                _GMat("rglru.w_out", "matmul", T, d, dl, 1, n, dt),
            ]
            ops += ffn_ops(n, "rglru")
        elif kind == C.MLSTM:
            di = 2 * d
            hdm = di // hq
            chunk = np.minimum(128, s)
            nC = np.maximum(s // chunk, 1)
            ops += [
                _GMem("mlstm.ln", "rmsnorm", (T, d), n, dt),
                _GMat("mlstm.up", "matmul", T, 2 * di, d, 1, n, dt),
                _GMem("mlstm.conv", "conv1d4", (b, s, di), n, dt),
                _GMat("mlstm.qkv", "matmul", T, di, di, 1, 3 * n, dt),
                _GAttn("mlstm.intra",
                       attn_flops(b * nC, hq, chunk, chunk, hdm, n), chunk, dt,
                       hd=hdm),
                _GMat("mlstm.state", "bmm", hdm, hdm, chunk, b * nC * hq,
                      2 * n, dt),
                _GMem("mlstm.gate", "silu_mul", (T, di), n, dt),
                _GMat("mlstm.down", "matmul", T, d, di, 1, n, dt),
            ]
        elif kind == C.SLSTM:
            ops += [
                _GMem("slstm.ln", "rmsnorm", (T, d), n, dt),
                _GMat("slstm.wx", "matmul", T, 4 * d, d, 1, n, dt),
                _GMat("slstm.rh", "matmul", b, 4 * d, d, 1, n * s, dt),
                _GMem("slstm.scan", "seq_scan", (b, s, 4 * d), n, dt),
            ]
            ops += _mlp_ops("slstm.ff", n, og.slstm_ff(cfg))
        elif kind == C.ENC_ATTN:
            ops += attn_ops(n, C.ENC_ATTN, "enc")
            ops += ffn_ops(n, "enc")

    if cfg.encoder is not None:
        Tx = b * cfg.encoder.n_frames
        n = cfg.encoder.n_layers
        ops += [
            _GMem("enc.ln", "rmsnorm", (Tx, d), 2 * n, dt),
            _GMat("enc.qkvo", "matmul", Tx, d, d, 1, 4 * n, dt),
            _GAttn("enc.attn",
                   attn_flops(b, hq, cfg.encoder.n_frames,
                              cfg.encoder.n_frames, hd, n),
                   cfg.encoder.n_frames, dt, hd=hd),
        ]
        ops += _mlp_ops("enc.ff", n, ff)

    ops += [
        _GMem("final_norm", "rmsnorm", (T, d), 1, dt),
        _GMat("unembed", "matmul", T, Vp, d, 1, 1, dt),
    ]
    return ops


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class BatchPredictor:
    """All-op-family vectorized PM2Lat.  Drop-in for the scalar predictor's
    ``predict_ops`` / ``predict_model`` / ``predict_blocks`` interfaces, plus
    grid prediction (``predict_model_grid``, ``predict_decode_grid``),
    cached queries (``predict_model_cached``) and the device fleet
    (``for_device``)."""

    def __init__(self, store: TableStore, device: str,
                 cache: Optional["PredictionCache"] = None):
        self.store = store
        self.device = device
        self.scalar = PM2Lat(store, device)
        # THE oracle: the same instance the scalar path dispatches through,
        # so candidate order, scoring, dtype fallback, and warn-once state
        # are shared — batch==scalar equivalence includes kernel selection.
        self.oracle = self.scalar.oracle
        self.memory_model = self.scalar.memory_model
        self.cache = cache
        self._interp: Dict[str, _TableInterp] = {}
        # proxy-feature rows keyed (snippet, shape, dtype): persists across
        # grid sweeps so steady-state cost never depends on (and cannot
        # thrash) opgraph._snippet_features' bounded lru_cache
        self._feat_cache: Dict[tuple, np.ndarray] = {}
        # fleet: derived predictors over roofline-transferred stores,
        # one per target device (core/transfer.py), built lazily
        self._fleet: Dict[str, "BatchPredictor"] = {}
        self._host_prof = None

    # ----- device fleet -----
    def host_profile(self):
        """This store's empirical DeviceProfile (transfer source), registered
        fleet-wide so the host is addressable by name like any target."""
        if self._host_prof is None:
            self._host_prof = D.register(
                D.host_profile_from_store(self.store, self.device),
                overwrite=True)
        return self._host_prof

    def for_device(self, device: Optional[str]) -> "BatchPredictor":
        """The predictor answering for ``device``: ``self`` for the host
        (None or this store's own device — the golden, bit-identical path),
        else a derived predictor over the roofline-transferred store.  The
        shared ``PredictionCache`` keeps per-device entries apart because
        every key is fingerprinted with the answering predictor's device."""
        if device is None or device == self.device:
            return self
        derived = self._fleet.get(device)
        if derived is None:
            dst = D.get_profile(device)
            store = transfer_store(self.store, self.host_profile(), dst)
            derived = BatchPredictor(store, dst.name, cache=self.cache)
            # share the proxy-feature rows: the counted features are
            # device-independent inputs to the (rescaled) memory model
            derived._feat_cache = self._feat_cache
            self._fleet[device] = derived
        return derived

    # ----- table plumbing -----
    def _table_interp(self, t: ThroughputTable) -> _TableInterp:
        key = t.key.id()
        if key not in self._interp:
            self._interp[key] = _TableInterp(t)
        return self._interp[key]

    # ----- vectorized op families -----
    def _matmul_select(self, m, n, batch, *, dtype: str, kind: str
                       ) -> Tuple[List[ThroughputTable], np.ndarray]:
        """Vectorized oracle selection: the shared candidate enumeration and
        scoring from ``core/oracle.py`` applied to flat config arrays.
        Returns ``(candidates, selected_index_per_config)``."""
        cands, _ = self.oracle.candidates_with_fallback(kind, dtype)
        scores = O.score_matmul(cands, m, n, batch)
        return cands, np.argmin(scores, axis=0)   # first-wins, as the scalar

    def predict_matmul_batch(self, m, n, k, batch=1, count=1, *,
                             dtype: str = "float32", kind: str = "matmul",
                             kernel: Optional[str] = None,
                             return_kernels: bool = False) -> np.ndarray:
        """Seconds for a batch of matmul/bmm configs (broadcastable args).
        Without an explicit ``kernel``, the shared kernel-selection oracle
        picks the profiled reference grid per config (matmul AND bmm).
        ``return_kernels=True`` additionally returns the selected kernel id
        per config (object array, same shape)."""
        m, n, k, batch, count = np.broadcast_arrays(
            _f64(m), _f64(n), _f64(k), _f64(batch), _f64(count))
        shape = m.shape
        m, n, k, batch, count = (a.ravel() for a in (m, n, k, batch, count))
        if kernel is not None:
            t = self.oracle.lookup(kind, kernel, dtype)
            out = (self._table_interp(t).predict(m, n, k, batch)
                   * count).reshape(shape)
            if return_kernels:
                return out, np.full(shape, t.key.kernel, object)
            return out
        cands, sel = self._matmul_select(m, n, batch, dtype=dtype, kind=kind)
        out = np.empty(m.size)
        kernels = np.empty(m.size, object) if return_kernels else None
        for i, t in enumerate(cands):
            mask = sel == i
            if mask.any():
                out[mask] = self._table_interp(t).predict(
                    m[mask], n[mask], k[mask], batch[mask])
                if kernels is not None:
                    kernels[mask] = t.key.kernel
        out = (out * count).reshape(shape)
        if return_kernels:
            return out, kernels.reshape(shape)
        return out

    def predict_attention_batch(self, skv, flops, hd=None, *,
                                dtype: str = "float32",
                                kernel: Optional[str] = None,
                                return_kernels: bool = False) -> np.ndarray:
        """Seconds for a batch of attention configs.  ``flops`` must already
        include the per-op repetition count (as ``AttentionOp.flops`` does).
        Without an explicit ``kernel``, the shared oracle selects the
        profiled attention kernel per (skv, head_dim)."""
        skv, flops = np.broadcast_arrays(_f64(skv), _f64(flops))
        shape = skv.shape
        skv, flops = skv.ravel(), flops.ravel()
        if hd is not None:
            hd = np.broadcast_to(_f64(hd), shape).ravel()
        if kernel is not None:
            t = self.oracle.lookup("attention", kernel, dtype)
            out = (flops / self._table_interp(t).throughput(skv)
                   ).reshape(shape)
            if return_kernels:
                return out, np.full(shape, t.key.kernel, object)
            return out
        cands, _ = self.oracle.candidates_with_fallback("attention", dtype)
        sel = np.argmin(O.score_attention(cands, skv, hd), axis=0)
        out = np.empty(skv.size)
        kernels = np.empty(skv.size, object) if return_kernels else None
        for i, t in enumerate(cands):
            mask = sel == i
            if mask.any():
                out[mask] = (flops[mask]
                             / self._table_interp(t).throughput(skv[mask]))
                if kernels is not None:
                    kernels[mask] = t.key.kernel
        out = out.reshape(shape)
        if return_kernels:
            return out, kernels.reshape(shape)
        return out

    def predict_decode_attention_batch(self, ops: Sequence,
                                       return_kernels: bool = False
                                       ) -> np.ndarray:
        """Seconds for a batch of DECODE-phase ``AttentionOp``s.  At sq=1 the
        kernel streams the KV cache, so the op is memory-bound and flops-based
        table pricing collapses — price through the memory model over the
        analytic KV-read traffic instead (class ``softmax``), mirroring
        ``PM2Lat.predict_decode_attention``.  The kernel id surfaces the GQA
        ratio (``kv_read@gqaN``) that sets the byte traffic."""
        if not ops:
            out = np.zeros(0)
            return (out, np.zeros(0, object)) if return_kernels else out
        X = self.memory_model.apply_cache(
            np.stack([feature_vector(og.decode_attention_features(op))
                      for op in ops]))
        coef = self._memory_coef("softmax")
        secs = (X * coef).sum(axis=1)
        if return_kernels:
            kernels = np.array(
                [f"kv_read@gqa{max(1, op.heads // max(1, op.kv_heads))}"
                 for op in ops], object)
            return secs, kernels
        return secs

    def _memory_coef(self, snippet: str) -> np.ndarray:
        mmod = self.memory_model
        cls = class_of(snippet)
        if mmod.class_coef and cls in mmod.class_coef:
            return np.asarray(mmod.class_coef[cls])
        return np.asarray(mmod.coef)

    def _feature_row(self, snippet: str, shape: tuple, dtype: str) -> np.ndarray:
        fkey = (snippet, tuple(shape), dtype)
        row = self._feat_cache.get(fkey)
        if row is None:
            row = feature_vector(og._snippet_features(snippet, tuple(shape),
                                                      dtype))
            self._feat_cache[fkey] = row
        return row

    def predict_memory_batch(self, ops: Sequence) -> np.ndarray:
        """Seconds for a batch of ``MemoryOp``s: one stacked feature-matrix
        product through the per-class linear coefficients."""
        if not ops:
            return np.zeros(0)
        X = self.memory_model.apply_cache(
            np.stack([self._feature_row(op.snippet, op.shape, op.dtype)
                      for op in ops]))
        Cm = np.stack([self._memory_coef(op.snippet) for op in ops])
        counts = np.array([op.count for op in ops], np.float64)
        return (X * Cm).sum(axis=1) * counts

    @property
    def interconnect(self):
        """This device's α–β interconnect (``core/collectives.py``), shared
        with the scalar path so both price collectives identically."""
        return self.scalar.interconnect

    @property
    def cache_device(self) -> str:
        """The device field of every cache key this predictor writes: the
        bare device name (comm calibration, which would tag it, is not
        ported)."""
        return self.device

    def predict_collective_batch(self, ops: Sequence,
                                 return_algos: bool = False) -> np.ndarray:
        """Seconds for a batch of ``CollectiveOp``s of the SAME collective
        type: one vectorized α–β evaluation per group, ring/tree selected
        per entry.  ``return_algos=True`` additionally returns the selected
        algorithm per op (the collective rows' kernel attribution)."""
        if not ops:
            out = np.zeros(0)
            return (out, np.zeros(0, object)) if return_algos else out
        coll = ops[0].coll
        assert all(o.coll == coll for o in ops), [o.coll for o in ops]
        nbytes = np.array([o.nbytes for o in ops], np.float64)
        world = np.array([o.world for o in ops], np.float64)
        counts = np.array([o.count for o in ops], np.float64)
        secs, algos = CC.collective_time(coll, nbytes, world,
                                         self.interconnect)
        secs = secs * counts
        return (secs, algos) if return_algos else secs

    # ----- op-list interface (drop-in for PM2Lat) -----
    def _predict_ops_arrays(self, ops: Sequence
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized per-op ``(seconds, selected kernel id)``, aligned with
        ``ops`` — kernel ids come from the shared oracle, matching the
        scalar predictor's ``PredictionRow.kernel`` attribution."""
        secs = np.zeros(len(ops))
        kernels = np.full(len(ops), "linreg", object)
        groups: Dict[tuple, List[int]] = {}
        for i, op in enumerate(ops):
            # dispatch over the real Op union (opgraph.Op), not duck-typed
            # kind strings
            if isinstance(op, og.MatmulOp):
                groups.setdefault(("mm", op.kind, op.dtype), []).append(i)
            elif isinstance(op, og.AttentionOp):
                if op.phase == og.DECODE:
                    groups.setdefault(("dattn",), []).append(i)
                else:
                    groups.setdefault(("attn", op.dtype), []).append(i)
            elif isinstance(op, CC.CollectiveOp):
                groups.setdefault(("coll", op.coll), []).append(i)
            else:
                groups.setdefault(("mem",), []).append(i)
        for gkey, idx in groups.items():
            sub = [ops[i] for i in idx]
            if gkey[0] == "mm":
                _, kind, dtype = gkey
                secs[idx], kernels[idx] = self.predict_matmul_batch(
                    [o.m for o in sub], [o.n for o in sub], [o.k for o in sub],
                    [o.batch for o in sub], [o.count for o in sub],
                    dtype=dtype, kind=kind, return_kernels=True)
            elif gkey[0] == "attn":
                secs[idx], kernels[idx] = self.predict_attention_batch(
                    [o.skv for o in sub], [o.flops for o in sub],
                    [o.hd for o in sub], dtype=gkey[1], return_kernels=True)
            elif gkey[0] == "dattn":
                secs[idx], kernels[idx] = self.predict_decode_attention_batch(
                    sub, return_kernels=True)
            elif gkey[0] == "coll":
                secs[idx], kernels[idx] = self.predict_collective_batch(
                    sub, return_algos=True)
            else:
                secs[idx] = self.predict_memory_batch(sub)
        return secs, kernels

    def predict_ops_seconds(self, ops: Sequence) -> np.ndarray:
        """Vectorized per-op seconds, aligned with ``ops``."""
        return self._predict_ops_arrays(ops)[0]

    def predict_ops(self, ops: Sequence) -> Tuple[float, List[PredictionRow]]:
        secs, kernels = self._predict_ops_arrays(ops)
        rows = []
        for op, sec, kern in zip(ops, secs, kernels):
            kind = op.kind if isinstance(op, (og.MatmulOp, og.AttentionOp,
                                              CC.CollectiveOp)) else "memory"
            rows.append(PredictionRow(op.name, kind, float(sec), str(kern)))
        return sum(r.seconds for r in rows), rows

    def predict_model(self, cfg: C.ModelConfig, batch: int, seq: int,
                      dtype: Optional[str] = None,
                      device: Optional[str] = None):
        if device is not None and device != self.device:
            return self.for_device(device).predict_model(cfg, batch, seq,
                                                         dtype=dtype)
        ops = og.enumerate_ops(cfg, batch, seq, dtype=dtype)
        return self.predict_ops(ops)

    def predict_parallel(self, cfg: C.ModelConfig, batch: int, seq: int,
                         spec: og.ParallelismSpec,
                         dtype: Optional[str] = None,
                         device: Optional[str] = None):
        """Schedule-aware end-to-end prediction under a ``ParallelismSpec``
        (the vectorized twin of ``PM2Lat.predict_parallel``): the makespan
        of the list schedule over the sharded compute ops plus the induced
        collectives, and its rows."""
        sched = self.schedule_parallel(cfg, batch, seq, spec, dtype=dtype,
                                       device=device)
        return sched.makespan, sched.rows

    def schedule_parallel(self, cfg: C.ModelConfig, batch: int, seq: int,
                          spec: og.ParallelismSpec,
                          dtype: Optional[str] = None,
                          device: Optional[str] = None):
        """The full ``Schedule`` (timeline + busy/exposed splits) behind
        ``predict_parallel``."""
        if device is not None and device != self.device:
            return self.for_device(device).schedule_parallel(
                cfg, batch, seq, spec, dtype=dtype)
        from repro_torch.core import schedule as S
        return S.schedule_parallel(self, cfg, batch, seq, spec, dtype=dtype)

    def predict_step(self, cfg: C.ModelConfig, batch: int, seq: int,
                     spec: Optional[og.ParallelismSpec] = None, train=None,
                     dtype: Optional[str] = None,
                     device: Optional[str] = None):
        """One training step (fwd + bwd + gradient comm + optimizer
        update) priced as the schedule makespan: the vectorized twin of
        ``PM2Lat.predict_step``."""
        sched = self.schedule_step(cfg, batch, seq, spec=spec, train=train,
                                   dtype=dtype, device=device)
        return sched.makespan, sched.rows

    def schedule_step(self, cfg: C.ModelConfig, batch: int, seq: int,
                      spec: Optional[og.ParallelismSpec] = None, train=None,
                      dtype: Optional[str] = None,
                      device: Optional[str] = None):
        """The full training-step ``Schedule`` behind ``predict_step``."""
        if device is not None and device != self.device:
            return self.for_device(device).schedule_step(
                cfg, batch, seq, spec=spec, train=train, dtype=dtype)
        from repro_torch.core import schedule as S
        return S.schedule_step(self, cfg, batch, seq, spec=spec, train=train,
                               dtype=dtype)

    def sweep_strategies(self, cfg: C.ModelConfig, batch: int, seq: int,
                         specs: Sequence[og.ParallelismSpec], *,
                         train=None, dtype: Optional[str] = None,
                         hbm_bytes: Optional[float] = None,
                         device: Optional[str] = None):
        """Price many parallelism strategies in one vectorized pass
        (``schedule.sweep_strategies``): unique op components enumerated
        once, priced through one ``predict_ops_seconds`` call, and
        simulated per structural template by the batched list schedule.
        ``train`` (None | TrainingStepSpec | per-spec sequence) switches to
        training steps; ``hbm_bytes`` adds the ``feasible`` mask against
        the peak-memory column."""
        if device is not None and device != self.device:
            return self.for_device(device).sweep_strategies(
                cfg, batch, seq, specs, train=train, dtype=dtype,
                hbm_bytes=hbm_bytes)
        from repro_torch.core import schedule as S
        return S.sweep_strategies(self, cfg, batch, seq, specs, train=train,
                                  dtype=dtype, hbm_bytes=hbm_bytes)

    def predict_blocks(self, cfg: C.ModelConfig, batch: int, seq: int,
                       dtype: Optional[str] = None,
                       device: Optional[str] = None) -> List[float]:
        """Per-transformer-block latencies from ONE vectorized pass over the
        concatenated per-block op lists (the partition planner's input)."""
        if device is not None and device != self.device:
            return self.for_device(device).predict_blocks(cfg, batch, seq,
                                                          dtype=dtype)
        all_ops, seg = [], []
        for li, kind in enumerate(cfg.layer_kinds):
            one = dataclasses.replace(cfg, n_layers=1, block_pattern=(kind,))
            block_ops = og.enumerate_ops(one, batch, seq, dtype=dtype)
            block_ops = [o for o in block_ops
                         if o.name not in ("embed", "unembed", "final_norm")]
            all_ops += block_ops
            seg += [li] * len(block_ops)
        secs = self.predict_ops_seconds(all_ops)
        per = [0.0] * len(cfg.layer_kinds)
        for li, sec in zip(seg, secs):
            per[li] += float(sec)
        return per

    # ----- grid interface -----
    def predict_grid_ops(self, gops: Sequence, G: int) -> np.ndarray:
        """Total seconds per grid point for a symbolic op list."""
        total = np.zeros(G)
        # matmul family: one oracle call per (kind, dtype) over (n_ops, G)
        groups: Dict[tuple, List[_GMat]] = {}
        for op in gops:
            if isinstance(op, _GMat):
                groups.setdefault((op.kind, op.dtype), []).append(op)
        for (kind, dtype), sub in groups.items():
            stack = lambda attr: np.stack(
                [np.broadcast_to(_f64(getattr(o, attr)), (G,)) for o in sub])
            secs = self.predict_matmul_batch(
                stack("m"), stack("n"), stack("k"), stack("batch"),
                stack("count"), dtype=dtype, kind=kind)
            total += secs.sum(axis=0)
        agroups: Dict[str, List[_GAttn]] = {}
        for op in gops:
            if isinstance(op, _GAttn):
                agroups.setdefault(op.dtype, []).append(op)
        for dtype, sub in agroups.items():
            skv = np.stack([np.broadcast_to(_f64(o.skv), (G,)) for o in sub])
            fl = np.stack([np.broadcast_to(_f64(o.flops), (G,)) for o in sub])
            hd = np.stack([np.broadcast_to(_f64(o.hd), (G,)) for o in sub])
            total += self.predict_attention_batch(skv, fl, hd,
                                                  dtype=dtype).sum(axis=0)
        mem = [op for op in gops if isinstance(op, _GMem)]
        if mem:
            X = np.empty((len(mem), G, 4))
            for i, op in enumerate(mem):
                for g in range(G):
                    shape = tuple(int(x[g]) if isinstance(x, np.ndarray)
                                  else int(x) for x in op.shape)
                    X[i, g] = self._feature_row(op.snippet, shape, op.dtype)
            X = self.memory_model.apply_cache(X)
            Cm = np.stack([self._memory_coef(op.snippet) for op in mem])
            counts = np.stack(
                [np.broadcast_to(_f64(op.count), (G,)) for op in mem])
            total += ((X * Cm[:, None, :]).sum(axis=2) * counts).sum(axis=0)
        return total

    def predict_model_grid(self, cfg: C.ModelConfig,
                           batches: Sequence[int], seqs: Sequence[int],
                           dtype: Optional[str] = None,
                           device: Optional[str] = None) -> np.ndarray:
        """Whole-model latency over the (batch, seq) grid, the op graph
        enumerated symbolically once.  Returns a
        ``(len(batches), len(seqs))`` float array of total seconds."""
        if device is not None and device != self.device:
            return self.for_device(device).predict_model_grid(
                cfg, batches, seqs, dtype)
        batches = np.asarray(list(batches), np.int64)
        seqs = np.asarray(list(seqs), np.int64)
        bg, sg = np.meshgrid(batches, seqs, indexing="ij")
        b, s = bg.ravel(), sg.ravel()
        gops = enumerate_grid_ops(cfg, b, s, dtype=dtype)
        total = self.predict_grid_ops(gops, b.size)
        return total.reshape(len(batches), len(seqs))

    def predict_decode_grid(self, cfg: C.ModelConfig,
                            batches: Sequence[int], ctxs: Sequence[int],
                            dtype: Optional[str] = None,
                            device: Optional[str] = None,
                            spec: Optional[og.ParallelismSpec] = None
                            ) -> np.ndarray:
        """Per-decode-step latency over the (batch, ctx) grid — the decode
        twin of ``predict_model_grid``.  ONE decode enumeration per batch
        with ``ctx`` passed as an array: only the KV-cache-read attention
        ops vary with ctx (their skv/flops broadcast over the grid); every
        other decode op — skinny matmuls, KV appends, recurrent steps,
        induced collectives — is ctx-independent and priced once.  Returns
        a ``(len(batches), len(ctxs))`` float array of per-step seconds;
        ``spec`` shards the step (``enumerate_decode_parallel_ops``)."""
        if device is not None and device != self.device:
            return self.for_device(device).predict_decode_grid(
                cfg, batches, ctxs, dtype=dtype, spec=spec)
        batches = np.asarray(list(batches), np.int64)
        ctx = np.asarray(list(ctxs), np.int64)
        out = np.empty((batches.size, ctx.size))
        coef = self._memory_coef("softmax")
        for bi, b in enumerate(batches):
            if spec is None:
                ops = og.enumerate_decode_ops(cfg, int(b), ctx, dtype=dtype)
            else:
                ops = og.enumerate_decode_parallel_ops(cfg, int(b), ctx,
                                                       spec, dtype=dtype)
            varying = [op for op in ops
                       if isinstance(op, og.AttentionOp)
                       and isinstance(op.skv, np.ndarray)]
            fixed = [op for op in ops
                     if not (isinstance(op, og.AttentionOp)
                             and isinstance(op.skv, np.ndarray))]
            base = (float(self.predict_ops_seconds(fixed).sum())
                    if fixed else 0.0)
            var = np.zeros(ctx.size)
            for op in varying:
                f = og.decode_attention_features(op)
                X = self.memory_model.apply_cache(np.stack(
                    [np.broadcast_to(_f64(f["bytes"]), ctx.shape),
                     np.broadcast_to(_f64(f["flops"]), ctx.shape),
                     np.broadcast_to(_f64(f["transcendentals"]), ctx.shape),
                     np.ones(ctx.size)], axis=1))
                var += (X * coef).sum(axis=1)
            out[bi] = base + var
        return out

    def serving_tables(self, cfg: C.ModelConfig, mix, *, capacity: int,
                       dtype: Optional[str] = None,
                       spec: Optional[og.ParallelismSpec] = None,
                       device: Optional[str] = None):
        """One serving point's latency substrate (``schedule.ServingTables``)
        in two vectorized passes: a prefill entry per distinct prompt length
        (``predict_model`` at batch 1, or the ``schedule_parallel`` makespan
        under a spec) and ONE ``predict_decode_grid`` call covering
        ``(1..capacity, 1..mix.max_ctx)``.  The grid rows are
        batch-independent, so a max-capacity table serves every smaller
        capacity bit-identically."""
        if device is not None and device != self.device:
            return self.for_device(device).serving_tables(
                cfg, mix, capacity=capacity, dtype=dtype, spec=spec)
        from repro_torch.core import schedule as S
        pre: Dict[int, float] = {}
        for p in sorted(set(int(p) for p in mix.prompt_lens)):
            if spec is None:
                pre[p] = float(self.predict_model(cfg, 1, p, dtype=dtype)[0])
            else:
                pre[p] = float(self.schedule_parallel(cfg, 1, p, spec,
                                                      dtype=dtype).makespan)
        grid = self.predict_decode_grid(cfg, np.arange(1, int(capacity) + 1),
                                        np.arange(1, mix.max_ctx + 1),
                                        dtype=dtype, spec=spec)
        return S.ServingTables(prefill=pre, decode=grid)

    # ----- cached interface -----
    def predict_model_cached(self, cfg: C.ModelConfig, batch: int, seq: int,
                             dtype: Optional[str] = None,
                             cache: Optional["PredictionCache"] = None,
                             device: Optional[str] = None) -> float:
        if device is not None and device != self.device:
            return self.for_device(device).predict_model_cached(
                cfg, batch, seq, dtype=dtype, cache=cache)
        cache = cache if cache is not None else self.cache
        if cache is None:
            total, _ = self.predict_model(cfg, batch, seq, dtype=dtype)
            return total
        key = PredictionCache.make_key(config_key(cfg), self.cache_device,
                                       dtype, batch, seq)
        hit = cache.get(key)
        if hit is not None:
            return hit
        total, _ = self.predict_model(cfg, batch, seq, dtype=dtype)
        cache.put(key, total)
        return total


# ---------------------------------------------------------------------------
# LRU + JSON-persistent prediction cache
# ---------------------------------------------------------------------------

def config_key(cfg: C.ModelConfig) -> str:
    """Cache identity for a model config: the name plus a fingerprint of the
    full architecture, so variants built with ``dataclasses.replace`` (which
    keep ``cfg.name``) never collide in the prediction cache."""
    return f"{cfg.name}@{zlib.crc32(repr(cfg).encode()):08x}"


class PredictionCache:
    """LRU cache of model-level predictions (seconds) keyed on
    ``(model, device, dtype, batch, seq)``, JSON-persistable so NAS sweeps
    and latency queries survive process restarts.

    ``SCHEMA`` stamps the persisted file with the prediction SEMANTICS
    version, so caches persisted under other semantics self-invalidate on
    load instead of silently serving stale latencies.  It is the JAX
    package's number (8, whose history its module records): a file means
    the same to both engines.
    """

    SCHEMA = 8

    def __init__(self, maxsize: int = 65536, path: Optional[str] = None):
        self.maxsize = int(maxsize)
        self.path = path
        self.hits = 0
        self.misses = 0
        self._od: "OrderedDict[str, float]" = OrderedDict()
        if path and os.path.exists(path):
            self.load(path)

    @staticmethod
    def make_key(model: str, device: str, dtype: Optional[str],
                 batch: int, seq: int) -> str:
        return f"{model}|{device}|{dtype or 'float32'}|{int(batch)}|{int(seq)}"

    def get(self, key: str) -> Optional[float]:
        if key in self._od:
            self._od.move_to_end(key)
            self.hits += 1
            return self._od[key]
        self.misses += 1
        return None

    def put(self, key: str, seconds: float):
        self._od[key] = float(seconds)
        self._od.move_to_end(key)
        while len(self._od) > self.maxsize:
            self._od.popitem(last=False)

    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, key: str) -> bool:
        return key in self._od

    @property
    def stats(self) -> dict:
        return {"size": len(self._od), "hits": self.hits,
                "misses": self.misses, "maxsize": self.maxsize}

    def save(self, path: Optional[str] = None):
        """Atomic write (temp file + rename): a crash mid-save must not
        leave a truncated cache behind."""
        path = path or self.path
        if not path:
            raise ValueError("PredictionCache.save: no path configured")
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"schema": self.SCHEMA,
                       "entries": list(self._od.items())}, f)
        os.replace(tmp, path)

    def load(self, path: Optional[str] = None):
        """A corrupt/truncated file is treated as an empty cache (predictions
        are recomputable), and so is a file persisted under a different
        ``SCHEMA`` — entries computed with old predictor semantics must not
        be served as current; entries that are not a number (the JAX
        engine's dict-valued schedule results) are skipped; explicit loads
        of well-formed files still raise on missing paths via open()."""
        path = path or self.path
        try:
            with open(path) as f:
                d = json.load(f)
        except (json.JSONDecodeError, ValueError):
            return
        if not isinstance(d, dict) or d.get("schema") != self.SCHEMA:
            return
        for e in d.get("entries", []):
            if (isinstance(e, (list, tuple)) and len(e) == 2
                    and isinstance(e[0], str)
                    and isinstance(e[1], (int, float))
                    and not isinstance(e[1], bool)):
                self.put(e[0], e[1])
