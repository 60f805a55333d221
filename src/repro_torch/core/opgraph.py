"""Op-graph extraction: ModelConfig + input shape -> the PM2Lat op IR.

PM2Lat aggregates per-kernel predictions assuming sequential execution
(paper §III).  The op graph is enumerated directly from the config: every
matmul-family op with its (batch, M, N, K), every attention call with its
geometry, every memory-bound op as a torch snippet whose proxy features come
from ``core/cost.py`` (cached by shape).  The enumeration is the JAX
package's, op for op; only the snippets and their features are torch.
A decode step (one token a request against a KV cache) is enumerated too;
the parallel enumerations come with the collectives slice.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import base as C
from repro_torch.core.collectives import CollectiveOp, dtype_bytes
from repro_torch.core.cost import cost_of
from repro_torch.core.memory_model import assoc_scan, seq_scan
from repro_torch.models.layers import is_gated, pad_vocab

PREFILL = "prefill"
DECODE = "decode"
PHASES = (PREFILL, DECODE)


def slstm_ff(cfg: C.ModelConfig) -> int:
    ff = int(round(4 * cfg.d_model / 3))
    return ((ff + 127) // 128) * 128


@dataclasses.dataclass
class MatmulOp:
    name: str
    m: int
    n: int
    k: int
    batch: int = 1
    count: int = 1
    dtype: str = "float32"
    kind: str = "matmul"          # 'matmul' | 'bmm'

    @property
    def flops(self) -> float:
        return 2.0 * self.batch * self.m * self.n * self.k * self.count


@dataclasses.dataclass
class AttentionOp:
    name: str
    batch: int
    heads: int
    kv_heads: int
    sq: int
    skv: int
    hd: int
    causal: bool = True
    count: int = 1
    dtype: str = "float32"
    kind: str = "attention"
    # execution phase: 'prefill' attention is compute-bound and priced by
    # the throughput tables; 'decode' attention (sq == 1, KV-cache read)
    # is memory-bound and priced by the memory model over its analytic
    # byte/flop features.  ``skv`` may be a numpy array (ctx swept
    # symbolically).
    phase: str = PREFILL

    @property
    def flops(self):
        return 4.0 * self.batch * self.heads * self.sq * self.skv * self.hd * self.count


@dataclasses.dataclass
class MemoryOp:
    name: str
    snippet: str                  # key into SNIPPETS
    shape: Tuple[int, ...]
    count: int = 1
    dtype: str = "float32"
    kind: str = "memory"

    def features(self) -> Dict[str, float]:
        return _snippet_features(self.snippet, self.shape, self.dtype)


Op = Union[MatmulOp, AttentionOp, MemoryOp, CollectiveOp]
OP_TYPES: Tuple[type, ...] = (MatmulOp, AttentionOp, MemoryOp, CollectiveOp)

COMPUTE_STREAM = "compute"
COMM_STREAM = "comm"


def stream_of(op: Op) -> str:
    """Default execution stream: collectives run on the comm stream,
    everything else on the compute stream."""
    return COMM_STREAM if isinstance(op, CollectiveOp) else COMPUTE_STREAM


@dataclasses.dataclass
class OpNode:
    """One node of the schedule-aware IR: an op, the stream it executes on,
    and the indices of the nodes that must finish before it starts."""
    op: Op
    stream: str = COMPUTE_STREAM
    deps: Tuple[int, ...] = ()


@dataclasses.dataclass
class OpGraph:
    """Dependency/stream-aware op IR.  Nodes are appended in topological
    order (every dep index is smaller than the node's own index).  ``phase``
    tags which serving phase the graph models."""
    nodes: List[OpNode] = dataclasses.field(default_factory=list)
    phase: str = PREFILL

    def __len__(self) -> int:
        return len(self.nodes)

    def ops(self) -> List[Op]:
        """The flat op list, in insertion (topological) order."""
        return [n.op for n in self.nodes]

    def tail(self) -> Tuple[int, ...]:
        """Dep tuple pointing at the last node (empty for an empty graph)."""
        return (len(self.nodes) - 1,) if self.nodes else ()

    def add(self, op: Op, stream: Optional[str] = None,
            deps: Sequence[int] = ()) -> int:
        """Append one node; returns its index.  ``stream`` defaults to
        ``stream_of(op)``."""
        deps = tuple(deps)
        assert all(0 <= d < len(self.nodes) for d in deps), (deps, len(self))
        self.nodes.append(OpNode(op, stream or stream_of(op), deps))
        return len(self.nodes) - 1

    def add_chain(self, ops: Sequence[Op], deps: Sequence[int] = (),
                  compute_stream: Optional[str] = None) -> Tuple[int, ...]:
        """Append ``ops`` serialized (each depends on the previous; the first
        on ``deps``).  Compute ops go on ``compute_stream`` (default
        'compute'); collectives always go on the comm stream."""
        ids: List[int] = []
        for op in ops:
            stream = None if isinstance(op, CollectiveOp) else compute_stream
            ids.append(self.add(op, stream=stream, deps=deps))
            deps = (ids[-1],)
        return tuple(ids)

    @classmethod
    def chain(cls, ops: Sequence[Op]) -> "OpGraph":
        """A fully serialized graph — the classic sequential-sum op list.
        Scheduling it reproduces ``sum(op seconds)`` bit for bit."""
        g = cls()
        g.add_chain(ops)
        return g


# ----- memory-op snippets (run on meta tensors by core/cost.py) -----

def _rope_snippet(x):
    h = x.shape[-1] // 2
    return torch.cat([x[..., :h] * 0.5 - x[..., h:] * 0.5,
                      x[..., h:] * 0.5 + x[..., :h] * 0.5], -1)


def _conv1d4_snippet(x):
    out = x
    for s in (1, 2, 3):
        out = out + F.pad(x, (0, 0, s, 0))[:, :-s]
    return out


SNIPPETS: Dict[str, Callable] = {
    "rmsnorm": lambda x: x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6),
    "add": lambda x: x + x,
    "silu_mul": lambda x: F.silu(x) * x,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softmax": lambda x: F.softmax(x, dim=-1),
    "rope": _rope_snippet,
    "embed_gather": lambda x: torch.index_select(
        x, 0, torch.zeros((16,), dtype=torch.long, device=x.device)),
    "conv1d4": _conv1d4_snippet,
    "assoc_scan": assoc_scan,
    "seq_scan": seq_scan,
    "gate_sigmoid": lambda x: torch.sigmoid(x) * x,
    "adamw_update": lambda x: x - 0.01 * (
        (0.9 * x + 0.1 * x) / (torch.sqrt(0.999 * x * x + 0.001 * x * x)
                               + 1e-8) + 0.01 * x),
    "sgd_update": lambda x: x - 0.01 * x,
}


def kv_read_bytes(op: AttentionOp) -> float:
    """KV-cache read traffic of one attention op: the K and V blocks the
    kernel streams from HBM, ``2 · batch · kv_heads · skv · hd`` elements.
    Scales with ``kv_heads`` (NOT ``heads``): grouped-query attention cuts
    decode-step memory traffic by the GQA ratio while the flops (which
    scale with ``heads``) stay put.  Elementwise when ``skv`` is an
    array."""
    return (2.0 * op.batch * op.kv_heads * op.skv * op.hd
            * dtype_bytes(op.dtype) * op.count)


def decode_attention_features(op: AttentionOp) -> Dict[str, float]:
    """Proxy features pricing a DECODE-phase attention op through the
    memory model, as the memory-bound snippets' features do:

    * ``bytes``: the KV-cache read (``kv_read_bytes``) plus the query
      read and output write (``2 · batch · heads · sq · hd`` elements);
    * ``flops``: the op's own QK^T + PV flops;
    * ``transcendentals``: the softmax exponentials, one per score.

    At sq = 1 the flops term is tiny and the KV bytes dominate: the
    memory-bound regime the throughput tables (built around compute-bound
    prefill kernels) cannot represent."""
    esz = dtype_bytes(op.dtype)
    qo = 2.0 * op.batch * op.heads * op.sq * op.hd * esz * op.count
    return {"bytes": kv_read_bytes(op) + qo,
            "flops": op.flops,
            "transcendentals": (1.0 * op.batch * op.heads * op.sq * op.skv
                                * op.count)}


def kv_cache_bytes(cfg: C.ModelConfig, batch: int, ctx: int,
                   dtype: Optional[str] = None) -> float:
    """Bytes of per-request serving state at context length ``ctx``:
    K + V cache for every attention layer (``2 · batch · kv_heads · ctx ·
    hd`` elements each; sliding-window layers cap ``ctx`` at the window,
    cross-attention adds its fixed encoder-context K/V), plus the O(1)
    recurrent state of RG-LRU/xLSTM blocks."""
    dt = dtype or "float32"
    esz = dtype_bytes(dt)
    d, hkv, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind in (C.ATTN, C.ENC_ATTN):
            total += 2.0 * batch * hkv * ctx * hd * esz
        elif kind == C.LOCAL_ATTN:
            total += 2.0 * batch * hkv * min(ctx, cfg.sliding_window) * hd * esz
        elif kind == C.CROSS_ATTN:
            Lx = cfg.cross_attn_context_len or (
                cfg.encoder.n_frames if cfg.encoder else 0)
            total += 2.0 * batch * hkv * (ctx + Lx) * hd * esz
        elif kind == C.RGLRU:
            dl = cfg.lru_dim or d
            total += batch * (dl + 4 * dl) * esz      # h state + conv window
        elif kind == C.MLSTM:
            di = 2 * d
            hdm = di // cfg.n_heads
            # matrix memory C (hdm x hdm per head) + normalizer + conv window
            total += batch * (cfg.n_heads * hdm * hdm + di + 4 * di) * esz
        elif kind == C.SLSTM:
            total += batch * 2 * 4 * d * esz          # c/h gate states
    return total


@functools.lru_cache(maxsize=4096)
def _snippet_features(snippet: str, shape: tuple, dtype: str) -> Dict[str, float]:
    return cost_of(SNIPPETS[snippet], (shape, getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# enumeration
# ---------------------------------------------------------------------------

def _mlp_ops(cfg: C.ModelConfig, T: int, dt: str, prefix: str,
             n_layers: int, dff: int) -> List[Op]:
    """Dense-MLP ops for ``T`` tokens — shared between the prefill and
    decode enumerations (decode calls it with T = batch)."""
    gated = is_gated(cfg.mlp_act)
    d = cfg.d_model
    return [MatmulOp(f"{prefix}.w_in", m=T, n=dff, k=d,
                     count=n_layers * (2 if gated else 1), dtype=dt),
            MemoryOp(f"{prefix}.act", "silu_mul" if gated else "gelu",
                     (T, dff), count=n_layers, dtype=dt),
            MatmulOp(f"{prefix}.w_out", m=T, n=d, k=dff, count=n_layers,
                     dtype=dt),
            MemoryOp(f"{prefix}.residual", "add", (T, d), count=n_layers,
                     dtype=dt)]


def _ffn_ops(cfg: C.ModelConfig, T: int, G: int, dt: str,
             n_layers: int, prefix: str) -> List[Op]:
    """FFN (dense or MoE) ops for ``T`` tokens routed in ``G`` groups —
    shared between the prefill (G = batch, T = batch·seq) and decode
    (G = T = batch, one token per group) enumerations."""
    d, ff = cfg.d_model, cfg.d_ff
    out: List[Op] = [MemoryOp(f"{prefix}.ln2", "rmsnorm", (T, d),
                              count=n_layers, dtype=dt)]
    if cfg.moe is not None:
        m = cfg.moe
        Sg = T // G
        cap = max(int(m.capacity_factor * Sg * m.top_k / m.num_experts),
                  m.top_k, 4)
        gated = is_gated(cfg.mlp_act)
        out += [
            MatmulOp(f"{prefix}.router", m=T, n=m.num_experts, k=d,
                     count=n_layers, dtype=dt),
            MemoryOp(f"{prefix}.gate", "softmax", (T, m.num_experts),
                     count=n_layers, dtype=dt),
            MatmulOp(f"{prefix}.dispatch", m=m.num_experts * cap, n=d, k=Sg,
                     batch=G, count=n_layers, dtype=dt, kind="bmm"),
            MatmulOp(f"{prefix}.expert_in", m=cap, n=m.d_ff_expert, k=d,
                     batch=G * m.num_experts,
                     count=n_layers * (2 if gated else 1), dtype=dt, kind="bmm"),
            MemoryOp(f"{prefix}.expert_act", "silu_mul",
                     (G * m.num_experts * cap, m.d_ff_expert),
                     count=n_layers, dtype=dt),
            MatmulOp(f"{prefix}.expert_out", m=cap, n=d, k=m.d_ff_expert,
                     batch=G * m.num_experts, count=n_layers, dtype=dt,
                     kind="bmm"),
            MatmulOp(f"{prefix}.combine", m=Sg, n=d, k=m.num_experts * cap,
                     batch=G, count=n_layers, dtype=dt, kind="bmm"),
        ]
        for i in range(m.num_shared_experts):
            out += _mlp_ops(cfg, T, dt, f"{prefix}.shared{i}", n_layers,
                            m.d_ff_expert)
    elif ff > 0:
        out += _mlp_ops(cfg, T, dt, prefix, n_layers, ff)
    return out


def _forward_segments(cfg: C.ModelConfig, batch: int, seq: int,
                      dtype: Optional[str] = None
                      ) -> List[Tuple[str, List[Op]]]:
    """Forward-pass ops for tokens (batch, seq) as labeled segments:
    ``('head', [embed])``, one ``('group:<kind>', [...])`` per layer-kind
    group (counts folded over the group's layers, exactly as the flat list
    always enumerated them), optionally ``('encoder', [...])``, and
    ``('tail', [final_norm, unembed])``.  Concatenating the segments IS the
    historical ``enumerate_ops`` list, op for op."""
    dt = dtype or "float32"
    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)
    T = batch * seq
    Vp = pad_vocab(cfg.vocab_size)
    segments: List[Tuple[str, List[Op]]] = [
        ("head", [MemoryOp("embed", "embed_gather", (Vp, d), dtype=dt)]),
    ]
    kinds = cfg.layer_kinds
    kind_counts = Counter(kinds)

    def attn_ops(n_layers: int, kind: str, prefix: str):
        window = cfg.sliding_window if kind == C.LOCAL_ATTN else None
        skv = seq if window is None else seq  # full-seq masked (flash path)
        out = [
            MemoryOp(f"{prefix}.ln", "rmsnorm", (T, d), count=n_layers, dtype=dt),
            MatmulOp(f"{prefix}.wq", m=T, n=hq * hd, k=d, count=n_layers, dtype=dt),
            MatmulOp(f"{prefix}.wk", m=T, n=hkv * hd, k=d, count=n_layers, dtype=dt),
            MatmulOp(f"{prefix}.wv", m=T, n=hkv * hd, k=d, count=n_layers, dtype=dt),
            MemoryOp(f"{prefix}.rope", "rope", (T, hq, hd), count=n_layers, dtype=dt),
            AttentionOp(f"{prefix}.attn", batch=batch, heads=hq, kv_heads=hkv,
                        sq=seq, skv=skv, hd=hd, causal=kind != C.ENC_ATTN,
                        count=n_layers, dtype=dt),
            MatmulOp(f"{prefix}.wo", m=T, n=d, k=hq * hd, count=n_layers, dtype=dt),
            MemoryOp(f"{prefix}.residual", "add", (T, d), count=n_layers, dtype=dt),
        ]
        return out

    def ffn_ops(n_layers: int, prefix: str):
        return _ffn_ops(cfg, T, batch, dt, n_layers, prefix)

    def mlp_ops(prefix: str, n_layers: int, dff: int):
        return _mlp_ops(cfg, T, dt, prefix, n_layers, dff)

    # --- main stack ---
    for kind, n in sorted(kind_counts.items()):
        ops: List[Op] = []
        if kind in (C.ATTN, C.LOCAL_ATTN):
            ops += attn_ops(n, kind, kind)
            ops += ffn_ops(n, kind)
        elif kind == C.CROSS_ATTN:
            ops += attn_ops(n, C.ATTN, "self")
            Lx = cfg.cross_attn_context_len or (
                cfg.encoder.n_frames if cfg.encoder else 0)
            Tx = batch * Lx
            ops += [
                MatmulOp("cross.wq", m=T, n=hq * hd, k=d, count=n, dtype=dt),
                MatmulOp("cross.wk", m=Tx, n=hkv * hd, k=d, count=n, dtype=dt),
                MatmulOp("cross.wv", m=Tx, n=hkv * hd, k=d, count=n, dtype=dt),
                AttentionOp("cross.attn", batch=batch, heads=hq, kv_heads=hkv,
                            sq=seq, skv=Lx, hd=hd, causal=False, count=n, dtype=dt),
                MatmulOp("cross.wo", m=T, n=d, k=hq * hd, count=n, dtype=dt),
            ]
            ops += ffn_ops(n, "decoder")
        elif kind == C.RGLRU:
            dl = cfg.lru_dim or d
            ops += [
                MemoryOp("rglru.ln", "rmsnorm", (T, d), count=n, dtype=dt),
                MatmulOp("rglru.wx", m=T, n=dl, k=d, count=2 * n, dtype=dt),
                MemoryOp("rglru.conv", "conv1d4", (batch, seq, dl), count=n, dtype=dt),
                MatmulOp("rglru.gates", m=T, n=dl, k=dl, count=2 * n, dtype=dt),
                MemoryOp("rglru.scan", "assoc_scan", (batch, seq, dl), count=n, dtype=dt),
                MemoryOp("rglru.gate_mul", "silu_mul", (T, dl), count=n, dtype=dt),
                MatmulOp("rglru.w_out", m=T, n=d, k=dl, count=n, dtype=dt),
            ]
            ops += ffn_ops(n, "rglru")
        elif kind == C.MLSTM:
            di = 2 * d
            hdm = di // hq
            chunk = min(128, seq)
            nC = max(seq // chunk, 1)
            ops += [
                MemoryOp("mlstm.ln", "rmsnorm", (T, d), count=n, dtype=dt),
                MatmulOp("mlstm.up", m=T, n=2 * di, k=d, count=n, dtype=dt),
                MemoryOp("mlstm.conv", "conv1d4", (batch, seq, di), count=n, dtype=dt),
                MatmulOp("mlstm.qkv", m=T, n=di, k=di, count=3 * n, dtype=dt),
                AttentionOp("mlstm.intra", batch=batch * nC, heads=hq,
                            kv_heads=hq, sq=chunk, skv=chunk, hd=hdm,
                            causal=True, count=n, dtype=dt),
                MatmulOp("mlstm.state", m=hdm, n=hdm, k=chunk,
                         batch=batch * nC * hq, count=2 * n, dtype=dt, kind="bmm"),
                MemoryOp("mlstm.gate", "silu_mul", (T, di), count=n, dtype=dt),
                MatmulOp("mlstm.down", m=T, n=d, k=di, count=n, dtype=dt),
            ]
        elif kind == C.SLSTM:
            ops += [
                MemoryOp("slstm.ln", "rmsnorm", (T, d), count=n, dtype=dt),
                MatmulOp("slstm.wx", m=T, n=4 * d, k=d, count=n, dtype=dt),
                MatmulOp("slstm.rh", m=batch, n=4 * d, k=d, batch=1,
                         count=n * seq, dtype=dt),
                MemoryOp("slstm.scan", "seq_scan", (batch, seq, 4 * d),
                         count=n, dtype=dt),
            ]
            ops += mlp_ops("slstm.ff", n, slstm_ff(cfg))
        elif kind == C.ENC_ATTN:
            ops += attn_ops(n, C.ENC_ATTN, "enc")
            ops += ffn_ops(n, "enc")
        segments.append((f"group:{kind}", ops))

    if cfg.encoder is not None:
        Tx = batch * cfg.encoder.n_frames
        n = cfg.encoder.n_layers
        enc: List[Op] = [
            MemoryOp("enc.ln", "rmsnorm", (Tx, d), count=2 * n, dtype=dt),
            MatmulOp("enc.qkvo", m=Tx, n=d, k=d, count=4 * n, dtype=dt),
            AttentionOp("enc.attn", batch=batch, heads=hq, kv_heads=hq,
                        sq=cfg.encoder.n_frames, skv=cfg.encoder.n_frames,
                        hd=hd, causal=False, count=n, dtype=dt),
        ]
        enc += mlp_ops("enc.ff", n, ff)
        segments.append(("encoder", enc))

    segments.append(("tail", [
        MemoryOp("final_norm", "rmsnorm", (T, d), dtype=dt),
        MatmulOp("unembed", m=T, n=Vp, k=d, dtype=dt),
    ]))
    return segments


def enumerate_graph(cfg: C.ModelConfig, batch: int, seq: int,
                    dtype: Optional[str] = None) -> OpGraph:
    """Forward pass for tokens (batch, seq) as an ``OpGraph`` — one fully
    serialized compute chain (the paper's sequential-aggregation model)."""
    g = OpGraph()
    for _, seg in _forward_segments(cfg, batch, seq, dtype=dtype):
        g.add_chain(seg, deps=g.tail())
    return g


def enumerate_ops(cfg: C.ModelConfig, batch: int, seq: int,
                  dtype: Optional[str] = None) -> List[Op]:
    """Forward-pass op list for tokens (batch, seq) — the flat view over
    ``enumerate_graph`` (same ops, same order)."""
    return enumerate_graph(cfg, batch, seq, dtype=dtype).ops()




# ---------------------------------------------------------------------------
# Decode-phase enumeration (serving)
# ---------------------------------------------------------------------------

def _clamp_ctx(ctx, window: Optional[int]):
    """min(ctx, window), elementwise when ``ctx`` is an array."""
    if window is None:
        return ctx
    if isinstance(ctx, np.ndarray):
        return np.minimum(ctx, window)
    return min(int(ctx), int(window))


def _decode_segments(cfg: C.ModelConfig, batch: int, ctx,
                     dtype: Optional[str] = None
                     ) -> List[Tuple[str, List[Op]]]:
    """One decode STEP for ``batch`` in-flight requests, each attending a
    KV cache of ``ctx`` entries (the step's own K/V is appended first, so
    ``ctx`` counts it): the phase-aware twin of ``_forward_segments``.

    What changes against prefill (sq == seq):

    * every token-indexed matmul goes skinny: m = batch (one token per
      request), the memory-bound GEMV regime;
    * attention becomes a KV-cache READ: sq = 1, skv = ctx (window-clamped
      for sliding-window layers, the fixed encoder context for
      cross-attention), tagged ``phase='decode'`` so the predictor prices
      it memory-bound; a ``kv_append`` MemoryOp writes the step's K/V;
    * recurrent blocks advance their O(1) state, one gate/scan step whose
      cost is constant in ctx;
    * the encoder segment disappears (it runs once, at prefill).

    ``ctx`` may be a numpy array: only the decode attention's skv/flops
    become arrays (everything else is ctx-independent)."""
    dt = dtype or "float32"
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = batch                               # sq = 1: one token per request
    Vp = pad_vocab(cfg.vocab_size)
    segments: List[Tuple[str, List[Op]]] = [
        ("head", [MemoryOp("embed", "embed_gather", (Vp, d), dtype=dt)]),
    ]
    kind_counts = Counter(cfg.layer_kinds)

    def attn_ops(n: int, kind: str, prefix: str):
        window = cfg.sliding_window if kind == C.LOCAL_ATTN else None
        skv = _clamp_ctx(ctx, window)
        return [
            MemoryOp(f"{prefix}.ln", "rmsnorm", (T, d), count=n, dtype=dt),
            MatmulOp(f"{prefix}.wq", m=T, n=hq * hd, k=d, count=n, dtype=dt),
            MatmulOp(f"{prefix}.wk", m=T, n=hkv * hd, k=d, count=n, dtype=dt),
            MatmulOp(f"{prefix}.wv", m=T, n=hkv * hd, k=d, count=n, dtype=dt),
            MemoryOp(f"{prefix}.rope", "rope", (T, hq, hd), count=n, dtype=dt),
            MemoryOp(f"{prefix}.kv_append", "add", (batch, 2 * hkv * hd),
                     count=n, dtype=dt),
            AttentionOp(f"{prefix}.attn", batch=batch, heads=hq,
                        kv_heads=hkv, sq=1, skv=skv, hd=hd,
                        causal=kind != C.ENC_ATTN, count=n, dtype=dt,
                        phase=DECODE),
            MatmulOp(f"{prefix}.wo", m=T, n=d, k=hq * hd, count=n, dtype=dt),
            MemoryOp(f"{prefix}.residual", "add", (T, d), count=n, dtype=dt),
        ]

    def ffn_ops(n: int, prefix: str):
        return _ffn_ops(cfg, T, batch, dt, n, prefix)

    for kind, n in sorted(kind_counts.items()):
        ops: List[Op] = []
        if kind in (C.ATTN, C.LOCAL_ATTN):
            ops += attn_ops(n, kind, kind)
            ops += ffn_ops(n, kind)
        elif kind == C.CROSS_ATTN:
            ops += attn_ops(n, C.ATTN, "self")
            Lx = cfg.cross_attn_context_len or (
                cfg.encoder.n_frames if cfg.encoder else 0)
            # cross K/V were cached at prefill: decode computes q only and
            # reads the fixed encoder context (skv = Lx, O(1) in ctx)
            ops += [
                MatmulOp("cross.wq", m=T, n=hq * hd, k=d, count=n, dtype=dt),
                AttentionOp("cross.attn", batch=batch, heads=hq,
                            kv_heads=hkv, sq=1, skv=Lx, hd=hd, causal=False,
                            count=n, dtype=dt, phase=DECODE),
                MatmulOp("cross.wo", m=T, n=d, k=hq * hd, count=n, dtype=dt),
            ]
            ops += ffn_ops(n, "decoder")
        elif kind == C.RGLRU:
            dl = cfg.lru_dim or d
            ops += [
                MemoryOp("rglru.ln", "rmsnorm", (T, d), count=n, dtype=dt),
                MatmulOp("rglru.wx", m=T, n=dl, k=d, count=2 * n, dtype=dt),
                MemoryOp("rglru.conv", "conv1d4", (batch, 4, dl), count=n,
                         dtype=dt),
                MatmulOp("rglru.gates", m=T, n=dl, k=dl, count=2 * n, dtype=dt),
                MemoryOp("rglru.step", "gate_sigmoid", (T, dl), count=n,
                         dtype=dt),
                MemoryOp("rglru.gate_mul", "silu_mul", (T, dl), count=n,
                         dtype=dt),
                MatmulOp("rglru.w_out", m=T, n=d, k=dl, count=n, dtype=dt),
            ]
            ops += ffn_ops(n, "rglru")
        elif kind == C.MLSTM:
            di = 2 * d
            hdm = di // hq
            ops += [
                MemoryOp("mlstm.ln", "rmsnorm", (T, d), count=n, dtype=dt),
                MatmulOp("mlstm.up", m=T, n=2 * di, k=d, count=n, dtype=dt),
                MemoryOp("mlstm.conv", "conv1d4", (batch, 4, di), count=n,
                         dtype=dt),
                MatmulOp("mlstm.qkv", m=T, n=di, k=di, count=3 * n, dtype=dt),
                # matrix-memory update (k v^T outer product) + read (q C):
                # per-head (1, hdm) x (hdm, hdm) steps, O(1) in ctx
                MatmulOp("mlstm.state", m=1, n=hdm, k=hdm, batch=batch * hq,
                         count=2 * n, dtype=dt, kind="bmm"),
                MemoryOp("mlstm.gate", "silu_mul", (T, di), count=n, dtype=dt),
                MatmulOp("mlstm.down", m=T, n=d, k=di, count=n, dtype=dt),
            ]
        elif kind == C.SLSTM:
            ops += [
                MemoryOp("slstm.ln", "rmsnorm", (T, d), count=n, dtype=dt),
                MatmulOp("slstm.wx", m=T, n=4 * d, k=d, count=n, dtype=dt),
                MatmulOp("slstm.rh", m=batch, n=4 * d, k=d, batch=1,
                         count=n, dtype=dt),      # ONE recurrent step
                MemoryOp("slstm.step", "gate_sigmoid", (batch, 4 * d),
                         count=n, dtype=dt),
            ]
            ops += _mlp_ops(cfg, T, dt, "slstm.ff", n, slstm_ff(cfg))
        elif kind == C.ENC_ATTN:
            ops += attn_ops(n, C.ENC_ATTN, "enc")
            ops += ffn_ops(n, "enc")
        segments.append((f"group:{kind}", ops))

    segments.append(("tail", [
        MemoryOp("final_norm", "rmsnorm", (T, d), dtype=dt),
        MatmulOp("unembed", m=T, n=Vp, k=d, dtype=dt),
    ]))
    return segments


def enumerate_decode_graph(cfg: C.ModelConfig, batch: int, ctx: int,
                           dtype: Optional[str] = None) -> OpGraph:
    """One decode step as a phase-tagged ``OpGraph`` (serialized chain)."""
    g = OpGraph(phase=DECODE)
    for _, seg in _decode_segments(cfg, batch, ctx, dtype=dtype):
        g.add_chain(seg, deps=g.tail())
    return g


def enumerate_decode_ops(cfg: C.ModelConfig, batch: int, ctx,
                         dtype: Optional[str] = None) -> List[Op]:
    """Op list for ONE decode step of ``batch`` requests at KV length
    ``ctx``: the flat view over ``enumerate_decode_graph``."""
    return [op for _, seg in _decode_segments(cfg, batch, ctx, dtype=dtype)
            for op in seg]
