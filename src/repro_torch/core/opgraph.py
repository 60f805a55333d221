"""Op-graph extraction: ModelConfig + input shape -> the PM2Lat op IR.

PM2Lat aggregates per-kernel predictions assuming sequential execution
(paper §III).  The op graph is enumerated directly from the config: every
matmul-family op with its (batch, M, N, K), every attention call with its
geometry, every memory-bound op as a torch snippet whose proxy features come
from ``core/cost.py`` (cached by shape).  The enumeration is the JAX
package's, op for op; only the snippets and their features are torch.
A decode step (one token a request against a KV cache) is enumerated too.

The primary representation is a typed ``OpGraph``: nodes carry an
execution ``stream`` (``'compute'`` | ``'comm'``; pipeline builders use
suffixed labels like ``'compute.s1'``) and explicit dependency edges, so
``core/schedule.py`` can price a model as the makespan of a list schedule
instead of a sequential sum.  ``enumerate_parallel_ops`` and
``enumerate_decode_parallel_ops`` expand a model into one rank's op list
under a ``ParallelismSpec``: every compute op sharded by the JAX package's
name-pattern rules plus the induced ``CollectiveOp``s.  The rules match on
op names, so the names here are the JAX package's letter for letter.
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
from repro_torch.models.recurrent import slstm_ff

PREFILL = "prefill"
DECODE = "decode"
PHASES = (PREFILL, DECODE)


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


def activation_bytes(op: Op) -> float:
    """Bytes of output activation a backward pass must keep live for ``op``
    (output elements × dtype size × count): the per-op term of
    ``schedule.peak_memory_bytes``.  Collectives produce no new tensor, and
    the ``embed_gather`` snippet's shape is the embedding table (its (T, d)
    output is the hidden state the first ``ln``/``residual`` ops already
    count), so both contribute 0."""
    esz = dtype_bytes(op.dtype) if not isinstance(op, CollectiveOp) else 0
    if isinstance(op, MatmulOp):
        return float(op.batch) * op.m * op.n * esz * op.count
    if isinstance(op, AttentionOp):
        return float(op.batch) * op.heads * op.sq * op.hd * esz * op.count
    if isinstance(op, MemoryOp):
        if op.snippet == "embed_gather":
            return 0.0
        n = 1.0
        for d in op.shape:
            n *= d
        return n * esz * op.count
    return 0.0


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
        """A fully serialized graph: the classic sequential-sum op list.
        Scheduling it adds the op seconds left to right (Python 3.12's
        ``sum()`` is compensated and can differ in the last bits)."""
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


def layer_segments(cfg: C.ModelConfig, batch: int, seq: int,
                   dtype: Optional[str] = None
                   ) -> Tuple[List[Op], List[List[Op]], List[Op]]:
    """Per-layer forward segmentation for pipeline staging:
    ``(head_ops, [ops per layer in positional order], tail_ops)``.  Each
    layer is re-enumerated as a single-layer config (the move
    ``predict_blocks`` makes); ``head`` carries the embedding plus the
    whole encoder stack, ``tail`` the final norm + unembed."""
    segs = dict(_forward_segments(cfg, batch, seq, dtype=dtype))
    head = list(segs["head"]) + list(segs.get("encoder", []))
    tail = list(segs["tail"])
    ctx = cfg.cross_attn_context_len or (
        cfg.encoder.n_frames if cfg.encoder else 0)
    per_layer: List[List[Op]] = []
    for kind in cfg.layer_kinds:
        one = dataclasses.replace(cfg, n_layers=1, block_pattern=(kind,),
                                  encoder=None, cross_attn_context_len=ctx)
        ops = [op for label, seg in _forward_segments(one, batch, seq,
                                                      dtype=dtype)
               if label.startswith("group:") for op in seg]
        per_layer.append(ops)
    return head, per_layer, tail


def total_flops(ops: List[Op]) -> float:
    return sum(getattr(o, "flops", 0.0) for o in ops)




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


def enumerate_decode_parallel_ops(cfg: C.ModelConfig, batch: int, ctx,
                                  spec: "ParallelismSpec",
                                  dtype: Optional[str] = None) -> List[Op]:
    """One rank's decode-step op list under ``spec``: the name-pattern tp
    sharding of ``enumerate_parallel_ops`` (decode ops reuse the prefill op
    names) plus the induced collectives of a one-token forward
    (``seq = 1``).  ``spec.trivial`` returns ``enumerate_decode_ops``."""
    if spec.trivial:
        return enumerate_decode_ops(cfg, batch, ctx, dtype=dtype)
    dt = dtype or "float32"
    bsh = _ceil_div(batch, spec.dp)
    ops = [_shard_op(op, spec)
           for op in enumerate_decode_ops(cfg, bsh, ctx, dtype=dtype)]
    return ops + _induced_collectives(cfg, bsh, 1, spec, dt)


# ---------------------------------------------------------------------------
# Parallelism-aware expansion (paper §IV-D, multi-device planning)
# ---------------------------------------------------------------------------
# A ParallelismSpec names the logical mesh axes ('dp' over data, 'tp' over
# model, act_mode 'tp'|'sp') plus a pipeline degree.
# ``enumerate_parallel_ops`` expands a model into ONE RANK's op list: each
# compute op sharded by name-pattern rules, plus the induced CollectiveOps
# (priced by core/collectives.py).

SCHEDULE_KINDS = ("gpipe", "1f1b", "interleaved")


@dataclasses.dataclass(frozen=True)
class ParallelismSpec:
    """(dp, tp, pp) degrees + activation-sharding mode at block boundaries
    ('tp' = Megatron tensor parallel, hidden states replicated over the tp
    axis; 'sp' = Megatron sequence parallel, hidden states sharded over
    sequence: all-reduces become reduce-scatter + all-gather pairs).

    ``microbatches`` splits one rank's batch into that many sequential
    chunks: under ``pp > 1`` they pipeline across stages (the bubble
    emerges from ``core/schedule.py``'s list schedule); under ``pp == 1``
    they are chunked execution back to back.  The flat
    ``enumerate_parallel_ops`` view ignores it.

    ``schedule`` picks the pipeline schedule: ``'gpipe'``, ``'1f1b'``
    (one-forward-one-backward; forward-only graphs under it are GPipe) or
    ``'interleaved'`` (``schedule.VIRTUAL_STAGES`` chunks per device)."""
    dp: int = 1
    tp: int = 1
    pp: int = 1
    act_mode: str = "tp"          # 'tp' | 'sp'
    microbatches: int = 1
    schedule: str = "gpipe"       # 'gpipe' | '1f1b' | 'interleaved'

    def __post_init__(self):
        if min(self.dp, self.tp, self.pp) < 1:
            raise ValueError(f"parallel degrees must be >= 1: {self}")
        if self.act_mode not in ("tp", "sp"):
            raise ValueError(f"act_mode must be 'tp' or 'sp': {self.act_mode!r}")
        if self.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1: {self.microbatches}")
        if self.schedule not in SCHEDULE_KINDS:
            raise ValueError(f"schedule must be one of {SCHEDULE_KINDS}: "
                             f"{self.schedule!r}")

    @property
    def world(self) -> int:
        return self.dp * self.tp * self.pp

    @property
    def trivial(self) -> bool:
        return self.world == 1

    def tag(self) -> str:
        """Stable fingerprint for cache keys / report rows (the JAX
        package's, character for character).  The microbatch degree and
        schedule kind are appended only when non-default."""
        base = f"dp{self.dp}.tp{self.tp}.pp{self.pp}.{self.act_mode}"
        if self.microbatches != 1:
            base += f".mb{self.microbatches}"
        if self.schedule != "gpipe":
            base += f".{self.schedule}"
        return base


def _ceil_div(x: int, t: int) -> int:
    return max(-(-int(x) // int(t)), 1)


# Name-pattern sharding rules: column-parallel projections shard the output
# dim (n), row-parallel shard the contraction dim (k) and end in a partial
# sum the tp group must reduce.
_COL_SUFFIXES = (".wq", ".wk", ".wv", ".w_in", ".w_gate", ".up", ".wx",
                 ".rh", ".qkvo")
_ROW_SUFFIXES = (".wo", ".w_out", ".down")
_INNER_SUFFIXES = (".qkv", ".gates")      # square maps on the sharded width
_SEQ_SUFFIXES = (".ln", ".ln2", ".residual")   # hidden (T, d) activations
_ACT_SUFFIXES = (".act", ".expert_act", ".gate_mul", ".scan", ".conv",
                 ".kv_append", ".step")   # decode-phase per-head/width state


def _shard_matmul(op: MatmulOp, tp: int) -> MatmulOp:
    nm = op.name
    if nm == "unembed" or any(nm.endswith(s) for s in _COL_SUFFIXES):
        return dataclasses.replace(op, n=_ceil_div(op.n, tp))
    if any(nm.endswith(s) for s in _ROW_SUFFIXES):
        return dataclasses.replace(op, k=_ceil_div(op.k, tp))
    if any(nm.endswith(s) for s in _INNER_SUFFIXES):
        return dataclasses.replace(op, n=_ceil_div(op.n, tp),
                                   k=_ceil_div(op.k, tp))
    # MoE: experts shard over the tp axis
    if nm.endswith(".dispatch"):
        return dataclasses.replace(op, m=_ceil_div(op.m, tp))
    if nm.endswith(".expert_in") or nm.endswith(".expert_out") \
            or nm.endswith(".state"):
        return dataclasses.replace(op, batch=_ceil_div(op.batch, tp))
    if nm.endswith(".combine"):
        return dataclasses.replace(op, k=_ceil_div(op.k, tp))
    return op


def _shard_attention(op: AttentionOp, tp: int) -> AttentionOp:
    return dataclasses.replace(op, heads=_ceil_div(op.heads, tp),
                               kv_heads=_ceil_div(op.kv_heads, tp))


def _shard_memory(op: MemoryOp, tp: int, act_mode: str) -> MemoryOp:
    nm, shape = op.name, op.shape
    if nm == "embed":                     # vocab-parallel embedding table
        return dataclasses.replace(op, shape=(_ceil_div(shape[0], tp),)
                                   + shape[1:])
    if nm.endswith(".rope"):              # (T, heads, hd): heads sharded
        return dataclasses.replace(
            op, shape=(shape[0], _ceil_div(shape[1], tp)) + shape[2:])
    if nm == "mlstm.gate" or any(nm.endswith(s) for s in _ACT_SUFFIXES):
        # activations between a column- and a row-parallel projection:
        # the feature dim is sharded in both act modes
        return dataclasses.replace(op, shape=shape[:-1]
                                   + (_ceil_div(shape[-1], tp),))
    if act_mode == "sp" and (nm == "final_norm"
                             or any(nm.endswith(s) for s in _SEQ_SUFFIXES)):
        # sequence parallelism shards the (T, d) hidden states over tp
        return dataclasses.replace(op, shape=(_ceil_div(shape[0], tp),)
                                   + shape[1:])
    return op                             # replicated ('tp' mode hiddens,
                                          # router softmax, ...)


def _shard_op(op: Op, spec: ParallelismSpec) -> Op:
    if spec.tp == 1:
        return op
    if isinstance(op, MatmulOp):
        return _shard_matmul(op, spec.tp)
    if isinstance(op, AttentionOp):
        return _shard_attention(op, spec.tp)
    if isinstance(op, MemoryOp):
        return _shard_memory(op, spec.tp, spec.act_mode)
    return op


def _row_parallel_per_layer(cfg: C.ModelConfig, kind: str) -> int:
    """Forward row-parallel projections per layer of ``kind``: each ends in
    a partial-sum hidden state the tp group must reduce (Megatron: one after
    attention's wo, one after the MLP's w_out)."""
    ffn = 0
    if kind in (C.ATTN, C.LOCAL_ATTN, C.ENC_ATTN, C.CROSS_ATTN, C.RGLRU):
        if cfg.moe is not None:
            ffn = 1 + cfg.moe.num_shared_experts
        elif cfg.d_ff > 0:
            ffn = 1
    if kind in (C.ATTN, C.LOCAL_ATTN, C.ENC_ATTN):
        return 1 + ffn
    if kind == C.CROSS_ATTN:
        return 2 + ffn                    # self.wo + cross.wo
    if kind == C.RGLRU:
        return 1 + ffn                    # rglru.w_out
    if kind == C.MLSTM:
        return 1                          # mlstm.down
    if kind == C.SLSTM:
        return 1                          # slstm.ff w_out
    return 0


# Layer kinds whose blocks carry an FFN: under MoE these route tokens
# through experts.
_FFN_KINDS = (C.ATTN, C.LOCAL_ATTN, C.CROSS_ATTN, C.RGLRU, C.ENC_ATTN)


def moe_routed_bytes(cfg: C.ModelConfig, batch: int, seq: int,
                     dt: str) -> float:
    """Full (unsharded) payload of ONE MoE layer's dispatch (== combine)
    all-to-all: the routed ``(G, E·cap, d_model)`` activation, with the
    capacity floor the expert bmms use."""
    m = cfg.moe
    T = batch * seq
    G = batch
    Sg = T // G
    cap = max(int(m.capacity_factor * Sg * m.top_k / m.num_experts),
              m.top_k, 4)
    return float(G * m.num_experts * cap * cfg.d_model * dtype_bytes(dt))


def _moe_all_to_all(cfg: C.ModelConfig, batch: int, seq: int, tp: int,
                    dt: str, count: int = 1) -> List[Op]:
    """Dispatch + combine token-routing all-to-alls for ``count`` MoE
    layers (experts are sharded over the tp axis, as ``_shard_matmul``)."""
    routed = moe_routed_bytes(cfg, batch, seq, dt)
    return [
        CollectiveOp("moe.dispatch.all_to_all", "all_to_all", routed, tp,
                     count=count, dtype=dt),
        CollectiveOp("moe.combine.all_to_all", "all_to_all", routed, tp,
                     count=count, dtype=dt),
    ]


def tp_boundary_reductions(name: str, nbytes: float, spec: ParallelismSpec,
                           dt: str, count: int = 1) -> List[Op]:
    """The collective(s) one partial-sum boundary induces under ``spec``'s
    act mode: one all-reduce in Megatron-TP, a reduce-scatter + all-gather
    pair of the same bytes in sequence-parallel mode.  Both the flat
    expansion and ``core/schedule.py``'s per-layer pipeline stages emit
    through it."""
    if count <= 0 or spec.tp <= 1:
        return []
    if spec.act_mode == "sp":
        return [CollectiveOp(f"{name}.reduce_scatter", "reduce_scatter",
                             nbytes, spec.tp, count=count, dtype=dt),
                CollectiveOp(f"{name}.all_gather", "all_gather",
                             nbytes, spec.tp, count=count, dtype=dt)]
    return [CollectiveOp(f"{name}.all_reduce", "all_reduce", nbytes,
                         spec.tp, count=count, dtype=dt)]


def _induced_collectives(cfg: C.ModelConfig, batch: int, seq: int,
                         spec: ParallelismSpec, dt: str) -> List[Op]:
    """The CollectiveOps one rank issues during a forward pass under
    ``spec``.  Data parallelism induces none (the gradient all-reduce is a
    training-step concern: ``core/schedule.py``'s training graph)."""
    out: List[Op] = []
    esz = dtype_bytes(dt)
    T = batch * seq
    hid_bytes = float(T * cfg.d_model * esz)
    tp, pp = spec.tp, spec.pp

    def emit(name: str, nbytes: float, n_ops: int):
        out.extend(tp_boundary_reductions(name, nbytes, spec, dt,
                                          count=n_ops))

    if tp > 1:
        for kind, n in sorted(Counter(cfg.layer_kinds).items()):
            emit(f"{kind}.tp", hid_bytes,
                 n * _row_parallel_per_layer(cfg, kind))
        if cfg.encoder is not None:
            enc_bytes = float(batch * cfg.encoder.n_frames * cfg.d_model * esz)
            emit("enc.tp", enc_bytes, 2 * cfg.encoder.n_layers)
        # vocab-parallel embed: masked partial embeddings are summed
        out.append(CollectiveOp("embed.tp.all_reduce", "all_reduce",
                                hid_bytes, tp, dtype=dt))
        # vocab-parallel logits gathered for decoding
        Vp = pad_vocab(cfg.vocab_size)
        out.append(CollectiveOp("unembed.tp.all_gather", "all_gather",
                                float(T * Vp * esz), tp, dtype=dt))
        # MoE: expert parallelism over the tp axis routes tokens through
        # dispatch/combine all-to-alls
        if cfg.moe is not None:
            n_moe = sum(1 for k in cfg.layer_kinds if k in _FFN_KINDS)
            if n_moe:
                out += _moe_all_to_all(cfg, batch, seq, tp, dt, count=n_moe)
    if pp > 1:
        # single-microbatch pipeline: stage hand-offs are sequential p2p
        # sends of the (T, d) activation
        out.append(CollectiveOp("pp.activation_p2p", "p2p", hid_bytes, 2,
                                count=pp - 1, dtype=dt))
    return out


def enumerate_parallel_ops(cfg: C.ModelConfig, batch: int, seq: int,
                           spec: ParallelismSpec,
                           dtype: Optional[str] = None) -> List[Op]:
    """ONE RANK's op list for tokens (batch, seq) executed under ``spec``:

    * dp shards the batch (per-rank batch = ⌈batch/dp⌉, no forward comm),
    * tp shards each op by the ``_shard_*`` name rules and appends the
      induced reductions/gathers,
    * pp leaves the per-rank compute equal to the full stack: a
      single-microbatch pipeline's latency is the sum of all stages plus
      the (pp-1) activation hand-offs appended here.

    ``spec.trivial`` returns ``enumerate_ops`` unchanged."""
    if spec.trivial:
        return enumerate_ops(cfg, batch, seq, dtype=dtype)
    dt = dtype or "float32"
    bsh = _ceil_div(batch, spec.dp)
    ops = [_shard_op(op, spec) for op in enumerate_ops(cfg, bsh, seq,
                                                       dtype=dtype)]
    return ops + _induced_collectives(cfg, bsh, seq, spec, dt)
