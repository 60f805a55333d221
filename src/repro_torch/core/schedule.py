"""Two-stream list-schedule simulator: price an ``OpGraph`` as makespan
(the JAX package's ``core/schedule.py``, numpy on both sides).

PM2Lat (paper §III) aggregates per-kernel predictions sequentially; that is
exact for a single device but wrong whenever compute and communication (or
two pipeline stages) overlap.  This module prices the dependency/stream-
aware ``OpGraph`` IR (``core/opgraph.py``) with a deterministic list
schedule instead of a sum:

* each node runs on a named stream (``'compute'``, ``'comm'``, per-stage
  ``'compute.s<i>'``, per-link ``'comm.pp<i>'``, ...);
* a node starts at ``max(stream available, all dependencies finished)``;
* the makespan is the last finish time.

Three schedule families are built here:

1. **Micro-batched pipeline** (``ParallelismSpec.microbatches`` under
   ``pp > 1``): per-stage, per-microbatch op segments with p2p activation
   hand-offs; the ``(pp-1)/(pp+mb-1)`` GPipe bubble emerges from the
   schedule.  ``ParallelismSpec.schedule`` selects GPipe, 1F1B or
   interleaved virtual stages (``VIRTUAL_STAGES`` chunks per device).
   Under ``pp == 1`` the microbatches run as sequential chunks.
2. **Bucketed gradient all-reduce**: a ``TrainingStepSpec`` prices one
   optimizer step: forward + backward (``bwd_fwd_ratio`` × forward
   compute, collectives mirrored at 1×), the data-parallel gradient
   all-reduce split into DDP-style buckets that overlap the tail of
   backward, and the optimizer update priced by the memory model.
3. **Stage-level pipeline** (``pipeline_stage_schedule``): the partition
   planners' objective, already-priced stage times scheduled as a
   micro-batched pipeline.

Below them, the vectorized strategy sweep (``sweep_strategies``) and the
continuous-batching serving simulator (``simulate_serving``).

The arithmetic is the JAX package's, in the same order: ``simulate`` adds
sequentially, while ``Schedule.sequential_seconds`` and ``predict_ops`` use
``sum()``, which Python 3.12 compensates, so a serialized chain's makespan
can differ from that sum in the last bits.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import base as C
from repro_torch.core import opgraph as og
from repro_torch.core.collectives import CollectiveOp, dtype_bytes
from repro_torch.core.predictor import PredictionRow
from repro_torch.models.layers import pad_vocab


@dataclasses.dataclass(frozen=True)
class TrainingStepSpec:
    """What one optimizer step looks like, beyond the forward pass.

    ``bucket_mb`` is the DDP-style gradient-bucket size (MiB): the
    data-parallel all-reduce is issued per bucket as backward produces the
    corresponding gradients, so small buckets overlap more (and pay more
    latency terms).  ``bwd_fwd_ratio`` is the standard backward/forward
    compute ratio (2×: grads w.r.t. inputs and weights)."""
    optimizer: str = "adamw"        # 'adamw' | 'sgd'
    bucket_mb: float = 25.0         # gradient all-reduce bucket size (MiB)
    bwd_fwd_ratio: float = 2.0

    def __post_init__(self):
        if self.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}; "
                             "expected 'adamw' or 'sgd'")
        if self.bucket_mb <= 0 or self.bwd_fwd_ratio <= 0:
            raise ValueError(f"invalid TrainingStepSpec: {self}")

    def tag(self) -> str:
        """Stable fingerprint for cache keys / report rows.  The backward
        ratio is appended only when non-default, keeping common tags
        short."""
        base = f"{self.optimizer}.bkt{self.bucket_mb:g}"
        if self.bwd_fwd_ratio != 2.0:
            base += f".bwd{self.bwd_fwd_ratio:g}"
        return base


# Optimizer-update traffic multiplier: the jit-lowered snippet fuses to one
# read + one write of the parameter tensor, while a real update streams
# param+grad+moments in and param+moments out (~3x that for AdamW).
_OPT_SNIPPET = {"adamw": ("adamw_update", 3), "sgd": ("sgd_update", 1)}

# Optimizer state bytes per parameter held resident on each rank (fp32
# moment tensors: AdamW keeps two, SGD none) — the peak-memory estimator's
# optimizer term.
_OPT_STATE_BYTES = {"adamw": 8.0, "sgd": 0.0}

# Virtual-stage interleave degree for ``schedule='interleaved'``: each
# device runs this many non-contiguous layer chunks (Megatron's
# virtual-pipeline "model chunks"), shrinking the fill/drain bubble from
# ``pp-1`` to ``(pp-1)/v`` microbatch slots at the cost of ``v×`` the p2p
# hand-offs.  A module constant (not a spec field) keeps the strategy
# space — and the cache-tag surface — small.
VIRTUAL_STAGES = 2


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

def simulate(durations: Sequence[float], streams: Sequence[str],
             deps: Sequence[Tuple[int, ...]]
             ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Deterministic list schedule over named streams.

    Nodes must be in topological order (dep indices < own index — what the
    ``OpGraph`` builders guarantee).  Returns ``(starts, ends, makespan)``.
    A fully serialized chain adds its durations left to right, one float
    addition a node: the sequential aggregation, but not Python 3.12's
    compensated ``sum()``, which can differ in the last bits.
    """
    n = len(durations)
    starts = np.zeros(n)
    ends = np.zeros(n)
    avail: Dict[str, float] = {}
    for i in range(n):
        t = avail.get(streams[i], 0.0)
        for d in deps[i]:
            if ends[d] > t:
                t = ends[d]
        starts[i] = t
        ends[i] = t + durations[i]
        avail[streams[i]] = float(ends[i])
    makespan = float(ends.max()) if n else 0.0
    return starts, ends, makespan


def simulate_batch(durations: np.ndarray, streams: Sequence[str],
                   deps: Sequence[Tuple[int, ...]]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched list schedule: ``durations`` is ``(S, N)`` — S specs sharing
    ONE graph shape (same ``streams`` + ``deps``), differing only in
    per-node durations.  This is the sweep kernel: the per-node event
    propagation runs once, with every per-spec update a length-S vector op,
    instead of S full Python walks.

    Row ``s`` performs exactly the same max/add sequence as
    ``simulate(durations[s], streams, deps)``, so each row is bit-identical
    to the scalar simulator.  Returns ``(starts, ends, makespans)`` of
    shapes ``(S, N)``, ``(S, N)``, ``(S,)``.
    """
    D = np.asarray(durations, dtype=np.float64)
    S, n = D.shape
    ids: Dict[str, int] = {}
    sid = [ids.setdefault(st, len(ids)) for st in streams]
    # (N, S) layout so per-node rows are contiguous in the hot loop
    Dt = np.ascontiguousarray(D.T)
    starts = np.empty((n, S))
    ends = np.empty((n, S))
    avail = np.zeros((max(len(ids), 1), S))
    for i in range(n):
        t = avail[sid[i]]
        for d in deps[i]:
            t = np.maximum(t, ends[d])
        starts[i] = t
        np.add(t, Dt[i], out=ends[i])
        avail[sid[i]] = ends[i]
    makespans = ends.max(axis=0) if n else np.zeros(S)
    return starts.T, ends.T, makespans


def _interval_union(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Total measure of the union of ``[start, end)`` intervals along the
    last axis (leading axes are independent rows): sort by start, then each
    interval contributes ``max(0, end - max(start, running max of earlier
    ends))`` — the part not already covered."""
    starts = np.asarray(starts, dtype=np.float64)
    ends = np.asarray(ends, dtype=np.float64)
    if starts.shape[-1] == 0:
        return np.zeros(starts.shape[:-1])
    order = np.argsort(starts, axis=-1, kind="stable")
    s = np.take_along_axis(starts, order, axis=-1)
    e = np.take_along_axis(ends, order, axis=-1)
    covered = np.maximum.accumulate(e, axis=-1)
    prev = np.concatenate(
        [np.full(s.shape[:-1] + (1,), -np.inf), covered[..., :-1]], axis=-1)
    return np.maximum(e - np.maximum(s, prev), 0.0).sum(axis=-1)


@dataclasses.dataclass
class Schedule:
    """A priced, simulated ``OpGraph``: per-node rows (same order as the
    graph) plus the stream timeline the list scheduler produced."""
    rows: List[PredictionRow]
    streams: List[str]
    starts: np.ndarray
    ends: np.ndarray
    makespan: float
    kind: str = "gpipe"           # schedule kind: bubble accounting rule

    @property
    def sequential_seconds(self) -> float:
        """What the pre-schedule sequential aggregation would report."""
        return sum(r.seconds for r in self.rows)

    @property
    def comm_seconds(self) -> float:
        """Total communication work (sum over collective rows — busy time,
        not necessarily on the critical path)."""
        return sum(r.seconds for r in self.rows if r.kind == "collective")

    @property
    def compute_seconds(self) -> float:
        """Total compute work (sum over non-collective rows)."""
        return sum(r.seconds for r in self.rows if r.kind != "collective")

    @property
    def exposed_comm_seconds(self) -> float:
        """Communication (and bubble) time NOT hidden behind compute:
        ``makespan`` minus the measure of the UNION of the busy intervals of
        all non-collective nodes — the wall-clock span during which no
        compute runs anywhere.

        The union is taken from the simulated timeline, not from summed
        busy time: with one compute stream the two agree, but a multi-stage
        pipeline sums per-stage busy time past the makespan, which floored
        the old ``makespan - compute_seconds`` definition to 0.0 exactly
        where the overlap signal matters (pp > 1: in a two-stage worked
        example 10 ms of hand-off is provably exposed).  Because the list schedule is
        work-conserving, some node is always running before the makespan,
        so the exposed span is covered by collective intervals and
        ``exposed_comm_seconds <= comm_seconds`` still holds."""
        comp = [i for i, r in enumerate(self.rows)
                if r.kind != "collective"]
        union = float(_interval_union(self.starts[comp], self.ends[comp]))
        return max(self.makespan - union, 0.0)

    def busy(self) -> Dict[str, float]:
        """Busy seconds per stream."""
        out: Dict[str, float] = {}
        for r, s in zip(self.rows, self.streams):
            out[s] = out.get(s, 0.0) + r.seconds
        return out

    @property
    def bubble_share(self) -> float:
        """Idle share of the compute executors, under the accounting rule
        of the schedule ``kind`` the graph was wired with.

        * ``'gpipe'`` / ``'interleaved'`` — idle fraction of the makespan:
          ``1 - total compute busy / (n_compute_streams · makespan)``.  For
          a balanced micro-batched GPipe pipeline this is the classic
          ``(pp-1)/(pp+mb-1)`` bubble — emerging from the schedule, not a
          formula — and it shrinks monotonically as microbatches grow even
          when smaller per-chunk shapes make the absolute makespan worse
          (fixed per-op overheads).
        * ``'1f1b'`` — idle time relative to IDEAL compute,
          ``(n_streams · makespan - busy) / busy``: the convention the
          1F1B literature quotes, whose balanced-pipeline value is the
          steady-state ``(pp-1)/mb``.  Same idle time, different
          denominator — the two rules coincide only as the bubble → 0.

        Only the per-stage ``compute.s<i>`` executors count when present —
        the bare ``compute`` stream (e.g. the optimizer node in training
        schedules) is not a pipeline stage."""
        busy = self.busy()
        comp = {s: b for s, b in busy.items() if s.startswith("compute.s")}
        if not comp:
            comp = {s: b for s, b in busy.items()
                    if s.startswith(og.COMPUTE_STREAM)}
        if not comp or self.makespan <= 0:
            return 0.0
        total = sum(comp.values())
        idle = max(len(comp) * self.makespan - total, 0.0)
        if self.kind == "1f1b":
            return idle / total if total > 0 else 0.0
        return idle / (len(comp) * self.makespan)

    def bounds_ok(self, rel: float = 1e-9) -> bool:
        """The acceptance invariant: busiest stream <= makespan <= the
        sequential sum (up to float accumulation noise)."""
        hi = self.sequential_seconds
        lo = max(self.busy().values()) if self.rows else 0.0
        return (lo <= self.makespan * (1 + rel)
                and self.makespan <= hi * (1 + rel))


def schedule_graph(predictor, graph: og.OpGraph,
                   kind: str = "gpipe") -> Schedule:
    """Price every node through ``predictor`` (scalar ``PM2Lat`` or the
    vectorized ``BatchPredictor`` — both expose ``predict_ops``) and
    simulate the two-stream list schedule.  ``kind`` tags the result with
    the schedule flavour so ``Schedule.bubble_share`` applies the right
    accounting rule."""
    _, rows = predictor.predict_ops(graph.ops())
    streams = [n.stream for n in graph.nodes]
    deps = [n.deps for n in graph.nodes]
    starts, ends, makespan = simulate([r.seconds for r in rows],
                                      streams, deps)
    return Schedule(rows, streams, starts, ends, makespan, kind=kind)


# ---------------------------------------------------------------------------
# graph builders: forward (parallel) schedules
# ---------------------------------------------------------------------------

_ceil_div = og._ceil_div


def _stage_ops(cfg: C.ModelConfig, bmb: int, seq: int,
               spec: og.ParallelismSpec, dt: str,
               segments: Optional[Tuple] = None,
               n_stages: Optional[int] = None
               ) -> Tuple[List[List[og.Op]], float]:
    """One microbatch's ops per pipeline stage (tp-sharded, per-layer tp
    collectives inline), plus the stage-boundary activation payload.

    Layers split contiguously and near-evenly over ``n_stages`` segments
    (default ``spec.pp``; the interleaved builders pass
    ``pp · VIRTUAL_STAGES`` to get per-virtual-chunk op lists); the
    embedding (+ encoder) lands on stage 0, final norm + unembed on the
    last stage, with their vocab-parallel collectives.  ``segments`` lets a
    sweep pass a precomputed ``og.layer_segments(cfg, bmb, seq)`` so the
    per-layer re-enumeration is shared across every spec with the same
    microbatch shape."""
    head, per_layer, tail = (segments if segments is not None
                             else og.layer_segments(cfg, bmb, seq, dtype=dt))
    shard = lambda ops: [og._shard_op(o, spec) for o in ops]
    esz = dtype_bytes(dt)
    T = bmb * seq
    hid_bytes = float(T * cfg.d_model * esz)
    pp, tp = int(n_stages) if n_stages else spec.pp, spec.tp
    n_layers = len(per_layer)
    bounds = [round(i * n_layers / pp) for i in range(pp + 1)]
    stages: List[List[og.Op]] = []
    for s in range(pp):
        ops: List[og.Op] = []
        if s == 0:
            ops += shard(head)
            if tp > 1:
                ops.append(CollectiveOp("embed.tp.all_reduce", "all_reduce",
                                        hid_bytes, tp, dtype=dt))
                if cfg.encoder is not None:
                    enc_bytes = float(bmb * cfg.encoder.n_frames
                                      * cfg.d_model * esz)
                    ops += og.tp_boundary_reductions(
                        "enc.tp", enc_bytes, spec, dt,
                        count=2 * cfg.encoder.n_layers)
        for li in range(bounds[s], bounds[s + 1]):
            kind = cfg.layer_kinds[li]
            ops += shard(per_layer[li])
            ops += og.tp_boundary_reductions(
                f"{kind}.tp", hid_bytes, spec, dt,
                count=og._row_parallel_per_layer(cfg, kind))
            if tp > 1 and cfg.moe is not None and kind in og._FFN_KINDS:
                ops += og._moe_all_to_all(cfg, bmb, seq, tp, dt)
        if s == pp - 1:
            ops += shard(tail)
            if tp > 1:
                Vp = pad_vocab(cfg.vocab_size)
                ops.append(CollectiveOp("unembed.tp.all_gather", "all_gather",
                                        float(T * Vp * esz), tp, dtype=dt))
        stages.append(ops)
    return stages, hid_bytes


def _wire_pipeline_grid(pp: int, mb: int, add_stage, add_p2p,
                        last_in_stage: List[Optional[int]],
                        reverse: bool = False) -> None:
    """THE (stage × microbatch) dependency wiring, shared by the op-level
    grids and the planners' stage-level scheduler: stage ``s`` of
    microbatch ``m`` depends on stage ``s`` of microbatch ``m-1`` (same
    executor, serialized by its stream) and on the p2p hand-off from the
    upstream stage of the same microbatch.  ``add_stage(m, s, deps)``
    appends one stage node-chain and returns its last id (or None for an
    empty stage); ``add_p2p(m, s, link, dep)`` appends one hand-off and
    returns its id.  ``reverse`` flows stage-last-to-first (the backward
    pass); ``last_in_stage`` is read and updated in place so successive
    grids chain."""
    order = range(pp - 1, -1, -1) if reverse else range(pp)
    first = order[0]
    for m in range(mb):
        prev_last: Optional[int] = None
        for s in order:
            deps: List[int] = []
            if s != first and prev_last is not None:
                link = s if not reverse else s + 1
                deps.append(add_p2p(m, s, link, prev_last))
            if last_in_stage[s] is not None:
                deps.append(last_in_stage[s])
            nid = add_stage(m, s, tuple(deps))
            prev_last = nid if nid is not None else (deps[0] if deps
                                                     else None)
            last_in_stage[s] = prev_last


def _1f1b_stage_order(pp: int, mb: int, s: int) -> List[Tuple[str, int]]:
    """Stage ``s``'s static op order under 1F1B: warmup of
    ``W = min(pp - s, mb)`` forwards, then strict one-backward-one-forward
    alternation, then the remaining backwards (cooldown).  The warmup depth
    is exactly what bounds the in-flight activations at ``min(pp - s, mb)``
    — the schedule's memory win over GPipe's ``mb``."""
    warm = min(pp - s, mb)
    seq: List[Tuple[str, int]] = [("F", m) for m in range(warm)]
    nf, nb = warm, 0
    while nb < mb:
        seq.append(("B", nb))
        nb += 1
        if nf < mb:
            seq.append(("F", nf))
            nf += 1
    return seq


def _wire_1f1b(pp: int, mb: int, add_fwd, add_bwd, add_act_p2p,
               add_grad_p2p) -> None:
    """One-forward-one-backward pipeline wiring (Megatron/PipeDream-flush).

    Each stage executes its ``_1f1b_stage_order`` sequence, serialized on
    its own ``compute.s<s>`` stream; ``F_m@s`` waits on the activation p2p
    from ``F_m@(s-1)``, ``B_m@s`` on the gradient p2p from ``B_m@(s+1)``
    (and, on the last stage, on its own ``F_m`` via stage serialization).
    Nodes are emitted by a round-robin readiness sweep over the per-stage
    sequences — 1F1B's warmup depths make that deadlock-free — so the node
    list stays topological for the list scheduler.

    The wiring callbacks mirror ``_wire_pipeline_grid``'s: ``add_fwd`` /
    ``add_bwd(m, s, deps)`` append one stage chain and return its last node
    id (None for an empty stage); ``add_act_p2p`` / ``add_grad_p2p(m, s,
    dep)`` append one hand-off.  Empty stages (pp > layer count) propagate
    their feeding p2p id — or the sentinel -1 when there is nothing
    upstream — exactly like the GPipe grid's ``prev_last`` fallback."""
    orders = [_1f1b_stage_order(pp, mb, s) for s in range(pp)]
    # None = not emitted yet; -1 = emitted but empty (no node to depend
    # on); >= 0 = last node id of that (stage, microbatch) chain.
    fwd_done: List[List[Optional[int]]] = [[None] * mb for _ in range(pp)]
    bwd_done: List[List[Optional[int]]] = [[None] * mb for _ in range(pp)]
    last: List[Optional[int]] = [None] * pp
    ptr = [0] * pp
    remaining = 2 * pp * mb
    while remaining:
        progressed = False
        for s in range(pp):
            while ptr[s] < len(orders[s]):
                what, m = orders[s][ptr[s]]
                if what == "F":
                    up = fwd_done[s - 1][m] if s > 0 else -1
                    if up is None:
                        break                   # upstream F not emitted yet
                    deps: List[int] = []
                    pid: Optional[int] = None
                    if up >= 0:
                        pid = add_act_p2p(m, s, up)
                        deps.append(pid)
                    if last[s] is not None:
                        deps.append(last[s])
                    nid = add_fwd(m, s, tuple(deps))
                    done, src = fwd_done, nid
                else:
                    dn = bwd_done[s + 1][m] if s < pp - 1 else -1
                    if dn is None:
                        break                   # downstream B not emitted
                    deps = []
                    pid = None
                    if s < pp - 1 and dn >= 0:
                        pid = add_grad_p2p(m, s, dn)
                        deps.append(pid)
                    if last[s] is not None:
                        deps.append(last[s])
                    nid = add_bwd(m, s, tuple(deps))
                    done, src = bwd_done, nid
                eff = src if src is not None else (
                    pid if pid is not None else -1)
                done[s][m] = eff
                if eff >= 0:
                    last[s] = eff
                ptr[s] += 1
                remaining -= 1
                progressed = True
        if remaining and not progressed:        # pragma: no cover
            raise RuntimeError("1F1B wiring deadlocked — stage orders "
                               "inconsistent with p2p dependencies")


def _wire_interleaved(pp: int, v: int, mb: int, add_chunk, add_p2p,
                      last: List[Optional[int]], *,
                      reverse: bool = False) -> None:
    """Interleaved-virtual-stage wiring (Megatron virtual pipeline): the
    layer stack splits into ``v·pp`` chunks, chunk ``c`` living on device
    ``c mod pp`` (stream ``compute.s<c mod pp>``).  Insertion order is the
    Megatron grouping — chunk group ``g``'s microbatches before group
    ``g+1``'s, i.e. global order ``(g, m, d)`` with ``c = g·pp + d`` —
    which is what shrinks the fill to ``(pp-1)/v`` microbatch slots: a
    device starts group 0's chunk after only ``d`` upstream chunk times,
    not ``d`` full stage times.  ``reverse`` emits the mirrored backward
    order ``(g desc, m, d desc)`` with gradient hand-offs flowing chunk
    ``c+1 → c``.

    ``add_chunk(c, m, deps)`` appends one chunk chain and returns its last
    id (None when empty); ``add_p2p(c, m, dep)`` appends the hand-off INTO
    chunk ``c``.  ``last`` (per device) is read and updated in place so a
    forward and a backward grid chain on the device streams, exactly like
    ``_wire_pipeline_grid``'s ``last_in_stage``."""
    nchunks = pp * v
    done: List[List[Optional[int]]] = [[None] * mb for _ in range(nchunks)]
    for g in (range(v - 1, -1, -1) if reverse else range(v)):
        for m in range(mb):
            for d in (range(pp - 1, -1, -1) if reverse else range(pp)):
                c = g * pp + d
                up = c + 1 if reverse else c - 1
                deps: List[int] = []
                pid: Optional[int] = None
                if 0 <= up < nchunks:
                    u = done[up][m]
                    assert u is not None, (c, m, "wired before upstream")
                    if u >= 0:
                        pid = add_p2p(c, m, u)
                        deps.append(pid)
                if last[d] is not None:
                    deps.append(last[d])
                nid = add_chunk(c, m, tuple(deps))
                eff = nid if nid is not None else (
                    pid if pid is not None else -1)
                done[c][m] = eff
                if eff >= 0:
                    last[d] = eff


# ---------------------------------------------------------------------------
# graph templates: symbolic wiring shared across specs
# ---------------------------------------------------------------------------
# A sweep prices thousands of ParallelismSpecs over the SAME structural
# shapes: for a fixed (pp, mb, collective-position, bucket-count) layout the
# wiring (streams + deps) is identical across specs, only op durations vary.
# The template layer therefore splits graph construction in two:
#
#   template — node list of (slot, stream, deps), built ONCE per shape by
#              the same ``_wire_pipeline_grid`` callbacks the op-level
#              builders always used;
#   bind     — per-spec op durations indexed into the slots
#              (``durations[:, template.slots]``) and simulated in one
#              ``simulate_batch`` call for the whole template group.
#
# ``build_parallel_graph`` / ``build_training_graph`` instantiate concrete
# ``OpGraph``s from the same templates, so the per-spec and swept paths can
# never disagree on structure.

_CLS_FWD, _CLS_BWD, _CLS_OPT = 0, 1, 2


class _TemplateBuilder:
    """Accumulates symbolic nodes ``(slot, stream, deps)`` — the template
    mirror of ``OpGraph.add`` / ``add_chain``."""

    def __init__(self):
        self.slots: List[int] = []
        self.streams: List[str] = []
        self.deps: List[Tuple[int, ...]] = []

    def __len__(self) -> int:
        return len(self.slots)

    def tail(self) -> Tuple[int, ...]:
        return (len(self.slots) - 1,) if self.slots else ()

    def add(self, slot: int, stream: str,
            deps: Sequence[int] = ()) -> int:
        self.slots.append(slot)
        self.streams.append(stream)
        self.deps.append(tuple(deps))
        return len(self.slots) - 1

    def add_chain(self, slot0: int, coll_mask: Sequence[bool],
                  deps: Sequence[int], compute_stream: str) -> List[int]:
        """Serialized chain over slots ``slot0 + j``; collective positions
        go on the shared comm stream, exactly like ``OpGraph.add_chain``."""
        ids: List[int] = []
        for j, is_coll in enumerate(coll_mask):
            stream = og.COMM_STREAM if is_coll else compute_stream
            ids.append(self.add(slot0 + j, stream, deps))
            deps = (ids[-1],)
        return ids


@dataclasses.dataclass
class GraphTemplate:
    """Symbolic schedule graph for one structural shape.

    ``slots[i]`` indexes node ``i``'s duration in a per-spec slot vector
    (slots repeat across microbatches: the grid reuses one stage's op list
    ``mb`` times).  ``simulate_slots`` binds ``(S, n_slots)`` durations and
    prices all S specs in one batched walk; ``_instantiate`` binds concrete
    ops into the same wiring for the per-spec ``OpGraph`` path.

    For the batched walk, maximal serialized same-stream runs that no other
    node depends into are fused to single nodes (their durations sum —
    that's the only float re-association between this path and the scalar
    simulator, bounded well under the 1e-9 golden-equivalence tolerance).
    """
    key: Tuple
    slots: np.ndarray               # (n_nodes,) -> slot id
    streams: List[str]              # per node
    deps: List[Tuple[int, ...]]     # per node
    n_slots: int
    slot_class: np.ndarray          # (n_slots,) _CLS_FWD | _CLS_BWD | _CLS_OPT
    last_bwd_ids: Tuple[int, ...] = ()   # training: last microbatch's
    #                                      backward compute node ids

    def __post_init__(self):
        n = len(self.slots)
        self.n_nodes = n
        # 1F1B quotes its bubble relative to ideal compute (idle/busy),
        # every other kind relative to the makespan — same rule as
        # Schedule.bubble_share's ``kind`` switch.
        self.bubble_ideal = bool(self.key) and self.key[0] == "trainpp1f1b"
        node_is_comm = np.array([st.startswith("comm")
                                 for st in self.streams], dtype=bool)
        self.slot_is_comm = np.zeros(self.n_slots, dtype=bool)
        self.slot_is_comm[self.slots] = node_is_comm
        self.slot_mult = np.bincount(
            self.slots, minlength=self.n_slots).astype(np.float64)
        # per-stream slot multiplicity (busy time = durs @ this matrix)
        self.stream_names = list(dict.fromkeys(self.streams))
        sid_of = {s: i for i, s in enumerate(self.stream_names)}
        sid = np.array([sid_of[s] for s in self.streams], dtype=np.int64)
        self.slot_stream_mult = np.zeros((self.n_slots,
                                          len(self.stream_names)))
        np.add.at(self.slot_stream_mult, (self.slots, sid), 1.0)
        # pipeline-executor columns for bubble_share (same rule as
        # Schedule.bubble_share: per-stage compute.s<i> streams when
        # present, else any compute* stream)
        cols = [i for i, s in enumerate(self.stream_names)
                if s.startswith("compute.s")]
        if not cols:
            cols = [i for i, s in enumerate(self.stream_names)
                    if s.startswith(og.COMPUTE_STREAM)]
        self.comp_cols = np.array(cols, dtype=np.int64)
        # ----- fused serial runs for the batched walk -----
        referenced = np.zeros(n, dtype=bool)
        for k, ds in enumerate(self.deps):
            for d in ds:
                if not (len(ds) == 1 and d == k - 1):
                    referenced[d] = True
        start_new = np.ones(n, dtype=bool)
        for i in range(1, n):
            if (self.deps[i] == (i - 1,)
                    and self.streams[i] == self.streams[i - 1]
                    and not referenced[i - 1]):
                start_new[i] = False
        self.run_starts = np.flatnonzero(start_new)
        run_of = np.cumsum(start_new) - 1
        self.run_streams = [self.streams[i] for i in self.run_starts]
        self.run_deps = [tuple(int(run_of[d]) for d in self.deps[i])
                         for i in self.run_starts]
        self.run_is_comm = node_is_comm[self.run_starts]

    def simulate_slots(self, slot_durs: np.ndarray
                       ) -> Dict[str, np.ndarray]:
        """Bind ``(S, n_slots)`` per-spec durations and price all S specs:
        returns the per-spec metric arrays (keys match ``StrategySweep``
        fields), each row matching the scalar ``Schedule`` to float
        re-association."""
        D = np.asarray(slot_durs, dtype=np.float64)
        Dn = D[:, self.slots]                               # (S, n_nodes)
        Dr = np.add.reduceat(Dn, self.run_starts, axis=1)
        starts, ends, mk = simulate_batch(Dr, self.run_streams,
                                          self.run_deps)
        keep = ~self.run_is_comm
        union = _interval_union(starts[:, keep], ends[:, keep])
        w = self.slot_mult
        not_coll = w * ~self.slot_is_comm
        busy = D @ self.slot_stream_mult                    # (S, n_streams)
        if self.comp_cols.size:
            comp_busy = busy[:, self.comp_cols].sum(axis=1)
            k = len(self.comp_cols)
            idle = np.maximum(k * mk - comp_busy, 0.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                if self.bubble_ideal:
                    bubble = np.where(comp_busy > 0,
                                      idle / np.maximum(comp_busy, 1e-300),
                                      0.0)
                else:
                    bubble = np.where(
                        mk > 0, idle / (k * np.maximum(mk, 1e-300)), 0.0)
        else:
            bubble = np.zeros(len(D))
        return {
            "seconds": mk,
            "compute_seconds": D @ not_coll,
            "comm_seconds": D @ (w * self.slot_is_comm),
            "exposed_comm_seconds": np.maximum(mk - union, 0.0),
            "sequential_seconds": D @ w,
            "bubble_share": bubble,
            "max_stream_busy": busy.max(axis=1),
            "fwd_seconds": D @ (not_coll * (self.slot_class == _CLS_FWD)),
            "bwd_seconds": D @ (not_coll * (self.slot_class == _CLS_BWD)),
            "optimizer_seconds": D @ (not_coll
                                      * (self.slot_class == _CLS_OPT)),
        }


def _instantiate(tpl: GraphTemplate,
                 slot_ops: Sequence[og.Op]) -> og.OpGraph:
    """Bind concrete ops into the symbolic wiring: node ``i`` executes
    ``slot_ops[tpl.slots[i]]`` on ``tpl.streams[i]``."""
    g = og.OpGraph()
    for slot, stream, deps in zip(tpl.slots, tpl.streams, tpl.deps):
        g.add(slot_ops[slot], stream=stream, deps=deps)
    return g


def _grid_template(tb: _TemplateBuilder,
                   stage_masks: Sequence[Sequence[bool]], mb: int,
                   stage_slot0: Sequence[int], p2p_slot0: int,
                   last_in_stage: List[Optional[int]], *,
                   reverse: bool = False,
                   record: Optional[List[List[int]]] = None) -> None:
    """Append a symbolic (stage × microbatch) grid over
    ``_wire_pipeline_grid``: stage ``s``'s chain binds slots
    ``stage_slot0[s] + j`` on ``compute.s<s>``, the hand-off for stage
    ``s`` binds ``p2p_slot0 + (s if reverse else s - 1)`` on its
    ``comm.pp<link>`` stream.  ``record`` collects every microbatch's node
    ids straight from the wiring callbacks — per-microbatch membership is
    never derived from node-count arithmetic (which an empty stage would
    break)."""

    def add_stage(m, s, deps):
        ids = tb.add_chain(stage_slot0[s], stage_masks[s], deps,
                           f"compute.s{s}")
        if record is not None:
            record[m].extend(ids)
        return ids[-1] if ids else None

    def add_p2p(m, s, link, dep):
        i = tb.add(p2p_slot0 + (s if reverse else s - 1),
                   f"comm.pp{link}", (dep,))
        if record is not None:
            record[m].append(i)
        return i

    _wire_pipeline_grid(len(stage_masks), mb, add_stage, add_p2p,
                        last_in_stage, reverse=reverse)


def _interleaved_template(tb: _TemplateBuilder,
                          chunk_masks: Sequence[Sequence[bool]],
                          pp: int, v: int, mb: int,
                          chunk_slot0: Sequence[int], p2p_slot0: int,
                          last: List[Optional[int]], *,
                          reverse: bool = False,
                          record: Optional[List[List[int]]] = None) -> None:
    """Append a symbolic interleaved (virtual-chunk × microbatch) grid over
    ``_wire_interleaved``: chunk ``c``'s chain binds slots
    ``chunk_slot0[c] + j`` on its device stream ``compute.s<c mod pp>``;
    the hand-off into chunk ``c`` binds ``p2p_slot0 + c - 1`` (forward) /
    ``p2p_slot0 + c`` (backward) on the boundary's link stream — with
    ``v == 1`` both reduce to ``_grid_template``'s layout.  Boundaries
    ``c`` and ``c + pp`` connect the same device pair, so they share a
    stream (the physical link serializes both virtual chunks' traffic)."""

    def add_chunk(c, m, deps):
        ids = tb.add_chain(chunk_slot0[c], chunk_masks[c], deps,
                           f"compute.s{c % pp}")
        if record is not None:
            record[m].extend(ids)
        return ids[-1] if ids else None

    def add_p2p(c, m, dep):
        slot = p2p_slot0 + (c if reverse else c - 1)
        link = (c + 1) % pp if reverse else c % pp
        i = tb.add(slot, f"comm.pp{link}", (dep,))
        if record is not None:
            record[m].append(i)
        return i

    _wire_interleaved(pp, v, mb, add_chunk, add_p2p, last, reverse=reverse)


def _bucket_anchors(bwd_ids: Sequence[int], n_buckets: int) -> List[int]:
    """DDP-style reverse-registration bucketing: bucket ``i`` becomes ready
    once the first ``(i+1)/n`` of the (reverse-order) backward nodes
    finish, so the gradient all-reduce overlaps the tail of backward."""
    nb = len(bwd_ids)
    return [bwd_ids[min(nb - 1, _ceil_div((i + 1) * nb, n_buckets) - 1)]
            for i in range(n_buckets)]


def _build_template(key: Tuple, masks: Sequence[Tuple[bool, ...]],
                    classes: Sequence[int]) -> GraphTemplate:
    """Construct the symbolic wiring for one template ``key``.  ``masks``
    holds each component's collective-position mask (components concatenate
    into the slot vector in order), ``classes`` the per-component
    fwd/bwd/opt class.  The key fully determines the wiring; specs sharing
    a key differ only in durations."""
    kind = key[0]
    offs = np.cumsum([0] + [len(m) for m in masks])
    slot_class = np.array([c for m, c in zip(masks, classes) for _ in m],
                          dtype=np.int8)
    tb = _TemplateBuilder()
    last_bwd: List[int] = []
    if kind == "chain":
        tb.add_chain(0, masks[0], (), og.COMPUTE_STREAM)
    elif kind == "chunks":
        for _ in range(key[1]):
            tb.add_chain(0, masks[0], tb.tail(), og.COMPUTE_STREAM)
    elif kind == "grid":
        pp, mb = key[1], key[2]
        last: List[Optional[int]] = [None] * pp
        _grid_template(tb, masks[:pp], mb, [int(o) for o in offs[:pp]],
                       int(offs[pp]), last)
    elif kind == "gridil":
        pp, mb, v = key[1], key[2], key[3]
        nch = pp * v
        last = [None] * pp
        _interleaved_template(tb, masks[:nch], pp, v, mb,
                              [int(o) for o in offs[:nch]], int(offs[nch]),
                              last)
    elif kind == "train1":
        mb = key[1]
        b_ids: List[int] = []
        for _ in range(mb):
            tb.add_chain(int(offs[0]), masks[0], tb.tail(),
                         og.COMPUTE_STREAM)
            b_ids = tb.add_chain(int(offs[1]), masks[1], tb.tail(),
                                 og.COMPUTE_STREAM)
        last_bwd = [i for i in b_ids
                    if not tb.streams[i].startswith("comm")]
    elif kind == "trainpp":
        pp, mb = key[1], key[2]
        last = [None] * pp
        per_mb: List[List[int]] = [[] for _ in range(mb)]
        # forward grid, then backward grid in reverse stage order (GPipe
        # flush: per-stage streams serialize bwd after that stage's fwd)
        _grid_template(tb, masks[:pp], mb, [int(o) for o in offs[:pp]],
                       int(offs[2 * pp]), last)
        _grid_template(tb, masks[pp:2 * pp], mb,
                       [int(o) for o in offs[pp:2 * pp]],
                       int(offs[2 * pp + 1]), last, reverse=True,
                       record=per_mb)
        # the last microbatch's backward compute nodes, in insertion order
        # (= reverse-stage = gradient-availability order), collected from
        # the wiring itself so empty stages can't skew the selection
        last_bwd = [i for i in per_mb[mb - 1]
                    if not tb.streams[i].startswith("comm")]
    elif kind == "trainpp1f1b":
        pp, mb = key[1], key[2]
        per_mb = [[] for _ in range(mb)]
        foffs = [int(o) for o in offs[:pp]]
        boffs = [int(o) for o in offs[pp:2 * pp]]
        fp2p0, bp2p0 = int(offs[2 * pp]), int(offs[2 * pp + 1])

        def add_fwd(m, s, deps):
            ids = tb.add_chain(foffs[s], masks[s], deps, f"compute.s{s}")
            return ids[-1] if ids else None

        def add_bwd(m, s, deps):
            ids = tb.add_chain(boffs[s], masks[pp + s], deps,
                               f"compute.s{s}")
            per_mb[m].extend(ids)
            return ids[-1] if ids else None

        # Hand-offs keep the GPipe slot layout (act p2p over link s = slot
        # s-1, grad p2p into stage s = slot s) but gradient hand-offs get
        # their own ``.g`` streams: under 1F1B forward and backward p2p
        # genuinely overlap in steady state, and NVLink/PCIe links are
        # full-duplex — sharing the stream would charge phantom contention.
        def add_act_p2p(m, s, dep):
            return tb.add(fp2p0 + s - 1, f"comm.pp{s}", (dep,))

        def add_grad_p2p(m, s, dep):
            return tb.add(bp2p0 + s, f"comm.pp{s + 1}.g", (dep,))

        _wire_1f1b(pp, mb, add_fwd, add_bwd, add_act_p2p, add_grad_p2p)
        last_bwd = [i for i in per_mb[mb - 1]
                    if not tb.streams[i].startswith("comm")]
    elif kind == "trainppil":
        pp, mb, v = key[1], key[2], key[3]
        nch = pp * v
        last = [None] * pp
        per_mb = [[] for _ in range(mb)]
        _interleaved_template(tb, masks[:nch], pp, v, mb,
                              [int(o) for o in offs[:nch]],
                              int(offs[2 * nch]), last)
        _interleaved_template(tb, masks[nch:2 * nch], pp, v, mb,
                              [int(o) for o in offs[nch:2 * nch]],
                              int(offs[2 * nch + 1]), last, reverse=True,
                              record=per_mb)
        last_bwd = [i for i in per_mb[mb - 1]
                    if not tb.streams[i].startswith("comm")]
    else:
        raise ValueError(f"unknown template kind {kind!r}")
    if kind in ("train1", "trainpp", "trainpp1f1b", "trainppil"):
        n_buckets = key[-1]           # every training key ends with it
        opt_deps: List[int] = list(tb.tail())
        if n_buckets and last_bwd:
            boff = int(offs[-3])          # bucket component precedes opt
            anchors = _bucket_anchors(last_bwd, n_buckets)
            bids = [tb.add(boff + i, og.COMM_STREAM, (anchors[i],))
                    for i in range(n_buckets)]
            opt_deps = ([opt_deps[-1], bids[-1]] if opt_deps
                        else [bids[-1]])
        tb.add(int(offs[-2]), og.COMPUTE_STREAM, tuple(opt_deps))
    return GraphTemplate(key=key, slots=np.array(tb.slots, dtype=np.int64),
                         streams=tb.streams, deps=tb.deps,
                         n_slots=int(offs[-1]), slot_class=slot_class,
                         last_bwd_ids=tuple(last_bwd))


class _SweepBuilder:
    """Shared working state for one sweep (or one graph build): unique op
    components — stage op lists, backward mirrors, p2p/bucket/optimizer
    ops — cached so specs share both enumeration and (later) pricing, plus
    the template cache keyed on structural shape."""

    def __init__(self, cfg: C.ModelConfig, batch: int, seq: int, dt: str):
        self.cfg, self.batch, self.seq, self.dt = cfg, int(batch), int(seq), dt
        self.uniq_ops: List[List[og.Op]] = []
        self.uniq_masks: List[Tuple[bool, ...]] = []
        self._comp: Dict[Tuple, int] = {}
        self._stage_sets: Dict[Tuple, Tuple[List[int], Tuple, float]] = {}
        self._segments: Dict[int, Tuple] = {}
        self._templates: Dict[Tuple, GraphTemplate] = {}

    # ----- unique components -----
    def _component(self, key: Tuple, make) -> int:
        ci = self._comp.get(key)
        if ci is None:
            ops = list(make())
            ci = len(self.uniq_ops)
            self.uniq_ops.append(ops)
            self.uniq_masks.append(
                tuple(isinstance(o, CollectiveOp) for o in ops))
            self._comp[key] = ci
        return ci

    def _flat(self, spec: og.ParallelismSpec, batch: int) -> int:
        """One serialized-chain component (``enumerate_parallel_ops`` at
        ``batch``), keyed on the per-rank batch shard — dp enters the op
        list only through ⌈batch/dp⌉."""
        bsh = _ceil_div(batch, spec.dp)
        return self._component(
            ("flat", bsh, spec.tp, spec.pp, spec.act_mode),
            lambda: og.enumerate_parallel_ops(self.cfg, batch, self.seq,
                                              spec, dtype=self.dt))

    def _stages(self, bmb: int, spec: og.ParallelismSpec,
                n_stages: Optional[int] = None
                ) -> Tuple[List[int], Tuple, float]:
        ns = int(n_stages) if n_stages else spec.pp
        key = ("stages", bmb, spec.tp, ns, spec.act_mode)
        hit = self._stage_sets.get(key)
        if hit is None:
            segs = self._segments.get(bmb)
            if segs is None:
                segs = og.layer_segments(self.cfg, bmb, self.seq,
                                         dtype=self.dt)
                self._segments[bmb] = segs
            stages, hid_bytes = _stage_ops(self.cfg, bmb, self.seq, spec,
                                           self.dt, segments=segs,
                                           n_stages=ns)
            idxs = [self._component(key + (s,), lambda ops=ops: ops)
                    for s, ops in enumerate(stages)]
            hit = (idxs, tuple(self.uniq_masks[i] for i in idxs), hid_bytes)
            self._stage_sets[key] = hit
        return hit

    def _bwd(self, fwd_idx: int, ratio: float) -> int:
        return self._component(
            ("bwd", fwd_idx, ratio),
            lambda: _backward_ops(self.uniq_ops[fwd_idx], ratio))

    def _p2p(self, prefix: str, pp: int, hid_bytes: float,
             reverse: bool) -> int:
        rng = range(pp - 1) if reverse else range(1, pp)
        return self._component(
            ("p2p", prefix, pp, hid_bytes),
            lambda: [CollectiveOp(f"{prefix}.s{s}", "p2p", hid_bytes, 2,
                                  dtype=self.dt) for s in rng])

    def _bucket_shape(self, spec: og.ParallelismSpec,
                      train: TrainingStepSpec) -> Tuple[int, float, float]:
        """(n_buckets, grad_bytes, bucket_bytes); no buckets under dp=1 —
        computable per spec without building any graph."""
        if spec.dp == 1:
            return 0, 0.0, 0.0
        grad_bytes = (self.cfg.param_count()
                      / (spec.tp * spec.pp)) * dtype_bytes(self.dt)
        bucket_bytes = train.bucket_mb * 2 ** 20
        n = max(int(math.ceil(grad_bytes / bucket_bytes)), 1)
        return n, grad_bytes, bucket_bytes

    def _buckets(self, grad_bytes: float, bucket_bytes: float,
                 dp: int) -> int:
        n = max(int(math.ceil(grad_bytes / bucket_bytes)), 1)
        return self._component(
            ("buckets", grad_bytes, bucket_bytes, dp),
            lambda: [CollectiveOp(
                f"grad.bucket{i}.all_reduce", "all_reduce",
                float(min(bucket_bytes, grad_bytes - i * bucket_bytes)),
                dp, dtype=self.dt) for i in range(n)])

    # ----- per-spec plan -----
    def spec_plan(self, spec: og.ParallelismSpec,
                  train: Optional[TrainingStepSpec]
                  ) -> Tuple[GraphTemplate, List[int]]:
        """The (template, component list) pair for one spec: components
        concatenate (in order) into the template's slot vector."""
        dp, tp, pp, mb = spec.dp, spec.tp, spec.pp, spec.microbatches
        bmb = _ceil_div(_ceil_div(self.batch, dp), mb)
        # Interleaving only exists for a multi-microbatch pipeline; a
        # forward-only pass under '1f1b' is GPipe by definition (nothing
        # to interleave), so it shares the plain grid template — and its
        # metrics — exactly.
        il = spec.schedule == "interleaved" and pp > 1 and mb > 1
        nch = pp * VIRTUAL_STAGES
        if train is None:
            if mb == 1:
                ci = self._flat(spec, self.batch)
                return self._template(("chain", self.uniq_masks[ci]),
                                      [ci], [_CLS_FWD])
            if pp == 1:
                chunk = dataclasses.replace(spec, microbatches=1)
                ci = self._flat(chunk, bmb * dp)
                return self._template(("chunks", mb, self.uniq_masks[ci]),
                                      [ci], [_CLS_FWD])
            if il:
                idxs, masks, hid = self._stages(bmb, spec, n_stages=nch)
                pi = self._p2p("pp.act_p2p", nch, hid, reverse=False)
                return self._template(
                    ("gridil", pp, mb, VIRTUAL_STAGES, masks), idxs + [pi],
                    [_CLS_FWD] * (nch + 1))
            idxs, masks, hid = self._stages(bmb, spec)
            pi = self._p2p("pp.act_p2p", pp, hid, reverse=False)
            return self._template(("grid", pp, mb, masks), idxs + [pi],
                                  [_CLS_FWD] * (pp + 1))
        n_buckets, grad_bytes, bucket_bytes = self._bucket_shape(spec, train)
        if pp == 1:
            chunk = dataclasses.replace(spec, microbatches=1)
            fi = self._flat(chunk, bmb * dp)
            bi = self._bwd(fi, train.bwd_fwd_ratio)
            comps = [fi, bi]
            classes = [_CLS_FWD, _CLS_BWD]
            key: Tuple = ("train1", mb, self.uniq_masks[fi], n_buckets)
        elif il:
            idxs, masks, hid = self._stages(bmb, spec, n_stages=nch)
            bidxs = [self._bwd(i, train.bwd_fwd_ratio) for i in idxs]
            fpi = self._p2p("pp.act_p2p", nch, hid, reverse=False)
            bpi = self._p2p("pp.grad_p2p", nch, hid, reverse=True)
            comps = idxs + bidxs + [fpi, bpi]
            classes = ([_CLS_FWD] * nch + [_CLS_BWD] * nch
                       + [_CLS_FWD, _CLS_BWD])
            key = ("trainppil", pp, mb, VIRTUAL_STAGES, masks, n_buckets)
        else:
            idxs, masks, hid = self._stages(bmb, spec)
            bidxs = [self._bwd(i, train.bwd_fwd_ratio) for i in idxs]
            fpi = self._p2p("pp.act_p2p", pp, hid, reverse=False)
            bpi = self._p2p("pp.grad_p2p", pp, hid, reverse=True)
            comps = idxs + bidxs + [fpi, bpi]
            classes = ([_CLS_FWD] * pp + [_CLS_BWD] * pp
                       + [_CLS_FWD, _CLS_BWD])
            kind = "trainpp1f1b" if spec.schedule == "1f1b" else "trainpp"
            key = (kind, pp, mb, masks, n_buckets)
        if n_buckets:
            comps.append(self._buckets(grad_bytes, bucket_bytes, dp))
            classes.append(_CLS_BWD)
        comps.append(self._component(
            ("opt", train.optimizer, tp * pp),
            lambda: [_optimizer_op(self.cfg, spec, train)]))
        classes.append(_CLS_OPT)
        return self._template(key, comps, classes)

    def _template(self, key: Tuple, comps: List[int],
                  classes: List[int]) -> Tuple[GraphTemplate, List[int]]:
        tpl = self._templates.get(key)
        if tpl is None:
            tpl = _build_template(key, [self.uniq_masks[c] for c in comps],
                                  classes)
            self._templates[key] = tpl
        return tpl, comps

    def slot_ops(self, comps: Sequence[int]) -> List[og.Op]:
        """The concrete per-spec slot op list (component concatenation)."""
        return [op for c in comps for op in self.uniq_ops[c]]


def build_parallel_graph(cfg: C.ModelConfig, batch: int, seq: int,
                         spec: og.ParallelismSpec,
                         dtype: Optional[str] = None) -> og.OpGraph:
    """The forward-pass schedule under ``spec``.

    * ``microbatches == 1`` — the flat one-rank op list
      (``opgraph.enumerate_parallel_ops``) as a serialized chain: scheduling
      it reproduces the historical sequential sum bit for bit (tp
      collectives are blocking — the next op consumes their output).
    * ``microbatches > 1, pp > 1`` — the pipeline grid (bubble emerges).
    * ``microbatches > 1, pp == 1`` — sequential chunked execution
      (gradient-accumulation-style forward).

    The multi-microbatch families are instantiated from the shared
    ``GraphTemplate`` layer, so this per-spec path and ``sweep_strategies``
    can never disagree on wiring."""
    if spec.microbatches == 1:
        return og.OpGraph.chain(
            og.enumerate_parallel_ops(cfg, batch, seq, spec, dtype=dtype))
    b = _SweepBuilder(cfg, batch, seq, dtype or "float32")
    tpl, comps = b.spec_plan(spec, None)
    return _instantiate(tpl, b.slot_ops(comps))


# ---------------------------------------------------------------------------
# graph builders: training step
# ---------------------------------------------------------------------------

def _backward_ops(fwd_ops: Sequence[og.Op], ratio: float) -> List[og.Op]:
    """Backward ops mirrored in reverse order: compute at ``ratio``× the
    forward count (grads w.r.t. inputs and weights), collectives at 1×
    (Megatron's conjugate f/g pairs recur once in backward)."""
    out: List[og.Op] = []
    for op in reversed(list(fwd_ops)):
        if isinstance(op, CollectiveOp):
            out.append(dataclasses.replace(op, name=f"bwd.{op.name}"))
        else:
            out.append(dataclasses.replace(op, name=f"bwd.{op.name}",
                                           count=op.count * ratio))
    return out


def _optimizer_op(cfg: C.ModelConfig, spec: og.ParallelismSpec,
                  train: TrainingStepSpec) -> og.Op:
    """The optimizer update as a ``MemoryOp`` priced by the memory model:
    an elementwise snippet over this rank's parameter shard (params are
    sharded by tp and, across pipeline stages, by pp), with a traffic
    multiplier for the optimizer-state streams the fused snippet hides."""
    snippet, traffic = _OPT_SNIPPET[train.optimizer]
    shard = _ceil_div(cfg.param_count(), spec.tp * spec.pp)
    return og.MemoryOp("opt.update", snippet, (shard,), count=traffic,
                       dtype="float32")


def build_training_graph(cfg: C.ModelConfig, batch: int, seq: int,
                         spec: Optional[og.ParallelismSpec] = None,
                         train: Optional[TrainingStepSpec] = None,
                         dtype: Optional[str] = None) -> og.OpGraph:
    """One optimizer step as an ``OpGraph``: forward + backward (pipelined
    per microbatch under ``pp > 1``, GPipe-style flush), the bucketed
    data-parallel gradient all-reduce overlapping the last microbatch's
    backward, and the optimizer update.

    Instantiated from the shared ``GraphTemplate`` layer: gradient buckets
    anchor to the last microbatch's backward compute nodes COLLECTED FROM
    THE WIRING CALLBACKS (``_grid_template``'s ``record``), never from
    per-microbatch node-count arithmetic — an empty pipeline stage
    (``pp`` > layer count) contributes only hand-off nodes and would skew
    any count-based selection."""
    spec = spec or og.ParallelismSpec()
    train = train or TrainingStepSpec()
    b = _SweepBuilder(cfg, batch, seq, dtype or "float32")
    tpl, comps = b.spec_plan(spec, train)
    return _instantiate(tpl, b.slot_ops(comps))


# ---------------------------------------------------------------------------
# peak-memory estimation (feasibility)
# ---------------------------------------------------------------------------

def schedule_inflight(kind: str, pp: int, mb: int, stage: int) -> int:
    """How many microbatches' stored activations stage ``stage`` holds at
    its peak, per schedule kind — the factor that separates the schedules
    memory-wise:

    * GPipe flush (and the interleaved flush) completes every forward
      before any backward, so each stage stores all ``mb``;
    * 1F1B's warmup depth caps stage ``s`` at ``min(pp - s, mb)`` — never
      more than ``pp`` regardless of microbatch count;
    * a single stage (``pp == 1``) alternates fwd/bwd per chunk, holding
      one microbatch.
    """
    if pp == 1:
        return 1
    if kind == "1f1b":
        return min(pp - stage, mb)
    return mb


def _static_state_bytes(cfg: C.ModelConfig, spec: og.ParallelismSpec,
                        train: Optional[TrainingStepSpec], dt: str) -> float:
    """Per-device resident state: the parameter shard (params divide over
    tp · pp), plus — when training — the same-shaped gradient shard and
    the optimizer's fp32 moment state (``_OPT_STATE_BYTES``/param)."""
    shard = cfg.param_count() / (spec.tp * spec.pp)
    out = shard * dtype_bytes(dt)
    if train is not None:
        out += shard * dtype_bytes(dt)
        out += shard * _OPT_STATE_BYTES[train.optimizer]
    return out


def _component_act_bytes(uniq_ops: Sequence[Sequence[og.Op]]
                         ) -> Tuple[List[float], List[float]]:
    """(sum, max) of ``og.activation_bytes`` per unique component: the sum
    is a stage's stored-for-backward footprint per microbatch, the max its
    transient forward working set."""
    sums, maxs = [], []
    for ops in uniq_ops:
        acts = [og.activation_bytes(op) for op in ops]
        sums.append(float(sum(acts)))
        maxs.append(float(max(acts, default=0.0)))
    return sums, maxs


def _peak_stage_bytes(cfg: C.ModelConfig, spec: og.ParallelismSpec,
                      train: Optional[TrainingStepSpec], kind: str,
                      comps: Sequence[int], act_sum: Sequence[float],
                      act_max: Sequence[float], dt: str) -> List[float]:
    """Per-device peak bytes for one planned spec (one entry per pipeline
    stage / device; tp ranks are symmetric).  Forward-only schedules charge
    the transient working set (inference keeps no activations); training
    schedules charge the stored per-microbatch activation sum times the
    schedule's in-flight count (``schedule_inflight``), on top of the
    static param/grad/optimizer state."""
    stat = _static_state_bytes(cfg, spec, train, dt)
    pp, mb, v = spec.pp, spec.microbatches, VIRTUAL_STAGES
    if kind in ("chain", "chunks", "grid", "gridil"):
        if kind in ("chain", "chunks"):
            return [stat + act_max[comps[0]]]
        if kind == "grid":
            return [stat + act_max[c] for c in comps[:pp]]
        A = [act_max[c] for c in comps[:pp * v]]
        return [stat + max(A[g * pp + d] for g in range(v))
                for d in range(pp)]
    if kind == "train1":
        return [stat + act_sum[comps[0]]]
    if kind in ("trainpp", "trainpp1f1b"):
        sk = "1f1b" if kind == "trainpp1f1b" else "gpipe"
        return [stat + act_sum[c] * schedule_inflight(sk, pp, mb, s)
                for s, c in enumerate(comps[:pp])]
    if kind == "trainppil":
        A = [act_sum[c] for c in comps[:pp * v]]
        return [stat + mb * sum(A[g * pp + d] for g in range(v))
                for d in range(pp)]
    raise ValueError(f"unknown template kind {kind!r}")


def peak_memory_bytes(cfg: C.ModelConfig, batch: int, seq: int,
                      spec: og.ParallelismSpec,
                      train: Optional[TrainingStepSpec] = None,
                      dtype: Optional[str] = None, *,
                      per_stage: bool = False):
    """Estimated peak device memory for running ``cfg`` under ``spec``:
    parameter/gradient/optimizer shards plus schedule-dependent in-flight
    activations.  Returns the worst device's bytes (float), or the
    per-stage list with ``per_stage=True``.

    Built from the same ``_SweepBuilder`` plan as the schedule itself, so
    the scalar answer and ``sweep_strategies``' vectorized ``peak_bytes``
    column agree by construction."""
    b = _SweepBuilder(cfg, batch, seq, dtype or "float32")
    tpl, comps = b.spec_plan(spec, train)
    act_sum, act_max = _component_act_bytes(b.uniq_ops)
    per = _peak_stage_bytes(cfg, spec, train, tpl.key[0], comps,
                            act_sum, act_max, b.dt)
    return per if per_stage else float(max(per))


# ---------------------------------------------------------------------------
# high-level entry points (predictor-agnostic)
# ---------------------------------------------------------------------------

def _effective_kind(spec: og.ParallelismSpec,
                    train: Optional[TrainingStepSpec]) -> str:
    """The schedule flavour a (spec, train) pair actually wires — the
    value ``Schedule.kind`` must carry so scalar bubble accounting matches
    the template the sweep path picks.  '1f1b' only materializes for a
    training pipeline (forward-only or single-stage graphs degenerate to
    GPipe)."""
    if spec.pp > 1 and train is not None and spec.schedule == "1f1b":
        return "1f1b"
    if spec.pp > 1 and spec.microbatches > 1 \
            and spec.schedule == "interleaved":
        return "interleaved"
    return "gpipe"


def schedule_parallel(predictor, cfg: C.ModelConfig, batch: int, seq: int,
                      spec: og.ParallelismSpec,
                      dtype: Optional[str] = None) -> Schedule:
    """Forward-pass schedule under ``spec``, priced by ``predictor``."""
    return schedule_graph(predictor,
                          build_parallel_graph(cfg, batch, seq, spec,
                                               dtype=dtype),
                          kind=_effective_kind(spec, None))


def schedule_step(predictor, cfg: C.ModelConfig, batch: int, seq: int,
                  spec: Optional[og.ParallelismSpec] = None,
                  train: Optional[TrainingStepSpec] = None,
                  dtype: Optional[str] = None) -> Schedule:
    """Training-step schedule (fwd + bwd + grad comm + optimizer), priced
    by ``predictor``."""
    spec = spec or og.ParallelismSpec()
    return schedule_graph(predictor,
                          build_training_graph(cfg, batch, seq, spec=spec,
                                               train=train, dtype=dtype),
                          kind=_effective_kind(spec, train
                                               or TrainingStepSpec()))


# ---------------------------------------------------------------------------
# vectorized strategy sweep
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StrategySweep:
    """Vectorized pricing of many parallelism strategies over one
    (model, batch, seq, device): every array is aligned with ``specs``.

    ``seconds`` is the schedule makespan (``Schedule.makespan``); the
    remaining fields mirror the scalar ``Schedule`` properties.  Training
    sweeps (``trains`` set) additionally carry the fwd/bwd/optimizer
    busy-time split of a training step.
    ``cached``, when present, is the service layer's per-spec cache-hit
    mask."""
    specs: List[og.ParallelismSpec]
    seconds: np.ndarray
    compute_seconds: np.ndarray
    comm_seconds: np.ndarray
    exposed_comm_seconds: np.ndarray
    sequential_seconds: np.ndarray
    bubble_share: np.ndarray
    max_stream_busy: np.ndarray
    trains: Optional[List[TrainingStepSpec]] = None
    fwd_seconds: Optional[np.ndarray] = None
    bwd_seconds: Optional[np.ndarray] = None
    optimizer_seconds: Optional[np.ndarray] = None
    cached: Optional[np.ndarray] = None
    peak_bytes: Optional[np.ndarray] = None   # worst-device peak memory
    feasible: Optional[np.ndarray] = None     # peak_bytes <= capacity mask

    def __len__(self) -> int:
        return len(self.specs)

    def bounds_ok(self, rel: float = 1e-9) -> np.ndarray:
        """``Schedule.bounds_ok`` batch-wise: busiest stream <= makespan <=
        sequential sum, per spec."""
        return ((self.max_stream_busy <= self.seconds * (1 + rel))
                & (self.seconds <= self.sequential_seconds * (1 + rel)))

    def best(self, feasible_only: bool = True) -> int:
        """Index of the fastest spec.  When a ``feasible`` mask is present
        (the sweep was given a memory capacity) only feasible specs
        compete, unless none is or ``feasible_only=False``."""
        if (feasible_only and self.feasible is not None
                and bool(self.feasible.any())):
            idx = np.flatnonzero(self.feasible)
            return int(idx[np.argmin(self.seconds[idx])])
        return int(np.argmin(self.seconds))

    def tag(self, i: int) -> str:
        t = self.specs[i].tag()
        if self.trains is not None:
            t += f"+{self.trains[i].tag()}"
        return t

    def row(self, i: int) -> dict:
        """One spec's metrics as a plain dict (report/JSON row)."""
        out = {"spec": self.tag(i),
               "seconds": float(self.seconds[i]),
               "compute_seconds": float(self.compute_seconds[i]),
               "comm_seconds": float(self.comm_seconds[i]),
               "exposed_comm_seconds": float(self.exposed_comm_seconds[i]),
               "sequential_seconds": float(self.sequential_seconds[i]),
               "bubble_share": float(self.bubble_share[i]),
               "max_stream_busy": float(self.max_stream_busy[i])}
        if self.trains is not None:
            out.update(fwd_seconds=float(self.fwd_seconds[i]),
                       bwd_seconds=float(self.bwd_seconds[i]),
                       optimizer_seconds=float(self.optimizer_seconds[i]))
        if self.peak_bytes is not None:
            out["peak_bytes"] = float(self.peak_bytes[i])
        if self.feasible is not None:
            out["feasible"] = bool(self.feasible[i])
        if self.cached is not None:
            out["cached"] = bool(self.cached[i])
        return out

    def rows(self) -> List[dict]:
        return [self.row(i) for i in range(len(self))]


# Metric field names shared with the serving layer's cache entries
SWEEP_METRICS = ("seconds", "compute_seconds", "comm_seconds",
                 "exposed_comm_seconds", "sequential_seconds",
                 "bubble_share", "max_stream_busy")
TRAIN_METRICS = ("fwd_seconds", "bwd_seconds", "optimizer_seconds")
MEM_METRICS = ("peak_bytes",)     # predictor-free; feasible is derived


def sweep_strategies(predictor, cfg: C.ModelConfig, batch: int, seq: int,
                     specs: Sequence[og.ParallelismSpec], *,
                     train=None, dtype: Optional[str] = None,
                     hbm_bytes: Optional[float] = None
                     ) -> StrategySweep:
    """Price many parallelism strategies in one vectorized pass.

    Three stages, amortizing everything the per-spec loop repeats:

    1. **enumerate** — unique op components (stage op lists, backward
       mirrors, p2p/bucket/optimizer ops) are built once and shared across
       every spec that needs them (``_SweepBuilder``);
    2. **price** — every unique op goes through ONE vectorized predictor
       call (``BatchPredictor.predict_ops_seconds``; a scalar predictor
       works too, just without the vectorization win);
    3. **simulate** — specs are grouped by structural ``GraphTemplate``
       (same (pp, mb, collective-position, bucket-count) shape) and each
       group is walked once by ``simulate_batch`` with per-spec durations
       bound into the template slots.

    Per-spec results match ``schedule_parallel`` / ``schedule_step`` to
    <= 1e-9 relative — the only divergence is float re-association when
    fused serial runs sum their durations.

    ``train`` is ``None`` (forward sweep), one shared ``TrainingStepSpec``,
    or a per-spec sequence aligned with ``specs`` (so a (spec × bucket_mb)
    grid is a single call).

    Every sweep also carries the predictor-free ``peak_bytes`` column
    (worst-device peak memory per spec, ``peak_memory_bytes``'s estimate
    from the same plans); passing ``hbm_bytes`` additionally sets the
    ``feasible`` mask, which ``StrategySweep.best`` then respects."""
    dt = dtype or "float32"
    specs = list(specs)
    if train is None:
        trains = None
    elif isinstance(train, TrainingStepSpec):
        trains = [train] * len(specs)
    else:
        trains = list(train)
        if len(trains) != len(specs):
            raise ValueError(f"train sequence length {len(trains)} != "
                             f"{len(specs)} specs")
        if any(t is None for t in trains):
            raise ValueError("per-spec train sequence must not mix None "
                             "with TrainingStepSpecs")
    b = _SweepBuilder(cfg, batch, seq, dt)
    plans = [b.spec_plan(sp, trains[i] if trains is not None else None)
             for i, sp in enumerate(specs)]
    all_ops = [op for ops in b.uniq_ops for op in ops]
    if not all_ops:
        secs = np.zeros(0)
    elif hasattr(predictor, "predict_ops_seconds"):
        secs = np.asarray(predictor.predict_ops_seconds(all_ops),
                          dtype=np.float64)
    else:
        secs = np.array([r.seconds
                         for r in predictor.predict_ops(all_ops)[1]])
    offs = np.cumsum([0] + [len(ops) for ops in b.uniq_ops])
    comp_secs = [secs[offs[i]:offs[i + 1]]
                 for i in range(len(b.uniq_ops))]
    S = len(specs)
    out = {name: np.zeros(S) for name in SWEEP_METRICS + TRAIN_METRICS}
    groups: Dict[Tuple, List[int]] = {}
    for i, (tpl, _) in enumerate(plans):
        groups.setdefault(tpl.key, []).append(i)
    for idxs in groups.values():
        tpl = plans[idxs[0]][0]
        D = np.stack([np.concatenate([comp_secs[c] for c in plans[i][1]])
                      for i in idxs])
        metrics = tpl.simulate_slots(D)
        for name, vec in metrics.items():
            out[name][idxs] = vec
    train_kw = {name: out.pop(name) for name in TRAIN_METRICS}
    if trains is None:
        train_kw = {name: None for name in TRAIN_METRICS}
    act_sum, act_max = _component_act_bytes(b.uniq_ops)
    peak = np.array([max(_peak_stage_bytes(
        cfg, sp, trains[i] if trains is not None else None,
        plans[i][0].key[0], plans[i][1], act_sum, act_max, dt))
        for i, sp in enumerate(specs)])
    feasible = (peak <= float(hbm_bytes)) if hbm_bytes is not None else None
    return StrategySweep(specs=specs, trains=trains, peak_bytes=peak,
                         feasible=feasible, **out, **train_kw)


def strategy_grid(*, dp: Sequence[int] = (1,), tp: Sequence[int] = (1,),
                  pp: Sequence[int] = (1,),
                  microbatches: Sequence[int] = (1,),
                  act_modes: Sequence[str] = ("tp",),
                  schedules: Sequence[str] = ("gpipe",),
                  max_world: Optional[int] = None
                  ) -> List[og.ParallelismSpec]:
    """Cartesian ``ParallelismSpec`` grid for sweeps, in deterministic
    (act_mode, dp, tp, pp, microbatches, schedule) nesting order.
    ``max_world`` drops specs needing more devices than the fleet has;
    non-GPipe schedules are skipped at ``pp == 1`` (without a pipeline
    every schedule kind prices identically — keeping them would only
    duplicate grid points under different tags)."""
    out: List[og.ParallelismSpec] = []
    for a in act_modes:
        for d in dp:
            for t in tp:
                for p in pp:
                    for m in microbatches:
                        for sch in schedules:
                            if sch != "gpipe" and int(p) == 1:
                                continue
                            s = og.ParallelismSpec(dp=int(d), tp=int(t),
                                                   pp=int(p), act_mode=a,
                                                   microbatches=int(m),
                                                   schedule=sch)
                            if (max_world is not None
                                    and s.world > max_world):
                                continue
                            out.append(s)
    return out


# ---------------------------------------------------------------------------
# stage-level pipeline (partition planners)
# ---------------------------------------------------------------------------

def pipeline_stage_schedule(stage_seconds: Sequence[float],
                            handoff_seconds: float,
                            microbatches: int = 1) -> Schedule:
    """Schedule already-priced pipeline stages as a micro-batched pipeline
    over the same grid wiring as the op-level builders: per-microbatch
    stage cost = ``stage_seconds[s] / microbatches``, and
    ``handoff_seconds`` is the PER-MICROBATCH hand-off, charged once per
    microbatch per link — the caller prices it at the microbatch batch
    size (``plan_stages_model`` recomputes ``activation_comm_cost`` there),
    so the α latency term is paid per transfer, exactly like
    the op-level grid's per-microbatch p2p ops.  The partition planners
    report this makespan as the plan's end-to-end cost."""
    mb = max(int(microbatches), 1)
    pp = len(stage_seconds)
    rows: List[PredictionRow] = []
    streams: List[str] = []
    deps: List[Tuple[int, ...]] = []
    last_in_stage: List[Optional[int]] = [None] * pp

    def add(name, kind, sec, stream, dep):
        rows.append(PredictionRow(name, kind, float(sec), "schedule"))
        streams.append(stream)
        deps.append(tuple(dep))
        return len(rows) - 1

    def add_stage(m, s, d):
        return add(f"stage{s}.mb{m}", "stage", stage_seconds[s] / mb,
                   f"compute.s{s}", d)

    def add_p2p(m, s, link, dep):
        return add(f"p2p.s{s}.mb{m}", "collective", handoff_seconds,
                   f"comm.pp{link}", (dep,))

    _wire_pipeline_grid(pp, mb, add_stage, add_p2p, last_in_stage)
    starts, ends, makespan = simulate([r.seconds for r in rows], streams,
                                      deps)
    return Schedule(rows, streams, starts, ends, makespan)


# ---------------------------------------------------------------------------
# Continuous-batching serving occupancy model (prefill/decode phases)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """A serving traffic mix: prompt/output length distributions plus an
    arrival process.  ``sample()`` draws the deterministic request trace
    (seeded), so the same mix always simulates the same workload and
    ``tag()`` can serve as a cache-key component."""
    prompt_lens: Tuple[int, ...]
    output_lens: Tuple[int, ...]
    prompt_weights: Optional[Tuple[float, ...]] = None
    output_weights: Optional[Tuple[float, ...]] = None
    arrival_rate: Optional[float] = None    # requests/sec; None = all at t=0
    n_requests: int = 64
    seed: int = 0

    def __post_init__(self):
        if not self.prompt_lens or min(self.prompt_lens) < 1:
            raise ValueError(f"prompt_lens must be >=1: {self.prompt_lens}")
        if not self.output_lens or min(self.output_lens) < 1:
            raise ValueError(f"output_lens must be >=1: {self.output_lens}")
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >=1: {self.n_requests}")

    @property
    def max_ctx(self) -> int:
        """Largest KV length any request reaches (prompt + all generated
        tokens) — the decode-grid ctx axis upper bound."""
        return int(max(self.prompt_lens) + max(self.output_lens))

    def sample(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The request trace: ``(prompt_lens, output_lens, arrivals)``
        arrays of length ``n_requests`` (seeded, deterministic)."""
        rng = np.random.default_rng(self.seed)

        def draw(vals, weights):
            v = np.asarray(vals, np.int64)
            p = None
            if weights is not None:
                w = np.asarray(weights, np.float64)
                p = w / w.sum()
            return rng.choice(v, size=self.n_requests, p=p)

        plens = draw(self.prompt_lens, self.prompt_weights)
        olens = draw(self.output_lens, self.output_weights)
        if self.arrival_rate is None:
            arrivals = np.zeros(self.n_requests)
        else:
            gaps = rng.exponential(1.0 / float(self.arrival_rate),
                                   self.n_requests)
            arrivals = np.cumsum(gaps) - gaps[0]   # first request at t=0
        return plens, olens, arrivals

    def tag(self) -> str:
        """8-hex fingerprint of the full mix (lengths, weights, arrival
        process, trace seed) — the serving cache-key component."""
        return f"{zlib.crc32(repr(self).encode()):08x}"


@dataclasses.dataclass
class ServingStats:
    """What ``simulate_serving`` reports for one (mix, capacity) point.
    All fields are floats so the whole record round-trips through a flat
    ``PredictionCache`` dict entry (``to_entry``/``from_entry``)."""
    capacity: float
    n_requests: float
    makespan: float
    tokens_out: float
    tokens_per_sec: float
    ttft_p50: float
    ttft_p95: float
    tpot_p50: float
    tpot_p95: float
    latency_p50: float
    latency_p95: float
    occupancy: float

    FIELDS = ("capacity", "n_requests", "makespan", "tokens_out",
              "tokens_per_sec", "ttft_p50", "ttft_p95", "tpot_p50",
              "tpot_p95", "latency_p50", "latency_p95", "occupancy")

    def to_entry(self) -> Dict[str, float]:
        return {f: float(getattr(self, f)) for f in self.FIELDS}

    @staticmethod
    def from_entry(d: Dict[str, float]) -> "ServingStats":
        return ServingStats(**{f: float(d[f]) for f in ServingStats.FIELDS})


@dataclasses.dataclass(frozen=True)
class ServingTables:
    """Precomputed per-phase latency tables for one serving point — the
    grid-priced substrate ``simulate_serving`` consumes instead of
    per-step closures.  ``prefill[plen]`` prices one prompt forward for
    each distinct prompt length in the mix; ``decode[b-1, c-1]`` prices
    one decode step for ``b`` co-scheduled slots at KV length ``c`` (one
    ``BatchPredictor.predict_decode_grid`` call per (device, tp) fills
    the whole grid).  Rows/cols beyond what a point needs are harmless:
    the simulators only read ``decode[:capacity, :mix.max_ctx]``, so one
    max-capacity grid serves every smaller capacity bit-identically."""
    prefill: Dict[int, float]
    decode: np.ndarray

    def __post_init__(self):
        d = np.asarray(self.decode, np.float64)
        if d.ndim != 2:
            raise ValueError(
                f"decode grid must be 2-D (batch, ctx): shape {d.shape}")
        object.__setattr__(self, "decode", d)
        object.__setattr__(
            self, "prefill",
            {int(k): float(v) for k, v in dict(self.prefill).items()})

    @staticmethod
    def from_callables(mix: "TrafficMix", capacity: int,
                       prefill_seconds, decode_step_seconds
                       ) -> "ServingTables":
        """Materialize legacy closures into tables (one call per distinct
        prompt length and per (batch, ctx) cell)."""
        pre = {int(p): float(prefill_seconds(int(p)))
               for p in sorted(set(int(p) for p in mix.prompt_lens))}
        ctx = mix.max_ctx
        dec = [[float(decode_step_seconds(b, c)) for c in range(1, ctx + 1)]
               for b in range(1, int(capacity) + 1)]
        return ServingTables(prefill=pre, decode=np.asarray(dec, np.float64))

    def validate(self, mix: "TrafficMix", capacity: int) -> None:
        if (self.decode.shape[0] < capacity
                or self.decode.shape[1] < mix.max_ctx):
            raise ValueError(
                f"decode grid {self.decode.shape} smaller than "
                f"(capacity={capacity}, max_ctx={mix.max_ctx})")
        missing = sorted(set(int(p) for p in mix.prompt_lens)
                         - set(self.prefill))
        if missing:
            raise ValueError(
                f"prefill table missing prompt lengths {missing}")


def _as_serving_tables(mix: TrafficMix, capacity: int, prefill,
                       decode) -> ServingTables:
    """Accept closures (legacy API), a ``{plen: seconds}`` mapping plus a
    ``(batch, ctx)`` grid, or mixed — always return validated tables."""
    if callable(prefill):
        pre = {int(p): float(prefill(int(p)))
               for p in sorted(set(int(p) for p in mix.prompt_lens))}
    else:
        pre = dict(prefill)
    if callable(decode):
        dec = np.asarray(
            [[float(decode(b, c)) for c in range(1, mix.max_ctx + 1)]
             for b in range(1, int(capacity) + 1)], np.float64)
    else:
        dec = decode
    tab = ServingTables(prefill=pre, decode=dec)
    tab.validate(mix, capacity)
    return tab


def _finalize_serving(capacity, makespan, ttft, tpot, lat, multi,
                      tokens_out, occ_num, occ_den) -> ServingStats:
    """Shared stats finalization: TPOT percentiles run over multi-token
    requests only (an ``output_len == 1`` request emits its single token
    at prefill and has no per-token gap — an all-single-token mix pins
    ``tpot_p50 == tpot_p95 == 0.0``); occupancy is the
    duration-weighted decode-batch fill
    ``sum(batch * step_seconds) / (capacity * sum(step_seconds))``."""
    tp = tpot[multi]
    return ServingStats(
        capacity=float(capacity), n_requests=float(ttft.size),
        makespan=float(makespan), tokens_out=tokens_out,
        tokens_per_sec=tokens_out / makespan if makespan > 0 else 0.0,
        ttft_p50=float(np.percentile(ttft, 50)),
        ttft_p95=float(np.percentile(ttft, 95)),
        tpot_p50=float(np.percentile(tp, 50)) if tp.size else 0.0,
        tpot_p95=float(np.percentile(tp, 95)) if tp.size else 0.0,
        latency_p50=float(np.percentile(lat, 50)),
        latency_p95=float(np.percentile(lat, 95)),
        occupancy=float(occ_num / (occ_den * capacity))
        if occ_den > 0 else 0.0)


def simulate_serving_steps(mix: TrafficMix, capacity: int,
                           prefill_seconds, decode_step_seconds,
                           return_detail: bool = False):
    """Reference token-by-token serving loop: one decode step per
    iteration, O(total generated tokens).  ``simulate_serving``
    fast-forwards whole constant-batch runs and must agree with this
    loop bit-for-bit on every time value.  Accepts the same
    closure / table arguments as ``simulate_serving``."""
    if capacity < 1:
        raise ValueError(f"capacity must be >=1: {capacity}")
    tab = _as_serving_tables(mix, int(capacity), prefill_seconds,
                             decode_step_seconds)
    plens, olens, arrivals = mix.sample()
    n = len(plens)
    order = np.argsort(arrivals, kind="stable")
    tfirst = np.zeros(n)
    tdone = np.zeros(n)
    t = 0.0
    nxt = 0
    active: List[List[int]] = []    # [kv_len, remaining_tokens, request_idx]
    occ_num = 0.0
    occ_den = 0.0
    while nxt < n or active:
        while (len(active) < capacity and nxt < n
               and float(arrivals[order[nxt]]) <= t):
            i = int(order[nxt])
            nxt += 1
            t += tab.prefill[int(plens[i])]
            tfirst[i] = t
            if int(olens[i]) > 1:
                # KV holds plen prompt entries + the just-sampled token
                active.append([int(plens[i]) + 1, int(olens[i]) - 1, i])
            else:
                tdone[i] = t
        if active:
            ctx = max(sl[0] + 1 for sl in active)
            dur = float(tab.decode[len(active) - 1, ctx - 1])
            t += dur
            occ_num += len(active) * dur
            occ_den += dur
            still = []
            for sl in active:
                sl[0] += 1
                sl[1] -= 1
                if sl[1] <= 0:
                    tdone[sl[2]] = t
                else:
                    still.append(sl)
            active = still
        elif nxt < n:
            t = max(t, float(arrivals[order[nxt]]))
    ttft = tfirst - arrivals
    lat = tdone - arrivals
    multi = olens > 1
    tpot = np.zeros(n)
    tpot[multi] = (tdone[multi] - tfirst[multi]) / (olens[multi] - 1.0)
    stats = _finalize_serving(capacity, float(t), ttft, tpot, lat, multi,
                              float(olens.sum()), occ_num, occ_den)
    if return_detail:
        return stats, {"ttft": ttft, "tpot": tpot, "latency": lat,
                       "prompt_lens": plens, "output_lens": olens,
                       "arrivals": arrivals}
    return stats


def simulate_serving(mix: TrafficMix, capacity: int,
                     prefill_seconds, decode_step_seconds,
                     return_detail: bool = False):
    """Continuous-batching slot-refill simulation over PREDICTED
    per-step latencies — event-driven.

    ``prefill_seconds`` prices one prompt forward (a closure over plen,
    or a ``{plen: seconds}`` mapping / ``ServingTables.prefill``);
    ``decode_step_seconds`` prices one decode step for ``batch``
    co-scheduled slots at KV length ``ctx`` — the longest slot's
    post-append length, since batched decode runs one kernel wave sized
    by the longest cache — as a closure or a ``(batch, ctx)`` grid
    (``ServingTables.decode``).  Admission is prefill-priority: whenever
    a slot is free and a request has arrived, the engine prefills it
    (stalling in-flight decodes — the stall shows up in the
    admitted-earlier requests' TPOT, as on a real engine).  The
    prefill's last forward samples the FIRST output token, so TTFT is
    the prefill completion time minus the submit time and a request with
    ``output_len == 1`` never enters the decode batch.  TPOT is the
    per-token gap over the remaining ``output_len - 1`` tokens;
    occupancy is the duration-weighted decode-batch fill.

    Between admissions and completions the decode batch is constant and
    ctx advances by exactly 1 per step, so instead of looping per token
    the simulator fast-forwards each run in O(1) numpy ops
    (``simulate_serving_batch`` with S=1); ``simulate_serving_steps``
    keeps the naive loop as the bit-identical reference."""
    if capacity < 1:
        raise ValueError(f"capacity must be >=1: {capacity}")
    tab = _as_serving_tables(mix, int(capacity), prefill_seconds,
                             decode_step_seconds)
    out = simulate_serving_batch(mix, [int(capacity)], [tab],
                                 return_detail=return_detail)
    if not return_detail:
        return out[0]
    stats, det = out
    return stats[0], {
        k: (v[0] if k in ("ttft", "tpot", "latency") else v)
        for k, v in det.items()}


def simulate_serving_batch(mix: TrafficMix, capacities: Sequence[int],
                           tables: Sequence[ServingTables],
                           return_detail: bool = False):
    """Evaluate S (capacity, latency-table) serving points over ONE
    shared sampled trace, every per-event update a length-S vector op —
    the serving analogue of ``simulate_batch``.

    Each row is bit-identical to ``simulate_serving`` run scalar on the
    same point: between admissions and completions the
    decode batch is constant and ctx advances by exactly 1 per step, so
    a run of ``k = min(remaining)`` decode steps is ``np.cumsum`` over a
    slice of the point's decode-grid row — the exact sequence of float
    additions the naive loop performs.  A pending arrival into a free
    slot truncates the run at the first step whose completion time
    reaches the arrival (the naive loop re-checks admission after every
    step).  Complexity is O(events), not O(total generated tokens).

    Returns ``[ServingStats] * S`` in input order; with
    ``return_detail``, also a dict of (S, n) per-request arrays plus the
    shared trace."""
    caps = np.asarray(list(capacities), np.int64)
    S = int(caps.size)
    tabs = list(tables)
    if len(tabs) != S:
        raise ValueError(f"{S} capacities but {len(tabs)} tables")
    if S == 0:
        return ([], {}) if return_detail else []
    if (caps < 1).any():
        raise ValueError(f"capacity must be >=1: {caps.tolist()}")
    plens, olens, arrivals = mix.sample()
    n = int(plens.size)
    order = np.argsort(arrivals, kind="stable")
    max_ctx = mix.max_ctx
    maxcap = int(caps.max())
    # pack per-UNIQUE-table arrays once (sweeps share one table across
    # many capacities); tmap[s] is point s's row in Pre/D
    uniq: Dict[int, int] = {}
    tmap = np.empty(S, np.int64)
    packed: List[ServingTables] = []
    for s, tab in enumerate(tabs):
        tab.validate(mix, int(caps[s]))
        u = uniq.setdefault(id(tab), len(packed))
        if u == len(packed):
            packed.append(tab)
        tmap[s] = u
    U = len(packed)
    Pre = np.empty((U, n))
    D = np.zeros((U, maxcap, max_ctx))
    for u, tab in enumerate(packed):
        Pre[u] = [tab.prefill[int(p)] for p in plens]
        rows = min(maxcap, tab.decode.shape[0])
        D[u, :rows] = tab.decode[:rows, :max_ctx]
    BIG = np.iinfo(np.int64).max
    arr_next = np.append(arrivals[order], np.inf)  # arrival of order[nxt]
    t = np.zeros(S)
    nxt = np.zeros(S, np.int64)
    seated = np.zeros((S, n), bool)
    kv = np.zeros((S, n), np.int64)
    rem = np.zeros((S, n), np.int64)
    tfirst = np.zeros((S, n))
    tdone = np.zeros((S, n))
    occ_num = np.zeros(S)
    occ_den = np.zeros(S)
    while True:
        nact = seated.sum(axis=1)
        pending = nxt < n
        if not (pending.any() or nact.any()):
            break
        # --- admission (prefill-priority): per pass, each point admits
        #     its longest burst of ready requests in one cumsum — the
        #     scalar inner-while's exact sequence of float additions.
        #     The burst is bounded by free slots (single-token requests
        #     never seat, so the outer while picks up any remainder) and
        #     stops at the first not-yet-arrived request; prefills
        #     advance t, so later arrivals may qualify mid-burst ---
        while True:
            jcap = np.minimum(caps - nact, n - nxt)
            can = (jcap > 0) & (arr_next[nxt] <= t)
            if not can.any():
                break
            sa = np.nonzero(can)[0]
            jmax = int(jcap[sa].max())
            offs = np.arange(jmax)
            pos = np.minimum(nxt[sa][:, None] + offs[None, :], n - 1)
            inrun = offs[None, :] < jcap[sa][:, None]
            req = order[pos]
            prem = np.where(inrun, Pre[tmap[sa][:, None], req], 0.0)
            T = np.cumsum(np.concatenate([t[sa][:, None], prem], axis=1),
                          axis=1)
            # request i joins iff it has arrived by the time the engine
            # reaches it (the prefill end of request i-1)
            okm = inrun & (np.where(inrun, arr_next[pos], np.inf)
                           <= T[:, :-1])
            j = np.where(okm.all(axis=1), jmax, (~okm).argmax(axis=1))
            adm = offs[None, :] < j[:, None]
            asel, aoff = np.nonzero(adm)
            sg = sa[asel]
            rg = req[asel, aoff]
            tf = T[asel, aoff + 1]
            tfirst[sg, rg] = tf
            mlt = olens[rg] > 1
            # KV holds plen prompt entries + the just-sampled token
            seated[sg[mlt], rg[mlt]] = True
            kv[sg[mlt], rg[mlt]] = plens[rg[mlt]] + 1
            rem[sg[mlt], rg[mlt]] = olens[rg[mlt]] - 1
            tdone[sg[~mlt], rg[~mlt]] = tf[~mlt]
            t[sa] = T[np.arange(sa.size), j]
            nxt[sa] += j
            nact = seated.sum(axis=1)
            pending = nxt < n
        # --- decode: fast-forward one constant-batch run per point ---
        if nact.any():
            sd = np.nonzero(nact > 0)[0]
            b = nact[sd]
            seat = seated[sd]
            c0 = np.where(seat, kv[sd], 0).max(axis=1) + 1  # first-step ctx
            k = np.where(seat, rem[sd], BIG).min(axis=1)    # next completion
            free = (b < caps[sd]) & (nxt[sd] < n)
            arr = np.where(free, arr_next[nxt[sd]], np.inf)
            kmax = int(k.max())
            off = np.arange(kmax)
            steps = (c0 - 1)[:, None] + off[None, :]        # ctx-1 per step
            valid = off[None, :] < k[:, None]
            durs = np.where(
                valid,
                D[tmap[sd][:, None], (b - 1)[:, None],
                  np.minimum(steps, max_ctx - 1)],
                0.0)
            times = np.cumsum(
                np.concatenate([t[sd][:, None], durs], axis=1), axis=1)
            crossed = times[:, 1:] >= arr[:, None]
            hit = crossed.any(axis=1)
            k = np.where(hit, np.minimum(k, crossed.argmax(axis=1) + 1), k)
            t_end = times[np.arange(sd.size), k]
            run = t_end - t[sd]
            occ_num[sd] += b * run
            occ_den[sd] += run
            t[sd] = t_end
            adv = np.where(seat, k[:, None], 0)
            kv[sd] += adv
            rem[sd] -= adv
            fin = seat & (rem[sd] <= 0)
            fs, fr = np.nonzero(fin)
            tdone[sd[fs], fr] = t_end[fs]
            seated[sd] = seat & ~fin
        # --- idle: no active slots, next request not yet arrived ---
        idle = (nact == 0) & pending
        if idle.any():
            si = np.nonzero(idle)[0]
            t[si] = np.maximum(t[si], arr_next[nxt[si]])
    ttft = tfirst - arrivals[None, :]
    lat = tdone - arrivals[None, :]
    multi = olens > 1
    tpot = np.zeros((S, n))
    if multi.any():
        tpot[:, multi] = ((tdone[:, multi] - tfirst[:, multi])
                          / (olens[multi] - 1.0))
    tokens_out = float(olens.sum())
    # one vectorized percentile call per metric (per-row results are the
    # same partition + linear interpolation ``_finalize_serving`` runs on
    # a single row, so each row stays bit-identical to the scalar path)
    ttft_q = np.percentile(ttft, [50, 95], axis=1)
    lat_q = np.percentile(lat, [50, 95], axis=1)
    tp_q = (np.percentile(tpot[:, multi], [50, 95], axis=1)
            if multi.any() else np.zeros((2, S)))
    stats = [ServingStats(
        capacity=float(caps[s]), n_requests=float(n), makespan=float(t[s]),
        tokens_out=tokens_out,
        tokens_per_sec=tokens_out / float(t[s]) if t[s] > 0 else 0.0,
        ttft_p50=float(ttft_q[0, s]), ttft_p95=float(ttft_q[1, s]),
        tpot_p50=float(tp_q[0, s]), tpot_p95=float(tp_q[1, s]),
        latency_p50=float(lat_q[0, s]), latency_p95=float(lat_q[1, s]),
        occupancy=float(occ_num[s] / (occ_den[s] * caps[s]))
        if occ_den[s] > 0 else 0.0)
        for s in range(S)]
    if return_detail:
        return stats, {"ttft": ttft, "tpot": tpot, "latency": lat,
                       "prompt_lens": plens, "output_lens": olens,
                       "arrivals": arrivals}
    return stats
