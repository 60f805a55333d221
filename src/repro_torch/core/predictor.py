"""PM2Lat predictor: kernel-differentiated throughput interpolation for
compute ops + linear proxy-metric regression for memory-bound ops, aggregated
sequentially over the op graph (paper §III-C).

Kernel selection — which profiled table answers for an op — lives in
``core/oracle.py`` (``KernelOracle``).  ``PredictionRow.kernel`` reports the
kernel id the oracle actually selected (e.g. ``cublas@1024x1024``).  The
arithmetic is the JAX package's, so the same store and features give
bit-identical answers.  A decode step is priced as
``predict_ops(enumerate_decode_ops(...))``; a ``CollectiveOp`` by the α–β
model (``core/collectives.py``) under the device's datasheet interconnect.
Parallel and training-step prediction price the list schedule of
``core/schedule.py`` (imported where it is used: it imports
``PredictionRow`` from here).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.configs import base as C
from repro_torch.core import collectives as CC
from repro_torch.core import opgraph as og
from repro_torch.core.memory_model import MemoryModel, class_of
from repro_torch.core.oracle import KernelOracle
from repro_torch.core.table import TableStore, ThroughputTable


@dataclasses.dataclass
class PredictionRow:
    name: str
    kind: str
    seconds: float
    kernel: str


class PM2Lat:
    def __init__(self, store: TableStore, device: str):
        self.store = store
        self.device = device
        self.oracle = KernelOracle(store, device)
        mm = store.memory_model
        self.memory_model = MemoryModel.from_json(mm) if isinstance(mm, dict) else mm

    @property
    def interconnect(self) -> CC.Interconnect:
        """This device's α–β interconnect (collective-op prediction): the
        registered datasheet profile, else ``DEFAULT_INTERCONNECT``.  Comm
        calibration is not ported, so there is no measured fit to prefer."""
        return CC.interconnect_for(self.device)

    # ----- per-op -----
    def _matmul_table(self, op: og.MatmulOp,
                      kernel: Optional[str]) -> ThroughputTable:
        if kernel is not None:
            return self.oracle.lookup(op.kind, kernel, op.dtype)
        return self.oracle.select_matmul(op.kind, op.dtype, op.m, op.n,
                                         batch=op.batch)

    def _attention_table(self, op: og.AttentionOp,
                         kernel: Optional[str]) -> ThroughputTable:
        if kernel is not None:
            return self.oracle.lookup("attention", kernel, op.dtype)
        return self.oracle.select_attention(op.dtype, op.skv,
                                            head_dim=op.hd)

    def predict_matmul(self, op: og.MatmulOp, kernel: str = None) -> float:
        t = self._matmul_table(op, kernel)
        return t.predict(op.m, op.n, op.k, batch=op.batch) * op.count

    def predict_attention(self, op: og.AttentionOp,
                          kernel: Optional[str] = None) -> float:
        if op.phase == og.DECODE:
            return self.predict_decode_attention(op)
        t = self._attention_table(op, kernel)
        return op.flops / t.interpolate_throughput(op.skv)

    def predict_decode_attention(self, op: og.AttentionOp) -> float:
        """Decode-phase attention (sq=1): the step streams the KV cache, so
        the op is memory-bound and flops-based table pricing collapses:
        price it with the memory model over the analytic KV-read traffic
        instead (class ``softmax``: the same reduce-then-scale access
        pattern)."""
        return self.memory_model.predict(og.decode_attention_features(op),
                                         "softmax")

    def predict_memory(self, op: og.MemoryOp) -> float:
        return self.memory_model.predict(op.features(),
                                         class_of(op.snippet)) * op.count

    def predict_collective(self, op: CC.CollectiveOp) -> Tuple[float, str]:
        """Seconds (incl. count) + selected ring/tree algorithm for one
        ``CollectiveOp`` under this device's interconnect."""
        return CC.predict_collective(op, self.interconnect)

    def predict_op(self, op) -> PredictionRow:
        if op.kind in ("matmul", "bmm"):
            t = self._matmul_table(op, None)
            sec = t.predict(op.m, op.n, op.k, batch=op.batch) * op.count
            return PredictionRow(op.name, op.kind, sec, t.key.kernel)
        if op.kind == "attention":
            if op.phase == og.DECODE:
                gqa = max(1, op.heads // max(1, op.kv_heads))
                return PredictionRow(op.name, "attention",
                                     self.predict_decode_attention(op),
                                     f"kv_read@gqa{gqa}")
            t = self._attention_table(op, None)
            sec = op.flops / t.interpolate_throughput(op.skv)
            return PredictionRow(op.name, "attention", sec, t.key.kernel)
        if op.kind == "collective":
            sec, algo = self.predict_collective(op)
            return PredictionRow(op.name, "collective", sec, algo)
        if op.kind == "memory":
            return PredictionRow(op.name, "memory", self.predict_memory(op),
                                 "linreg")
        raise NotImplementedError(
            f"no pricing for {op.kind!r} ops")

    # ----- model level -----
    def predict_ops(self, ops: List) -> Tuple[float, List[PredictionRow]]:
        rows = [self.predict_op(op) for op in ops]
        return sum(r.seconds for r in rows), rows

    def predict_model(self, cfg: C.ModelConfig, batch: int, seq: int,
                      dtype: Optional[str] = None):
        ops = og.enumerate_ops(cfg, batch, seq, dtype=dtype)
        return self.predict_ops(ops)

    def predict_parallel(self, cfg: C.ModelConfig, batch: int, seq: int,
                         spec: og.ParallelismSpec,
                         dtype: Optional[str] = None):
        """Schedule-aware end-to-end prediction under a ``ParallelismSpec``:
        the makespan of the two-stream list schedule over the sharded
        compute ops + induced collectives, and its rows.  With
        ``microbatches == 1`` the schedule is a serialized chain (a trivial
        spec runs the ``predict_model`` op list)."""
        sched = self.schedule_parallel(cfg, batch, seq, spec, dtype=dtype)
        return sched.makespan, sched.rows

    def schedule_parallel(self, cfg: C.ModelConfig, batch: int, seq: int,
                          spec: og.ParallelismSpec,
                          dtype: Optional[str] = None):
        """The full ``Schedule`` (timeline + busy/exposed splits) behind
        ``predict_parallel``."""
        from repro_torch.core import schedule as S
        return S.schedule_parallel(self, cfg, batch, seq, spec, dtype=dtype)

    def predict_step(self, cfg: C.ModelConfig, batch: int, seq: int,
                     spec: Optional[og.ParallelismSpec] = None, train=None,
                     dtype: Optional[str] = None):
        """One training step (fwd + bwd + gradient comm + optimizer update)
        under a ``ParallelismSpec`` + ``schedule.TrainingStepSpec``, priced
        as the schedule makespan."""
        sched = self.schedule_step(cfg, batch, seq, spec=spec, train=train,
                                   dtype=dtype)
        return sched.makespan, sched.rows

    def schedule_step(self, cfg: C.ModelConfig, batch: int, seq: int,
                      spec: Optional[og.ParallelismSpec] = None, train=None,
                      dtype: Optional[str] = None):
        """The full training-step ``Schedule`` behind ``predict_step``."""
        from repro_torch.core import schedule as S
        return S.schedule_step(self, cfg, batch, seq, spec=spec, train=train,
                               dtype=dtype)

    def predict_blocks(self, cfg: C.ModelConfig, batch: int, seq: int,
                       dtype: Optional[str] = None) -> List[float]:
        """Per-transformer-block latency (for the partition planner)."""
        per_layer = []
        for li, kind in enumerate(cfg.layer_kinds):
            one = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern),
                                      block_pattern=(kind,))
            ops = og.enumerate_ops(
                dataclasses.replace(one, n_layers=1), batch, seq, dtype=dtype)
            # strip embed/unembed/final-norm (not per-block)
            ops = [o for o in ops
                   if o.name not in ("embed", "unembed", "final_norm")]
            total, _ = self.predict_ops(ops)
            per_layer.append(total)
        return per_layer
