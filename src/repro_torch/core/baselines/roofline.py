"""FLOPs/bytes-proxy baseline (Paleo-style, paper §I 'traditional proxy
metrics'): duration = max(flops/peak, bytes/bw) with device peaks measured
once.  This is the naive model PM2Lat's kernel differentiation beats.  The
arithmetic is the JAX package's."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core.predictor import PredictionRow
from repro_torch.core.table import TableStore


def best_matmul_throughput(store: TableStore, dtype: str) -> float:
    """The best anchor of every ``matmul`` table of ``dtype`` (cuBLAS and
    the hand ``mm_*`` kernels alike): the measured peak."""
    peak = 0.0
    for t in store.tables.values():
        if t.key.op == "matmul" and t.key.dtype == dtype:
            peak = max(peak, max(t.anchors.values()))
    return peak


@dataclasses.dataclass
class RooflineBaseline:
    peak_flops: float
    mem_bw: float

    @staticmethod
    def from_store(store: TableStore, device: str,
                   dtype: str = "float32") -> "RooflineBaseline":
        # peak := best observed matmul throughput; bw := from memory model
        # coefficient (bytes coefficient ~ 1/bw).
        coef = store.memory_model["coef"] if isinstance(store.memory_model, dict) \
            else store.memory_model.coef
        bw = 1.0 / max(coef[0], 1e-18)
        return RooflineBaseline(peak_flops=best_matmul_throughput(store, dtype),
                                mem_bw=bw)

    def predict_op(self, op) -> PredictionRow:
        if op.kind in ("matmul", "bmm", "attention"):
            return PredictionRow(op.name, op.kind, op.flops / self.peak_flops,
                                 "flops_proxy")
        feats = op.features()
        return PredictionRow(op.name, "memory",
                             feats["bytes"] / self.mem_bw * op.count,
                             "bytes_proxy")

    def predict_ops(self, ops: List) -> Tuple[float, List[PredictionRow]]:
        rows = [self.predict_op(o) for o in ops]
        return sum(r.seconds for r in rows), rows
