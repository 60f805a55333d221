"""Habitat-style wave scaling (Geoffrey et al., ATC'21; paper §II): measure
once on a reference device, scale to the target by peak-FLOPs ratio
(compute-bound kernels) or bandwidth ratio (memory-bound kernels).

The total adds the rows left to right, as the JAX package's does; Python
3.12's ``sum()`` (``PM2Lat.predict_ops``) is compensated, so at ratios 1
the rows equal ``PM2Lat``'s bit for bit and the total equals their
left-to-right sum."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core.predictor import PM2Lat, PredictionRow


@dataclasses.dataclass
class HabitatScaler:
    reference: PM2Lat
    flops_ratio: float = 1.0   # peak_ref / peak_target
    bw_ratio: float = 1.0      # bw_ref / bw_target

    def predict_ops(self, ops: List) -> Tuple[float, List[PredictionRow]]:
        total = 0.0
        rows = []
        for op in ops:
            base = self.reference.predict_op(op)
            ratio = self.bw_ratio if base.kind == "memory" else self.flops_ratio
            rows.append(PredictionRow(base.name, base.kind,
                                      base.seconds * ratio, "habitat_scaled"))
            total += rows[-1].seconds
        return total, rows
