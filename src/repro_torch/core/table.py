"""PM2Lat kernel-differentiated throughput tables (paper §III-C).

One ``ThroughputTable`` per *kernel identity* (op family + concrete kernel
config + dtype + device).  The table stores throughput at power-of-two K
anchors; prediction uses the paper's two formulas verbatim:

  Eq (2)  newThrPut = (K_new - K1)/(K3 - K1) * (ThrPut3 - ThrPut1) + ThrPut1
  Eq (1)  newDur    = orgDur * (newK / K_max) * (orgThrPut / newThrPut)

plus a wave/grid scaling factor for (M, N) different from the profiled
reference: duration scales with the number of output tiles (a
partially-filled tile costs a full tile — the paper's partial-block rule).

A numpy copy of the JAX package's module: both sides must give
bit-identical answers from one stored JSON.

A rational fit y=(ax+b)/(cx+d) (the paper's observed trend) is also provided
as an alternative estimator and validated against the interpolation in tests.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True, order=True)
class KernelKey:
    op: str        # 'matmul' | 'bmm' | 'flash_attention' | ...
    kernel: str    # e.g. 'mm_256x256x256' | 'xla_default' | 'fa_128x128'
    dtype: str     # 'float32' | 'bfloat16'
    device: str

    def id(self) -> str:
        return f"{self.op}|{self.kernel}|{self.dtype}|{self.device}"

    @staticmethod
    def parse(s: str) -> "KernelKey":
        op, kernel, dtype, device = s.split("|")
        return KernelKey(op, kernel, dtype, device)


@dataclasses.dataclass
class ThroughputTable:
    key: KernelKey
    anchors: Dict[int, float]            # K -> throughput (FLOP/s)
    org_dur: float                       # measured duration at k_max (s)
    k_max: int
    ref_grid: Tuple[int, int]            # (M0, N0) profiled reference
    ref_tiles: int                       # grid tiles at reference (MxN plane)
    # selection-oracle metadata (core/oracle.py): the profiled batch for bmm
    # reference grids and the profiled head dim for attention kernels.
    # Survives cross-device re-anchoring (core/transfer.py) and (de)serializes
    # with defaults so pre-oracle calibration artifacts keep loading.
    ref_batch: int = 1
    ref_head_dim: Optional[int] = None

    # ----- Eq (2): piecewise-linear interpolation between pow2 anchors -----
    def interpolate_throughput(self, k: int) -> float:
        ks = sorted(self.anchors)
        if k <= ks[0]:
            return self.anchors[ks[0]]
        if k >= ks[-1]:
            return self.anchors[ks[-1]]
        for k1, k3 in zip(ks, ks[1:]):
            if k1 <= k <= k3:
                t1, t3 = self.anchors[k1], self.anchors[k3]
                return (k - k1) / (k3 - k1) * (t3 - t1) + t1
        raise AssertionError

    # ----- Eq (1): duration at the reference grid -----
    def duration_at_ref(self, k: int) -> float:
        org_thr = self.anchors[self.k_max]
        new_thr = self.interpolate_throughput(k)
        return self.org_dur * (k / self.k_max) * (org_thr / new_thr)

    # ----- wave/grid scaling to arbitrary (M, N[, batch]) -----
    def predict(self, m: int, n: int, k: int, *, batch: int = 1,
                tile: Optional[Tuple[int, int]] = None) -> float:
        tiles = self.ref_tiles
        if tile is not None:
            tm, tn = tile
            tiles_new = math.ceil(m / tm) * math.ceil(n / tn) * batch
        else:
            # kernel tile unknown (e.g. XLA-chosen): scale by area ratio,
            # floored at ONE full reference tile — a sub-reference shape
            # still launches the reference kernel's wave (the paper's
            # partial-block rule), it never costs a fraction of it.  Kept in
            # lockstep with _TableInterp.predict (core/batch_predict.py).
            m0, n0 = self.ref_grid
            tiles_new = (m * n * batch) / (m0 * n0 * self.ref_batch)
            return self.duration_at_ref(k) * max(tiles_new, 1.0)
        return self.duration_at_ref(k) * tiles_new / self.ref_tiles

    # ----- rational trend fit (paper §III-C observation) -----
    def fit_rational(self) -> Tuple[float, float, float, float]:
        """Least-squares fit of thr(K) = (aK + b) / (cK + d), d := 1."""
        ks = np.array(sorted(self.anchors), dtype=np.float64)
        ys = np.array([self.anchors[int(k)] for k in ks], dtype=np.float64)
        scale = ys.max()
        y = ys / scale
        # y*(c*k + 1) = a*k + b  ->  a*k + b - y*k*c = y
        A = np.stack([ks, np.ones_like(ks), -y * ks], axis=1)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        a, b, c = coef
        return a * scale, b * scale, c, 1.0

    def rational_throughput(self, k: int) -> float:
        """Rational-fit throughput, clamped to the nearest anchor when the
        fitted denominator ``cK + d`` has a pole on positive K — past the
        pole the raw fit returns negative/infinite throughput (a negative
        Eq(1) duration), and just BELOW it a finite positive blowup orders
        of magnitude above anything measured.  Any value outside twice the
        measured anchor envelope is treated as degenerate."""
        a, b, c, d = self.fit_rational()
        nearest = self.anchors[min(self.anchors, key=lambda a_: abs(a_ - k))]
        den = c * k + d
        if den <= 0.0:
            return nearest
        val = (a * k + b) / den
        if not math.isfinite(val) or val <= 0.0:
            return nearest
        lo, hi = min(self.anchors.values()), max(self.anchors.values())
        if val < 0.5 * lo or val > 2.0 * hi:
            return nearest
        return val

    # ----- (de)serialization -----
    def to_json(self) -> dict:
        d = {"key": self.key.id(),
             "anchors": {str(k): v for k, v in self.anchors.items()},
             "org_dur": self.org_dur, "k_max": self.k_max,
             "ref_grid": list(self.ref_grid), "ref_tiles": self.ref_tiles}
        if self.ref_batch != 1:
            d["ref_batch"] = self.ref_batch
        if self.ref_head_dim is not None:
            d["ref_head_dim"] = self.ref_head_dim
        return d

    @staticmethod
    def from_json(d: dict) -> "ThroughputTable":
        hd = d.get("ref_head_dim")
        return ThroughputTable(
            key=KernelKey.parse(d["key"]),
            anchors={int(k): float(v) for k, v in d["anchors"].items()},
            org_dur=float(d["org_dur"]), k_max=int(d["k_max"]),
            ref_grid=tuple(d["ref_grid"]), ref_tiles=int(d["ref_tiles"]),
            ref_batch=int(d.get("ref_batch", 1)),
            ref_head_dim=None if hd is None else int(hd))


class TableStore:
    """All throughput tables for one device + the memory-model coefficients."""

    def __init__(self):
        self.tables: Dict[str, ThroughputTable] = {}
        self.memory_model: Optional[dict] = None
        self.meta: dict = {}

    def add(self, t: ThroughputTable):
        self.tables[t.key.id()] = t

    def get(self, key: KernelKey) -> Optional[ThroughputTable]:
        return self.tables.get(key.id())

    def save(self, path: str):
        """Atomic write (temp file + ``os.replace``, matching
        ``PredictionCache.save``): a crash mid-save must leave the previous
        calibration artifact intact, never a truncated one."""
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(
                    {"tables": [t.to_json() for t in self.tables.values()],
                     "memory_model": self.memory_model,
                     "meta": self.meta}, f, indent=1)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    @staticmethod
    def load(path: str) -> "TableStore":
        with open(path) as f:
            try:
                d = json.load(f)
            except (json.JSONDecodeError, ValueError) as e:
                raise ValueError(
                    f"corrupt calibration store {path!r}: {e}") from e
        st = TableStore()
        try:
            for td in d["tables"]:
                st.add(ThroughputTable.from_json(td))
        except (KeyError, TypeError, AttributeError) as e:
            raise ValueError(
                f"malformed calibration store {path!r}: {e!r}") from e
        st.memory_model = d.get("memory_model")
        st.meta = d.get("meta", {})
        return st
