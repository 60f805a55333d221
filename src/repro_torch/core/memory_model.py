"""Memory-bound (utility) op latency: linear regression over proxy metrics
(paper §III-C 'Utility Layer Latency Prediction').

The paper collects instruction/byte counters with Nsight Compute and fits a
linear model instead of hand-crafted per-layer formulas.  The port's
counters come from ``core/cost.py`` (a dispatch-mode count of the aten ops
the snippet runs, on meta tensors); the JAX package's come from XLA's
``cost_analysis()``.  The regression itself is a numpy copy of the JAX
package's and gives bit-identical coefficients from the same samples.

Features per op: [bytes_accessed, flops, transcendentals, 1].
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import profiler
from repro_torch.core.cost import cost_of
from repro_torch.core.device import resolve


def op_features(fn: Callable, *args: torch.Tensor) -> Dict[str, float]:
    """Proxy metrics of ``fn`` on tensors shaped like ``args``."""
    return cost_of(fn, *[(a.shape, a.dtype) for a in args])


def feature_vector(feats: Dict[str, float]) -> np.ndarray:
    return np.array([feats["bytes"], feats["flops"],
                     feats["transcendentals"], 1.0])


# Kernel differentiation for memory-bound ops (same move as the matmul
# tables): one regression per utility-kernel CLASS.  A single global linear
# model had 46% train error; per-class models are each near-linear in bytes.
KERNEL_CLASS = {
    "softmax": "softmax", "rmsnorm": "norm",
    "fused_norm_act": "transcendental",
    "add": "pointwise", "mul": "pointwise", "relu": "pointwise",
    "gelu": "transcendental", "fused_vec": "transcendental",
    "silu_mul": "transcendental", "gate_sigmoid": "transcendental",
    "rope": "pointwise", "embed_gather": "pointwise", "conv1d4": "pointwise",
    "assoc_scan": "scan", "seq_scan": "scan",
    "adamw_update": "transcendental", "sgd_update": "pointwise",
}


def class_of(name: str) -> str:
    for prefix, cls in KERNEL_CLASS.items():
        if name.startswith(prefix):
            return cls
    return "pointwise"


@dataclasses.dataclass(frozen=True)
class CacheCorrection:
    """PPT-GPU-style measured L2 correction for memory-bound predictions.

    The linear model's bytes coefficient is 1/effective-DRAM-bandwidth; it
    overcharges working sets that fit (partly) in L2.  With a measured hit
    rate ``hit_rate`` and an L2:DRAM speedup ``speedup``, the effective
    bytes cost scales by

        factor(w) = 1 - hit_rate · min(1, l2_bytes / w) · (1 - 1/speedup)

    — full discount when the working set ``w`` fits in L2, fading as
    ``l2_bytes / w`` once it spills (the resident fraction of a streaming
    working set).  ``factor`` is 1.0 everywhere when ``hit_rate`` is 0.
    """
    l2_bytes: float
    hit_rate: float       # measured fraction of accesses served by L2
    speedup: float        # L2 : DRAM bandwidth ratio (>= 1)

    def __post_init__(self):
        if not (0.0 <= self.hit_rate <= 1.0):
            raise ValueError(f"invalid hit_rate: {self}")
        if self.speedup < 1.0 or self.l2_bytes <= 0:
            raise ValueError(f"invalid CacheCorrection: {self}")

    def factor(self, nbytes):
        """Bytes-cost multiplier in (0, 1]; scalar in → float out, array in
        → ndarray out (same contract as ``Interconnect.efficiency``)."""
        w = np.maximum(np.asarray(nbytes, np.float64), 1.0)
        resident = np.minimum(1.0, self.l2_bytes / w)
        f = 1.0 - self.hit_rate * resident * (1.0 - 1.0 / self.speedup)
        if np.ndim(nbytes) == 0:
            return float(f)
        return f

    def to_json(self) -> dict:
        return {"l2_bytes": self.l2_bytes, "hit_rate": self.hit_rate,
                "speedup": self.speedup}

    @staticmethod
    def from_json(d: dict) -> "CacheCorrection":
        return CacheCorrection(l2_bytes=float(d["l2_bytes"]),
                               hit_rate=float(d["hit_rate"]),
                               speedup=float(d["speedup"]))


@dataclasses.dataclass
class MemoryModel:
    coef: np.ndarray                         # global fallback (4,)
    train_rel_err: float = 0.0
    class_coef: Optional[dict] = None        # class -> (4,) coefficients
    cache: Optional[CacheCorrection] = None  # measured L2 correction

    def apply_cache(self, X: np.ndarray) -> np.ndarray:
        """Scale the bytes feature (column 0) of an ``(..., 4)`` feature
        array by the L2 factor.  Identity — same object, no copy — when no
        cache correction is fit, so the calibration-absent path stays
        bit-identical."""
        if self.cache is None:
            return X
        X = np.array(X, dtype=np.float64, copy=True)
        X[..., 0] = X[..., 0] * self.cache.factor(X[..., 0])
        return X

    def predict(self, feats: Dict[str, float], kernel_class: str = None) -> float:
        coef = self.coef
        if self.class_coef and kernel_class in self.class_coef:
            coef = np.asarray(self.class_coef[kernel_class])
        return float(self.apply_cache(feature_vector(feats)) @ coef)

    def to_json(self) -> dict:
        d = {"coef": self.coef.tolist(), "train_rel_err": self.train_rel_err,
             "class_coef": {k: list(v) for k, v in (self.class_coef or {}).items()}}
        if self.cache is not None:
            d["cache"] = self.cache.to_json()
        return d

    @staticmethod
    def from_json(d: dict) -> "MemoryModel":
        cache = d.get("cache")
        return MemoryModel(coef=np.asarray(d["coef"]),
                           train_rel_err=float(d["train_rel_err"]),
                           class_coef={k: np.asarray(v) for k, v in
                                       d.get("class_coef", {}).items()} or None,
                           cache=CacheCorrection.from_json(cache)
                           if cache else None)


def _lstsq_rel(samples):
    """Nonnegative relative-space least squares (active-set: drop the most
    negative coefficient and re-solve — plain clipping after lstsq produces
    garbage when features are collinear, e.g. softmax bytes ~ flops ~
    transcendentals)."""
    X = np.stack([feature_vector(s["features"]) for s in samples])
    y = np.array([s["duration"] for s in samples])
    Xr = X / y[:, None]
    ones = np.ones_like(y)
    active = list(range(X.shape[1]))
    coef = np.zeros(X.shape[1])
    for _ in range(X.shape[1]):
        c, *_ = np.linalg.lstsq(Xr[:, active], ones, rcond=None)
        if (c >= 0).all() or len(active) == 1:
            coef[:] = 0.0
            coef[active] = np.maximum(c, 0.0)
            break
        active.pop(int(np.argmin(c)))
    rel = float(np.mean(np.abs(X @ coef - y) / y))
    return coef, rel


def fit_memory_model(samples: List[Dict], *, weighted: bool = True) -> MemoryModel:
    """samples: [{"features": {...}, "duration": s[, "name"]}].  Weighted
    least squares in relative space (divide rows by duration) so fast and
    slow kernels count equally — this directly avoids the loss-imbalance
    failure mode the paper attributes to NeuSight (§IV-B).  Per-kernel-class
    sub-models when sample names are present."""
    coef, rel = _lstsq_rel(samples)
    class_coef = {}
    by_class: Dict[str, list] = {}
    for s in samples:
        if "name" in s:
            by_class.setdefault(class_of(s["name"]), []).append(s)
    rels = []
    for cls, ss in by_class.items():
        if len(ss) >= 6:
            c, r = _lstsq_rel(ss)
            class_coef[cls] = c
            rels.append(r * len(ss))
    if rels and sum(len(v) for v in by_class.values()) == len(samples):
        rel = sum(rels) / len(samples)
    return MemoryModel(coef=coef, train_rel_err=rel,
                       class_coef=class_coef or None)


# ----- utility-op sample generators (profiling workloads) -----

def _rms(x):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6)


def assoc_scan(x):
    """Inclusive scan of h_t = x_t·h_{t-1} + x_t along axis 1 by recursive
    doubling (the log-depth structure of ``jax.lax.associative_scan``)."""
    a, b = x, x
    n, off = x.shape[1], 1
    while off < n:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        a = torch.cat([a[:, :off], a_prev * a_cur], 1)
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], 1)
        off *= 2
    return b


def seq_scan(x):
    """c_t = tanh(0.9·c_{t-1} + x_t) over axis 1, starting from x[:, 0]."""
    c = x[:, 0]
    for t in range(x.shape[1]):
        c = torch.tanh(c * 0.9 + x[:, t])
    return c


def utility_workloads(max_feat: int = 16384, device="cuda"):
    """(name, fn, args) triples spanning the paper's utility-layer set,
    including FUSED elementwise chains; the same names and numpy seed-0
    shapes as the JAX package's.  Eager torch runs each aten op of a chain
    as its own kernel, so here a chain is several kernels."""
    dev = resolve(device)
    rng = np.random.default_rng(0)
    shapes = []
    for _ in range(16):
        b = int(rng.integers(1, 96))
        f = int(2 ** rng.integers(6, int(np.log2(max_feat)) + 1))
        shapes.append((b, f))

    def t(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.float32)

    gelu = lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    out = []
    for b, f in shapes:
        x = t(rng.standard_normal((b, f)))
        y = t(rng.standard_normal((b, f)))
        out += [
            (f"gelu_{b}x{f}", gelu, (x,)),
            (f"relu_{b}x{f}", F.relu, (x,)),
            (f"softmax_{b}x{f}", lambda x: F.softmax(x, dim=-1), (x,)),
            (f"add_{b}x{f}", lambda x, y: x + y, (x, y)),
            (f"mul_{b}x{f}", lambda x, y: x * y, (x, y)),
            (f"fused_vec_{b}x{f}", lambda x, y: gelu(x + y) * x, (x, y)),
            (f"fused_norm_act_{b}x{f}",
             lambda x: F.silu(x) * torch.rsqrt(
                 torch.mean(x * x, -1, keepdim=True) + 1e-6), (x,)),
            (f"rmsnorm_{b}x{f}", _rms, (x,)),
        ]
        if b >= 2 and f >= 256:
            s3 = t(rng.standard_normal((b, 32, f // 8)))
            out += [
                (f"assoc_scan_{b}x{f}", assoc_scan, (s3,)),
                (f"seq_scan_{b}x{f}", seq_scan, (s3,)),
            ]
    return out


def collect_utility_samples(workloads=None, device="cuda") -> List[Dict]:
    workloads = workloads or utility_workloads(device=device)
    samples = []
    for name, fn, args in workloads:
        dur = profiler.measure(fn, *args, device=device)
        feats = op_features(fn, *args)
        samples.append({"name": name, "features": feats, "duration": dur})
    return samples


# ----- measured L2 / cache-hierarchy correction (PPT-GPU-style) -----

def collect_cache_samples(sizes=None, *, min_reps: int = 5,
                          device="cuda") -> List[Dict]:
    """Measured streaming-copy durations across working-set sizes that
    straddle the last-level cache: the raw material for
    ``fit_cache_correction``.  Each sample times ``dst.copy_(src)`` on
    ``uint8`` tensors of ``size`` bytes on ``device`` with
    ``profiler.measure``, the timer the memory model's own samples were
    taken with, so the fit's intercept means the same on both sides.  Each
    sample is ``{"bytes": accessed_bytes, "duration": seconds}``."""
    dev = resolve(device)
    if sizes is None:
        sizes = tuple(1 << s for s in range(16, 29, 2))   # 64 KiB .. 256 MiB
    samples = []
    for size in sizes:
        src = torch.ones(int(size), dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        dur = profiler.measure(dst.copy_, src, min_reps=min_reps, device=dev)
        # bytes accessed = read + write of the working set
        samples.append({"bytes": 2.0 * size, "duration": dur})
        del src, dst
    return samples


def fit_cache_correction(samples: List[Dict], coef: np.ndarray,
                         l2_bytes: float) -> "tuple[CacheCorrection, float]":
    """Fit (hit_rate, speedup) so ``coef``'s bytes term, scaled by
    ``CacheCorrection.factor``, explains the measured size sweep.  Grid
    search with one refinement pass — the surface is smooth and 2-D, no
    gradient machinery needed.  Returns ``(correction, rel_err)``; the
    correction degrades to the identity (hit_rate 0) when the data shows
    no cache effect."""
    w = np.array([s["bytes"] for s in samples], np.float64)
    y = np.array([s["duration"] for s in samples], np.float64)
    keep = (w > 0) & (y > 0)
    w, y = w[keep], y[keep]
    if len(w) < 3:
        raise ValueError(f"fit_cache_correction: need >= 3 positive samples, "
                         f"got {len(w)}")
    c_bytes, c_const = float(coef[0]), float(coef[3])

    def err(h, s):
        cc = CacheCorrection(l2_bytes=l2_bytes, hit_rate=h, speedup=s)
        pred = c_bytes * w * cc.factor(w) + c_const
        return float(np.mean(np.abs(pred - y) / y))

    hs = np.linspace(0.0, 1.0, 21)
    ss = np.linspace(1.0, 8.0, 29)
    _, h0, s0 = min(((err(h, s), h, s) for h in hs for s in ss),
                    key=lambda t: t[0])
    hs = np.clip(np.linspace(h0 - 0.05, h0 + 0.05, 11), 0.0, 1.0)
    ss = np.clip(np.linspace(s0 - 0.25, s0 + 0.25, 11), 1.0, None)
    e, h, s = min(((err(h, s), h, s) for h in hs for s in ss),
                  key=lambda t: t[0])
    e0 = err(0.0, 1.0)
    if e0 <= e:       # no measurable cache effect: keep the identity factor
        return CacheCorrection(l2_bytes=l2_bytes, hit_rate=0.0,
                               speedup=1.0), e0
    return CacheCorrection(l2_bytes=l2_bytes, hit_rate=float(h),
                           speedup=float(s)), e
