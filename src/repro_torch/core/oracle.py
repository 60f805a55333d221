"""Kernel-selection oracle (paper §III-C kernel differentiation).

The paper's core observation is that "different GPU kernels exhibit
significant performance disparities, even when serving the same purpose":
before PM2Lat can use a throughput table it must decide WHICH profiled
kernel the executing library would actually run for the query shape.  A
numpy copy of the JAX package's oracle, with one change: the provider rule
classifies every kernel id explicitly (``kernel_provider``).

Selection rules per op family
=============================

* **matmul / bmm** — nearest profiled reference grid in
  ``(log-area, log-aspect)`` space, the area including the batch dimension
  (``batch·M·N`` vs the candidate's ``ref_batch·M0·N0``).
* **attention** — nearest profiled sequence length in log space
  (``|log(skv / K_max)|``) plus a head-dim term
  (``0.5·|log(hd / ref_head_dim)|``) when both sides record one.

Execution providers
===================

The model stack executes through the framework (cuBLAS GEMMs via
``torch.matmul``, the model's attention entry point ``fa_model``), while
the hand-written kernels' block configs (``mm_<cfg>``, ``fa_<cfg>``) are a
separate custom-kernel pool benchmarked by the Table VI check.  The
op-graph predictor asks for the framework provider by default; the Table VI
check selects from the hand-kernel pool (``provider=PROVIDER_PALLAS``);
``provider=None`` scores the full pool (the ``explain`` debugging view).

Fallback policy (deterministic, device-safe)
============================================

Candidate enumeration only ever considers tables calibrated for the
oracle's own device, sorted by key id so dict insertion order can never
change an answer.  When the requested dtype has no candidates, the dtype
widens along an explicit preference order (e.g. ``bfloat16 → float16 →
float32`` …); the first fallback per ``(family, kernel/provider, dtype)``
warns once, and under ``REPRO_STRICT_DTYPE=1`` (or
``KernelOracle(strict=True)``) the oracle raises instead of falling back.
"""
from __future__ import annotations

import os
import re
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.device import STRICT_DTYPE_ENV
from repro_torch.core.table import KernelKey, TableStore, ThroughputTable

PROVIDER_FRAMEWORK = "framework"
PROVIDER_PALLAS = "pallas"

# dtype widening order when the requested dtype was not calibrated; dtypes
# absent from the map fall back through the sorted remainder only.
_DTYPE_PREFERENCE: Dict[str, Tuple[str, ...]] = {
    "float32": ("float32", "tf32", "bfloat16", "float16"),
    "tf32": ("tf32", "float32", "bfloat16", "float16"),
    "bfloat16": ("bfloat16", "float16", "float32"),
    "float16": ("float16", "bfloat16", "float32"),
    "float64": ("float64", "float32"),
}


# Every kernel id is classified explicitly; an id that matches neither rule
# raises instead of silently joining a pool.  Framework ids: the JAX
# package's ``xla_default*`` / ``fa_jnp*`` (so its stores load) and the
# port's ``cublas@*`` GEMMs and ``fa_model`` (the model's attention entry
# point).  Hand-kernel ids: one per block config of the hand-written kernels.
_FRAMEWORK_PREFIXES = ("xla_default", "fa_jnp", "cublas@", "fa_model")
_HAND_KERNEL = re.compile(r"mm_\d+x\d+x\d+|fa_\d+x\d+")


def kernel_provider(kernel: str) -> str:
    """Execution provider a kernel id belongs to: the framework's own paths
    vs the hand-written kernel backend (``mm_<bm>x<bk>x<bn>`` tiled
    matmuls, ``fa_<bq>x<bk>`` flash attention), whose pool keeps the name
    ``PROVIDER_PALLAS`` so stores stay comparable with the JAX package's."""
    if kernel.startswith(_FRAMEWORK_PREFIXES):
        return PROVIDER_FRAMEWORK
    if _HAND_KERNEL.fullmatch(kernel):
        return PROVIDER_PALLAS
    raise ValueError(f"kernel_provider: unclassified kernel id {kernel!r}")


def dtype_preference(dtype: str, available: Sequence[str]) -> List[str]:
    """Deterministic dtype fallback order: the requested dtype, then its
    preference chain, then any remaining available dtypes sorted."""
    pref = _DTYPE_PREFERENCE.get(dtype, (dtype,))
    ordered = [dtype] + [d for d in pref if d != dtype]
    ordered += sorted(d for d in set(available) if d not in ordered)
    return ordered


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def score_matmul(cands: Sequence[ThroughputTable], m, n,
                 batch=1) -> np.ndarray:
    """(len(cands), *shape) nearest-grid scores: |log area ratio| +
    0.5·|log aspect ratio|, area including batch on both sides."""
    m = np.asarray(m, np.float64)
    n = np.asarray(n, np.float64)
    batch = np.asarray(batch, np.float64)
    area = m * n * batch
    aspect = m / n
    scores = np.empty((len(cands),) + np.broadcast(area, aspect).shape)
    for i, t in enumerate(cands):
        m0, n0 = t.ref_grid
        ref_area = float(m0) * float(n0) * float(t.ref_batch)
        scores[i] = (np.abs(np.log(area / ref_area))
                     + 0.5 * np.abs(np.log(aspect / (m0 / n0))))
    return scores


def score_attention(cands: Sequence[ThroughputTable], skv,
                    head_dim=None) -> np.ndarray:
    """(len(cands), *shape) attention scores: log-distance from the profiled
    sequence sweep reference (``k_max``), plus a head-dim term for tables
    that record their profiled head dim."""
    skv = np.asarray(skv, np.float64)
    scores = np.empty((len(cands),) + skv.shape)
    for i, t in enumerate(cands):
        sc = np.abs(np.log(skv / float(t.k_max)))
        if head_dim is not None and t.ref_head_dim:
            sc = sc + 0.5 * np.abs(
                np.log(np.asarray(head_dim, np.float64)
                       / float(t.ref_head_dim)))
        scores[i] = sc
    return scores


class KernelOracle:
    """Select the profiled table of the kernel the library would run.

    One oracle per ``(TableStore, device)``: deterministic candidate order
    and shared scoring.
    """

    def __init__(self, store: TableStore, device: str, *,
                 strict: Optional[bool] = None):
        self.store = store
        self.device = device
        self._strict = strict
        self._warned: set = set()
        self._cands: Dict[tuple, List[ThroughputTable]] = {}
        self._family: Dict[str, List[ThroughputTable]] = {}
        self._resolved: Dict[tuple, Tuple[List[ThroughputTable], str]] = {}

    # ----- policy plumbing -----
    def _is_strict(self) -> bool:
        if self._strict is not None:
            return self._strict
        return os.environ.get(STRICT_DTYPE_ENV, "") not in ("", "0")

    def invalidate(self):
        """Drop memoized candidate lists (call after mutating the store)."""
        self._cands.clear()
        self._family.clear()
        self._resolved.clear()

    def _warn_once(self, key: tuple, msg: str):
        if key in self._warned:
            return
        self._warned.add(key)
        warnings.warn(msg, stacklevel=4)

    # ----- candidate enumeration (device-safe, deterministic) -----
    def _family_tables(self, op_family: str) -> List[ThroughputTable]:
        """Every same-device table of the family, sorted by key id —
        insertion order of the store can never influence selection.
        Memoized: this sits on the predictor's hottest dispatch path."""
        got = self._family.get(op_family)
        if got is None:
            got = sorted((t for t in self.store.tables.values()
                          if t.key.op == op_family
                          and t.key.device == self.device),
                         key=lambda t: t.key.id())
            self._family[op_family] = got
        return got

    def candidates(self, op_family: str, dtype: str, *,
                   provider: Optional[str] = PROVIDER_FRAMEWORK,
                   kernel: Optional[str] = None) -> List[ThroughputTable]:
        """Exact-dtype candidates (no fallback): same device, same family,
        filtered by provider (or exact kernel id), sorted by key id."""
        ck = (op_family, dtype, provider, kernel)
        got = self._cands.get(ck)
        if got is None:
            got = [t for t in self._family_tables(op_family)
                   if t.key.dtype == dtype
                   and (kernel is None or t.key.kernel == kernel)
                   and (provider is None
                        or kernel_provider(t.key.kernel) == provider)]
            self._cands[ck] = got
        return got

    def candidates_with_fallback(
            self, op_family: str, dtype: str, *,
            provider: Optional[str] = PROVIDER_FRAMEWORK,
            kernel: Optional[str] = None
    ) -> Tuple[List[ThroughputTable], str]:
        """Candidates under the dtype-fallback policy.  Returns
        ``(tables, dtype_used)``; warns once per fallback, raises ``KeyError``
        when nothing matches on this device, or on ANY fallback under strict
        mode (``REPRO_STRICT_DTYPE=1`` / ``strict=True``).  Successful
        resolutions are memoized (strict failures are re-derived so the
        error fires on every offending call)."""
        rk = (op_family, dtype, provider, kernel)
        hit = self._resolved.get(rk)
        if hit is not None:
            return hit
        fam = self._family_tables(op_family)
        available = {t.key.dtype for t in fam}
        for dt in dtype_preference(dtype, available):
            cands = self.candidates(op_family, dt, provider=provider,
                                    kernel=kernel)
            if not cands:
                continue
            if dt != dtype:
                what = kernel or provider or "any"
                base = (f"KernelOracle[{self.device}]: no {op_family}"
                        f"/{what} table calibrated for dtype {dtype!r} "
                        f"(calibrated: {sorted(available)})")
                if self._is_strict():
                    raise KeyError(f"{base}; refusing dtype fallback under "
                                   f"strict mode ({STRICT_DTYPE_ENV})")
                self._warn_once((op_family, provider, kernel, dtype, dt),
                                f"{base}; falling back to {dt!r}")
            self._resolved[rk] = (cands, dt)
            return cands, dt
        raise KeyError(
            f"KernelOracle[{self.device}]: no {op_family} table for "
            f"kernel={kernel!r} provider={provider!r} dtype={dtype!r} "
            f"on device {self.device!r} "
            f"(family dtypes calibrated here: {sorted(available)})")

    # ----- exact lookup with safe fallback (the fixed PM2Lat._table) -----
    def lookup(self, op_family: str, kernel: str,
               dtype: str) -> ThroughputTable:
        """Table for an exact kernel id, with the deterministic device-safe
        dtype fallback (never a wrong-device or wrong-kernel table)."""
        t = self.store.get(KernelKey(op_family, kernel, dtype, self.device))
        if t is not None:
            return t
        cands, _ = self.candidates_with_fallback(op_family, dtype,
                                                 provider=None, kernel=kernel)
        return cands[0]

    # ----- selection per op family -----
    def select_matmul(self, kind: str, dtype: str, m, n, *, batch=1,
                      provider: Optional[str] = PROVIDER_FRAMEWORK
                      ) -> ThroughputTable:
        """Nearest-reference-grid table for one matmul/bmm shape."""
        cands, _ = self.candidates_with_fallback(kind, dtype,
                                                 provider=provider)
        scores = score_matmul(cands, float(m), float(n), float(batch))
        return cands[int(np.argmin(scores, axis=0))]

    def select_attention(self, dtype: str, skv, *, head_dim=None,
                         provider: Optional[str] = PROVIDER_FRAMEWORK
                         ) -> ThroughputTable:
        """Nearest profiled attention kernel for one (skv, head_dim)."""
        cands, _ = self.candidates_with_fallback("attention", dtype,
                                                 provider=provider)
        hd = None if head_dim is None else float(head_dim)
        scores = score_attention(cands, float(skv), hd)
        return cands[int(np.argmin(scores, axis=0))]

    def select(self, op_family: str, dtype: str, shape, *,
               provider: Optional[str] = PROVIDER_FRAMEWORK
               ) -> ThroughputTable:
        """Uniform entry point: ``shape`` is ``(m, n[, batch])`` for the
        matmul family and ``(skv[, head_dim])`` for attention."""
        if op_family in ("matmul", "bmm"):
            m, n = shape[0], shape[1]
            batch = shape[2] if len(shape) > 2 else 1
            return self.select_matmul(op_family, dtype, m, n, batch=batch,
                                      provider=provider)
        if op_family == "attention":
            skv = shape[0]
            head_dim = shape[1] if len(shape) > 1 else None
            return self.select_attention(dtype, skv, head_dim=head_dim,
                                         provider=provider)
        raise KeyError(f"KernelOracle.select: unknown op family "
                       f"{op_family!r}")

    # ----- introspection -----
    def explain(self, op_family: str, dtype: str, shape, *,
                provider: Optional[str] = None) -> List[dict]:
        """Scored candidate list (best first) for one query — the debugging
        / benchmark-reporting view of a selection."""
        cands, dtype_used = self.candidates_with_fallback(
            op_family, dtype, provider=provider)
        if op_family in ("matmul", "bmm"):
            m, n = float(shape[0]), float(shape[1])
            batch = float(shape[2]) if len(shape) > 2 else 1.0
            scores = score_matmul(cands, m, n, batch)
        else:
            hd = float(shape[1]) if len(shape) > 1 else None
            scores = score_attention(cands, float(shape[0]), hd)
        rows = [{"kernel": t.key.kernel, "dtype": dtype_used,
                 "provider": kernel_provider(t.key.kernel),
                 "score": float(s), "ref_grid": tuple(t.ref_grid),
                 "ref_batch": t.ref_batch}
                for t, s in zip(cands, scores)]
        rows.sort(key=lambda r: (r["score"], r["kernel"]))
        return rows
