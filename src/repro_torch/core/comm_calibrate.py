"""Measured comm calibration: fit the α–β–γ interconnect constants from
busbw sweeps instead of trusting datasheets (the JAX package's
``core/comm_calibrate.py``; the fits are numpy on both sides and agree bit
for bit on the same records).

The α–β collective model (``core/collectives.py``) prices every multi-device
prediction from three constants per device — ``link_latency`` (α),
``link_bw`` (β⁻¹ per link) and the efficiency decay γ.  This module is the
loop that calibrates them against profiled reality, NCCL-tests style:

  sweep    — measure collective latency over a (collective, bytes, world)
             grid.  With one card there is no peer to exchange with, so
             ``run_host_sweep`` is a loopback stand-in on the calibrated
             device: each ring step is a ``dst.copy_(src)`` on it (HBM
             copies shaped like the ring on the card).  For NVLink/PCIe
             worlds, the recorded traces under ``artifacts/traces/`` stand
             in — the same "rerun or re-anchor" stance the throughput
             tables take.
  fit      — ``fit_interconnect``: least squares for (α, 1/B_raw) in
             relative space (fast and slow points count equally, the same
             loss-balance move as ``memory_model``) nested inside a γ grid
             search, with iterative ring/tree reassignment since the
             algorithm the model would pick depends on the constants being
             fit.
  persist  — a schema-stamped ``artifacts/torch/comm_calibration.json``
             keyed by device (``PM2LAT_COMM_CALIBRATION`` overrides the
             path), loaded lazily + mtime-memoized.  Absent artifact ⇒
             every lookup falls back to the datasheet constants and all
             predictions stay bit-identical.

``calibrated_interconnect(device)`` is the drop-in, fit-aware replacement
for ``collectives.interconnect_for``; ``calibration_tag(device)`` is the
cache-key fingerprint that keeps calibrated and datasheet predictions from
colliding in the shared ``PredictionCache``.

Validation of the fitted (and unfitted) constants against the recorded
traces lives in ``core/validate.py``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core import collectives as C
from repro_torch.core import memory_model as mm
from repro_torch.core import profiler
from repro_torch.core.device import resolve

SCHEMA = 1

# Artifact-path override (a nonexistent path disables calibration — what
# the test suite sets to keep tier-1 goldens datasheet-anchored).
CALIBRATION_ENV = "PM2LAT_COMM_CALIBRATION"

DEFAULT_SIZES = (256, 1024, 4096, 16384, 65536, 262144,
                 1 << 20, 4 << 20, 16 << 20, 64 << 20)
DEFAULT_WORLDS = (2, 4, 8)
DEFAULT_COLLS = ("all_reduce", "all_gather", "broadcast")


def default_calibration_path() -> str:
    """``PM2LAT_COMM_CALIBRATION`` when set, else the port's own
    ``artifacts/torch/comm_calibration.json`` (never the JAX package's
    ``artifacts/comm_calibration.json``)."""
    override = os.environ.get(CALIBRATION_ENV, "")
    if override:
        return os.path.abspath(override)
    root = os.environ.get("REPRO_ARTIFACTS",
                          os.path.join(os.path.dirname(__file__), "..", "..",
                                       "..", "artifacts"))
    return os.path.abspath(os.path.join(root, "torch",
                                        "comm_calibration.json"))


def default_traces_dir() -> str:
    root = os.environ.get("REPRO_ARTIFACTS",
                          os.path.join(os.path.dirname(__file__), "..", "..",
                                       "..", "artifacts"))
    return os.path.abspath(os.path.join(root, "traces"))


# ---------------------------------------------------------------------------
# records and fits
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommRecord:
    """One measured point of a busbw sweep: a collective of ``nbytes``
    full-tensor bytes over ``world`` ranks took ``measured_s`` seconds."""
    coll: str
    nbytes: float
    world: int
    measured_s: float

    def to_json(self) -> dict:
        return {"coll": self.coll, "nbytes": self.nbytes,
                "world": self.world, "measured_s": self.measured_s}

    @staticmethod
    def from_json(d: dict) -> "CommRecord":
        return CommRecord(coll=str(d["coll"]), nbytes=float(d["nbytes"]),
                          world=int(d["world"]),
                          measured_s=float(d["measured_s"]))


@dataclasses.dataclass(frozen=True)
class CommFit:
    """Fitted interconnect constants for one device, plus fit diagnostics.
    ``Interconnect.from_fit`` consumes exactly these fields."""
    topology: str
    link_bw: float          # bytes/s per link (fitted B_raw / links_per_gpu)
    link_latency: float     # fitted α, seconds
    eff_gamma: float        # fitted efficiency decay γ
    links_per_gpu: int = 1
    rel_err: float = 0.0    # mean |pred-meas|/meas over the fit points
    n_points: int = 0

    def interconnect(self) -> C.Interconnect:
        return C.Interconnect.from_fit(self)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "CommFit":
        return CommFit(topology=str(d["topology"]),
                       link_bw=float(d["link_bw"]),
                       link_latency=float(d["link_latency"]),
                       eff_gamma=float(d["eff_gamma"]),
                       links_per_gpu=int(d.get("links_per_gpu", 1)),
                       rel_err=float(d.get("rel_err", 0.0)),
                       n_points=int(d.get("n_points", 0)))


# ---------------------------------------------------------------------------
# the fitter
# ---------------------------------------------------------------------------

def _algo_coeffs(coll: str, algo: str, nbytes: float, world: float
                 ) -> Tuple[float, float]:
    """(A, V) such that the model's cost is ``A·α + V/B`` — the same
    formulas as ``collectives._ring_time`` / ``_tree_time``, expressed as
    coefficients so the fit is linear in (α, 1/B_raw).  The final fit error
    is re-computed through ``collective_time`` itself, which pins these two
    expressions of the formulas against each other."""
    n, p = float(nbytes), float(world)
    steps = p - 1.0
    frac = steps / p if p > 0 else 0.0
    rounds = math.ceil(math.log2(max(p, 1.0)))
    if algo == "ring":
        if coll == "all_reduce":
            return 2.0 * steps, 2.0 * n * frac
        if coll in ("all_gather", "reduce_scatter", "all_to_all"):
            return steps, n * frac
        if coll == "broadcast":
            return steps, n
        if coll == "p2p":
            return 1.0, n
    elif algo == "tree":
        if coll == "all_reduce":
            return 2.0 * rounds, 2.0 * rounds * n
        if coll in ("all_gather", "reduce_scatter"):
            return float(rounds), n * frac
        if coll == "broadcast":
            return float(rounds), rounds * n
        if coll == "all_to_all":
            return float(rounds), 0.5 * rounds * n
        if coll == "p2p":
            return 1.0, n
    raise ValueError(f"unknown (coll, algo) = ({coll!r}, {algo!r})")


def _wls_nonneg(a: np.ndarray, b: np.ndarray, t: np.ndarray
                ) -> Tuple[float, float]:
    """Solve min Σ((a·α + b·β − t)/t)² for α, β ≥ 0 (β strictly > 0 — it
    is an inverse bandwidth).  Relative space: rows divided by t, target 1.
    2-D active set: unconstrained solve, clamp α to 0 and re-solve β alone
    if it comes out negative."""
    ar, br = a / t, b / t
    ones = np.ones_like(t)
    X = np.stack([ar, br], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(X, ones, rcond=None)
    if alpha < 0.0 or beta <= 0.0:
        if beta <= 0.0:
            # degenerate sweep (e.g. all same size): bandwidth from the
            # largest point, latency from the rest
            beta = float(np.max(t / np.maximum(b, 1.0)))
        alpha = 0.0
        denom = float(br @ br)
        if denom > 0.0:
            beta = max(float(br @ ones) / denom, 1e-18)
        # α from residuals if any latency-bound points remain
        resid = t - b * beta
        pos = (a > 0) & (resid > 0)
        if pos.any():
            alpha = max(float(np.median(resid[pos] / a[pos])), 0.0)
    return max(float(alpha), 0.0), max(float(beta), 1e-18)


def _solve_fixed_gamma(recs: Sequence[CommRecord], gamma: float
                       ) -> Tuple[float, float, float]:
    """(α, β_raw, rel_err) at a fixed γ, iterating the ring/tree assignment
    to a fixed point (the min-selection in ``collective_time`` depends on
    the constants being fit — 2-3 rounds settle it)."""
    t = np.array([r.measured_s for r in recs], np.float64)
    lg = np.array([math.log2(max(r.world, 1)) for r in recs])
    coeffs = {algo: np.array([_algo_coeffs(r.coll, algo, r.nbytes, r.world)
                              for r in recs])
              for algo in ("ring", "tree")}
    # V/B = V·(1+γ·log2 p)/B_raw: fold the efficiency into the β column
    b_cols = {algo: coeffs[algo][:, 1] * (1.0 + gamma * lg)
              for algo in ("ring", "tree")}
    a_cols = {algo: coeffs[algo][:, 0] for algo in ("ring", "tree")}
    assign = np.zeros(len(recs), dtype=bool)   # False=ring, True=tree
    alpha, beta = 0.0, 1e-12
    for _ in range(4):
        a = np.where(assign, a_cols["tree"], a_cols["ring"])
        b = np.where(assign, b_cols["tree"], b_cols["ring"])
        alpha, beta = _wls_nonneg(a, b, t)
        pred_ring = a_cols["ring"] * alpha + b_cols["ring"] * beta
        pred_tree = a_cols["tree"] * alpha + b_cols["tree"] * beta
        new_assign = pred_tree < pred_ring
        if (new_assign == assign).all():
            break
        assign = new_assign
    a = np.where(assign, a_cols["tree"], a_cols["ring"])
    b = np.where(assign, b_cols["tree"], b_cols["ring"])
    pred = np.minimum(a_cols["ring"] * alpha + b_cols["ring"] * beta,
                      a_cols["tree"] * alpha + b_cols["tree"] * beta)
    rel = float(np.mean(np.abs(pred - t) / t))
    return alpha, beta, rel


def fit_interconnect(records: Sequence[CommRecord], topology: str,
                     *, links_per_gpu: int = 1,
                     gamma_grid: Optional[np.ndarray] = None) -> CommFit:
    """Least-squares fit of (α, link_bw, γ) to a measured busbw sweep.

    Outer 1-D grid over γ (the only nonlinearity), inner linear solve for
    (α, 1/B_raw); one refinement pass around the best coarse γ.  World-1
    and nonpositive points carry no information for the model (they cost
    exactly 0) and are dropped.  The returned ``rel_err`` is computed by
    replaying the records through ``collective_time`` with the fitted
    ``Interconnect`` — the fit is only accepted as good as the *actual*
    model evaluates it.
    """
    recs = [r for r in records if r.world > 1 and r.measured_s > 0
            and r.nbytes >= 0]
    if len(recs) < 3:
        raise ValueError(f"fit_interconnect: need >= 3 informative records, "
                         f"got {len(recs)}")
    if gamma_grid is None:
        gamma_grid = np.linspace(0.0, 0.6, 31)
    best = min(((_solve_fixed_gamma(recs, g)[2], g) for g in gamma_grid),
               key=lambda t: t[0])
    g0 = best[1]
    step = float(gamma_grid[1] - gamma_grid[0]) if len(gamma_grid) > 1 else 0.02
    fine = np.clip(np.linspace(g0 - step, g0 + step, 21), 0.0, None)
    _, gamma = min(((_solve_fixed_gamma(recs, g)[2], g) for g in fine),
                   key=lambda t: t[0])
    alpha, beta, _ = _solve_fixed_gamma(recs, gamma)
    b_raw = 1.0 / beta
    link_bw = b_raw / links_per_gpu if topology == "nvlink-mesh" else b_raw
    fit = CommFit(topology=topology, link_bw=link_bw, link_latency=alpha,
                  eff_gamma=float(gamma), links_per_gpu=links_per_gpu,
                  rel_err=0.0, n_points=len(recs))
    ic = fit.interconnect()
    meas = np.array([r.measured_s for r in recs])
    pred = np.array([float(C.collective_time(r.coll, r.nbytes, r.world,
                                             ic)[0]) for r in recs])
    rel = float(np.mean(np.abs(pred - meas) / meas))
    return dataclasses.replace(fit, rel_err=rel)


# ---------------------------------------------------------------------------
# sweeps: host loopback measurement + synthetic trace generation
# ---------------------------------------------------------------------------

def run_host_sweep(*, sizes: Sequence[int] = DEFAULT_SIZES,
                   worlds: Sequence[int] = DEFAULT_WORLDS,
                   colls: Sequence[str] = DEFAULT_COLLS,
                   min_reps: int = 3, device="cuda") -> List[CommRecord]:
    """Loopback busbw sweep on the calibrated device (the "host" of the
    store, as in ``BatchPredictor.host_profile``): emulate each
    collective's ring algorithm as its sequence of per-step buffer copies
    (``dst.copy_(src)`` on preallocated ``uint8`` tensors on ``device``)
    and time the whole exchange with ``profiler.measure``.  A stand-in:
    there is one card and no NVLink peer, so this prices HBM copies shaped
    like the ring, as the JAX package's sweep prices host memcpy."""
    dev = resolve(device)
    records = []
    for world in worlds:
        for coll in colls:
            for nbytes in sizes:
                steps, vol = _algo_coeffs(coll, "ring", nbytes, world)
                chunk = max(int(vol / max(steps, 1.0)), 1)
                src = torch.ones(chunk, dtype=torch.uint8, device=dev)
                dst = torch.empty_like(src)

                def exchange(n=int(steps)):
                    for _ in range(n):
                        dst.copy_(src)

                dur = profiler.measure(exchange, min_reps=min_reps,
                                       device=dev)
                records.append(CommRecord(coll, float(nbytes), int(world),
                                          dur))
    return records


def synthesize_records(ic: C.Interconnect, *,
                       sizes: Sequence[int] = DEFAULT_SIZES,
                       worlds: Sequence[int] = DEFAULT_WORLDS,
                       colls: Sequence[str] = DEFAULT_COLLS,
                       noise: float = 0.0, seed: int = 0
                       ) -> List[CommRecord]:
    """Ground-truth sweep from a known ``Interconnect``, with optional
    multiplicative lognormal noise — the generator behind both the bundled
    recorded traces and the fitter's property tests (recover the truth you
    synthesized)."""
    rng = np.random.default_rng(seed)
    records = []
    for world in worlds:
        for coll in colls:
            for nbytes in sizes:
                t, _ = C.collective_time(coll, nbytes, world, ic)
                t = float(t)
                if noise > 0.0:
                    t *= float(rng.lognormal(0.0, noise))
                records.append(CommRecord(coll, float(nbytes), int(world), t))
    return records


# ---------------------------------------------------------------------------
# the persisted artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommCalibration:
    """Everything the measured loop produced: per-device interconnect fits
    and per-device L2 cache corrections (``memory_model.CacheCorrection``
    JSON), plus provenance meta."""
    fits: Dict[str, CommFit] = dataclasses.field(default_factory=dict)
    cache: Dict[str, dict] = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"schema": SCHEMA,
                "fits": {k: f.to_json() for k, f in self.fits.items()},
                "cache": self.cache,
                "meta": self.meta}

    @staticmethod
    def from_json(d: dict) -> "CommCalibration":
        return CommCalibration(
            fits={k: CommFit.from_json(v)
                  for k, v in d.get("fits", {}).items()},
            cache=dict(d.get("cache", {})),
            meta=dict(d.get("meta", {})))

    def save(self, path: Optional[str] = None) -> str:
        """Atomic write (temp + ``os.replace``), like every other artifact:
        a crash mid-save leaves the previous calibration intact."""
        path = path or default_calibration_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        _CAL_MEMO.clear()
        return path


# (path, mtime) -> CommCalibration | None; a new artifact invalidates by
# mtime, save() clears it outright.
_CAL_MEMO: Dict[Tuple[str, float], Optional[CommCalibration]] = {}
_WARNED_SCHEMA: set = set()


def load_calibration(path: Optional[str] = None) -> Optional[CommCalibration]:
    """The persisted calibration, or None when absent (the bit-identical
    datasheet path).  Corrupt JSON fails loudly with the offending path; a
    schema mismatch warns once and behaves as absent (self-invalidation,
    same policy as ``PredictionCache``)."""
    path = path or default_calibration_path()
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    key = (path, mtime)
    if key in _CAL_MEMO:
        return _CAL_MEMO[key]
    try:
        with open(path) as f:
            d = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(f"corrupt comm calibration artifact {path!r}: {e}")
    if d.get("schema") != SCHEMA:
        if path not in _WARNED_SCHEMA:
            _WARNED_SCHEMA.add(path)
            warnings.warn(f"comm calibration {path!r} has schema "
                          f"{d.get('schema')!r} != {SCHEMA}; ignoring it "
                          "(regenerate with calibrate_comm)")
        cal: Optional[CommCalibration] = None
    else:
        cal = CommCalibration.from_json(d)
    _CAL_MEMO.clear()
    _CAL_MEMO[key] = cal
    return cal


# ---------------------------------------------------------------------------
# fit-aware lookups (the seams the predictor stack threads through)
# ---------------------------------------------------------------------------

def calibrated_interconnect(device: Optional[str],
                            path: Optional[str] = None) -> C.Interconnect:
    """The measured ``Interconnect`` for ``device`` when a calibration
    artifact carries a fit for it; the datasheet
    ``collectives.interconnect_for`` constants otherwise.  The
    calibration-absent path returns the exact same objects as before this
    module existed."""
    cal = load_calibration(path)
    if cal is not None and device is not None:
        fit = cal.fits.get(device)
        if fit is not None:
            return C.Interconnect.from_fit(fit)
    return C.interconnect_for(device)


def cache_correction_for(device: Optional[str], path: Optional[str] = None):
    """The measured ``memory_model.CacheCorrection`` for ``device``, or
    None (identity) without one."""
    cal = load_calibration(path)
    if cal is None or device is None:
        return None
    d = cal.cache.get(device)
    if d is None:
        return None
    return mm.CacheCorrection.from_json(d)


def calibration_tag(device: Optional[str],
                    path: Optional[str] = None) -> Optional[str]:
    """A short fingerprint of everything calibration changes about
    ``device``'s predictions — None when calibration leaves them untouched.
    ``BatchPredictor`` folds it into the cache-key device field so
    calibrated and datasheet entries never collide, and recalibration
    (a different fingerprint) self-invalidates without a schema bump."""
    cal = load_calibration(path)
    if cal is None or device is None:
        return None
    fit = cal.fits.get(device)
    cc = cal.cache.get(device)
    if fit is None and cc is None:
        return None
    blob = json.dumps({"fit": fit.to_json() if fit else None, "cache": cc},
                      sort_keys=True)
    return format(zlib.crc32(blob.encode()) & 0xFFFFFFFF, "08x")


# ---------------------------------------------------------------------------
# the top-level loop
# ---------------------------------------------------------------------------

def _profile_interconnect(device: str) -> C.Interconnect:
    return C.interconnect_for(device)


def calibrate_comm(path: Optional[str] = None, *, host: bool = True,
                   traces_dir: Optional[str] = None, cache: bool = True,
                   save: bool = True, verbose: bool = True,
                   device="cuda") -> CommCalibration:
    """Run the whole measured loop and (optionally) persist the artifact:

    1. loopback sweep on ``device`` → fit its interconnect, filed under
       ``calibrate.device_name(device)``,
    2. every recorded collective trace under ``traces_dir`` → fit that
       trace's device (NVLink/PCIe worlds one card cannot run),
    3. measured streaming-copy size sweep on ``device`` → L2 cache
       correction for the device profile's ``l2_bytes``.  The store's
       profile is registered first, so a card's store gives the card's L2
       size (``calibrate.card_sizes``), not the 32 MiB fallback.

    The L2 fit scales the memory model of ``calibrate.load_or_calibrate``'s
    store for ``device``; its samples and error are kept in ``meta``.
    Returns the ``CommCalibration``; with ``save`` it lands at ``path``
    (default ``artifacts/torch/comm_calibration.json``) and every
    subsequent ``calibrated_interconnect`` / ``LatencyService`` answer
    uses it.
    """
    from repro_torch.core import calibrate
    from repro_torch.core import devices as D
    from repro_torch.core import validate as V
    from repro_torch.core.batch_predict import BatchPredictor
    dev_t = resolve(device)
    t0 = time.time()
    cal = CommCalibration()
    if host:
        dev = calibrate.device_name(dev_t)
        prof_ic = _profile_interconnect(dev)
        if verbose:
            print(f"[comm-calibrate] loopback sweep ({dev})")
        recs = run_host_sweep(device=dev_t)
        fit = fit_interconnect(recs, prof_ic.topology,
                               links_per_gpu=prof_ic.links_per_gpu)
        cal.fits[dev] = fit
        if verbose:
            print(f"  {dev}: bw={fit.link_bw:.3g}B/s α={fit.link_latency:.3g}s "
                  f"γ={fit.eff_gamma:.3f} rel_err={fit.rel_err:.3f}")
    tdir = traces_dir or default_traces_dir()
    if os.path.isdir(tdir):
        for fname in sorted(os.listdir(tdir)):
            if not fname.endswith(".json"):
                continue
            trace = V.load_trace(os.path.join(tdir, fname))
            if trace.get("kind") != "collective":
                continue
            dev = trace["device"]
            recs = [CommRecord.from_json(r) for r in trace["records"]]
            fit = fit_interconnect(recs, trace["topology"],
                                   links_per_gpu=int(
                                       trace.get("links_per_gpu", 1)))
            cal.fits[dev] = fit
            if verbose:
                print(f"  {dev} (trace {trace['name']}): "
                      f"bw={fit.link_bw:.3g}B/s α={fit.link_latency:.3g}s "
                      f"γ={fit.eff_gamma:.3f} rel_err={fit.rel_err:.3f}")
    if cache:
        dev = calibrate.device_name(dev_t)
        if verbose:
            print(f"[comm-calibrate] L2 cache sweep ({dev})")
        store = calibrate.load_or_calibrate(device=dev_t, verbose=False)
        BatchPredictor(store, dev).host_profile()   # register the device
        try:
            l2 = D.get_profile(dev).l2_bytes
        except KeyError:
            l2 = 32 * 2 ** 20
        coef = np.asarray(store.memory_model["coef"])
        samples = mm.collect_cache_samples(device=dev_t)
        cc, rel = mm.fit_cache_correction(samples, coef, l2)
        cal.cache[dev] = cc.to_json()
        cal.meta["cache_samples"] = samples
        cal.meta["cache_rel_err"] = rel
        if verbose:
            print(f"  {dev}: hit={cc.hit_rate:.2f} speedup={cc.speedup:.2f} "
                  f"rel_err={rel:.3f}")
    cal.meta.update(seconds=time.time() - t0, schema=SCHEMA)
    if save:
        out = cal.save(path)
        if verbose:
            print(f"[comm-calibrate] done in {cal.meta['seconds']:.1f}s "
                  f"-> {out}")
    return cal
