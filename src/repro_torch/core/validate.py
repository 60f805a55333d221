"""Measured-vs-predicted validation: replay recorded traces through the
analytical models and fail loudly when the error exceeds a pinned budget
(the JAX package's ``core/validate.py``; numpy on both sides, so the same
trace gives the same report field for field).

Two trace kinds live under ``artifacts/traces/`` (schema below, one JSON
file per recorded run):

``kind: "collective"`` — an NCCL-tests-style sweep: for each
(collective, bytes, world) point the recorded wall time of the real (or
recorded-elsewhere) exchange.  Replayed through
``collectives.collective_time`` with a chosen ``Interconnect``; the report
groups relative error per collective, per size decade, and per world.

``kind: "schedule"`` — a recorded overlap schedule: per-node measured
durations + stream/dependency structure, and the measured end-to-end
makespan.  The node durations are replayed through ``schedule.simulate``
and the *simulated* makespan is compared to the measured one — this
validates the overlap/bubble accounting itself, independent of the
per-op latency models.

Trace JSON::

    {"schema": 1, "kind": "collective", "name": "...", "device": "a100_80g",
     "topology": "nvlink-mesh", "links_per_gpu": 12,
     "records": [{"coll": "all_reduce", "nbytes": 1024.0, "world": 8,
                  "measured_s": 1.2e-05}, ...],
     "meta": {...}}

    {"schema": 1, "kind": "schedule", "name": "...", "device": "a100_80g",
     "nodes": [{"name": "s0.mb0.fwd", "stream": "compute",
                "duration_s": 1e-3, "deps": []}, ...],
     "measured": {"makespan_s": 4.2e-3},
     "meta": {...}}

The error budgets (``BUDGETS``) are deliberately tight enough that a
perturbed-constants run fails them (a 3x lower link bandwidth fails every
bundled collective trace).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import collectives as C
from repro_torch.core import comm_calibrate as CC
from repro_torch.core import schedule as S

TRACE_SCHEMA = 1

# Pinned error budgets (mean relative error per group, and max over
# groups): the harness's pass/fail line.  Collective traces carry measured
# noise; schedule traces validate deterministic accounting and are held
# tighter.
BUDGETS: Dict[str, float] = {"collective": 0.10, "schedule": 0.05}


def load_trace(path: str) -> dict:
    """One trace file, schema-checked: corrupt JSON or an unknown schema /
    kind fails loudly with the offending path."""
    try:
        with open(path) as f:
            d = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(f"corrupt trace file {path!r}: {e}")
    if d.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"trace {path!r}: schema {d.get('schema')!r} != "
                         f"{TRACE_SCHEMA}")
    if d.get("kind") not in ("collective", "schedule"):
        raise ValueError(f"trace {path!r}: unknown kind {d.get('kind')!r}")
    return d


def list_traces(traces_dir: Optional[str] = None) -> List[str]:
    tdir = traces_dir or CC.default_traces_dir()
    if not os.path.isdir(tdir):
        return []
    return [os.path.join(tdir, f) for f in sorted(os.listdir(tdir))
            if f.endswith(".json")]


# ---------------------------------------------------------------------------
# error reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ErrorRow:
    """One line of an error table: a group of replayed points."""
    group: str          # e.g. "coll=all_reduce", "size=64KiB-1MiB", "world=8"
    n: int
    mean_rel_err: float
    max_rel_err: float


@dataclasses.dataclass
class ErrorReport:
    """Measured-vs-predicted outcome for one trace: grouped error tables,
    the overall numbers, and the budget verdict."""
    name: str
    kind: str
    device: str
    rows: List[ErrorRow]
    mean_rel_err: float
    max_rel_err: float
    budget: float
    n_points: int

    @property
    def passed(self) -> bool:
        return self.mean_rel_err <= self.budget

    def table(self) -> str:
        lines = [f"{self.kind} trace {self.name} ({self.device}): "
                 f"mean={self.mean_rel_err:.3f} max={self.max_rel_err:.3f} "
                 f"budget={self.budget:.2f} "
                 f"[{'PASS' if self.passed else 'FAIL'}]"]
        for r in self.rows:
            lines.append(f"  {r.group:<24} n={r.n:<4} "
                         f"mean={r.mean_rel_err:.3f} max={r.max_rel_err:.3f}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"name": self.name, "kind": self.kind, "device": self.device,
                "mean_rel_err": self.mean_rel_err,
                "max_rel_err": self.max_rel_err, "budget": self.budget,
                "passed": self.passed, "n_points": self.n_points,
                "rows": [dataclasses.asdict(r) for r in self.rows]}


def _size_bucket(nbytes: float) -> str:
    """Log-decade size label: every point in a bucket shares the regime
    (latency-bound, mixed, bandwidth-bound) that one α–β point lives in."""
    if nbytes < 1024:
        return "size<1KiB"
    exp = int(math.log2(max(nbytes, 1.0)) // 4 * 4)     # 4-octave buckets
    lo, hi = 2 ** exp, 2 ** (exp + 4)

    def fmt(b):
        for unit, s in ((2 ** 30, "GiB"), (2 ** 20, "MiB"), (2 ** 10, "KiB")):
            if b >= unit:
                return f"{b // unit}{s}"
        return f"{b}B"
    return f"size={fmt(lo)}-{fmt(hi)}"


def _rows(groups: Dict[str, List[float]]) -> List[ErrorRow]:
    return [ErrorRow(group=g, n=len(errs),
                     mean_rel_err=float(np.mean(errs)),
                     max_rel_err=float(np.max(errs)))
            for g, errs in sorted(groups.items())]


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def validate_collective_trace(trace: dict,
                              ic: Optional[C.Interconnect] = None,
                              budget: Optional[float] = None) -> ErrorReport:
    """Replay every record through ``collective_time`` with ``ic`` (default:
    the calibrated interconnect for the trace's device — the full loop) and
    table the relative error per collective, per size decade, per world."""
    if ic is None:
        ic = CC.calibrated_interconnect(trace.get("device"))
    budget = BUDGETS["collective"] if budget is None else budget
    groups: Dict[str, List[float]] = {}
    errs = []
    for r in trace["records"]:
        meas = float(r["measured_s"])
        if meas <= 0 or int(r["world"]) <= 1:
            continue    # world-1 points are identically 0 in the model
        pred, _ = C.collective_time(r["coll"], float(r["nbytes"]),
                                    int(r["world"]), ic)
        e = abs(float(pred) - meas) / meas
        errs.append(e)
        for g in (f"coll={r['coll']}", _size_bucket(float(r["nbytes"])),
                  f"world={int(r['world'])}"):
            groups.setdefault(g, []).append(e)
    if not errs:
        raise ValueError(f"trace {trace.get('name')!r}: no informative "
                         "records (world > 1, measured_s > 0)")
    return ErrorReport(name=trace["name"], kind="collective",
                       device=trace.get("device", "?"), rows=_rows(groups),
                       mean_rel_err=float(np.mean(errs)),
                       max_rel_err=float(np.max(errs)),
                       budget=budget, n_points=len(errs))


def validate_schedule_trace(trace: dict,
                            budget: Optional[float] = None) -> ErrorReport:
    """Replay the recorded node durations through ``schedule.simulate`` and
    compare the simulated makespan (and, when recorded, per-stream busy
    times) against the measured ones."""
    budget = BUDGETS["schedule"] if budget is None else budget
    nodes = trace["nodes"]
    names = [n["name"] for n in nodes]
    index = {n: i for i, n in enumerate(names)}
    durations = [float(n["duration_s"]) for n in nodes]
    streams = [str(n["stream"]) for n in nodes]
    deps = [tuple(index[d] if isinstance(d, str) else int(d)
                  for d in n.get("deps", ())) for n in nodes]
    for i, dd in enumerate(deps):
        if any(d >= i for d in dd):
            raise ValueError(f"trace {trace.get('name')!r}: node {names[i]} "
                             "depends forward (nodes must be topological)")
    starts, ends, makespan = S.simulate(durations, streams, deps)
    measured = trace["measured"]
    groups: Dict[str, List[float]] = {}
    errs = []
    m = float(measured["makespan_s"])
    e = abs(makespan - m) / m
    errs.append(e)
    groups.setdefault("makespan", []).append(e)
    for stream, meas_busy in measured.get("stream_busy_s", {}).items():
        mask = np.array([s == stream for s in streams])
        sim_busy = float((ends[mask] - starts[mask]).sum())
        mb = float(meas_busy)
        if mb > 0:
            eb = abs(sim_busy - mb) / mb
            errs.append(eb)
            groups.setdefault(f"busy:{stream}", []).append(eb)
    return ErrorReport(name=trace["name"], kind="schedule",
                       device=trace.get("device", "?"), rows=_rows(groups),
                       mean_rel_err=float(np.mean(errs)),
                       max_rel_err=float(np.max(errs)),
                       budget=budget, n_points=len(errs))


def validate_trace(trace: dict, ic: Optional[C.Interconnect] = None,
                   budget: Optional[float] = None) -> ErrorReport:
    if trace["kind"] == "collective":
        return validate_collective_trace(trace, ic=ic, budget=budget)
    return validate_schedule_trace(trace, budget=budget)


def run_validation(traces_dir: Optional[str] = None, *,
                   calibration: Optional[CC.CommCalibration] = None,
                   budgets: Optional[Dict[str, float]] = None
                   ) -> List[ErrorReport]:
    """Replay every bundled trace.  Collective traces are replayed with
    ``calibration``'s fit for their device when given (an in-memory fit —
    the dry-run path that never touches the persisted artifact), else with
    ``calibrated_interconnect``'s view (persisted fit or datasheet)."""
    budgets = dict(BUDGETS, **(budgets or {}))
    reports = []
    for path in list_traces(traces_dir):
        trace = load_trace(path)
        ic = None
        if trace["kind"] == "collective" and calibration is not None:
            fit = calibration.fits.get(trace.get("device", ""))
            if fit is not None:
                ic = fit.interconnect()
        reports.append(validate_trace(trace, ic=ic,
                                      budget=budgets[trace["kind"]]))
    return reports
