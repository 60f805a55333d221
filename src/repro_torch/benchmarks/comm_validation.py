"""Measured-against-predicted comm and cache validation (the JAX package's
``benchmarks/comm_validation.py`` on the port's ``core/comm_calibrate.py``
and ``core/validate.py``):

  real run       the measured loop on the card (loopback sweep, the
                 recorded traces' fits for the NVLink and PCIe worlds one
                 card cannot run, the L2 sweep), the artifact persisted
                 (``artifacts/torch/comm_calibration.json``), then every
                 bundled trace replayed against the fitted constants, each
                 held to its pinned error budget;
  --dry-run      no sweep, nothing persisted: the bundled traces fitted in
                 memory, every trace held to its budget, then the harness
                 shown to have teeth (constants with link_bw / 3 must fail
                 every collective budget) and replay shown deterministic
                 (two passes, bit-identical errors);
  --regen-traces the bundled traces rebuilt from their pinned ground-truth
                 constants and seeds, bit-identical, under ``--traces-dir``
                 (default ``artifacts/torch/traces``: the bundled
                 ``artifacts/traces/`` is the JAX package's and is only
                 read).

    PYTHONPATH=src python -m repro_torch.benchmarks.comm_validation
        [--dry-run] [--regen-traces] [--traces-dir DIR] [--device cuda]

Writes ``artifacts/torch/BENCH_comm_validation[_dry].json`` (or
``--json``): per-trace error tables.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.benchmarks import common
from repro_torch.core import calibrate
from repro_torch.core import collectives as C
from repro_torch.core import comm_calibrate as CC
from repro_torch.core import schedule as S
from repro_torch.core import validate as V

# The ground truth behind the bundled recorded traces: off the datasheet
# constants on purpose (real links never reach them), so that fitting them
# means something and the datasheet replay differs from the calibrated one.
_COLLS = ("all_reduce", "all_gather", "broadcast", "all_to_all")
TRACE_TRUTHS = {
    "nccl_a100_nvlink_w8": dict(
        device="a100_80g",
        ic=C.Interconnect("nvlink-mesh", 23e9, 2.6e-6, 12, eff_gamma=0.045),
        worlds=(2, 4, 8), colls=_COLLS, noise=0.015, seed=7),
    "nccl_l4_pcie_w4": dict(
        device="l4",
        ic=C.Interconnect("pcie-tree", 27e9, 6.5e-6, 1, eff_gamma=0.15),
        worlds=(2, 4), colls=_COLLS, noise=0.015, seed=11),
}


# Recorded overlap schedules: stream timelines (durations in seconds) whose
# measured makespan differs from the ideal list schedule by the recorded
# jitter; the simulator must land within the schedule budget.
def _gpipe_nodes():
    nodes = []
    for mb in range(4):
        nodes.append({"name": f"s0.mb{mb}.fwd", "stream": "compute:s0",
                      "duration_s": 1.00e-3, "deps": []})
        nodes.append({"name": f"pp.act_p2p.mb{mb}", "stream": "comm",
                      "duration_s": 0.13e-3, "deps": [f"s0.mb{mb}.fwd"]})
        nodes.append({"name": f"s1.mb{mb}.fwd", "stream": "compute:s1",
                      "duration_s": 1.07e-3, "deps": [f"pp.act_p2p.mb{mb}"]})
    return nodes


def _ddp_nodes():
    nodes = []
    ars = []
    for i in range(4):
        nodes.append({"name": f"bwd.chunk{i}", "stream": "compute",
                      "duration_s": 0.82e-3, "deps": []})
        nodes.append({"name": f"grad.bucket{i}.all_reduce", "stream": "comm",
                      "duration_s": 0.55e-3, "deps": [f"bwd.chunk{i}"]})
        ars.append(f"grad.bucket{i}.all_reduce")
    nodes.append({"name": "opt.update", "stream": "compute",
                  "duration_s": 0.21e-3, "deps": ars})
    return nodes


SCHEDULE_TRACES = {
    "gpipe_pp2_mb4": dict(device="a100_80g", nodes=_gpipe_nodes,
                          jitter=1.018),
    "ddp_bucket_overlap": dict(device="a100_80g", nodes=_ddp_nodes,
                               jitter=0.992),
}


def _simulated_makespan(nodes) -> float:
    index = {n["name"]: i for i, n in enumerate(nodes)}
    _, _, makespan = S.simulate(
        [n["duration_s"] for n in nodes],
        [n["stream"] for n in nodes],
        [tuple(index[d] for d in n["deps"]) for n in nodes])
    return makespan


def regen_traces(traces_dir=None, verbose=True):
    """Rebuild every bundled trace, bit-identical, from its pinned truth,
    under ``traces_dir`` (default ``artifacts/torch/traces``)."""
    tdir = traces_dir or os.path.join(calibrate.artifacts_dir(), "traces")
    os.makedirs(tdir, exist_ok=True)
    paths = []
    for name, t in TRACE_TRUTHS.items():
        ic = t["ic"]
        recs = CC.synthesize_records(ic, worlds=t["worlds"], colls=t["colls"],
                                     noise=t["noise"], seed=t["seed"])
        trace = {"schema": V.TRACE_SCHEMA, "kind": "collective",
                 "name": name, "device": t["device"],
                 "topology": ic.topology, "links_per_gpu": ic.links_per_gpu,
                 "records": [r.to_json() for r in recs],
                 "meta": {"source": "synthesized-recording",
                          "truth": dataclasses.asdict(ic),
                          "noise": t["noise"], "seed": t["seed"]}}
        paths.append(_write_trace(tdir, name, trace, verbose))
    for name, t in SCHEDULE_TRACES.items():
        nodes = t["nodes"]()
        trace = {"schema": V.TRACE_SCHEMA, "kind": "schedule",
                 "name": name, "device": t["device"], "nodes": nodes,
                 "measured": {"makespan_s":
                              _simulated_makespan(nodes) * t["jitter"]},
                 "meta": {"source": "synthesized-recording",
                          "jitter": t["jitter"]}}
        paths.append(_write_trace(tdir, name, trace, verbose))
    return paths


def _write_trace(tdir, name, trace, verbose):
    path = os.path.join(tdir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(trace, f, indent=1, sort_keys=True)
    if verbose:
        print(f"wrote {path}")
    return path


def _fit_traces(traces_dir=None) -> CC.CommCalibration:
    """In-memory fits of every bundled collective trace (never persisted:
    a dry run must not switch the port into calibrated mode)."""
    cal = CC.CommCalibration()
    for path in V.list_traces(traces_dir):
        trace = V.load_trace(path)
        if trace["kind"] != "collective":
            continue
        recs = [CC.CommRecord.from_json(r) for r in trace["records"]]
        cal.fits[trace["device"]] = CC.fit_interconnect(
            recs, trace["topology"],
            links_per_gpu=int(trace.get("links_per_gpu", 1)))
    return cal


def run(dry: bool = False, traces_dir=None, verbose: bool = True,
        device="cuda", path=None) -> dict:
    """The record; ``path``: where it goes (default
    ``artifacts/torch/BENCH_comm_validation[_dry].json``)."""
    if dry:
        cal = _fit_traces(traces_dir)
    else:
        cal = CC.calibrate_comm(traces_dir=traces_dir, save=True,
                                verbose=verbose, device=device)
    reports = V.run_validation(traces_dir, calibration=cal)
    if not reports:
        raise SystemExit("no traces found: run with --regen-traces first")
    for r in reports:
        if verbose:
            print(r.table())
        assert r.passed, (f"trace {r.name}: mean rel err {r.mean_rel_err:.3f}"
                          f" exceeds budget {r.budget:.2f}")

    # the harness must have teeth: a 3x bandwidth regression in the
    # constants has to fail every collective budget
    perturbed_fails = []
    for tpath in V.list_traces(traces_dir):
        trace = V.load_trace(tpath)
        if trace["kind"] != "collective":
            continue
        fit = cal.fits[trace["device"]]
        bad_ic = dataclasses.replace(fit.interconnect(),
                                     link_bw=fit.link_bw / 3.0)
        bad = V.validate_collective_trace(trace, ic=bad_ic)
        perturbed_fails.append({"name": bad.name,
                                "mean_rel_err": bad.mean_rel_err})
        assert not bad.passed, (
            f"perturbed-constants replay of {bad.name} still passed "
            f"({bad.mean_rel_err:.3f} <= {bad.budget:.2f}): "
            "the budget cannot catch a 3x bandwidth regression")
        if verbose:
            print(f"perturbed {bad.name}: mean={bad.mean_rel_err:.3f} "
                  f"> budget {bad.budget:.2f} [FAILS as it must]")

    # replay is deterministic: the same trace through the same constants
    # is bit-identical (float arithmetic only, no random draw)
    again = V.run_validation(traces_dir, calibration=cal)
    for a, b in zip(reports, again):
        assert (a.mean_rel_err == b.mean_rel_err
                and a.max_rel_err == b.max_rel_err), (
            f"non-deterministic replay of {a.name}")

    payload = {
        "dry": dry,
        "budgets": dict(V.BUDGETS),
        "reports": [r.to_json() for r in reports],
        "perturbed": perturbed_fails,
        "fits": {k: f.to_json() for k, f in cal.fits.items()},
    }
    out = common.write_bench("comm_validation", payload, dry=dry, path=path)
    if verbose:
        print(f"comm_validation ok: {len(reports)} traces within budget, "
              f"{len(perturbed_fails)} perturbed replays correctly failed; "
              f"wrote {out}")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-run", action="store_true",
                    help="bundled traces only; no sweep, nothing persisted")
    ap.add_argument("--regen-traces", action="store_true",
                    help="rebuild the bundled traces from pinned truths")
    ap.add_argument("--traces-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.regen_traces:
        regen_traces(args.traces_dir)
        return
    run(dry=args.dry_run, traces_dir=args.traces_dir, device=args.device,
        path=args.json)


if __name__ == "__main__":
    main()
