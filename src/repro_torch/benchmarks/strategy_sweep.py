"""Vectorized strategy-sweep benchmark: specs/s against the per-spec loop
(the JAX package's ``benchmarks/strategy_sweep.py`` on the card's store).

``core/schedule.py::sweep_strategies`` prices a whole (dp, tp, pp,
microbatches, bucket_mb) strategy grid in one template/bind/simulate-batch
pass; the per-spec alternative builds and walks a full ``OpGraph`` a point
(``schedule_parallel`` / ``schedule_step``).  This benchmark times both on
the same grid and checks that they agree within 1e-9 relative makespan
error.

* **training sweep**: every (dp, tp, pp, mb) in the spec grid crossed with
  every gradient-bucket size, each point one optimizer step (forward,
  backward, bucketed gradient all-reduce, optimizer).  The per-spec loop
  is timed on a strided subset (``--loop-limit``) and extrapolated.
* **forward sweep**: the same spec grid forward only, against the
  ``schedule_parallel`` loop.

    PYTHONPATH=src python -m repro_torch.benchmarks.strategy_sweep
        [--arch qwen3-mini] [--device a100_80g] [--batch 8] [--seq 128]
        [--dp 1,2,4,8] [--tp 1,2,4,8] [--pp 1,2,4,8]
        [--microbatches 1,2,4,8] [--buckets 1,5,25,100]
        [--schedules gpipe,1f1b,interleaved] [--loop-limit 64] [--plan]
        [--devices 64] [--json PATH] [--dry-run] [--torch-device cuda]

``--device`` is the fleet target priced; ``--torch-device`` the device
whose store is read.  ``--dry-run`` prices a small grid on the reduced
arch, all three schedule kinds, and asserts the golden equivalence over
every point and that 1F1B never loses to GPipe (``dry_run``).  ``--plan``
also runs ``LatencyService.plan_training`` for ``--devices`` and records
the winning feasible plan.  The record goes to ``--json`` or
``artifacts/torch/BENCH_strategy_sweep[_dry].json``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.configs import registry as cr
from repro_torch.core import devices as D
from repro_torch.core.batch_predict import BatchPredictor
from repro_torch.core.device import resolve
from repro_torch.core.schedule import TrainingStepSpec, strategy_grid

DRY_ARCH = "qwen2-0.5b-reduced"


def _cross_buckets(specs, buckets):
    """(spec grid) x (bucket sizes) -> aligned (specs, trains) lists."""
    out_s, out_t = [], []
    for bkt in buckets:
        tr = TrainingStepSpec(bucket_mb=float(bkt))
        for sp in specs:
            out_s.append(sp)
            out_t.append(tr)
    return out_s, out_t


def run(store=None, *, arch="qwen3-mini", device="a100_80g", batch=8,
        seq=128, dp=(1, 2, 4, 8), tp=(1, 2, 4, 8), pp=(1, 2, 4, 8),
        microbatches=(1, 2, 4, 8), buckets=(1.0, 5.0, 25.0, 100.0),
        schedules=("gpipe",), loop_limit=64, dtype=None, verbose=True,
        torch_device="cuda") -> dict:
    store = store or common.get_calibration(resolve(torch_device))
    bp = BatchPredictor(store, store.meta["device"])
    bp.host_profile()
    cfg = cr.get_any(arch)
    pred = bp.for_device(device)

    specs = strategy_grid(dp=dp, tp=tp, pp=pp, microbatches=microbatches,
                          schedules=schedules)
    tspecs, trains = _cross_buckets(specs, buckets)
    n = len(tspecs)
    cap = float(D.get_profile(device).hbm_bytes)

    # warm the predictor's per-shape caches once, so that the timed
    # comparison is warm against warm
    pred.sweep_strategies(cfg, batch, seq, tspecs, train=trains, dtype=dtype)
    with common.timer() as t_sweep:
        sw = pred.sweep_strategies(cfg, batch, seq, tspecs, train=trains,
                                   dtype=dtype, hbm_bytes=cap)
    assert bool(sw.bounds_ok().all()), "sweep violated schedule bounds"
    sweep_sps = n / t_sweep.s

    # the per-spec loop on an evenly strided subset of the same grid
    loop_n = min(int(loop_limit), n) if loop_limit else n
    idx = np.linspace(0, n - 1, loop_n).astype(int) if loop_n else []
    with common.timer() as t_loop:
        loop_secs = [pred.schedule_step(cfg, batch, seq, spec=tspecs[i],
                                        train=trains[i], dtype=dtype).makespan
                     for i in idx]
    loop_sps = loop_n / t_loop.s if loop_n else 0.0
    speedup = sweep_sps / loop_sps if loop_sps else float("inf")
    max_rel = max(abs(sw.seconds[i] - s) / s
                  for i, s in zip(idx, loop_secs)) if loop_n else 0.0

    # schedule kinds: for every (dp, tp, pp > 1, mb, bucket) point swept
    # under more than one schedule, the 1F1B / interleaved makespan over
    # GPipe's (1F1B must never lose)
    by_point = {}
    for i, (sp, tr) in enumerate(zip(tspecs, trains)):
        k = (sp.dp, sp.tp, sp.pp, sp.microbatches, sp.act_mode, tr.bucket_mb)
        by_point.setdefault(k, {})[sp.schedule] = float(sw.seconds[i])
    ratios = {"1f1b": [], "interleaved": []}
    for k, per in by_point.items():
        if "gpipe" not in per or k[2] == 1:
            continue
        for sch in ("1f1b", "interleaved"):
            if sch in per:
                ratios[sch].append(per[sch] / per["gpipe"])
    sched_cmp = {sch: {"n": len(r), "max_ratio": max(r), "min_ratio": min(r)}
                 for sch, r in ratios.items() if r}

    # forward only, on the bare spec grid
    pred.sweep_strategies(cfg, batch, seq, specs, dtype=dtype)
    with common.timer() as t_fwd:
        fsw = pred.sweep_strategies(cfg, batch, seq, specs, dtype=dtype)
    fwd_n = min(int(loop_limit), len(specs)) if loop_limit else len(specs)
    fidx = np.linspace(0, len(specs) - 1, fwd_n).astype(int)
    with common.timer() as t_floop:
        floop = [pred.schedule_parallel(cfg, batch, seq, specs[i],
                                        dtype=dtype).makespan for i in fidx]
    fwd_rel = max(abs(fsw.seconds[i] - s) / s
                  for i, s in zip(fidx, floop)) if fwd_n else 0.0
    fwd_sps = len(specs) / t_fwd.s
    floop_sps = fwd_n / t_floop.s if fwd_n else 0.0

    res = {
        "arch": cfg.name, "device": pred.device, "batch": int(batch),
        "seq": int(seq), "dtype": dtype or "float32",
        "n_specs": n, "sweep_seconds": t_sweep.s,
        "specs_per_sec": sweep_sps,
        "loop_n": int(loop_n), "loop_seconds": t_loop.s,
        "loop_specs_per_sec": loop_sps,
        "speedup": speedup, "max_rel_err": float(max_rel),
        "schedule_vs_gpipe": sched_cmp,
        "n_feasible": int(sw.feasible.sum()), "hbm_bytes": cap,
        "forward": {"n_specs": len(specs), "sweep_seconds": t_fwd.s,
                    "specs_per_sec": fwd_sps, "loop_n": int(fwd_n),
                    "loop_specs_per_sec": floop_sps,
                    "speedup": fwd_sps / floop_sps if floop_sps
                    else float("inf"),
                    "max_rel_err": float(fwd_rel)},
        "best": sw.row(sw.best()),
        "seconds": [float(x) for x in sw.seconds],
    }
    if verbose:
        print(f"train grid: {n} specs  sweep {t_sweep.s*1e3:.1f}ms "
              f"({sweep_sps:,.0f}/s)  loop[{loop_n}] "
              f"({loop_sps:,.0f}/s)  speedup {speedup:.1f}x  "
              f"max rel err {max_rel:.2e}")
        print(f"fwd grid:   {len(specs)} specs  sweep {t_fwd.s*1e3:.1f}ms "
              f"({fwd_sps:,.0f}/s)  loop[{fwd_n}] ({floop_sps:,.0f}/s)  "
              f"max rel err {fwd_rel:.2e}")
        print(f"best train spec: {res['best']['spec']} "
              f"{res['best']['seconds']*1e3:.3f}ms")
    common.emit("strategy_sweep/train_specs_per_sec", 1e6 / sweep_sps,
                f"{sweep_sps:.0f}/s over {n} specs")
    common.emit("strategy_sweep/speedup_vs_loop", t_sweep.s * 1e6 / n,
                f"{speedup:.1f}x (loop {loop_sps:.0f}/s)")
    return res


def dry_run(store=None, *, device="a100_80g", dtype=None,
            torch_device="cuda") -> dict:
    """A small grid on the reduced arch, all three schedule kinds, with the
    JAX package's golden checks: every point within 1e-9 of the per-spec
    loop, forward and training, and 1F1B never above GPipe."""
    res = run(store, arch=DRY_ARCH, device=device,
              batch=4, seq=64, dp=(1, 2), tp=(1,), pp=(1, 2),
              microbatches=(1, 2), buckets=(1.0, 25.0),
              schedules=("gpipe", "1f1b", "interleaved"),
              loop_limit=0, dtype=dtype, torch_device=torch_device)
    assert res["max_rel_err"] <= 1e-9, res["max_rel_err"]
    assert res["forward"]["max_rel_err"] <= 1e-9, res["forward"]
    cmp = res["schedule_vs_gpipe"]
    assert cmp["1f1b"]["n"] > 0 and cmp["interleaved"]["n"] > 0, cmp
    # 1F1B must never lose to GPipe on any swept pipeline point
    assert cmp["1f1b"]["max_ratio"] <= 1 + 1e-9, cmp["1f1b"]
    print("dry-run golden check ok (every point <= 1e-9 rel; "
          f"1f1b/gpipe max ratio {cmp['1f1b']['max_ratio']:.6f})")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-mini")
    ap.add_argument("--device", default="a100_80g")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dp", default="1,2,4,8")
    ap.add_argument("--tp", default="1,2,4,8")
    ap.add_argument("--pp", default="1,2,4,8")
    ap.add_argument("--microbatches", default="1,2,4,8")
    ap.add_argument("--buckets", default="1,5,25,100",
                    help="comma-separated gradient-bucket sizes (MiB)")
    ap.add_argument("--schedules", default="gpipe",
                    help="comma-separated pipeline schedule kinds "
                         "(gpipe,1f1b,interleaved)")
    ap.add_argument("--loop-limit", type=int, default=64,
                    help="per-spec loop subset size (golden + timing)")
    ap.add_argument("--plan", action="store_true",
                    help="run LatencyService.plan_training on the same "
                         "arch/device and report the winning feasible plan")
    ap.add_argument("--devices", type=int, default=64,
                    help="device budget for --plan")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--dry-run", action="store_true",
                    help="small grid on the reduced arch, golden-check "
                         "every point")
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)
    ints = lambda s: tuple(int(x) for x in s.split(","))
    store = common.get_calibration(resolve(args.torch_device))
    if args.dry_run:
        res = dry_run(store, device=args.device, dtype=args.dtype)
    else:
        res = run(store, arch=args.arch, device=args.device,
                  batch=args.batch, seq=args.seq, dp=ints(args.dp),
                  tp=ints(args.tp), pp=ints(args.pp),
                  microbatches=ints(args.microbatches),
                  buckets=tuple(float(x) for x in args.buckets.split(",")),
                  schedules=tuple(args.schedules.split(",")),
                  loop_limit=args.loop_limit, dtype=args.dtype)
    if args.plan:
        from repro_torch.serving.latency_service import LatencyService
        svc = LatencyService(store, store.meta["device"])
        arch = DRY_ARCH if args.dry_run else args.arch
        plan = svc.plan_training(
            arch, args.batch, args.seq, devices=args.devices,
            bucket_mbs=tuple(float(x) for x in args.buckets.split(",")),
            dtype=args.dtype, device=args.device)
        res["plan"] = plan.to_json()
        print(f"plan[{args.devices} devices]: {plan.breakdown['spec']}  "
              f"{plan.seconds*1e3:.3f}ms  "
              f"peak {plan.peak_bytes/2**30:.2f}GiB  "
              f"feasible {plan.n_feasible}/{plan.n_candidates}")
    res["dry_run"] = bool(args.dry_run)
    path = common.write_bench("strategy_sweep", res, dry=args.dry_run,
                              path=args.json)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
