"""Strong-scaling sweep: world size x parallelism strategy x device (the
JAX package's ``benchmarks/parallel_scaling.py`` on the card's store).

For a fixed (model, batch, seq) workload, predict one rank's end-to-end
latency, sharded compute plus the induced collectives priced by each
device's α–β interconnect (``core/collectives.py``), across world sizes
and strategies, and report latency, speedup over world 1, parallel
efficiency and the communication share.

    PYTHONPATH=src python -m repro_torch.benchmarks.parallel_scaling
        [--worlds 1,2,4,8] [--strategies dp,tp,tp-sp,pp]
        [--devices a100_80g,l4] [--archs qwen3-mini] [--batch 8]
        [--seq 256] [--dtype float32] [--json PATH] [--dry-run]
        [--torch-device cuda]

``--dry-run`` runs a minimal sweep (one arch, one device, worlds 1-2).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.benchmarks import common
from repro_torch.configs import registry as cr
from repro_torch.core.batch_predict import BatchPredictor
from repro_torch.core.device import resolve
from repro_torch.core.opgraph import ParallelismSpec

# strategy name -> spec builder at world size w
STRATEGIES = {
    "dp": lambda w: ParallelismSpec(dp=w),
    "tp": lambda w: ParallelismSpec(tp=w),
    "tp-sp": lambda w: ParallelismSpec(tp=w, act_mode="sp"),
    "pp": lambda w: ParallelismSpec(pp=w),
    # balanced hybrid: tensor-parallel pairs, data-parallel across them
    "dpxtp": lambda w: ParallelismSpec(dp=max(w // 2, 1), tp=min(w, 2)),
}


def run(store=None, *, batch=8, seq=256, worlds=(1, 2, 4, 8),
        strategies=None, devices=None, archs=None, dtype=None, verbose=True,
        torch_device="cuda") -> list:
    """One row per (arch, device, strategy, world)."""
    store = store or common.get_calibration(resolve(torch_device))
    bp = BatchPredictor(store, store.meta["device"])
    bp.host_profile()                       # register the store's device
    devices = devices or ["a100_80g", "h100_sxm", "l4"]
    strategies = strategies or ["dp", "tp", "tp-sp", "pp"]
    cfgs = {n: cr.get_any(n)
            for n in (archs or ["qwen3-mini", "qwen2-0.5b-reduced"])}

    rows = []
    for name, cfg in cfgs.items():
        for dev in devices:
            base = None
            for w in sorted(set(int(x) for x in worlds)):
                for strat in strategies:
                    spec = STRATEGIES[strat](w)
                    total, prows = bp.predict_parallel(cfg, batch, seq, spec,
                                                       dtype=dtype,
                                                       device=dev)
                    comm = sum(r.seconds for r in prows
                               if r.kind == "collective")
                    if w == 1 and base is None:
                        base = total    # every strategy is one at w = 1
                    speedup = base / total if base else float("nan")
                    # the spec's own world: dpxtp at an odd w rounds down
                    rows.append({
                        "arch": name, "device": dev, "strategy": strat,
                        "world": spec.world, "dp": spec.dp, "tp": spec.tp,
                        "pp": spec.pp, "act_mode": spec.act_mode,
                        "seconds": total, "comm_seconds": comm,
                        "comm_share": comm / total if total else 0.0,
                        "speedup": speedup,
                        "efficiency": (speedup / spec.world if spec.world
                                       else float("nan")),
                    })

    if verbose:
        print(f"{'arch':28s} {'device':10s} {'strat':6s} {'w':>3s} "
              f"{'ms':>10s} {'comm ms':>9s} {'share':>6s} "
              f"{'speedup':>8s} {'eff':>6s}")
        for r in rows:
            print(f"{r['arch']:28s} {r['device']:10s} {r['strategy']:6s} "
                  f"{r['world']:3d} {r['seconds']*1e3:10.3f} "
                  f"{r['comm_seconds']*1e3:9.3f} {r['comm_share']:6.3f} "
                  f"{r['speedup']:8.2f} {r['efficiency']:6.2f}")
    for r in rows:
        common.emit(
            f"parallel/{r['arch']}/{r['device']}/{r['strategy']}@{r['world']}"
            f"_ms", r["seconds"] * 1e3,
            f"share={r['comm_share']:.3f},speedup={r['speedup']:.2f}")
    return rows


def dry_run(store=None, *, dtype=None, torch_device="cuda") -> list:
    """The minimal sweep: one arch and device, worlds 1 and 2."""
    return run(store, batch=2, seq=64, worlds=(1, 2),
               strategies=["tp", "pp"], devices=["a100_80g"],
               archs=["qwen2-0.5b-reduced"], dtype=dtype,
               torch_device=torch_device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--worlds", default="1,2,4,8",
                    help="comma-separated world sizes")
    ap.add_argument("--strategies", default=None,
                    help=f"comma-separated, from {sorted(STRATEGIES)}")
    ap.add_argument("--devices", default=None,
                    help="comma-separated registry names")
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch names")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--json", default=None, help="write the table here")
    ap.add_argument("--dry-run", action="store_true",
                    help="minimal sweep: one arch/device, w<=2")
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)
    split = lambda s: s.split(",") if s else None
    store = common.get_calibration(resolve(args.torch_device))
    if args.dry_run:
        batch, seq = 2, 64
        rows = dry_run(store, dtype=args.dtype)
    else:
        batch, seq = args.batch, args.seq
        rows = run(store, batch=batch, seq=seq,
                   worlds=[int(x) for x in args.worlds.split(",")],
                   strategies=split(args.strategies),
                   devices=split(args.devices), archs=split(args.archs),
                   dtype=args.dtype)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"batch": batch, "seq": seq, "rows": rows},
                      f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
