"""Overlap-scaling sweep: world size x microbatches x gradient-bucket size
(the JAX package's ``benchmarks/overlap_scaling.py`` on the card's store).

The schedule layer (``core/schedule.py``) prices parallel execution as a
two-stream list-schedule makespan instead of a sequential sum.  This
benchmark sweeps the two overlap mechanisms that makes visible:

* **pipeline sweep**: for each world size w (run as ``pp=w``) and each
  microbatch count, the forward makespan, the sequential sum of the same
  schedule's ops and the bubble share;
* **training sweep**: for each world size w (run as ``dp=w``) and each
  gradient-bucket size, one training step: total against exposed
  communication, how much of the gradient all-reduce the bucket schedule
  hides behind the backward.

    PYTHONPATH=src python -m repro_torch.benchmarks.overlap_scaling
        [--worlds 2,4,8] [--microbatches 1,2,4,8] [--buckets 1,5,25,100]
        [--archs qwen3-mini] [--devices a100_80g] [--batch 16] [--seq 256]
        [--dtype float32] [--json PATH] [--dry-run] [--torch-device cuda]

``--dry-run`` runs a minimal sweep (one arch and device, world 2, two
microbatch counts, two bucket sizes).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.benchmarks import common
from repro_torch.configs import registry as cr
from repro_torch.core.batch_predict import BatchPredictor
from repro_torch.core.device import resolve
from repro_torch.core.opgraph import ParallelismSpec
from repro_torch.core.schedule import TrainingStepSpec


def run(store=None, *, batch=16, seq=256, worlds=(2, 4, 8),
        microbatches=(1, 2, 4, 8), buckets=(1.0, 5.0, 25.0, 100.0),
        devices=None, archs=None, dtype=None, verbose=True,
        torch_device="cuda"):
    """(pipeline rows, training rows)."""
    store = store or common.get_calibration(resolve(torch_device))
    bp = BatchPredictor(store, store.meta["device"])
    bp.host_profile()                       # register the store's device
    devices = devices or ["a100_80g"]
    cfgs = {n: cr.get_any(n) for n in (archs or ["qwen3-mini"])}

    pipe_rows, train_rows = [], []
    for name, cfg in cfgs.items():
        for dev in devices:
            for w in sorted(set(int(x) for x in worlds)):
                for mb in sorted(set(int(x) for x in microbatches)):
                    spec = ParallelismSpec(pp=w, microbatches=mb)
                    sched = bp.schedule_parallel(cfg, batch, seq, spec,
                                                 dtype=dtype, device=dev)
                    pipe_rows.append({
                        "arch": name, "device": dev, "pp": w,
                        "microbatches": mb,
                        "seconds": sched.makespan,
                        "sequential_seconds": sched.sequential_seconds,
                        "bubble_share": sched.bubble_share,
                        "comm_seconds": sched.comm_seconds,
                    })
                for bkt in sorted(set(float(x) for x in buckets)):
                    spec = ParallelismSpec(dp=w)
                    train = TrainingStepSpec(bucket_mb=bkt)
                    sched = bp.schedule_step(cfg, batch, seq, spec=spec,
                                             train=train, dtype=dtype,
                                             device=dev)
                    comm = sched.comm_seconds
                    exposed = sched.exposed_comm_seconds
                    train_rows.append({
                        "arch": name, "device": dev, "dp": w,
                        "bucket_mb": bkt,
                        "seconds": sched.makespan,
                        "sequential_seconds": sched.sequential_seconds,
                        "comm_seconds": comm,
                        "exposed_comm_seconds": exposed,
                        "hidden_share": (1.0 - exposed / comm) if comm
                        else 0.0,
                    })

    if verbose:
        print(f"{'arch':24s} {'device':10s} {'pp':>3s} {'mb':>3s} "
              f"{'ms':>10s} {'seq ms':>10s} {'bubble':>7s}")
        for r in pipe_rows:
            print(f"{r['arch']:24s} {r['device']:10s} {r['pp']:3d} "
                  f"{r['microbatches']:3d} {r['seconds']*1e3:10.3f} "
                  f"{r['sequential_seconds']*1e3:10.3f} "
                  f"{r['bubble_share']:7.3f}")
        print(f"\n{'arch':24s} {'device':10s} {'dp':>3s} {'bkt MB':>7s} "
              f"{'ms':>10s} {'comm ms':>9s} {'expo ms':>9s} {'hidden':>7s}")
        for r in train_rows:
            print(f"{r['arch']:24s} {r['device']:10s} {r['dp']:3d} "
                  f"{r['bucket_mb']:7.1f} {r['seconds']*1e3:10.3f} "
                  f"{r['comm_seconds']*1e3:9.3f} "
                  f"{r['exposed_comm_seconds']*1e3:9.3f} "
                  f"{r['hidden_share']:7.3f}")
    for r in pipe_rows:
        common.emit(
            f"overlap/{r['arch']}/{r['device']}/pp{r['pp']}"
            f".mb{r['microbatches']}_ms", r["seconds"] * 1e3,
            f"bubble={r['bubble_share']:.3f}")
    for r in train_rows:
        common.emit(
            f"overlap/{r['arch']}/{r['device']}/train.dp{r['dp']}"
            f".bkt{r['bucket_mb']:g}_ms", r["seconds"] * 1e3,
            f"hidden={r['hidden_share']:.3f}")
    return pipe_rows, train_rows


def dry_run(store=None, *, dtype=None, torch_device="cuda"):
    """The minimal sweep: one arch and device, world 2."""
    return run(store, batch=4, seq=64, worlds=(2,), microbatches=(1, 2),
               buckets=(1.0, 25.0), devices=["a100_80g"],
               archs=["qwen2-0.5b-reduced"], dtype=dtype,
               torch_device=torch_device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--worlds", default="2,4,8",
                    help="comma-separated world sizes (pp for the pipeline "
                         "sweep, dp for the training sweep)")
    ap.add_argument("--microbatches", default="1,2,4,8")
    ap.add_argument("--buckets", default="1,5,25,100",
                    help="comma-separated gradient-bucket sizes (MiB)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated registry names")
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch names")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--json", default=None, help="write the tables here")
    ap.add_argument("--dry-run", action="store_true",
                    help="minimal sweep: one arch/device, w=2")
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)
    split = lambda s: s.split(",") if s else None
    store = common.get_calibration(resolve(args.torch_device))
    if args.dry_run:
        batch, seq = 4, 64
        pipe, train = dry_run(store, dtype=args.dtype)
    else:
        batch, seq = args.batch, args.seq
        pipe, train = run(
            store, batch=batch, seq=seq,
            worlds=[int(x) for x in args.worlds.split(",")],
            microbatches=[int(x) for x in args.microbatches.split(",")],
            buckets=[float(x) for x in args.buckets.split(",")],
            devices=split(args.devices), archs=split(args.archs),
            dtype=args.dtype)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"batch": batch, "seq": seq, "pipeline": pipe,
                       "training": train}, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
