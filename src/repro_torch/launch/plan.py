"""Partition planner CLI: PM2Lat-driven pipeline-stage balancing
(the paper's §IV-D1 application as a framework feature; the JAX package's
``launch/plan.py``, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.plan --arch qwen2-0.5b \
      --reduced --batch 8 --seq 64 --device-b-scale 0.4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.plan --arch yi-6b --stages 4

Prices the blocks with the device's calibrated store
(``calibrate.load_or_calibrate``: ``artifacts/torch/`` or
``$REPRO_ARTIFACTS/torch/``; a device without one is calibrated first).
Plans for the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import registry as cr
from repro_torch.core import calibrate
from repro_torch.core import partition
from repro_torch.core.predictor import PM2Lat


def run(args) -> partition.PartitionPlan:
    cfg = cr.reduced(args.arch) if args.reduced else cr.get_any(args.arch)
    store = calibrate.load_or_calibrate(device=args.device, verbose=False)
    pred = PM2Lat(store, calibrate.device_name(args.device))
    lat = pred.predict_blocks(cfg, args.batch, args.seq)
    if args.stages > 2 or args.device_b_scale == 1.0:
        plan = partition.plan_stages(lat, args.stages)
    else:
        lat_b = [t * args.device_b_scale for t in lat]
        plan = partition.plan_two_devices(lat, lat_b, comm_cost=args.comm_cost)
    if args.verbose:
        print(f"[plan] arch={cfg.name} blocks={len(lat)} stages={args.stages}")
        print(f"[plan] boundaries={plan.boundaries} "
              f"stage_times={[f'{t*1e3:.1f}ms' for t in plan.stage_times]} "
              f"bottleneck={plan.bottleneck*1e3:.1f}ms")
    return plan


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--device-b-scale", type=float, default=1.0,
                    help="per-block latency multiplier for device B (0.5 = B is 2x faster)")
    ap.add_argument("--comm-cost", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    # the JAX launcher's flag, kept for its command lines: it is always on
    ap.add_argument("--verbose", action="store_true", default=True)
    return ap.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
