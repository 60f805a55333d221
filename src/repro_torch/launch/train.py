"""Training launcher: the fault-tolerant loop over the train step (the JAX
package's ``launch/train.py``, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 30 --batch 8 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 10 --batch 8 --seq 512 --compute-dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 10 --fail-at 5 --ckpt-every 2 --device cpu

Runs on the card unless ``--device cpu``; weights are random from
``--seed`` and held in float32 (so are AdamW's moments) whatever the
compute dtype, as in the JAX package.  One device: ``--mesh`` takes
``1x1`` only (the sharded mesh comes with the distributed slice), and
``--act-mode`` is accepted for the JAX launcher's command lines (on a 1x1
mesh it changes nothing there either).  The loop resumes from the newest
checkpoint in ``--ckpt-dir`` if there is one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import registry as cr
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft import driver as ftd
from repro_torch.models import registry as mr
from repro_torch.training import optimizer as opt
from repro_torch.training import step as tstep

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "ckpt"


def run(args) -> dict:
    if args.mesh != "1x1":
        raise ValueError(f"--mesh {args.mesh}: the port trains on one device "
                         f"(1x1); a sharded mesh needs the distributed slice")
    cfg = cr.reduced(args.arch) if args.reduced else cr.get_any(args.arch)
    cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    model = mr.build(cfg, device=args.device, seed=args.seed)
    params = tstep.trainable_params(model)
    adamw = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                            total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed),
                       device=args.device)
    step_fn = tstep.build_train_step(
        model, adamw, num_microbatches=args.microbatches,
        block_skip=args.block_skip, fused_ce=not args.naive_ce,
        remat=not args.no_remat)
    store = CheckpointStore(str(args.ckpt_dir), keep=3,
                            async_write=not args.sync_ckpt)
    injector = ftd.FailureInjector(tuple(args.fail_at or ()))
    monitor = ftd.StragglerMonitor()
    # the JAX launcher's make_ctx(key(0), B): the same context every step
    ctx = model.make_ctx(args.batch)

    def wrapped_step(state, batch):
        params, opt_state = state
        if ctx is not None:
            batch = dict(batch, ctx=ctx)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        return (params, opt_state), metrics

    t0 = time.time()
    _, log = ftd.run_training(
        step_fn=wrapped_step, init_state=(params, opt.init_opt_state(params)),
        data=data, num_steps=args.steps, store=store,
        ckpt_every=args.ckpt_every, injector=injector, monitor=monitor)
    wall = time.time() - t0

    result = {"losses": log.losses, "steps": log.steps,
              "restarts": log.restarts, "wall_s": wall,
              "straggler_events": log.straggler_events,
              "final_loss": log.losses[-1] if log.losses else float("nan"),
              "first_loss": log.losses[0] if log.losses else float("nan"),
              "checkpoints": store.writes}
    if args.verbose:
        print(f"[train] arch={cfg.name} steps={args.steps} "
              f"loss {result['first_loss']:.3f} -> {result['final_loss']:.3f} "
              f"restarts={log.restarts} wall={wall:.1f}s")
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--act-mode", default="tp", choices=["tp", "sp"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--block-skip", action="store_true")
    ap.add_argument("--naive-ce", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--sync-ckpt", action="store_true")
    ap.add_argument("--fail-at", type=int, nargs="*", default=None)
    ap.add_argument("--device", default="cuda")
    # the JAX launcher's flag, kept for its command lines: it is always on
    ap.add_argument("--verbose", action="store_true", default=True)
    return ap.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
