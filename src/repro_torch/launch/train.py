"""Training launcher: the fault-tolerant loop over the train step, on one
device or on a ``DeviceMesh`` (the JAX package's ``launch/train.py``, plus
``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 30 --batch 8 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 10 --batch 8 --seq 512 --compute-dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 10 --fail-at 5 --ckpt-every 2 --device cpu
  PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \\
      -m repro_torch.launch.train --arch qwen2-0.5b --reduced --mesh 2x2 \\
      --device cpu

Runs on the card unless ``--device cpu``; weights are random from
``--seed`` and held in float32 (so are AdamW's moments) whatever the
compute dtype, as in the JAX package.  The loop resumes from the newest
checkpoint in ``--ckpt-dir`` if there is one.

``--mesh dxm`` (or ``pxdxm``, with a leading 'pod' dim) trains on a
``DeviceMesh`` with dims ("data", "model") (or ("pod", "data",
"model")) over a process group that torchrun's environment describes
(``maybe_init_distributed``: NCCL on the card, each rank on
``cuda:$LOCAL_RANK``; gloo on the CPU).  Parameters, moments and batches are
DTensors laid out by ``distributed.specs``.  Under a process group even
``--mesh 1x1`` takes that path; without one, ``1x1`` is the one-device
path and any other mesh raises.  ``--act-mode`` picks the activations'
sharding at block boundaries.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import registry as cr
from repro_torch.data.pipeline import DataConfig, SyntheticLM, lay_out
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import specs as sp
from repro_torch.ft import driver as ftd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import registry as mr
from repro_torch.training import optimizer as opt
from repro_torch.training import step as tstep

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "ckpt"


def maybe_init_distributed(device: str, backend: str = None):
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``; the counterpart of the JAX launcher's
    ``JAX_COORDINATOR``).  Returns (the device this rank runs on, whether
    this call made the group).  The backend is NCCL for ``cuda`` and gloo
    for ``cpu`` unless ``backend`` names one; each rank runs on
    ``cuda:$LOCAL_RANK`` (modulo the cards there are under gloo, which lets
    ranks share a card).  Without that environment, or with a group already
    made, the device is ``device`` itself.  A failed init raises."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ \
            or dist.is_initialized():
        return device, False
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        n = torch.cuda.device_count()
        if backend == "nccl" and local >= n:
            raise RuntimeError(f"LOCAL_RANK {local}: NCCL needs a card a rank "
                               f"and this host has {n}")
        device = f"cuda:{local % n}"
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, init_method="env://")
    return device, True


def build_mesh(spec: str, device: str):
    """``spec`` 'dxm' (or 'pxdxm'): a ``DeviceMesh`` over the process group,
    whose size must equal the product; None for '1x1' without a process
    group (the one-device path).  Any other mesh without a process group
    raises."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) not in (2, 3):
        raise ValueError(f"--mesh {spec}: expected dxm or pxdxm")
    n = 1
    for d in dims:
        n *= d
    if not dist.is_initialized():
        if n == 1:
            return None
        raise ValueError(f"--mesh {spec} needs {n} ranks and there is no "
                         f"process group: launch it with torchrun "
                         f"(--nproc_per_node {n})")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"--mesh {spec} needs {n} ranks; the process group "
                         f"has {world}")
    dev_type = torch.device(device).type
    if len(dims) == 2:
        return make_host_mesh(*dims, device_type=dev_type)
    return make_host_mesh(dims[1], dims[2], pod=dims[0], device_type=dev_type)


def run(args) -> dict:
    device, owns_group = maybe_init_distributed(args.device)
    try:
        mesh = build_mesh(args.mesh, device)
        with sh.mesh_context(mesh, act_mode=args.act_mode,
                             remat=not args.no_remat):
            return _run(args, device, mesh)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args, device, mesh) -> dict:
    cfg = cr.reduced(args.arch) if args.reduced else cr.get_any(args.arch)
    cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype,
                              n_layers=args.n_layers or cfg.n_layers)
    model = mr.build(cfg, device=device, seed=args.seed)
    if mesh is not None:
        sh.distribute_module_(model, sp.params_specs(model), mesh)
    params = tstep.trainable_params(model)
    adamw = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                            total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed),
                       device=device)
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
        params, opt_state, metrics = step_fn(params, opt_state,
                                             lay_out(batch))
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
              "checkpoints": store.writes,
              "step_seconds": list(monitor.times)}
    if mesh is not None:
        result["mesh"] = dict(sh.mesh_extents(mesh))
        result["world"] = dist.get_world_size()
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if args.verbose and rank0:
        print(f"[train] arch={cfg.name} steps={args.steps} "
              f"loss {result['first_loss']:.3f} -> {result['final_loss']:.3f} "
              f"restarts={log.restarts} wall={wall:.1f}s")
    if args.result_json and rank0:
        with open(args.result_json, "w") as f:
            json.dump(result, f)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    # the config's depth cut to this many layers (its widths kept)
    ap.add_argument("--n-layers", type=int, default=None)
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
    ap.add_argument("--result-json", default=None,
                    help="rank 0 writes the result here")
    # the JAX launcher's flag, kept for its command lines: it is always on
    ap.add_argument("--verbose", action="store_true", default=True)
    return ap.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
