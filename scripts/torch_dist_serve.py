"""One rank of the port's sharded serving path, against the same model
without a mesh: run under torchrun, one process.

    python3 -m torch.distributed.run --standalone --nproc_per_node 1 \\
        scripts/torch_dist_serve.py --record OUT/prefix --arch ARCH \\
        [--n-layers N] [--compute-dtype bfloat16] [--batch 8] \\
        [--prompt 64] [--steps 8] [--device cuda]

Builds ``ARCH`` from seed 0 at full width (``--n-layers`` cuts the depth)
and runs ``compare`` on a 1x1 ``DeviceMesh`` of the process group.
Writes ``<prefix><rank>.json``: ``compare``'s record and the run's
settings.  Exits non-zero on any failure.

``compare`` is also the worker of the CPU tests' sharded prefill and
decode on gloo meshes (``tests/_torch_dist.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import registry as cr  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import specs as sp  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import matmul as mk  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import registry as mr  # noqa: E402


def launches() -> dict:
    return {"flash_attention": fk.flash_attention_kernel.launches,
            "matmul": mk.matmul_kernel.launches,
            "flash_by_hd": dict(fk.flash_attention_kernel.launches_by_hd)}


def moved(before: dict) -> dict:
    now = launches()
    return {"flash_attention": now["flash_attention"]
            - before["flash_attention"],
            "matmul": now["matmul"] - before["matmul"],
            "flash_by_hd": {hd: n - before["flash_by_hd"].get(hd, 0)
                            for hd, n in now["flash_by_hd"].items()
                            if n - before["flash_by_hd"].get(hd, 0)}}


def cache_fields(cache):
    """(field, layer, tensor) of every decode-state tensor of ``cache``
    (``pos`` aside), in ``KVCache.tensors()``'s order."""
    return [(f, i, t) for f in ("k", "v", "h", "conv", "xk", "xv", "C",
                                "c", "n", "m")
            for i, t in enumerate(getattr(cache, f)) if t is not None]


def rel_max(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize()


def compare(model, cfg, mesh, *, batch, prompt, steps, capacity=None,
            relay_cache=False) -> dict:
    """Serve ``batch`` seeded prompts of ``prompt`` tokens (and a context,
    for a model that takes one) and ``steps`` decode steps with ``model``
    on its one device; then lay its weights out with the serving specs on
    ``mesh``, the prompts by ``batch_spec``, and run the same prefill and
    steps through the sharded path: the flash kernel on each rank's heads
    through ``local_map``, the caches seeded as DTensors, an MoE's routing
    and expert products on each rank's groups and experts.  The steps
    continue from the sharded prefill's cache, or (``relay_cache``) from
    the one-device prefill's with every cache tensor laid out by
    ``cache_specs``.

    Returns the largest error of the prefill's logits, of its cache
    tensors (attention, cross-attention and recurrent) and of each step's
    logits, each relative to the largest reference value; whether every
    logit is finite; the placements of the first cache tensor and the
    cache position at the end; the hand-kernel launches of each run (the
    flash kernel's by head dim too) and its seconds."""
    dev = next(model.parameters()).device
    capacity = capacity or prompt + steps
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                           device=dev)
    toks = torch.randint(0, cfg.vocab_size, (steps, batch), generator=gen,
                         device=dev)
    ctx = model.make_ctx(batch) if model.needs_ctx() else None
    rec = {}
    with torch.no_grad():
        before, t0 = launches(), time.perf_counter()
        logits, want_cache = model.prefill(tokens, ctx_embed=ctx,
                                           max_len=capacity)
        cache = want_cache.clone()
        want = [logits]
        for t in toks:
            logits, cache = model.decode_step(t, cache)
            want.append(logits)
        _sync(logits)
        rec["plain_launches"] = moved(before)
        rec["plain_s"] = time.perf_counter() - t0
        with sh.mesh_context(mesh):
            sh.distribute_module_(model, sp.params_specs(model, serve=True),
                                  mesh)
            lay = lambda t: t if t is None else sh.distribute(
                t, sp.batch_spec(tuple(t.shape)))
            before, t0 = launches(), time.perf_counter()
            logits, cache = model.prefill(lay(tokens), ctx_embed=lay(ctx),
                                          max_len=capacity)
            got = [sh.full(logits)]
            cache_errs = [rel_max(sh.full(g), w) for (_, _, g), (_, _, w)
                          in zip(cache_fields(cache),
                                 cache_fields(want_cache))]
            if relay_cache:
                specs = sp.cache_specs(want_cache, cfg)
                for field, i, t in cache_fields(want_cache):
                    getattr(want_cache, field)[i] = sh.distribute(
                        t, specs[field][i])
                cache = want_cache
            for t in toks:
                logits, cache = model.decode_step(lay(t), cache)
                got.append(sh.full(logits))
            _sync(got[-1])
            rec["mesh_launches"] = moved(before)
            rec["mesh_s"] = time.perf_counter() - t0
    errs = [rel_max(g, w) for g, w in zip(got, want)]
    first = cache_fields(cache)[0][2]
    rec.update(prefill_err=errs[0], step_errs=errs[1:],
               cache_err=max(cache_errs), n_caches=len(cache_errs),
               finite=all(bool(torch.isfinite(g).all()) for g in got),
               cache_placements=[str(p) for p in first.placements],
               pos=int(cache.pos))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--record", required=True)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device, owns = train.maybe_init_distributed(args.device)
    try:
        cfg = cr.get(args.arch)
        if args.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
        model = mr.build(cfg, device=device,
                         dtype=getattr(torch, args.compute_dtype), seed=0)
        mesh = train.build_mesh("1x1", device)
        rec = compare(model, cfg, mesh, batch=args.batch,
                      prompt=args.prompt, steps=args.steps)
        rec.update(rank=dist.get_rank(), world=dist.get_world_size(),
                   backend=dist.get_backend(), device=device, arch=cfg.name,
                   n_layers=cfg.n_layers, dtype=args.compute_dtype,
                   mesh=list(mesh.shape), batch=args.batch,
                   prompt=args.prompt, steps=args.steps)
        Path(f"{args.record}{rec['rank']}.json").write_text(json.dumps(rec))
    finally:
        if owns:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
