"""Multi-process runs for the port's distributed tests: ``spawn`` starts N
processes with torchrun's environment (a port taken from the OS, gloo on
the CPU), each runs one of the worker functions below and writes its JSON
result; a process that fails or outlives its timeout stops them all.

Run as ``python -m tests._torch_dist <function> <args.json> <out prefix>``
by ``spawn``; imports neither jax nor the JAX package.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def torchrun_env(rank: int, world: int, port: int) -> dict:
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))


def run_ranks(cmds, tmp_path, timeout: float):
    """Start one process a rank (``cmds[r]``, argv lists) with torchrun's
    environment; wait for all, killing every one at the first failure or at
    ``timeout`` seconds.  Returns each rank's stdout."""
    port = free_port()
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(len(cmds))]
    procs = [subprocess.Popen(cmd, env=torchrun_env(r, len(cmds), port),
                              cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True)
             for r, cmd in enumerate(cmds)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = bad[0] if bad else "timeout"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode]
            failed = bad[0] if bad else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for f in logs:
        f.seek(0)
        out.append(f.read())
        f.close()
    if failed is not None:
        which = 0 if failed == "timeout" else failed
        raise AssertionError(f"rank {which} failed ({failed}):\n"
                             f"{out[which][-4000:]}")
    return out


def spawn(n: int, fn: str, tmp_path, timeout: float = 150, **kwargs):
    """Run worker ``fn(**kwargs)`` in ``n`` gloo processes; returns each
    rank's result."""
    args = tmp_path / f"{fn}_args.json"
    args.write_text(json.dumps(kwargs))
    prefix = tmp_path / f"{fn}_out"
    cmd = [sys.executable, "-m", "tests._torch_dist", fn, str(args),
           str(prefix)]
    run_ranks([cmd] * n, tmp_path, timeout)
    return [json.loads(Path(f"{prefix}{r}.json").read_text())
            for r in range(n)]


# ---------------------------------------------------------------------------
# workers (each runs on every rank inside a gloo process group)
# ---------------------------------------------------------------------------

def _mesh(shape):
    from repro_torch.launch.mesh import make_host_mesh
    if len(shape) == 2:
        return make_host_mesh(*shape, device_type="cpu")
    return make_host_mesh(shape[1], shape[2], pod=shape[0],
                          device_type="cpu")


def load_params(npz_path: str) -> dict:
    """A JAX parameter tree saved flat ('/'-joined keys) -> nested numpy."""
    import numpy as np
    tree = {}
    with np.load(npz_path) as data:
        for key in data.files:
            node = tree
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = data[key]
    return tree


def train_losses(arch, n_layers, params_npz, mesh=None, steps=3, batch=8,
                 seq=32):
    """The port's train step on the reduced ``arch`` holding the JAX
    package's weights, ``steps`` steps of ``SyntheticLM`` (seed 0), one
    device or (``mesh``) DTensors laid out by ``specs``; the losses."""
    from repro_torch.configs import registry as cr
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, lay_out
    from repro_torch.distributed import sharding as sh, specs as sp
    from repro_torch.models import convert
    from repro_torch.training import optimizer as opt, step as tstep
    cfg = dataclasses.replace(cr.reduced(arch, n_layers=n_layers),
                              compute_dtype="float32")
    model = convert.from_jax_params(load_params(params_npz), cfg,
                                    device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0), device="cpu")
    m = _mesh(mesh) if mesh else None
    with sh.mesh_context(m):
        if m is not None:
            sh.distribute_module_(model, sp.params_specs(model), m)
        params = tstep.trainable_params(model)
        state = opt.init_opt_state(params)
        step = tstep.build_train_step(model, opt.AdamWConfig(lr=1e-3))
        losses = []
        for s in range(steps):
            params, state, metrics = step(params, state,
                                          lay_out(data.batch_at(s)))
            losses.append(float(metrics["loss"]))
        placed = {k: [str(p) for p in v.placements]
                  for k, v in params.items() if sh.is_sharded(v)}
    return {"losses": losses, "placements": placed}


def remat_grads_off_thread(arch, n_layers, mesh, batch=8, seq=32):
    """The reduced ``arch``'s loss gradients under per-block remat on
    ``mesh``, the backward once on this thread and once on another (as
    autograd runs a CUDA backward, on a device thread of its own, where
    the forward's mesh context is not set): the largest difference, or
    the other thread's error."""
    import threading
    import torch
    from repro_torch.configs import registry as cr
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, lay_out
    from repro_torch.distributed import sharding as sh, specs as sp
    from repro_torch.models import registry as mr
    from repro_torch.training import objective, step as tstep
    cfg = dataclasses.replace(cr.reduced(arch, n_layers=n_layers),
                              compute_dtype="float32")
    model = mr.build(cfg, device="cpu", seed=0)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0), device="cpu")
    m = _mesh(mesh)
    out = {}
    with sh.mesh_context(m):
        sh.distribute_module_(model, sp.params_specs(model), m)
        params = list(tstep.trainable_params(model).values())
        b = lay_out(data.batch_at(0))
        loss = lambda: objective.loss_fn(model, b, remat=True)[0]
        here = torch.autograd.grad(loss(), params)
        second = loss()

        def backward():
            try:
                out["grads"] = torch.autograd.grad(second, params)
            except Exception as e:   # reported to the test
                out["error"] = repr(e)

        t = threading.Thread(target=backward)
        t.start()
        t.join(120)
    if "grads" not in out:
        return {"error": out.get("error", "timeout")}
    return {"max_diff": max(float((sh.full(a) - sh.full(g)).abs().max())
                            for a, g in zip(here, out["grads"]))}


def psum(rows, stochastic=False):
    """``compressed_psum`` of row ``rank`` of ``rows`` over the world."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compression as comp
    x = torch.tensor(rows[dist.get_rank()], dtype=torch.float32)
    gen = torch.Generator().manual_seed(0) if stochastic else None
    y = comp.compressed_psum(x, dist.group.WORLD, generator=gen)
    return {"sum": y.tolist()}


def reshard(arch, n_layers, healthy, batch):
    """Reduced ``arch``'s weights on a 2x2 mesh, resharded onto the elastic
    plan for ``healthy`` ranks: whether every value is equal."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry as cr
    from repro_torch.distributed import sharding as sh, specs as sp
    from repro_torch.ft import elastic
    from repro_torch.models import registry as mr
    cfg = cr.reduced(arch, n_layers=n_layers)
    model = mr.build(cfg, device="cpu", seed=0)
    whole = {k: p.detach().clone() for k, p in model.named_parameters()}
    old = _mesh((2, 2))
    with sh.mesh_context(old):
        specs = sp.params_specs(model)
        tree = {k: sh.distribute(t, specs[k]) for k, t in whole.items()}
    plan = elastic.plan_elastic_mesh(healthy, model_degree=2,
                                     global_batch=batch)
    new = elastic.make_elastic_mesh(list(range(dist.get_world_size())),
                                    *plan, device_type="cpu")
    with sh.mesh_context(new):
        new_specs = sp.params_specs(model)
    moved = elastic.reshard(tree, new_specs, new)
    out = {"plan": list(plan), "in_mesh": elastic.in_mesh(new)}
    if out["in_mesh"]:
        out["equal"] = all(torch.equal(sh.full(moved[k]), whole[k])
                           for k in whole)
        out["placements"] = {k: [str(p) for p in moved[k].placements]
                             for k in ("embed.w", "blocks.0.attn.wq.w")}
        out["mesh"] = list(new.shape)
    return out


def decode(arch, n_layers, mesh, steps=4, batch=8, prompt=16, capacity=32):
    """Reduced ``arch`` (float32, seed 0): a prefill on every rank, then
    ``steps`` decode steps with the weights under ``params_specs(serve=
    True)`` and the caches under ``cache_specs`` on ``mesh``, against the
    same steps on one device; the largest error relative to the largest
    logit, and the caches' placements."""
    import torch
    from repro_torch.configs import registry as cr
    from repro_torch.distributed import sharding as sh, specs as sp
    from repro_torch.models import registry as mr
    cfg = dataclasses.replace(cr.reduced(arch, n_layers=n_layers),
                              compute_dtype="float32")
    model = mr.build(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    prompt_toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (steps, batch), generator=gen)
    m = _mesh(mesh)
    with torch.no_grad():
        _, cache = model.prefill(prompt_toks, max_len=capacity)
        one = cache.clone()
        want = [model.decode_step(toks[i], one)[0] for i in range(steps)]
        with sh.mesh_context(m):
            sh.distribute_module_(model, sp.params_specs(model, serve=True),
                                  m)
            specs = sp.cache_specs(cache, cfg)
            for field in ("k", "v"):
                getattr(cache, field)[:] = [
                    sh.distribute(t, s)
                    for t, s in zip(getattr(cache, field), specs[field])]
            got = []
            for i in range(steps):
                tok = sh.distribute(toks[i], sp.batch_spec((batch,)))
                logits, cache = model.decode_step(tok, cache)
                got.append(sh.full(logits))
    err = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    return {"err": err,
            "cache_placements": [str(p) for p in cache.k[0].placements],
            "pos": int(cache.pos)}


def prefill(arch, n_layers, mesh, batch=8, prompt=16, capacity=32):
    """Reduced ``arch`` (float32, seed 0): a prefill with the weights under
    ``params_specs(serve=True)`` and the tokens under ``batch_spec`` on
    ``mesh``, against the same prefill on one device; the largest error of
    the logits and of every layer's k and v caches, each relative to its
    largest value, and the caches' placements."""
    import torch
    from repro_torch.configs import registry as cr
    from repro_torch.distributed import sharding as sh, specs as sp
    from repro_torch.models import registry as mr
    cfg = dataclasses.replace(cr.reduced(arch, n_layers=n_layers),
                              compute_dtype="float32")
    model = mr.build(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen)
    m = _mesh(mesh)
    with torch.no_grad():
        want, want_cache = model.prefill(toks, max_len=capacity)
        with sh.mesh_context(m):
            sh.distribute_module_(model, sp.params_specs(model, serve=True),
                                  m)
            got, cache = model.prefill(
                sh.distribute(toks, sp.batch_spec((batch, prompt))),
                max_len=capacity)
            pairs = [(sh.full(got), want)] + [
                (sh.full(g), w) for field in ("k", "v")
                for g, w in zip(getattr(cache, field),
                                getattr(want_cache, field))]
    errs = [float((g - w).abs().max() / w.abs().max()) for g, w in pairs]
    return {"logits_err": errs[0], "cache_err": max(errs[1:]),
            "n_caches": len(errs) - 1,
            "cache_placements": [str(p) for p in cache.k[0].placements],
            "pos": int(cache.pos)}


def _main():
    import torch.distributed as dist
    fn, args, prefix = sys.argv[1:4]
    dist.init_process_group("gloo")
    try:
        res = globals()[fn](**json.loads(Path(args).read_text()))
        Path(f"{prefix}{dist.get_rank()}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
