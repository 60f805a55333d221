"""Dry run: every (architecture x input-shape x mesh) cell traced on meta
tensors, with its per-device flops, bytes, collectives and memory (the
JAX package's ``launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --reduced --n-layers 2 --batch 8 --seq 128 --mesh 8x1 2x4 --json d.json

The JAX package lowers and compiles each cell for 256 or 512 fake XLA
devices and reads XLA's output.  The port has no compiler output to
read.  It runs the cell's real step (the train step with its backward and
AdamW, a prefill, or one decode step) on ``meta`` tensors, which hold
shapes and no data, and counts what is dispatched:

  - globally, on plain meta tensors: ``core/jaxpr_cost.py`` in place of
    the jaxpr walk (the ``jaxpr_*`` fields);
  - per device, on meta DTensors over the production ``DeviceMesh`` of a
    fake process group (``launch/mesh.fake_mesh``; this process is rank 0
    and no other rank exists): the flops and bytes of each rank's local
    shards in place of ``cost_analysis()``, the functional collectives in
    place of the optimized HLO's (``core/hlo.py``), and the arguments'
    and outputs' local bytes in place of ``memory_analysis()`` (no
    temporary peak: nothing tracks it).

The mesh is the production one (``--multi-pod``, ``--both-meshes``), or
the fake meshes ``--mesh`` names; ``--device-mesh none`` runs no mesh: the
per-device fields are the global count and there are no collectives.
``compile_s`` holds the seconds of the traces.  The run needs no card,
and importing this module starts no process group.  The hand kernels take
their meta path (``kernels/priced.py``): each call is priced, nothing is
launched, and each report carries the wrappers' launch counters' moves
during its cell (``launches``, all 0).

``--mlstm-chunk``, ``--mlstm-state-dtype``, ``--kv-block`` and
``REPRO_DECODE_WRITE`` have no counterpart in the port and raise.
Reports go to ``--json`` (default ``artifacts/torch/dryrun_default.json``,
or under ``$REPRO_ARTIFACTS/torch``), which ``benchmarks/roofline.py``
reads.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import sys
import time
from typing import Optional

import torch

from repro_torch.configs import registry as cr
from repro_torch.configs import shapes as shp
from repro_torch.core import calibrate
from repro_torch.core import hlo
from repro_torch.core.devices.profiles import H100_SXM, DeviceProfile
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import specs as sp
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import flash_attention_bwd as fkb
from repro_torch.kernels import matmul as mk
from repro_torch.launch import mesh as lm
from repro_torch.models import registry as mr
from repro_torch.training import optimizer as opt
from repro_torch.training import step as tstep

MISSING_KNOBS = ("mlstm_chunk", "mlstm_state_dtype", "kv_block")


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(arch: str, shape: shp.ShapeCell, *,
                cache_dtype=torch.bfloat16, param_dtype=None, cfg=None,
                mesh=None, serve: bool = False) -> dict:
    """Meta stand-ins for every input of the cell's step, with the model
    that holds the parameters (``"model"``).  ``cfg``: the configuration
    (default ``arch``'s); ``mesh``: lay the inputs out on it as DTensors
    by ``distributed/specs.py`` (call under its ``sh.mesh_context``);
    ``serve``: the serving parameter specs (no data-parallel dims)."""
    cfg = cfg or cr.get(arch)
    model = mr.build(cfg, device="meta", dtype=param_dtype)
    if mesh is not None:
        sh.distribute_module_(model, sp.params_specs(model, serve=serve),
                              mesh)
    B, S = shape.global_batch, shape.seq_len
    lay = (lambda t: sh.distribute(t, sp.batch_spec(tuple(t.shape)))) \
        if mesh is not None else (lambda t: t)
    ctx = None
    if model.needs_ctx():
        ctx = _meta((B, model.ctx_len(), cfg.d_model),
                    getattr(torch, cfg.compute_dtype))
    if shape.kind == "train":
        params = tstep.trainable_params(model)
        batch = {"tokens": lay(_meta((B, S), torch.int64)),
                 "labels": lay(_meta((B, S), torch.int64))}
        if ctx is not None:
            batch["ctx"] = lay(ctx)
        return {"model": model, "params": params,
                "opt_state": opt.init_opt_state(params), "batch": batch}
    params = dict(model.named_parameters())
    if shape.kind == "prefill":
        d = {"model": model, "params": params,
             "tokens": lay(_meta((B, S), torch.int64))}
        if ctx is not None:
            d["ctx"] = lay(ctx)
        return d
    # decode: one new token against a cache of seq_len
    cache = model.init_cache(B, S, dtype=cache_dtype)
    if mesh is not None:
        specs = sp.cache_specs(cache, cfg)
        for field, fspecs in specs.items():
            if field == "pos":
                continue
            getattr(cache, field)[:] = [
                None if t is None else sh.distribute(t, s)
                for t, s in zip(getattr(cache, field), fspecs)]
    return {"model": model, "params": params,
            "token": lay(_meta((B,), torch.int64)), "cache": cache}


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    ok: bool
    error: str = ""
    compile_s: float = 0.0
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    jaxpr_flops_global: float = 0.0
    jaxpr_bytes_global: float = 0.0
    jaxpr_bytes_prefusion_global: float = 0.0
    jaxpr_transcendentals_global: float = 0.0
    ici_bytes: float = 0.0
    collective_operand_bytes: float = 0.0
    memory: dict = dataclasses.field(default_factory=dict)
    n_params: int = 0
    options: dict = dataclasses.field(default_factory=dict)
    # hand-kernel calls of the global count and of one device
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    kernel_calls_per_device: dict = dataclasses.field(default_factory=dict)
    # per collective kind: {"dtype[shape]" of the local operand: count}
    collective_operands: dict = dataclasses.field(default_factory=dict)
    # the hand kernels' launch counters' moves during the cell
    launches: dict = dataclasses.field(default_factory=dict)

    def row(self) -> str:
        if not self.ok:
            return f"{self.arch:26s} {self.shape:12s} {self.mesh:9s} FAIL {self.error[:90]}"
        mem = self.memory.get("argument_size_in_bytes", 0) + self.memory.get(
            "temp_size_in_bytes", 0)
        chips = mesh_devices(self.mesh)
        return (f"{self.arch:26s} {self.shape:12s} {self.mesh:9s} ok "
                f"compile={self.compile_s:6.1f}s flops/dev={self.jaxpr_flops_global/chips:.3e} "
                f"bytes/dev={self.jaxpr_bytes_global/chips:.3e} ici/dev={self.ici_bytes:.3e} "
                f"mem/dev={mem/2**30:.2f}GiB")


def mesh_name(shape) -> str:
    """'pod256' / 'pod2x256' for the production meshes, 'none' without a
    mesh, else the extents joined by 'x'."""
    if shape is None:
        return "none"
    if tuple(shape) == lm.production_mesh_shape()[0]:
        return "pod256"
    if tuple(shape) == lm.production_mesh_shape(multi_pod=True)[0]:
        return "pod2x256"
    return "x".join(map(str, shape))


def mesh_devices(name: str) -> int:
    """Devices of the mesh named ``name`` (``mesh_name``'s)."""
    if name == "none":
        return 1
    if name in ("pod256", "pod2x256"):
        return 512 if name == "pod2x256" else 256
    return math.prod(int(x) for x in name.split("x"))


def parse_mesh(spec: str):
    """'dxm' or 'pxdxm' -> (shape, dim names)."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 2:
        return dims, ("data", "model")
    if len(dims) == 3:
        return dims, ("pod", "data", "model")
    raise ValueError(f"--mesh {spec}: expected dxm or pxdxm")


def _run_step(spec: dict, shape: shp.ShapeCell, opts: dict):
    """(arguments, outputs) of one run of the cell's step."""
    model = spec["model"]
    if shape.kind == "train":
        step_fn = tstep.build_train_step(
            model, opt.AdamWConfig(), num_microbatches=opts["num_microbatches"],
            block_skip=opts["block_skip"], fused_ce=opts["fused_ce"],
            remat=opts["remat"])
        args = (spec["params"], spec["opt_state"], spec["batch"])
        return args, step_fn(*args)
    if shape.kind == "prefill":
        args = (spec["params"], spec["tokens"], spec.get("ctx"))
        with torch.no_grad():
            logits, cache = model.prefill(spec["tokens"],
                                          ctx_embed=spec.get("ctx"),
                                          max_len=shape.seq_len + 64)
        return args, (logits, cache.tensors())
    cache = spec["cache"]
    args = (spec["params"], spec["token"], cache.tensors())
    with torch.no_grad():
        logits, cache = model.decode_step(spec["token"], cache)
    return args, (logits, cache.tensors())


def _count(cfg, arch, shape, opts, mesh=None):
    """The step run once under the counter: (``hlo.CollectiveCounter``,
    memory summary)."""
    is_serve = shape.kind in ("prefill", "decode")
    serve = opts["serve_opt"] and is_serve
    spec = input_specs(arch, shape, cfg=cfg, mesh=mesh, serve=serve,
                       param_dtype=torch.bfloat16 if serve else None)
    with hlo.CollectiveCounter() as counter:
        args, outs = _run_step(spec, shape, opts)
    return counter, hlo.memory_summary(args, outs)


def wrapper_launches() -> dict:
    """The hand kernels' wrappers' launch counters."""
    return {"matmul": mk.matmul_kernel.launches,
            "flash_attention": fk.flash_attention_kernel.launches,
            "flash_attention_bwd":
                fkb.flash_attention_bwd_kernel.launches}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               act_mode: str = "tp", block_skip: bool = False,
               num_microbatches: int = 1, remat: bool = True,
               fused_ce: bool = True, moe_dispatch: str = None,
               moe_tokens_per_group: int = None, mlstm_chunk: int = None,
               mlstm_state_dtype: str = None,
               kv_block: int = None, serve_opt: bool = False,
               verbose: bool = True, cfg=None,
               shape: Optional[shp.ShapeCell] = None,
               mesh_shape="production") -> CellReport:
    """One cell.  ``cfg`` overrides ``arch``'s configuration (a reduced
    one, another compute dtype); ``shape`` a cell not in ``shapes.SHAPES``;
    ``mesh_shape``: "production" (``multi_pod`` picks which), None for no
    mesh, or (shape, dim names) of a fake mesh."""
    for knob, value in zip(MISSING_KNOBS,
                           (mlstm_chunk, mlstm_state_dtype, kv_block)):
        if value:
            raise NotImplementedError(
                f"dryrun: {knob} has no counterpart in the port "
                f"(ROADMAP.md Queue 1)")
    if os.environ.get("REPRO_DECODE_WRITE"):
        raise NotImplementedError("dryrun: REPRO_DECODE_WRITE has no "
                                  "counterpart in the port (ROADMAP.md "
                                  "Queue 1)")
    shape = shape or shp.SHAPES[shape_name]
    if mesh_shape == "production":
        mesh_shape = lm.production_mesh_shape(multi_pod=multi_pod)
    cfg = cfg or cr.get(arch)
    rep = CellReport(arch=arch, shape=shape.name,
                     mesh=mesh_name(mesh_shape and mesh_shape[0]), ok=False,
                     options={"act_mode": act_mode, "block_skip": block_skip,
                              "num_microbatches": num_microbatches,
                              "remat": remat, "fused_ce": fused_ce,
                              "moe_dispatch": moe_dispatch,
                              "kv_block": kv_block, "serve_opt": serve_opt,
                              "compute_dtype": cfg.compute_dtype,
                              "batch": shape.global_batch,
                              "seq": shape.seq_len, "kind": shape.kind,
                              "active_params": cfg.active_param_count()})
    if moe_dispatch:
        os.environ["REPRO_MOE_DISPATCH"] = moe_dispatch
    if moe_tokens_per_group:
        os.environ["REPRO_MOE_TOKENS_PER_GROUP"] = str(moe_tokens_per_group)
        rep.options["moe_tokens_per_group"] = moe_tokens_per_group
    rep.n_params = cfg.param_count()
    opts = dict(rep.options)
    launched = wrapper_launches()
    t0 = time.perf_counter()
    try:
        with sh.mesh_context(None):
            glob, memory = _count(cfg, arch, shape, opts)
        dev = glob
        if mesh_shape is not None:
            with lm.fake_mesh(*mesh_shape) as mesh, \
                    sh.mesh_context(mesh, act_mode=act_mode, remat=remat):
                dev, memory = _count(cfg, arch, shape, opts, mesh)
        rep.compile_s = time.perf_counter() - t0
        cs = hlo.cost_summary(dev)
        rep.flops_per_device = cs["flops"]
        rep.bytes_per_device = cs["bytes"]
        jc = glob.cost.as_dict()
        rep.jaxpr_flops_global = jc["flops"]
        rep.jaxpr_bytes_global = jc["bytes"]
        rep.jaxpr_bytes_prefusion_global = jc["bytes_prefusion"]
        rep.jaxpr_transcendentals_global = jc["transcendentals"]
        stats = dev.stats
        rep.collectives = {k: v for k, v in stats.by_kind.items() if v[0]}
        rep.collective_operands = {k: dict(sorted(v.items()))
                                   for k, v in dev.operands.items() if v}
        rep.ici_bytes = float(stats.total_ici_bytes)
        rep.collective_operand_bytes = float(stats.total_operand_bytes)
        rep.memory = memory
        rep.kernel_calls = dict(glob.kernel_calls)
        rep.kernel_calls_per_device = dict(dev.kernel_calls)
        rep.ok = True
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rep.error = f"{type(e).__name__}: {e}"
        rep.compile_s = time.perf_counter() - t0
    rep.launches = {k: n - launched[k]
                    for k, n in wrapper_launches().items()}
    if verbose:
        print(rep.row(), flush=True)
    return rep


def roofline_terms(rep: CellReport, device: DeviceProfile = H100_SXM,
                   dtype: str = "bfloat16") -> dict:
    """Three roofline terms (seconds) from a dry-run report (per device):
    flops over ``device``'s peak in ``dtype``, bytes over its memory
    bandwidth, ICI bytes over its link bandwidth."""
    compute_s = rep.flops_per_device / device.peak(dtype)
    memory_s = rep.bytes_per_device / device.hbm_bw
    collective_s = rep.ici_bytes / device.link_bw
    dom = max((("compute", compute_s), ("memory", memory_s),
               ("collective", collective_s)), key=lambda kv: kv[1])
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dom[0],
            "step_s_lower_bound": max(compute_s, memory_s, collective_s)}


def _cells(args):
    """[(arch, cfg, ShapeCell)] from the arguments."""
    if args.all:
        return [(a, None, s) for a, s in shp.cells(cr.ARCH_NAMES)]
    if not args.arch:
        raise SystemExit("dryrun: --arch and --shape (or --all)")
    cfg = cr.reduced(args.arch, n_layers=args.n_layers) if args.reduced \
        else cr.get(args.arch)
    if args.batch or args.seq:
        if not (args.batch and args.seq):
            raise SystemExit("dryrun: --batch and --seq go together")
        cells = [shp.ShapeCell(f"{kind}_{args.batch}x{args.seq}", args.seq,
                               args.batch, kind) for kind in args.kind]
    elif args.shape:
        cells = [shp.SHAPES[s] for s in args.shape]
    else:
        raise SystemExit("dryrun: --shape (or --batch and --seq)")
    dtypes = args.compute_dtype or [cfg.compute_dtype]
    return [(args.arch, dataclasses.replace(cfg, compute_dtype=dt), s)
            for dt in dtypes for s in cells]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", nargs="+", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--device-mesh", default="fake", choices=["fake", "none"],
                    help="none: the unsharded count only")
    ap.add_argument("--mesh", nargs="+", default=None,
                    help="fake meshes dxm / pxdxm in place of the "
                         "production one")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--kind", nargs="+", default=["train"],
                    choices=["train", "prefill", "decode"],
                    help="the steps of a --batch/--seq cell")
    ap.add_argument("--compute-dtype", nargs="+", default=None)
    ap.add_argument("--act-mode", default="tp", choices=["tp", "sp"])
    ap.add_argument("--block-skip", action="store_true")
    ap.add_argument("--num-microbatches", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--naive-ce", action="store_true")
    ap.add_argument("--moe-dispatch", default=None, choices=[None, "einsum", "gather"])
    ap.add_argument("--moe-tokens-per-group", type=int, default=None)
    ap.add_argument("--mlstm-chunk", type=int, default=None)
    ap.add_argument("--mlstm-state-dtype", default=None)
    ap.add_argument("--kv-block", type=int, default=None)
    ap.add_argument("--serve-opt", action="store_true",
                    help="bf16 weights, no FSDP regather for prefill/decode")
    ap.add_argument("--json", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # DTensor warns on every multi-dim redistribution of the step: the
    # counts carry them, the log need not
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    if args.device_mesh == "none":
        meshes = [None]
    elif args.mesh:
        meshes = [parse_mesh(m) for m in args.mesh]
    elif args.both_meshes:
        meshes = [lm.production_mesh_shape(multi_pod=mp)
                  for mp in (False, True)]
    else:
        meshes = [lm.production_mesh_shape(multi_pod=args.multi_pod)]
    reports = []
    for arch, cfg, cell in _cells(args):
        for mesh_shape in meshes:
            reports.append(lower_cell(
                arch, cell.name, act_mode=args.act_mode,
                block_skip=args.block_skip,
                num_microbatches=args.num_microbatches,
                remat=not args.no_remat, fused_ce=not args.naive_ce,
                moe_dispatch=args.moe_dispatch,
                moe_tokens_per_group=args.moe_tokens_per_group,
                mlstm_chunk=args.mlstm_chunk,
                mlstm_state_dtype=args.mlstm_state_dtype,
                kv_block=args.kv_block, serve_opt=args.serve_opt,
                cfg=cfg, shape=cell, mesh_shape=mesh_shape))

    n_fail = sum(1 for r in reports if not r.ok)
    print(f"\n{len(reports) - n_fail}/{len(reports)} cells traced")
    path = args.json or os.path.join(calibrate.artifacts_dir(),
                                     "dryrun_default.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump([dataclasses.asdict(r) for r in reports], f, indent=1)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
