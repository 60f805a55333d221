"""Counts of the dry run (``repro_torch.launch.dryrun``) that its command
line does not report, each in a process of its own (a fake process group
is process-wide): run by ``tests/test_torch_dryrun_kinds.py`` as

    python tests/_torch_meta_count.py '<json>'

with ``{"what": "experts", "arch", "n_layers", "batch", "seq", "kind",
"mesh", "dispatch"}``: the flops of the MoE expert products (``moe._experts``)
per device on the fake mesh and globally, summed over the layers; or
``{"what": "scan", "n_layers", "batch", "seq", "kind", "full"}``: the
xLSTM cell's reports (reduced xlstm-1.3b, its layers alternating mLSTM and
sLSTM) on a fake 2x4 mesh and without one, with ``full`` every loop run
whole (``jaxpr_cost.scan``, the hook the counter installs, replaced by one
that runs every trip), and the (trips, iterations run) of the loops.
Prints one JSON object."""
import contextlib
import dataclasses
import json
import logging
import os
import sys

from repro_torch.configs import base as C
from repro_torch.configs import registry as cr
from repro_torch.configs import shapes as shp
from repro_torch.core import jaxpr_cost
from repro_torch.launch import dryrun
from repro_torch.models import moe

MESH_NAMES = ("data", "model")
REPORT = ("ok", "error", "flops_per_device", "bytes_per_device",
          "collectives", "collective_operands", "ici_bytes",
          "jaxpr_flops_global", "jaxpr_bytes_global",
          "jaxpr_bytes_prefusion_global", "jaxpr_transcendentals_global",
          "kernel_calls", "kernel_calls_per_device", "launches")


def _mesh(spec):
    return (tuple(int(x) for x in spec.split("x")), MESH_NAMES)


def experts(a):
    """{"device": per-device expert flops, "global": global ones}."""
    flops = {"device": 0.0, "global": 0.0}
    where = ["global"]
    inner = moe._experts

    def counted(p, xe, act):
        with jaxpr_cost.CostCounter() as c:
            out = inner(p, xe, act)
        flops[where[0]] += c.product_flops()
        return out
    moe._experts = counted
    os.environ["REPRO_MOE_DISPATCH"] = a["dispatch"]
    cfg = cr.reduced(a["arch"], n_layers=a["n_layers"])
    cell = shp.ShapeCell("cell", a["seq"], a["batch"], a["kind"])
    orig = dryrun._count

    def count(cfg_, arch, shape, opts, mesh=None):
        where[0] = "global" if mesh is None else "device"
        return orig(cfg_, arch, shape, opts, mesh)
    dryrun._count = count
    rep = dryrun.lower_cell(a["arch"], cell.name, cfg=cfg, shape=cell,
                            mesh_shape=_mesh(a["mesh"]), verbose=False)
    return {"ok": rep.ok, "error": rep.error, **flops,
            "experts": cfg.moe.num_experts}


def scan(a):
    """The reports on the fake 2x4 mesh and without one, and under
    ``"loops"`` each loop's (trips, iterations run), by mesh."""
    inner = (lambda trips, probe: contextlib.nullcontext(trips)) \
        if a["full"] else jaxpr_cost.scan
    loops = []

    @contextlib.contextmanager
    def recorded(trips, probe):
        with inner(trips, probe) as n:
            loops.append((trips, n))
            yield n
    jaxpr_cost.scan = recorded
    cfg = dataclasses.replace(cr.reduced("xlstm-1.3b", n_layers=a["n_layers"]),
                              block_pattern=(C.MLSTM, C.SLSTM))
    cell = shp.ShapeCell("cell", a["seq"], a["batch"], a["kind"])
    out = {"loops": {}}
    for mesh in ("2x4", None):
        loops.clear()
        rep = dryrun.lower_cell("xlstm-1.3b", cell.name, cfg=cfg, shape=cell,
                                mesh_shape=mesh and _mesh(mesh),
                                verbose=False)
        out[mesh or "none"] = {k: getattr(rep, k) for k in REPORT}
        out["loops"][mesh or "none"] = sorted(set(loops))
    return out


if __name__ == "__main__":
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    args = json.loads(sys.argv[1])
    print(json.dumps({"experts": experts, "scan": scan}[args["what"]](args)))
