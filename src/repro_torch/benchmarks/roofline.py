"""Three-term roofline per (arch x shape x mesh) from the dry run's reports,
against the H100 SXM's datasheet (the JAX package's
``benchmarks/roofline.py``, which uses TPU v5e constants).

Reads ``artifacts/torch/dryrun_*.json`` (``launch/dryrun.py --json``; under
``$REPRO_ARTIFACTS/torch`` where that is set) and emits, per cell:
compute/memory/collective seconds (``dryrun.roofline_terms`` on the
per-device counts, at the peak of the cell's compute dtype), the dominant
term, MODEL_FLOPS = 6*N(active)*D, the model-vs-counted FLOP ratio (over
the global count) and a one-line bottleneck note; beside them the JAX
package's compute term, the global count over the devices
(``compute_s_global``).  Markdown goes to ``artifacts/torch/roofline.md``.

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from repro_torch.configs import registry as cr
from repro_torch.configs import shapes as shp
from repro_torch.core import calibrate
from repro_torch.core.devices.profiles import H100_SXM
from repro_torch.launch import dryrun

CHIPS = {"pod256": 256, "pod2x256": 512}


def emit(name: str, us_per_call: float, derived):
    """One CSV row: name,us_per_call,derived."""
    print(f"{name},{us_per_call:.3f},{derived}")


def model_flops(arch: str, shape: shp.ShapeCell, n_active: int = None
                ) -> float:
    """6·N·D (train), 2·N·D (prefill) or 2·N·B (decode) over ``arch``'s
    active parameters, or ``n_active`` (a reduced configuration's)."""
    n_active = n_active or cr.get(arch).active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token


def _note(dom: str, rep: dict) -> str:
    if dom == "compute":
        return "tensor-core-bound: raise per-card utilization (larger tiles / fewer remat recomputes)"
    if dom == "memory":
        return "HBM-bound: cut activation/state traffic (chunking, bf16 states, fusion)"
    return "link-bound: reduce or overlap collectives (schedule, compression, 2D sharding)"


def _shape(rep: dict) -> shp.ShapeCell:
    """The report's cell: a named one, or the custom cell its options
    give (``--batch``/``--seq``)."""
    if rep["shape"] in shp.SHAPES:
        return shp.SHAPES[rep["shape"]]
    o = rep["options"]
    return shp.ShapeCell(rep["shape"], o["seq"], o["batch"], o["kind"])


def analyze(reports, verbose=True):
    rows = []
    for rep in reports:
        if not rep.get("ok"):
            rows.append({"arch": rep["arch"], "shape": rep["shape"],
                         "mesh": rep["mesh"], "ok": False,
                         "error": rep.get("error", "")})
            continue
        chips = CHIPS.get(rep["mesh"]) or dryrun.mesh_devices(rep["mesh"])
        shape = _shape(rep)
        opts = rep.get("options", {})
        dtype = opts.get("compute_dtype", "bfloat16")
        terms = dryrun.roofline_terms(dryrun.CellReport(**rep), H100_SXM,
                                      dtype)
        dom, bound = terms["dominant"], terms["step_s_lower_bound"]
        mf = model_flops(rep["arch"], shape, opts.get("active_params"))
        counted = rep.get("jaxpr_flops_global", 0.0)
        ratio = mf / counted if counted else 0.0
        # roofline fraction: useful model flops vs what the dominant term
        # allows in the same wall time
        frac = (mf / chips / H100_SXM.peak(dtype)) / bound if bound else 0.0
        rows.append({"arch": rep["arch"], "shape": rep["shape"],
                     "mesh": rep["mesh"], "ok": True, "dtype": dtype,
                     "compute_s": terms["compute_s"],
                     "memory_s": terms["memory_s"],
                     "collective_s": terms["collective_s"], "dominant": dom,
                     "compute_s_global": counted / chips
                     / H100_SXM.peak(dtype),
                     "model_flops": mf, "flops_ratio": ratio,
                     "step_lower_bound_s": bound, "roofline_frac": frac,
                     "note": _note(dom, rep),
                     "mem_gib": (rep["memory"].get("argument_size_in_bytes", 0)
                                 + rep["memory"].get("temp_size_in_bytes", 0)) / 2 ** 30,
                     "options": opts})
    return rows


def to_markdown(rows) -> str:
    hdr = ("| arch | shape | mesh | dtype | compute_s | memory_s | "
           "collective_s | dominant | compute_s_global | 6ND/counted | "
           "roofline_frac | next lever |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if not r["ok"]:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"FAIL: {r['error'][:40]} | | | | | | | | |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['dtype']} | "
            f"{r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"{r['collective_s']:.3e} | **{r['dominant']}** | "
            f"{r['compute_s_global']:.3e} | {r['flops_ratio']:.2f} | {r['roofline_frac']:.2f} | {r['note']} |")
    return hdr + "\n".join(lines) + "\n"


def run(pattern=None, verbose=True, out_dir=None):
    """One table per dryrun_*.json variant (baseline / optimized / ...)."""
    out_dir = out_dir or calibrate.artifacts_dir()
    pattern = pattern or os.path.join(out_dir, "dryrun_*.json")
    all_rows = {}
    md_parts = []
    for path in sorted(glob.glob(pattern)):
        label = os.path.basename(path).replace("dryrun_", "").replace(".json", "")
        with open(path) as f:
            reports = json.load(f)
        seen = {}
        for r in reports:
            seen[(r["arch"], r["shape"], r["mesh"])] = r
        rows = analyze(list(seen.values()), verbose=verbose)
        all_rows[label] = rows
        ok_rows = [r for r in rows if r["ok"]]
        md_parts.append(f"## {label}\n\n" + to_markdown(rows))
        emit(f"roofline/{label}/cells_ok", 0.0, f"{len(ok_rows)}/{len(rows)}")
        for dom in ("compute", "memory", "collective"):
            n = sum(1 for r in ok_rows if r["dominant"] == dom)
            emit(f"roofline/{label}/{dom}_bound_cells", 0.0, str(n))
        if ok_rows:
            emit(f"roofline/{label}/median_frac", 0.0,
                 f"{np.median([r['roofline_frac'] for r in ok_rows]):.3f}")
            emit(f"roofline/{label}/best_frac", 0.0,
                 f"{max(r['roofline_frac'] for r in ok_rows):.3f}")
    if not all_rows:
        emit("roofline/cells_analyzed", 0.0,
             "0 (run launch.dryrun --all --json first)")
        return []
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "roofline.md"), "w") as f:
        f.write(chr(10).join(md_parts))
    # paired improvement summary (same cell present in two variants)
    labels = list(all_rows)
    if len(labels) >= 2:
        base = {(r["arch"], r["shape"], r["mesh"]): r
                for r in all_rows[labels[0]] if r["ok"]}
        opt = {(r["arch"], r["shape"], r["mesh"]): r
               for r in all_rows[labels[-1]] if r["ok"]}
        gains = []
        for k in base:
            if k in opt and base[k]["step_lower_bound_s"] > 0:
                gains.append(base[k]["step_lower_bound_s"]
                             / max(opt[k]["step_lower_bound_s"], 1e-12))
        if gains:
            emit("roofline/paired_median_speedup", 0.0,
                 f"{np.median(gains):.2f}x")
            emit("roofline/paired_max_speedup", 0.0, f"{max(gains):.1f}x")
        # per-cell best-of (the launcher picks the better config per cell)
        best_gains = [max(g, 1.0) for g in gains]
        if best_gains:
            emit("roofline/bestof_median_speedup", 0.0,
                 f"{np.median(best_gains):.2f}x")
            n_improved = sum(1 for g in gains if g > 1.05)
            emit("roofline/cells_improved_>5pct", 0.0,
                 f"{n_improved}/{len(gains)}")
            both = [k for k in base if k in opt]
            fracs = [max(base[k]["roofline_frac"], opt[k]["roofline_frac"])
                     for k in both]
            emit("roofline/bestof_median_frac", 0.0, f"{np.median(fracs):.3f}")
            emit("roofline/bestof_best_frac", 0.0, f"{max(fracs):.3f}")
    return [r for rows in all_rows.values() for r in rows]


if __name__ == "__main__":
    run()
