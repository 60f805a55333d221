"""The paper's tables and figures, one module a table or figure (the JAX
package's ``benchmarks/run.py``).  Prints ``name,us_per_call,derived`` CSV
rows with a banner before each section; ``--fast`` shrinks the samples
and runs the sweeps at their ``--dry-run`` sizes, with their self-checks.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast]
        [--only table6,nas,...] [--device cuda]

``--only`` takes any of ``DRIVERS``.  Every driver reads the device's
store (``common.get_calibration``; calibrated first where there is none)
and writes under ``artifacts/torch/``.  ``--device cpu`` runs them on the
host (a host store, the hand kernels' plain versions).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks import common
from repro_torch.core.device import resolve

DRIVERS = ("fig3", "table2", "table4", "table6", "nas", "partition",
           "roofline", "fleet", "strategy", "serving", "parallel",
           "overlap", "comm")


def _banner(s: str):
    print(f"# === {s} ===", flush=True)


def run(only=None, *, fast=False, device="cuda") -> dict:
    """{driver: its result} for each driver of ``only`` (default all)."""
    from repro_torch.benchmarks import (comm_validation, fig3_throughput_vs_k,
                                        fleet_compare, nas_speed,
                                        overlap_scaling, parallel_scaling,
                                        partition_app, roofline,
                                        serving_sweep, strategy_sweep,
                                        table2_per_layer, table4_model_wise,
                                        table6_custom_kernels)
    want = set(only) if only else set(DRIVERS)
    unknown = want - set(DRIVERS)
    if unknown:
        raise SystemExit(f"run: unknown drivers {sorted(unknown)}; "
                         f"choose from {DRIVERS}")
    dev = resolve(device)
    store = common.get_calibration(dev) if want - {"roofline", "comm"} \
        else None
    neusight = lambda dts: common.neusight_by_dtype(store, dts, device=dev)
    out = {}
    t0 = time.time()
    if "fig3" in want:
        _banner("Fig 3/4: duration & throughput vs K (rational trend)")
        out["fig3"] = {dt: fig3_throughput_vs_k.run(store, dt)
                       for dt in ("float32", "bfloat16")}
    if "table2" in want:
        _banner("Table II: per-layer error, PM2Lat vs NeuSight vs FLOPs-proxy")
        out["table2"] = table2_per_layer.run(
            store, neusight(table2_per_layer.DTYPES),
            samples_per_layer=5 if fast else 10, device=dev)
    if "table4" in want:
        _banner("Table IV/V: model-wise error")
        out["table4"] = table4_model_wise.run(
            store, neusight(table4_model_wise.DTYPES),
            models=("gpt2-mini", "qwen3-mini") if fast
            else table4_model_wise.MODELS,
            batches=(1, 4) if fast else (1, 4, 8), device=dev)
    if "table6" in want:
        _banner("Table VI: custom (hand CUDA) kernels")
        out["table6"] = table6_custom_kernels.run(
            store, samples=3 if fast else 6, device=dev)
    if "nas" in want:
        _banner("NAS preprocessing speed (paper IV-D2)")
        out["nas"] = nas_speed.run(store, limit=200_000 if fast
                                   else 1_000_000, device=dev)
    if "partition" in want:
        _banner("Pipeline partition app (paper IV-D1)")
        out["partition"] = partition_app.run(
            store, neusight(("float32",))["float32"],
            seq=64 if fast else 128, device=dev)
    if "roofline" in want:
        _banner("Roofline (dry-run artifacts)")
        out["roofline"] = roofline.run()
    if "fleet" in want:
        _banner("Fleet comparison")
        out["fleet"] = fleet_compare.run(
            store, archs=["qwen3-mini"] if fast else None, device=dev)
    sweeps = (("strategy", strategy_sweep), ("serving", serving_sweep),
              ("parallel", parallel_scaling), ("overlap", overlap_scaling))
    for name, mod in sweeps:
        if name in want:
            _banner(f"{mod.__name__.rsplit('.', 1)[-1]}")
            out[name] = (mod.dry_run(store, torch_device=dev) if fast
                         else mod.run(store, torch_device=dev))
    if "comm" in want:
        _banner("Comm / cache validation")
        out["comm"] = comm_validation.run(dry=fast, device=dev)
    common.emit("benchmarks/total_wall_s", 0.0, f"{time.time()-t0:.1f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of " + ",".join(DRIVERS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    run(args.only.split(",") if args.only else None, fast=args.fast,
        device=args.device)


if __name__ == "__main__":
    main()
