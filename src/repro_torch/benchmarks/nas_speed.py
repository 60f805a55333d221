"""NAS preprocessing speed (paper §IV-D2): µs a prediction for the
vectorized batch engine, the matmul search grid (kernel-selection oracle +
Eq. (1)/(2)) and the full-model grid path (``predict_model_grid``), against
the NeuSight MLP, with the extrapolated wall time of the paper's whole
400M-config matmul grid.  The JAX package's ``benchmarks/nas_speed.py`` on
the device's store.

    PYTHONPATH=src python -m repro_torch.benchmarks.nas_speed [--limit N]
        [--skip-neusight] [--skip-model-grid] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks import common
from repro_torch.configs import registry as cr
from repro_torch.core import opgraph as og
from repro_torch.core.batch_predict import BatchPredictor
from repro_torch.core.device import resolve
from repro_torch.core.nas import NASGrid, precompute_cache

MODEL_GRID_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)
MODEL_GRID_SEQS = (64, 128, 256, 512, 1024)


def run(store=None, *, limit=1_000_000, include_neusight=True,
        include_model_grid=True, device="cuda", neusight_path=None,
        verbose=True) -> dict:
    """The JAX package's record; ``cache`` holds the matmul grid's
    predictions and ``model_grid`` the full-model grid (seconds).
    ``neusight_path``: the float32 NeuSight model to time (default
    ``common.neusight_path``, trained there if it is missing)."""
    dev = resolve(device)
    store = store or common.get_calibration(dev)
    name = store.meta["device"]
    grid = NASGrid()
    bp = BatchPredictor(store, name)

    cache, _, us_per, n = precompute_cache(store, name, grid=grid,
                                           limit=limit, predictor=bp)
    common.emit("nas/pm2lat_us_per_prediction", us_per, f"{us_per:.4f}")
    common.emit("nas/n_predictions", 0.0, str(n))
    common.emit("nas/pm2lat_full_grid_hours", 0.0,
                f"{grid.n_configs * us_per / 1e6 / 3600:.2f}")
    common.emit("nas/grid_size", 0.0, str(grid.n_configs))
    out = {"pm2lat_us": us_per, "n_sampled": n, "cache": cache}

    if include_model_grid:
        cfg = cr.get_any("qwen3-mini")
        # the first call enumerates and caches the memory ops' features;
        # the timed second call is the steady sweep a NAS loop would see
        bp.predict_model_grid(cfg, MODEL_GRID_BATCHES, MODEL_GRID_SEQS)
        t0 = time.perf_counter()
        mg = bp.predict_model_grid(cfg, MODEL_GRID_BATCHES, MODEL_GRID_SEQS)
        mg_s = time.perf_counter() - t0
        n_matmul_ops = sum(1 for o in og.enumerate_ops(cfg, 1, 64)
                           if o.kind in ("matmul", "bmm"))
        us_model = mg_s / mg.size * 1e6
        common.emit("nas/model_grid_us_per_model", us_model,
                    f"{us_model:.2f}")
        common.emit("nas/model_grid_models", 0.0, str(mg.size))
        common.emit("nas/model_grid_matmul_configs", 0.0,
                    str(mg.size * n_matmul_ops))
        out.update({"model_grid_us_per_model": us_model,
                    "model_grid_models": int(mg.size), "model_grid": mg})

    if include_neusight:
        ns = common.get_neusight(store, dtype="float32", device=dev,
                                 path=neusight_path)
        reps = 200
        t0 = time.perf_counter()
        for i in range(reps):
            ns.predict_matmul(512 + i, 512, 512)
        ns_us = (time.perf_counter() - t0) / reps * 1e6
        common.emit("nas/neusight_us_per_prediction", ns_us, f"{ns_us:.1f}")
        common.emit("nas/neusight_full_grid_hours", 0.0,
                    f"{grid.n_configs * ns_us / 1e6 / 3600:.1f}")
        common.emit("nas/speedup", 0.0, f"{ns_us / us_per:.0f}x")
        out["neusight_us"] = ns_us
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--limit", type=int, default=1_000_000,
                    help="max sampled matmul configs from the NAS grid")
    ap.add_argument("--skip-neusight", action="store_true",
                    help="skip training/timing the NeuSight baseline")
    ap.add_argument("--skip-model-grid", action="store_true",
                    help="skip the full-model predict_model_grid timing")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(limit=args.limit, include_neusight=not args.skip_neusight,
        include_model_grid=not args.skip_model_grid, device=args.device)


if __name__ == "__main__":
    main()
