"""Shared benchmark utilities: error metrics, CSV rows, timers, the
device's calibration, the NeuSight baseline trained (and cached) on the
device, and the drivers' JSON records.  Records go under the port's
artifacts (``artifacts/torch/``, or ``$REPRO_ARTIFACTS/torch``), never to
the JAX package's ``artifacts/BENCH_*.json`` or the checkout's root."""
from __future__ import annotations

import json
import os
import time

import torch

from repro_torch.core import calibrate
from repro_torch.core import memory_model as mm
from repro_torch.core.baselines import neusight as ns
from repro_torch.core.baselines.roofline import best_matmul_throughput


def emit(name: str, us_per_call: float, derived):
    """One CSV row: name,us_per_call,derived (the JAX package's format)."""
    print(f"{name},{us_per_call:.3f},{derived}", flush=True)


class timer:
    """``with timer() as t: ...``; then ``t.s``, the seconds it took."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.s = time.perf_counter() - self.t0


def write_bench(name: str, payload: dict, dry: bool = False,
                path: str = None) -> str:
    """One driver's record as JSON at ``path``, by default
    ``<artifacts>/torch/BENCH_<name>[_dry].json``; returns the path."""
    path = path or os.path.join(calibrate.artifacts_dir(),
                                f"BENCH_{name}{'_dry' if dry else ''}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def rel_err(pred: float, meas: float) -> float:
    return abs(pred - meas) / max(abs(meas), 1e-12)


def signed_err(pred: float, meas: float) -> float:
    return (pred - meas) / max(abs(meas), 1e-12)


def get_calibration(device="cuda"):
    """The device's store: ``artifacts/torch/`` (or ``$REPRO_ARTIFACTS``),
    calibrated first where there is none."""
    return calibrate.load_or_calibrate(device=device, verbose=False)


def neusight_path(dtype: str, device="cuda") -> str:
    root = os.path.dirname(calibrate.default_store_path(device))
    return os.path.join(root, f"neusight_{calibrate.device_name(device)}"
                              f"_{dtype}.pt")


def get_neusight(store, *, dtype: str, device="cuda", n_samples=40,
                 steps=800, seed=0, path=None) -> ns.NeuSightModel:
    """Train (and cache at ``path``, by default ``neusight_path``) the
    NeuSight baseline for ``dtype`` on ``device``: ``n_samples`` timed
    ``torch.matmul`` calls in ``dtype``, the float32 utility ops' samples,
    and the peak of ``store``'s ``dtype`` matmul tables."""
    path = path or neusight_path(dtype, device)
    if os.path.exists(path):
        return ns.NeuSightModel.from_state(
            torch.load(path, weights_only=True), device=device)
    samples = ns.collect_matmul_dataset(n_samples=n_samples, dtype=dtype,
                                        seed=seed, device=device)
    mem_samples = mm.collect_utility_samples(device=device)
    model = ns.train(samples, mem_samples,
                     peak_flops=best_matmul_throughput(store, dtype),
                     steps=steps, seed=seed, device=device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(model.state(), path)
    return model


def neusight_by_dtype(store, dtypes, device="cuda") -> dict:
    return {dt: get_neusight(store, dtype=dt, device=device) for dt in dtypes}
