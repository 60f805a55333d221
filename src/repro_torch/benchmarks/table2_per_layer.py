"""Table II reproduction: per-layer relative error (%), PM2Lat vs NeuSight
vs FLOPs-proxy, across layer types {MM, Linear, BMM, SoftMax, Vector} on
the device, in each dtype.

The JAX package's layer set, shape sampler and ops; the measured calls are
the framework's (``torch.matmul`` is cuBLAS on the card), which is what the
``cublas@*`` tables price.  Every dtype draws the same shapes (the sampler
restarts at ``seed``).

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_per_layer
"""
from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.benchmarks import common
from repro_torch.core import calibrate, opgraph as og, profiler
from repro_torch.core.baselines.roofline import RooflineBaseline
from repro_torch.core.device import resolve
from repro_torch.core.predictor import PM2Lat

LAYERS = ("MM", "Linear", "BMM", "SoftMax", "Vector")
PREDICTORS = ("pm2lat", "neusight", "flops_proxy")
DTYPES = ("float32", "bfloat16")


def _sample_shapes(rng, layer: str):
    if layer in ("MM", "Linear"):
        return (int(2 ** rng.uniform(6, 11)), int(2 ** rng.uniform(6, 11)),
                int(2 ** rng.uniform(5, 12)))
    if layer == "BMM":
        return (int(2 ** rng.uniform(2, 4)), int(2 ** rng.uniform(5, 9)),
                int(2 ** rng.uniform(5, 9)), int(2 ** rng.uniform(5, 9)))
    return (int(2 ** rng.uniform(0, 6)), int(2 ** rng.uniform(8, 13)))


def vector(x):
    """The Vector layer: add, mul and gelu (``jax.nn.gelu``'s tanh form)."""
    return F.gelu(x + x, approximate="tanh") * x


def _sample(layer, rng, dname, dev, pm, ns, rb):
    """(shape, measured seconds, {predictor: seconds}) of one sample."""
    ones = lambda *s: torch.ones(s, dtype=getattr(torch, dname), device=dev)
    measure = lambda fn, *a: profiler.measure(fn, *a, device=dev)
    if layer in ("MM", "Linear"):
        m, n, k = shape = _sample_shapes(rng, layer)
        a, w = ones(m, k), ones(k, n)
        if layer == "Linear":
            meas = measure(lambda a, w, b: a @ w + b, a, w, ones(n))
        else:
            meas = measure(lambda a, w: a @ w, a, w)
        op = og.MatmulOp(layer, m=m, n=n, k=k, dtype=dname)
        return shape, meas, {"pm2lat": pm.predict_matmul(op),
                             "neusight": ns.predict_matmul(m, n, k),
                             "flops_proxy": op.flops / rb.peak_flops}
    if layer == "BMM":
        bsz, m, n, k = shape = _sample_shapes(rng, layer)
        meas = measure(torch.bmm, ones(bsz, m, k), ones(bsz, k, n))
        op = og.MatmulOp(layer, m=m, n=n, k=k, batch=bsz, kind="bmm",
                         dtype=dname)
        return shape, meas, {"pm2lat": pm.predict_matmul(op),
                             "neusight": ns.predict_matmul(m, n, k, batch=bsz),
                             "flops_proxy": op.flops / rb.peak_flops}
    b, f = shape = _sample_shapes(rng, layer)
    x = ones(b, f)
    if layer == "SoftMax":
        meas = measure(lambda x: F.softmax(x, dim=-1), x)
        op = og.MemoryOp(layer, "softmax", (b, f), dtype=dname)
    else:
        meas = measure(vector, x)
        op = og.MemoryOp(layer, "silu_mul", (b, f), dtype=dname)
    feats = op.features()
    return shape, meas, {"pm2lat": pm.predict_memory(op),
                         "neusight": ns.predict_memory(feats),
                         "flops_proxy": feats["bytes"] / rb.mem_bw}


def run(store, neusight_by_dtype, *, samples_per_layer=10, seed=0,
        dtypes=DTYPES, device="cuda") -> dict:
    """``errors[dtype][layer][predictor]``: mean and max relative error
    (%) over ``samples_per_layer`` shapes; ``rows``: every sample."""
    dev = resolve(device)
    name = calibrate.device_name(dev)
    pm = PM2Lat(store, name)
    errors, rows = {}, []
    for dname in dtypes:
        ns = neusight_by_dtype[dname]
        rb = RooflineBaseline.from_store(store, name, dname)
        rng = np.random.default_rng(seed)
        errors[dname] = {}
        for layer in LAYERS:
            errs = {k: [] for k in PREDICTORS}
            for _ in range(samples_per_layer):
                shape, meas, preds = _sample(layer, rng, dname, dev, pm, ns, rb)
                for k, p in preds.items():
                    errs[k].append(common.rel_err(p, meas))
                rows.append({"dtype": dname, "layer": layer,
                             "shape": list(shape), "measured_ms": meas * 1e3,
                             **{f"{k}_ms": p * 1e3 for k, p in preds.items()}})
            errors[dname][layer] = {
                k: {"mean": 100 * float(np.mean(v)),
                    "max": 100 * float(np.max(v))} for k, v in errs.items()}
    return {"errors": errors, "rows": rows}


if __name__ == "__main__":
    store = common.get_calibration()
    print(json.dumps(run(store, common.neusight_by_dtype(store, DTYPES))
                     ["errors"], indent=1))
