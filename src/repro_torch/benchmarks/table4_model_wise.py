"""Table IV/V reproduction: model-wise signed error (%) across batch sizes,
PM2Lat vs NeuSight vs the FLOPs/bytes proxy, on structural miniatures of
the paper's models (GPT-2, FLAN-T5, Qwen-3, DeepSeek-R1) plus two
assigned-arch reduced configs (MoE + hybrid, beyond the paper's set), in
each dtype.  Any registry config can be a row (``models=``): the card runs
qwen2-0.5b and yi-6b at full width too.

Each (model, dtype) is built from seed 0 with its weights in the dtype
(``models.registry.build(dtype=)``) and freed before the next; each batch's
forward over zero tokens is measured, then run once more to count its
flash launches, and its ``opgraph.enumerate_ops`` list in the row's dtype
(``dtype=``: without it the op list is float32, whatever the config's
compute dtype) is priced by each predictor.

    PYTHONPATH=src python -m repro_torch.benchmarks.table4_model_wise
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.configs import base as C
from repro_torch.configs import registry as cr
from repro_torch.core import calibrate, opgraph as og, profiler
from repro_torch.core.baselines.roofline import RooflineBaseline
from repro_torch.core.device import resolve
from repro_torch.core.predictor import PM2Lat
from repro_torch.kernels import flash_attention as fk
from repro_torch.models import registry as mr

MODELS = ("gpt2-mini", "flan-t5-mini", "qwen3-mini", "deepseek-r1-mini",
          "moonshot-v1-16b-a3b-reduced", "recurrentgemma-2b-reduced")
BATCHES = (1, 4, 8)
SEQ = 128
DTYPES = ("float32", "bfloat16")
PREDICTORS = ("pm2lat", "neusight", "flops_proxy")


def flash_calls(cfg: C.ModelConfig) -> int:
    """Flash calls in one forward: each attention block's self-attention, a
    cross-attention block's second, each encoder layer's."""
    n = sum(1 + (k == C.CROSS_ATTN) for k in cfg.layer_kinds if k != C.RGLRU)
    return n + (cfg.encoder.n_layers if cfg.encoder is not None else 0)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(store, neusight_by_dtype, *, models=MODELS, batches=BATCHES,
        seq=SEQ, dtypes=DTYPES, device="cuda") -> dict:
    """``rows``: one per (model, dtype, batch), measured ms, each
    predictor's ms and signed error (%); ``mean_abs_err_pct[dtype]
    [predictor]`` over the rows."""
    dev = resolve(device)
    name = calibrate.device_name(dev)
    pm = PM2Lat(store, name)
    rbs = {dt: RooflineBaseline.from_store(store, name, dt) for dt in dtypes}
    rows = []
    for arch in models:
        for dname in dtypes:
            cfg = dataclasses.replace(cr.get_any(arch), compute_dtype=dname)
            predictors = {"pm2lat": pm, "neusight": neusight_by_dtype[dname],
                          "flops_proxy": rbs[dname]}
            model = mr.build(cfg, device=dev, dtype=getattr(torch, dname))
            for B in batches:
                tokens = torch.zeros((B, seq), dtype=torch.long, device=dev)
                ctx = model.make_ctx(B) if model.needs_ctx() else None
                fwd = lambda t, c: model(t, ctx_embed=c)
                with torch.no_grad():
                    meas = profiler.measure(fwd, tokens, ctx, device=dev)
                    before = fk.flash_attention_kernel.launches
                    logits = fwd(tokens, ctx)
                    _sync(dev)
                    flash = fk.flash_attention_kernel.launches - before
                    finite = bool(torch.isfinite(logits).all())
                    del logits
                ops = og.enumerate_ops(cfg, B, seq, dtype=dname)
                pred = {k: p.predict_ops(ops)[0] for k, p in predictors.items()}
                rows.append({
                    "model": arch, "dtype": dname, "batch": B, "seq": seq,
                    "measured_ms": meas * 1e3, "logits_finite": finite,
                    "flash_launches": flash, "flash_calls": flash_calls(cfg),
                    **{f"{k}_ms": v * 1e3 for k, v in pred.items()},
                    **{f"{k}_pct": common.signed_err(v, meas) * 100
                       for k, v in pred.items()}})
            del model
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    mean_abs = {dt: {k: float(np.mean([abs(r[f"{k}_pct"]) for r in rows
                                       if r["dtype"] == dt]))
                     for k in PREDICTORS} for dt in dtypes}
    return {"rows": rows, "mean_abs_err_pct": mean_abs}


if __name__ == "__main__":
    store = common.get_calibration()
    out = run(store, common.neusight_by_dtype(store, DTYPES))
    print(json.dumps(out["mean_abs_err_pct"], indent=1))
