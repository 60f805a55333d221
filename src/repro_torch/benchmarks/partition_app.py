"""Paper application §IV-D1: two-device pipeline partition of a Qwen-3-style
model.  Device A = this device; device B = a simulated 2.5x-faster device
(habitat-style scaling).  Compare the TRUE bottleneck achieved by the
PM2Lat-chosen split vs the NeuSight-chosen split vs the optimal split
computed from measured per-block times, and the completion time of 100
pipelined requests under each plan.

Each of the model's blocks is timed alone on a random (batch, seq, d)
hidden state with RoPE factors for positions 0..seq-1 (where the JAX
package jits ``apply_block`` once per block kind).

    PYTHONPATH=src python -m repro_torch.benchmarks.partition_app
"""
from __future__ import annotations

import dataclasses
import json

import torch

from repro_torch.benchmarks import common
from repro_torch.configs import registry as cr
from repro_torch.core import calibrate, opgraph as og, profiler
from repro_torch.core.batch_predict import BatchPredictor
from repro_torch.core.device import resolve
from repro_torch.core.partition import plan_two_devices, plan_two_devices_model
from repro_torch.kernels import flash_attention as fk
from repro_torch.models import attention as attn
from repro_torch.models import registry as mr

B_SPEED = 0.4  # device B per-block latency multiplier (B is 2.5x faster)


def measured_block_latencies(cfg, B, S, device="cuda"):
    """Seconds of each block alone, and the flash launches of one pass over
    every block."""
    dev = resolve(device)
    cdt = getattr(torch, cfg.compute_dtype)
    model = mr.build(cfg, device=dev, dtype=cdt)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(cdt)
    rope = attn.rope_tables(torch.arange(S, device=dev)[None, :],
                            cfg.head_dim, cfg.rope_theta)
    with torch.no_grad():
        before = fk.flash_attention_kernel.launches
        for blk in model.blocks:
            blk(x, cfg, cdt, rope)
        flash = fk.flash_attention_kernel.launches - before
        lat = [profiler.measure(lambda x, blk=blk: blk(x, cfg, cdt, rope)[0],
                                x, device=dev) for blk in model.blocks]
    del model
    return lat, flash


def run(store, neusight, *, batch=4, seq=128, n_requests=100,
        device="cuda") -> dict:
    dev = resolve(device)
    pm = BatchPredictor(store, calibrate.device_name(dev))
    cfg = dataclasses.replace(cr.get_any("qwen3-mini"), n_layers=12,
                              compute_dtype="float32")

    true_a, flash = measured_block_latencies(cfg, batch, seq, dev)
    true_b = [t * B_SPEED for t in true_a]

    def blocks_from(predictor):
        per = []
        for li, kind in enumerate(cfg.layer_kinds):
            one = dataclasses.replace(cfg, n_layers=1, block_pattern=(kind,))
            ops = [o for o in og.enumerate_ops(one, batch, seq,
                                               dtype=cfg.compute_dtype)
                   if o.name not in ("embed", "unembed", "final_norm")]
            t, _ = predictor.predict_ops(ops)
            per.append(t)
        return per

    # PM2Lat per-block latencies come from ONE batched engine pass.
    # comm_cost=0.0: the oracle/neusight plans and the measured-bottleneck
    # evaluation below are zero-comm, so every planner must optimize the
    # same objective for the pick comparison to be meaningful.
    pm_plan, pred_pm = plan_two_devices_model(pm, cfg, batch, seq,
                                              b_speed=B_SPEED,
                                              comm_cost=0.0,
                                              dtype=cfg.compute_dtype)
    pred_ns = blocks_from(neusight)

    plans = {
        "oracle": plan_two_devices(true_a, true_b),
        "pm2lat": pm_plan,
        "neusight": plan_two_devices(pred_ns, [t * B_SPEED for t in pred_ns]),
    }
    out = {"blocks": len(true_a), "flash_launches": flash,
           "measured_block_ms": [t * 1e3 for t in true_a],
           "pm2lat_block_ms": [t * 1e3 for t in pred_pm],
           "neusight_block_ms": [t * 1e3 for t in pred_ns]}
    for name, plan in plans.items():
        s = plan.split_point
        stage_a = sum(true_a[:s])
        stage_b = sum(true_b[s:])
        bottleneck = max(stage_a, stage_b)
        # pipelined completion of n requests: fill + (n-1) * bottleneck
        completion = stage_a + stage_b + (n_requests - 1) * bottleneck
        out[name] = {"split": s, "true_bottleneck_ms": bottleneck * 1e3,
                     "completion_100_s": completion,
                     "predicted_bottleneck_ms": plan.bottleneck * 1e3}
        if name != "oracle":
            out[name]["bottleneck_pred_err_pct"] = 100 * common.rel_err(
                plan.bottleneck, out["oracle"]["true_bottleneck_ms"] / 1e3)
    return out


if __name__ == "__main__":
    store = common.get_calibration()
    print(json.dumps(run(store, common.get_neusight(store, dtype="float32")),
                     indent=1))
