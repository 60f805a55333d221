"""The train-step builder: loss and gradients, microbatch accumulation and
AdamW (the JAX package's ``training/step.py``).

The returned ``train_step(params, opt_state, batch)`` takes the model's
own parameter tensors (``trainable_params``), so the model computes with
the values the optimizer writes in place; it returns (params, opt_state,
metrics) as the JAX step does, and metrics holds the reference's keys:
loss, ce, lb_loss, z_loss, grad_norm and lr, each an f32 scalar tensor.

On a mesh (``distributed.sharding``) the parameters are DTensors; each
gradient is laid out as its parameter (a pending sum is reduced and
scattered there) and the metrics are whole values on every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models import convert
from repro_torch.training import objective
from repro_torch.training import optimizer as opt

METRIC_KEYS = ("loss", "ce", "lb_loss", "z_loss")


def trainable_params(model) -> Dict[str, torch.Tensor]:
    """The model's parameters by ``state_dict`` name, with gradients turned
    on (inference keeps them off: no graph, no host time)."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def build_train_step(model, adamw: opt.AdamWConfig, *,
                     num_microbatches: int = 1, block_skip: bool = False,
                     fused_ce: bool = True, remat: bool = False,
                     grad_transform: Optional[Callable] = None,
                     mark: Optional[Callable[[str], None]] = None):
    """``grad_transform``: an optional fn(grads) -> grads applied before the
    optimizer (e.g. a compressed all-reduce).  ``mark``: an optional
    fn(part) called as each part of the step ends: "forward" after the
    loss, "backward" after the gradients (once a microbatch), "optimizer"
    after the update; e.g. to record CUDA events between the parts.
    ``remat``: per-block checkpointing (``Transformer.train_forward``).  With
    ``num_microbatches`` > 1 the batch's leading dimension is split, each
    microbatch's gradients and metrics are summed in f32 buffers and the
    sums are scaled by 1 / num_microbatches.  Weight decay follows the
    reference's rule on its stacked leaves (``convert.jax_ndim``)."""
    decay = {name: convert.jax_ndim(name, p, model.cfg) >= 2
             for name, p in model.named_parameters()}

    def compute_grads(params, batch):
        loss, metrics = objective.loss_fn(model, batch, block_skip=block_skip,
                                          fused_ce=fused_ce, remat=remat)
        if mark is not None:
            mark("forward")
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if sh.is_sharded(p) else g
                 for p, g in zip(params.values(), grads)]
        if mark is not None:
            mark("backward")
        metrics["loss"] = loss
        return (dict(zip(params, grads)),
                {k: sh.full(metrics[k].detach()) for k in METRIC_KEYS})

    def accumulate(params, batch):
        if num_microbatches == 1:
            return compute_grads(params, batch)
        B = batch["tokens"].shape[0]
        if B % num_microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{num_microbatches} microbatches")
        mb = B // num_microbatches
        g_acc = {k: torch.zeros_like(p, dtype=torch.float32)
                 if sh.is_sharded(p) else
                 torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        m_acc = {k: torch.zeros((), dtype=torch.float32,
                                device=batch["tokens"].device)
                 for k in METRIC_KEYS}
        for i in range(num_microbatches):
            part = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
            g, m = compute_grads(params, part)
            for k in g_acc:
                g_acc[k] += g[k]
            for k in m_acc:
                m_acc[k] += m[k]
        inv = 1.0 / num_microbatches
        return ({k: x * inv for k, x in g_acc.items()},
                {k: x * inv for k, x in m_acc.items()})

    def train_step(params, opt_state, batch):
        grads, metrics = accumulate(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = opt.apply_updates(
            params, grads, opt_state, adamw, decay)
        if mark is not None:
            mark("optimizer")
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
