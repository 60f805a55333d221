"""AdamW and its learning-rate schedule (the JAX package's
``training/optimizer.py``), on a name -> tensor dict of parameters.

The arithmetic is the reference's, not ``torch.optim.AdamW``'s: f32 first
and second moments, bias corrections from the step count, weight decay
only on tensors of two or more dimensions, added to the Adam direction
before the learning rate, and ``(p - lr · delta)`` computed in f32 and cast
back to the parameter's type.  The reference counts the dimensions of its
stored leaves, which stack each block's parameters along a period axis,
so its norm scales and biases inside the stack decay too:
``build_train_step`` passes that rule as ``decay``
(``models.convert.jax_ndim``).  PyTorch tensors are mutable, so
``apply_updates`` writes the new parameters and moments into the tensors
it is given (the JAX package returns new ones; XLA donates the old).

On a mesh the parameters are DTensors: the moments take each parameter's
placements, the gradient norm is global (each tensor's sum of squares is
reduced over the mesh) and the update runs on each rank's local shards,
gradients first laid out as their parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.distributed import sharding as sh


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor                 # int32 scalar
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def init_opt_state(params: Dict[str, torch.Tensor]) -> OptState:
    """Step 0 and zero f32 moments shaped like each parameter, on its
    device."""
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32) \
        if sh.is_sharded(p) else \
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m={k: zeros(p) for k, p in params.items()},
                    v={k: zeros(p) for k, p in params.items()})


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_ratio`` of
    it at ``total_steps``; an f32 scalar on ``step``'s device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over ``tensors`` of their f32 sums of squares (a
    DTensor's over its whole value)."""
    return torch.sqrt(torch.stack([sh.full(torch.sum(torch.square(x.float())))
                                   for x in tensors]).sum())


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """(grads scaled by min(1, max_norm / norm), in their types; norm)."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: OptState,
                  cfg: AdamWConfig, decay: Optional[Dict[str, bool]] = None):
    """One AdamW step, in place.  ``decay``: which parameters take weight
    decay (default: those of two or more dimensions).  Returns (params, new
    state, metrics {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p_ in params.items():
        p, g = sh.local(p_), sh.local(grads[name]).float()
        m, v = sh.local(state.m[name]), sh.local(state.v[name])
        pf = p.float()
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if (p_.dim() >= 2) if decay is None else decay[name]:
            delta = delta + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step=step, m=state.m, v=state.v), metrics
