"""The hand kernels' wrappers on ``meta`` tensors (shapes and dtypes, no
data): what the dry run (``launch/dryrun.py``) traces the model with.

A wrapper given meta tensors launches nothing, runs no plain version and
moves no launch counter: it makes its outputs on ``meta`` and reports the
call, priced as one fused kernel, to every counter in the current
``TorchDispatchMode`` stack that takes such reports (an object with a
``kernel_call`` method, ``core.jaxpr_cost.CostCounter``).  The price is
the kernel's own: the flops of the tiles it visits and the bytes of its
operands and results (what crosses the call boundary; its tiles live in
shared memory and registers)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def all_meta(tensors: Sequence) -> bool:
    return all(t.is_meta for t in tensors if t is not None)


def report(name: str, flops: float, transcendentals: float,
           inputs: Sequence, outputs: Sequence):
    """One call of hand kernel ``name`` to every active counter that takes
    kernel calls."""
    ins = [t for t in inputs if isinstance(t, torch.Tensor)]
    outs = [t for t in outputs if isinstance(t, torch.Tensor)]
    for mode in _get_current_dispatch_mode_stack():
        take = getattr(mode, "kernel_call", None)
        if take is not None:
            take(name, float(flops), float(transcendentals), ins, outs)
