"""Op cost counter: FLOPs, bytes and transcendentals of a torch function,
counted per aten op under a ``TorchDispatchMode`` while the function runs
on ``meta`` tensors (shapes and dtypes only: nothing is allocated and no
kernel runs).

This is the port's stand-in for the XLA ``cost_analysis()`` features the
JAX package feeds its memory model.  The conventions follow the JAX
package's ``core/jaxpr_cost.py``:

  - matrix products (``mm``/``bmm``/``addmm``/``baddbmm``):
    2 · batch · M · N · K flops;
  - transcendental ops (the ``jaxpr_cost`` set, plus the fused aten
    activations and softmax whose kernels evaluate exp/tanh per element):
    one flop and one transcendental per output element;
  - type conversion, copies and ``arange``: 0 flops;
  - everything else (pointwise, reductions, gathers, padding, concat):
    one flop per output element;
  - bytes: operands + outputs of every op — the ``bytes_prefusion``
    convention, which is honest for eager torch because each aten op is
    its own kernel.  Ops that only make a view (``is_view``, and the
    metadata-only ``_unsafe_view``/``detach``/``alias``) launch nothing and
    count nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_MATMUL = {"mm", "bmm", "addmm", "baddbmm"}

_TRANSCENDENTAL = {"exp", "exp2", "log", "log1p", "log2", "expm1", "tanh",
                   "sin", "cos", "sigmoid", "erf", "erfinv", "erfc", "rsqrt",
                   "sqrt", "pow", "atan2", "sinh", "cosh", "tan", "asin",
                   "acos", "atan", "digamma", "lgamma",
                   # fused aten kernels that evaluate one of the above
                   "gelu", "silu", "softplus", "_softmax", "_log_softmax"}

_ZERO_FLOP = {"_to_copy", "clone", "copy", "arange"}

_METADATA = {"_unsafe_view", "detach", "alias", "lift_fresh"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0

    def as_features(self) -> Dict[str, float]:
        return {"bytes": self.bytes, "flops": self.flops,
                "transcendentals": self.transcendentals}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _dot_flops(name: str, args) -> float:
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else args[:2]
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2], a.shape[-1]
    return 2.0 * batch * m * b.shape[-1] * k


def op_cost(func, args, kwargs, out) -> Cost:
    """Cost of one aten op call under the conventions above."""
    name = func.overloadpacket.__name__.rstrip("_")
    if func.is_view or name in _METADATA:
        return Cost()
    outs = _tensors(out)
    io = sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
    return priced(name, args, outs, io)


def priced(name: str, args, outs, io: float) -> Cost:
    """``op_cost`` of op ``name`` (not a view) from its arguments, its
    output tensors and its operand + output bytes ``io``."""
    out_elems = float(sum(t.numel() for t in outs))
    if name in _MATMUL:
        return Cost(_dot_flops(name, args), io, 0.0)
    if name in _TRANSCENDENTAL:
        return Cost(out_elems, io, out_elems)
    if name in _ZERO_FLOP:
        return Cost(0.0, io, 0.0)
    return Cost(out_elems, io, 0.0)


class CostCounter(TorchDispatchMode):
    """Accumulates ``op_cost`` over every aten op dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = op_cost(func, args, kwargs, out)
        self.cost.flops += c.flops
        self.cost.bytes += c.bytes
        self.cost.transcendentals += c.transcendentals
        return out


def cost_of(fn: Callable, *specs: Tuple[Sequence[int], torch.dtype]
            ) -> Dict[str, float]:
    """Features ``{"bytes", "flops", "transcendentals"}`` of ``fn`` applied
    to meta tensors of the given ``(shape, dtype)`` specs."""
    args = [torch.empty(tuple(shape), dtype=dtype, device="meta")
            for shape, dtype in specs]
    with CostCounter() as counter:
        fn(*args)
    return counter.cost.as_features()
