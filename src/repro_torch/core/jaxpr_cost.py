"""Dispatch-exact FLOP/byte accounting of a function run on ``meta``
tensors (the JAX package's ``core/jaxpr_cost.py``).

The JAX package walks the staged jaxpr, since XLA's ``cost_analysis``
counts loop bodies once, and multiplies each scan body by its length.
The port has no jaxpr and no compiler output to read: it runs the
function once on meta tensors (shapes and dtypes, no data, no kernel)
under a ``TorchDispatchMode`` and prices every aten op dispatched.  Eager
Python loops (layers, cross-entropy chunks, microbatches, AdamW's
tensors) dispatch every iteration, so there is no trip count to multiply;
the recompute of ``torch.utils.checkpoint`` (remat) dispatches again
inside the backward and is counted there.  The two loops over a sequence,
the sLSTM scan and the mLSTM chunk loop, are the reference's scans: under
a counter on meta tensors they run one iteration inside ``scan``, whose
ops, collectives and hand-kernel calls count as many times as the loop
has trips (each iteration dispatches the same ops at the same shapes).

Conventions (the reference's, on aten ops):
  - flops and transcendentals are ``core/cost.py::op_cost``'s: matrix
    products 2 · batch · M · N · K, transcendental ops one per output
    element and counted apart, conversions and copies 0, every other op
    one per output element;
  - ``bytes_prefusion``: operands + outputs of every op (a no-fusion upper
    bound);
  - ``bytes`` (fusion-aware HBM estimate, the roofline's memory term):
    layout ops (views, reshape, transpose, expand, ``_to_copy``, copies)
    0; pointwise ops their output bytes only (a chain fuses into its
    consumer); products, reductions, gathers and scatters operands +
    outputs;
  - a hand kernel (``kernels.priced.report``) is one fused call: the flops
    and exponentials of the tiles it visits, its call-boundary I/O for
    both byte counts;
  - allocations (``empty*``) and the functional collectives count nothing
    here: each collective goes to ``CostCounter.collective``, which
    ``core/hlo.py``'s counter prices.

On DTensors the counter lets DTensor dispatch each op (it returns
``NotImplemented``) and counts the ops DTensor then runs on each rank's
local shards, so on a mesh the count is per device; DTensor's own shape
propagation, run on ``FakeTensor``s at the global shapes, is not counted.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from repro_torch.core import cost as _cost

_ALLOCATION = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "empty_permuted"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
_LAYOUT = {"_to_copy", "clone", "copy"} | _cost._METADATA
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "prod", "logsumexp", "cumsum", "cumprod", "sort",
               "topk", "var", "std", "var_mean", "norm",
               "linalg_vector_norm", "_softmax", "_log_softmax",
               "_softmax_backward_data", "_log_softmax_backward_data",
               "any", "all", "nll_loss_forward", "nll_loss_backward"}
_GATHERS = {"gather", "index_select", "embedding", "index", "take",
            "take_along_dim"}
_SCATTERS = {"scatter", "scatter_add", "scatter_reduce", "index_put",
             "_index_put_impl", "index_add", "index_copy",
             "embedding_dense_backward", "slice_scatter", "select_scatter",
             "masked_scatter"}
_HEAVY = _cost._MATMUL | _REDUCTIONS | _GATHERS | _SCATTERS


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0               # fusion-aware HBM estimate
    transcendentals: float = 0.0
    bytes_prefusion: float = 0.0     # no-fusion upper bound

    def __iadd__(self, o):
        self.flops += o.flops
        self.bytes += o.bytes
        self.transcendentals += o.transcendentals
        self.bytes_prefusion += o.bytes_prefusion
        return self

    def times(self, n: int) -> "Cost":
        return Cost(self.flops * n, self.bytes * n, self.transcendentals * n,
                    self.bytes_prefusion * n)

    def as_dict(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes": self.bytes,
                "transcendentals": self.transcendentals,
                "bytes_prefusion": self.bytes_prefusion}


_NAMES: Dict[object, str] = {}


def op_name(func) -> str:
    """An aten op's name without its overload or in-place underscore."""
    name = _NAMES.get(func)
    if name is None:
        name = _NAMES[func] = func.overloadpacket.__name__.rstrip("_")
    return name


def is_collective(func) -> bool:
    return getattr(func, "namespace", "") in _COLLECTIVE_NAMESPACES


def op_price(func, args, kwargs, out) -> Cost:
    """The cost of one aten op call under the conventions above."""
    name = op_name(func)
    if name in _ALLOCATION or is_collective(func):
        return Cost()
    outs = _cost._tensors(out)
    out_bytes = sum(_cost._nbytes(t) for t in outs)
    pre = out_bytes + sum(_cost._nbytes(t) for t in _cost._tensors((args,
                                                                     kwargs)))
    if func.is_view or name in _LAYOUT:
        return Cost(0.0, 0.0, 0.0, pre)
    c = _cost.priced(name, args, outs, pre)
    return Cost(c.flops, pre if name in _HEAVY else out_bytes,
                c.transcendentals, pre)


class CostCounter(TorchDispatchMode):
    """Accumulates ``op_price`` over every aten op dispatched inside it
    (``cost``), by op name (``by_op``; a hand kernel's calls under
    ``kernel:<name>``), and the hand kernels' calls (``kernel_calls``).
    Inside ``scan`` each is counted ``scale`` times; while a counter is
    entered, ``scan`` prices the models' loops (``cost.loop_trips``)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.by_op: Dict[str, Cost] = {}
        self.kernel_calls: Dict[str, int] = {}
        self.scale = 1
        self._outer_hook = None

    def __enter__(self):
        self._outer_hook = _cost.set_loop_hook(scan)
        return super().__enter__()

    def __exit__(self, *exc):
        _cost.set_loop_hook(self._outer_hook)
        return super().__exit__(*exc)

    def _add(self, key: str, c: Cost):
        c = c.times(self.scale)
        self.cost += c
        self.by_op.setdefault(key, Cost())
        self.by_op[key] += c

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # priced on the local shards it runs
        out = func(*args, **kwargs)
        if not any(issubclass(t, FakeTensor) for t in types):
            self._add(op_name(func), op_price(func, args, kwargs, out))
            if is_collective(func):
                self.collective(func, args, kwargs, out)
        return out

    def collective(self, func, args, kwargs, out):
        """One functional collective (priced 0 above); ``core/hlo.py``'s
        counter records it."""

    def kernel_call(self, name: str, flops: float, transcendentals: float,
                    inputs, outputs):
        """One hand-kernel call (``kernels.priced.report``)."""
        io = sum(_cost._nbytes(t) for t in list(inputs) + list(outputs))
        self._add(f"kernel:{name}", Cost(flops, io, transcendentals, io))
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + self.scale

    def product_flops(self) -> float:
        """The flops of the matrix products (aten ``mm``, ``bmm``,
        ``addmm``, ``baddbmm``), hand kernels not included."""
        return sum(c.flops for k, c in self.by_op.items()
                   if k in _cost._MATMUL)


@contextlib.contextmanager
def scan(trips: int, probe: torch.Tensor):
    """A Python loop of ``trips`` iterations priced as the reference prices
    a scan, its body times its length (the hook ``CostCounter`` installs in
    ``cost.loop_trips``): on meta tensors (``probe``) under a counter,
    where no gradient is recorded, yields 1, and each op, collective and
    hand-kernel call dispatched inside counts ``trips`` times; elsewhere
    (a real device, no counter, or a loop whose backward autograd will
    run) yields ``trips`` and changes nothing.  A recorded loop runs whole
    because its iterations' backward differs (the first takes no gradient
    of the initial state, and the inputs every iteration reads sum one
    gradient an iteration), which one iteration cannot stand for."""
    recorded = torch.is_grad_enabled() and probe.requires_grad
    counters = [m for m in _get_current_dispatch_mode_stack()
                if isinstance(m, CostCounter)] \
        if probe.is_meta and not recorded else []
    if not counters or trips <= 1:
        yield trips
        return
    for c in counters:
        c.scale *= trips
    try:
        yield 1
    finally:
        for c in counters:
            c.scale //= trips


def count(fn: Callable, *args, **kwargs) -> CostCounter:
    """The counter after ``fn(*args, **kwargs)`` ran under it."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter


def cost_of(fn: Callable, *meta_args, **kwargs) -> Dict[str, float]:
    """Dispatch-exact cost of ``fn(*meta_args)``: global on plain meta
    tensors, per device on meta DTensors.  A function that takes gradients
    (a train step) is counted with its backward, remat recompute
    included."""
    return count(fn, *meta_args, **kwargs).cost.as_dict()
