"""Per-device cost, collective traffic and memory of a step run on meta
DTensors over a mesh (the JAX package's ``core/hlo.py``).

The JAX package reads these from the compiled executable: XLA's per-device
``cost_analysis()``, the collectives in the optimized HLO text and
``memory_analysis()``.  The port has no compiled program.  It runs the step
once on meta DTensors over a (fake) ``DeviceMesh`` and reads instead:

  - the per-device cost from ``core.jaxpr_cost.CostCounter``, which prices
    the ops DTensor runs on each rank's local shards (``cost_summary``);
  - the collectives from ``CollectiveCounter``, that same counter (one
    ``TorchDispatchMode``) recording the functional collectives
    (``_c10d_functional``) DTensor issues on the local shards:
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_reduce``, ``all_to_all_single`` and their coalesced and
    autograd forms; ``broadcast``, the one
    point-to-point-shaped op there, is priced as a ``collective-permute``.
    A gather's or scatter's group size is its own ``group_size`` argument,
    the others' their process group's size;
  - the argument and output bytes per device from the local shards of the
    step's inputs and outputs (``memory_summary``).  No temporary peak is
    tracked, so the summary has none.

Per-device ICI traffic uses the reference's ring formulas
(``ring_bytes``):
    all-gather      (g-1)/g * output_bytes
    reduce-scatter  (g-1)/g * input_bytes
    all-reduce      2*(g-1)/g * input_bytes
    all-to-all      (g-1)/g * input_bytes
    collective-permute  input_bytes
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten

from repro_torch.core import jaxpr_cost

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collective (op name) -> the HLO collective kind it prices as
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_gather_into_tensor_out": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_reduce": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "all_to_all_single": "all-to-all",
          "broadcast": "collective-permute"}


@dataclasses.dataclass
class CollectiveStats:
    # per collective kind: [count, operand_bytes, ici_bytes_estimate]
    by_kind: Dict[str, list]

    @property
    def total_operand_bytes(self) -> int:
        return sum(v[1] for v in self.by_kind.values())

    @property
    def total_ici_bytes(self) -> int:
        return sum(v[2] for v in self.by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(v[0] for v in self.by_kind.values())

    def summary(self) -> str:
        rows = [f"{k}: n={v[0]} operand={v[1]/1e6:.1f}MB ici={v[2]/1e6:.1f}MB"
                for k, v in sorted(self.by_kind.items()) if v[0]]
        return "; ".join(rows) if rows else "none"


def empty_stats() -> CollectiveStats:
    return CollectiveStats(by_kind={k: [0, 0, 0] for k in COLLECTIVES})


def ring_bytes(kind: str, operand_bytes: float, out_bytes: float,
               g: int) -> Tuple[float, float]:
    """(operand bytes, per-device ICI bytes) of one ``kind`` collective
    over a group of ``g`` devices, as the reference's ``_accumulate_line``
    prices an HLO line: an operand of 0 bytes is recovered from the
    output's."""
    if operand_bytes == 0:
        if kind == "all-gather":
            operand_bytes = out_bytes // max(g, 1)
        elif kind == "reduce-scatter":
            operand_bytes = out_bytes * max(g, 1)
        else:
            operand_bytes = out_bytes
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-gather":
        ici = frac * out_bytes
    elif kind == "reduce-scatter":
        ici = frac * operand_bytes
    elif kind == "all-reduce":
        ici = 2 * frac * operand_bytes
    elif kind == "all-to-all":
        ici = frac * operand_bytes
    else:  # collective-permute
        ici = operand_bytes
    return operand_bytes, ici


def accumulate(by_kind, kind: str, operand_bytes: int, out_bytes: int,
               g: int, m_exec: float = 1.0):
    """Add one collective to ``by_kind`` as the reference adds a line."""
    operand_bytes, ici = ring_bytes(kind, operand_bytes, out_bytes, g)
    rec = by_kind[kind]
    rec[0] += int(m_exec)
    rec[1] += int(operand_bytes * m_exec)
    rec[2] += int(ici * m_exec)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _group_size(func, args, kwargs) -> int:
    """The op's ``group_size`` argument where it has one, else the size of
    the process group it names."""
    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args), **kwargs)
    if "group_size" in bound:
        return int(bound["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(bound["group_name"]).size()


def operand_key(t) -> str:
    """A collective's operand as ``dtype[shape]`` (a coalesced op's
    operands joined by '+')."""
    if isinstance(t, torch.Tensor):
        return f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
    return "+".join(operand_key(x) for x in t)


class CollectiveCounter(jaxpr_cost.CostCounter):
    """A ``CostCounter`` that also counts the functional collectives
    dispatched inside it into ``stats`` (a ``CollectiveStats``), each
    priced by ``ring_bytes`` on the local tensors it moves, and each one's
    operand into ``operands`` ({kind: Counter(``operand_key``)})."""

    def __init__(self):
        super().__init__()
        self.stats = empty_stats()
        self.operands = {k: collections.Counter() for k in COLLECTIVES}

    def collective(self, func, args, kwargs, out):
        name = jaxpr_cost.op_name(func)
        if name in _KINDS:
            kind = _KINDS[name]
            # priced once, then added ``scale`` times: a loop that ``scan``
            # ran once counts what its every iteration would add
            one = empty_stats().by_kind
            accumulate(one, kind, _nbytes(args[0]), _nbytes(out),
                       _group_size(func, args, kwargs))
            rec = self.stats.by_kind[kind]
            for i, v in enumerate(one[kind]):
                rec[i] += v * self.scale
            self.operands[kind][operand_key(args[0])] += self.scale


def cost_summary(counter: jaxpr_cost.CostCounter) -> Dict[str, float]:
    """flops / bytes / transcendentals of one device, from a counter that
    ran the step on the mesh (bytes: the fusion-aware estimate)."""
    c = counter.cost
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "transcendentals": float(c.transcendentals)}


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def memory_summary(arguments, outputs) -> Dict[str, int]:
    """Bytes of one device's share of the step's ``arguments`` and
    ``outputs`` (pytrees of tensors; a DTensor counts its local shard),
    and of the outputs that are arguments updated in place
    (``alias_size_in_bytes``)."""
    args = [t for t in tree_flatten(arguments)[0]
            if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_flatten(outputs)[0]
            if isinstance(t, torch.Tensor)]
    ids = {id(t) for t in args}
    size = lambda ts: sum(_nbytes(_local(t)) for t in ts)
    return {"argument_size_in_bytes": size(args),
            "output_size_in_bytes": size(outs),
            "alias_size_in_bytes": size([t for t in outs if id(t) in ids])}
