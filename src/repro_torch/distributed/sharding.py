"""Mesh context, logical sharding constraints and parameter partition specs
(the JAX package's ``distributed/sharding.py``, on ``DeviceMesh`` and
DTensor).

Conventions
-----------
Mesh dims: single-pod ``('data', 'model')``; multi-pod ``('pod', 'data',
'model')``.  ``'pod'`` and ``'data'`` are data-parallel / FSDP dims;
``'model'`` is the tensor-parallel dim.

Model code never names mesh dims.  It calls ``constrain(x, 'dp', None,
'tp')`` with *logical* entries:

  - ``'dp'``  -> every data-parallel dim of the mesh (a tuple)
  - ``'tp'``  -> the 'model' dim
  - ``None``  -> unsharded
  - a raw mesh-dim name or tuple of names passes through verbatim

A spec is a tuple of resolved entries, one per tensor dim (the JAX
package's ``PartitionSpec``); ``placements`` turns it into DTensor
placements, ``Shard(i)`` on each mesh dim that tensor dim ``i`` names and
``Replicate()`` on the rest.  ``constrain`` is ``DTensor.redistribute`` to
those placements.  Outside a ``mesh_context``, and on a plain tensor inside
one, every constraint returns its input untouched, so the same model code
runs on one device and on a mesh.

``act_mode`` selects the activation sharding at block boundaries: ``'tp'``
keeps hidden states replicated over 'model' (Megatron TP), ``'sp'`` shards
the sequence over 'model' (sequence parallelism).

The spec functions read only the mesh's dim names and extents, so they
also take a ``MeshShape`` (no process group) where no ``DeviceMesh`` is
needed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_STATE = threading.local()

DP_AXIS_NAMES = ("pod", "data")
TP_AXIS_NAME = "model"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and extents alone, for the spec functions."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_extents(mesh) -> Dict[str, int]:
    """{dim name: extent} of a ``DeviceMesh`` or ``MeshShape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class _Ctx:
    def __init__(self, mesh, act_mode: str, remat: bool):
        self.mesh = mesh
        self.act_mode = act_mode
        self.remat = remat
        self.extent = mesh_extents(mesh)
        self.dp_axes = tuple(a for a in DP_AXIS_NAMES if a in self.extent)
        self.tp_axis = TP_AXIS_NAME if TP_AXIS_NAME in self.extent else None


def _current() -> Optional[_Ctx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def _entered(ctx: Optional[_Ctx]):
    prev = _current()
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def mesh_context(mesh, *, act_mode: str = "tp", remat: bool = True):
    """``mesh``: a ``DeviceMesh`` (or a ``MeshShape`` for specs alone), or
    None for no mesh."""
    assert act_mode in ("tp", "sp"), act_mode
    return _entered(_Ctx(mesh, act_mode, remat) if mesh is not None
                    else None)


def checkpoint_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: the recompute runs
    under the forward's mesh context.  The context is per thread, and
    autograd runs a CUDA backward (and so the recompute) on a thread of
    its own."""
    return contextlib.nullcontext(), _entered(_current())


def current_mesh():
    ctx = _current()
    return ctx.mesh if ctx else None


def act_mode() -> str:
    ctx = _current()
    return ctx.act_mode if ctx else "tp"


def remat_enabled() -> bool:
    ctx = _current()
    return ctx.remat if ctx else False


def dp_size() -> int:
    ctx = _current()
    if not ctx:
        return 1
    n = 1
    for a in ctx.dp_axes:
        n *= ctx.extent[a]
    return n


def tp_size() -> int:
    ctx = _current()
    if not ctx or not ctx.tp_axis:
        return 1
    return ctx.extent[ctx.tp_axis]


def resolve(entry):
    """Logical entry -> mesh dim name(s) or None."""
    ctx = _current()
    if ctx is None or entry is None:
        return None
    if entry == "dp":
        return ctx.dp_axes if ctx.dp_axes else None
    if entry == "tp":
        return ctx.tp_axis
    return entry  # raw dim name / tuple


def spec(*entries) -> tuple:
    return tuple(resolve(e) for e in entries)


def axis_size(axes) -> int:
    """The product of the extents of a dim name or tuple of names (1
    without a mesh or for None)."""
    ctx = _current()
    if axes is None or ctx is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= ctx.extent[a]
    return n


def _divisible(dim: int, axes) -> bool:
    n = axis_size(axes)
    return n > 0 and dim % n == 0


def placements(entries, mesh=None) -> list:
    """Resolved spec entries (one per tensor dim) -> DTensor placements,
    one per mesh dim: ``Shard(i)`` on each mesh dim that entry ``i`` names,
    in the mesh's order (the first named dim is the major split, as in a
    ``PartitionSpec``), ``Replicate()`` elsewhere."""
    mesh = mesh if mesh is not None else current_mesh()
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, axes in enumerate(entries):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            out[names.index(a)] = Shard(i)
    return out


def _resolved_divisible(shape, entries) -> tuple:
    out = []
    for dim, e in zip(shape, entries):
        axes = resolve(e)
        out.append(axes if _divisible(dim, axes) else None)
    return tuple(out)


def constrain(x, *entries):
    """``DTensor.redistribute`` to logical entries; a plain tensor, or any
    tensor outside a mesh, is returned untouched.

    Entries whose mesh extent does not divide the dim are dropped
    (replicated), so callers never special-case small batches."""
    ctx = _current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    assert len(entries) == x.ndim, (entries, x.shape)
    want = placements(_resolved_divisible(x.shape, entries), x.device_mesh)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def keep_grad_layout(x):
    """``x`` itself, whose gradient is laid out as ``x`` is: a DTensor is
    redistributed to its own placements, which moves nothing forward and
    lays the incoming gradient out again backward."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def constrain_hidden(x):
    """Block-boundary activation constraint: (batch, seq, d_model)."""
    ctx = _current()
    if ctx is None:
        return x
    if ctx.act_mode == "sp" and x.ndim >= 3:
        return constrain(x, "dp", "tp", *([None] * (x.ndim - 2)))
    return constrain(x, "dp", *([None] * (x.ndim - 1)))


# ---------------------------------------------------------------------------
# Parameter partition specs (path-pattern rules)
# ---------------------------------------------------------------------------
# Paths are '/'-joined: the port's ``state_dict`` names with '.' -> '/'.
# The JAX package stacks each block's leaves along a leading period dim
# (``stacked``); the port keeps per-layer ``blocks/<i>/...`` leaves, which
# the same rules match with ``stacked=False``.

_RULES: Sequence[tuple[str, tuple]] = (
    # embeddings / unembed: (padded_vocab, d_model)
    (r"(^|/)(embed|unembed)/w$",        ("tp", "dp")),
    # attention projections
    (r"/wq/w$",                         ("dp", "tp")),
    (r"/wk/w$",                         ("dp", "tp")),
    (r"/wv/w$",                         ("dp", "tp")),
    (r"/wo/w$",                         ("tp", "dp")),
    (r"/w[qkv]/b$",                     ("tp",)),
    # dense mlp
    (r"/(w_in|w_gate)/w$",              ("dp", "tp")),
    (r"/w_out/w$",                      ("tp", "dp")),
    # moe
    (r"/router/w$",                     ("dp", None)),
    (r"/experts/(w_in|w_gate)$",        ("tp", "dp", None)),
    (r"/experts/w_out$",                ("tp", None, "dp")),
    (r"/shared\d*/(w_in|w_gate)/w$",    ("dp", "tp")),
    (r"/shared\d*/w_out/w$",            ("tp", "dp")),
    # rg-lru block
    (r"/(conv)/w$",                     (None, "tp")),
    (r"/(wx|wg)/w$",                    ("dp", "tp")),
    (r"/(w_lru_out)/w$",                ("tp", "dp")),
    (r"/lru/(a_param|w_r|w_i)(/w)?$",   None),  # small; handled below
    # xlstm
    (r"/(w_up|w_qkv|w_if)/w$",          ("dp", "tp")),
    (r"/(w_down)/w$",                   ("tp", "dp")),
    (r"/slstm/(wx|rh)/w$",              ("dp", "tp")),
    # norms / scalars / biases default: replicated
)


def _rule_for(path: str):
    for pat, sp_ in _RULES:
        if re.search(pat, path):
            return sp_
    return None


def param_spec_for(path: str, shape: tuple, stacked: bool) -> tuple:
    """The spec of one parameter leaf."""
    ctx = _current()
    entries = _rule_for(path)
    ndim = len(shape)
    lead = 1 if stacked else 0
    out = [None] * ndim
    if entries is not None:
        body_shape = shape[lead:]
        ents = list(entries)[: len(body_shape)]
        for i, (dim, e) in enumerate(zip(body_shape, ents)):
            axes = resolve(e)
            if axes is not None and _divisible(dim, axes):
                out[lead + i] = axes
    else:
        # fallback: shard the largest divisible dim over dp (pure FSDP) for
        # anything big (>= 1M elements) so no parameter is fully replicated.
        size = 1
        for d in shape:
            size *= d
        if ctx is not None and size >= 1 << 20:
            dims = sorted(range(lead, ndim), key=lambda i: -shape[i])
            for i in dims:
                if _divisible(shape[i], resolve("dp")):
                    out[i] = resolve("dp")
                    break
    return tuple(out)


def param_path(name: str) -> str:
    """A ``state_dict`` name as a rule path: '.' -> '/'."""
    return name.replace(".", "/")


def params_partition_specs(named) -> Dict[str, tuple]:
    """{name: spec} over ``(name, tensor)`` pairs (``named_parameters()``
    or a dict's items), per-layer leaves (``stacked=False``)."""
    return {name: param_spec_for(param_path(name), tuple(t.shape), False)
            for name, t in named}


def replicate_like(t: torch.Tensor, ref):
    """``t`` as a DTensor replicated over ``ref``'s mesh where ``ref`` is a
    DTensor and ``t`` is not (a table every rank computes alike, such as
    RoPE's); otherwise ``t`` itself."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        mesh = ref.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def is_sharded(x) -> bool:
    return isinstance(x, DTensor)


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view of its local tensor), or a
    plain tensor itself."""
    return x.to_local() if isinstance(x, DTensor) else x


def distribute(t: torch.Tensor, spec_: tuple, mesh=None):
    """``t`` (the same whole value on every rank) as a DTensor laid out by
    ``spec_`` on ``mesh`` (default: the current one); each rank keeps its
    own chunk, nothing is sent."""
    mesh = mesh if mesh is not None else current_mesh()
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.detach(), mesh, placements(spec_, mesh),
                             src_data_rank=None)


def local_chunk(t: torch.Tensor, like) -> torch.Tensor:
    """This rank's chunk of the whole value ``t`` laid out as the DTensor
    ``like`` (``t`` itself where ``like`` is a plain tensor)."""
    if not isinstance(like, DTensor):
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.to(like.device), like.device_mesh,
                             like.placements, src_data_rank=None).to_local()


def distribute_module_(module: torch.nn.Module, specs: Dict[str, tuple],
                       mesh=None) -> torch.nn.Module:
    """Replace each parameter of ``module`` named in ``specs`` by a DTensor
    parameter laid out by its spec, in place (``requires_grad`` kept)."""
    for name, spec_ in specs.items():
        owner, _, attr = name.rpartition(".")
        mod = module.get_submodule(owner)
        p = getattr(mod, attr)
        setattr(mod, attr, torch.nn.Parameter(distribute(p.data, spec_, mesh),
                                              requires_grad=p.requires_grad))
    return module


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole value of ``x`` as a plain tensor on every rank (a DTensor
    is gathered; a plain tensor is returned as it is)."""
    return x.full_tensor() if isinstance(x, DTensor) else x
