"""Partition specs for every train / serve state object (the JAX package's
``distributed/specs.py``), keyed by the port's names.

All rules live here and in ``sharding.py``, so that the launcher,
checkpointing and the elastic re-mesh agree on one source of truth.  A
spec is a tuple of resolved entries, one per tensor dim
(``sharding.placements`` turns it into DTensor placements); the functions
read the mesh of the current ``sharding.mesh_context``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.distributed import sharding as sh
from repro_torch.training import optimizer as opt

def _named(params):
    if hasattr(params, "named_parameters"):
        return params.named_parameters()
    return params.items() if isinstance(params, dict) else params


def strip_dp(spec: tuple) -> tuple:
    """``spec`` without its data-parallel (FSDP) dims."""
    dp_axes = set(sh.DP_AXIS_NAMES)
    ents = []
    for e in spec:
        if e is None:
            ents.append(None)
        elif isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a not in dp_axes)
            ents.append(kept if kept else None)
        else:
            ents.append(None if e in dp_axes else e)
    return tuple(ents)


def params_specs(params, *, serve: bool = False) -> Dict[str, tuple]:
    """{name: spec} of a model's parameters (a module, a name -> tensor
    dict or (name, tensor) pairs).

    ``serve=True``: drop the data-parallel (FSDP) dims: weights replicated
    over dp and sharded over 'model' only, so that a decode step does not
    all-gather every FSDP shard once a token."""
    specs = sh.params_partition_specs(_named(params))
    if not serve:
        return specs
    return {k: strip_dp(s) for k, s in specs.items()}


def opt_specs(p_specs: Dict[str, tuple]) -> opt.OptState:
    """AdamW's moments take their parameters' specs; the step is a
    replicated scalar."""
    return opt.OptState(step=(), m=p_specs, v=p_specs)


def batch_spec(shape) -> tuple:
    """The leading (batch) dim over dp where it divides, the rest
    replicated."""
    resolved = [sh.resolve("dp")] + [None] * (len(shape) - 1)
    if shape[0] % max(sh.dp_size(), 1):
        resolved[0] = None
    return tuple(resolved)


def batch_specs(batch: dict) -> Dict[str, tuple]:
    return {k: batch_spec(tuple(t.shape)) for k, t in batch.items()}


# the KVCache lists that hold attention caches (B, Hkv, W, hd), and those
# that hold recurrent states with a wide last dim
_KV_FIELDS = ("k", "v", "xk", "xv")
_STATE_FIELDS = ("h", "c", "n", "m", "C", "conv")


def cache_leaf_spec(field: str, shape) -> tuple:
    """Decode-cache leaf sharding, on the port's head-major layout.

    kv caches (B, Hkv, W, hd): batch -> dp; heads -> tp where divisible,
      else the cache's sequence -> tp (flash-decoding-style sequence
      sharding).
    recurrent states: batch -> dp; the wide last dim -> tp.
    """
    nd = len(shape)
    out = [None] * nd
    dp_ax, tp_ax = sh.resolve("dp"), sh.resolve("tp")

    def try_set(i, ax):
        if ax is not None and shape[i] % sh.axis_size(ax) == 0 \
                and out[i] is None:
            out[i] = ax
            return True
        return False

    if field in _KV_FIELDS and nd == 4:
        try_set(0, dp_ax)                 # batch
        if not try_set(1, tp_ax):         # kv heads
            try_set(2, tp_ax)             # else: cache sequence
    elif field in _STATE_FIELDS:
        try_set(0, dp_ax)
        try_set(nd - 1, tp_ax)            # dl / di / hd
    elif field != "pos":
        try_set(0, dp_ax)
    return tuple(out)


def cache_specs(cache, cfg=None) -> Dict[str, list]:
    """{field: [spec, or None where the layer has no such tensor], ...,
    "pos": spec} of a ``KVCache`` (``cfg`` is accepted for the JAX
    package's signature)."""
    del cfg
    out = {}
    for field in ("k", "v", "h", "conv", "xk", "xv", "C", "c", "n", "m"):
        out[field] = [None if t is None else
                      cache_leaf_spec(field, tuple(t.shape))
                      for t in getattr(cache, field)]
    out["pos"] = cache_leaf_spec("pos", tuple(cache.pos.shape))
    return out
