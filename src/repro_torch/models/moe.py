"""Mixture-of-Experts FFN: GShard/Switch-style static capacity dispatch (the
JAX package's ``models/moe.py``).

Two dispatch modes (env ``REPRO_MOE_DISPATCH`` or the ``dispatch_mode``
arg), with the same routing decisions:

  - ``einsum`` (default): one-hot dispatch and combine products over the
    (G, S, E, C) masks;
  - ``gather``: dispatch by scatter-add into E·C slots (and a dump slot for
    dropped pairs), combine by gathering each token's K slots.

Tokens are routed in groups (default one a batch row; env
``REPRO_MOE_TOKENS_PER_GROUP`` sets tokens a group) and each expert takes
at most ``expert_capacity`` tokens a group: for each choice k in turn a
token's slot at its expert is a cumulative count over the group's
sequence, so earlier tokens win slots and later ones are dropped.  A
decode step routes each batch row's one token as a group of its own.

The router runs in f32 on f32 weights (``keep_f32``: ``cast_weights_``
leaves them).  One-hot masks are comparisons against ``arange`` (no host
check of the indices, as ``F.one_hot`` makes on the card), so the decode
step stays capturable as a CUDA graph.  The expert products are E batched
products of (G·C, d) × (d, f): the expert weights are never broadcast over
the groups.

On a mesh (DTensor activations) the groups lie over the data-parallel
dims and the experts over 'model' (``_RULES``' ``experts`` rows).  The
routing, the gather mode's scatter into slots and its combine run on each
rank's own groups through ``local_map`` (``_by_group``): nothing of it is
gathered over 'data', and each rank combines only its own experts' slots
into a partial sum over 'model', as the einsum mode's combine product
does.
"""
from __future__ import annotations

import math
import os

import torch
from torch import nn
from torch.distributed.tensor import Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import sharding as sh
from repro_torch.models import layers as L


class Experts(nn.Module):
    """The routed experts' stacked weights: ``w_in`` (E, d, f), ``w_out``
    (E, f, d) and, for a gated activation, ``w_gate`` (E, d, f).  Cast by
    ``transformer.cast_weights_`` as the linears are."""

    def __init__(self, n_experts: int, d_model: int, d_ff: int, act: str, *,
                 device=None):
        super().__init__()
        self.w_in = L._param(n_experts, d_model, d_ff, device=device)
        self.w_out = L._param(n_experts, d_ff, d_model, device=device)
        self.w_gate = L._param(n_experts, d_model, d_ff, device=device) \
            if L.is_gated(act) else None

    def reset(self, gen: torch.Generator):
        # normal / sqrt(fan_in), fan_in = shape[-2] (the JAX ``_init_w``)
        for w in (self.w_in, self.w_out, self.w_gate):
            if w is not None:
                w.normal_(0.0, 1.0, generator=gen).mul_(
                    1.0 / math.sqrt(w.shape[-2]))


class MoE(nn.Module):
    """``router`` (d -> E, f32), ``experts`` and ``shared<i>`` (dense MLPs
    of width ``d_ff_expert`` over every token): the JAX package's MoE
    parameter keys."""

    def __init__(self, d_model: int, moe: MoEConfig, act: str, *,
                 device=None):
        super().__init__()
        self.router = L.Linear(d_model, moe.num_experts, device=device)
        self.router.keep_f32 = True
        self.experts = Experts(moe.num_experts, d_model, moe.d_ff_expert, act,
                               device=device)
        self.n_shared = moe.num_shared_experts
        for i in range(self.n_shared):
            setattr(self, f"shared{i}", L.MLP(d_model, moe.d_ff_expert, act,
                                              device=device))

    def reset(self, gen: torch.Generator):
        self.router.reset(gen)
        self.experts.reset(gen)
        for i in range(self.n_shared):
            getattr(self, f"shared{i}").reset(gen)

    def forward(self, x, moe: MoEConfig, act: str, compute_dtype=None):
        """x (B, S, d) -> (y, aux) (``moe_ffn``)."""
        return moe_ffn(self, x, moe, act, compute_dtype=compute_dtype)


def expert_capacity(tokens_per_group: int, moe: MoEConfig) -> int:
    cap = int(moe.capacity_factor * tokens_per_group * moe.top_k
              / moe.num_experts)
    return max(cap, moe.top_k, 4)


def _one_hot(idx, n: int, dtype):
    """``idx`` (...) -> (..., n), by comparison on idx's device."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _by_group(fn, args, in_dims, out_dims):
    """``fn(*args)``; on DTensor ``args`` (a mesh) through ``local_map`` on
    each rank's own groups.  ``in_dims`` and ``out_dims`` give each input's
    and output's layout as logical entries after its group dim (dim 0),
    which lies over the data-parallel dims where their extent divides the
    groups, else whole; an entry ``"partial"`` marks an output that is a
    partial sum over 'model'."""
    if not sh.is_sharded(args[0]):
        return fn(*args)
    mesh = args[0].device_mesh
    g = "dp" if args[0].shape[0] % sh.dp_size() == 0 else None

    def place(rest):
        partial = rest == "partial"
        pl = sh.placements(sh.spec(g, *(() if partial else rest)), mesh)
        if partial:
            pl[list(mesh.mesh_dim_names).index(sh.TP_AXIS_NAME)] = Partial()
        return pl
    outs = [place(r) for r in out_dims]
    return local_map(fn, out_placements=tuple(outs) if len(outs) > 1
                     else outs[0],
                     in_placements=tuple(place(r) for r in in_dims),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _top_k(router_probs, moe: MoEConfig):
    """(gates renormalised over the top k, expert indices), each (G, S, K),
    in descending order of probability."""
    gates, idx = torch.topk(router_probs, moe.top_k, dim=-1)
    return _renormalise(gates), idx


def _renormalise(gates):
    """gates (..., K) over their sum, clamped at 1e-9; the K gates are
    summed left to right, as XLA sums them."""
    total = gates[..., 0]
    for kk in range(1, gates.shape[-1]):
        total = total + gates[..., kk]
    return gates / total[..., None].clamp_min(1e-9)


def _positions(onehot, base_count):
    """Position-in-expert of each (token, expert) of one choice: the
    group's running count over the sequence, after ``base_count`` (G, E)
    slots taken by the earlier choices."""
    return torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1 \
        + base_count[:, None, :]


def _top_k_mask(router_probs, moe: MoEConfig, capacity: int):
    """router_probs (G, S, E) -> dispatch (G, S, E, C) bool, combine (G, S,
    E, C) f32: GShard position-in-expert assignment, k slots."""
    G, S, E = router_probs.shape
    gates, idx = _top_k(router_probs, moe)
    dev = router_probs.device
    base_count = torch.zeros((G, E), dtype=torch.int32, device=dev)
    dispatch = torch.zeros((G, S, E, capacity), dtype=torch.bool, device=dev)
    combine = torch.zeros((G, S, E, capacity), dtype=torch.float32,
                          device=dev)
    for kk in range(moe.top_k):
        onehot = _one_hot(idx[..., kk], E, torch.int32)           # (G,S,E)
        pos = _positions(onehot, base_count)
        keep = (pos < capacity) & (onehot > 0)
        # a dropped pair's position is C: it has no slot among the first C
        slot = _one_hot(torch.where(keep, pos, capacity), capacity,
                        torch.float32) * onehot[..., None]
        dispatch |= slot > 0
        combine += slot * gates[..., kk][..., None, None]
        base_count = base_count + onehot.sum(1, dtype=torch.int32)
    return dispatch, combine


def load_balance_loss(router_probs, dispatch):
    """Switch-style aux loss: E * <fraction routed> . <mean prob>."""
    E = router_probs.shape[-1]
    frac = dispatch.any(-1).float().mean((0, 1))
    prob = router_probs.mean((0, 1))
    return E * (frac * prob).sum()


def _top_k_routing(router_probs, moe: MoEConfig, capacity: int):
    """Index form of ``_top_k_mask``'s assignment: expert index, slot, keep
    and gate, each (G, S, K).  The same routing decisions."""
    G, S, E = router_probs.shape
    gates, idx = _top_k(router_probs, moe)
    base_count = torch.zeros((G, E), dtype=torch.int32,
                             device=router_probs.device)
    slots, keeps = [], []
    for kk in range(moe.top_k):
        onehot = _one_hot(idx[..., kk], E, torch.int32)
        pos = _positions(onehot, base_count)
        pos_k = torch.gather(pos, -1, idx[..., kk, None])[..., 0]
        slots.append(pos_k)
        keeps.append(pos_k < capacity)
        base_count = base_count + onehot.sum(1, dtype=torch.int32)
    return idx, torch.stack(slots, -1), torch.stack(keeps, -1), gates


def _gather_routing(router_probs, moe: MoEConfig, capacity: int):
    """The gather mode's routing: (flat slot of each (token, choice), E·C
    where it is dropped; keep; gate; the (G, S, E) share of kept pairs
    each expert takes, the load-balance loss's fraction)."""
    E = router_probs.shape[-1]
    e_idx, slot, keep, gates = _top_k_routing(router_probs, moe, capacity)
    routed = _one_hot(e_idx[..., 0], E, torch.float32) * keep[..., 0, None]
    for kk in range(1, moe.top_k):
        routed = routed + _one_hot(e_idx[..., kk], E, torch.float32) \
            * keep[..., kk, None]
    flat = torch.where(keep, e_idx * capacity + slot, E * capacity)
    return flat, keep, gates, routed


def _scatter_slots(xg, flat, n_slots: int):
    """xg (G, S, d) and flat (G, S, K) -> (G, n_slots + 1, d): each kept
    (token, choice) added into its slot, the dropped ones into the dump
    slot last."""
    G, S, d = xg.shape
    K = flat.shape[-1]
    src = xg[:, :, None, :].expand(G, S, K, d)
    xe = torch.zeros((G, n_slots + 1, d), dtype=xg.dtype, device=xg.device)
    xe.scatter_add_(1, flat.reshape(G, -1, 1).expand(-1, -1, d),
                    src.reshape(G, -1, d))
    return xe


def _combine_slots(ye, flat, keep, gates, capacity: int, by_expert: bool):
    """ye (G, E, C, d) -> (G, S, d): each token's kept slots, weighted by
    their gates.  ``by_expert``: ``ye`` holds this rank's share of the
    experts over 'model' (a local tensor in ``local_map``), and only the
    slots of those experts are combined, a partial sum over 'model'."""
    G, E, C, d = ye.shape
    lo = 0
    if by_expert:
        lo = sh.current_mesh().get_local_rank(sh.TP_AXIS_NAME) * E * C
        keep = keep & (flat >= lo) & (flat < lo + E * C)
    local = torch.where(keep, flat - lo, E * C)
    ye_flat = torch.cat([ye.reshape(G, E * C, d),
                         torch.zeros((G, 1, d), dtype=ye.dtype,
                                     device=ye.device)], dim=1)
    S, K = flat.shape[1], flat.shape[2]
    picked = torch.gather(
        ye_flat, 1, local.reshape(G, -1, 1).expand(-1, -1, d)) \
        .view(G, S, K, d)                                     # (G, S, K, d)
    w = torch.where(keep, gates, 0.0).to(ye.dtype)
    return (picked * w[..., None]).sum(2)


def _experts(p: MoE, xe, act: str):
    """xe (G, E, C, d) -> (G, E, C, d): each expert's FFN over its slots,
    as E batched products of (G·C, d) x (d, f)."""
    G, E, C, d = xe.shape
    w = p.experts
    cdt = xe.dtype
    xs = xe.transpose(0, 1).reshape(E, G * C, d)
    h = torch.bmm(xs, w.w_in.to(cdt))
    if w.w_gate is not None:
        h = L.act_fn(act)(torch.bmm(xs, w.w_gate.to(cdt))) * h
    else:
        h = L.act_fn(act)(h)
    h = sh.constrain(h, "tp", "dp", None)     # (E, G·C, f): gecf's layout
    ye = torch.bmm(h, w.w_out.to(cdt))
    return sh.constrain(ye.view(E, G, C, d).transpose(0, 1),
                        "dp", "tp", None, None)


def moe_ffn(p: MoE, x, moe: MoEConfig, act: str, *, num_groups=None,
            compute_dtype=None, dispatch_mode=None):
    """x (B, S, d) -> (y, aux) with aux = {"lb_loss", "z_loss"}."""
    mode = dispatch_mode or os.environ.get("REPRO_MOE_DISPATCH", "einsum")
    B, S, d = x.shape
    T = B * S
    if num_groups is None:
        tpg = int(os.environ.get("REPRO_MOE_TOKENS_PER_GROUP", "0"))
        num_groups = max(T // tpg, 1) if tpg else B
    G = min(num_groups, T)
    while T % G:
        G -= 1
    xg = sh.constrain(x.reshape(G, T // G, d), "dp", None, None)

    logits = p.router(xg.float())                       # (G, Sg, E) f32
    probs = torch.softmax(logits, dim=-1)
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    E = moe.num_experts
    cap = expert_capacity(T // G, moe)
    cdt = compute_dtype or xg.dtype

    if mode == "gather":
        flat, keep, gates, routed = _by_group(
            lambda p_: _gather_routing(p_, moe, cap), (probs,),
            [(None, None)], [(None, None)] * 4)
        lb = E * (routed.mean((0, 1)) * probs.mean((0, 1))).sum()
        xe = _by_group(lambda x_, f_: _scatter_slots(x_.to(cdt), f_, E * cap),
                       (xg, flat), [(None, None), (None, None)],
                       [(None, None)])
        xe = xe[:, :E * cap].reshape(G, E, cap, d)
    else:
        dispatch, combine = _by_group(
            lambda p_: _top_k_mask(p_, moe, cap), (probs,), [(None, None)],
            [(None, None, None)] * 2)
        lb = load_balance_loss(probs, dispatch)
        disp = dispatch.to(cdt).reshape(G, T // G, E * cap)
        xe = torch.bmm(disp.transpose(1, 2), xg.to(cdt)) \
            .view(G, E, cap, d)                               # gsec,gsd->gecd
    ye = _experts(p, sh.constrain(xe, "dp", "tp", None, None), act)

    if mode == "gather":
        by_expert = sh.is_sharded(ye) and E % sh.tp_size() == 0
        y = _by_group(
            lambda ye_, f_, k_, g_: _combine_slots(ye_, f_, k_, g_, cap,
                                                   by_expert),
            (ye, flat, keep, gates),
            [("tp" if by_expert else None, None, None), (None, None),
             (None, None), (None, None)],
            ["partial" if by_expert else (None, None)])
    else:
        y = torch.bmm(combine.to(cdt).reshape(G, T // G, E * cap),
                      ye.reshape(G, E * cap, d))              # gsec,gecd->gsd
    y = y.reshape(B, S, d)

    for i in range(moe.num_shared_experts):
        y = y + getattr(p, f"shared{i}")(x, compute_dtype)
    return y, {"lb_loss": lb, "z_loss": z_loss}
