"""The port's dispatch-exact cost count (``repro_torch/core/jaxpr_cost.py``)
against the JAX package's ``core/jaxpr_cost.py``, and the hand kernels'
meta path (``kernels/priced.py``) it prices them through.

Everything runs on ``meta`` tensors at reduced widths: no process group,
no real tensor larger than a few kB."""
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import registry as cr
from repro_torch.core import jaxpr_cost as jc
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import flash_attention_bwd as fkb
from repro_torch.kernels import ops
from repro_torch.models import registry as mr
from repro_torch.training import optimizer as opt
from repro_torch.training import step as tstep


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# --- the counterparts of tests/test_jaxpr_cost.py (Python loops for scan) ---

def test_loop_counts_every_iteration():
    def loop(x):
        for _ in range(7):
            x = x @ x
        return x

    c = jc.cost_of(loop, meta(64, 64))
    assert c["flops"] == pytest.approx(7 * 2 * 64 ** 3, rel=1e-6)


def test_dot_general_flops_batched():
    c = jc.cost_of(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                   meta(4, 32, 16), meta(4, 16, 8))
    assert c["flops"] == pytest.approx(2 * 4 * 32 * 8 * 16, rel=1e-6)


def test_nested_loops_compose():
    def inner(x):
        for _ in range(3):
            x = x @ x
        return x

    def outer(x):
        for _ in range(5):
            x = inner(x)
        return x

    c = jc.cost_of(outer, meta(32, 32))
    assert c["flops"] == pytest.approx(15 * 2 * 32 ** 3, rel=1e-6)


def test_transcendentals_tracked():
    c = jc.cost_of(lambda x: torch.exp(x) + torch.tanh(x), meta(100))
    assert c["transcendentals"] == pytest.approx(200)


def test_remat_recompute_counted():
    """The backward of a checkpointed block runs its forward again."""
    def f(x):
        return torch.sum(checkpoint(lambda y: torch.tanh(y @ y), x,
                                    use_reentrant=False))

    x = meta(64, 64, grad=True)
    c_fwd = jc.cost_of(f, x)
    c_grad = jc.cost_of(lambda x: torch.autograd.grad(f(x), [x]), x)
    assert c_grad["flops"] > 2.5 * c_fwd["flops"]


def _train_inputs(cfg, B, S):
    model = mr.build(cfg, device="meta")
    params = tstep.trainable_params(model)
    batch = {"tokens": meta(B, S, dtype=torch.int64),
             "labels": meta(B, S, dtype=torch.int64)}
    if model.needs_ctx():
        batch["ctx"] = meta(B, model.ctx_len(), cfg.d_model,
                            dtype=getattr(torch, cfg.compute_dtype))
    return model, params, opt.init_opt_state(params), batch


def test_train_step_flops_near_6nd():
    """The whole train step on meta: within 4x of 6ND."""
    cfg = cr.reduced("yi-6b", n_layers=2)
    B, S = 8, 128
    model, params, state, batch = _train_inputs(cfg, B, S)
    c = jc.cost_of(tstep.build_train_step(model, opt.AdamWConfig()),
                   params, state, batch)
    nd6 = 6 * cfg.param_count() * B * S
    assert nd6 < c["flops"] < 4 * nd6


# --- conventions ------------------------------------------------------------

def test_fused_bytes_conventions():
    """Layout ops move no fused bytes, pointwise ops their output, products
    and reductions their operands and output; prefusion counts all."""
    x = meta(16, 32)
    assert jc.cost_of(lambda x: x.t().reshape(-1).to(torch.bfloat16),
                      x)["bytes"] == 0
    c = jc.cost_of(lambda x: x * 2.0, x)
    assert c["bytes"] == 16 * 32 * 4
    assert c["bytes_prefusion"] == 2 * 16 * 32 * 4
    assert jc.cost_of(lambda x: x.sum(-1), x)["bytes"] == (16 * 32 + 16) * 4
    assert jc.cost_of(lambda a, b: a @ b, x, meta(32, 8))["bytes"] \
        == (16 * 32 + 32 * 8 + 16 * 8) * 4


# --- the reference's count at reduced configs of every model kind -----------

# the parity shape: B 2 x S 64; xlstm at S 256, two mLSTM chunks of 128
# (below it the chunkwise cell runs one chunk, where the reference's scan
# also differentiates its zero initial state: see PERF.md)
KINDS = (("qwen2-0.5b", 1e-6), ("yi-6b", 1e-6), ("recurrentgemma-2b", 2e-2),
         ("whisper-small", 2e-2), ("llama-3.2-vision-11b", 2e-2),
         ("moonshot-v1-16b-a3b", 2e-2), ("xlstm-1.3b", 2e-2))


@pytest.mark.parametrize("arch,rtol", KINDS, ids=[k[0] for k in KINDS])
def test_products_match_reference(arch, rtol):
    """The train step's matrix-product flops outside the attention call
    equal the JAX package's dot_generals outside its attention call
    (``scripts/torch_cost_parity.py``)."""
    pytest.importorskip("jax")
    from scripts import torch_cost_parity as parity
    n_layers = parity.N_LAYERS.get(arch, 2)
    B, S = 2, 256 if arch == "xlstm-1.3b" else 64
    ref, ref_all = parity.reference(arch, n_layers, B, S)
    c = parity.port(arch, n_layers, B, S)
    assert c.product_flops() == pytest.approx(ref, rel=rtol)
    # the whole count stays near the reference's (its attention forward is
    # unfused jnp, its pointwise ops differ in form)
    assert c.cost.flops == pytest.approx(ref_all["flops"], rel=0.25)


# --- the hand kernels priced on meta ----------------------------------------

def _fwd_formula(B, H, Sq, Skv, hd, config):
    tiles = B * H * -(-Sq // config.bq) * -(-Skv // config.bk)
    return tiles * 4 * config.bq * config.bk * hd


def _bwd_formula(B, H, Sq, Skv, hd, **mask):
    """14 · 64 · 64 · hd a visited (Q tile, KV tile) pair of each (batch,
    head): 8 in the dK/dV kernel and 6 in the dQ kernel, the pairs from
    ``tile_range`` along both axes."""
    T = fkb.TILE
    dkdv = sum(np.subtract(*fkb.tile_range(t, "q", Sq, Skv, **mask)[::-1])
               for t in range(-(-Skv // T)))
    dq = sum(np.subtract(*fkb.tile_range(t, "kv", Sq, Skv, **mask)[::-1])
             for t in range(-(-Sq // T)))
    return B * H * T * T * hd * (8 * dkdv + 6 * dq)


MASKS = (dict(causal=True), dict(causal=True, window=96),
         dict(causal=False), dict(causal=True, q_offset=-64))


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("Sq,Skv", [(256, 256), (200, 328)])
def test_flash_calls_priced_by_visited_tiles(mask, Sq, Skv):
    """Forward: every KV tile (csrc/flash_attention.cu); backward: the
    tiles ``tile_range`` keeps.  Bytes: the call boundary's."""
    B, H, Hkv, hd = 2, 4, 2, 32
    q, o = meta(B, Sq, H, hd), meta(B, Sq, H, hd)
    k, v = meta(B, Skv, Hkv, hd), meta(B, Skv, Hkv, hd)
    lse = meta(B, H, Sq)
    cfg = fk.select_config(Sq, Skv, hd)
    fwd_kw = {k_: v_ for k_, v_ in mask.items() if k_ != "q_offset"}
    with jc.CostCounter() as c:
        out, l = fk.flash_attention_kernel(
            q, k, v, cfg, return_lse=True, q_offset=mask.get("q_offset", 0),
            **fwd_kw)
        grads = fkb.flash_attention_bwd_kernel(q, k, v, o, lse, o, **mask)
    assert out.shape == q.shape and out.is_meta and l.shape == (B, H, Sq)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert c.kernel_calls == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert c.by_op["kernel:flash_attention"].flops == \
        _fwd_formula(B, H, Sq, Skv, hd, cfg)
    assert c.by_op["kernel:flash_attention_bwd"].flops == \
        _bwd_formula(B, H, Sq, Skv, hd, **mask)
    # q, o, do, dq; k, v, dk, dv; lse
    assert c.by_op["kernel:flash_attention_bwd"].bytes == 4 * (
        4 * B * Sq * H * hd + 4 * B * Skv * Hkv * hd + B * H * Sq)
    assert c.by_op["kernel:flash_attention"].bytes == 4 * (
        2 * B * Sq * H * hd + 2 * B * Skv * Hkv * hd + B * H * Sq)


def test_train_step_flash_calls():
    """Remat runs each layer's flash forward again in the backward: two
    forward calls and one backward a layer, each priced alike."""
    cfg = cr.reduced("qwen2-0.5b", n_layers=2)
    B, S = 2, 64
    model, params, state, batch = _train_inputs(cfg, B, S)
    c = jc.count(tstep.build_train_step(model, opt.AdamWConfig(), remat=True),
                 params, state, batch)
    assert c.kernel_calls == {"flash_attention": 4, "flash_attention_bwd": 2}
    H, hd = cfg.n_heads, cfg.head_dim
    assert c.by_op["kernel:flash_attention"].flops == 4 * _fwd_formula(
        B, H, S, S, hd, fk.select_config(S, S, hd))
    assert c.by_op["kernel:flash_attention_bwd"].flops == 2 * _bwd_formula(
        B, H, S, S, hd, causal=True)


def test_meta_path_moves_no_counter_and_cpu_path_unchanged():
    """Meta calls launch nothing (the counters stay put) and run no plain
    version; CPU tensors still take the plain version, bit for bit; a mix
    of devices raises."""
    launches = (fk.flash_attention_kernel.launches,
                fkb.flash_attention_bwd_kernel.launches)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 48, 4, 16), generator=gen) for _ in range(3))
    cfg = fk.select_config(48, 48, 16)
    want = fk.flash_attention_plain(q, k, v, cfg, causal=True)
    assert torch.equal(fk.flash_attention_kernel(q, k, v, cfg), want)
    o, lse = fk.flash_attention_plain(q, k, v, cfg, return_lse=True)
    do = torch.randn(o.shape, generator=gen)
    got = fkb.flash_attention_bwd_kernel(q, k, v, o, lse, do)
    ref = fkb.flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))

    plain = fk.flash_attention_plain
    fk.flash_attention_plain = None       # a meta call must not reach it
    try:
        qm, km, vm = (meta(2, 48, 4, 16, grad=True) for _ in range(3))
        out = ops.flash_attention(qm, km, vm)
        torch.autograd.grad(out.sum(), [qm, km, vm])
    finally:
        fk.flash_attention_plain = plain
    assert (fk.flash_attention_kernel.launches,
            fkb.flash_attention_bwd_kernel.launches) == launches
    with pytest.raises(ValueError):
        fk.flash_attention_kernel(q, meta(2, 48, 4, 16), v, cfg)
    with pytest.raises(ValueError):
        fkb.flash_attention_bwd_kernel(q, k, v, o, lse, meta(*do.shape))


def test_build_on_meta_draws_nothing(monkeypatch):
    """``build(cfg, device="meta")`` makes every parameter on meta and
    never makes a generator; ``dtype`` casts as ``cast_weights_`` does."""
    from repro_torch.core.device import resolve

    class Refuse(torch.Generator):
        def __new__(cls, *a, **k):
            raise AssertionError("build drew on meta")

    monkeypatch.setattr(torch, "Generator", Refuse)
    assert resolve("meta") == torch.device("meta")
    cfg = cr.reduced("qwen2-0.5b")
    model = mr.build(cfg, device="meta", dtype=torch.bfloat16)
    assert all(p.is_meta for p in model.parameters())
    assert model.blocks[0].attn.wq.w.dtype == torch.bfloat16
    assert model.blocks[0].ln1.scale.dtype == torch.float32
    cache = model.init_cache(2, 32)
    assert all(t.is_meta for t in cache.tensors())
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()


def test_cost_module_unchanged():
    """``core/cost.py::cost_of`` (the memory model's calibration features)
    still counts its own convention: every op's operands and outputs."""
    from repro_torch.core import cost
    f = cost.cost_of(lambda x: (x * 2.0).sum(), ((16, 32), torch.float32))
    assert f == {"bytes": (16 * 32 * 2 + 16 * 32 + 1) * 4.0,
                 "flops": 16 * 32 + 1.0, "transcendentals": 0.0}
