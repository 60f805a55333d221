"""The port's MoE model kind (``models/moe.py``: capacity-dispatch experts)
against the JAX package's ``models/moe.py``, on the same numpy weights and
inputs from a seed, and the reduced ``moonshot-v1-16b-a3b`` (64 experts
top-6 and 2 shared, cut to 8 experts top-2 and 1 shared, d 64) and
``llama4-scout-17b-16e`` (16 experts top-1 and 1 shared, cut to 8, GQA
group 5, d 320) through ``convert.from_jax_params``.  No test here builds
a full-width config.

Tolerances:
- capacities, routing decisions (dispatch masks, expert indices, slots,
  keeps), parameter counts: equal.
- combine weights and gates: atol 1e-7 (both sides take the same f32
  top-k probabilities and divide by the same f32 sum).
- ``load_balance_loss`` and ``lb_loss``: atol 1e-6; ``z_loss``: rtol 1e-6
  (f32 means in another order).
- ``moe_ffn``'s ``y`` in f32: atol 1e-5 (f32 products and sums in another
  order, below 2e-6 recorded); in bf16: 4 · 2^-8 · max|y| (each side rounds
  the expert products, the gated activation, the combine and the shared
  experts' output to bf16, at unit roundoff 2^-8, in other places).
- the two dispatch modes of the port: f32 within atol 1e-6, the JAX
  package's own limit (``tests/test_moe.py``), since a top-k > 1 combine
  sums its K terms in another order; at top-1 equal, bit for bit, in both
  dtypes.
- the reduced models' f32 forward, prefill and decode logits: atol 1e-4
  / rtol 1e-4, the dense forward's (``tests/test_torch_models.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jC  # noqa: E402
from repro.configs import registry as jcr  # noqa: E402
from repro.models import moe as jM  # noqa: E402
from repro.models import registry as jmr  # noqa: E402
from repro_torch.configs import base as tC  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.models import registry as tmr  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

MODELS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-16e")


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _moe_cfgs(E, top_k, cf=1.25, d_ff=32, shared=1):
    kw = dict(num_experts=E, top_k=top_k, d_ff_expert=d_ff,
              num_shared_experts=shared, capacity_factor=cf)
    return jC.MoEConfig(**kw), tC.MoEConfig(**kw)


def _probs(G, S, E, seed=0, skew=2.0):
    """Router probabilities (G, S, E) f32, skewed toward the low experts
    so that capacity 1.25 drops pairs."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((G, S, E)) - skew * np.linspace(0, 1, E)
    p = np.exp(logits)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _moe_pair(E, top_k, d=16, d_ff=32, shared=1, act="silu", seed=0):
    """The JAX package's MoE parameters (numpy) and the port's ``MoE``
    holding them."""
    jm, tm = _moe_cfgs(E, top_k, d_ff=d_ff, shared=shared)
    p = jax.tree.map(np.asarray, jM.init_moe(jax.random.key(seed), d, jm, act))
    mod = tM.MoE(d, tm, act)
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         convert._flatten(p).items()}, strict=True)
    return jm, tm, p, mod


# ----- capacity and routing -----

@pytest.mark.parametrize("no_drop", [False, True])
def test_expert_capacity_matches_jax(no_drop):
    for E in (2, 8, 16, 64):
        for top_k in (1, 2, 6):
            if top_k > E:
                continue
            cf = E / top_k + 1.0 if no_drop else 1.25
            jm, tm = _moe_cfgs(E, top_k, cf)
            for S in (1, 4, 12, 64, 96, 512):
                assert tM.expert_capacity(S, tm) == jM.expert_capacity(S, jm)
                if no_drop:       # every token fits: reduced()'s capacity
                    assert tM.expert_capacity(S, tm) >= S


@pytest.mark.parametrize("E,top_k,S", [(8, 2, 48), (16, 1, 64), (64, 6, 96)])
def test_top_k_mask_matches_jax(E, top_k, S):
    jm, tm = _moe_cfgs(E, top_k)
    probs = _probs(2, S, E)
    cap = jM.expert_capacity(S, jm)
    jd, jc = jM._top_k_mask(jnp.asarray(probs), jm, cap)
    td, tc = tM._top_k_mask(torch.from_numpy(probs), tm, cap)
    assert td.dtype == torch.bool and tc.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-7, rtol=0)
    # capacity 1.25 drops pairs here: fewer slots taken than (token, choice)
    assert int(td.sum()) < 2 * S * top_k


@pytest.mark.parametrize("E,top_k,S", [(8, 2, 48), (16, 1, 64), (64, 6, 96)])
def test_top_k_routing_matches_jax(E, top_k, S):
    jm, tm = _moe_cfgs(E, top_k)
    probs = _probs(2, S, E, seed=1)
    cap = jM.expert_capacity(S, jm)
    want = jM._top_k_routing(jnp.asarray(probs), jm, cap)
    got = tM._top_k_routing(torch.from_numpy(probs), tm, cap)
    for name, g, w in zip(("expert index", "slot", "keep"), got[:3],
                          want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               atol=1e-7, rtol=0)
    keep, slot = got[2].numpy(), got[1].numpy()
    assert not keep.all() and keep.any()          # some pairs are dropped
    assert (slot[keep] < cap).all() and (slot[~keep] >= cap).all()


def test_top_k_is_in_descending_order_with_clamped_renormalised_gates():
    _, tm = _moe_cfgs(8, 3)
    probs = torch.from_numpy(_probs(1, 5, 8))
    gates, idx = tM._top_k(probs, tm)
    raw = torch.gather(probs, -1, idx)
    assert (raw[..., :-1] >= raw[..., 1:]).all()
    torch.testing.assert_close(gates, raw / raw.sum(-1, keepdim=True))
    zero, _ = tM._top_k(torch.zeros(1, 1, 8), tm)
    assert torch.equal(zero, torch.zeros(1, 1, 3))    # the 1e-9 clamp


def test_load_balance_loss_matches_jax():
    jm, tm = _moe_cfgs(8, 2)
    probs = _probs(3, 40, 8, seed=2)
    cap = jM.expert_capacity(40, jm)
    jd, _ = jM._top_k_mask(jnp.asarray(probs), jm, cap)
    want = jM.load_balance_loss(jnp.asarray(probs), jd)
    got = tM.load_balance_loss(torch.from_numpy(probs),
                               torch.from_numpy(np.array(jd)))
    assert abs(float(got) - float(want)) <= 1e-6


# ----- moe_ffn -----

@pytest.mark.parametrize("mode", ["einsum", "gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,top_k,shared", [(8, 2, 1), (64, 6, 2),
                                            (16, 1, 1)])
def test_moe_ffn_matches_jax(mode, dtype, E, top_k, shared):
    jm, tm, p, mod = _moe_pair(E, top_k, shared=shared)
    x = np.random.default_rng(3).standard_normal((3, 24, 16)).astype(
        np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jaux = jM.moe_ffn(jax.tree.map(jnp.asarray, p),
                          jnp.asarray(x).astype(jdt), jm, "silu",
                          compute_dtype=jdt, dispatch_mode=mode)
    with torch.no_grad():
        ty, taux = tM.moe_ffn(mod, torch.from_numpy(x).to(tdt), tm, "silu",
                              compute_dtype=tdt, dispatch_mode=mode)
    assert ty.dtype == tdt and ty.shape == (3, 24, 16)
    want = np.asarray(jy.astype(jnp.float32))
    atol = 1e-5 if dtype == "float32" else 4 * 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(ty.float().numpy(), want, atol=atol, rtol=0)
    assert abs(float(taux["lb_loss"]) - float(jaux["lb_loss"])) <= 1e-6
    np.testing.assert_allclose(float(taux["z_loss"]), float(jaux["z_loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,top_k", [(8, 2), (16, 1)])
def test_dispatch_modes_agree(dtype, E, top_k, monkeypatch):
    """The default mode is ``einsum``; ``REPRO_MOE_DISPATCH`` picks, as the
    JAX package reads it.  At top-1 the modes are equal bit for bit (each
    token's output is one product); above, f32 within 1e-6."""
    _, tm, _, mod = _moe_pair(E, top_k)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 24, 16)).astype(np.float32)).to(tdt)
    with torch.no_grad():
        y1, a1 = tM.moe_ffn(mod, x, tm, "silu", compute_dtype=tdt)
        monkeypatch.setenv("REPRO_MOE_DISPATCH", "gather")
        y2, a2 = tM.moe_ffn(mod, x, tm, "silu", compute_dtype=tdt)
        monkeypatch.setenv("REPRO_MOE_DISPATCH", "einsum")
        assert torch.equal(y1, tM.moe_ffn(mod, x, tm, "silu",
                                          compute_dtype=tdt)[0])
    assert float(a1["lb_loss"]) == pytest.approx(float(a2["lb_loss"]),
                                                 abs=1e-6)
    if top_k == 1:
        assert torch.equal(y1, y2)
    elif dtype == "float32":
        torch.testing.assert_close(y1, y2, atol=1e-6, rtol=0)


@pytest.mark.parametrize("tpg,groups", [(0, 3), (8, 9), (72, 1)])
def test_groups_follow_tokens_per_group(tpg, groups, monkeypatch):
    """One group a batch row by default; ``REPRO_MOE_TOKENS_PER_GROUP``
    sets tokens a group, as in the JAX package: the capacity (and so what
    is dropped) follows the group."""
    jm, tm, p, mod = _moe_pair(8, 2)
    x = np.random.default_rng(5).standard_normal((3, 24, 16)).astype(
        np.float32)
    monkeypatch.setenv("REPRO_MOE_TOKENS_PER_GROUP", str(tpg))
    jy, _ = jM.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jm,
                       "silu")
    with torch.no_grad():
        ty, _ = tM.moe_ffn(mod, torch.from_numpy(x), tm, "silu")
        g, _ = tM.moe_ffn(mod, torch.from_numpy(x), tm, "silu",
                          num_groups=groups)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    assert torch.equal(ty, g)


class _Ops(TorchDispatchMode):
    """Every op dispatched, and the largest output it made."""

    def __init__(self):
        super().__init__()
        self.names, self.largest = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.names.append(func.__name__)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("mode", ["einsum", "gather"])
def test_expert_products_never_broadcast_the_weights(mode):
    """(G, E, C, d) x (E, d, f) runs as E products of (G·C, d) x (d, f):
    no op makes a tensor the size of the weights repeated over the
    groups (a broadcasting matmul would, G-fold)."""
    E, d, f, G = 8, 64, 128, 4
    _, tm, _, mod = _moe_pair(E, 2, d=d, d_ff=f, shared=0)
    x = torch.randn(G, 12, d, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), _Ops() as ops:
        tM.moe_ffn(mod, x, tm, "silu", dispatch_mode=mode)
    assert ops.largest <= E * d * f < G * E * d * f
    assert "bmm.default" in ops.names


# ----- the modules: cast, convert, build -----

def test_cast_weights_keeps_the_router_f32_and_casts_the_experts():
    model = tT.cast_weights_(tmr.build(tcr.reduced("moonshot-v1-16b-a3b"),
                                       device="cpu", seed=0), torch.bfloat16)
    moe = model.blocks[0].moe
    assert model.blocks[0].mlp is None
    assert moe.router.w.dtype == torch.float32
    assert all(w.dtype == torch.bfloat16 for w in (
        moe.experts.w_in, moe.experts.w_out, moe.experts.w_gate,
        moe.shared0.w_in.w))
    assert model.blocks[0].ln2.scale.dtype == torch.float32


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["qwen2-0.5b", "moonshot-v1-16b-a3b",
                                  "whisper-small"])
def test_build_in_a_dtype_equals_build_then_cast(name, dtype):
    """``build(dtype=)`` draws and casts one part at a time: the same
    weights, bit for bit and in the same dtypes, as a whole model made on
    the device in f32, drawn by ``reset`` and cast (``cast_weights_``)."""
    cfg = tcr.reduced(name)
    want = tT.Transformer(cfg, device=torch.device("cpu"))
    want.reset(torch.Generator().manual_seed(3))
    if dtype is not None:
        tT.cast_weights_(want, dtype)
    got = tmr.build(cfg, device="cpu", seed=3, dtype=dtype)
    sw, sg = want.state_dict(), got.state_dict()
    assert list(sg) == list(sw)
    for k in sw:
        assert sg[k].dtype == sw[k].dtype and torch.equal(sg[k], sw[k]), k
    assert not any(t.is_meta for t in (*got.parameters(), *got.buffers()))
    assert got.cfg is cfg


def test_build_from_seed_draws_the_reference_distributions():
    """Experts normal / sqrt(fan_in): w_in and w_gate 1/sqrt(d), w_out
    1/sqrt(f) (the JAX ``_init_w``'s fan-in is ``shape[-2]``)."""
    cfg = dataclasses.replace(tcr.reduced("moonshot-v1-16b-a3b"),
                              d_model=128)
    moe = tmr.build(cfg, device="cpu", seed=0).blocks[0].moe
    f = cfg.moe.d_ff_expert
    for w, fan_in in ((moe.experts.w_in, 128), (moe.experts.w_gate, 128),
                      (moe.experts.w_out, f), (moe.router.w, 128)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.05


def _params_np(jcfg, seed=0):
    """JAX parameters from a seed, norm scales perturbed with numpy."""
    params = jmr.build(jcfg).init(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x, np.float32)
        if "'scale'" in jax.tree_util.keystr(path):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module", params=MODELS)
def both(request):
    jcfg = _f32(jcr.reduced(request.param))
    tcfg = _f32(tcr.reduced(request.param))
    params = _params_np(jcfg)
    return (jcfg, jmr.build(jcfg), jax.tree.map(jnp.asarray, params), tcfg,
            params, convert.from_jax_params(params, tcfg, device="cpu"))


def test_convert_maps_every_moe_leaf(both):
    jcfg, jmodel, _, tcfg, params, model = both
    sub = params["blocks"]["sub0"]
    np.testing.assert_array_equal(model.blocks[1].moe.experts.w_in.numpy(),
                                  sub["moe"]["experts"]["w_in"][1])
    np.testing.assert_array_equal(model.blocks[0].moe.router.w.numpy(),
                                  sub["moe"]["router"]["w"][0])
    n_np = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_np == sum(p.numel() for p in model.parameters())
    assert n_np == jmodel.count_params()
    assert all(blk.mlp is None for blk in model.blocks)


def test_forward_matches_jax(both):
    jcfg, jmodel, jparams, _, _, model = both
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 48))
    jlogits, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    fk.flash_attention_kernel.launches = 0
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert fk.flash_attention_kernel.launches == 0       # CPU: plain version
    assert got.shape == (2, 48, tL.pad_vocab(jcfg.vocab_size))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), atol=1e-4,
                               rtol=1e-4)


def test_prefill_and_decode_steps_match_jax(both):
    """The prefill routes each row's prompt as a group; each decode step
    routes each row's one token as a group of its own."""
    jcfg, jmodel, jparams, _, _, model = both
    B, S, n = 2, 12, 3
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S + n))
    jlg, jcache = jmodel.prefill(jparams, jnp.asarray(tokens[:, :S]))
    with torch.no_grad():
        lg, cache = model.prefill(torch.from_numpy(tokens[:, :S]))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=1e-4)
    for t in range(n):
        jlg, jcache = jmodel.decode_step(jparams,
                                         jnp.asarray(tokens[:, S + t]), jcache)
        with torch.no_grad():
            lg, cache = model.decode_step(torch.from_numpy(tokens[:, S + t]),
                                          cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=1e-4)


def test_decode_step_reads_nothing_on_the_host(both):
    """No op of an MoE decode step returns a value to the host (one-hot
    by comparison, not ``F.one_hot``'s range check), so the step can be
    captured as a CUDA graph on the card."""
    jcfg, _, _, _, _, model = both
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 9)))
    with torch.no_grad():
        _, cache = model.prefill(tokens[:, :8])
        with _Ops() as ops:
            model.decode_step(tokens[:, 8], cache)
    assert "_local_scalar_dense.default" not in ops.names
    assert "topk.default" in ops.names


def test_serve_launcher_moonshot_on_the_cpu(capsys):
    args = serve.parse_args(["--arch", "moonshot-v1-16b-a3b", "--reduced",
                             "--requests", "3", "--prompt-len", "8",
                             "--max-new", "3", "--max-batch", "2",
                             "--device", "cpu"])
    engine, done = serve.serve(args)
    assert [len(r.out_tokens) for r in done] == [3, 3, 3]
    assert engine.stats.prefills == 2 and engine.stats.decode_steps == 4
    model = engine.model
    assert model.blocks[0].moe is not None
    for wave in (done[:2], done[2:]):
        toks = torch.from_numpy(np.stack([r.prompt for r in wave])).long()
        with torch.no_grad():
            logits, cache = model.prefill(toks, max_len=engine.max_len)
            out = [logits[:, :model.cfg.vocab_size].argmax(-1)]
            for _ in range(2):
                logits, _ = model.decode_step(out[-1], cache)
                out.append(logits[:, :model.cfg.vocab_size].argmax(-1))
        assert [r.out_tokens for r in wave] == torch.stack(out, 1).tolist()
    serve.summary(engine, done, verbose=True)
    assert "[serve] arch=moonshot-v1-16b-a3b-reduced reqs=3" in \
        capsys.readouterr().out


def test_serve_launcher_bf16_builds_moonshot_in_its_dtype():
    args = serve.parse_args(["--arch", "moonshot-v1-16b-a3b", "--reduced",
                             "--requests", "2", "--prompt-len", "6",
                             "--max-new", "2", "--compute-dtype", "bfloat16",
                             "--device", "cpu"])
    engine, done = serve.serve(args)
    moe = engine.model.blocks[0].moe
    assert moe.experts.w_in.dtype == torch.bfloat16
    assert moe.router.w.dtype == torch.float32
    assert [len(r.out_tokens) for r in done] == [2, 2]


def test_serve_moonshot_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        serve.run(serve.parse_args(["--arch", "moonshot-v1-16b-a3b",
                                    "--reduced"]))
