"""The port's dense forward pass against the JAX package's on the same
weights: the JAX parameter tree (made by ``repro.models`` from a seed, then
perturbed with numpy so biases and norm scales are not trivial) goes to
both sides as numpy arrays (``models/convert.py``).

A model that takes a context (whisper-small's encoder frames,
llama-3.2-vision's patches) gets the same numpy context on both sides.

Tolerance: f32 logits within atol 1e-4 / rtol 1e-4.  Both sides compute in
f32; they differ only in summation order (XLA's dots and KV blocks of 256
against torch's matmuls and the port's flash tiles)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jcr  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import registry as jmr  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import registry as tmr  # noqa: E402
from repro_torch.models.transformer import cast_weights_  # noqa: E402

CASES = {"qwen2-0.5b-reduced": lambda m: m.reduced("qwen2-0.5b", n_layers=2),
         "qwen3-mini": lambda m: m.get_any("qwen3-mini"),
         "recurrentgemma-2b-reduced": lambda m: m.reduced("recurrentgemma-2b",
                                                          n_layers=5),
         "xlstm-1.3b-reduced": lambda m: m.reduced("xlstm-1.3b"),
         "whisper-small-reduced": lambda m: m.reduced("whisper-small"),
         "gemma-7b-reduced": lambda m: m.reduced("gemma-7b", n_layers=2),
         "starcoder2-15b-reduced": lambda m: m.reduced("starcoder2-15b",
                                                       n_layers=2),
         "llama-3.2-vision-reduced": lambda m: m.reduced(
             "llama-3.2-vision-11b")}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _params_np(jcfg, seed=0):
    params = jmr.build(jcfg).init(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x, np.float32)
        leaf = jax.tree_util.keystr(path)
        if "'b'" in leaf or "'scale'" in leaf:
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    jcfg = _f32(CASES[name](jcr))
    tcfg = _f32(CASES[name](tcr))
    params = _params_np(jcfg)
    jmodel = jmr.build(jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64))
    ctx = rng.standard_normal((2, jmodel.ctx_len(), jcfg.d_model)).astype(
        np.float32) if jmodel.needs_ctx() else None
    jlogits, _ = jmodel.forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
        ctx_embed=None if ctx is None else jnp.asarray(ctx))
    model = convert.from_jax_params(params, tcfg, device="cpu")
    assert model.needs_ctx() == jmodel.needs_ctx()
    fk.flash_attention_kernel.launches = 0
    with torch.no_grad():
        tlogits = model(torch.from_numpy(tokens), ctx_embed=None if ctx is None
                        else torch.from_numpy(ctx))
    assert fk.flash_attention_kernel.launches == 0       # CPU: plain version
    assert tlogits.shape == jlogits.shape == (2, 64, tL.pad_vocab(
        jcfg.vocab_size))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


def test_convert_keeps_jax_layout_and_every_leaf():
    jcfg = _f32(CASES["qwen2-0.5b-reduced"](jcr))
    params = _params_np(jcfg)
    model = convert.from_jax_params(params, _f32(CASES["qwen2-0.5b-reduced"](
        tcr)), device="cpu")
    wq = params["blocks"]["sub0"]["attn"]["wq"]
    np.testing.assert_array_equal(model.blocks[1].attn.wq.w.numpy(), wq["w"][1])
    np.testing.assert_array_equal(model.blocks[0].attn.wq.b.numpy(), wq["b"][0])
    n_np = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_np == sum(p.numel() for p in model.parameters())
    assert n_np == jmr.build(jcfg).count_params()


def test_build_from_seed_is_deterministic_and_finite():
    cfg = _f32(tcr.reduced("qwen2-0.5b", n_layers=2))
    a, b = tmr.build(cfg, device="cpu", seed=3), tmr.build(cfg, device="cpu",
                                                          seed=3)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not all(torch.equal(pa, pc) for pa, pc in zip(
        a.parameters(), tmr.build(cfg, device="cpu", seed=4).parameters()))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = a(tokens)
    assert torch.isfinite(out).all() and out.shape == (2, 16, a.padded_vocab)


def test_bf16_weights_cast_once_match_per_call_cast():
    """``cast_weights_`` stores the weights in bf16; the logits equal those
    of casting on every call (the JAX package's way)."""
    cfg = tcr.reduced("qwen2-0.5b", n_layers=2)       # compute dtype bf16
    model = tmr.build(cfg, device="cpu", seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 32),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        per_call = model(tokens)
        cast_weights_(model, torch.bfloat16)
        once = model(tokens)
    assert once.dtype == torch.bfloat16
    assert torch.equal(per_call, once)


def test_unported_block_kinds_raise():
    """Every block kind of every config is ported (xlstm-1.3b's mLSTM and
    sLSTM since the xLSTM slice); a kind outside ``PORTED`` still
    raises."""
    for name in ("xlstm-1.3b",):
        model = tmr.build(tcr.reduced(name), device="cpu")
        assert {b.kind for b in model.blocks} == {"mlstm", "slstm"}
    with pytest.raises(NotImplementedError, match="no port"):
        tmr.build(dataclasses.replace(tcr.reduced("qwen2-0.5b"),
                                      block_pattern=("conv_mixer",)),
                  device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tmr.build(tcr.reduced("qwen2-0.5b"), device="cuda")
    with pytest.raises(RuntimeError):     # the card is the default
        convert.from_jax_params({}, tcr.reduced("qwen2-0.5b"))


def test_attention_block_matches_jax():
    """The model's attention path (projections with QKV bias, RoPE, GQA
    flash attention, output projection) against ``attn_forward``."""
    cfg = _f32(tcr.reduced("qwen2-0.5b"))
    rng = np.random.default_rng(7)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d)}
    p = {n: {"w": (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)}
         for n, s in shapes.items()}
    for n in ("wq", "wk", "wv"):
        p[n]["b"] = rng.standard_normal(shapes[n][1]).astype(np.float32)
    x = rng.standard_normal((2, 40, d)).astype(np.float32)
    want, _ = jA.attn_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              cfg, jA.AttnSpec(causal=True))
    attn = tA.Attention(cfg)
    attn.load_state_dict({f"{n}.{k}": torch.from_numpy(v)
                          for n, leaf in p.items() for k, v in leaf.items()})
    with torch.no_grad():
        got, _ = attn(torch.from_numpy(x), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32])
def test_rope_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 33, 4, 16)).astype(dtype)
    pos = np.arange(33)[None, :] + 7
    want = jA.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(tA.rope_freqs(16, 1e4).numpy(),
                               np.asarray(jA.rope_freqs(16, 1e4)), rtol=1e-6)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 7, 48)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    want = jL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    norm = tL.RMSNorm(48)
    norm.scale.data = torch.from_numpy(scale)
    got = norm(torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)
    got16 = norm(torch.from_numpy(x).to(torch.bfloat16), 1e-6)
    assert got16.dtype == torch.bfloat16          # f32 inside, cast back
