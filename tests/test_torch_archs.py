"""The three dense archs of ``chip_smoke.py``'s phase ``archs`` against the
JAX package, at the geometries that phase brings to the flash kernel:

* gemma-7b reduced at ``head_dim=256`` (MHA, GeGLU, tied embeddings): the
  causal hd-256 flash over every KV head;
* starcoder2-15b reduced (48 query heads over 4: a GQA group of 12, QKV
  bias, a GELU MLP);
* llama-3.2-vision-11b reduced at ``head_dim=128`` with a 101-position
  context, ragged against both flash tiles (64 + 37 keys), non-causal
  cross attention with a GQA group of 4.  Its depth is one block-pattern
  period (5 layers): the cross-attention layer is the fifth.

Weights: the JAX parameter tree from a seed, biases and norm scales
perturbed with numpy, given to both sides (``convert.from_jax_params``);
tokens and context from numpy seeds.  f32 on both sides; the forward, the
prefill and two decode steps within atol / rtol 1e-4, the tolerance of
``tests/test_torch_models.py`` and ``tests/test_torch_decode.py``: both
sides compute in f32 and differ only in the order of sums."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jcr  # noqa: E402
from repro.models import registry as jmr  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import opgraph as tog  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
GEOMETRIES = {
    "gemma-7b-hd256": lambda m: dataclasses.replace(
        m.reduced("gemma-7b", n_layers=2), head_dim=256),
    "starcoder2-15b-gqa12": lambda m: m.reduced("starcoder2-15b",
                                                n_layers=2),
    "llama-3.2-vision-hd128-ctx101": lambda m: dataclasses.replace(
        m.reduced("llama-3.2-vision-11b"), head_dim=128,
        cross_attn_context_len=101)}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _both(name):
    """(JAX model, its parameters, the port's model on the same weights)."""
    jcfg, tcfg = _f32(GEOMETRIES[name](jcr)), _f32(GEOMETRIES[name](tcr))
    params = jmr.build(jcfg).init(jax.random.key(0))
    rng = np.random.default_rng(0)

    def perturb(path, x):
        x = np.asarray(x, np.float32)
        leaf = jax.tree_util.keystr(path)
        if "'b'" in leaf or "'scale'" in leaf:
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    params = jax.tree_util.tree_map_with_path(perturb, params)
    return (jmr.build(jcfg), jax.tree.map(jnp.asarray, params),
            convert.from_jax_params(params, tcfg, device="cpu"))


def _ctx(jmodel, batch):
    """A numpy context for a model that takes one, as (JAX, torch)."""
    if not jmodel.needs_ctx():
        return None, None
    ctx = np.random.default_rng(4).standard_normal(
        (batch, jmodel.ctx_len(), jmodel.cfg.d_model)).astype(np.float32)
    return jnp.asarray(ctx), torch.from_numpy(ctx)


def test_geometries_are_the_ones_named():
    g, s, v = (_f32(GEOMETRIES[n](tcr)) for n in (
        "gemma-7b-hd256", "starcoder2-15b-gqa12",
        "llama-3.2-vision-hd128-ctx101"))
    assert (g.head_dim, g.n_heads, g.n_kv_heads, g.mlp_act,
            g.tie_embeddings) == (256, 4, 4, "geglu", True)
    assert (s.n_heads // s.n_kv_heads, s.head_dim, s.qkv_bias,
            s.mlp_act) == (12, 16, True, "gelu")
    assert (v.head_dim, v.n_heads // v.n_kv_heads, v.cross_attn_context_len,
            v.layer_kinds[-1]) == (128, 4, 101, "cross_attn")
    # the full configs' cross call: its last KV tile holds one key
    assert fk.select_config(512, 1601, 128) == fk.FlashConfig(64, 64)
    assert 1601 % 64 == 1 and 101 % 64 == 37


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_forward_matches_jax(name):
    jmodel, jparams, model = _both(name)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jmodel.cfg.vocab_size, (2, 75))  # ragged: 64 + 11
    jctx, tctx = _ctx(jmodel, 2)
    jlogits, _ = jmodel.forward(jparams, jnp.asarray(tokens), ctx_embed=jctx)
    fk.flash_attention_kernel.launches = 0
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens), ctx_embed=tctx)
    assert fk.flash_attention_kernel.launches == 0       # CPU: plain version
    assert logits.shape == (2, 75, tL.pad_vocab(jmodel.cfg.vocab_size))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_prefill_and_two_decode_steps_match_jax(name):
    jmodel, jparams, model = _both(name)
    B, S = 2, 67
    tokens = np.random.default_rng(2).integers(0, jmodel.cfg.vocab_size,
                                               (B, S + 2))
    jctx, tctx = _ctx(jmodel, B)
    jlg, jcache = jmodel.prefill(jparams, jnp.asarray(tokens[:, :S]),
                                 ctx_embed=jctx, max_len=S + 2)
    with torch.no_grad():
        lg, cache = model.prefill(torch.from_numpy(tokens[:, :S]),
                                  ctx_embed=tctx, max_len=S + 2)
    # the cache holds what the predictor prices, cross K/V included
    assert cache.nbytes == tog.kv_cache_bytes(model.cfg, B, S + 2, "float32")
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    for t in range(2):
        jlg, jcache = jmodel.decode_step(jparams,
                                         jnp.asarray(tokens[:, S + t]), jcache)
        with torch.no_grad():
            lg, cache = model.decode_step(torch.from_numpy(tokens[:, S + t]),
                                          cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    assert int(cache.pos) == int(jcache["pos"]) == S + 2
