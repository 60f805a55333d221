"""The port's training slice on the dense archs of ``chip_smoke.py``'s phase
``archs`` and the two registry archs no other training test holds, against
the JAX package's on the same numpy weights (``convert.from_jax_params``),
batches and contexts, on the CPU: ``loss_fn``'s value, metrics and
gradients in both cross-entropy modes, and the launcher on the vision
model (``tests/test_torch_training_archs_others.py``: ``loss_fn`` on yi-6b
and llama4-scout-17b-16e; ``tests/test_torch_training_archs_steps.py`` and
``tests/test_torch_training_archs_others_steps.py``: three AdamW steps of
the three and of the two; the files split so that each runs alone in
well under a minute).

The reduced configs, at the geometries of ``tests/test_torch_archs.py``:
- gemma-7b at 2 layers and ``head_dim=256`` (MHA: 4 KV heads of 256,
  GeGLU, a tied embedding scaled by sqrt(d));
- starcoder2-15b at 2 layers (48 query heads over 4: a GQA group of 12,
  QKV biases, a GELU MLP);
- llama-3.2-vision-11b at ``head_dim=128`` over a 101-position context
  (64 + 37 keys: a ragged last tile), one block-pattern period (5 layers)
  so that its cross-attention layer, non-causal with a GQA group of 4, is
  in;
- yi-6b (GQA 8) and llama4-scout-17b-16e (MoE, top-1 with a shared
  expert) as ``reduced`` makes them, so that every registry arch's
  training is held.

Tolerances: ``tests/_torch_train_common.py`` (gradients atol 1e-5 / rtol
1e-3); losses and metrics rtol 1e-5, the aux losses atol 1e-6 besides, as
``tests/test_torch_training_kinds.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.training import objective as jobj  # noqa: E402
from repro_torch.configs import base as C  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import objective as tobj  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402
from tests import _torch_train_common as common  # noqa: E402

# name: (layers, S, config changes)
ARCHS = {
    "gemma-7b": (2, 32, dict(head_dim=256)),
    "starcoder2-15b": (2, 32, {}),
    "llama-3.2-vision-11b": (None, 32, dict(head_dim=128,
                                            cross_attn_context_len=101)),
    "yi-6b": (2, 32, {}),
    "llama4-scout-17b-16e": (2, 32, {}),
}
# the three whose training runs on the card (``chip_smoke.py``'s phase
# ``train``)
DENSE = ("gemma-7b", "starcoder2-15b", "llama-3.2-vision-11b")


def _setup(name, B=2, seed=0):
    layers, S, changes = ARCHS[name]
    return common.setup(name, layers, B=B, S=S, seed=seed, **changes)


def test_reduced_configs_hold_what_they_test():
    """Each config has the geometry it is here for, alike on both
    sides."""
    got = {}
    for name, (layers, S, changes) in ARCHS.items():
        jcfg, tcfg = common.cfgs(name, layers, **changes)
        for key in ("layer_kinds", "n_heads", "n_kv_heads", "head_dim",
                    "mlp_act", "qkv_bias", "tie_embeddings",
                    "cross_attn_context_len"):
            assert tuple(np.atleast_1d(getattr(jcfg, key))) == \
                tuple(np.atleast_1d(getattr(tcfg, key))), (name, key)
        got[name] = tcfg
    g, s, v = (got[n] for n in ("gemma-7b", "starcoder2-15b",
                                "llama-3.2-vision-11b"))
    assert (g.head_dim, g.n_heads, g.n_kv_heads, g.mlp_act,
            g.tie_embeddings) == (256, 4, 4, "geglu", True)
    assert (s.n_heads // s.n_kv_heads, s.qkv_bias, s.mlp_act) == \
        (12, True, "gelu")
    assert (v.head_dim, v.n_heads // v.n_kv_heads, v.cross_attn_context_len,
            v.layer_kinds[-1], v.n_layers) == (128, 4, 101, C.CROSS_ATTN, 5)
    assert got["yi-6b"].n_heads // got["yi-6b"].n_kv_heads == 8
    assert got["llama4-scout-17b-16e"].moe is not None


def check_loss_fn(name, fused):
    """``loss_fn``'s value, metrics and gradients (remat on) against the
    JAX package's on ``_setup(name)``."""
    jmodel, params, model, batch = _setup(name)
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jobj.loss_fn(p, b, jmodel, fused_ce=fused),
        has_aux=True))
    (jloss, jm), jg = loss_grad(jax.tree.map(jnp.asarray, params),
                                common.jbatch(batch))
    tparams = tstep.trainable_params(model)
    loss, m = tobj.loss_fn(model, common.tbatch(batch), fused_ce=fused,
                           remat=True)
    grads = torch.autograd.grad(loss, list(tparams.values()))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(m["ce"]) == pytest.approx(float(jm["ce"]), rel=1e-5)
    for key in ("lb_loss", "z_loss"):
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                              abs=1e-6)
    want = common.as_port(jax.tree.map(np.asarray, jg), model.cfg)
    assert set(want) == set(tparams)
    for key, g in zip(tparams, grads):
        np.testing.assert_allclose(g.numpy(), want[key], err_msg=key,
                                   **common.GRAD_TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "naive"])
@pytest.mark.parametrize("name", sorted(DENSE))
def test_loss_fn_values_and_grads_match_jax(name, fused):
    check_loss_fn(name, fused)


def test_remat_runs_the_cross_layer_twice(monkeypatch):
    """Under remat every attention call runs twice a step: the vision
    model's period of four self-attention layers and one cross-attention
    layer (a self and a cross call) makes 6 flash forwards a forward, 12
    under remat (phase ``train`` counts the launches on the card the same
    way); the cross calls are non-causal, over the context's 101 keys."""
    _, _, model, batch = _setup("llama-3.2-vision-11b", B=1)
    params = tstep.trainable_params(model)
    calls, plain = [], fk.flash_attention_plain

    def counting(q, k, v, cfg, **kw):
        calls.append((k.shape[1], kw.get("causal", True)))
        return plain(q, k, v, cfg, **kw)
    monkeypatch.setattr(fk, "flash_attention_plain", counting)
    for remat, want in ((False, 6), (True, 12)):
        calls.clear()
        loss, _ = tobj.loss_fn(model, common.tbatch(batch), remat=remat)
        torch.autograd.grad(loss, list(params.values()))
        assert len(calls) == want
        assert calls.count((101, False)) == want // 6


def test_launch_train_vision_model_takes_its_context(tmp_path, monkeypatch):
    """``launch/train.py --arch llama-3.2-vision-11b --reduced --steps 3
    --device cpu``: the one context ``make_ctx`` draws reaches every
    step's forward, and the losses are finite."""
    made, seen = [], []
    make_ctx, train_forward = T.Transformer.make_ctx, T.Transformer.train_forward

    def recording_make_ctx(self, batch, **kw):
        made.append(make_ctx(self, batch, **kw))
        return made[-1]

    def recording_train_forward(self, tokens, ctx_embed=None, **kw):
        seen.append(ctx_embed)
        return train_forward(self, tokens, ctx_embed, **kw)
    monkeypatch.setattr(T.Transformer, "make_ctx", recording_make_ctx)
    monkeypatch.setattr(T.Transformer, "train_forward",
                        recording_train_forward)
    res = train.run(train.parse_args([
        "--arch", "llama-3.2-vision-11b", "--reduced", "--steps", "3",
        "--batch", "2", "--seq", "16", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)]))
    assert res["steps"] == [0, 1, 2] and res["restarts"] == 0
    assert np.isfinite(res["losses"]).all()
    cfg = train.cr.reduced("llama-3.2-vision-11b")
    assert len(made) == 1
    assert tuple(made[0].shape) == (2, cfg.cross_attn_context_len,
                                    cfg.d_model)
    assert len(seen) == 3 and all(c is made[0] for c in seen)
