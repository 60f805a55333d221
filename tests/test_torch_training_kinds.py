"""The port's training slice on the hybrid, encoder–decoder and xLSTM
kinds against the JAX package's, on the same numpy weights
(``convert.from_jax_params``), batches and contexts, on the CPU:
``loss_fn``'s value, metrics and gradients in both cross-entropy modes
(``tests/test_torch_training_kinds_steps.py``: three AdamW steps;
``tests/test_torch_training.py`` holds the dense and MoE kinds the same
way; the two files split so that each runs alone in well under a
minute).

The reduced configs (``dataclasses.replace`` on both sides):
- recurrentgemma-2b at 3 layers (RG-LRU, RG-LRU, local attention) with its
  window cut to 16, below S 48, so that the window masks;
- whisper-small as ``reduced`` makes it (2 encoder and 2 decoder layers
  over 16 frames), one numpy context for both packages;
- xlstm-1.3b at 2 layers of the pattern (mLSTM, sLSTM), S 128: one
  mLSTM chunk and the sLSTM loop.  ``reduced``'s own 8 layers (7 mLSTM,
  then the sLSTM) carry f32 rounding to ~5e-5 of each gradient's largest
  element, past the elementwise rtol below for elements near zero.

Tolerances: ``tests/_torch_train_common.py`` (gradients atol 1e-5 / rtol
1e-3; parameters atol 1e-5 / rtol 1e-4); losses and metrics rtol 1e-5, the
aux losses atol 1e-6 besides, as ``test_torch_training``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.training import objective as jobj  # noqa: E402
from repro_torch.configs import base as C  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.models import registry as tmr  # noqa: E402
from repro_torch.training import objective as tobj  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402
from tests import _torch_train_common as common  # noqa: E402

# name: (layers, S, config changes)
KINDS = {
    "recurrentgemma-2b": (3, 48, dict(sliding_window=16)),
    "whisper-small": (None, 32, {}),
    "xlstm-1.3b": (2, 128, dict(block_pattern=(C.MLSTM, C.SLSTM))),
}


def _setup(name, B=2, seed=0):
    layers, S, changes = KINDS[name]
    return common.setup(name, layers, B=B, S=S, seed=seed, **changes)


def test_reduced_configs_hold_what_they_test():
    """Each config has the layers it is here for, alike on both sides."""
    for name, (layers, S, changes) in KINDS.items():
        jcfg, tcfg = common.cfgs(name, layers, **changes)
        kinds = tcfg.layer_kinds
        assert tuple(jcfg.layer_kinds) == kinds
        if name == "recurrentgemma-2b":
            assert kinds == (C.RGLRU, C.RGLRU, C.LOCAL_ATTN)
            assert jcfg.sliding_window == tcfg.sliding_window < S
        elif name == "whisper-small":
            assert tcfg.encoder is not None and jcfg.encoder is not None
            assert set(kinds) == {C.CROSS_ATTN}
        else:
            assert kinds == (C.MLSTM, C.SLSTM)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "naive"])
@pytest.mark.parametrize("name", sorted(KINDS))
def test_loss_fn_values_and_grads_match_jax(name, fused):
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


def test_remat_runs_the_encoder_again(monkeypatch):
    """Under remat every attention call runs twice a step, the encoder's
    too: whisper-small's 2 encoder and 2 cross-attention layers (a self
    and a cross call each) make 6 flash forwards a forward, 12 under remat
    (phase ``train`` counts the launches on the card the same way)."""
    cfg = tcr.reduced("whisper-small")
    model = tmr.build(cfg, device="cpu", seed=0)
    params = tstep.trainable_params(model)
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg.vocab_size, (1, 17))
    batch = common.tbatch({"tokens": seq[:, :-1], "labels": seq[:, 1:],
                           "ctx": rng.standard_normal(
                               (1, model.ctx_len(), cfg.d_model))})
    calls, plain = [], fk.flash_attention_plain

    def counting(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)
    monkeypatch.setattr(fk, "flash_attention_plain", counting)
    for remat, want in ((False, 6), (True, 12)):
        calls.clear()
        loss, _ = tobj.loss_fn(model, batch, remat=remat)
        torch.autograd.grad(loss, list(params.values()))
        assert len(calls) == want
