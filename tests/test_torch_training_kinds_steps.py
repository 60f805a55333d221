"""Three AdamW steps of the port's train step on the hybrid,
encoder–decoder and xLSTM kinds against the JAX package's, from the same
numpy weights on the same batches (and context), on the CPU, at
``tests/test_torch_training_kinds.py``'s reduced configs.  Losses rtol
1e-5, gradient norms rtol 1e-4, parameters ``PARAM_TOL`` (atol 1e-5 /
rtol 1e-4), with AdamW's eps at 1e-6, as ``tests/test_torch_training.py``
runs its steps and for the reason given there.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402
from tests import _torch_train_common as common  # noqa: E402
from tests.test_torch_training_kinds import KINDS, _setup  # noqa: E402


@pytest.mark.parametrize("name", sorted(KINDS))
def test_train_steps_match_jax(name):
    """Three steps of the train step (remat on) from the same weights on
    the same batches (and context) give the JAX step's losses, gradient
    norms and parameters."""
    K = 3
    jmodel, params, model, batch = _setup(name, seed=4)
    cfg = model.cfg
    S = batch["tokens"].shape[1]
    data = jdata.SyntheticLM(jdata.DataConfig(vocab_size=cfg.vocab_size,
                                              seq_len=S, global_batch=2,
                                              seed=0))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-6)
    jfn = jax.jit(jstep.build_train_step(jmodel, jopt.AdamWConfig(**kw)))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp)
    tparams = tstep.trainable_params(model)
    tfn = tstep.build_train_step(model, topt.AdamWConfig(**kw), remat=True)
    ts = topt.init_opt_state(tparams)
    for s in range(K):
        step_batch = jax.tree.map(np.asarray, data.batch_at(s))
        if "ctx" in batch:
            step_batch["ctx"] = batch["ctx"]
        jp, js, jm = jfn(jp, js, common.jbatch(step_batch))
        tparams, ts, tm = tfn(tparams, ts, common.tbatch(step_batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-4)
    want = common.as_port(jax.tree.map(np.asarray, jp), cfg)
    for key, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[key], err_msg=key,
                                   **common.PARAM_TOL)
    assert int(ts.step) == K
