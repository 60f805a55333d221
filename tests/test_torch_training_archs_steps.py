"""Three AdamW steps of the port's train step on gemma-7b (hd 256),
starcoder2-15b (GQA 12) and llama-3.2-vision-11b (a cross-attention layer
over a 101-position context) against the JAX package's, from the same
numpy weights on the same batches (and context), on the CPU, at
``tests/test_torch_training_archs.py``'s reduced configs
(``tests/test_torch_training_archs_others_steps.py``: yi-6b and
llama4-scout-17b-16e).

Losses rtol 1e-5, gradient norms rtol 1e-4, parameters ``PARAM_TOL``
(atol 1e-5 / rtol 1e-4), as ``tests/test_torch_training.py`` runs its
steps; AdamW's eps is raised as there, to 1e-5 here where that file
takes 1e-6, for the reason given there: Adam moves an element whose
gradient is below eps by about lr · g / eps, so the two sides' f32 sums
in another order move it apart by lr · |Δg| / eps.  gemma-7b's
embedding, scaled by sqrt(d), makes |Δg| reach 3.5e-8 in its first
query projection (1.2e-6 of that gradient's largest element), where a
few elements' gradients cancel to ~1e-8: at eps 1e-6 one such element
moves up to 3.5e-5 apart in a step, past the parameters' atol.
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
from tests.test_torch_training_archs import DENSE, _setup  # noqa: E402


def check_train_steps(name):
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
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-5)
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


@pytest.mark.parametrize("name", sorted(DENSE))
def test_train_steps_match_jax(name):
    check_train_steps(name)
