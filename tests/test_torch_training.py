"""The port's training slice (``training/``, ``data/pipeline.py``,
``launch/train.py``) against the JAX package's on the same numpy weights
(``convert.from_jax_params``), batches and optimizer state, on the CPU,
for a reduced qwen2-0.5b (dense, GQA) and a reduced moonshot-v1-16b-a3b
(MoE: the router's aux losses).  No test here builds a full-width config.

Tolerances (float32 on both sides; sums in another order):
- cross entropy, ``loss_fn`` and its metrics: rtol 1e-5, ``test_training``'s
  fused-against-naive limit (the aux losses atol 1e-6, ``test_torch_moe``'s);
- gradients: atol 1e-5 / rtol 1e-3, ``test_training``'s fused-against-
  naive gradient limit (``tests/_torch_train_common.py``, shared with
  ``tests/test_torch_training_kinds.py``, which holds the hybrid,
  encoder–decoder and xLSTM kinds the same way);
- ``apply_updates``, ``schedule``, ``clip_by_global_norm``: rtol 1e-6 (the
  same f32 formula, one rounding apart); the moments atol 1e-12 besides;
- microbatches against the full batch: loss rtol 1e-5, parameters atol 1e-5
  / rtol 1e-4, ``test_training``'s own limits;
- K steps against the JAX step: losses rtol 1e-5, parameters atol 1e-5 /
  rtol 1e-4, the same limits, with AdamW's eps at 1e-6 in place of 1e-8:
  Adam moves an element by about lr · g / (|g| + eps), so a gradient at
  the f32 noise floor (the K bias's, zero in exact arithmetic, since a
  row's softmax ignores a constant added to all its scores; expert
  weights at |g| ~ 1e-8 against a largest 0.05) moves by a share of lr
  that differs between the two sides, by up to 3.9e-5 after three steps;
  eps 1e-6 keeps such elements still on both sides;
- ``SyntheticLM.batch_at``: equal.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jcr  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import registry as jmr  # noqa: E402
from repro.training import objective as jobj  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as tmr  # noqa: E402
from repro_torch.training import objective as tobj  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402
from tests._torch_train_common import (GRAD_TOL, PARAM_TOL,  # noqa: E402
                                       as_port as _as_port,
                                       jbatch as _jbatch, setup,
                                       tbatch as _tbatch)

MODELS = {"qwen2-0.5b": 2, "moonshot-v1-16b-a3b": 2}


def _setup(name, B=2, S=32, seed=0):
    """(JAX model, its params as numpy, the port's model holding them, a
    numpy batch) at ``MODELS[name]`` layers."""
    return setup(name, MODELS[name], B=B, S=S, seed=seed)


def test_cross_entropy_matches_jax_with_padded_vocab():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 8, 256)).astype(np.float32)
    labels = rng.integers(0, 200, (2, 8))
    want, jg = jax.value_and_grad(lambda x: jobj.cross_entropy(
        x, jnp.asarray(labels), 200))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tobj.cross_entropy(x, torch.from_numpy(labels), 200)
    (tg,) = torch.autograd.grad(got, x)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD_TOL)
    assert not tg[..., 200:].any()           # padded entries never predicted


@pytest.mark.parametrize("S,ch", [(48, 48), (96, 16)])
def test_fused_cross_entropy_matches_jax(S, ch, monkeypatch):
    """Values and gradients (hidden states and the unembedding) of the
    sequence-chunked CE, in one chunk and in six (the chunk budget cut on
    both sides)."""
    if ch < S:
        monkeypatch.setattr(jobj, "_CE_TARGET_ELEMS", 16 * 2 * 2)
        monkeypatch.setattr(tobj, "_CE_TARGET_ELEMS", 16 * 2 * 2)
    assert tobj._ce_chunk(S, 2, 512) == jobj._ce_chunk(S, 2, 512) == ch
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, S, 32)).astype(np.float32)
    w = (0.2 * rng.standard_normal((512, 32))).astype(np.float32)
    y = rng.integers(0, 500, (2, S))
    fn = lambda h, w: jobj.fused_cross_entropy(h, w, jnp.asarray(y), 500,
                                               compute_dtype=jnp.float32)
    want, (jh, jw) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(h),
                                                            jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    got = tobj.fused_cross_entropy(th, tw, torch.from_numpy(y), 500,
                                   compute_dtype=torch.float32)
    gh, gw = torch.autograd.grad(got, (th, tw))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jh), **GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), **GRAD_TOL)


@pytest.mark.parametrize("S,B,Vp", [(512, 8, 152064), (64, 2, 512),
                                    (96, 4, 32000), (7, 1, 256)])
def test_ce_chunk_is_the_references(S, B, Vp):
    assert tobj._ce_chunk(S, B, Vp) == jobj._ce_chunk(S, B, Vp)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "naive"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_fn_values_and_grads_match_jax(name, fused):
    jmodel, params, model, batch = _setup(name)
    (jloss, jm), jg = jax.value_and_grad(jobj.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), _jbatch(batch), jmodel,
        fused_ce=fused)
    tparams = tstep.trainable_params(model)
    loss, m = tobj.loss_fn(model, _tbatch(batch), fused_ce=fused)
    grads = torch.autograd.grad(loss, list(tparams.values()))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(m["ce"]) == pytest.approx(float(jm["ce"]), rel=1e-5)
    for key in ("lb_loss", "z_loss"):
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                              abs=1e-6)
    if name.startswith("moonshot"):
        assert float(m["lb_loss"]) > 0 and float(m["z_loss"]) > 0
    want = _as_port(jax.tree.map(np.asarray, jg), model.cfg)
    assert set(want) == set(tparams)
    for (key, g) in zip(tparams, grads):
        np.testing.assert_allclose(g.numpy(), want[key], err_msg=key,
                                   **GRAD_TOL)


def test_fused_ce_equals_naive_and_remat_changes_nothing():
    """The fused cross entropy, per-block remat and ``block_skip`` give the
    naive path's loss and gradients."""
    _, _, model, batch = _setup("qwen2-0.5b", B=2, S=16)
    params = tstep.trainable_params(model)
    tb = _tbatch(batch)
    out = {}
    for label, kw in (("naive", dict(fused_ce=False)),
                      ("fused", dict(fused_ce=True)),
                      ("remat", dict(fused_ce=True, remat=True)),
                      ("skip", dict(fused_ce=True, block_skip=True))):
        loss, _ = tobj.loss_fn(model, tb, **kw)
        out[label] = (loss, torch.autograd.grad(loss, list(params.values())))
    for label in ("fused", "remat", "skip"):
        assert float(out[label][0]) == pytest.approx(float(out["naive"][0]),
                                                     rel=1e-5)
        for a, b in zip(out[label][1], out["naive"][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    for a, b in zip(out["remat"][1], out["fused"][1]):
        assert torch.equal(a, b)


def test_remat_runs_the_attention_forward_again():
    """Under remat the backward re-runs each block's forward: the flash
    forward is called twice a layer (the launch count on the card doubles
    the same way)."""
    _, _, model, batch = _setup("qwen2-0.5b", B=1, S=16)
    params = tstep.trainable_params(model)
    calls = []
    plain = fk.flash_attention_plain

    def counting(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)
    try:
        fk.flash_attention_plain = counting
        for remat, want in ((False, 2), (True, 4)):
            calls.clear()
            loss, _ = tobj.loss_fn(model, _tbatch(batch), remat=remat)
            torch.autograd.grad(loss, list(params.values()))
            assert len(calls) == want
    finally:
        fk.flash_attention_plain = plain


@pytest.mark.parametrize("name,layers", [("recurrentgemma-2b", 5),
                                         ("whisper-small", None)])
def test_jax_ndim_is_the_stored_leafs(name, layers):
    """AdamW's decay rule reads the JAX package's leaves: a block stacked
    along the period axis (and every encoder block) has one dimension more
    than the port's tensor; a remainder block (``rem<r>``) does not.  Each
    JAX leaf is filled with its own ndim and carried across by
    ``convert``."""
    jcfg, tcfg = (m.reduced(name, n_layers=layers) for m in (jcr, tcr))
    params = jmr.build(jcfg).init(jax.random.key(0))
    marked = jax.tree.map(lambda x: np.full(x.shape, x.ndim, np.float32),
                          params)
    model = convert.from_jax_params(marked, tcfg, device="cpu")
    got = {n: convert.jax_ndim(n, p, tcfg) for n, p in
           model.named_parameters()}
    assert got == {n: int(p.flatten()[0]) for n, p in
                   model.named_parameters()}
    if layers == 5:       # one period of 3, then rem0 and rem1
        assert got["blocks.0.ln1.scale"] == 2
        assert got["blocks.4.ln1.scale"] == 1


def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 6), "b": (6,), "e": (3, 2, 5)}
    mk = lambda scale=1.0: {k: (scale * rng.standard_normal(s)).astype(
        np.float32) for k, s in shapes.items()}
    params, grads, m = mk(), mk(3.0), mk(0.1)
    v = {k: np.abs(x) for k, x in mk(0.01).items()}
    return params, grads, m, v


@pytest.mark.parametrize("step", [0, 3, 150])
def test_apply_updates_matches_jax(step):
    params, grads, m, v = _opt_case(step)
    cfg = dict(lr=1e-2, warmup_steps=5, total_steps=200, grad_clip=1.0)
    jstate = jopt.OptState(step=jnp.asarray(step, jnp.int32),
                           m=jax.tree.map(jnp.asarray, m),
                           v=jax.tree.map(jnp.asarray, v))
    jp, js, jmet = jopt.apply_updates(jax.tree.map(jnp.asarray, params),
                                      jax.tree.map(jnp.asarray, grads),
                                      jstate, jopt.AdamWConfig(**cfg))
    tt = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}
    tstate = topt.OptState(step=torch.tensor(step, dtype=torch.int32),
                           m=tt(m), v=tt(v))
    tp, ts, tmet = topt.apply_updates(tt(params), tt(grads), tstate,
                                      topt.AdamWConfig(**cfg))
    assert int(ts.step) == int(js.step) == step + 1
    for key in params:
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.m[key].numpy(), np.asarray(js.m[key]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(ts.v[key].numpy(), np.asarray(js.v[key]),
                                   rtol=1e-6, atol=1e-12)
    for key in ("grad_norm", "lr"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=1e-6)
    # decay only on tensors of two or more dims: b moves by Adam alone
    assert not np.allclose(tp["w"].numpy(), params["w"])


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 120])
def test_schedule_matches_jax(step):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = jopt.schedule(jopt.AdamWConfig(**cfg), jnp.asarray(step))
    got = topt.schedule(topt.AdamWConfig(**cfg), torch.tensor(step))
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("fill,max_norm", [(100.0, 1.0), (0.1, 1.0),
                                           (3.0, 0.5)])
def test_clip_by_global_norm_matches_jax(fill, max_norm):
    g = {"w": np.full((4,), fill, np.float32),
         "u": np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)}
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = topt.clip_by_global_norm(
        {k: torch.from_numpy(x) for k, x in g.items()}, max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for key in g:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-6)
    assert float(topt.global_norm(tc.values())) <= max_norm * (1 + 1e-5)


def test_microbatch_accumulation_matches_full_batch():
    _, _, model, batch = _setup("qwen2-0.5b", B=4, S=16)
    adamw = topt.AdamWConfig(lr=1e-3)
    params = tstep.trainable_params(model)
    start = {k: p.detach().clone() for k, p in params.items()}
    out = []
    for n in (1, 2):
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(start[k])
        step = tstep.build_train_step(model, adamw, num_microbatches=n)
        _, _, m = step(params, topt.init_opt_state(params), _tbatch(batch))
        out.append((float(m["loss"]),
                    {k: p.detach().clone() for k, p in params.items()}))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for key in start:
        np.testing.assert_allclose(out[1][1][key].numpy(),
                                   out[0][1][key].numpy(), **PARAM_TOL)
    with pytest.raises(ValueError):
        tstep.build_train_step(model, adamw, num_microbatches=3)(
            params, topt.init_opt_state(params), _tbatch(batch))


@pytest.mark.parametrize("n", [1, 2])
def test_mark_hook_sees_the_parts_and_changes_nothing(n):
    """``mark`` is called at the end of each part of the step (forward and
    backward once a microbatch, then the optimizer) and leaves the step's
    loss and parameters as they are without it, bit for bit."""
    _, _, model, batch = _setup("qwen2-0.5b", B=4, S=16)
    adamw = topt.AdamWConfig(lr=1e-3)
    params = tstep.trainable_params(model)
    start = {k: p.detach().clone() for k, p in params.items()}
    out, parts = [], []
    for mark in (None, parts.append):
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(start[k])
        step = tstep.build_train_step(model, adamw, num_microbatches=n,
                                      mark=mark)
        _, _, m = step(params, topt.init_opt_state(params), _tbatch(batch))
        out.append((float(m["loss"]),
                    {k: p.detach().clone() for k, p in params.items()}))
    assert parts == ["forward", "backward"] * n + ["optimizer"]
    assert out[1][0] == out[0][0]
    for key in start:
        assert torch.equal(out[1][1][key], out[0][1][key]), key


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_steps_match_jax(name):
    """The slice as a whole: K steps of the train step from the same
    weights on the same batches give the JAX step's losses and
    parameters."""
    K = 3
    jmodel, params, model, _ = _setup(name, seed=4)
    cfg = model.cfg
    data = jdata.SyntheticLM(jdata.DataConfig(vocab_size=cfg.vocab_size,
                                              seq_len=16, global_batch=4,
                                              seed=0))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-6)
    jfn = jax.jit(jstep.build_train_step(jmodel, jopt.AdamWConfig(**kw)))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp)
    tparams = tstep.trainable_params(model)
    tfn = tstep.build_train_step(model, topt.AdamWConfig(**kw))
    ts = topt.init_opt_state(tparams)
    for s in range(K):
        batch = jax.tree.map(np.asarray, data.batch_at(s))
        jp, js, jm = jfn(jp, js, _jbatch(batch))
        tparams, ts, tm = tfn(tparams, ts, _tbatch(batch))
        assert set(tm) == set(jm)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-4)
    want = _as_port(jax.tree.map(np.asarray, jp), cfg)
    for key, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[key], err_msg=key,
                                   **PARAM_TOL)
    assert int(ts.step) == K


def test_synthetic_lm_batches_equal_the_references():
    kw = dict(vocab_size=151, seq_len=24, global_batch=4, seed=3)
    ref = jdata.SyntheticLM(jdata.DataConfig(**kw))
    port = tdata.SyntheticLM(tdata.DataConfig(**kw), device="cpu")
    for step in (0, 7):
        for host in (0, 1):
            want = ref.batch_at(step, host_id=host, num_hosts=2)
            got = port.batch_at(step, host_id=host, num_hosts=2)
            for key in ("tokens", "labels"):
                assert got[key].dtype == torch.int64
                assert (got[key].numpy() == np.asarray(want[key])).all()
    b = port.batch_at(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    with pytest.raises(ValueError):
        port.batch_at(0, num_hosts=3)


def test_parameters_train_only_when_asked():
    """Inference builds parameters without gradients; training turns them
    on; ``reset`` draws under ``no_grad`` either way."""
    cfg = tcr.reduced("qwen2-0.5b", n_layers=2)
    model = tmr.build(cfg, device="cpu", seed=0)
    assert not any(p.requires_grad for p in model.parameters())
    params = tstep.trainable_params(model)
    assert all(p.requires_grad for p in params.values())
    model.reset(torch.Generator().manual_seed(1))
    assert all(p.requires_grad for p in model.parameters())


def _train_args(tmp_path, *extra):
    return train.parse_args(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                             "8", "--batch", "4", "--seq", "32", "--device",
                             "cpu", "--ckpt-dir", str(tmp_path),
                             "--ckpt-every", "3", *extra])


def test_launch_train_end_to_end_with_a_failure(tmp_path, capsys):
    """``launch.train.run`` on the CPU: finite, falling losses; a run with
    two injected failures restarts twice and logs every step's loss as the
    uninterrupted run does, bit for bit."""
    base = train.run(_train_args(tmp_path / "a"))
    assert base["steps"] == list(range(8)) and base["restarts"] == 0
    assert np.isfinite(base["losses"]).all()
    assert base["final_loss"] < base["first_loss"]
    assert [c["step"] for c in base["checkpoints"]] == [0, 3, 6]
    assert all(c["bytes"] > 0 for c in base["checkpoints"])
    failed = train.run(_train_args(tmp_path / "b", "--fail-at", "4", "7"))
    assert failed["restarts"] == 2
    d1 = dict(zip(base["steps"], base["losses"]))
    assert dict(zip(failed["steps"], failed["losses"])) == d1
    assert "[train] arch=qwen2-0.5b-reduced steps=8" in capsys.readouterr().out


def test_launch_train_cuts_the_depth(tmp_path, monkeypatch):
    """``--n-layers`` trains the config at that depth, its widths kept."""
    built = []
    build = train.mr.build
    monkeypatch.setattr(train.mr, "build", lambda cfg, **kw: (
        built.append(cfg), build(cfg, **kw))[1])
    res = train.run(_train_args(tmp_path, "--steps", "2", "--n-layers", "1"))
    full = tcr.reduced("qwen2-0.5b")
    assert [(c.n_layers, c.d_model, c.d_ff) for c in built] == [
        (1, full.d_model, full.d_ff)]
    assert res["steps"] == [0, 1] and np.isfinite(res["losses"]).all()


def test_launch_train_takes_one_device_only(tmp_path):
    with pytest.raises(ValueError):
        train.run(_train_args(tmp_path, "--mesh", "2x1"))
    args = _train_args(tmp_path, "--act-mode", "sp", "--steps", "1")
    assert train.run(args)["steps"] == [0]
