"""The port's xLSTM model kind (mLSTM and sLSTM blocks,
``reduced("xlstm-1.3b")``: 8 layers, seven mLSTM and one sLSTM, d 64, 4
heads, mLSTM hd 32, vocab 512) against the JAX package, on the same
weights and the same numpy inputs from a seed.  No test here builds a
full-width config (xlstm-1.3b is 3.65 B parameters).

Tolerances (max |Δ| against the JAX package's, ``_close``: within atol +
rtol · max |want|):
- the cells in float32: 1e-5 / 1e-5 (both sides sum in f32; the chunks
  and the scans add in other orders).  The chunkwise cell in bf16: h
  within 2^-6 · max |h| (two bf16 ulps at the largest value: a product
  that lands on a rounding edge rounds the other way), its f32 state
  within 1e-5.
- chunkwise against recurrent inside the port: the JAX package's own
  2e-4 / 1e-3 (``tests/test_recurrent.py``); a block's steps against its
  forward: 5e-4 / 2e-3 (same file).
- the blocks in float32: 2e-5 (the RG-LRU block's); in bf16: 5e-2 ·
  max, ``BF16_BLOCK``: the activations round (silu, gelu) at other
  points in XLA's CPU code than in PyTorch's, which moves bf16 values by
  an ulp, and the mLSTM's normaliser amplifies such moves (h 1.2 % at
  S 140, measured).
- the whole model in float32: 1e-4 / 1e-4 (the dense forward's).  In
  bf16 the seeded reduced model is ill-conditioned (the JAX package's own
  bf16 forward is 44 % of max |logits| off its float32 one at S 140), so
  the port's bf16 logits are held to the float32 reference: no further
  from it than ``BF16_MODEL_RATIO`` times the JAX package's bf16 logits
  are, plus ``BF16_MODEL_SLACK``.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jcr  # noqa: E402
from repro.core import opgraph as jog  # noqa: E402
from repro.models import recurrent as jR  # noqa: E402
from repro.models import registry as jmr  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import base as C  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import opgraph as tog  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import recurrent as tR  # noqa: E402
from repro_torch.models import registry as tmr  # noqa: E402
from repro_torch.models.transformer import Transformer, cast_weights_  # noqa: E402

NAME = "xlstm-1.3b"
BF16_BLOCK = 5e-2
BF16_MODEL_RATIO, BF16_MODEL_SLACK = 1.5, 5e-2


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(jcr.reduced(NAME, **kw), compute_dtype=dtype),
            dataclasses.replace(tcr.reduced(NAME, **kw), compute_dtype=dtype))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, atol, rtol=0.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    bound = atol + rtol * float(np.abs(want).max()) if want.size else atol
    assert err <= bound, (err, bound)


def _load(block, p):
    block.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           convert._flatten(p).items()}, strict=True)
    return block


def _mlstm(seed=0):
    """One mLSTM block's JAX parameters (numpy) and the port's block."""
    jcfg, tcfg = _cfgs()
    p = jax.tree.map(np.asarray, jR.init_mlstm_block(jax.random.key(seed),
                                                     jcfg))
    return jcfg, p, _load(tR.MLSTMBlock(tcfg), p)


def _slstm(seed=0):
    jcfg, tcfg = _cfgs()
    p = jax.tree.map(np.asarray, jR.init_slstm_block(jax.random.key(seed),
                                                     jcfg))
    return jcfg, p, _load(tR.SLSTMBlock(tcfg), p)


def _cell_inputs(B, S, H, hd, seed):
    """q, k / sqrt(hd), v (B, S, H, hd), i_raw and log sigmoid(f_raw + 2)
    (B, S, H), as numpy f32."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    k /= np.sqrt(hd)
    i_raw = rng.standard_normal((B, S, H)).astype(np.float32)
    f_raw = rng.standard_normal((B, S, H)).astype(np.float32) + 2.0
    return q, k, v, i_raw, np.asarray(-jax.nn.softplus(-jnp.asarray(f_raw)))


def _params_np(jcfg, seed=0):
    """JAX parameters from a seed, biases and norm scales perturbed with
    numpy so that they are not trivial."""
    params = jmr.build(jcfg).init(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x, np.float32)
        leaf = jax.tree_util.keystr(path)
        if "'b'" in leaf or "'scale'" in leaf:
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(perturb, params)


# ----- sizes -----

def test_dims_and_the_full_model_size():
    """mLSTM hd = di / H: 1024 at full width (not the predictor's 512);
    the model ``init_params`` builds is 3,650,382,160 parameters, counted
    without allocating (the JAX package's ``eval_shape``, the port's
    ``meta`` device)."""
    full = tcr.get(NAME)
    assert tR.mlstm_dims(full) == (4096, 4, 1024) and full.head_dim == 512
    assert tR.mlstm_dims(tcr.reduced(NAME)) == (128, 4, 32)
    assert tR.slstm_ff(full) == jR.slstm_ff(jcr.get(NAME)) == 2816
    meta = Transformer(full, device=torch.device("meta"))
    n = sum(p.numel() for p in meta.parameters())
    assert n == jT.count_params(jcr.get(NAME)) == 3_650_382_160
    assert tog.slstm_ff is tR.slstm_ff                 # one copy in the port


# ----- the mLSTM cells -----

@pytest.mark.parametrize("S", [1, 7, 128, 256])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_cell_recurrent_matches_jax(S, with_state):
    """From zero (m = -inf) and from a given state, which stays as it
    was."""
    q, k, v, i_raw, f = _cell_inputs(2, S, 4, 32, S)
    state = None
    if with_state:
        rng = np.random.default_rng(S + 1)
        state = (rng.standard_normal((2, 4, 32, 32)).astype(np.float32),
                 rng.standard_normal((2, 4, 32)).astype(np.float32),
                 rng.standard_normal((2, 4)).astype(np.float32))
    jh, jstate = jR.mlstm_cell_recurrent(
        *map(jnp.asarray, (q, k, v, i_raw, f)),
        state=None if state is None else tuple(map(jnp.asarray, state)))
    tstate = None if state is None else tuple(map(torch.from_numpy, state))
    h, got = tR.mlstm_cell_recurrent(*map(torch.from_numpy,
                                          (q, k, v, i_raw, f)), tstate)
    _close(h, jh, 1e-5, 1e-5)
    for g, w in zip(got, jstate):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5, 1e-5)
    if state is not None:
        assert all(np.array_equal(t.numpy(), s)
                   for t, s in zip(tstate, state))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 7, 128, 256])
@pytest.mark.parametrize("chunk", [4, 64, 128])
def test_mlstm_cell_chunkwise_matches_jax(dtype, S, chunk):
    """Every chunking (one chunk where ``chunk`` does not divide S), q, k
    and v in ``dtype``, the state f32."""
    q, k, v, i_raw, f = _cell_inputs(2, S, 4, 32, 10 + S)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    jh, jstate = jR.mlstm_cell_chunkwise(jq, jk, jv, jnp.asarray(i_raw),
                                         jnp.asarray(f), chunk=chunk)
    h, state = tR.mlstm_cell_chunkwise(tq, tk, tv, torch.from_numpy(i_raw),
                                       torch.from_numpy(f), chunk)
    assert h.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(h, jh, 1e-5, 1e-5)
    else:
        _close(h, jh, 0.0, 2.0 ** -6)
    for g, w in zip(state, jstate):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5, 1e-5)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunkwise_matches_recurrent_in_the_port(chunk):
    """The JAX package's ``test_mlstm_chunkwise_matches_recurrent``, on
    the port's two cells."""
    q, k, v, i_raw, f = map(torch.from_numpy, _cell_inputs(2, 32, 2, 8, 0))
    h_rec, (C1, n1, m1) = tR.mlstm_cell_recurrent(q, k, v, i_raw, f)
    h_chk, (C2, n2, m2) = tR.mlstm_cell_chunkwise(q, k, v, i_raw, f, chunk)
    torch.testing.assert_close(h_chk, h_rec, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(n2, n1, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(C2, C1, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(m2, m1, atol=1e-5, rtol=1e-5)


def test_no_infinity_meets_infinity_in_the_first_chunk():
    """m starts at -inf: the first chunk's inter-chunk weights and decay
    are exp(-inf) = 0, and nothing computes -inf - (-inf) (a NaN), even
    where every input gate is very negative."""
    q, k, v, i_raw, f = map(torch.from_numpy, _cell_inputs(1, 16, 2, 8, 1))
    i_raw = i_raw - 80.0
    for h, state in (tR.mlstm_cell_chunkwise(q, k, v, i_raw, f, 4),
                     tR.mlstm_cell_recurrent(q, k, v, i_raw, f)):
        assert torch.isfinite(h).all()
        assert all(torch.isfinite(t).all() for t in state)


# ----- the mLSTM block -----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_block_state_and_steps_match_jax(dtype):
    """The block over 20 positions (chunk 8: two chunks and a short one
    falls back to one of 20) with its state against
    ``mlstm_block(return_state=True)``, then 4 steps from that state
    against ``mlstm_block_step``."""
    jcfg, p, blk = _mlstm(seed=1)
    jp = jax.tree.map(jnp.asarray, p)
    tdt = getattr(torch, dtype)
    tol = (2e-5, 0.0) if dtype == "float32" else (0.0, BF16_BLOCK)
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal((2, 20, jcfg.d_model))).astype(np.float32)
    want, jstate = jR.mlstm_block(jp, jnp.asarray(x).astype(dtype), jcfg,
                                  compute_dtype=jnp.dtype(dtype), chunk=8,
                                  return_state=True)
    with torch.no_grad():
        got, state = blk(torch.from_numpy(x).to(tdt), tdt, chunk=8)
    assert got.dtype == tdt and state[3].dtype == tdt
    assert [t.dtype for t in state[:3]] == [torch.float32] * 3
    _close(got, want, *tol)
    for g, key in zip(state, ("C", "n", "m", "conv")):
        assert tuple(g.shape) == jstate[key].shape
        _close(g, jstate[key], *tol)
    jcache = {k: jnp.asarray(t.float().numpy()).astype(jstate[k].dtype)
              for k, t in zip(("C", "n", "m", "conv"), state)}
    for t in range(4):
        xt = (0.5 * rng.standard_normal((2, 1, jcfg.d_model))).astype(
            np.float32)
        jy, jcache = jR.mlstm_block_step(jp, jnp.asarray(xt).astype(dtype),
                                         jcache, jcfg, jnp.dtype(dtype))
        with torch.no_grad():
            y = blk.step(torch.from_numpy(xt).to(tdt), *state, tdt)
        _close(y, jy, *tol)
        for g, key in zip(state, ("C", "n", "m", "conv")):
            _close(g, jcache[key], *tol)


def test_mlstm_block_steps_match_its_forward():
    """Steps from ``init_mlstm_cache`` give the block's chunkwise output
    (the JAX package's ``test_mlstm_block_step_matches_block``)."""
    jcfg, p, blk = _mlstm()
    _, tcfg = _cfgs()
    x = torch.from_numpy((0.5 * np.random.default_rng(2).standard_normal(
        (1, 8, jcfg.d_model))).astype(np.float32))
    C_, n, m, conv = tR.init_mlstm_cache(tcfg, 1)
    assert C_.shape == (1, 4, 32, 32) and conv.shape == (1, 3, 128)
    assert bool(torch.isneginf(m).all())
    with torch.no_grad():
        full, _ = blk(x, chunk=4)
        steps = torch.cat([blk.step(x[:, t:t + 1], C_, n, m, conv)
                           for t in range(8)], 1)
    torch.testing.assert_close(steps, full, atol=5e-4, rtol=2e-3)
    want = jR.mlstm_block(jax.tree.map(jnp.asarray, p),
                          jnp.asarray(x.numpy()), jcfg, chunk=4)
    _close(full, want, 2e-5)


def test_mlstm_short_prompt_conv_state_is_zero_padded():
    """A prompt shorter than the conv's window leaves zero rows before it
    in the state; a step then reads them as the inputs before the start
    (the forward's zero padding)."""
    _, _, blk = _mlstm(seed=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 3, 64)).astype(np.float32))
    with torch.no_grad():
        full, _ = blk(x)
        _, state = blk(x[:, :2])
        assert state[3].shape == (1, 3, 128) and not state[3][:, 0].any()
        step = blk.step(x[:, 2:], *state)
    torch.testing.assert_close(step, full[:, 2:], atol=2e-5, rtol=0)


# ----- the sLSTM -----

@pytest.mark.parametrize("S", [1, 9, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_cell_matches_jax(S, with_state):
    jcfg, p, blk = _slstm()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((2, 64)).astype(np.float32),
                 rng.uniform(0.5, 2.0, (2, 64)).astype(np.float32),
                 rng.standard_normal((2, 64)).astype(np.float32),
                 rng.standard_normal((2, 64)).astype(np.float32))
    jh, jstate = jR.slstm_cell(
        jax.tree.map(jnp.asarray, p["slstm"]), jnp.asarray(x),
        None if state is None else tuple(map(jnp.asarray, state)))
    h, got = tR.slstm_cell(blk.slstm, torch.from_numpy(x),
                           None if state is None
                           else tuple(map(torch.from_numpy, state)))
    _close(h, jh, 1e-5, 1e-5)
    for g, w in zip(got, jstate):
        _close(g, w, 1e-5, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_block_state_and_steps_match_jax(dtype):
    """``SLSTMBlock`` over 12 positions with its state against
    ``slstm_block(return_state=True)``, then 4 in-place steps against
    ``slstm_block_step``; the cell's state is f32 in both dtypes."""
    jcfg, p, blk = _slstm(seed=2)
    jp = jax.tree.map(jnp.asarray, p)
    tdt = getattr(torch, dtype)
    tol = (2e-5, 0.0) if dtype == "float32" else (0.0, BF16_BLOCK)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    want, jstate = jR.slstm_block(jp, jnp.asarray(x).astype(dtype), jcfg,
                                  jnp.dtype(dtype), return_state=True)
    with torch.no_grad():
        got, state = blk(torch.from_numpy(x).to(tdt), tdt)
    assert got.dtype == tdt
    assert all(t.dtype == torch.float32 for t in state)
    _close(got, want, *tol)
    keys = ("c", "n", "h", "m")
    for g, key in zip(state, keys):
        _close(g, jstate[key], *tol)
    ids = [id(t) for t in state]
    for t in range(4):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jstate = jR.slstm_block_step(jp, jnp.asarray(xt).astype(dtype),
                                         jstate, jcfg, jnp.dtype(dtype))
        with torch.no_grad():
            y = blk.step(torch.from_numpy(xt).to(tdt), *state, tdt)
        _close(y, jy, *tol)
        for g, key in zip(state, keys):
            _close(g, jstate[key], *tol)
    assert [id(t) for t in state] == ids


def test_slstm_stability_long_sequence():
    """The JAX package's ``test_slstm_stability_long_sequence``: the
    stabilised exponential gates do not overflow over 200 steps of inputs
    at scale 2, and the port's scan follows the reference's."""
    jcfg, p, blk = _slstm()
    x = 2.0 * np.random.default_rng(5).standard_normal(
        (1, 200, jcfg.d_model)).astype(np.float32)
    jh, jstate = jR.slstm_cell(jax.tree.map(jnp.asarray, p["slstm"]),
                               jnp.asarray(x))
    h, state = tR.slstm_cell(blk.slstm, torch.from_numpy(x))
    assert torch.isfinite(h).all() and torch.isfinite(state[0]).all()
    _close(h, jh, 1e-4, 1e-4)
    _close(state[0], jstate[0], 1e-4, 1e-4)


def test_init_slstm_cache_starts_where_the_cell_does():
    _, tcfg = _cfgs()
    c, n, h, m = tR.init_slstm_cache(tcfg, 3)
    assert all(t.shape == (3, 64) and t.dtype == torch.float32
               for t in (c, n, h, m))
    assert not c.any() and not h.any() and c is not h
    assert bool((n == 1e-6).all()) and bool((m == -1e30).all())
    assert torch.isfinite(m).all()                      # -1e30, not -inf


# ----- the model -----

@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = _cfgs()
    params = _params_np(jcfg)
    return (jcfg, jmr.build(jcfg), jax.tree.map(jnp.asarray, params), tcfg,
            params, convert.from_jax_params(params, tcfg, device="cpu"))


def test_forward_prefill_and_decode_match_jax_f32(both):
    """The forward over 20 tokens, a prefill of 12 and 8 decode steps
    against the JAX ``forward`` / ``prefill`` / ``decode_step``."""
    jcfg, jmodel, jparams, _, _, model = both
    S, steps = 12, 8
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                               (2, S + steps))
    jlogits, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    jlg, jcache = jmodel.prefill(jparams, jnp.asarray(tokens[:, :S]))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
        lg, cache = model.prefill(torch.from_numpy(tokens[:, :S]))
    assert logits.shape == (2, S + steps, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=1e-4)
    for t in range(steps):
        jlg, jcache = jmodel.decode_step(jparams,
                                         jnp.asarray(tokens[:, S + t]), jcache)
        with torch.no_grad():
            lg, cache = model.decode_step(torch.from_numpy(tokens[:, S + t]),
                                          cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=1e-4)
    assert int(cache.pos) == int(jcache["pos"]) == S + steps


def test_forward_prefill_and_decode_bf16_as_close_as_jax(both):
    """bf16: the port's forward, prefill and 8 decode steps are no further
    from the float32 reference than ``BF16_MODEL_RATIO`` times the JAX
    package's own bf16 ones, plus ``BF16_MODEL_SLACK`` (max |Δ| over max
    |logits|)."""
    jcfg, j32, jparams, tcfg, params, _ = both
    jb = jmr.build(dataclasses.replace(jcfg, compute_dtype="bfloat16"))
    model = convert.from_jax_params(
        params, dataclasses.replace(tcfg, compute_dtype="bfloat16"),
        device="cpu")
    S, steps = 12, 8
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                               (2, S + steps))
    ref, _ = j32.forward(jparams, jnp.asarray(tokens))
    ref = _np(ref)
    scale = np.abs(ref).max()
    err = lambda x, pos: float(np.abs(x - ref[:, pos]).max() / scale)
    jl, _ = jb.forward(jparams, jnp.asarray(tokens))
    jlg, jcache = jb.prefill(jparams, jnp.asarray(tokens[:, :S]))
    with torch.no_grad():
        tl = model(torch.from_numpy(tokens)).float().numpy()
        lg, cache = model.prefill(torch.from_numpy(tokens[:, :S]))
    assert tl.dtype == np.float32 and lg.dtype == torch.bfloat16
    pairs = [(err(tl, slice(None)), err(_np(jl), slice(None))),
             (err(lg.float().numpy(), S - 1), err(_np(jlg), S - 1))]
    for t in range(steps):
        jlg, jcache = jb.decode_step(jparams, jnp.asarray(tokens[:, S + t]),
                                     jcache)
        with torch.no_grad():
            lg, cache = model.decode_step(torch.from_numpy(tokens[:, S + t]),
                                          cache)
        pairs.append((err(lg.float().numpy(), S + t), err(_np(jlg), S + t)))
    for port, ref_err in pairs:
        assert port <= BF16_MODEL_RATIO * ref_err + BF16_MODEL_SLACK, pairs


def test_prefill_seeds_the_jax_states(both):
    """Each layer's state after a prefill equals the JAX cache's: an
    mLSTM layer's C, n, m and conv, the sLSTM layer's c, n, h and m."""
    jcfg, jmodel, jparams, tcfg, _, model = both
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 9))
    _, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=16)
    with torch.no_grad():
        _, cache = model.prefill(torch.from_numpy(tokens), max_len=16)
    period = len(jcfg.block_pattern)
    for i, kind in enumerate(tcfg.layer_kinds):
        rec = jcache["layers"]["scan"][f"sub{i % period}"]["rec"]
        keys = ("C", "n", "m", "conv") if kind == C.MLSTM else \
            ("c", "n", "h", "m")
        for got, key in zip(cache.layer(i), keys):
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(rec[key])[i // period],
                                       atol=1e-4, rtol=1e-4)


def test_decode_from_scratch_matches_forward(both):
    """``init_cache(pos=0)`` and steps token by token against the forward
    (the JAX package's ``test_decode_cache_from_scratch``)."""
    *_, model = both
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, (1, 10)))
    with torch.no_grad():
        full = model(tokens)
        cache = model.init_cache(1, 16, pos=0, dtype=torch.float32)
        scale = float(full.abs().max())
        for t in range(10):
            lg, cache = model.decode_step(tokens[:, t], cache)
            assert float((lg - full[:, t]).abs().max()) / scale < 3e-5, t


def test_cache_layout_bytes_and_copies(both):
    """The cache holds what the reference model holds: per mLSTM layer C
    (B, 4, 32, 32), n, m f32 and the conv window in the cache's dtype; per
    sLSTM layer c, n, h, m f32.  ``kv_cache_bytes`` prices C in the
    compute dtype (the JAX package's formula), so in bf16 it prices about
    half of what is held."""
    *_, tcfg, _, model = both
    cache = model.init_cache(3, 40)
    kinds = tcfg.layer_kinds
    assert kinds == (C.MLSTM,) * 7 + (C.SLSTM,)
    held = 0
    for i, kind in enumerate(kinds):
        assert cache.k[i] is None and cache.xk[i] is None
        if kind == C.MLSTM:
            C_, n, m, conv = cache.layer(i)
            assert C_.shape == (3, 4, 32, 32) and n.shape == (3, 4, 32)
            assert m.shape == (3, 4) and bool(torch.isneginf(m).all())
            assert conv.shape == (3, 3, 128) and conv.dtype == torch.bfloat16
            assert cache.c[i] is None and cache.h[i] is None
            held += 4 * (3 * 4 * 32 * 32 + 3 * 4 * 32 + 3 * 4) + 2 * 3 * 3 * 128
        else:
            c, n, h, m = cache.layer(i)
            assert c.shape == h.shape == (3, 64) and cache.C[i] is None
            held += 4 * 4 * 3 * 64
    assert cache.nbytes == held
    assert cache.nbytes != tog.kv_cache_bytes(tcfg, 3, 40, "bfloat16")
    assert tog.kv_cache_bytes(tcfg, 3, 40, "bfloat16") == \
        jog.kv_cache_bytes(tcfg, 3, 40, "bfloat16")
    twin = cache.clone()
    for a, b in zip(twin.tensors(), cache.tensors()):
        assert a is not b and torch.equal(a, b)
    twin.C[0].fill_(1.0)
    twin.c[7].fill_(2.0)
    twin.m[7].fill_(3.0)
    cache.copy_(twin)
    assert (cache.C[0] == 1).all() and (cache.c[7] == 2).all()
    assert (cache.m[7] == 3).all() and cache.batch == 3


def test_decode_step_updates_the_state_in_place(both):
    """Every state tensor keeps its identity through a step (so that a
    captured CUDA graph carries it), every recurrent state moves, and pos
    advances on the device."""
    *_, model = both
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (2, 9)))
    with torch.no_grad():
        _, cache = model.prefill(tokens[:, :8])
        before = cache.clone()
        ids = [id(t) for t in cache.tensors()]
        _, out = model.decode_step(tokens[:, 8], cache)
    assert out is cache and [id(t) for t in cache.tensors()] == ids
    assert int(cache.pos) == 9
    for a, b in zip(cache.tensors()[:-1], before.tensors()[:-1]):
        assert not torch.equal(a, b)


def test_cast_weights_keeps_the_gates_f32():
    """After ``cast_weights_(bf16)`` the projections and the sLSTM's FFN
    are bf16; ``w_if``, ``wx``, ``rh``, the conv taps and the norms stay
    f32; a bf16 prefill and step run, carrying f32 states."""
    jcfg, tcfg = _cfgs("bfloat16")
    model = cast_weights_(convert.from_jax_params(
        _params_np(_cfgs()[0]), tcfg, device="cpu"), torch.bfloat16)
    ml, sl = model.blocks[0].mlstm, model.blocks[7].slstm_blk
    assert {ml.w_up.w.dtype, ml.wq.w.dtype, ml.wk.w.dtype, ml.wv.w.dtype,
            ml.w_down.w.dtype, sl.ff.w_in.w.dtype, sl.ff.w_out.w.dtype,
            model.embed.w.dtype} == {torch.bfloat16}
    assert {ml.w_if.w.dtype, ml.w_if.b.dtype, sl.slstm.wx.w.dtype,
            sl.slstm.wx.b.dtype, sl.slstm.rh.w.dtype, ml.conv.w.dtype,
            ml.out_norm.scale.dtype, model.blocks[0].ln1.scale.dtype} == {
                torch.float32}
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, 512, (1, 12)))
    with torch.no_grad():
        logits, cache = model.prefill(tokens, max_len=16)
        step, _ = model.decode_step(tokens[:, -1], cache)
    assert logits.dtype == step.dtype == torch.bfloat16
    assert cache.C[0].dtype == cache.c[7].dtype == torch.float32
    assert cache.conv[0].dtype == torch.bfloat16
    assert torch.isfinite(step.float()).all()


def test_convert_maps_a_rem_layer():
    """10 = 1 x 8 + 2: ``rem0`` and ``rem1`` are layers 8 and 9, both
    mLSTM; every leaf lands and the forward matches the JAX package's."""
    jcfg, tcfg = _cfgs(n_layers=10)
    assert jT.grouping(jcfg) == (1, 2) and jT.grouping(jcr.get(NAME)) == (6, 0)
    params = _params_np(jcfg)
    model = convert.from_jax_params(params, tcfg, device="cpu")
    n_np = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_np == sum(p.numel() for p in model.parameters())
    np.testing.assert_array_equal(model.blocks[9].mlstm.w_if.b.numpy(),
                                  params["rem1"]["mlstm"]["w_if"]["b"])
    np.testing.assert_array_equal(model.blocks[8].mlstm.conv.w.numpy(),
                                  params["rem0"]["mlstm"]["conv"]["w"])
    np.testing.assert_array_equal(
        model.blocks[7].slstm_blk.slstm.rh.w.numpy(),
        params["blocks"]["sub7"]["slstm_blk"]["slstm"]["rh"]["w"][0])
    tokens = np.random.default_rng(8).integers(0, 512, (2, 10))
    jlogits, _ = jmr.build(jcfg).forward(jax.tree.map(jnp.asarray, params),
                                         jnp.asarray(tokens))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


def test_build_from_seed_in_the_jax_distributions():
    """Seeded weights: conv taps normal / width, projections normal /
    sqrt(fan_in), zero biases, unit norms; ``build(dtype=bf16)`` equals
    build-then-cast; the forward is finite."""
    _, tcfg = _cfgs()
    model = tmr.build(tcfg, device="cpu", seed=0)
    ml = model.blocks[0].mlstm
    assert abs(float(ml.conv.w.std()) - 1 / 4) < 0.05
    assert abs(float(ml.wq.w.std()) * 128 ** 0.5 - 1) < 0.1
    assert not ml.w_if.b.any() and bool((ml.out_norm.scale == 1).all())
    bf = tmr.build(tcfg, device="cpu", seed=0, dtype=torch.bfloat16)
    cast_weights_(model, torch.bfloat16)
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 bf.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    tokens = torch.randint(0, 512, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = tmr.build(tcfg, device="cpu", seed=0)(tokens)
    assert torch.isfinite(out).all() and out.shape == (2, 16, 512)


def test_bf16_step_drift_like_the_references():
    """Each model's bf16 decode steps drift from its own forward no
    further than the JAX package's do from its forward, on the same
    weights and tokens (times 1.5, plus 0.02): xlstm at 8 layers,
    recurrentgemma-2b at 5 over a wrapped 64-slot ring."""
    for arch, n_layers, B, P, steps, cap in (
            (NAME, 8, 2, 24, 8, None),
            ("recurrentgemma-2b", 5, 2, 70, 8, 96)):
        jcfg = dataclasses.replace(jcr.reduced(arch, n_layers=n_layers),
                                   compute_dtype="bfloat16")
        tcfg = dataclasses.replace(tcr.reduced(arch, n_layers=n_layers),
                                   compute_dtype="bfloat16")
        params = _params_np(dataclasses.replace(jcfg,
                                                compute_dtype="float32"))
        jm, jp = jmr.build(jcfg), jax.tree.map(jnp.asarray, params)
        model = convert.from_jax_params(params, tcfg, device="cpu")
        tokens = np.random.default_rng(9).integers(0, 512, (B, P + steps))
        cap = cap or P + steps

        def drift(fwd, prefill, step):
            want = fwd(tokens)[:, P:]
            scale = np.abs(want).max()
            cache, errs = prefill(tokens[:, :P]), []
            for t in range(steps - 1):
                lg, cache = step(tokens[:, P + t], cache)
                errs.append(float(np.abs(lg - want[:, t]).max() / scale))
            return max(errs)

        ref = drift(lambda t: _np(jm.forward(jp, jnp.asarray(t))[0]),
                    lambda t: jm.prefill(jp, jnp.asarray(t), max_len=cap)[1],
                    lambda t, c: (lambda o: (_np(o[0]), o[1]))(
                        jm.decode_step(jp, jnp.asarray(t), c)))
        with torch.no_grad():
            port = drift(
                lambda t: model(torch.from_numpy(t)).float().numpy(),
                lambda t: model.prefill(torch.from_numpy(t),
                                        max_len=cap)[1],
                lambda t, c: (lambda o: (o[0].float().numpy(), o[1]))(
                    model.decode_step(torch.from_numpy(t), c)))
        assert port <= 1.5 * ref + 0.02, (arch, port, ref)


def test_layer_bf16_step_drift_on_the_references_inputs():
    """Each mLSTM layer alone in bf16, on the normed inputs the JAX
    package's forward gives it (the same weights): a prefill of 48
    positions and 8 block steps against the block's own forward.  The
    port's largest step error is within 1.5 times the JAX package's, plus
    0.01 (the bf16 layer readings of ``chip_smoke.py``'s phase ``xlstm``
    are reported, not gated, on this ground)."""
    from repro.configs import base as JC
    from repro.models import layers as JL
    jcfg, tcfg = _cfgs("bfloat16")
    params = jmr.build(jcfg).init(jax.random.key(3))
    tokens = jnp.asarray(np.random.default_rng(3).integers(0, 512, (2, 56)))
    P, n, cdt = 48, 8, jnp.bfloat16
    block = jax.jit(lambda p, h: jR.mlstm_block(
        p, h, jcfg, compute_dtype=cdt, return_state=True))
    step = jax.jit(lambda p, h, c: jR.mlstm_block_step(p, h, c, jcfg, cdt))
    x = JL.embed(params["embed"], tokens, cdt)
    worst = {"jax": 0.0, "port": 0.0}
    for li, kind in enumerate(jcfg.layer_kinds):
        lp = jT._layer_params(params, jcfg, li)
        h = JL.rmsnorm(lp["ln1"], x, jcfg.norm_eps)
        if kind == JC.SLSTM:
            x = x + jR.slstm_block(lp["slstm_blk"], h, jcfg, cdt)
            continue
        y_all, _ = block(lp["mlstm"], h)
        ref = _np(y_all[:, P:])
        _, cache = block(lp["mlstm"], h[:, :P])
        blk = _load(tR.MLSTMBlock(tcfg), jax.tree.map(np.asarray,
                                                      lp["mlstm"]))
        th = torch.from_numpy(_np(h)).to(torch.bfloat16)
        with torch.no_grad():
            ty = blk(th, torch.bfloat16)[0][:, P:].float().numpy()
            state = blk(th[:, :P], torch.bfloat16)[1]
            for t in range(n):
                jy, cache = step(lp["mlstm"], h[:, P + t:P + t + 1], cache)
                y = blk.step(th[:, P + t:P + t + 1], *state, torch.bfloat16)
                worst["jax"] = max(worst["jax"], float(
                    np.abs(_np(jy[:, 0]) - ref[:, t]).max()
                    / np.abs(ref).max()))
                worst["port"] = max(worst["port"], float(
                    np.abs(y[:, 0].float().numpy() - ty[:, t]).max()
                    / np.abs(ty).max()))
        x = x + y_all
    assert worst["port"] <= 1.5 * worst["jax"] + 0.01, worst


def test_xlstm_builds_and_a_kind_outside_ported_raises():
    model = tmr.build(tcr.reduced(NAME), device="cpu")
    assert [b.kind for b in model.blocks] == [C.MLSTM] * 7 + [C.SLSTM]
    bogus = dataclasses.replace(tcr.reduced(NAME), block_pattern=("bogus",))
    with pytest.raises(NotImplementedError, match="bogus"):
        tmr.build(bogus, device="cpu")


def test_serve_launcher_serves_xlstm_on_the_cpu():
    args = serve.parse_args(["--arch", NAME, "--reduced", "--requests", "3",
                             "--prompt-len", "8", "--max-new", "3",
                             "--max-batch", "2", "--device", "cpu"])
    engine, done = serve.serve(args)
    assert [len(r.out_tokens) for r in done] == [3, 3, 3]
    assert engine.stats.prefills == 2 and engine.stats.decode_steps == 4


def test_serve_xlstm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        serve.run(serve.parse_args(["--arch", NAME, "--reduced"]))
    with pytest.raises(RuntimeError):
        tmr.build(tcr.reduced(NAME))
