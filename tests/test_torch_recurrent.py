"""The port's hybrid model kind (RG-LRU blocks and sliding-window ring
attention, ``reduced("recurrentgemma-2b", n_layers=5)``: one period and
both ``rem`` layers, d 160, 10/1 heads at hd 16, window 64, vocab 512)
against the JAX package, on the same weights and the same numpy inputs
from a seed.  No test here builds a full-width config.

Tolerances:
- conv1d and the scan: atol 1e-5, the JAX package's own
  (``tests/test_recurrent.py``); conv1d in bf16: equal to ``jax.jit`` of
  the reference; the RG-LRU block and its step: 2e-5
  (same file).  Both sides compute in f32; the scans differ in the order
  of their products (JAX's odd-even associative scan against recursive
  doubling).
- the model's f32 forward, prefill and decode logits: atol 1e-4 / rtol
  1e-4, the dense forward's (``tests/test_torch_models.py``).
- the gates from bf16 inputs: atol 1e-5 (f32 both sides, the same f32
  weights).
- slot layouts, ring positions and parameter counts: equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jcr  # noqa: E402
from repro.models import recurrent as jR  # noqa: E402
from repro.models import registry as jmr  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import base as C  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import opgraph as tog  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import recurrent as tR  # noqa: E402
from repro_torch.models import registry as tmr  # noqa: E402
from repro_torch.models.transformer import cast_weights_  # noqa: E402

NAME = "recurrentgemma-2b"
N_LAYERS = 5


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _cfgs():
    return (_f32(jcr.reduced(NAME, n_layers=N_LAYERS)),
            _f32(tcr.reduced(NAME, n_layers=N_LAYERS)))


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


@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = _cfgs()
    params = _params_np(jcfg)
    return (jcfg, jmr.build(jcfg), jax.tree.map(jnp.asarray, params), tcfg,
            params, convert.from_jax_params(params, tcfg, device="cpu"))


def _rec_params(seed=0):
    """One RG-LRU block's JAX parameters (numpy) and the port's block."""
    jcfg, tcfg = _cfgs()
    p = jax.tree.map(np.asarray, jR.init_rglru_block(jax.random.key(seed),
                                                     jcfg))
    blk = tR.RGLRUBlock(tcfg)
    blk.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         convert._flatten(p).items()}, strict=True)
    return jcfg, p, blk


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ----- conv1d, scan, block and step -----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_causal_and_step_match_jax(dtype):
    """float32 at the JAX package's atol; bf16 against ``jax.jit`` of the
    reference, equal: the causal conv rounds each tap's product and partial
    sum to bf16, the step's einsum sums in f32 and rounds once."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((4, 24)) / 4).astype(np.float32)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jx, jstate = (jnp.asarray(a, dtype) for a in (x, state))
    tx, tstate = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (x, state))
    jw, tw = {"w": jnp.asarray(w)}, torch.from_numpy(w)
    atol = 1e-5 if dtype == "float32" else 0.0
    want = jax.jit(jR.conv1d_causal)(jw, jx)
    got = tR.conv1d_causal(tw, tx)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=atol,
                               rtol=0)
    jy, jst = jax.jit(jR.conv1d_step)(jw, jx[:, :1], jstate)
    y, st = tR.conv1d_step(tw, tx[:, :1], tstate)
    np.testing.assert_allclose(y.float().numpy(), _np(jy), atol=atol, rtol=0)
    np.testing.assert_array_equal(st.float().numpy(), _np(jst))


@pytest.mark.parametrize("S", [1, 12, 37, 128])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(S, with_h0):
    """Recursive doubling against ``jax.lax.associative_scan``, from zero
    and from a carried state, at lengths that are and are not powers of
    two."""
    jcfg, p, blk = _rec_params()
    rng = np.random.default_rng(S)
    xb = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, jcfg.d_model)).astype(np.float32) \
        if with_h0 else None
    want = jR.rglru_scan(p, jnp.asarray(xb),
                         None if h0 is None else jnp.asarray(h0))
    got = tR.rglru_scan(blk.lru, torch.from_numpy(xb),
                        None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, 21, 5)))
    b = torch.from_numpy(rng.standard_normal((3, 21, 5)))
    h, want = torch.zeros(3, 5, dtype=a.dtype), []
    for t in range(21):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(tR.linear_scan(a, b), torch.stack(want, 1),
                               atol=1e-12, rtol=1e-12)


def test_rglru_step_matches_jax():
    jcfg, p, blk = _rec_params()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    h = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    jy, jh = jR.rglru_step(p, jnp.asarray(x), jnp.asarray(h))
    y, hn = tR.rglru_step(blk.lru, torch.from_numpy(x), torch.from_numpy(h))
    assert hn.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), _np(jy), atol=1e-5)
    np.testing.assert_allclose(hn.numpy(), _np(jh), atol=1e-5)


def test_rglru_block_and_step_match_jax():
    """The block over a sequence with its carried state, then steps from
    that state, against ``rglru_block(return_state=True)`` and
    ``rglru_block_step``."""
    jcfg, p, blk = _rec_params(seed=3)
    rng = np.random.default_rng(3)
    x = (0.5 * rng.standard_normal((2, 10, jcfg.d_model))).astype(np.float32)
    want, jstate = jR.rglru_block(p, jnp.asarray(x), jcfg, return_state=True)
    with torch.no_grad():
        got, (h, conv) = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)
    np.testing.assert_allclose(h.numpy(), _np(jstate["h"]), atol=2e-5)
    np.testing.assert_array_equal(conv.shape, jstate["conv"].shape)
    np.testing.assert_allclose(conv.numpy(), _np(jstate["conv"]), atol=2e-5)
    jcache = {"h": jnp.asarray(h.numpy()), "conv": jnp.asarray(conv.numpy())}
    for t in range(4):
        xt = (0.5 * rng.standard_normal((2, 1, jcfg.d_model))).astype(np.float32)
        jy, jcache = jR.rglru_block_step(p, jnp.asarray(xt), jcache, jcfg)
        with torch.no_grad():
            y = blk.step(torch.from_numpy(xt), h, conv)      # h, conv in place
        np.testing.assert_allclose(y.numpy(), _np(jy), atol=2e-5)
        np.testing.assert_allclose(h.numpy(), _np(jcache["h"]), atol=2e-5)
        np.testing.assert_allclose(conv.numpy(), _np(jcache["conv"]),
                                   atol=2e-5)


def test_rglru_block_from_scratch_matches_its_steps():
    """Steps from ``init_rglru_cache`` give the block's sequence output
    (the JAX package's ``test_rglru_block_step_matches_block``)."""
    jcfg, p, blk = _rec_params(seed=4)
    _, tcfg = _cfgs()
    x = torch.from_numpy((0.5 * np.random.default_rng(4).standard_normal(
        (1, 10, jcfg.d_model))).astype(np.float32))
    h, conv = tR.init_rglru_cache(tcfg, 1)
    assert h.shape == (1, tcfg.lru_dim) and conv.shape == (1, 3, tcfg.lru_dim)
    with torch.no_grad():
        full, _ = blk(x)
        steps = torch.cat([blk.step(x[:, t:t + 1], h, conv)
                           for t in range(10)], 1)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), atol=2e-5)


def test_short_prompt_conv_state_is_zero_padded():
    """A prompt shorter than the conv's window leaves zero rows before
    it in the state, which a step then reads as the inputs before the
    start (the forward's zero padding)."""
    _, _, blk = _rec_params(seed=5)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 3, blk.wx.w.shape[0])).astype(np.float32))
    with torch.no_grad():
        full, _ = blk(x)
        out, (h, conv) = blk(x[:, :2])
        assert conv.shape[1] == 3 and not conv[:, 0].any()
        step = blk.step(x[:, 2:], h, conv)
    np.testing.assert_allclose(step.numpy(), full[:, 2:].numpy(), atol=2e-5)


def test_gates_stay_f32_in_bf16():
    """After ``cast_weights_(bf16)`` the projections are bf16 but the gate
    weights, conv taps and Λ stay f32, and the gates of bf16 inputs are the
    JAX package's f32 ``_rglru_gates``."""
    jcfg, tcfg = _cfgs()
    params = _params_np(jcfg)
    model = cast_weights_(convert.from_jax_params(
        params, dataclasses.replace(tcfg, compute_dtype="bfloat16"),
        device="cpu"), torch.bfloat16)
    rec = model.blocks[0].rec
    assert rec.wx.w.dtype == rec.w_lru_out.w.dtype == torch.bfloat16
    assert model.blocks[2].attn.wq.w.dtype == torch.bfloat16
    assert {rec.lru.w_r.w.dtype, rec.lru.w_i.w.dtype, rec.lru.a_param.dtype,
            rec.conv.w.dtype, model.blocks[0].ln1.scale.dtype} == {
                torch.float32}
    xb = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 7, tcfg.lru_dim)).astype(np.float32)).to(torch.bfloat16)
    a, b = rec.lru.gates(xb)
    assert a.dtype == b.dtype == torch.float32
    p0 = jax.tree.map(lambda x: jnp.asarray(x[0]),
                      params["blocks"]["sub0"]["rec"])
    ja, jb = jR._rglru_gates(p0, jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16))
    np.testing.assert_allclose(a.numpy(), _np(ja), atol=1e-5)
    np.testing.assert_allclose(b.numpy(), _np(jb), atol=1e-5)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (1, 12)))
    with torch.no_grad():
        logits, cache = model.prefill(tokens, max_len=16)
        assert cache.h[0].dtype == torch.float32
        assert cache.conv[0].dtype == torch.bfloat16
        step, _ = model.decode_step(tokens[:, -1], cache)
    assert cache.h[0].dtype == torch.float32                # carried in f32
    assert logits.dtype == step.dtype == torch.bfloat16
    assert torch.isfinite(step.float()).all()


# ----- the hybrid model -----

def test_forward_where_the_window_bites_matches_jax(both):
    """S 128 over a window of 64: the local layers mask."""
    jcfg, jmodel, jparams, tcfg, _, model = both
    assert jcfg.sliding_window == 64
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 128))
    jlogits, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    fk.flash_attention_kernel.launches = 0
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    assert fk.flash_attention_kernel.launches == 0       # CPU: plain version
    assert logits.shape == (2, 128, tL.pad_vocab(jcfg.vocab_size))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


def test_prefill_past_the_window_then_decode_match_jax(both):
    """Prefill 80 tokens (past W 64: the seeded ring has wrapped), then 20
    decode steps, against the JAX ``prefill`` / ``decode_step``."""
    jcfg, jmodel, jparams, tcfg, _, model = both
    S, steps = 80, 20
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                               (2, S + steps))
    jlg, jcache = jmodel.prefill(jparams, jnp.asarray(tokens[:, :S]),
                                 max_len=128)
    with torch.no_grad():
        lg, cache = model.prefill(torch.from_numpy(tokens[:, :S]), max_len=128)
    assert cache.capacity == 128 and int(cache.pos) == S
    assert cache.k[2].shape[2] == 64 and cache.k[0] is None
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


@pytest.mark.parametrize("S,W", [(80, 64), (50, 64), (64, 64), (9, 16)])
def test_seeded_ring_equals_seed_cache(S, W):
    """``seed_kv_cache`` puts the same values in the same slots as the JAX
    package's ``_seed_cache`` (the ring of a LOCAL_ATTN layer), given the
    same k and v."""
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(S)
    k = rng.standard_normal((2, S, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 1, 16)).astype(np.float32)
    want = jT._seed_cache(dataclasses.replace(jcfg, sliding_window=64),
                          jnp.asarray(k), jnp.asarray(v), C.LOCAL_ATTN, W)
    kc, vc = tA.seed_kv_cache(torch.from_numpy(k), torch.from_numpy(v),
                              min(64, W))
    np.testing.assert_array_equal(kc.transpose(1, 2).numpy(),
                                  np.asarray(want["k"]))
    np.testing.assert_array_equal(vc.transpose(1, 2).numpy(),
                                  np.asarray(want["v"]))


@pytest.mark.parametrize("W", [64, 16])
def test_ring_slots_equal_attn_decode_positions(W):
    """The write slot pos mod W and the slot positions
    pos - ((pos - j) mod W) of the JAX ``attn_decode``, computed from a
    position tensor."""
    for pos in (0, 5, W - 1, W, W + 3, 3 * W + 7):
        slot, positions = tA.ring_slots(torch.tensor([pos]), W)
        j = np.arange(W)
        assert int(slot) == pos % W
        np.testing.assert_array_equal(positions.numpy(),
                                      pos - np.mod(pos - j, W))
        assert int(positions[pos % W]) == pos


def test_decode_over_a_wrapped_ring_matches_forward(both):
    """Prefill 70 tokens at capacity 96 (ring of 64, wrapped), then decode
    token by token against the forward over the whole sequence; a ring
    write one slot off is caught."""
    *_, model = both
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (2, 82)))
    with torch.no_grad():
        full = model(tokens)
        scale = float(full.abs().max())
        _, cache = model.prefill(tokens[:, :70], max_len=96)
        start = cache.clone()
        for t in range(70, 82):
            lg, cache = model.decode_step(tokens[:, t], cache)
            assert float((lg - full[:, t]).abs().max()) / scale < 3e-5, t
        ring_slots = tA.ring_slots
        try:
            tA.ring_slots = lambda pos, W: ((pos + 1) % W,
                                            ring_slots(pos, W)[1])
            lg, _ = model.decode_step(tokens[:, 70], start)
        finally:
            tA.ring_slots = ring_slots
    assert float((lg - full[:, 70]).abs().max()) / scale > 1e-3


def test_hybrid_cache_layout_bytes_and_copies(both):
    *_, tcfg, _, model = both
    cache = model.init_cache(3, 40)
    assert int(cache.pos) == 39 and cache.capacity == 40 and cache.batch == 3
    kinds = tcfg.layer_kinds
    assert kinds == (C.RGLRU, C.RGLRU, C.LOCAL_ATTN, C.RGLRU, C.RGLRU)
    for i, kind in enumerate(kinds):
        if kind == C.RGLRU:
            assert cache.k[i] is None and cache.h[i].dtype == torch.float32
            assert cache.conv[i].shape == (3, 3, tcfg.lru_dim)
            assert cache.conv[i].dtype == torch.bfloat16
        else:
            assert cache.h[i] is None
            assert cache.k[i].shape == (3, 1, 40, 16)        # min(64, 40)
    assert model.init_cache(3, 100).k[2].shape[2] == 64      # min(64, 100)
    # h in f32 (4 bytes) and 3 conv rows in bf16: 10 bytes a channel, which
    # is what the predictor's 5 compute-dtype values a channel count in bf16
    assert cache.nbytes == tog.kv_cache_bytes(tcfg, 3, 40, "bfloat16")
    twin = cache.clone()
    for a, b in zip(twin.tensors(), cache.tensors()):
        assert a is not b and torch.equal(a, b)
    twin.h[0].fill_(1.0)
    twin.k[2].fill_(2.0)
    cache.copy_(twin)
    assert (cache.h[0] == 1).all() and (cache.k[2] == 2).all()


def test_convert_maps_every_leaf_including_rem(both):
    """26 = 8 x 3 + 2 at full width; here 5 = 1 x 3 + 2: ``rem0`` and
    ``rem1`` are layers 3 and 4, both RG-LRU."""
    jcfg, jmodel, _, tcfg, params, model = both
    assert jT.grouping(jcfg) == (1, 2)
    assert jT.grouping(jcr.get(NAME)) == (8, 2)
    n_np = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_np == sum(p.numel() for p in model.parameters())
    assert n_np == jmodel.count_params()
    np.testing.assert_array_equal(model.blocks[4].rec.lru.w_r.w.numpy(),
                                  params["rem1"]["rec"]["lru"]["w_r"]["w"])
    np.testing.assert_array_equal(model.blocks[3].rec.conv.w.numpy(),
                                  params["rem0"]["rec"]["conv"]["w"])
    np.testing.assert_array_equal(
        model.blocks[1].rec.lru.a_param.numpy(),
        params["blocks"]["sub1"]["rec"]["lru"]["a_param"][0])
    np.testing.assert_array_equal(
        model.blocks[2].attn.wk.w.numpy(),
        params["blocks"]["sub2"]["attn"]["wk"]["w"][0])


def test_build_from_seed_matches_jax_init_distributions():
    """Seeded weights in the JAX package's distributions: Λ the same
    linspace, conv taps normal / width, projections normal / sqrt(fan_in);
    the forward is finite."""
    jcfg, tcfg = _cfgs()
    model = tmr.build(tcfg, device="cpu", seed=0)
    jp = jR.init_rglru_block(jax.random.key(0), jcfg)
    rec = model.blocks[0].rec
    np.testing.assert_allclose(rec.lru.a_param.numpy(),
                               np.asarray(jp["lru"]["a_param"]), rtol=1e-6)
    assert abs(float(rec.conv.w.std()) - 1 / 4) < 0.05
    assert abs(float(rec.wx.w.std()) * tcfg.d_model ** 0.5 - 1) < 0.1
    tokens = torch.randint(0, tcfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(tokens)
    assert torch.isfinite(out).all() and out.shape == (2, 16, 512)


def test_serve_launcher_serves_recurrentgemma_on_the_cpu():
    args = serve.parse_args(["--arch", NAME, "--reduced", "--requests", "3",
                             "--prompt-len", "8", "--max-new", "3",
                             "--max-batch", "2", "--device", "cpu"])
    out = serve.run(args)
    assert out["tokens_out"] == 9 and out["decode_steps"] == 4


def test_serve_recurrentgemma_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        serve.run(serve.parse_args(["--arch", NAME, "--reduced"]))
