"""The port's decode path against the JAX package's, on the same weights
(``convert.from_jax_params``) and the same numpy inputs from a seed, at
``reduced("qwen2-0.5b", n_layers=2)``, ``qwen3-mini``, the hybrid
``reduced("recurrentgemma-2b", n_layers=5)`` (RG-LRU and sliding-window
layers; its ring wraps in ``tests/test_torch_recurrent.py``), the xLSTM
``reduced("xlstm-1.3b")`` (mLSTM and sLSTM layers) and the
encoder–decoder ``reduced("whisper-small")`` and
``reduced("llama-3.2-vision-11b")`` (cross attention over the same numpy
context on both sides).

Tolerances:
- ``decode_attention``, f32: atol 2e-5 (``tests/test_attention.py``).
  bf16: both sides take exact f32 products of bf16 operands, sum them in
  f32 (in another order) and round P to bf16 before P V and the output to
  bf16 once, so an element may move by one bf16 rounding of P (up to
  2^-8 · sum_j p_j |v_j|, below 2^-8 · max|v|) and one of the output
  (rtol 2^-8): atol 2^-8 · max|v|, rtol 2^-8.
- prefill + decode logits against the JAX package's, f32: atol 1e-4 /
  rtol 1e-4, the forward's tolerance (``tests/test_torch_models.py``).
- decode from ``init_cache(pos=0)`` against the port's own forward, token
  by token: max|Δ| / max|logits| < 3e-5 (``tests/test_models.py``).
- op enumeration, cache bytes and prediction rows: equal (bit for bit).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jcr  # noqa: E402
from repro.core import opgraph as jog  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro.core.predictor import PM2Lat as JPM2Lat  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import registry as jmr  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import memory_model as mm  # noqa: E402
from repro_torch.core import opgraph as tog  # noqa: E402
from repro_torch.core.predictor import PM2Lat  # noqa: E402
from repro_torch.core.table import TableStore  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402

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
# the cases whose decode step prices an attention read (xLSTM has none)
ATTENTION_CASES = [n for n in CASES if not n.startswith("xlstm")]
NAMES = list(jcr.ARCH_NAMES) + list(jcr.PAPER_MODELS)
CTXS = (1, 512, 4096)


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


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


def _both(name):
    jcfg, tcfg = _f32(CASES[name](jcr)), _f32(CASES[name](tcr))
    params = _params_np(jcfg)
    return (jcfg, jmr.build(jcfg), jax.tree.map(jnp.asarray, params),
            tcfg, convert.from_jax_params(params, tcfg, device="cpu"))


def _ctx(jmodel, batch, seed=4):
    """A numpy context for a model that takes one, as (JAX, torch)
    arguments; (None, None) otherwise."""
    if not jmodel.needs_ctx():
        return None, None
    ctx = np.random.default_rng(seed).standard_normal(
        (batch, jmodel.ctx_len(), jmodel.cfg.d_model)).astype(np.float32)
    return jnp.asarray(ctx), torch.from_numpy(ctx)


# ----- decode_attention -----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_jax(dtype, window):
    B, W, Hq, Hkv, hd = 2, 24, 6, 2, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, W, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, W, Hkv, hd)).astype(np.float32)
    slots = np.arange(W, dtype=np.int32)
    slots[[3, 17, 20]] = -1                   # empty slots
    pos = 18                                  # slots 19.. lie in the future
    jdt = getattr(jnp, dtype)
    want = jA.decode_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                               jnp.asarray(v, jdt), jnp.asarray(slots), pos,
                               window=window)
    tdt = getattr(torch, dtype)
    head_major = lambda x: torch.from_numpy(x).to(tdt).transpose(1, 2) \
        .contiguous()
    got = tA.decode_attention(torch.from_numpy(q).to(tdt), head_major(k),
                              head_major(v), torch.from_numpy(slots).long(),
                              torch.tensor([pos]), window=window)
    assert got.dtype == tdt and got.shape == (B, 1, Hq, hd)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    else:
        vmax = float(np.abs(np.asarray(jnp.asarray(v, jdt).astype(
            jnp.float32))).max())
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2 ** -8 * vmax, rtol=2 ** -8)


def test_decode_attention_scores_are_f32_from_a_bf16_cache():
    """q·k = 1 + 2^-10 from bf16 operands: exact in f32, 1.0 once rounded
    to bf16.  With V in f32 (so that P is not rounded either) the output
    is the f32 score's softmax weight, not the bf16 score's."""
    hd = 4
    q = torch.tensor([1.0, 1.0, 0.0, 0.0]).view(1, 1, 1, hd)
    k = torch.zeros(1, 1, 2, hd, dtype=torch.bfloat16)
    k[0, 0, 0, :2] = torch.tensor([1.0, 2 ** -10])
    v = torch.zeros(1, 1, 2, hd)
    v[0, 0, 0, 0] = 1.0
    o = tA.decode_attention(q, k, v, torch.arange(2), 1)
    sigmoid = lambda s: 1.0 / (1.0 + np.exp(-s))
    want = sigmoid((1.0 + 2 ** -10) / 2.0)      # scale 1/sqrt(4)
    assert abs(float(o[0, 0, 0, 0]) - want) < 1e-6
    assert abs(want - sigmoid(0.5)) > 5e-5     # what bf16 scores would give


# ----- prefill / decode against the JAX package -----

@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_and_two_decode_steps_match_jax(name):
    jcfg, jmodel, jparams, tcfg, model = _both(name)
    B, S = 2, 12
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S + 2))
    jctx, tctx = _ctx(jmodel, B)
    jlg, jcache = jmodel.prefill(jparams, jnp.asarray(tokens[:, :S]),
                                 ctx_embed=jctx)
    fk.flash_attention_kernel.launches = 0
    with torch.no_grad():
        lg, cache = model.prefill(torch.from_numpy(tokens[:, :S]),
                                  ctx_embed=tctx)
    assert fk.flash_attention_kernel.launches == 0      # CPU: plain version
    assert lg.shape == (B, tL.pad_vocab(jcfg.vocab_size))
    assert cache.capacity == S + 64 and int(cache.pos) == S
    assert all(k.dtype == torch.float32                 # the compute dtype
               for k in cache.k if k is not None)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=1e-4)
    for t in range(2):
        jlg, jcache = jmodel.decode_step(jparams,
                                         jnp.asarray(tokens[:, S + t]), jcache)
        with torch.no_grad():
            lg, cache = model.decode_step(torch.from_numpy(tokens[:, S + t]),
                                          cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=1e-4)
    assert int(cache.pos) == int(jcache["pos"]) == S + 2


def _jax_layer_cache(jcfg, jcache, i):
    """Layer ``i``'s entry of a JAX cache (a period of ``scan/sub<j>`` or
    a ``rem<r>``)."""
    period = len(jcfg.block_pattern)
    n_scan = jcfg.n_layers // period * period
    if i < n_scan:
        sub = jcache["layers"]["scan"][f"sub{i % period}"]
        return jax.tree.map(lambda x: np.asarray(x)[i // period], sub)
    return jax.tree.map(np.asarray, jcache["layers"][f"rem{i - n_scan}"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_seeds_the_jax_cache(name):
    """The seeded caches hold the JAX package's post-RoPE K/V (head-major),
    zeros past the prompt, at the capacity asked for; a recurrent layer
    its state (RG-LRU h, conv; mLSTM C, n, m, conv; sLSTM c, n, h, m); a
    cross-attention layer the context's K/V besides."""
    jcfg, jmodel, jparams, tcfg, model = _both(name)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 9))
    jctx, tctx = _ctx(jmodel, 2)
    _, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), ctx_embed=jctx,
                               max_len=16)
    with torch.no_grad():
        _, cache = model.prefill(torch.from_numpy(tokens), ctx_embed=tctx,
                                 max_len=16)
    assert cache.capacity == 16
    for i in range(tcfg.n_layers):
        jl = _jax_layer_cache(jcfg, jcache, i)
        if "rec" in jl:
            for key, want in jl["rec"].items():
                np.testing.assert_allclose(getattr(cache, key)[i].numpy(),
                                           want, atol=1e-4, rtol=1e-4)
            continue
        assert cache.k[i].shape[2] == jl["self"]["k"].shape[1] == 16
        np.testing.assert_allclose(cache.k[i].transpose(1, 2).numpy(),
                                   jl["self"]["k"], atol=1e-4, rtol=1e-4)
        assert not cache.k[i][:, :, 9:].any() and not cache.v[i][:, :, 9:].any()
        assert ("cross" in jl) == (cache.xk[i] is not None)
        if "cross" in jl:
            for got, key in ((cache.xk[i], "k"), (cache.xv[i], "v")):
                np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                                           jl["cross"][key], atol=1e-4,
                                           rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_from_scratch_matches_forward(name):
    """init_cache(pos=0) and decode token by token against the forward
    (the JAX package's ``test_decode_cache_from_scratch``); a model with
    cross attention takes its context's K/V from a prefill."""
    _, jmodel, *_, model = _both(name)
    B, S = 1, 6
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (B, S)))
    _, ctx = _ctx(jmodel, B)
    with torch.no_grad():
        full = model(tokens, ctx_embed=ctx)
        cache = model.init_cache(B, 16, pos=0, dtype=torch.float32)
        if ctx is not None:
            _, seeded = model.prefill(tokens[:, :1], ctx_embed=ctx)
            cache.xk, cache.xv = seeded.xk, seeded.xv
        scale = float(full.abs().max())
        for t in range(S):
            lg, cache = model.decode_step(tokens[:, t], cache)
            err = float((lg - full[:, t]).abs().max()) / scale
            assert err < 3e-5, (t, err)


def test_init_cache_defaults_and_bytes():
    cfg = tcr.reduced("qwen2-0.5b", n_layers=2)
    model = convert.from_jax_params(_params_np(_f32(jcr.reduced(
        "qwen2-0.5b", n_layers=2))), _f32(cfg), device="cpu")
    cache = model.init_cache(3, 40)
    assert int(cache.pos) == 39 and cache.capacity == 40
    assert cache.k[0].dtype == torch.bfloat16 and len(cache.k) == 2
    assert cache.k[0].shape == (3, cfg.n_kv_heads, 40, cfg.head_dim)
    assert cache.nbytes == tog.kv_cache_bytes(cfg, 3, 40, "bfloat16")
    kc, vc = tA.init_kv_cache(cfg, 2, 8, dtype=torch.float32)
    assert kc.shape == vc.shape == (2, cfg.n_kv_heads, 8, cfg.head_dim)
    assert kc.dtype == torch.float32 and not kc.any() and not vc.any()


def test_prefill_refuses_a_context():
    *_, model = _both("qwen3-mini")
    with pytest.raises(TypeError):
        model.prefill(torch.zeros(1, 4, dtype=torch.long),
                      ctx_embed=torch.zeros(1, 2, 8))
    assert model.make_ctx(4) is None


# ----- decode enumeration -----

def _fields(op):
    d = dataclasses.asdict(op)
    if isinstance(d.get("shape"), list):
        d["shape"] = tuple(d["shape"])
    return type(op).__name__, d


@pytest.mark.parametrize("name", NAMES)
def test_enumerate_decode_ops_equal_field_by_field(name):
    jcfg, tcfg = jcr.get_any(name), tcr.get_any(name)
    for ctx in CTXS:
        for dtype in (None, "bfloat16"):
            jops = jog.enumerate_decode_ops(jcfg, 8, ctx, dtype=dtype)
            tops = tog.enumerate_decode_ops(tcfg, 8, ctx, dtype=dtype)
            assert [_fields(t) for t in tops] == [_fields(j) for j in jops]
            assert [t.flops for t in tops if hasattr(t, "flops")] == \
                [j.flops for j in jops if hasattr(j, "flops")]
            for t, j in zip(tops, jops):
                if getattr(t, "phase", None) == tog.DECODE:
                    assert tog.decode_attention_features(t) == \
                        jog.decode_attention_features(j)
                    assert tog.kv_read_bytes(t) == jog.kv_read_bytes(j)
    g = tog.enumerate_decode_graph(tcfg, 4, 64)
    assert g.phase == tog.DECODE and len(g) == len(
        jog.enumerate_decode_graph(jcfg, 4, 64))
    assert [n.deps for n in g.nodes] == [
        n.deps for n in jog.enumerate_decode_graph(jcfg, 4, 64).nodes]


def test_enumerate_decode_ops_broadcasts_ctx_arrays():
    cfg = tcr.get_any("recurrentgemma-2b")
    ctx = np.array([16, 4096, 10 ** 6])
    ops = tog.enumerate_decode_ops(cfg, 2, ctx)
    jops = jog.enumerate_decode_ops(jcr.get_any("recurrentgemma-2b"), 2, ctx)
    for t, j in zip(ops, jops):
        if getattr(t, "phase", None) == tog.DECODE:
            np.testing.assert_array_equal(t.skv, j.skv)


@pytest.mark.parametrize("name", NAMES)
def test_kv_cache_bytes_equal(name):
    jcfg, tcfg = jcr.get_any(name), tcr.get_any(name)
    for batch, ctx in ((1, 1), (8, 512), (8, 2048), (4, 4096)):
        for dtype in (None, "bfloat16"):
            assert tog.kv_cache_bytes(tcfg, batch, ctx, dtype) == \
                jog.kv_cache_bytes(jcfg, batch, ctx, dtype)


# ----- decode-step prediction from one shared store -----

def _synthetic_memory_model():
    """A memory model fitted to seeded synthetic samples, one regression a
    kernel class: the predictor's arithmetic, not a device's numbers."""
    rng = np.random.default_rng(0)
    samples = []
    for name in ("softmax", "rmsnorm", "add", "gelu", "rope"):
        for i in range(8):
            f = {"bytes": float(rng.uniform(1e4, 1e8)),
                 "flops": float(rng.uniform(1e3, 1e7)),
                 "transcendentals": float(rng.uniform(0, 1e6))}
            dur = 2e-6 + f["bytes"] / 2e12 + f["flops"] / 1e13
            samples.append({"name": f"{name}_{i}", "features": f,
                            "duration": dur * float(rng.uniform(0.9, 1.1))})
    return mm.fit_memory_model(samples).to_json()


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decode_store") / "store.json")
    store = TableStore()
    cal.calibrate_matmul(store, device="cpu", grids=((64, 64), (128, 256)),
                         k_anchors=(32, 64, 128))
    store.memory_model = _synthetic_memory_model()
    store.meta = {"device": cal.device_name("cpu"), "seconds": 0.0}
    store.save(path)
    return path


@pytest.mark.parametrize("name", sorted(ATTENTION_CASES))
@pytest.mark.parametrize("ctx", [1, 513, 2048])
def test_decode_rows_bit_identical_to_jax_predictor(store_path, name, ctx):
    dev = cal.device_name("cpu")
    pm = PM2Lat(TableStore.load(store_path), dev)
    jp = JPM2Lat(jtab.TableStore.load(store_path), dev)
    tcfg, jcfg = CASES[name](tcr), CASES[name](jcr)
    tops = tog.enumerate_decode_ops(tcfg, 8, ctx, dtype="float32")
    jops = jog.enumerate_decode_ops(jcfg, 8, ctx, dtype="float32")
    total, rows = pm.predict_ops(tops)
    assert np.isfinite(total) and total > 0
    for row, t, j in zip(rows, tops, jops):
        assert row.name == t.name == j.name
        if t.kind == "memory":
            # features are the port's own (torch snippets), priced by both
            want = jp.memory_model.predict(t.features(),
                                           mm.class_of(j.snippet)) * j.count
            assert (row.seconds, row.kernel) == (want, "linreg")
        else:
            jr = jp.predict_op(j)
            assert (row.seconds, row.kernel) == (jr.seconds, jr.kernel)
    attn = [r for r in rows if r.kind == "attention"]
    gqa = tcfg.n_heads // tcfg.n_kv_heads
    assert attn and {r.kernel for r in attn} == {f"kv_read@gqa{gqa}"}
    op = next(t for t in tops if t.kind == "attention")
    assert pm.predict_attention(op) == jp.predict_attention(
        next(j for j in jops if j.kind == "attention"))
