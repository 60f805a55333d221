"""The port's encoder–decoder kind against the JAX package's, on the CPU, at
``reduced("whisper-small")`` (2 decoder and 2 encoder layers, 16 frames, d
64) and ``reduced("llama-3.2-vision-11b")`` (cross attention over 16 stub
patches, no encoder), f32, the same weights on both sides
(``convert.from_jax_params``) and the same numpy contexts from a seed.  No
full-width whisper or vision model is built here.

Held here: the encoder alone, the cross-attention decode step, the cross
caches' layout and bytes, the conversion of the encoder's leaves, the
context's errors and ``make_ctx``, and the serve launcher.  Both models'
forward, prefill and decode steps, and whisper's engine tokens, are cases
of the ``CASES`` in ``tests/test_torch_{models,decode,serving}.py``.

Tolerances:
- ``encode``: atol 1e-4 / rtol 1e-4, the forward's
  (``tests/test_torch_models.py``): both sides compute in f32 and differ
  only in the order of sums.
- ``decode_cross``, f32: atol 2e-5 (``tests/test_torch_decode.py``'s
  ``decode_attention``).  bf16: both sides round q, P, the attention's
  output and the projection's output to bf16 at the same places, from f32
  sums taken in another order, so each rounding may land one bf16 step
  (2^-8 relative) apart and carry into the next product: atol 2^-6 ·
  max|out|, rtol 2^-6 (four such steps).
- cache bytes: equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jcr  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import registry as jmr  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import opgraph as tog  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as tmr  # noqa: E402

MODELS = {"whisper-small-reduced": "whisper-small",
          "llama-3.2-vision-reduced": "llama-3.2-vision-11b"}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _both(name):
    """(JAX config, JAX parameters as numpy arrays, the port's model) of
    ``reduced(MODELS[name])`` in f32 from seed 0."""
    jcfg = _f32(jcr.reduced(MODELS[name]))
    params = jax.tree.map(np.asarray, jmr.build(jcfg).init(jax.random.key(0)))
    tcfg = _f32(tcr.reduced(MODELS[name]))
    return jcfg, params, convert.from_jax_params(params, tcfg, device="cpu")


def _ctx(model, batch, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (batch, model.ctx_len(), model.cfg.d_model)).astype(np.float32)


def test_encode_matches_jax():
    jcfg, params, model = _both("whisper-small-reduced")
    ctx = _ctx(model, 2)
    want = jT.encode(jax.tree.map(jnp.asarray, params["encoder"]),
                     jnp.asarray(ctx), jcfg)
    fk.flash_attention_kernel.launches = 0
    with torch.no_grad():
        got = model.encode(torch.from_numpy(ctx))
    assert fk.flash_attention_kernel.launches == 0       # CPU: plain version
    assert got.shape == (2, 16, jcfg.d_model) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # non-causal: the last frame moves the first frame's output
    ctx2 = ctx.copy()
    ctx2[:, -1] += 1.0
    with torch.no_grad():
        moved = model.encode(torch.from_numpy(ctx2))
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_cross_matches_jax(dtype):
    """``decode_cross`` against ``attn_decode(cross=True)``: the same
    projections (no biases, though the config asks for QKV biases) and
    static context K/V, every slot valid."""
    cfg = dataclasses.replace(tcr.reduced("llama-3.2-vision-11b"),
                              qkv_bias=True, compute_dtype=dtype)
    jcfg = dataclasses.replace(jcr.reduced("llama-3.2-vision-11b"),
                               qkv_bias=True, compute_dtype=dtype)
    p = jax.tree.map(np.asarray, jA.init_attn(jax.random.key(1), jcfg,
                                              cross=True))
    assert all("b" not in p[n] for n in ("wq", "wk", "wv"))
    B, Lx = 3, 21
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, Lx, cfg.n_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, cache = jA.attn_decode(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
        {"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt)}, 7,
        compute_dtype=jdt, cross=True)
    attn = tA.Attention(cfg, cross=True)
    attn.load_state_dict({f"{n}.{key}": torch.from_numpy(np.array(a))
                          for n, leaf in p.items() for key, a in leaf.items()})
    head_major = lambda a: torch.from_numpy(a).to(tdt).transpose(1, 2) \
        .contiguous()
    kc, vc = head_major(k), head_major(v)
    before = (kc.clone(), vc.clone())
    with torch.no_grad():
        got = attn.decode_cross(torch.from_numpy(x), kc, vc, compute_dtype=tdt)
    assert torch.equal(kc, before[0]) and torch.equal(vc, before[1])
    assert got.dtype == tdt and got.shape == (B, 1, cfg.d_model)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2 ** -6 * np.abs(want).max(),
                                   rtol=2 ** -6)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_bytes_and_layout(name, dtype):
    """``init_cache`` and ``prefill`` hold ``kv_cache_bytes``: the self
    K/V at the capacity and, in each cross-attention layer, the context's
    K/V (B, Hkv, Lx, hd) besides, carried by ``tensors``, ``clone`` and
    ``copy_``."""
    _, _, model = _both(name)
    cfg = dataclasses.replace(model.cfg,
                              compute_dtype=str(dtype).split(".")[1])
    model.cfg = cfg
    dname = cfg.compute_dtype
    cache = model.init_cache(3, 40, dtype=dtype)
    assert cache.nbytes == tog.kv_cache_bytes(cfg, 3, 40, dname)
    n_cross = cfg.layer_kinds.count("cross_attn")
    assert sum(t is not None for t in cache.xk) == n_cross > 0
    for i, kind in enumerate(cfg.layer_kinds):
        assert (cache.xk[i] is None) == (kind != "cross_attn")
        if cache.xk[i] is not None:
            assert cache.xk[i].shape == (3, cfg.n_kv_heads, model.ctx_len(),
                                         cfg.head_dim)
            assert len(cache.layer(i)) == 4 and cache.layer(i)[2] is \
                cache.xk[i]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)))
    with torch.no_grad():
        _, seeded = model.prefill(tokens, ctx_embed=model.make_ctx(2),
                                  max_len=24)
    assert seeded.nbytes == tog.kv_cache_bytes(cfg, 2, 24, dname)
    assert all(t.dtype == dtype for t in seeded.xk + seeded.xv if t is not None)
    twin = model.init_cache(2, 24, dtype=dtype).copy_(seeded)
    for a, b in zip(twin.tensors(), seeded.clone().tensors()):
        assert torch.equal(a, b)


def test_convert_maps_every_leaf_encoder_included():
    jcfg, params, model = _both("whisper-small-reduced")
    enc = params["encoder"]
    np.testing.assert_array_equal(model.encoder.blocks[1].attn.wq.w.numpy(),
                                  enc["blocks"]["attn"]["wq"]["w"][1])
    np.testing.assert_array_equal(model.encoder.blocks[0].mlp.w_in.w.numpy(),
                                  enc["blocks"]["mlp"]["w_in"]["w"][0])
    np.testing.assert_array_equal(model.encoder.final_norm.scale.numpy(),
                                  enc["final_norm"]["scale"])
    sub = params["blocks"]["sub0"]
    np.testing.assert_array_equal(model.blocks[1].xattn.wk.w.numpy(),
                                  sub["xattn"]["wk"]["w"][1])
    np.testing.assert_array_equal(model.blocks[0].ln_x.scale.numpy(),
                                  sub["ln_x"]["scale"][0])
    assert model.blocks[0].xattn.wq.b is None
    n_np = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_np == sum(p.numel() for p in model.parameters())
    assert n_np == jmr.build(jcfg).count_params()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_context_is_required_and_made_from_a_seed(name):
    _, _, model = _both(name)
    tokens = torch.zeros(2, 4, dtype=torch.long)
    assert model.needs_ctx()
    with pytest.raises(ValueError):
        model(tokens)
    with pytest.raises(ValueError):
        model.prefill(tokens)
    ctx = model.make_ctx(2)
    assert ctx.shape == (2, model.ctx_len(), model.cfg.d_model) and \
        model.ctx_len() == 16
    assert ctx.dtype == torch.float32 and ctx.device == model.embed.w.device
    assert torch.equal(ctx, model.make_ctx(2))          # seed 0 by default
    other = model.make_ctx(2, torch.Generator().manual_seed(1))
    assert not torch.equal(ctx, other)
    model.cfg = dataclasses.replace(model.cfg, compute_dtype="bfloat16")
    assert model.make_ctx(1).dtype == torch.bfloat16


def test_xlstm_and_moe_still_raise_and_name_their_slice():
    """xLSTM is ported (``tests/test_torch_xlstm.py``) and builds, as MoE
    does (``tests/test_torch_moe.py``); a block kind outside ``PORTED``
    still raises, naming itself."""
    model = tmr.build(tcr.reduced("xlstm-1.3b"), device="cpu")
    assert model.blocks[7].slstm_blk is not None
    with pytest.raises(NotImplementedError, match="retnet"):
        tmr.build(dataclasses.replace(tcr.reduced("whisper-small"),
                                      block_pattern=("retnet",)),
                  device="cpu")
    model = tmr.build(tcr.reduced("moonshot-v1-16b-a3b"), device="cpu")
    assert all(blk.moe is not None for blk in model.blocks)


def test_serve_launcher_whisper_on_the_cpu(capsys):
    args = serve.parse_args(["--arch", "whisper-small", "--reduced",
                             "--requests", "3", "--prompt-len", "8",
                             "--max-new", "3", "--max-batch", "2",
                             "--device", "cpu"])
    fk.flash_attention_kernel.launches = 0
    engine, done = serve.serve(args)
    assert fk.flash_attention_kernel.launches == 0       # CPU: plain version
    assert [len(r.out_tokens) for r in done] == [3, 3, 3]
    assert engine.stats.prefills == 2 and engine.stats.decode_steps == 4
    # each wave's tokens are the eager steps' over the engine's context
    model = engine.model
    for wave in (done[:2], done[2:]):
        toks = torch.from_numpy(np.stack([r.prompt for r in wave])).long()
        with torch.no_grad():
            logits, cache = model.prefill(
                toks, ctx_embed=model.make_ctx(len(wave)),
                max_len=engine.max_len)
            out = [logits[:, :model.cfg.vocab_size].argmax(-1)]
            for _ in range(2):
                logits, _ = model.decode_step(out[-1], cache)
                out.append(logits[:, :model.cfg.vocab_size].argmax(-1))
        assert [r.out_tokens for r in wave] == torch.stack(out, 1).tolist()
    serve.summary(engine, done, verbose=True)
    assert "[serve] arch=whisper-small-reduced reqs=3" in \
        capsys.readouterr().out


def test_serve_whisper_defaults_to_the_card():
    assert serve.parse_args(["--arch", "whisper-small"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        serve.run(serve.parse_args(["--arch", "whisper-small", "--reduced"]))
