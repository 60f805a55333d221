"""The flash-attention backward (``kernels/flash_attention_bwd.py``) and
the forward's log-sum-exp against the JAX package's ``flash_attention``
(custom VJP: ``_fa_fwd_scan`` and ``_fa_bwd_scan``), on the same numpy
inputs from a seed.  On the CPU the wrappers take the plain versions; the
hand CUDA kernel is held against them on the card by ``chip_smoke.py``.

Tolerances:
- float32: atol 5e-5 / rtol 1e-3, ``tests/test_attention.py``'s limit for
  the JAX package's own flash against its dense attention (both sides f32;
  sums in another order: KV blocks of 256 and XLA's dots against blocks of
  16 and torch's einsums).
- the log-sum-exp: atol 1e-5 (one f32 log of a sum in another order).
- bfloat16: both sides take the same bf16 inputs and compute in f32, then
  round the gradients to bf16; the limit is 2 bf16 units (2 · 2^-8) of the
  largest gradient of each tensor, as an input rounded to bf16 at a
  different point can differ by one unit and the other unit covers the
  f32 sums' order.
"""
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jA  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fkb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F32_TOL = dict(atol=5e-5, rtol=1e-3)
LSE_ATOL = 1e-5
BF16_UNITS = 2 * 2.0 ** -8

# (B, Sq, Skv, H, Hkv, hd, causal, window): causal, window, non-causal
# (Sq != Skv, as cross attention), GQA groups 7 (qwen2-0.5b's 14 over 2)
# and 1, a ragged Skv (not a multiple of any KV block), bottom-right causal;
# at hd 256 recurrentgemma-2b's local attention (10 query heads over 1)
# under a window below S, over a ragged Sq / Skv, and non-causal
CASES = {
    "causal": (2, 48, 48, 4, 2, 64, True, None),
    "window": (1, 64, 64, 2, 1, 64, True, 16),
    "noncausal": (2, 40, 56, 2, 2, 64, False, None),
    "gqa7": (1, 32, 32, 14, 2, 64, True, None),
    "gqa1": (2, 32, 32, 3, 3, 128, True, None),
    "ragged": (1, 30, 50, 4, 2, 64, True, None),
    "hd256_window": (1, 96, 96, 10, 1, 256, True, 40),
    "hd256_ragged": (1, 70, 93, 10, 1, 256, True, 40),
    "hd256_noncausal": (1, 48, 80, 10, 1, 256, False, None),
}
KV_BLOCK = 16


def _inputs(case, seed=0):
    B, Sq, Skv, H, Hkv, hd, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    return (q, k, v, do), dict(causal=causal, window=window)


def _spec(mask):
    return jA.AttnSpec(causal=mask["causal"], window=mask["window"],
                       kv_block=KV_BLOCK)


def _jax_vjp(arrays, mask, dtype=jnp.float32):
    q, k, v, do = (jnp.asarray(a, dtype) for a in arrays)
    q_offset = k.shape[1] - q.shape[1]
    o, vjp = jax.vjp(lambda q, k, v: jA.flash_attention(
        q, k, v, spec=_spec(mask), q_offset=q_offset), q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *vjp(do))]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_jax_vjp(case):
    arrays, mask = _inputs(case)
    want = _jax_vjp(arrays, mask)
    q, k, v, do = _torch(arrays)
    cfg = fk.select_config(q.shape[1], k.shape[1], q.shape[3])
    o, lse = fk.flash_attention_plain(q, k, v, cfg, q_offset=k.shape[1]
                                      - q.shape[1], return_lse=True, **mask)
    got = fkb.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                        q_offset=k.shape[1] - q.shape[1],
                                        kv_block=KV_BLOCK, **mask)
    for g, w in zip((o, *got), want):
        _close(g, w, **F32_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_matches_jax_vjp(case):
    """``ops.flash_attention`` under autograd: the forward with its lse
    saved, the backward wrapper (the plain version on CPU tensors)."""
    arrays, mask = _inputs(case, seed=1)
    want = _jax_vjp(arrays, mask)
    q, k, v, do = _torch(arrays)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fkb.flash_attention_bwd_kernel.launches = 0
    o = ops.flash_attention(q, k, v, **mask)
    got = torch.autograd.grad(o, (q, k, v), do)
    assert fkb.flash_attention_bwd_kernel.launches == 0   # CPU: plain version
    for g, w in zip((o.detach(), *got), want):
        _close(g, w, **F32_TOL)


@pytest.mark.parametrize("case", ["causal", "window", "gqa7", "ragged",
                                  "hd256_window"])
def test_bf16_autograd_matches_jax_vjp(case):
    arrays, mask = _inputs(case, seed=2)
    want = _jax_vjp(arrays, mask, jnp.bfloat16)
    q, k, v, do = _torch(arrays, torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = ops.flash_attention(q, k, v, **mask)
    got = torch.autograd.grad(o, (q, k, v), do)
    for g, w in zip(got, want[1:]):
        assert g.dtype == torch.bfloat16
        _close(g, w, atol=BF16_UNITS * float(np.abs(w).max()), rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_matches_fwd_scan(case):
    arrays, mask = _inputs(case, seed=3)
    q, k, v, _ = arrays
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    pad = (-Skv) % KV_BLOCK
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    _, lse_j = jA._fa_fwd_scan(
        jnp.asarray(q.reshape(B, Sq, Hkv, H // Hkv, hd)), jnp.asarray(kp),
        jnp.asarray(vp), Skv - Sq, _spec(mask), 0, (Skv + pad) // KV_BLOCK,
        Skv if pad else None)
    want = np.asarray(lse_j).reshape(B, Sq, H).transpose(0, 2, 1)
    cfg = fk.select_config(Sq, Skv, hd)
    _, lse = fk.flash_attention_kernel(*_torch((q, k, v)), cfg,
                                       q_offset=Skv - Sq, return_lse=True,
                                       **mask)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=LSE_ATOL, rtol=0)


def test_second_order_gradients_raise():
    arrays, mask = _inputs("causal")
    q, k, v, _ = (t.requires_grad_() for t in _torch(arrays))
    o = ops.flash_attention(q, k, v, **mask)
    (dq,) = torch.autograd.grad(o.sum(), q, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dq.sum(), k)


def test_no_grad_call_writes_no_lse_and_records_no_graph():
    """Inference keeps the forward alone: no autograd node, no lse."""
    q, k, v, _ = _torch(_inputs("causal")[0])
    o = ops.flash_attention(q, k, v)
    assert o.grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.flash_attention(q, k, v).grad_fn is not None


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, do = _torch(_inputs("causal")[0])
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    with pytest.raises(ValueError):
        fkb.flash_attention_bwd_kernel(q, k[:, :, :1], v, q, lse, do)
    with pytest.raises(ValueError):
        fkb.flash_attention_bwd_kernel(q, k, v, q, lse[:, :, 1:], do)
    with pytest.raises(TypeError):
        fkb.flash_attention_bwd_kernel(q, k, v, q, lse.double(), do)
    with pytest.raises(ValueError):
        fkb.flash_attention_bwd_kernel(q, k, v, q, lse, do, window=0)
    with pytest.raises(ValueError):
        fkb.flash_attention_bwd_kernel(q, k, v, q, lse, do.to("meta"))


def test_cuda_instances_are_the_head_dims_in_both_types():
    """csrc/flash_attention_bwd.cu instantiates each of ``HEAD_DIMS`` once
    per type (float32 through ``launch_f32``, the FFMA kernels; bfloat16
    through ``launch_bf16``, the wgmma kernels), and the shared-memory
    getter answers for the same head dims."""
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    inst = re.findall(r"^\s*PM2LAT_FA_BWD\((\w+), (\d), (\d+)\)\s*$", text,
                      re.M)
    assert sorted((int(dt), int(hd)) for _, dt, hd in inst) == sorted(
        (dt, hd) for dt in fkb.DTYPES.values() for hd in fkb.HEAD_DIMS)
    assert {(launch, int(dt)) for launch, dt, _ in inst} == {
        ("launch_f32", fkb.DTYPES[torch.float32]),
        ("launch_bf16", fkb.DTYPES[torch.bfloat16])}
    smem = re.findall(r"^\s*PM2LAT_FA_BWD_SMEM\((\d+)\)\s*$", text, re.M)
    assert tuple(map(int, smem)) == fkb.HEAD_DIMS
    assert "flash_attention_bwd" in build.SOURCES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", fkb.HEAD_DIMS)
def test_bwd_smem_is_the_tile_layout(hd, dtype):
    """bfloat16: 1 KB of alignment slack, six swizzled [64][hd] bf16 tiles
    (K, V and two stages of Q and dO; Q, dO and two stages of K and V),
    dK/dV's two stages of 64 rows' (lse, D) and 256 bytes of barriers.
    float32: five [64][hd + 4] f32 tiles (K, V, two Q stages, dO; Q, dO,
    two K stages, V), one [64][68] score tile and (lse, D) of two Q tiles
    (dK/dV) or one (dQ); at hd 256 (two blocks a tile, one a column half)
    four [64][68] chunk tiles, the half's columns of Q and dO (dK/dV) or
    of K (dQ) as [64][132] tiles, the score tile and one Q tile's (lse,
    D).  All within one block's 227 KB; the float32 kernels up to hd 64
    within half an SM's 228 KB (two blocks an SM)."""
    dt = getattr(torch, dtype)
    if dt == torch.bfloat16:
        tiles = 1024 + 6 * 64 * hd * 2 + 256
        assert fkb.smem_bytes(hd, "dkdv", dt) == tiles + 2 * 64 * 8
        assert fkb.smem_bytes(hd, "dq", dt) == tiles
    elif hd == 256:
        assert fkb.column_halves(hd) == 2
        fixed = 4 * 64 * 68 + 64 * 68 + 128
        assert fkb.smem_bytes(hd, "dkdv", dt) == 4 * (fixed + 2 * 64 * 132)
        assert fkb.smem_bytes(hd, "dq", dt) == 4 * (fixed + 64 * 132)
    else:
        tiles = 5 * 64 * (hd + 4) + 64 * 68
        assert fkb.smem_bytes(hd, "dkdv", dt) == 4 * (tiles + 256)
        assert fkb.smem_bytes(hd, "dq", dt) == 4 * (tiles + 128)
        if hd <= 64:
            assert all(2 * (fkb.smem_bytes(hd, k, dt) + build.BLOCK_RESERVED_SMEM)
                       <= build.SM_SMEM for k in fkb.KERNELS)
    assert max(fkb.smem_bytes(hd, k, dt) for k in fkb.KERNELS) \
        <= fk.SMEM_BUDGET


def test_hd256_fits_one_block_in_both_types():
    """hd 256 is an instance of both types, and each of its four tile
    kernels' shared memory is within what one H100 block can use (227 KB):
    the bf16 dK/dV kernel at 194.25 KB, the float32 ones at 151.5 and
    118.5 KB (column halves, 64-column chunks)."""
    assert 256 in fkb.HEAD_DIMS
    got = {(k, str(dt)): fkb.smem_bytes(256, k, dt) for k in fkb.KERNELS
           for dt in fkb.DTYPES}
    assert all(b <= 227 * 1024 == fk.SMEM_BUDGET for b in got.values())
    assert got[("dkdv", "torch.bfloat16")] == 198912
    assert got[("dkdv", "torch.float32")] == 155136
    assert got[("dq", "torch.float32")] == 121344


# (Sq, Skv, causal, window, q_offset) for the tile bounds: CASES' masks,
# and a q_offset > 0 with Sq < Skv, windows narrower than a tile, lengths
# that are no multiple of 64, the train path's square, and rows that keep
# no key (q_offset < 0; qp past every key's window)
TILE_CASES = {
    **{name: (c[1], c[2], c[6], c[7], c[2] - c[1]) for name, c in CASES.items()},
    "train": (512, 512, True, None, 0),
    "offset": (100, 229, True, None, 129),
    "offset_window": (160, 300, True, 40, 140),
    "narrow_window": (300, 300, True, 16, 0),
    "window_one": (130, 130, True, 1, 0),
    "ragged_square": (190, 190, True, 50, 0),
    "ragged_noncausal": (200, 333, False, None, 133),
    "dead_head": (200, 100, True, None, -100),
    "dead_tail": (128, 64, True, 16, 200),
}


def _kept_tiles(Sq, Skv, causal, window, q_offset):
    """(nq, nk) booleans: tile (i, j) holds a (q, k) pair whose P the
    reference does not zero: a pair ``_block_mask`` keeps, or any pair of
    a row it keeps no key for (the additive mask leaves such rows P = 1)."""
    nq, nk = -(-Sq // fkb.TILE), -(-Skv // fkb.TILE)
    spec = jA.AttnSpec(causal=causal, window=window)
    mask = np.asarray(jA._block_mask(jnp.arange(Sq) + q_offset,
                                     jnp.arange(nk * fkb.TILE), spec, Skv))
    kept = mask == 0
    kept[~kept.any(1)] = True
    kept = np.pad(kept, ((0, nq * fkb.TILE - Sq), (0, 0)))
    return kept.reshape(nq, fkb.TILE, nk, fkb.TILE).any((1, 3))


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tile_range_covers_the_mask(case):
    """Both kernels' tile bounds against the JAX package's own mask: every
    tile with a kept pair is visited by both, every other one by neither
    (the skip is exact), so the two passes visit the same tiles."""
    Sq, Skv, causal, window, q_offset = TILE_CASES[case]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _kept_tiles(Sq, Skv, causal, window, q_offset)
    nq, nk = want.shape
    by_kv = np.zeros_like(want)
    for j in range(nk):
        lo, hi = fkb.tile_range(j, "q", Sq, Skv, **kw)
        assert 0 <= lo <= hi <= nq
        by_kv[lo:hi, j] = True
    by_q = np.zeros_like(want)
    for i in range(nq):
        lo, hi = fkb.tile_range(i, "kv", Sq, Skv, **kw)
        assert 0 <= lo <= hi <= nk
        by_q[i, lo:hi] = True
    np.testing.assert_array_equal(by_kv, want)
    np.testing.assert_array_equal(by_q, want)


def test_tile_range_at_the_train_shape():
    """qwen2-0.5b's causal 512 x 512: 36 of each head's 64 tile pairs; KV
    tile j visits Q tiles j..7, Q tile i KV tiles 0..i."""
    assert [fkb.tile_range(j, "q", 512, 512) for j in range(8)] == \
        [(j, 8) for j in range(8)]
    assert [fkb.tile_range(i, "kv", 512, 512) for i in range(8)] == \
        [(0, i + 1) for i in range(8)]
    assert sum(hi - lo for lo, hi in (fkb.tile_range(j, "q", 512, 512)
                                      for j in range(8))) == 36
