"""The port's hand-kernel wrappers against the JAX package's Pallas kernels.

On CPU tensors the wrappers run the kernels' plain PyTorch versions; the
Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` runs them.
The same numpy inputs go to both sides.  Tolerances are those of
``tests/test_kernels.py``: matmul f32 atol 1e-4·sqrt(K) / rtol 1e-4, bf16
atol 8e-2·sqrt(K) / rtol 5e-2; flash attention f32 atol 2e-5.  The CUDA
kernels themselves run only on the card (``chip_smoke.py``)."""
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI image has no hypothesis: seeded-sample shim
    from tests._propshim import given, settings, strategies as st

from repro.kernels import flash_attention as jfk  # noqa: E402
from repro.kernels import matmul as jmk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import matmul as mk  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 8e-2, 5e-2)}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.fixture(autouse=True)
def zero_counters():
    mk.matmul_kernel.launches = 0
    fk.flash_attention_kernel.launches = 0
    fk.flash_attention_kernel.launches_by_hd.clear()
    yield
    # CPU tensors never launch a kernel
    assert mk.matmul_kernel.launches == 0
    assert fk.flash_attention_kernel.launches == 0
    assert fk.flash_attention_kernel.launches_by_hd == {}


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cfg", mk.CONFIGS, ids=lambda c: c.name)
def test_matmul_plain_matches_pallas(cfg, dtype):
    jdt, tdt, atol, rtol = DTYPES[dtype]
    jcfg = jmk.MatmulConfig(cfg.bm, cfg.bk, cfg.bn)
    rng = np.random.default_rng(0)
    for M, K, N in [(cfg.bm, cfg.bk, cfg.bn), (2 * cfg.bm, 2 * cfg.bk, cfg.bn)]:
        a = rng.standard_normal((M, K)).astype(np.float32)
        b = rng.standard_normal((K, N)).astype(np.float32)
        aj, bj = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
        pallas = jmk.matmul_kernel(aj, bj, jcfg, interpret=True)
        port = mk.matmul_kernel(_t(a, tdt), _t(b, tdt), cfg)
        assert port.dtype == tdt and port.shape == (M, N)
        for want in (_np(pallas), _np(jref.matmul_ref(aj, bj))):
            np.testing.assert_allclose(port.float().numpy(), want,
                                       atol=atol * np.sqrt(K), rtol=rtol)


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 5), st.integers(1, 5), st.integers(1, 6))
def test_matmul_ops_ragged_shapes(mi, ni, ki):
    """Ragged shapes: the port masks in the kernel, the JAX package pads in
    the wrapper; both equal the JAX package's dense oracle."""
    M, N, K = 37 * mi, 23 * ni, 19 * ki
    rng = np.random.default_rng(mi * 100 + ni * 10 + ki)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    cfg = mk.MatmulConfig(128, 128, 128)
    port = ops.matmul(_t(a), _t(b), cfg).numpy()
    pallas = jops.matmul(jnp.asarray(a), jnp.asarray(b),
                         jmk.MatmulConfig(128, 128, 128), interpret=True)
    np.testing.assert_allclose(port, _np(pallas), atol=1e-3)
    np.testing.assert_allclose(
        port, _np(jref.matmul_ref(jnp.asarray(a), jnp.asarray(b))), atol=1e-3)


@settings(max_examples=8, deadline=None)
@given(st.sampled_from([16, 24, 40, 100]), st.sampled_from([16, 32, 64]))
def test_matmul_property_linearity(m, k):
    """kernel(a, 2b) == 2 kernel(a, b) through the skinny-M config."""
    cfg = mk.MatmulConfig(8, 128, 128)
    rng = np.random.default_rng(m * k)
    a = _t(rng.standard_normal((m, k)))
    b = _t(rng.standard_normal((k, 48)))
    o1 = ops.matmul(a, b, cfg)
    o2 = ops.matmul(a, 2 * b, cfg)
    np.testing.assert_allclose(o2.numpy(), 2 * o1.numpy(), atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_config_feasible_and_deterministic(dtype):
    for (m, n, k) in [(8, 8, 8), (4096, 4096, 4096), (1, 151936, 896),
                      (1000000, 128, 64), (4096, 4864, 896)]:
        c1 = mk.select_config(m, n, k, dtype)
        c2 = mk.select_config(m, n, k, dtype)
        assert c1 == c2 and c1 in mk.CONFIGS
        assert c1.smem_bytes(dtype) <= mk.SMEM_BUDGET


def test_matmul_family_fits_the_card():
    """Every identity fits a block's shared memory in both types, the TPU
    ids that fit are kept, and there is more than one square identity."""
    names = {c.name for c in mk.CONFIGS}
    assert {"mm_128x128x128", "mm_8x128x128"} <= names
    assert sum(c.bm == c.bk == c.bn for c in mk.CONFIGS) >= 2
    for c in mk.CONFIGS:
        for dt in (torch.float32, torch.bfloat16):
            assert c.smem_bytes(dt) <= mk.SMEM_BUDGET


def test_matmul_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.ones(4, 8)
    with pytest.raises(ValueError):
        mk.matmul_kernel(a, torch.ones(9, 4), mk.CONFIGS[0])
    with pytest.raises(TypeError):
        mk.matmul_kernel(a.half(), torch.ones(8, 4).half(), mk.CONFIGS[0])
    with pytest.raises(ValueError):
        mk.matmul_kernel(a, torch.ones(8, 4), mk.MatmulConfig(512, 512, 512))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(BH, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((BH, S, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cfg", fk.CONFIGS, ids=lambda c: c.name)
def test_flash_plain_matches_pallas(cfg, causal):
    q, k, v = _qkv(3, 256, 64)
    jcfg = jfk.FlashConfig(cfg.bq, cfg.bk)
    pallas = jfk.flash_attention_kernel(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jcfg, causal=causal,
                                        interpret=True)
    port = fk.flash_attention_kernel(_t(q), _t(k), _t(v), cfg, causal=causal)
    assert port.shape == (3, 256, 64)
    np.testing.assert_allclose(port.numpy(), _np(pallas), atol=2e-5)


@pytest.mark.parametrize("hd", [32, 64])
def test_flash_plain_window_matches_pallas(hd):
    q, _, _ = _qkv(2, 256, hd, seed=1)
    cfg = fk.FlashConfig(128, 128)
    pallas = jfk.flash_attention_kernel(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
        jfk.FlashConfig(128, 128), causal=True, window=64, interpret=True)
    port = fk.flash_attention_kernel(_t(q), _t(q), _t(q), cfg, causal=True,
                                     window=64)
    np.testing.assert_allclose(port.numpy(), _np(pallas), atol=2e-5)


@pytest.mark.parametrize("window", [None, 64])
def test_flash_plain_hd256_matches_pallas(window):
    """The hd-256 instance's function (fa_64x64, the only config whose
    tiles fit there) against the Pallas kernel in interpret mode, with and
    without the sliding window."""
    q, k, v = _qkv(2, 192, 256, seed=4)
    cfg = fk.FlashConfig(64, 64)
    assert (cfg, 256) in fk.INSTANCES and fk.select_config(192, 192, 256) == cfg
    pallas = jfk.flash_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jfk.FlashConfig(64, 64),
        causal=True, window=window, interpret=True)
    port = fk.flash_attention_kernel(_t(q), _t(k), _t(v), cfg, causal=True,
                                     window=window)
    np.testing.assert_allclose(port.numpy(), _np(pallas), atol=2e-5)
    with pytest.raises(ValueError):        # fa_128x128 has no hd-256 instance
        fk.flash_attention_kernel(_t(q), _t(k), _t(v), fk.FlashConfig(128, 128))


def test_flash_threads_per_instance():
    """2 bq threads a block, but 4 bq for float32 at hd 256 (4 query rows
    a thread instead of 8)."""
    for c, hd in fk.INSTANCES:
        assert c.threads(hd, torch.bfloat16) == 2 * c.bq
        assert c.threads(hd, torch.float32) == (4 if hd == 256 else 2) * c.bq


def test_flash_plain_bf16_matches_pallas():
    """bf16 inputs: both sides compute in f32 and round once to bf16, so
    they differ by at most one bf16 ulp (2^-7 relative)."""
    q, k, v = _qkv(2, 128, 32, seed=2)
    cast = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    pallas = jfk.flash_attention_kernel(cast(q), cast(k), cast(v),
                                        jfk.FlashConfig(64, 64), causal=True,
                                        interpret=True)
    port = fk.flash_attention_kernel(_t(q, torch.bfloat16),
                                     _t(k, torch.bfloat16),
                                     _t(v, torch.bfloat16),
                                     fk.FlashConfig(64, 64), causal=True)
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(), _np(pallas), atol=1e-3,
                               rtol=1e-2)


def test_flash_ops_gqa_matches_jax_wrapper_and_model_path():
    """Port ``ops.flash_attention`` (KV head h // G read in place) == the
    JAX wrapper (KV heads repeated) == the JAX model's jnp flash path."""
    B, S, Hkv, G, hd = 1, 256, 2, 2, 32
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, Hkv * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    port = ops.flash_attention(_t(q), _t(k), _t(v), fk.FlashConfig(128, 128),
                               causal=True).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    wrapper = jops.flash_attention(jq, jk, jv, jfk.FlashConfig(128, 128),
                                   causal=True, interpret=True)
    model = jA.flash_attention(jq, jk, jv,
                               spec=jA.AttnSpec(causal=True, kv_block=128))
    np.testing.assert_allclose(port, _np(wrapper), atol=3e-5)
    np.testing.assert_allclose(port, _np(model), atol=3e-5)


@pytest.mark.parametrize("Sq,Skv,window", [(200, 200, None), (100, 300, None),
                                           (77, 77, 16), (1, 130, None)])
def test_flash_plain_ragged_matches_oracle(Sq, Skv, window):
    """Lengths that are no multiple of the tile, and Sq < Skv (the causal
    mask aligned bottom-right), against the dense oracle."""
    rng = np.random.default_rng(Sq + Skv)
    B, H, Hkv, hd = 2, 4, 2, 16
    q = _t(rng.standard_normal((B, Sq, H, hd)))
    k = _t(rng.standard_normal((B, Skv, Hkv, hd)))
    v = _t(rng.standard_normal((B, Skv, Hkv, hd)))
    port = ops.flash_attention(q, k, v, causal=True, window=window)
    rep = lambda x: x.repeat_interleave(H // Hkv, dim=2)
    want = ref.attention_ref(q, rep(k), rep(v), causal=True, window=window)
    np.testing.assert_allclose(port.numpy(), want.numpy(), atol=2e-5)
    jwant = jref.attention_ref(jnp.asarray(q.numpy()),
                               jnp.asarray(rep(k).numpy()),
                               jnp.asarray(rep(v).numpy()), causal=True,
                               window=window)
    np.testing.assert_allclose(port.numpy(), _np(jwant), atol=2e-5)


def test_flash_select_config_feasible_and_deterministic():
    for (sq, skv, hd) in [(512, 512, 64), (128, 128, 128), (200, 200, 32),
                          (64, 64, 16), (4096, 4096, 64), (1, 77, 64)]:
        c = fk.select_config(sq, skv, hd)
        assert c == fk.select_config(sq, skv, hd) and c in fk.CONFIGS
        assert c.smem_bytes(hd) <= fk.SMEM_BUDGET
    assert fk.select_config(512, 512, 64) == fk.FlashConfig(128, 128)
    assert {c.name for c in fk.CONFIGS} >= {"fa_128x128", "fa_64x64"}


def test_build_returns_the_kept_compiler_output_when_cached(tmp_path,
                                                           monkeypatch):
    """A second build in the same checkout compiles nothing and still
    returns each source's ptxas report, kept beside its library."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: pytest.fail("compiled"))
    for name in build.SOURCES:
        build.library_path(name).write_bytes(b"")
        build.log_path(name).write_text(f"ptxas info : Used 40 registers "
                                         f"({name})")
    logs = build.build_all()
    assert sorted(logs) == sorted(build.SOURCES)
    for name, log in logs.items():
        assert "Used 40 registers" in log and name in log


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.ones(1, 64, 3, 64)
    kv = torch.ones(1, 64, 2, 64)
    with pytest.raises(ValueError):        # 3 query heads over 2 KV heads
        fk.flash_attention_kernel(q, kv, kv, fk.CONFIGS[0])
    with pytest.raises(ValueError):        # head dim not instantiated
        fk.flash_attention_kernel(torch.ones(1, 64, 2, 48),
                                  torch.ones(1, 64, 2, 48),
                                  torch.ones(1, 64, 2, 48), fk.CONFIGS[0])
    with pytest.raises(ValueError):
        fk.flash_attention_kernel(kv, kv, kv, fk.FlashConfig(512, 512))


# ---------------------------------------------------------------------------
# instances, load paths and shared memory of the CUDA sources
# ---------------------------------------------------------------------------

def _instances(source, macro):
    """The argument tuples of every ``macro(...)`` line in csrc/<source>.cu."""
    text = (build.CSRC / f"{source}.cu").read_text()
    return [tuple(int(x) for x in m.split(","))
            for m in re.findall(rf"^\s*{macro}\(([\d,\s]+)\)\s*$", text, re.M)]


@pytest.mark.parametrize("dtype", ["F32", "BF16"])
def test_cuda_instances_equal_configs_times_head_dims(dtype):
    """Every (config, hd) the wrappers accept is instantiated once per type,
    and nothing else is."""
    mm = _instances("matmul", f"PM2LAT_MM_{dtype}")
    assert sorted(t[:3] for t in mm) == sorted(
        (c.bm, c.bk, c.bn) for c in mk.CONFIGS)
    fa = _instances("flash_attention", f"PM2LAT_FA_{dtype}")
    assert sorted(fa) == sorted((c.bq, c.bk, hd) for c, hd in fk.INSTANCES)
    # every config up to hd 128; at hd 256 the one whose tiles fit
    assert [(c.name, hd) for c, hd in fk.INSTANCES if hd == 256] == [
        ("fa_64x64", 256)]
    assert len(fk.INSTANCES) == len(fk.CONFIGS) * (len(fk.HEAD_DIMS) - 1) + 1
    # the shared-memory getters answer for the same instances
    assert sorted(t[:3] for t in _instances("matmul", "PM2LAT_MM_SMEM")) == \
        sorted(t[:3] for t in mm)
    assert sorted(_instances("flash_attention", "PM2LAT_FA_SMEM")) == sorted(fa)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_instance_fits_the_shared_memory_budget(dtype):
    for c in mk.CONFIGS:
        assert 0 < c.smem_bytes(dtype) <= mk.SMEM_BUDGET
    for c, hd in fk.INSTANCES:
        assert 0 < c.smem_bytes(hd, dtype) <= fk.SMEM_BUDGET


def test_bf16_matmul_ring_is_at_least_double_buffered():
    for c in mk.CONFIGS:
        assert 2 <= c.stages <= 4
        assert c.stages * c._stage_bytes() <= mk.RING_BYTES


def _offset(shape, dtype, by=1):
    n = int(np.prod(shape))
    return torch.zeros(n + by, dtype=dtype)[by:].view(*shape)


@pytest.mark.parametrize("case,want", [
    ("aligned", "tma"), ("odd_k", "sync"), ("odd_n", "sync"),
    ("ragged_aligned", "tma"), ("offset_a", "sync"), ("offset_b", "sync"),
    ("slice_a", "sync"), ("transposed_a", "tma"), ("transposed_b", "tma"),
    ("float32", "ffma")])
def test_matmul_load_path(case, want):
    """TMA exactly when both operands' base addresses and row strides are
    multiples of 16 bytes, as the kernel takes them: an operand whose last
    dim is strided is copied first, and the copy is aligned."""
    bf = torch.bfloat16
    M, K, N = 256, 384, 256
    shapes = {"odd_k": (M, 385, N), "odd_n": (M, K, 257),
              "ragged_aligned": (293, 408, 296)}
    M, K, N = shapes.get(case, (M, K, N))
    dt = torch.float32 if case == "float32" else bf
    a, b = torch.zeros(M, K, dtype=dt), torch.zeros(K, N, dtype=dt)
    if case == "offset_a":
        a = _offset((M, K), bf)
    if case == "offset_b":
        b = _offset((K, N), bf)
    if case == "slice_a":
        a = torch.zeros(M, K + 1, dtype=bf)[:, 1:]
    if case == "transposed_a":
        a = torch.zeros(K, M, dtype=bf).t()
    if case == "transposed_b":
        b = torch.zeros(N + 1, K, dtype=bf)[1:].t()
    assert mk.load_path(a, b) == want


@pytest.mark.parametrize("case,want", [
    ("aligned", "tma"), ("odd_skv", "tma"), ("gqa_fused_slices", "tma"),
    ("offset_q", "sync"), ("offset_v", "sync"), ("odd_row_stride", "sync"),
    ("three_d", "tma"), ("strided_head_dim", "tma"), ("float32", "ffma")])
def test_flash_load_path(case, want):
    """TMA exactly when every base address and batch/sequence/head stride is
    a multiple of 16 bytes, as the kernel takes the tensors (one whose head
    dim is strided is copied first); a ragged length does not matter."""
    bf = torch.bfloat16
    B, S, Skv, H, Hkv, hd = 2, 128, 128, 4, 2, 32
    if case == "odd_skv":
        Skv = 77
    dt = torch.float32 if case == "float32" else bf
    q = torch.zeros(B, S, H, hd, dtype=dt)
    k = torch.zeros(B, Skv, Hkv, hd, dtype=dt)
    v = torch.zeros(B, Skv, Hkv, hd, dtype=dt)
    if case == "gqa_fused_slices":
        q, k, v = torch.zeros(B, S, H + 2 * Hkv, hd, dtype=bf).split(
            [H, Hkv, Hkv], dim=2)
    if case == "offset_q":
        q = _offset((B, S, H, hd), bf)
    if case == "offset_v":
        v = _offset((B, Skv, Hkv, hd), bf, by=3)
    if case == "odd_row_stride":
        k = torch.zeros(B, Skv, Hkv * hd + 1, dtype=bf)[..., :Hkv * hd] \
            .unflatten(2, (Hkv, hd))
    if case == "three_d":
        q, k, v = (torch.zeros(B * H, S, hd, dtype=bf)[:, :, None]
                   for _ in range(3))
    if case == "strided_head_dim":     # 2 bytes off, head-dim stride 3
        q = torch.zeros(B, S, H, hd, 3, dtype=bf)[..., 1]
    assert fk.load_path(q, k, v) == want


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Editing csrc/hopper.cuh rebuilds every library that includes it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in build.SOURCES}
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text() + "\n")
    assert all(build.library_path(n) != before[n] for n in build.SOURCES)


# ---------------------------------------------------------------------------
# the float32 (register-tiled FFMA) instances: layout, occupancy, picks
# ---------------------------------------------------------------------------

# Dynamic shared memory of each float32 instance, from the layouts stated in
# csrc/: matmul, a double buffer of A [bm, sk] + B [sk, bn] in f32, sk =
# min(bk, 64), each A row padded by 4 floats; flash, Q [bq, hd] +
# K [bk, hd + 4] + V [bk, hd] + P^T [bk, bq + 4] in f32, P^T over K where
# the four pass 227 KB (fa_128x128 at hd 128).
F32_MM_SMEM = {"mm_128x128x128": 4 * 2 * (128 * 68 + 64 * 128),
               "mm_128x32x128": 4 * 2 * (128 * 36 + 32 * 128),
               "mm_64x64x64": 4 * 2 * (64 * 68 + 64 * 64),
               "mm_8x128x128": 4 * 2 * (8 * 68 + 64 * 128)}
F32_FA_SMEM = {("fa_64x64", 16): 4 * (64 * 16 + 64 * 20 + 64 * 16 + 64 * 68),
               ("fa_64x64", 32): 4 * (64 * 32 + 64 * 36 + 64 * 32 + 64 * 68),
               ("fa_64x64", 64): 4 * (64 * 64 + 64 * 68 + 64 * 64 + 64 * 68),
               ("fa_64x64", 128): 4 * (64 * 128 + 64 * 132 + 64 * 128
                                       + 64 * 68),
               ("fa_64x64", 256): 4 * (64 * 256 + 64 * 260 + 64 * 256
                                       + 64 * 68),
               ("fa_128x128", 16): 4 * (128 * 16 + 128 * 20 + 128 * 16
                                        + 128 * 132),
               ("fa_128x128", 32): 4 * (128 * 32 + 128 * 36 + 128 * 32
                                        + 128 * 132),
               ("fa_128x128", 64): 4 * (128 * 64 + 128 * 68 + 128 * 64
                                        + 128 * 132),
               ("fa_128x128", 128): 4 * (128 * 128 + 128 * 132 + 128 * 128)}


@pytest.mark.parametrize("cfg", mk.CONFIGS, ids=lambda c: c.name)
def test_float32_matmul_smem_is_the_ring_layout(cfg):
    got = cfg.smem_bytes(torch.float32)
    assert got == F32_MM_SMEM[cfg.name] <= mk.SMEM_BUDGET
    # two slots of min(bk, 64) K columns, each A row padded by 4 floats:
    # two whole stages for bk <= 64, one stage in two halves for bk = 128
    sk = cfg.ffma_slot
    assert sk == min(cfg.bk, 64) and 2 * sk in (cfg.bk, 2 * cfg.bk)
    assert got - 4 * 2 * 4 * cfg.bm == 4 * 2 * sk * (cfg.bm + cfg.bn)


@pytest.mark.parametrize("cfg,hd", list(fk.INSTANCES),
                         ids=lambda x: getattr(x, "name", str(x)))
def test_float32_flash_smem_is_the_tile_layout(cfg, hd):
    assert cfg.smem_bytes(hd, torch.float32) == F32_FA_SMEM[(cfg.name, hd)] \
        <= fk.SMEM_BUDGET


@pytest.mark.parametrize("cfg,hd", [(c, hd) for c in fk.CONFIGS
                                    for hd in fk.HEAD_DIMS if hd <= 64],
                         ids=lambda x: getattr(x, "name", str(x)))
def test_float32_flash_holds_eight_warps_an_sm(cfg, hd):
    """At the most registers a thread may have (255), every float32 flash
    instance at hd <= 64 keeps 8 warps or more resident on an SM."""
    threads = cfg.threads(hd, torch.float32)
    blocks = build.blocks_per_sm(threads, 255,
                                 cfg.smem_bytes(hd, torch.float32))
    assert blocks * threads // 32 >= 8


@pytest.mark.parametrize("threads,regs,smem,want", [
    (256, 255, 0, 1),          # registers: 8 warps of 8192
    (256, 128, 0, 2),          # 4 warps a sub-partition
    (256, 64, 0, 4),
    (128, 200, 0, 2),          # 6400 a warp: 2 warps a sub-partition
    (128, 64, 67584, 3),       # shared memory: 3 x (67584 + 1024)
    (256, 100, 131072, 1),
    (32, 16, 0, 32),           # the block limit
    (1024, 32, 0, 2),          # the warp limit
    (1024, 128, 0, 0),         # 128 KB of registers: does not fit
])
def test_blocks_per_sm_follows_the_occupancy_rule(threads, regs, smem, want):
    assert build.blocks_per_sm(threads, regs, smem) == want


def test_float32_instances_match_the_python_description():
    """csrc/matmul.cu instantiates each float32 identity with the micro-tile
    ``ffma_tile`` names, and both sources' occupancy getters answer for
    exactly the float32 instances."""
    mm = _instances("matmul", "PM2LAT_MM_F32")
    assert {t[:3]: t[3:] for t in mm} == {
        (c.bm, c.bk, c.bn): c.ffma_tile for c in mk.CONFIGS}
    assert sorted(_instances("matmul", "PM2LAT_MM_OCC")) == sorted(mm)
    assert sorted(_instances("matmul", "PM2LAT_MM_SMEM")) == sorted(mm)
    assert sorted(_instances("flash_attention", "PM2LAT_FA_OCC")) == sorted(
        _instances("flash_attention", "PM2LAT_FA_F32"))
    for c in mk.CONFIGS:
        tm, tn = c.ffma_tile
        assert tn % 4 == 0 and c.ffma_threads == (c.bm // tm) * (c.bn // tn)
        assert c.ffma_threads % 32 == 0


# select_config's float32 picks, as the kernels before the register-tiled
# redesign gave them: the redesign changes no pick.
F32_MM_PICKS = {
    (1, 64, 32): "mm_8x128x128", (1, 4224, 1408): "mm_8x128x128",
    (8, 640, 32): "mm_8x128x128", (8, 4224, 1408): "mm_8x128x128",
    (100, 64, 32): "mm_128x32x128", (100, 64, 1408): "mm_64x64x64",
    (100, 640, 1408): "mm_8x128x128", (100, 4224, 32): "mm_128x32x128",
    (768, 64, 1408): "mm_64x64x64", (768, 640, 32): "mm_128x32x128",
    (768, 640, 1408): "mm_128x128x128", (768, 4224, 1408): "mm_128x128x128",
    (2048, 64, 1408): "mm_64x64x64", (2048, 640, 32): "mm_128x32x128",
    (2048, 4224, 1408): "mm_128x128x128", (2048, 4224, 4096): "mm_128x128x128",
}


@pytest.mark.parametrize("shape,want", sorted(F32_MM_PICKS.items()))
def test_float32_matmul_picks_are_pinned(shape, want):
    assert mk.select_config(*shape, torch.float32).name == want


@pytest.mark.parametrize("s,hd,want", [
    (512, 64, "fa_128x128"), (512, 128, "fa_128x128"), (128, 16, "fa_128x128"),
    (4096, 32, "fa_128x128"), (200, 64, "fa_64x64"), (64, 128, "fa_64x64")])
def test_float32_flash_picks_are_pinned(s, hd, want):
    assert fk.select_config(s, s, hd, torch.float32).name == want


@pytest.mark.parametrize("case,want", [
    ("aligned", "ffma"), ("odd_k", "ffma_scalar"), ("odd_n", "ffma_scalar"),
    ("offset_a", "ffma"), ("slice_b", "ffma")])
def test_float32_matmul_operands_are_dense_and_aligned(case, want):
    """The float32 kernel takes dense operands at 16-byte aligned addresses
    (others are copied) and copies 16 bytes at a time where K and N are
    multiples of 4."""
    M, K, N = 64, 96, 80
    K, N = {"odd_k": (97, N), "odd_n": (K, 81)}.get(case, (K, N))
    a, b = torch.zeros(M, K), torch.zeros(K, N)
    if case == "offset_a":
        a = _offset((M, K), torch.float32)
    if case == "slice_b":
        b = torch.zeros(K, N + 1)[:, 1:]
    a2, b2, path = mk._operands(a, b)
    assert path == want and mk.load_path(a, b) == want
    for t in (a2, b2):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0


def test_float32_flash_operands_are_dense_and_aligned():
    q = _offset((1, 64, 2, 32), torch.float32)
    kv = torch.zeros(1, 64, 4, 32)[:, :, 1:3]
    out = fk._operands(q, kv, kv)
    assert out[3] == "ffma"
    for t in out[:3]:
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
