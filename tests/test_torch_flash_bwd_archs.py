"""The flash backward's plain version, the autograd Function and the
kernels' tile bounds at the geometries the dense archs train at, against
the JAX package, by ``tests/test_torch_flash_bwd.py``'s checks and
tolerances (the files split so that each runs alone in under a minute):
gemma-7b's hd 256 over more than one KV head (GQA 1, causal, no window),
starcoder2-15b's GQA group of 12, and llama-3.2-vision-11b's non-causal
cross attention at GQA 4 over keys that leave one in the last KV block,
at small sizes; the tile bounds also at the cross attention's train
shape, 512 queries over 1,601 keys (25 tiles of 64 and one of one key).
"""
import pytest

pytest.importorskip("jax")

from tests import test_torch_flash_bwd as base  # noqa: E402

# (B, Sq, Skv, H, Hkv, hd, causal, window), as ``base.CASES``
CASES = {
    "hd256_mha": (1, 40, 40, 2, 2, 256, True, None),
    "gqa12": (1, 40, 40, 12, 1, 128, True, None),
    "cross_one_key": (2, 24, 2 * base.KV_BLOCK + 1, 8, 2, 128, False, None),
}
# (Sq, Skv, causal, window, q_offset), as ``base.TILE_CASES``
TILE_CASES = {
    **{name: (c[1], c[2], c[6], c[7], c[2] - c[1]) for name, c in CASES.items()},
    "cross_train": (512, 1601, False, None, 1089),
}


@pytest.fixture(autouse=True)
def these_cases(monkeypatch):
    monkeypatch.setattr(base, "CASES", CASES)
    monkeypatch.setattr(base, "TILE_CASES", TILE_CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_jax_vjp(case):
    base.test_bwd_plain_matches_jax_vjp(case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_matches_jax_vjp(case):
    base.test_autograd_matches_jax_vjp(case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_autograd_matches_jax_vjp(case):
    base.test_bf16_autograd_matches_jax_vjp(case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_matches_fwd_scan(case):
    base.test_lse_matches_fwd_scan(case)


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tile_range_covers_the_mask(case):
    base.test_tile_range_covers_the_mask(case)
