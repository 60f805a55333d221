"""The port's int8 gradient codec (``distributed/compression.py``) against
the JAX package's, on the CPU.

- ``quantize`` / ``dequantize`` without noise: bit-equal to the reference's
  on the same numpy inputs;
- the round trip within one quantization bin, stochastic rounding unbiased
  (2e-3) and error feedback below 2 % over 10 steps: the reference's own
  limits (``tests/test_compression.py``); the port's noise comes from a
  ``torch.Generator``, so its draws differ from ``jax.random``'s;
- ``compressed_psum`` over 4 gloo processes: bit-equal to the reference's
  psum over 4 fake devices (``shard_map``) on the same rows.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI image has no hypothesis: seeded-sample shim
    from tests._propshim import given, settings, strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as jcomp  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402
from tests import _torch_dist as td  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 2000), st.floats(0.01, 1e4))
def test_quantize_roundtrip_error_bound(n, scale):
    """Property: per-element error <= chunk_max / 127 / 2 (one bin)."""
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.standard_normal(n) * scale, dtype=torch.float32)
    q, s, n_ = comp.quantize(x)
    y = comp.dequantize(q, s, n_, x.shape)
    err = (y - x).abs().numpy()
    pad = (-n) % comp.CHUNK
    chunks = np.pad(x.numpy(), (0, pad)).reshape(-1, comp.CHUNK)
    bound = np.abs(chunks).max(1, keepdims=True) / 127.0 * 0.5001 + 1e-12
    bound = np.repeat(bound, comp.CHUNK, axis=1).reshape(-1)[:n]
    assert (err <= bound + 1e-7).all()


@pytest.mark.parametrize("n,scale", [(1, 1.0), (255, 3.0), (256, 1e-3),
                                     (1000, 1e4), (2000, 0.5), (4096, 7.0)])
def test_codec_bit_equal_to_reference(n, scale):
    x = (np.random.default_rng(n).standard_normal(n) * scale).astype(
        np.float32)
    q, s, n_ = comp.quantize(torch.from_numpy(x))
    jq, js, jn = jcomp.quantize(jnp.asarray(x))
    assert n_ == jn
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        comp.dequantize(q, s, n_, (n,)).numpy(),
        np.asarray(jcomp.dequantize(jq, js, jn, (n,))))


def test_stochastic_rounding_unbiased():
    x = torch.full((4096,), 0.3)
    outs = []
    for i in range(16):
        q, s, n = comp.quantize(x, generator=torch.Generator().manual_seed(i))
        outs.append(float(comp.dequantize(q, s, n, x.shape).mean()))
    assert abs(np.mean(outs) - 0.3) < 2e-3


def test_error_feedback_reduces_accumulated_bias():
    """Over 10 steps of one gradient, error feedback keeps the accumulated
    compressed sum within 2 % of the true sum."""
    g = torch.tensor(np.random.default_rng(0).standard_normal(1000) * 1e-3,
                     dtype=torch.float32)
    transform, init_buffer = comp.make_grad_transform({"w": g})
    buf = init_buffer()
    acc = torch.zeros_like(g)
    for _ in range(10):
        out, buf = transform({"w": g}, buf)
        acc += out["w"]
    true = 10 * g
    assert float(torch.linalg.norm(acc - true) / torch.linalg.norm(true)) \
        < 0.02


def test_grad_hook_carries_the_buffer_through_the_train_step():
    """``grad_hook`` in ``build_train_step(grad_transform=)``: the step's
    gradients reach AdamW through the codec, and the hook's second call
    adds the first call's residual back."""
    from repro_torch.configs import registry as cr
    from repro_torch.models import registry as mr
    import dataclasses
    cfg = dataclasses.replace(cr.reduced("qwen2-0.5b", n_layers=1),
                              compute_dtype="float32")
    model = mr.build(cfg, device="cpu", seed=0)
    params = tstep.trainable_params(model)
    seen = []
    transform, init_buffer = comp.make_grad_transform(params)

    def spy(grads, buf):
        out, new = transform(grads, buf)
        seen.append((grads, buf, out, new))
        return out, new

    step = tstep.build_train_step(model, topt.AdamWConfig(lr=1e-3),
                                  grad_transform=comp.grad_hook(spy,
                                                                init_buffer))
    rng = np.random.default_rng(0)
    state = topt.init_opt_state(params)
    for _ in range(2):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
        params, state, m = step(params, state, {"tokens": toks[:, :-1],
                                                "labels": toks[:, 1:]})
        assert torch.isfinite(m["loss"])
    (g0, b0, o0, n0), (g1, b1, o1, n1) = seen
    assert all(torch.equal(b0[k], torch.zeros_like(b0[k])) for k in b0)
    assert all(b1[k] is n0[k] for k in n0)
    for k in g0:
        torch.testing.assert_close(n0[k], g0[k].float() - o0[k], rtol=0,
                                   atol=0)


_REFERENCE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.distributed import compression as comp
rows = np.asarray(json.loads(sys.argv[1]), np.float32)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("dp",))
f = shard_map(lambda s: comp.compressed_psum(s[0], "dp"), mesh=mesh,
              in_specs=P("dp"), out_specs=P())
print(json.dumps(np.asarray(f(jnp.asarray(rows))).tolist()))
"""


def test_compressed_psum_on_4_processes_bit_equal_to_reference(tmp_path):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((4, 1000)).astype(np.float32)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                          json.dumps(rows.tolist())], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.asarray(json.loads(out.stdout.strip().splitlines()[-1]),
                      np.float32)
    res = td.spawn(4, "psum", tmp_path, rows=rows.tolist())
    for r in res:
        np.testing.assert_array_equal(np.asarray(r["sum"], np.float32), want)
    true = rows.sum(0)
    rel = np.abs(want - true) / (np.abs(true) + 1e-3)
    assert float(rel.mean()) < 0.05   # the reference's bound on such rows
