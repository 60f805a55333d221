"""The port's op-graph enumeration against the JAX package's, field by field,
for all ten registry architectures at full width and the paper miniatures.

MemoryOp features differ by design: the port counts the aten ops an eager
torch snippet launches (``core/cost.py``, operands + outputs of each op),
the JAX package reads XLA's ``cost_analysis()`` of the fused snippet.  The
test holds the port's features positive; run this file as a script to
print the port/XLA feature ratios for qwen2-0.5b:

    PYTHONPATH=src python tests/test_torch_opgraph.py
"""
import dataclasses
import math

import pytest

pytest.importorskip("jax")

from repro.configs import registry as jcr  # noqa: E402
from repro.core import opgraph as jog  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import cost  # noqa: E402
from repro_torch.core import opgraph as tog  # noqa: E402

NAMES = list(jcr.ARCH_NAMES) + list(jcr.PAPER_MODELS)
SHAPES = [(1, 128), (2, 512), (8, 4096)]


def _fields(op):
    d = dataclasses.asdict(op)
    if isinstance(d.get("shape"), list):
        d["shape"] = tuple(d["shape"])
    return type(op).__name__, d


def test_configs_are_a_verbatim_copy():
    assert tcr.ARCH_NAMES == jcr.ARCH_NAMES
    assert sorted(tcr.PAPER_MODELS) == sorted(jcr.PAPER_MODELS)
    for name in NAMES:
        assert (dataclasses.asdict(tcr.get_any(name))
                == dataclasses.asdict(jcr.get_any(name)))
    for name in jcr.ARCH_NAMES:
        assert (dataclasses.asdict(tcr.reduced(name))
                == dataclasses.asdict(jcr.reduced(name)))
        assert (dataclasses.asdict(tcr.reduced(name, n_layers=3))
                == dataclasses.asdict(jcr.reduced(name, n_layers=3)))
        assert tcr.get(name).param_count() == jcr.get(name).param_count()


@pytest.mark.parametrize("name", NAMES)
def test_enumerate_ops_equal_field_by_field(name):
    jcfg, tcfg = jcr.get_any(name), tcr.get_any(name)
    for batch, seq in SHAPES:
        for dtype in (None, "bfloat16"):
            jops = jog.enumerate_ops(jcfg, batch, seq, dtype=dtype)
            tops = tog.enumerate_ops(tcfg, batch, seq, dtype=dtype)
            assert len(tops) == len(jops)
            for t, j in zip(tops, jops):
                assert _fields(t) == _fields(j), (name, batch, seq)
                assert t.flops == j.flops if hasattr(j, "flops") else True
            jg = jog.enumerate_graph(jcfg, batch, seq, dtype=dtype)
            tg = tog.enumerate_graph(tcfg, batch, seq, dtype=dtype)
            assert [(n.stream, n.deps) for n in tg.nodes] == \
                [(n.stream, n.deps) for n in jg.nodes]
            assert tg.phase == jg.phase


@pytest.mark.parametrize("name", NAMES)
def test_memory_op_features_positive(name):
    cfg = tcr.get_any(name)
    for op in tog.enumerate_ops(cfg, 2, 256):
        if op.kind != "memory":
            continue
        f = op.features()
        assert f["bytes"] > 0 and math.isfinite(f["bytes"]), (op, f)
        assert f["flops"] >= 0 and f["transcendentals"] >= 0, (op, f)


def test_cost_counter_conventions():
    """Matrix products 2·b·M·N·K flops; transcendental ops one per element;
    bytes operands + outputs; views count nothing."""
    import torch
    f = cost.cost_of(lambda a, b: a @ b, ((4, 8, 16), torch.float32),
                     ((16, 32), torch.float32))
    assert f["flops"] == 2.0 * 4 * 8 * 32 * 16
    assert f["bytes"] == 4.0 * (4 * 8 * 16 + 16 * 32 + 4 * 8 * 32)
    f = cost.cost_of(torch.exp, ((10, 10), torch.bfloat16))
    assert f == {"bytes": 400.0, "flops": 100.0, "transcendentals": 100.0}
    f = cost.cost_of(lambda x: x.transpose(0, 1).reshape(-1),
                     ((10, 10), torch.float32))
    assert f["flops"] == 0.0
    f = cost.cost_of(lambda x: x + x, ((3, 5), torch.float32))
    assert f == {"bytes": 180.0, "flops": 15.0, "transcendentals": 0.0}


@pytest.mark.parametrize("snippet", sorted(jog.SNIPPETS))
def test_snippets_compute_what_the_jax_snippets_compute(snippet):
    """The torch snippets are the JAX ones, op for op, on the same input."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    assert sorted(tog.SNIPPETS) == sorted(jog.SNIPPETS)
    shape = (20, 16) if snippet == "embed_gather" else (2, 8, 16)
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jog.SNIPPETS[snippet](jnp.asarray(x)))
    got = tog.SNIPPETS[snippet](torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def feature_ratios(name="qwen2-0.5b", batch=8, seq=512, dtype="bfloat16"):
    """Per memory op: (port features, XLA features, bytes ratio)."""
    rows = []
    seen = set()
    jcfg, tcfg = jcr.get_any(name), tcr.get_any(name)
    for t, j in zip(tog.enumerate_ops(tcfg, batch, seq, dtype=dtype),
                    jog.enumerate_ops(jcfg, batch, seq, dtype=dtype)):
        if t.kind != "memory" or (t.snippet, t.shape) in seen:
            continue
        seen.add((t.snippet, t.shape))
        tf, jf = t.features(), j.features()
        rows.append((t.name, t.snippet, t.shape, tf, jf,
                     tf["bytes"] / jf["bytes"] if jf["bytes"] else float("nan")))
    return rows


if __name__ == "__main__":
    print("op | snippet | shape | port bytes | XLA bytes | bytes ratio | "
          "port flops | XLA flops")
    for name, snip, shape, tf, jf, ratio in feature_ratios():
        print(f"{name} | {snip} | {shape} | {tf['bytes']:.4g} | "
              f"{jf['bytes']:.4g} | {ratio:.3f} | {tf['flops']:.4g} | "
              f"{jf['flops']:.4g}")
