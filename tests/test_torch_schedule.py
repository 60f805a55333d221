"""The port's parallel op enumeration (``core/opgraph.py``) and list-schedule
core (``core/schedule.py``, first half) against the JAX package's.

Everything here is numpy on both sides, so every comparison is ``==``
(no tolerance):

* the parallel enumerations (prefill and decode, tp/sp/dp/pp) op for op,
  on a dense, an MoE, a recurrent and an encoder-decoder config;
* ``ParallelismSpec.tag``, ``activation_bytes``, ``layer_segments`` and
  ``total_flops``;
* ``simulate``/``simulate_batch``/``_interval_union`` on seeded graphs;
* the pipeline graphs (ops, streams, deps) for GPipe, 1F1B and interleaved,
  forward and training, and ``peak_memory_bytes``;
* the ``Schedule`` splits (busy, exposed comm, bubble share) under
  ``FieldPriced``, a predictor that prices an op from its fields alone and
  so needs no table store and no memory-op features.

No assertion compares a makespan with ``sum(...)``: Python 3.12's ``sum()``
is compensated while ``simulate`` adds left to right."""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import registry as jcr  # noqa: E402
from repro.core import opgraph as jog  # noqa: E402
from repro.core import schedule as JS  # noqa: E402
from repro.core.predictor import PredictionRow as JRow  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import opgraph as og  # noqa: E402
from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core.predictor import PredictionRow as TRow  # noqa: E402

# one config per branch of the enumeration that sharding touches
ARCHS = ("qwen2-0.5b",            # dense attention
         "moonshot-v1-16b-a3b",   # MoE: expert sharding, all-to-alls
         "recurrentgemma-2b",     # RG-LRU + local attention
         "whisper-small")         # encoder + cross-attention
SPECS = [dict(tp=2), dict(tp=4, act_mode="sp"), dict(dp=2, tp=2),
         dict(dp=3), dict(pp=2), dict(dp=2, tp=2, pp=2, act_mode="sp")]
PIPE_SPECS = [dict(pp=2, microbatches=4),
              dict(pp=2, microbatches=4, schedule="1f1b"),
              dict(pp=2, microbatches=4, schedule="interleaved"),
              dict(pp=3, microbatches=2, tp=2, act_mode="sp",
                   schedule="1f1b"),
              dict(dp=2, tp=2, pp=2, microbatches=4,
                   schedule="interleaved"),
              dict(dp=2, microbatches=3),
              dict(tp=2)]


def specs(kw):
    return og.ParallelismSpec(**kw), jog.ParallelismSpec(**kw)


def tup(ops):
    return [(type(o).__name__, dataclasses.astuple(o)) for o in ops]


def graph_tuple(g):
    return ([(type(n.op).__name__, dataclasses.astuple(n.op), n.stream,
              tuple(n.deps)) for n in g.nodes], g.phase)


class FieldPriced:
    """A predictor that prices an op from its fields alone, the same on
    both packages: ``row`` is the package's ``PredictionRow``.  With
    ``vectorized`` it also offers ``predict_ops_seconds``, the engine's
    entry point that ``sweep_strategies`` prefers."""

    def __init__(self, row, vectorized=False):
        self.row = row
        if vectorized:
            self.predict_ops_seconds = lambda ops: np.array(
                [self.seconds(o) for o in ops])

    @staticmethod
    def seconds(op):
        kind = op.kind
        if kind in ("matmul", "bmm"):
            return (2.0 * op.batch * op.m * op.n * op.k / 3e13 + 2e-6) \
                * op.count
        if kind == "attention":
            return op.flops / 2e13 + 5e-6 * op.count
        if kind == "collective":
            return (op.nbytes / 1e11 * (op.world - 1) / op.world
                    + 8e-6) * op.count
        n = 1.0
        for d in op.shape:
            n *= d
        return (n * 4 / 2e12 + 3e-6) * op.count

    def predict_ops(self, ops):
        rows = [self.row(op.name, op.kind, self.seconds(op), "field")
                for op in ops]
        return sum(r.seconds for r in rows), rows


# ---------------------------------------------------------------------------
# parallel enumeration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: og.ParallelismSpec(
    **kw).tag())
def test_parallel_enumeration_equals_jax(name, kw):
    ts, js = specs(kw)
    for dt in (None, "bfloat16"):
        assert tup(og.enumerate_parallel_ops(tcr.reduced(name), 5, 48, ts,
                                             dtype=dt)) == \
            tup(jog.enumerate_parallel_ops(jcr.reduced(name), 5, 48, js,
                                           dtype=dt))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: og.ParallelismSpec(
    **kw).tag())
def test_decode_parallel_enumeration_equals_jax(name, kw):
    ts, js = specs(kw)
    assert tup(og.enumerate_decode_parallel_ops(tcr.reduced(name), 6, 300,
                                                ts)) == \
        tup(jog.enumerate_decode_parallel_ops(jcr.reduced(name), 6, 300, js))
    ctx = np.array([1, 64, 700])
    t = og.enumerate_decode_parallel_ops(tcr.reduced(name), 6, ctx, ts)
    j = jog.enumerate_decode_parallel_ops(jcr.reduced(name), 6, ctx, js)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name))


@pytest.mark.parametrize("name", ("qwen2-0.5b", "xlstm-1.3b"))
def test_trivial_spec_is_the_plain_enumeration(name):
    cfg = tcr.reduced(name)
    assert tup(og.enumerate_parallel_ops(cfg, 2, 32, og.ParallelismSpec())) \
        == tup(og.enumerate_ops(cfg, 2, 32))
    assert tup(og.enumerate_decode_parallel_ops(
        cfg, 2, 40, og.ParallelismSpec())) == \
        tup(og.enumerate_decode_ops(cfg, 2, 40))


@pytest.mark.parametrize("kw", SPECS + PIPE_SPECS + [{}],
                         ids=lambda kw: og.ParallelismSpec(**kw).tag())
def test_spec_tag_world_trivial_equal_jax(kw):
    ts, js = specs(kw)
    assert (ts.tag(), ts.world, ts.trivial) == (js.tag(), js.world,
                                                js.trivial)


@pytest.mark.parametrize("bad", [dict(dp=0), dict(act_mode="xx"),
                                 dict(microbatches=0), dict(schedule="zb")])
def test_spec_validation_equals_jax(bad):
    with pytest.raises(ValueError) as te:
        og.ParallelismSpec(**bad)
    with pytest.raises(ValueError) as je:
        jog.ParallelismSpec(**bad)
    assert str(te.value) == str(je.value)


def test_tp_boundary_and_moe_helpers_equal_jax():
    for kw in (dict(tp=4), dict(tp=4, act_mode="sp"), dict(tp=1)):
        ts, js = specs(kw)
        assert tup(og.tp_boundary_reductions("x.tp", 123.0, ts, "bfloat16",
                                             count=3)) == \
            tup(jog.tp_boundary_reductions("x.tp", 123.0, js, "bfloat16",
                                           count=3))
    for name in ARCHS:
        tc, jc = tcr.reduced(name), jcr.reduced(name)
        for kind in set(tc.layer_kinds):
            assert og._row_parallel_per_layer(tc, kind) == \
                jog._row_parallel_per_layer(jc, kind)
    tc, jc = tcr.reduced("moonshot-v1-16b-a3b"), jcr.reduced(
        "moonshot-v1-16b-a3b")
    assert og.moe_routed_bytes(tc, 3, 40, "float32") == \
        jog.moe_routed_bytes(jc, 3, 40, "float32")


@pytest.mark.parametrize("name", ARCHS + ("xlstm-1.3b",))
def test_activation_bytes_and_total_flops_equal_jax(name):
    ts, js = specs(dict(tp=2, pp=2))
    t = og.enumerate_parallel_ops(tcr.reduced(name), 3, 40, ts,
                                  dtype="bfloat16")
    j = jog.enumerate_parallel_ops(jcr.reduced(name), 3, 40, js,
                                   dtype="bfloat16")
    assert [og.activation_bytes(o) for o in t] == \
        [jog.activation_bytes(o) for o in j]
    assert og.total_flops(t) == jog.total_flops(j)


@pytest.mark.parametrize("name", ARCHS + ("xlstm-1.3b",))
def test_layer_segments_equal_jax(name):
    th, tl, tt = og.layer_segments(tcr.reduced(name), 2, 24)
    jh, jl, jt = jog.layer_segments(jcr.reduced(name), 2, 24)
    assert tup(th) == tup(jh) and tup(tt) == tup(jt)
    assert [tup(x) for x in tl] == [tup(x) for x in jl]


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

def _random_graph(seed, n=60, n_streams=4):
    rng = np.random.default_rng(seed)
    streams = [f"s{int(x)}" for x in rng.integers(0, n_streams, n)]
    deps = [tuple(int(d) for d in rng.choice(
        i, size=min(i, int(rng.integers(0, 3))), replace=False))
        for i in range(n)]
    return rng, streams, deps


@pytest.mark.parametrize("seed", range(4))
def test_simulate_equals_jax(seed):
    rng, streams, deps = _random_graph(seed)
    d = rng.uniform(1e-6, 1e-2, len(streams))
    for a, b in zip(S.simulate(d, streams, deps),
                    JS.simulate(d, streams, deps)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_simulate_batch_equals_jax_and_scalar(seed):
    rng, streams, deps = _random_graph(seed)
    D = rng.uniform(1e-6, 1e-2, (5, len(streams)))
    got = S.simulate_batch(D, streams, deps)
    for a, b in zip(got, JS.simulate_batch(D, streams, deps)):
        np.testing.assert_array_equal(a, b)
    for s in range(D.shape[0]):
        st, en, mk = S.simulate(D[s], streams, deps)
        np.testing.assert_array_equal(got[0][s], st)
        np.testing.assert_array_equal(got[1][s], en)
        assert got[2][s] == mk


def test_simulate_empty_graphs_equal_jax():
    assert S.simulate([], [], [])[2] == JS.simulate([], [], [])[2] == 0.0
    for a, b in zip(S.simulate_batch(np.zeros((3, 0)), [], []),
                    JS.simulate_batch(np.zeros((3, 0)), [], [])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(7,), (3, 9), (2, 4, 5), (0,), (2, 0)])
def test_interval_union_equals_jax(shape):
    rng = np.random.default_rng(sum(shape) + 11)
    st = rng.uniform(0, 1, shape)
    en = st + rng.uniform(0, 0.3, shape)
    np.testing.assert_array_equal(S._interval_union(st, en),
                                  JS._interval_union(st, en))


# ---------------------------------------------------------------------------
# graph builders, peak memory, schedule splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("qwen2-0.5b", "moonshot-v1-16b-a3b",
                                  "whisper-small"))
@pytest.mark.parametrize("kw", PIPE_SPECS,
                         ids=lambda kw: og.ParallelismSpec(**kw).tag())
def test_parallel_graph_equals_jax(name, kw):
    ts, js = specs(kw)
    assert graph_tuple(S.build_parallel_graph(tcr.reduced(name), 8, 32, ts)) \
        == graph_tuple(JS.build_parallel_graph(jcr.reduced(name), 8, 32, js))


@pytest.mark.parametrize("kw", PIPE_SPECS,
                         ids=lambda kw: og.ParallelismSpec(**kw).tag())
@pytest.mark.parametrize("train", [dict(), dict(optimizer="sgd",
                                                bucket_mb=0.25,
                                                bwd_fwd_ratio=1.5)],
                         ids=("adamw", "sgd"))
def test_training_graph_equals_jax(kw, train):
    ts, js = specs(kw)
    tt, jt = S.TrainingStepSpec(**train), JS.TrainingStepSpec(**train)
    assert tt.tag() == jt.tag()
    cfg, jcfg = tcr.reduced("qwen2-0.5b"), jcr.reduced("qwen2-0.5b")
    assert graph_tuple(S.build_training_graph(cfg, 8, 32, ts, tt)) == \
        graph_tuple(JS.build_training_graph(jcfg, 8, 32, js, jt))


def test_training_graph_with_empty_stages_equals_jax():
    """pp above the layer count leaves stages empty: the bucket anchors
    come from the wiring, in both packages alike."""
    ts, js = specs(dict(dp=2, pp=6, microbatches=2))
    tt, jt = (S.TrainingStepSpec(bucket_mb=5.0),
              JS.TrainingStepSpec(bucket_mb=5.0))
    assert graph_tuple(S.build_training_graph(
        tcr.reduced("qwen2-0.5b", n_layers=2), 8, 32, ts, tt)) == \
        graph_tuple(JS.build_training_graph(
            jcr.reduced("qwen2-0.5b", n_layers=2), 8, 32, js, jt))


@pytest.mark.parametrize("kw", PIPE_SPECS + [{}],
                         ids=lambda kw: og.ParallelismSpec(**kw).tag())
@pytest.mark.parametrize("train", [None, "adamw", "sgd"])
def test_peak_memory_equals_jax(kw, train):
    ts, js = specs(kw)
    tt = None if train is None else S.TrainingStepSpec(optimizer=train)
    jt = None if train is None else JS.TrainingStepSpec(optimizer=train)
    for dt in (None, "bfloat16"):
        assert S.peak_memory_bytes(tcr.reduced("qwen2-0.5b"), 8, 32, ts, tt,
                                   dtype=dt, per_stage=True) == \
            JS.peak_memory_bytes(jcr.reduced("qwen2-0.5b"), 8, 32, js, jt,
                                 dtype=dt, per_stage=True)


@pytest.mark.parametrize("kind", ("gpipe", "1f1b", "interleaved"))
@pytest.mark.parametrize("pp,mb,stage", [(1, 4, 0), (4, 2, 1), (4, 8, 3)])
def test_schedule_inflight_equals_jax(kind, pp, mb, stage):
    assert S.schedule_inflight(kind, pp, mb, stage) == \
        JS.schedule_inflight(kind, pp, mb, stage)


def _schedule_tuple(sched):
    return ([dataclasses.astuple(r) for r in sched.rows], sched.streams,
            sched.starts.tolist(), sched.ends.tolist(), sched.makespan,
            sched.kind, sched.sequential_seconds, sched.comm_seconds,
            sched.compute_seconds, sched.exposed_comm_seconds, sched.busy(),
            sched.bubble_share, sched.bounds_ok())


@pytest.mark.parametrize("kw", PIPE_SPECS,
                         ids=lambda kw: og.ParallelismSpec(**kw).tag())
def test_schedule_splits_equal_jax(kw):
    """``schedule_parallel``/``schedule_step`` under ``FieldPriced``: rows,
    timeline, busy time per stream, exposed comm and bubble share."""
    ts, js = specs(kw)
    tp, jp = FieldPriced(TRow), FieldPriced(JRow)
    cfg, jcfg = tcr.reduced("qwen2-0.5b"), jcr.reduced("qwen2-0.5b")
    assert _schedule_tuple(S.schedule_parallel(tp, cfg, 8, 32, ts)) == \
        _schedule_tuple(JS.schedule_parallel(jp, jcfg, 8, 32, js))
    got = S.schedule_step(tp, cfg, 8, 32, ts, S.TrainingStepSpec())
    assert _schedule_tuple(got) == _schedule_tuple(
        JS.schedule_step(jp, jcfg, 8, 32, js, JS.TrainingStepSpec()))
    assert got.bounds_ok()


def test_pipeline_bubble_emerges_from_the_schedule():
    """A balanced GPipe forward: the bubble share is (pp-1)/(pp+mb-1)."""
    pp, mb = 4, 8
    sched = S.pipeline_stage_schedule([1.0] * pp, 0.0, microbatches=mb)
    assert sched.bubble_share == pytest.approx((pp - 1) / (pp + mb - 1),
                                               rel=1e-12)
    assert math.isclose(sched.makespan, (pp + mb - 1) / mb, rel_tol=1e-12)
