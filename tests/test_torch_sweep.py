"""The port's strategy sweep and schedule-priced predictions
(``core/schedule.py``'s ``sweep_strategies``/``strategy_grid``,
``PM2Lat``/``BatchPredictor``'s ``predict_parallel``/``predict_step``,
``predict_decode_grid(spec=)``).

Tolerances:

* against the JAX package, ``==``: under ``FieldPriced`` (numpy on both
  sides), and through the engines on ``tests/test_torch_core.py``'s shared
  store with the JAX engine's ``_feat_cache`` seeded from the port's rows
  (and asserted to have computed none itself);
* the port's sweep against its own per-spec ``schedule_parallel`` /
  ``schedule_step`` loop, and the port's scalar ``PM2Lat`` against its
  engine: 1e-9 relative (the JAX package's contract,
  ``tests/test_sweep.py``); exposed comm and bubble share, which reach
  exact zeros, 1e-6 relative + 1e-12 absolute as there."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import registry as jcr  # noqa: E402
from repro.core import batch_predict as jbp  # noqa: E402
from repro.core import opgraph as jog  # noqa: E402
from repro.core import schedule as JS  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro.core.predictor import PredictionRow as JRow  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import opgraph as og  # noqa: E402
from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core.batch_predict import BatchPredictor  # noqa: E402
from repro_torch.core.predictor import PM2Lat  # noqa: E402
from repro_torch.core.predictor import PredictionRow as TRow  # noqa: E402
from tests.test_torch_core import DEV, _store_json  # noqa: E402
from tests.test_torch_schedule import FieldPriced  # noqa: E402

RTOL = 1e-9
GRID_KW = dict(dp=(1, 2), tp=(1, 4), pp=(1, 2, 3), microbatches=(1, 2, 4))
FIXED_SPECS = [dict(tp=2), dict(tp=2, act_mode="sp"), dict(dp=2, tp=2),
               dict(pp=2, microbatches=4),
               dict(pp=2, microbatches=4, schedule="1f1b"),
               dict(pp=2, microbatches=4, schedule="interleaved"),
               dict(dp=2, tp=2, pp=2, microbatches=4)]
SWEEP_FIELDS = S.SWEEP_METRICS + S.TRAIN_METRICS + ("peak_bytes", "feasible")


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    return _store_json(tmp_path_factory.mktemp("sweep_store") / "store.json")


@pytest.fixture(scope="module")
def engine(store_path):
    store = ttab.TableStore.load(store_path)
    return PM2Lat(store, DEV), BatchPredictor(store, DEV)


@pytest.fixture
def engines(store_path):
    """Fresh port and JAX engines on the same store file."""
    return (BatchPredictor(ttab.TableStore.load(store_path), DEV),
            jbp.BatchPredictor(jtab.TableStore.load(store_path), DEV))


def _seed(jeng, teng):
    jeng._feat_cache.update({k: v.copy() for k, v in teng._feat_cache.items()})
    return len(jeng._feat_cache)


def _assert_sweeps_equal(t, j):
    assert [s.tag() for s in t.specs] == [s.tag() for s in j.specs]
    assert [t.tag(i) for i in range(len(t))] == [j.tag(i)
                                                 for i in range(len(j))]
    for f in SWEEP_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.rows() == j.rows()
    assert t.best() == j.best()


def _close(a, b, rel=RTOL, abs_=0.0):
    np.testing.assert_allclose(a, b, rtol=rel, atol=abs_)


# ---------------------------------------------------------------------------
# strategy_grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    GRID_KW,
    dict(GRID_KW, act_modes=("tp", "sp"), schedules=og.SCHEDULE_KINDS),
    dict(GRID_KW, max_world=4),
    dict(dp=(1, 2, 4, 8), tp=(1, 2, 4, 8), pp=(1, 2, 4, 8),
         microbatches=(1, 4, 8), max_world=64)])
def test_strategy_grid_equals_jax(kw):
    assert og.SCHEDULE_KINDS == jog.SCHEDULE_KINDS
    t = S.strategy_grid(**kw)
    j = JS.strategy_grid(**kw)
    assert [s.tag() for s in t] == [s.tag() for s in j]
    assert [dataclasses.astuple(s) for s in t] == \
        [dataclasses.astuple(s) for s in j]


# ---------------------------------------------------------------------------
# sweep == JAX sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vectorized", [True, False],
                         ids=("ops_seconds", "rows"))
@pytest.mark.parametrize("train", [None, "one", "per_spec"])
@pytest.mark.parametrize("name", ("qwen2-0.5b", "moonshot-v1-16b-a3b"))
def test_sweep_equals_jax_field_priced(vectorized, train, name):
    kw = dict(GRID_KW, schedules=og.SCHEDULE_KINDS, act_modes=("tp", "sp"))
    tspecs, jspecs = S.strategy_grid(**kw), JS.strategy_grid(**kw)
    if train == "one":
        tt, jt = S.TrainingStepSpec(bucket_mb=0.5), \
            JS.TrainingStepSpec(bucket_mb=0.5)
    elif train == "per_spec":
        tt = [S.TrainingStepSpec(bucket_mb=(0.25, 25.0)[i % 2],
                                 optimizer=("adamw", "sgd")[i % 3 == 0])
              for i in range(len(tspecs))]
        jt = [JS.TrainingStepSpec(**dataclasses.asdict(x)) for x in tt]
    else:
        tt = jt = None
    t = S.sweep_strategies(FieldPriced(TRow, vectorized), tcr.reduced(name),
                           8, 32, tspecs, train=tt, hbm_bytes=2e7)
    j = JS.sweep_strategies(FieldPriced(JRow, vectorized), jcr.reduced(name),
                            8, 32, jspecs, train=jt, hbm_bytes=2e7)
    _assert_sweeps_equal(t, j)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("train", [False, True])
def test_sweep_equals_jax_engine(engines, dtype, train):
    teng, jeng = engines
    tspecs, jspecs = S.strategy_grid(**GRID_KW), JS.strategy_grid(**GRID_KW)
    tt = S.TrainingStepSpec() if train else None
    jt = JS.TrainingStepSpec() if train else None
    t = teng.sweep_strategies(tcr.reduced("qwen2-0.5b"), 8, 32, tspecs,
                              train=tt, dtype=dtype, hbm_bytes=1e8)
    n_rows = _seed(jeng, teng)
    j = jeng.sweep_strategies(jcr.reduced("qwen2-0.5b"), 8, 32, jspecs,
                              train=jt, dtype=dtype, hbm_bytes=1e8)
    assert len(jeng._feat_cache) == n_rows     # every row came from the port
    _assert_sweeps_equal(t, j)


def test_sweep_rejects_what_jax_rejects():
    specs = S.strategy_grid(dp=(1, 2))
    with pytest.raises(ValueError, match="train sequence length"):
        S.sweep_strategies(FieldPriced(TRow), tcr.reduced("qwen2-0.5b"), 4,
                           16, specs, train=[S.TrainingStepSpec()])
    with pytest.raises(ValueError, match="must not mix None"):
        S.sweep_strategies(FieldPriced(TRow), tcr.reduced("qwen2-0.5b"), 4,
                           16, specs, train=[S.TrainingStepSpec(), None])
    for bad in (dict(optimizer="lion"), dict(bucket_mb=0)):
        with pytest.raises(ValueError) as te:
            S.TrainingStepSpec(**bad)
        with pytest.raises(ValueError) as je:
            JS.TrainingStepSpec(**bad)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the port's sweep against its own per-spec loop
# ---------------------------------------------------------------------------

def _golden(pred, cfg, batch, seq, specs, dtype=None):
    sw = pred.sweep_strategies(cfg, batch, seq, specs, dtype=dtype)
    scheds = [pred.schedule_parallel(cfg, batch, seq, sp, dtype=dtype)
              for sp in specs]
    _close(sw.seconds, [s.makespan for s in scheds])
    _close(sw.compute_seconds, [s.compute_seconds for s in scheds])
    _close(sw.comm_seconds, [s.comm_seconds for s in scheds])
    _close(sw.sequential_seconds, [s.sequential_seconds for s in scheds])
    _close(sw.exposed_comm_seconds,
           [s.exposed_comm_seconds for s in scheds], rel=1e-6, abs_=1e-12)
    _close(sw.bubble_share, [s.bubble_share for s in scheds],
           rel=1e-6, abs_=1e-12)
    _close(sw.max_stream_busy, [max(s.busy().values()) for s in scheds])
    assert sw.bounds_ok().all()
    return sw


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_sweep_matches_per_spec_loop(engine, dtype):
    _, bp = engine
    specs = S.strategy_grid(**GRID_KW, schedules=og.SCHEDULE_KINDS)
    sw = _golden(bp, tcr.reduced("qwen2-0.5b"), 8, 32, specs, dtype)
    assert len(set(np.round(sw.seconds, 12))) > len(specs) // 3


def test_sweep_matches_per_spec_loop_fleet_device(engine):
    _, bp = engine
    specs = S.strategy_grid(dp=(1, 2), tp=(1, 4), pp=(1, 2),
                            microbatches=(1, 4))
    _golden(bp.for_device("a100_80g"), tcr.reduced("qwen2-0.5b"), 8, 32,
            specs)


def test_train_sweep_matches_schedule_step(engine):
    _, bp = engine
    cfg = tcr.reduced("qwen2-0.5b")
    trains = [S.TrainingStepSpec(bucket_mb=b) for b in (0.5, 25.0)]
    specs = [sp for sp in S.strategy_grid(dp=(1, 2), tp=(1, 4), pp=(1, 2),
                                          microbatches=(1, 2),
                                          schedules=og.SCHEDULE_KINDS)
             for _ in trains]
    tr = trains * (len(specs) // len(trains))
    sw = bp.sweep_strategies(cfg, 8, 32, specs, train=tr)
    assert sw.bounds_ok().all()
    for i, (sp, t) in enumerate(zip(specs, tr)):
        sched = bp.schedule_step(cfg, 8, 32, spec=sp, train=t)
        assert sw.seconds[i] == pytest.approx(sched.makespan, rel=RTOL)
        assert sw.comm_seconds[i] == pytest.approx(sched.comm_seconds,
                                                   rel=RTOL)
        split = {"fwd": 0.0, "bwd": 0.0, "opt": 0.0}
        for r in sched.rows:
            if r.kind != "collective":
                split[r.name.split(".")[0] if r.name.startswith(
                    ("bwd.", "opt.")) else "fwd"] += r.seconds
        assert sw.fwd_seconds[i] == pytest.approx(split["fwd"], rel=RTOL)
        assert sw.bwd_seconds[i] == pytest.approx(split["bwd"], rel=RTOL)
        assert sw.optimizer_seconds[i] == pytest.approx(split["opt"],
                                                        rel=RTOL)
        assert sw.peak_bytes[i] == S.peak_memory_bytes(cfg, 8, 32, sp, t)


# ---------------------------------------------------------------------------
# scalar and engine entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", FIXED_SPECS,
                         ids=lambda kw: og.ParallelismSpec(**kw).tag())
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_engine_equals_scalar_parallel_and_step(engine, kw, dtype):
    pm, bp = engine
    cfg = tcr.reduced("qwen2-0.5b")
    spec = og.ParallelismSpec(**kw)
    for fn in ("predict_parallel", "predict_step"):
        want, wrows = getattr(pm, fn)(cfg, 8, 32, spec, dtype=dtype)
        got, grows = getattr(bp, fn)(cfg, 8, 32, spec, dtype=dtype)
        assert got == pytest.approx(want, rel=RTOL)
        assert [(r.name, r.kind, r.kernel) for r in grows] == \
            [(r.name, r.kind, r.kernel) for r in wrows]
        np.testing.assert_allclose([r.seconds for r in grows],
                                   [r.seconds for r in wrows], rtol=RTOL)


def test_trivial_spec_is_predict_model(engine):
    """A trivial spec's makespan adds the ``predict_model`` rows left to
    right; ``predict_model`` uses ``sum()`` (compensated on Python 3.12),
    so the two agree to 1e-12, not bit for bit."""
    pm, bp = engine
    cfg = tcr.reduced("qwen2-0.5b")
    for pred in (pm, bp):
        total, rows = pred.predict_model(cfg, 8, 32)
        mk, srows = pred.predict_parallel(cfg, 8, 32, og.ParallelismSpec())
        assert [dataclasses.astuple(r) for r in srows] == \
            [dataclasses.astuple(r) for r in rows]
        assert mk == pytest.approx(total, rel=1e-12)
        assert mk == S.simulate([r.seconds for r in rows],
                                ["compute"] * len(rows),
                                [()] + [(i,) for i in range(len(rows) - 1)])[2]


@pytest.mark.parametrize("kw", FIXED_SPECS,
                         ids=lambda kw: og.ParallelismSpec(**kw).tag())
def test_engine_parallel_and_step_equal_jax(engines, kw):
    teng, jeng = engines
    ts, js = og.ParallelismSpec(**kw), jog.ParallelismSpec(**kw)
    cfg, jcfg = tcr.reduced("qwen2-0.5b"), jcr.reduced("qwen2-0.5b")
    t_par = teng.schedule_parallel(cfg, 8, 32, ts, dtype="bfloat16")
    t_step = teng.schedule_step(cfg, 8, 32, ts, S.TrainingStepSpec())
    n_rows = _seed(jeng, teng)
    j_par = jeng.schedule_parallel(jcfg, 8, 32, js, dtype="bfloat16")
    j_step = jeng.schedule_step(jcfg, 8, 32, js, JS.TrainingStepSpec())
    assert len(jeng._feat_cache) == n_rows
    for t, j in ((t_par, j_par), (t_step, j_step)):
        assert [dataclasses.astuple(r) for r in t.rows] == \
            [dataclasses.astuple(r) for r in j.rows]
        np.testing.assert_array_equal(t.ends, j.ends)
        assert (t.makespan, t.kind, t.bubble_share,
                t.exposed_comm_seconds) == (j.makespan, j.kind,
                                            j.bubble_share,
                                            j.exposed_comm_seconds)


def test_engine_device_routing(engine):
    """``device=`` routes through ``for_device`` as the JAX engine does."""
    _, bp = engine
    cfg = tcr.reduced("qwen2-0.5b")
    spec = og.ParallelismSpec(tp=2, pp=2, microbatches=2)
    fleet = bp.for_device("h100_sxm")
    assert bp.predict_parallel(cfg, 4, 32, spec, device="h100_sxm")[0] == \
        fleet.predict_parallel(cfg, 4, 32, spec)[0]
    assert bp.predict_step(cfg, 4, 32, spec, device="h100_sxm")[0] == \
        fleet.predict_step(cfg, 4, 32, spec)[0]
    np.testing.assert_array_equal(
        bp.sweep_strategies(cfg, 4, 32, [spec], device="h100_sxm").seconds,
        fleet.sweep_strategies(cfg, 4, 32, [spec]).seconds)
    np.testing.assert_array_equal(
        bp.predict_decode_grid(cfg, (1, 2), (8, 64), device="h100_sxm",
                               spec=spec),
        fleet.predict_decode_grid(cfg, (1, 2), (8, 64), spec=spec))


# ---------------------------------------------------------------------------
# decode grid under a spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("qwen2-0.5b", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-2b"))
@pytest.mark.parametrize("kw", [dict(tp=2), dict(dp=2, tp=4, act_mode="sp")],
                         ids=("tp2", "dp2.tp4.sp"))
def test_decode_grid_spec_matches_scalar_loop(engine, name, kw):
    pm, bp = engine
    cfg = tcr.reduced(name)
    spec = og.ParallelismSpec(**kw)
    batches, ctxs = (1, 4), (1, 64, 513)
    grid = bp.predict_decode_grid(cfg, batches, ctxs, spec=spec)
    for i, b in enumerate(batches):
        for j, c in enumerate(ctxs):
            want, _ = pm.predict_ops(og.enumerate_decode_parallel_ops(
                cfg, b, c, spec))
            assert float(grid[i, j]) == pytest.approx(want, rel=RTOL), (b, c)


@pytest.mark.parametrize("name", ("qwen2-0.5b", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-2b"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_decode_grid_spec_equals_jax_engine(engines, name, dtype):
    teng, jeng = engines
    kw = dict(dp=2, tp=2)
    t = teng.predict_decode_grid(tcr.reduced(name), (1, 4, 16),
                                 (1, 100, 2048), dtype,
                                 spec=og.ParallelismSpec(**kw))
    n_rows = _seed(jeng, teng)
    j = jeng.predict_decode_grid(jcr.reduced(name), (1, 4, 16),
                                 (1, 100, 2048), dtype,
                                 spec=jog.ParallelismSpec(**kw))
    assert len(jeng._feat_cache) == n_rows
    np.testing.assert_array_equal(t, j)
