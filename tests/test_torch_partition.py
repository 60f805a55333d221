"""The port's partition planner (``core/partition.py``) and the stage-level
pipeline schedule (``schedule.pipeline_stage_schedule``) against the JAX
package's.

``plan_two_devices``, ``plan_stages`` and ``pipeline_stage_schedule`` are
plain Python/numpy on both sides: ``==`` on seeded latencies.  The
``plan_*_model`` planners run on both packages' ``BatchPredictor`` over
``tests/test_torch_core.py``'s shared store (the JAX engine's
``_feat_cache`` seeded from the port's rows): ``==`` as well.  The JAX
package's ``activation_comm_cost`` would read a comm-calibration artifact
where one exists; the port never does (comm calibration is not ported), so
these tests point the JAX package's lookup at a file that does not exist."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import registry as jcr  # noqa: E402
from repro.core import batch_predict as jbp  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.core import schedule as JS  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import partition as P  # noqa: E402
from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core.batch_predict import BatchPredictor  # noqa: E402
from repro_torch.core.predictor import PM2Lat  # noqa: E402
from tests.test_torch_core import DEV, _store_json  # noqa: E402


@pytest.fixture(autouse=True)
def no_comm_calibration(tmp_path, monkeypatch):
    monkeypatch.setenv("PM2LAT_COMM_CALIBRATION",
                       str(tmp_path / "absent_comm_calibration.json"))


def plan_tuple(plan):
    return dataclasses.astuple(plan)


def _lats(seed, n):
    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.uniform(0.01, 10.0, n)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("comm", [0.0, 0.7])
def test_plan_two_devices_equals_jax(seed, comm):
    a = _lats(seed, 3 + seed * 2)
    b = [x * (0.5 + 0.2 * seed) for x in _lats(seed + 50, len(a))]
    t = P.plan_two_devices(a, b, comm)
    assert plan_tuple(t) == plan_tuple(JP.plan_two_devices(a, b, comm))
    assert t.split_point == t.boundaries[1]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_stages", [2, 3, 5])
@pytest.mark.parametrize("comm", [0.0, 1.5])
def test_plan_stages_equals_jax(seed, n_stages, comm):
    lats = _lats(seed, 4 + 2 * seed)
    assert plan_tuple(P.plan_stages(lats, n_stages, comm)) == \
        plan_tuple(JP.plan_stages(lats, n_stages, comm))


@pytest.mark.parametrize("lats,n,comm", [([4, 3, 3], 2, 3.0),
                                         ([1, 10], 2, 5.0),
                                         ([1.0] * 3, 6, 0.0)])
def test_plan_stages_edge_cases_equal_jax(lats, n, comm):
    assert plan_tuple(P.plan_stages(lats, n, comm)) == \
        plan_tuple(JP.plan_stages(lats, n, comm))


@pytest.mark.parametrize("stages", [[0.04, 0.04], [0.01, 0.03, 0.02],
                                    [0.05], [0.02, 0.0, 0.03, 0.01]])
@pytest.mark.parametrize("mb", [1, 3, 4])
@pytest.mark.parametrize("handoff", [0.0, 0.015])
def test_pipeline_stage_schedule_equals_jax(stages, mb, handoff):
    t = S.pipeline_stage_schedule(stages, handoff, microbatches=mb)
    j = JS.pipeline_stage_schedule(stages, handoff, microbatches=mb)
    assert [dataclasses.astuple(r) for r in t.rows] == \
        [dataclasses.astuple(r) for r in j.rows]
    assert (t.streams, t.starts.tolist(), t.ends.tolist(), t.makespan,
            t.exposed_comm_seconds, t.bubble_share, t.busy()) == \
        (j.streams, j.starts.tolist(), j.ends.tolist(), j.makespan,
         j.exposed_comm_seconds, j.bubble_share, j.busy())


def test_pipeline_stage_schedule_worked_example():
    """Two 40 ms stages, a 15 ms hand-off, mb 4: 80 ms of makespan, of which
    10 ms no compute covers."""
    sched = S.pipeline_stage_schedule([40e-3, 40e-3], 15e-3, microbatches=4)
    assert sched.makespan == pytest.approx(80e-3, rel=1e-12)
    assert sched.exposed_comm_seconds == pytest.approx(10e-3, rel=1e-9)


@pytest.mark.parametrize("device", [None, "h100_sxm", "a100_80g", "nope"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_comm_cost_equals_jax(device, dtype):
    t = P.activation_comm_cost(tcr.reduced("qwen2-0.5b"), 4, 64, dtype=dtype,
                               device_a=device, device_b="l4")
    j = JP.activation_comm_cost(jcr.reduced("qwen2-0.5b"), 4, 64,
                                dtype=dtype, device_a=device, device_b="l4")
    assert t == j


@pytest.fixture
def engines(tmp_path):
    path = _store_json(tmp_path / "store.json")
    return (BatchPredictor(ttab.TableStore.load(path), DEV),
            jbp.BatchPredictor(jtab.TableStore.load(path), DEV))


def _seed(jeng, teng):
    jeng._feat_cache.update({k: v.copy() for k, v in teng._feat_cache.items()})
    return len(jeng._feat_cache)


@pytest.mark.parametrize("n_stages", [2, 3, 4])
@pytest.mark.parametrize("mb", [1, 4])
@pytest.mark.parametrize("comm", [None, 2e-4])
def test_plan_stages_model_equals_jax(engines, n_stages, mb, comm):
    teng, jeng = engines
    kw = dict(n_stages=n_stages, microbatches=mb, comm_cost=comm,
              dtype="bfloat16")
    tplan, tblocks = P.plan_stages_model(
        teng, tcr.reduced("recurrentgemma-2b", n_layers=6), 4, 64, **kw)
    n_rows = _seed(jeng, teng)
    jplan, jblocks = JP.plan_stages_model(
        jeng, jcr.reduced("recurrentgemma-2b", n_layers=6), 4, 64, **kw)
    assert len(jeng._feat_cache) == n_rows
    assert tblocks == jblocks
    assert plan_tuple(tplan) == plan_tuple(jplan)
    assert tplan.makespan is not None and tplan.microbatches == mb


@pytest.mark.parametrize("device_b,b_speed", [(None, 1.0), (None, 0.5),
                                              ("a100_80g", 1.0)])
@pytest.mark.parametrize("mb", [1, 3])
def test_plan_two_devices_model_equals_jax(engines, device_b, b_speed, mb):
    teng, jeng = engines
    kw = dict(b_speed=b_speed, device_b=device_b, microbatches=mb)
    cfg, jcfg = tcr.reduced("qwen2-0.5b", n_layers=5), \
        jcr.reduced("qwen2-0.5b", n_layers=5)
    tplan, tblocks = P.plan_two_devices_model(teng, cfg, 4, 64, **kw)
    n_rows = _seed(jeng, teng)
    jplan, jblocks = JP.plan_two_devices_model(jeng, jcfg, 4, 64, **kw)
    assert len(jeng._feat_cache) == n_rows
    assert tblocks == jblocks
    assert plan_tuple(tplan) == plan_tuple(jplan)


def test_plan_stages_model_on_the_scalar_predictor(engines):
    """``PM2Lat`` plans too; its blocks equal the engine's to 1e-9."""
    teng, _ = engines
    cfg = tcr.reduced("qwen2-0.5b", n_layers=4)
    pm = PM2Lat(teng.store, DEV)
    plan, blocks = P.plan_stages_model(pm, cfg, 2, 32, n_stages=2,
                                       microbatches=2)
    np.testing.assert_allclose(blocks, teng.predict_blocks(cfg, 2, 32),
                               rtol=1e-9)
    assert plan.boundaries[0] == 0 and plan.boundaries[-1] == 4
    assert plan.makespan == S.pipeline_stage_schedule(
        [sum(blocks[a:b]) for a, b in zip(plan.boundaries,
                                          plan.boundaries[1:])],
        P.activation_comm_cost(cfg, 1, 32), microbatches=2).makespan
