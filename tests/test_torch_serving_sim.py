"""The port's continuous-batching serving simulator (``core/schedule.py``'s
``TrafficMix``, ``ServingTables``, ``simulate_serving{_steps,,_batch}``) and
``BatchPredictor.serving_tables`` against the JAX package's.

The simulator is numpy on both sides: on seeded mixes (fixed and Poisson
arrivals, single-token requests, weighted lengths) and seeded tables,
every ``ServingStats`` field and every per-request array is ``==`` the JAX
package's.  Within the port, ``simulate_serving`` equals the token-by-token
``simulate_serving_steps`` bit for bit on every time field; occupancy, whose
float additions run in another order (per run against per step), at 1e-9
relative, as the JAX package's own tests hold it.  ``simulate_serving_batch``
equals the scalar calls bit for bit.  ``serving_tables`` is compared with the
JAX engine's on the shared store, ``==``, the JAX engine's ``_feat_cache``
seeded from the port's rows."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import registry as jcr  # noqa: E402
from repro.core import batch_predict as jbp  # noqa: E402
from repro.core import opgraph as jog  # noqa: E402
from repro.core import schedule as JS  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import opgraph as og  # noqa: E402
from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core.batch_predict import BatchPredictor  # noqa: E402
from tests.test_torch_core import DEV, _store_json  # noqa: E402

MIXES = [
    dict(prompt_lens=(7,), output_lens=(5,), n_requests=9),
    dict(prompt_lens=(3, 17), output_lens=(1, 9),
         prompt_weights=(0.2, 1.8), n_requests=20, seed=3),
    dict(prompt_lens=(4, 9, 30), output_lens=(2, 6),
         prompt_weights=(1.0, 1.0, 0.1), arrival_rate=5.0, n_requests=24,
         seed=7),
    dict(prompt_lens=(12, 40), output_lens=(1, 3, 16),
         output_weights=(0.3, 0.3, 0.4), arrival_rate=50.0, n_requests=31,
         seed=11),
    dict(prompt_lens=(5,), output_lens=(1,), arrival_rate=0.5,
         n_requests=6, seed=2),
]
CAPACITIES = (1, 2, 3, 8)


def mixes(kw):
    return S.TrafficMix(**kw), JS.TrafficMix(**kw)


def tables(mix, capacity, seed):
    """Seeded tables whose decode cost grows with batch and ctx, so the
    simulators' fast-forward runs are not constant."""
    rng = np.random.default_rng(seed)
    pre = {int(p): float(rng.uniform(0.005, 0.05)) + 1e-3 * p
           for p in mix.prompt_lens}
    dec = (rng.uniform(0.8e-3, 1.2e-3, (capacity, mix.max_ctx))
           * (1 + 0.3 * np.arange(capacity)[:, None])
           * (1 + 0.01 * np.arange(mix.max_ctx)[None, :]))
    return pre, dec


def assert_stats_equal(a, b, occ_rtol=0.0):
    for f in S.ServingStats.FIELDS:
        x, y = float(getattr(a, f)), float(getattr(b, f))
        if f == "occupancy" and occ_rtol:
            assert np.isclose(x, y, rtol=occ_rtol, atol=0), (f, x, y)
        else:
            assert x == y, (f, x, y)


def assert_detail_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", MIXES)
def test_traffic_mix_sample_and_tag_equal_jax(kw):
    t, j = mixes(kw)
    assert t.tag() == j.tag() and repr(t) == repr(j)
    assert t.max_ctx == j.max_ctx
    for a, b in zip(t.sample(), j.sample()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bad", [dict(prompt_lens=(), output_lens=(1,)),
                                 dict(prompt_lens=(0,), output_lens=(1,)),
                                 dict(prompt_lens=(3,), output_lens=(0,)),
                                 dict(prompt_lens=(3,), output_lens=(2,),
                                      n_requests=0)])
def test_traffic_mix_validation_equals_jax(bad):
    with pytest.raises(ValueError) as te:
        S.TrafficMix(**bad)
    with pytest.raises(ValueError) as je:
        JS.TrafficMix(**bad)
    assert str(te.value) == str(je.value)


def test_serving_tables_validation_equals_jax():
    mix, jmix = mixes(MIXES[1])
    pre, dec = tables(mix, 4, 0)
    cases = [
        (dict(prefill=pre, decode=dec[0]), None),                 # 1-D grid
        (dict(prefill=pre, decode=dec[:, :5]), 4),                # short ctx
        (dict(prefill=pre, decode=dec[:2]), 4),                   # short batch
        (dict(prefill={3: 0.1}, decode=dec), 4),                  # missing plen
    ]
    for kw, cap in cases:
        errs = []
        for mod, m in ((S, mix), (JS, jmix)):
            with pytest.raises(ValueError) as e:
                mod.ServingTables(**kw).validate(m, cap)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    tab = S.ServingTables(prefill=pre, decode=dec)
    jtab_ = JS.ServingTables(prefill=pre, decode=dec)
    assert tab.prefill == jtab_.prefill
    np.testing.assert_array_equal(tab.decode, jtab_.decode)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="capacity must be >=1"):
            S.simulate_serving(mix, bad, pre, dec)
        with pytest.raises(ValueError, match="capacity must be >=1"):
            S.simulate_serving_steps(mix, bad, pre, dec)


@pytest.mark.parametrize("kw", MIXES)
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_simulators_equal_jax(kw, capacity):
    mix, jmix = mixes(kw)
    pre, dec = tables(mix, capacity, capacity)
    for fn in ("simulate_serving", "simulate_serving_steps"):
        t, td = getattr(S, fn)(mix, capacity, pre, dec, return_detail=True)
        j, jd = getattr(JS, fn)(jmix, capacity, pre, dec, return_detail=True)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert_detail_equal(td, jd)


@pytest.mark.parametrize("kw", MIXES)
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_event_driven_equals_token_loop(kw, capacity):
    mix, _ = mixes(kw)
    pre, dec = tables(mix, capacity, 100 + capacity)
    fast, fd = S.simulate_serving(mix, capacity, pre, dec, return_detail=True)
    slow, sd = S.simulate_serving_steps(mix, capacity, pre, dec,
                                        return_detail=True)
    assert_stats_equal(fast, slow, occ_rtol=1e-9)
    assert_detail_equal(fd, sd)


def test_closures_equal_tables():
    """Closures (the legacy arguments) and tables give the same stats."""
    mix, _ = mixes(MIXES[2])
    pre, dec = tables(mix, 3, 5)
    by_table = S.simulate_serving(mix, 3, pre, dec)
    by_closure = S.simulate_serving(mix, 3, lambda p: pre[p],
                                    lambda b, c: dec[b - 1, c - 1])
    assert_stats_equal(by_table, by_closure)
    tab = S.ServingTables.from_callables(mix, 3, lambda p: pre[p],
                                         lambda b, c: dec[b - 1, c - 1])
    np.testing.assert_array_equal(tab.decode, dec)


@pytest.mark.parametrize("kw", MIXES)
def test_batch_equals_scalar_and_jax(kw):
    mix, jmix = mixes(kw)
    caps = list(CAPACITIES) + [2]
    tabs = [S.ServingTables(*tables(mix, max(CAPACITIES), 9))] * 2 + [
        S.ServingTables(*tables(mix, c, 20 + c)) for c in caps[2:]]
    jtabs = [JS.ServingTables(prefill=t.prefill, decode=t.decode)
             for t in tabs]
    stats, det = S.simulate_serving_batch(mix, caps, tabs,
                                          return_detail=True)
    jstats, jdet = JS.simulate_serving_batch(jmix, caps, jtabs,
                                             return_detail=True)
    assert [dataclasses.astuple(s) for s in stats] == \
        [dataclasses.astuple(s) for s in jstats]
    assert_detail_equal(det, jdet)
    for s, c, tab in zip(stats, caps, tabs):
        assert_stats_equal(s, S.simulate_serving(mix, c, tab.prefill,
                                                 tab.decode))
    assert S.simulate_serving_batch(mix, [], []) == []
    with pytest.raises(ValueError, match="capacities but"):
        S.simulate_serving_batch(mix, [1, 2], tabs[:1])


def test_serving_stats_entry_round_trip():
    mix, _ = mixes(MIXES[3])
    st = S.simulate_serving(mix, 3, *tables(mix, 3, 1))
    assert S.ServingStats.from_entry(st.to_entry()) == st
    assert S.ServingStats.FIELDS == JS.ServingStats.FIELDS


@pytest.fixture
def engines(tmp_path):
    path = _store_json(tmp_path / "store.json")
    return (BatchPredictor(ttab.TableStore.load(path), DEV),
            jbp.BatchPredictor(jtab.TableStore.load(path), DEV))


@pytest.mark.parametrize("spec", [None, dict(tp=2), dict(dp=2, tp=2,
                                                          act_mode="sp")],
                         ids=("single", "tp2", "dp2.tp2.sp"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_serving_tables_equal_jax_engine(engines, spec, dtype):
    teng, jeng = engines
    kw = dict(prompt_lens=(16, 48), output_lens=(4, 12), n_requests=10)
    mix, jmix = mixes(kw)
    t = teng.serving_tables(tcr.reduced("qwen2-0.5b"), mix, capacity=4,
                            dtype=dtype,
                            spec=None if spec is None
                            else og.ParallelismSpec(**spec))
    jeng._feat_cache.update({k: v.copy() for k, v in teng._feat_cache.items()})
    n_rows = len(jeng._feat_cache)
    j = jeng.serving_tables(jcr.reduced("qwen2-0.5b"), jmix, capacity=4,
                            dtype=dtype,
                            spec=None if spec is None
                            else jog.ParallelismSpec(**spec))
    assert len(jeng._feat_cache) == n_rows
    assert t.prefill == j.prefill
    np.testing.assert_array_equal(t.decode, j.decode)
    assert t.decode.shape == (4, mix.max_ctx)
    st = [S.simulate_serving(mix, c, t.prefill, t.decode) for c in (1, 4)]
    jst = [JS.simulate_serving(jmix, c, j.prefill, j.decode) for c in (1, 4)]
    assert [dataclasses.astuple(s) for s in st] == \
        [dataclasses.astuple(s) for s in jst]


def test_serving_tables_price_the_scalar_paths(engines):
    """The prefill entry is ``predict_model`` at batch 1 (the schedule's
    makespan under a spec); the decode grid is ``predict_decode_grid``."""
    teng, _ = engines
    cfg = tcr.reduced("qwen2-0.5b")
    mix = S.TrafficMix((16, 40), (3,), n_requests=4)
    tab = teng.serving_tables(cfg, mix, capacity=2)
    assert tab.prefill == {p: float(teng.predict_model(cfg, 1, p)[0])
                           for p in (16, 40)}
    np.testing.assert_array_equal(
        tab.decode, teng.predict_decode_grid(cfg, (1, 2),
                                             np.arange(1, mix.max_ctx + 1)))
    spec = og.ParallelismSpec(tp=2)
    tab = teng.serving_tables(cfg, mix, capacity=2, spec=spec)
    assert tab.prefill[40] == teng.schedule_parallel(cfg, 1, 40,
                                                     spec).makespan
