"""The port's latency service (``serving/latency_service.py``) against the
JAX package's, endpoint for endpoint, on one store file both packages load
(``tests/test_torch_core.py``'s ``_store_json``, device ``shared_test_dev``).

Tolerance: none (``==``) unless a test says otherwise.  The prediction
math is numpy on both sides; memory-bound rows use the features the port
counts on meta tensors, so each test runs the port first and then hands
its feature rows to the JAX service's engine (``_seed``), as
``tests/test_torch_batch_predict.py`` does.  No comm-calibration artifact
is in effect (``tests/conftest.py`` points ``PM2LAT_COMM_CALIBRATION``,
which both packages read, at a file that never exists) except where a test
writes one under ``tmp_path``.  No test compares a makespan with
``sum()``: the schedule adds left to right, ``sum()`` is compensated."""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jcr  # noqa: E402
from repro.core import batch_predict as jbp  # noqa: E402
from repro.core import comm_calibrate as JCC  # noqa: E402
from repro.core import schedule as JS  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro.models import registry as jmr  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import latency_service as JL  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import comm_calibrate as CC  # noqa: E402
from repro_torch.core import devices as D  # noqa: E402
from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core.batch_predict import (PredictionCache,  # noqa: E402
                                            config_key)
from repro_torch.core.devices.profiles import FLEET  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import latency_service as L  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from tests.test_torch_core import DEV, _store_json  # noqa: E402

MODEL = "qwen3-mini"
DTYPES = ("float32", "bfloat16")
MIX = dict(prompt_lens=(8, 16), output_lens=(1, 6), n_requests=12, seed=3)
SPECS = (dict(), dict(tp=2), dict(dp=2, tp=2, act_mode="sp"),
         dict(pp=2, microbatches=4), dict(pp=2, microbatches=4,
                                          schedule="1f1b"))


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    return _store_json(tmp_path_factory.mktemp("svc_store") / "store.json")


@pytest.fixture
def services(store_path, tmp_path):
    """Fresh port and JAX services on the same store, each with its own
    cache file under ``tmp_path``."""
    return (L.LatencyService(ttab.TableStore.load(store_path), DEV,
                             cache_path=str(tmp_path / "port_cache.json")),
            JL.LatencyService(jtab.TableStore.load(store_path), DEV,
                              cache_path=str(tmp_path / "jax_cache.json")))


def _seed(jsvc, tsvc):
    """Hand the port's counted feature rows to the JAX service's engine
    (its fleet predictors share the dict)."""
    jsvc.predictor._feat_cache.update(
        {k: v.copy() for k, v in tsvc.predictor._feat_cache.items()})


def _mixes():
    return S.TrafficMix(**MIX), JS.TrafficMix(**MIX)


def _entries(svc):
    return list(svc.cache._od.items())


# ---------------------------------------------------------------------------
# single-device and fleet queries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", [None, "h100_sxm", "l4"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_latency_query_equals_jax(services, device, dtype):
    t, j = services
    a = t.latency_query(MODEL, 2, 16, dtype=dtype, device=device)
    _seed(j, t)
    b = j.latency_query(MODEL, 2, 16, dtype=dtype, device=device)
    assert a.to_json() == b.to_json() and not a.cached
    again = t.latency_query(MODEL, 2, 16, dtype=dtype, device=device)
    assert again.cached and again.seconds == a.seconds
    assert _entries(t) == _entries(j)


def test_latency_query_equals_the_engine(services):
    t, _ = services
    cfg = tcr.get_any(MODEL)
    want, _ = t.predictor.predict_model(cfg, 4, 32, dtype="bfloat16")
    assert t.latency_query(MODEL, 4, 32, dtype="bfloat16").seconds == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_latency_grid_equals_jax_and_fills_the_cache(services, dtype):
    t, j = services
    batches, seqs = (1, 2, 4), (8, 16, 32)
    a = t.latency_grid(MODEL, batches, seqs, dtype=dtype)
    _seed(j, t)
    b = j.latency_grid(MODEL, batches, seqs, dtype=dtype)
    np.testing.assert_array_equal(a, b)
    assert _entries(t) == _entries(j)
    for i, bb in enumerate(batches):
        for k, s in enumerate(seqs):
            r = t.latency_query(MODEL, bb, s, dtype=dtype)
            assert r.cached and r.seconds == float(a[i, k])


@pytest.mark.parametrize("kw", SPECS, ids=lambda k: ".".join(
    f"{a}{b}" for a, b in k.items()) or "trivial")
def test_latency_parallel_equals_jax(services, kw):
    t, j = services
    a = t.latency_parallel(MODEL, 4, 16, dtype="bfloat16", **kw)
    _seed(j, t)
    b = j.latency_parallel(MODEL, 4, 16, dtype="bfloat16", **kw)
    assert a.to_json() == b.to_json() and not a.cached
    assert t.latency_parallel(MODEL, 4, 16, dtype="bfloat16", **kw).cached
    assert _entries(t) == _entries(j)


def test_latency_parallel_trivial_is_latency_query(services):
    """1e-12 relative: the makespan adds left to right, the engine's
    ``predict_model`` uses ``sum()``."""
    t, _ = services
    q = t.latency_query(MODEL, 4, 16)
    p = t.latency_parallel(MODEL, 4, 16)
    assert p.seconds == pytest.approx(q.seconds, rel=1e-12)
    assert p.comm_seconds == 0.0 and p.world == 1


@pytest.mark.parametrize("kw", SPECS[1:], ids=lambda k: ".".join(
    f"{a}{b}" for a, b in k.items()))
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_latency_train_equals_jax(services, kw, optimizer):
    t, j = services
    a = t.latency_train(MODEL, 8, 16, optimizer=optimizer, bucket_mb=4.0,
                        **kw)
    _seed(j, t)
    b = j.latency_train(MODEL, 8, 16, optimizer=optimizer, bucket_mb=4.0,
                        **kw)
    assert a.to_json() == b.to_json()
    assert t.latency_train(MODEL, 8, 16, optimizer=optimizer, bucket_mb=4.0,
                           **kw).cached
    assert _entries(t) == _entries(j)


def _sweep_fields(sw, names):
    return {n: np.asarray(getattr(sw, n)) for n in names}


@pytest.mark.parametrize("train", [False, True])
def test_sweeps_equal_jax_and_share_entries(services, train):
    t, j = services
    grid_kw = dict(dp=(1, 2), tp=(1, 2), pp=(1, 2), microbatches=(1, 2))
    tspecs, jspecs = S.strategy_grid(**grid_kw), JS.strategy_grid(**grid_kw)
    if train:
        a = t.sweep_train(MODEL, 8, 16, tspecs, hbm_bytes=2e8)
        _seed(j, t)
        b = j.sweep_train(MODEL, 8, 16, jspecs, hbm_bytes=2e8)
        names = S.SWEEP_METRICS + S.TRAIN_METRICS + S.MEM_METRICS
    else:
        a = t.sweep_parallel(MODEL, 8, 16, tspecs, hbm_bytes=2e8)
        _seed(j, t)
        b = j.sweep_parallel(MODEL, 8, 16, jspecs, hbm_bytes=2e8)
        names = S.SWEEP_METRICS + S.MEM_METRICS
    fa, fb = _sweep_fields(a, names), _sweep_fields(b, names)
    for n in names:
        np.testing.assert_array_equal(fa[n], fb[n], err_msg=n)
    np.testing.assert_array_equal(a.feasible, b.feasible)
    assert not a.cached.any()
    assert _entries(t) == _entries(j)
    sweep = t.sweep_train if train else t.sweep_parallel
    again = sweep(MODEL, 8, 16, tspecs)
    assert again.cached.all()
    spec = tspecs[-1]
    one = (t.latency_train if train else t.latency_parallel)(
        MODEL, 8, 16, dp=spec.dp, tp=spec.tp, pp=spec.pp,
        microbatches=spec.microbatches)
    assert one.cached and one.seconds == float(fa["seconds"][-1])


@pytest.mark.parametrize("devices,memory_gb", [(4, None), (8, 0.05)])
def test_plan_training_equals_jax(services, devices, memory_gb):
    t, j = services
    a = t.plan_training(MODEL, 8, 16, devices=devices, memory_gb=memory_gb,
                        bucket_mbs=(4.0, 25.0))
    _seed(j, t)
    b = j.plan_training(MODEL, 8, 16, devices=devices, memory_gb=memory_gb,
                        bucket_mbs=(4.0, 25.0))
    assert a.to_json() == b.to_json()
    assert _entries(t) == _entries(j)


# ---------------------------------------------------------------------------
# serving endpoints and the decode admission oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity,tp", [(1, 1), (4, 1), (4, 2)])
def test_latency_serve_equals_jax(services, capacity, tp):
    t, j = services
    tm, jm = _mixes()
    a = t.latency_serve(MODEL, tm, capacity=capacity, tp=tp)
    _seed(j, t)
    b = j.latency_serve(MODEL, jm, capacity=capacity, tp=tp)
    assert a.to_json() == b.to_json() and not a.cached
    assert t.latency_serve(MODEL, tm, capacity=capacity, tp=tp).cached
    assert _entries(t) == _entries(j)


def test_sweep_serve_and_plan_serving_equal_jax(services):
    t, j = services
    tm, jm = _mixes()
    tmixes = [tm, dataclasses.replace(tm, seed=9)]
    jmixes = [jm, dataclasses.replace(jm, seed=9)]
    a = t.sweep_serve(MODEL, tmixes, (1, 2, 4), tps=(1, 2))
    pa = t.plan_serving(MODEL, tm, devices=4, max_capacity=8,
                        memory_gb=1024.0)
    _seed(j, t)
    b = j.sweep_serve(MODEL, jmixes, (1, 2, 4), tps=(1, 2))
    pb = j.plan_serving(MODEL, jm, devices=4, max_capacity=8,
                        memory_gb=1024.0)
    assert [r.to_json() for r in a] == [r.to_json() for r in b]
    assert pa.to_json() == pb.to_json()
    assert _entries(t) == _entries(j)


def test_plan_serving_rejects_what_jax_rejects(services):
    t, j = services
    tm, jm = _mixes()
    for svc, mix in ((t, tm), (j, jm)):
        with pytest.raises(ValueError, match="fits"):
            svc.plan_serving(MODEL, mix, devices=1, max_capacity=2,
                             memory_gb=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_oracle_equals_jax(services, dtype):
    t, j = services
    tg = t.decode_oracle(MODEL, dtype, capacity=4, max_ctx=24)
    tmemo = t.decode_oracle(MODEL, dtype, maxsize=3)
    pts = [(b, c) for b in (1, 2, 4) for c in (1, 7, 24)]
    want = [tg(b, c) for b, c in pts]
    _seed(j, t)
    jg = j.decode_oracle(MODEL, dtype, capacity=4, max_ctx=24)
    assert [jg(b, c) for b, c in pts] == want
    assert tg.cache_info() == jg.cache_info() == {
        "size": 0, "maxsize": 4096, "grid": (4, 24)}
    assert [tmemo(b, c) for b, c in pts] == want
    assert tmemo.cache_info() == {"size": 3, "maxsize": 3, "grid": None}
    off = tg(6, 30)                          # off the grid: the memo
    _seed(j, t)
    assert jg(6, 30) == off and tg.cache_info()["size"] == 1


# ---------------------------------------------------------------------------
# explainability, fleet, cache keys and persistence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", [None, "h100_sxm"])
def test_breakdown_and_explain_equal_jax(services, device):
    t, j = services
    a = t.latency_breakdown(MODEL, 2, 16, dtype="bfloat16", device=device)
    _seed(j, t)
    b = j.latency_breakdown(MODEL, 2, 16, dtype="bfloat16", device=device)
    assert a == b
    for fam, shape in (("matmul", (512, 768)), ("bmm", (64, 64, 16)),
                       ("attention", (1024, 64))):
        for provider in ("framework", None):
            assert (t.explain_kernels(fam, shape, device=device,
                                      provider=provider)
                    == j.explain_kernels(fam, shape, device=device,
                                         provider=provider))


def test_fleet_and_stats(services):
    """Both fleets list the datasheet profiles and the store's device in
    the same order (each registry may also hold devices other tests in the
    process registered)."""
    t, j = services
    shared = {p.name for p in FLEET} | {DEV}
    assert ([d for d in t.fleet() if d in shared]
            == [d for d in j.fleet() if d in shared] == sorted(shared))
    assert t.fleet() == D.list_devices()
    t.latency_query(MODEL, 1, 8)
    t.latency_query(MODEL, 1, 8)
    assert t.stats == {"size": 1, "hits": 1, "misses": 1, "maxsize": 65536}


def test_cache_keys_equal_jax(services):
    t, j = services
    cfg = tcr.get_any(MODEL)
    assert config_key(cfg) == jbp.config_key(jcr.get_any(MODEL))
    for spec in (None, "tp2", "tp2+adamw.b25+train", "serve.cap4.tp1.x"):
        args = (config_key(cfg), t.predictor.cache_device, "bfloat16", 4, 16)
        assert (PredictionCache.make_key(*args, spec=spec)
                == jbp.PredictionCache.make_key(*args, spec=spec))
    assert PredictionCache.make_key("m", DEV, None, 1, 2) == \
        f"m|{DEV}|float32|1|2"
    for dev in (None, "h100_sxm"):
        assert (t.predictor.for_device(dev).cache_device
                == j.predictor.for_device(dev).cache_device)


def _fill(svc, mix):
    svc.latency_query(MODEL, 2, 16)
    svc.latency_parallel(MODEL, 4, 16, tp=2)
    svc.latency_train(MODEL, 8, 16, dp=2)
    svc.latency_serve(MODEL, mix, capacity=2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_file_crosses_packages(store_path, tmp_path, writer):
    """A cache file one package writes (float and dict entries) the other
    loads entry for entry, and answers every query from it as a hit."""
    path = str(tmp_path / "cache.json")
    tm, jm = _mixes()
    t = L.LatencyService(ttab.TableStore.load(store_path), DEV,
                         cache_path=path)
    j = JL.LatencyService(jtab.TableStore.load(store_path), DEV,
                          cache_path=path)
    _fill(t, tm)
    _seed(j, t)
    if writer == "port":
        t.save_cache()
        reader, mix = JL.LatencyService(jtab.TableStore.load(store_path),
                                        DEV, cache_path=path), jm
        want = _entries(t)
    else:
        _fill(j, jm)
        j.save_cache()
        reader, mix = L.LatencyService(ttab.TableStore.load(store_path),
                                       DEV, cache_path=path), tm
        want = _entries(j)
    assert _entries(reader) == want
    assert any(isinstance(v, dict) for _, v in want)
    assert json.loads(open(path).read())["schema"] == 8
    hits = [reader.latency_query(MODEL, 2, 16),
            reader.latency_parallel(MODEL, 4, 16, tp=2),
            reader.latency_train(MODEL, 8, 16, dp=2),
            reader.latency_serve(MODEL, mix, capacity=2)]
    assert all(h.cached for h in hits)
    assert hits[0].seconds == dict(want)[PredictionCache.make_key(
        config_key(tcr.get_any(MODEL)), DEV, None, 2, 16)]


def test_calibrated_keys_miss_datasheet_entries(store_path, tmp_path,
                                               monkeypatch):
    """Once an artifact changes the device's predictions, both services
    tag its keys the same way and the datasheet entries are not hit."""
    t = L.LatencyService(ttab.TableStore.load(store_path), DEV)
    first = t.latency_query(MODEL, 2, 16)
    path = str(tmp_path / "comm_calibration.json")
    monkeypatch.setenv(CC.CALIBRATION_ENV, path)
    CC.CommCalibration(cache={DEV: {"l2_bytes": 4e6, "hit_rate": 0.5,
                                    "speedup": 3.0}}).save(path)
    t2 = L.LatencyService(ttab.TableStore.load(store_path), DEV)
    j2 = JL.LatencyService(jtab.TableStore.load(store_path), DEV)
    tag = CC.calibration_tag(DEV)
    assert tag == JCC.calibration_tag(DEV) and tag is not None
    assert t2.predictor.cache_device == f"{DEV}+cc{tag}" == \
        j2.predictor.cache_device
    t2.cache = t.cache                       # the datasheet entries
    second = t2.latency_query(MODEL, 2, 16)
    assert not second.cached and second.seconds < first.seconds
    _seed(j2, t2)
    assert j2.latency_query(MODEL, 2, 16).seconds == second.seconds


def test_missing_store_is_calibrated_on_the_card_only(store_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        L.LatencyService(None, DEV)
    with pytest.raises(RuntimeError, match="CUDA"):
        L.LatencyService(ttab.TableStore.load(store_path))


# ---------------------------------------------------------------------------
# admission control: the port's engine against the JAX package's
# ---------------------------------------------------------------------------

def _waves(engine):
    sizes = []
    admit = engine._admit

    def record(queue):
        wave = admit(queue)
        sizes.append(len(wave))
        return wave
    engine._admit = record
    return sizes


def test_engine_admits_the_waves_jax_admits(services):
    """Both engines, each under its own package's oracle at one SLO taken
    from the oracle's grid, seat the same waves: each the largest k with
    oracle(k, ctx) <= SLO (1 if none), computed here from the grid."""
    t, j = services
    name, plen, new, cap, n = "qwen2-0.5b", 8, 3, 4, 7
    jcfg = dataclasses.replace(jcr.reduced(name, n_layers=2),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tcr.reduced(name, n_layers=2),
                               compute_dtype="float32")
    ctx = plen + new
    toracle = t.decode_oracle(tcfg, capacity=cap, max_ctx=ctx)
    _seed(j, t)
    joracle = j.decode_oracle(jcfg, capacity=cap, max_ctx=ctx)
    grid = [toracle(k, ctx) for k in range(1, cap + 1)]
    assert grid == [joracle(k, ctx) for k in range(1, cap + 1)]
    slo = sorted(grid)[1]
    want, left = [], n
    while left:
        k = max([k for k in range(1, min(cap, left) + 1)
                 if grid[k - 1] <= slo] or [1])
        want.append(k)
        left -= k

    params = jax.tree.map(np.asarray, jmr.build(jcfg).init(jax.random.key(0)))
    tmodel = convert.from_jax_params(params, tcfg, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, plen).astype(np.int32)
               for _ in range(n)]
    te = ServingEngine(tmodel, max_batch=cap, max_len=ctx + 4,
                       admission_oracle=toracle, slo_tpot=slo)
    je = jeng.ServingEngine(jmr.build(jcfg),
                            jax.tree.map(jnp.asarray, params),
                            max_batch=cap, max_len=ctx + 4,
                            admission_oracle=joracle, slo_tpot=slo)
    tw, jw = _waves(te), _waves(je)
    tdone = te.run([Request(rid=i, prompt=p, max_new_tokens=new)
                    for i, p in enumerate(prompts)])
    jdone = je.run([jeng.Request(rid=i, prompt=p, max_new_tokens=new)
                    for i, p in enumerate(prompts)])
    assert tw == jw == want
    assert te.stats.prefills == len(want)
    assert ([r.out_tokens for r in sorted(tdone, key=lambda r: r.rid)]
            == [r.out_tokens for r in sorted(jdone, key=lambda r: r.rid)])
