"""The port's comm calibration (``core/comm_calibrate.py``), trace
validation (``core/validate.py``), L2 cache correction
(``memory_model.collect_cache_samples`` / ``fit_cache_correction``) and the
seams through which they change predictions, against the JAX package's on
the same numpy inputs.

Tolerance: none (``==``) unless a test says otherwise: the fits, the
replay and the lookups are numpy on both sides.  Artifacts are written only
under ``tmp_path``; both packages read ``PM2LAT_COMM_CALIBRATION``, which
``tests/conftest.py`` points at a file that never exists, so without a
test's own artifact both take the datasheet path.  The sweeps run on the
CPU here (``device="cpu"``); on the card they run in ``chip_smoke.py``'s
phase ``service``."""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.configs import registry as jcr  # noqa: E402
from repro.core import batch_predict as jbp  # noqa: E402
from repro.core import collectives as JC  # noqa: E402
from repro.core import comm_calibrate as JCC  # noqa: E402
from repro.core import devices as JD  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro.core import validate as JV  # noqa: E402
from repro.core.predictor import PM2Lat as JPM2Lat  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.core import comm_calibrate as CC  # noqa: E402
from repro_torch.core import devices as D  # noqa: E402
from repro_torch.core import memory_model as mm  # noqa: E402
from repro_torch.core import partition as P  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core import validate as V  # noqa: E402
from repro_torch.core.batch_predict import BatchPredictor  # noqa: E402
from repro_torch.core.predictor import PM2Lat  # noqa: E402
from tests.test_torch_core import DEV, _store_json  # noqa: E402

TRUTHS = {
    "mesh": (C.Interconnect("nvlink-mesh", 23e9, 2.6e-6, 12, eff_gamma=0.045),
             JC.Interconnect("nvlink-mesh", 23e9, 2.6e-6, 12, eff_gamma=0.045)),
    "pcie": (C.Interconnect("pcie-tree", 27e9, 6.5e-6, 1, eff_gamma=0.15),
             JC.Interconnect("pcie-tree", 27e9, 6.5e-6, 1, eff_gamma=0.15)),
    "ethernet": (C.Interconnect("ethernet", 1.25e9, 25e-6, 1, eff_gamma=0.25),
                 JC.Interconnect("ethernet", 1.25e9, 25e-6, 1,
                                 eff_gamma=0.25)),
}
CACHE = {"l2_bytes": 4e6, "hit_rate": 0.55, "speedup": 2.5}


def _fit():
    return CC.CommFit("nvlink-mesh", 23e9, 2.6e-6, 0.045, 12,
                      rel_err=0.01, n_points=90)


@pytest.fixture
def artifact(tmp_path, monkeypatch):
    """An artifact path both packages' lookups read (nothing there yet)."""
    path = str(tmp_path / "comm_calibration.json")
    monkeypatch.setenv(CC.CALIBRATION_ENV, path)
    return path


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    return _store_json(tmp_path_factory.mktemp("cc_store") / "store.json")


# ---------------------------------------------------------------------------
# the fitter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coll", C.COLLECTIVES)
@pytest.mark.parametrize("algo", ["ring", "tree"])
def test_algo_coeffs_equal_jax(coll, algo):
    for world in (1, 2, 3, 4, 6, 8, 64):
        for nbytes in (0.0, 1.0, 512.0, 3e6, float(1 << 30)):
            assert (CC._algo_coeffs(coll, algo, nbytes, world)
                    == JCC._algo_coeffs(coll, algo, nbytes, world))
    with pytest.raises(ValueError, match="unknown"):
        CC._algo_coeffs(coll, "star", 1.0, 2)


@pytest.mark.parametrize("truth", sorted(TRUTHS))
@pytest.mark.parametrize("noise", [0.0, 0.05])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_interconnect_equals_jax(truth, noise, seed):
    tic, jic = TRUTHS[truth]
    recs = CC.synthesize_records(tic, noise=noise, seed=seed)
    jrecs = JCC.synthesize_records(jic, noise=noise, seed=seed)
    assert [r.to_json() for r in recs] == [r.to_json() for r in jrecs]
    links = tic.links_per_gpu
    fit = CC.fit_interconnect(recs, tic.topology, links_per_gpu=links)
    jfit = JCC.fit_interconnect(jrecs, jic.topology, links_per_gpu=links)
    assert fit.to_json() == jfit.to_json()
    assert fit.interconnect() == C.Interconnect.from_fit(fit)
    assert dataclasses.asdict(fit.interconnect()) == \
        dataclasses.asdict(jfit.interconnect())
    if noise == 0.0:
        assert fit.rel_err < 5e-3
        assert abs(fit.link_bw - tic.link_bw) / tic.link_bw < 0.02


def test_wls_and_fixed_gamma_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        a, b = rng.uniform(0, 10, 12), rng.uniform(1e3, 1e8, 12)
        t = a * 3e-6 + b * rng.uniform(1e-11, 1e-9) + rng.uniform(0, 1e-6, 12)
        assert CC._wls_nonneg(a, b, t) == JCC._wls_nonneg(a, b, t)
    # the clamped branch: a negative α forces the active set
    a, b = np.array([4.0, 4.0, 4.0]), np.array([1e3, 1e6, 1e7])
    t = np.array([1e-7, 1e-4, 1e-3])
    assert CC._wls_nonneg(a, b, t) == JCC._wls_nonneg(a, b, t)
    recs = CC.synthesize_records(TRUTHS["pcie"][0], noise=0.02, seed=4)
    jrecs = JCC.synthesize_records(TRUTHS["pcie"][1], noise=0.02, seed=4)
    for g in (0.0, 0.1, 0.37):
        assert (CC._solve_fixed_gamma(recs, g)
                == JCC._solve_fixed_gamma(jrecs, g))


def test_fit_rejects_what_jax_rejects():
    for mod in (CC, JCC):
        with pytest.raises(ValueError, match="informative"):
            mod.fit_interconnect([mod.CommRecord("all_reduce", 1024.0, 1,
                                                 1e-5)], "ethernet")


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

def test_calibration_json_round_trip_crosses_packages(tmp_path):
    cal = CC.CommCalibration(fits={"a100_80g": _fit(),
                                   "l4": CC.CommFit("pcie-tree", 27e9,
                                                    6.5e-6, 0.15)},
                             cache={"h100_sxm": dict(CACHE)},
                             meta={"seconds": 1.5})
    port, ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    cal.save(port)
    jcal = JCC.load_calibration(port)
    assert jcal.to_json() == cal.to_json()
    jcal.save(ref)
    assert open(ref).read() == open(port).read()
    back = CC.load_calibration(ref)
    assert back.to_json() == cal.to_json()
    assert back.fits["a100_80g"] == _fit()
    assert CC.CommFit.from_json({"topology": "ethernet", "link_bw": 1,
                                 "link_latency": 0, "eff_gamma": 0}) == \
        CC.CommFit("ethernet", 1.0, 0.0, 0.0)


def test_default_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(CC.CALIBRATION_ENV)
    path = CC.default_calibration_path()
    assert path.endswith("artifacts/torch/comm_calibration.json")
    assert path != JCC.default_calibration_path()
    monkeypatch.setenv(CC.CALIBRATION_ENV, str(tmp_path / "x.json"))
    assert CC.default_calibration_path() == \
        JCC.default_calibration_path() == str(tmp_path / "x.json")
    assert CC.default_traces_dir() == JCC.default_traces_dir()


@pytest.mark.parametrize("content,error", [
    ("{not json", "comm_calibration.json"), (b"\xff\xfe", "comm_calib")])
def test_corrupt_artifact_raises_as_jax(artifact, content, error):
    with open(artifact, "wb") as f:
        f.write(content.encode() if isinstance(content, str) else content)
    for mod in (CC, JCC):
        with pytest.raises(ValueError, match=error):
            mod.load_calibration(artifact)


@pytest.mark.parametrize("schema", [None, 0, 2, 999])
def test_schema_mismatch_warns_once_and_is_absent_as_jax(artifact, schema):
    with open(artifact, "w") as f:
        json.dump({"schema": schema, "fits": {}}, f)
    for mod in (CC, JCC):
        with pytest.warns(UserWarning, match="schema"):
            assert mod.load_calibration(artifact) is None
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert mod.load_calibration(artifact) is None
        assert mod.calibration_tag("a100_80g") is None


def test_missing_artifact_is_absent(artifact):
    for mod in (CC, JCC):
        assert mod.load_calibration(artifact) is None
        assert mod.load_calibration() is None


@pytest.mark.parametrize("fits,cache", [
    ({"a100_80g": True}, {}), ({}, {"a100_80g": True}),
    ({"a100_80g": True, "l4": True}, {"a100_80g": True, DEV: True})])
def test_calibration_tag_equals_jax(artifact, fits, cache):
    assert CC.calibration_tag("a100_80g") is None
    cal = CC.CommCalibration(
        fits={d: _fit() for d in fits},
        cache={d: dict(CACHE, l2_bytes=CACHE["l2_bytes"] + i)
               for i, d in enumerate(cache)})
    cal.save(artifact)
    for dev in ("a100_80g", "l4", DEV, "h100_sxm", None):
        tag = CC.calibration_tag(dev)
        assert tag == JCC.calibration_tag(dev)
        assert (tag is None) == (dev not in set(fits) | set(cache))
    # a new fit fingerprints differently in both packages
    first = CC.calibration_tag("a100_80g")
    cal.fits["a100_80g"] = dataclasses.replace(_fit(), link_bw=24e9)
    cal.cache.pop("a100_80g", None)
    cal.save(artifact)
    assert CC.calibration_tag("a100_80g") == JCC.calibration_tag("a100_80g")
    assert CC.calibration_tag("a100_80g") != first


@pytest.mark.parametrize("dev", ["a100_80g", "l4", "h100_sxm", DEV, None])
def test_lookups_with_and_without_artifact_equal_jax(artifact, dev):
    def both():
        ic, jic = CC.calibrated_interconnect(dev), \
            JCC.calibrated_interconnect(dev)
        assert dataclasses.asdict(ic) == dataclasses.asdict(jic)
        cc, jcc = CC.cache_correction_for(dev), JCC.cache_correction_for(dev)
        assert (cc is None) == (jcc is None)
        if cc is not None:
            assert cc.to_json() == jcc.to_json()
            w = np.logspace(3, 10, 30)
            np.testing.assert_array_equal(cc.factor(w), jcc.factor(w))
        return ic, cc

    ic, cc = both()
    assert ic == C.interconnect_for(dev) and cc is None
    CC.CommCalibration(fits={"a100_80g": _fit()},
                       cache={d: dict(CACHE) for d in ("a100_80g", DEV)}
                       ).save(artifact)
    ic, cc = both()
    assert (ic.link_bw == 23e9) == (dev == "a100_80g")
    assert (cc is not None) == (dev in ("a100_80g", DEV))


# ---------------------------------------------------------------------------
# the L2 cache correction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("truth", [(0.55, 2.5), (0.9, 6.0), (0.0, 1.0)])
def test_fit_cache_correction_equals_jax(seed, truth):
    rng = np.random.default_rng(seed)
    coef = np.array([rng.uniform(2e-11, 2e-10), 0.0, 0.0,
                     rng.uniform(1e-6, 5e-6)])
    l2 = float(rng.choice([4e6, 32e6, 50 * 2 ** 20]))
    tc = mm.CacheCorrection(l2_bytes=l2, hit_rate=truth[0], speedup=truth[1])
    w = np.logspace(4.5, 9.5, 7 + seed)
    y = (coef[0] * w * tc.factor(w) + coef[3]) * rng.lognormal(0, 0.02,
                                                               w.size)
    samples = [{"bytes": float(b), "duration": float(d)}
               for b, d in zip(w, y)]
    fit, rel = mm.fit_cache_correction(samples, coef, l2)
    jfit, jrel = jmm.fit_cache_correction(samples, coef, l2)
    assert fit.to_json() == jfit.to_json() and rel == jrel
    if truth[0] > 0:
        assert rel < 0.05


def test_fit_cache_correction_rejects_what_jax_rejects():
    bad = [{"bytes": 1e6, "duration": 1e-4}, {"bytes": 0.0, "duration": 1.0},
           {"bytes": 2e6, "duration": 0.0}]
    for mod in (mm, jmm):
        with pytest.raises(ValueError, match="samples"):
            mod.fit_cache_correction(bad, np.ones(4), 1e6)


def test_collect_cache_samples_on_the_cpu():
    sizes = (1 << 12, 1 << 14, 1 << 16)
    samples = mm.collect_cache_samples(sizes, min_reps=2, device="cpu")
    assert [s["bytes"] for s in samples] == [2.0 * s for s in sizes]
    assert all(s["duration"] > 0 and isinstance(s["duration"], float)
               for s in samples)
    fit, rel = mm.fit_cache_correction(samples, np.array(
        [1e-10, 0.0, 0.0, 1e-6]), 32 * 2 ** 20)
    assert 0.0 <= fit.hit_rate <= 1.0 and np.isfinite(rel)


def test_sweeps_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mm.collect_cache_samples((1024,))
    with pytest.raises(RuntimeError, match="CUDA"):
        CC.run_host_sweep(sizes=(1024,), worlds=(2,), colls=("p2p",))
    with pytest.raises(RuntimeError, match="CUDA"):
        CC.calibrate_comm(save=False, verbose=False)


def test_host_sweep_on_the_cpu_fits():
    recs = CC.run_host_sweep(sizes=(4096, 65536, 1 << 20), worlds=(2, 4),
                             colls=("all_reduce", "broadcast"), min_reps=2,
                             device="cpu")
    assert [(r.coll, r.nbytes, r.world) for r in recs] == [
        (c, float(n), w) for w in (2, 4) for c in ("all_reduce", "broadcast")
        for n in (4096, 65536, 1 << 20)]
    assert all(r.measured_s > 0 for r in recs)
    fit = CC.fit_interconnect(recs, "ethernet")
    jfit = JCC.fit_interconnect(
        [JCC.CommRecord.from_json(r.to_json()) for r in recs], "ethernet")
    assert fit.to_json() == jfit.to_json() and fit.link_bw > 0


def test_calibrate_comm_on_the_cpu(tmp_path, monkeypatch, store_path):
    """The whole loop on the CPU at small sizes: the trace fits equal the
    JAX package's fits of the same traces, the loopback fit is filed under
    the CPU's store name, the L2 fit under the store's profile L2 size."""
    traces = CC.default_traces_dir()
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    (tmp_path / "torch").mkdir()
    store = ttab.TableStore.load(store_path)
    store.save(str(tmp_path / "torch" / "calibration_torch_cpu_host.json"))
    sweep = CC.run_host_sweep
    monkeypatch.setattr(CC, "run_host_sweep", lambda **kw: sweep(
        sizes=(4096, 1 << 16), worlds=(2, 4), min_reps=2, **kw))
    samples = mm.collect_cache_samples
    monkeypatch.setattr(mm, "collect_cache_samples", lambda **kw: samples(
        (1 << 12, 1 << 14, 1 << 16), min_reps=2, **kw))
    path = str(tmp_path / "out.json")
    cal = CC.calibrate_comm(path, device="cpu", traces_dir=traces,
                            verbose=False)
    assert set(cal.fits) == {"torch_cpu_host", "a100_80g", "l4"}
    for name in ("nccl_a100_nvlink_w8", "nccl_l4_pcie_w4"):
        tr = JV.load_trace(f"{traces}/{name}.json")
        jfit = JCC.fit_interconnect(
            [JCC.CommRecord.from_json(r) for r in tr["records"]],
            tr["topology"], links_per_gpu=int(tr.get("links_per_gpu", 1)))
        assert cal.fits[tr["device"]].to_json() == jfit.to_json()
    cc = cal.cache["torch_cpu_host"]
    assert cc["l2_bytes"] == D.get_profile("torch_cpu_host").l2_bytes
    assert len(cal.meta["cache_samples"]) == 3
    assert CC.load_calibration(path).to_json() == \
        json.loads(json.dumps(cal.to_json()))


# ---------------------------------------------------------------------------
# trace validation
# ---------------------------------------------------------------------------

def _trace_fits(mod, vmod):
    cal = mod.CommCalibration()
    for p in vmod.list_traces():
        tr = vmod.load_trace(p)
        if tr["kind"] == "collective":
            cal.fits[tr["device"]] = mod.fit_interconnect(
                [mod.CommRecord.from_json(r) for r in tr["records"]],
                tr["topology"], links_per_gpu=int(tr.get("links_per_gpu", 1)))
    return cal


@pytest.mark.parametrize("calibrated", [False, True])
def test_run_validation_equals_jax(calibrated):
    cal = _trace_fits(CC, V) if calibrated else None
    jcal = _trace_fits(JCC, JV) if calibrated else None
    reps, jreps = V.run_validation(calibration=cal), \
        JV.run_validation(calibration=jcal)
    assert [r.name for r in reps] == [
        "ddp_bucket_overlap", "gpipe_pp2_mb4", "nccl_a100_nvlink_w8",
        "nccl_l4_pcie_w4"]
    assert [r.to_json() for r in reps] == [r.to_json() for r in jreps]
    assert [r.table() for r in reps] == [r.table() for r in jreps]
    if calibrated:
        assert all(r.passed for r in reps)
    else:
        assert not {r.name: r for r in reps}["nccl_a100_nvlink_w8"].passed


@pytest.mark.parametrize("name", ["nccl_a100_nvlink_w8", "nccl_l4_pcie_w4"])
def test_perturbed_fit_fails_the_budget_as_jax(name):
    tr = V.load_trace(f"{CC.default_traces_dir()}/{name}.json")
    fit = _trace_fits(CC, V).fits[tr["device"]]
    jfit = _trace_fits(JCC, JV).fits[tr["device"]]
    bad = V.validate_collective_trace(tr, ic=dataclasses.replace(
        fit.interconnect(), link_bw=fit.link_bw / 3.0))
    jbad = JV.validate_collective_trace(tr, ic=dataclasses.replace(
        jfit.interconnect(), link_bw=jfit.link_bw / 3.0))
    assert bad.to_json() == jbad.to_json()
    assert not bad.passed and bad.mean_rel_err > 3 * V.BUDGETS["collective"]


def test_schedule_trace_and_budgets_equal_jax():
    assert V.BUDGETS == JV.BUDGETS == {"collective": 0.10, "schedule": 0.05}
    tr = V.load_trace(f"{CC.default_traces_dir()}/gpipe_pp2_mb4.json")
    tr["measured"]["stream_busy_s"] = {"comm": 0.5e-3, "compute:s0": 4e-3}
    assert (V.validate_schedule_trace(tr).to_json()
            == JV.validate_schedule_trace(tr).to_json())
    tr["nodes"][0]["duration_s"] *= 2.0
    rep = V.validate_trace(tr, budget=0.2)
    assert rep.to_json() == JV.validate_trace(tr, budget=0.2).to_json()
    for b in (100, 512, 1023, 1024, 8192, 1 << 20, 3 << 30):
        assert V._size_bucket(b) == JV._size_bucket(b)


@pytest.mark.parametrize("body,error", [
    ({"schema": 99, "kind": "collective"}, "schema"),
    ({"schema": 1, "kind": "mystery"}, "kind"),
    ("{nope", "t.json")])
def test_load_trace_rejects_what_jax_rejects(tmp_path, body, error):
    p = str(tmp_path / "t.json")
    with open(p, "w") as f:
        f.write(body if isinstance(body, str) else json.dumps(body))
    for vmod in (V, JV):
        with pytest.raises(ValueError, match=error):
            vmod.load_trace(p)
    assert V.list_traces(str(tmp_path)) == JV.list_traces(str(tmp_path))
    assert V.list_traces(str(tmp_path / "none")) == []


def test_validators_reject_what_jax_rejects():
    fwd = {"name": "bad", "kind": "schedule",
           "nodes": [{"name": "a", "stream": "s", "duration_s": 1.0,
                      "deps": ["b"]},
                     {"name": "b", "stream": "s", "duration_s": 1.0,
                      "deps": []}], "measured": {"makespan_s": 2.0}}
    empty = {"name": "e", "kind": "collective", "device": "l4",
             "records": [{"coll": "p2p", "nbytes": 1.0, "world": 1,
                          "measured_s": 1.0}]}
    for vmod in (V, JV):
        with pytest.raises(ValueError, match="forward"):
            vmod.validate_schedule_trace(fwd)
        with pytest.raises(ValueError, match="informative"):
            vmod.validate_collective_trace(empty)


# ---------------------------------------------------------------------------
# the seams, with an artifact passed by path
# ---------------------------------------------------------------------------

def _seeded(store_path):
    t = BatchPredictor(ttab.TableStore.load(store_path), DEV)
    j = jbp.BatchPredictor(jtab.TableStore.load(store_path), DEV)
    return t, j


@pytest.mark.parametrize("with_artifact", [False, True])
def test_predictor_seams_equal_jax(artifact, store_path, with_artifact):
    if with_artifact:
        CC.CommCalibration(fits={DEV: CC.CommFit("pcie-tree", 9e9, 4e-6,
                                                 0.1)},
                           cache={DEV: dict(CACHE)}).save(artifact)
    pm = PM2Lat(ttab.TableStore.load(store_path), DEV)
    jpm = JPM2Lat(jtab.TableStore.load(store_path), DEV)
    assert (pm.memory_model.cache is None) == (not with_artifact)
    if with_artifact:
        assert pm.memory_model.cache.to_json() == \
            jpm.memory_model.cache.to_json()
    assert dataclasses.asdict(pm.interconnect) == \
        dataclasses.asdict(jpm.interconnect)
    feats = {"bytes": 3e6, "flops": 1e6, "transcendentals": 1e4}
    for cls in (None, "softmax", "norm", "pointwise", "scan"):
        assert pm.memory_model.predict(feats, cls) == \
            jpm.memory_model.predict(feats, cls)
    t, j = _seeded(store_path)
    cfg, jcfg = tcr.reduced("qwen2-0.5b"), jcr.reduced("qwen2-0.5b")
    for dt in ("float32", "bfloat16"):
        got = t.predict_model_grid(cfg, (1, 4), (16, 64), dt)
        dec = t.predict_decode_grid(cfg, (1, 4), (16, 64), dtype=dt)
        j._feat_cache.update(t._feat_cache)
        np.testing.assert_array_equal(
            got, j.predict_model_grid(jcfg, (1, 4), (16, 64), dt))
        np.testing.assert_array_equal(
            dec, j.predict_decode_grid(jcfg, (1, 4), (16, 64), dtype=dt))
    assert t.cache_device == j.cache_device
    assert (t.cache_device == DEV) == (not with_artifact)
    assert dataclasses.asdict(t.interconnect) == \
        dataclasses.asdict(j.interconnect)


def test_correction_lowers_memory_rows_only(artifact, store_path):
    t, _ = _seeded(store_path)
    cfg = tcr.reduced("qwen2-0.5b")
    base, rows = t.predict_model(cfg, 4, 64)
    CC.CommCalibration(cache={DEV: dict(CACHE)}).save(artifact)
    t2, _ = _seeded(store_path)
    corr, rows2 = t2.predict_model(cfg, 4, 64)
    assert corr < base
    for a, b in zip(rows, rows2):
        if a.kind == "memory":
            assert b.seconds <= a.seconds
        else:
            assert b.seconds == a.seconds


@pytest.mark.parametrize("devs", [("a100_80g", "l4"), ("a100_80g", None),
                                  ("h100_sxm", "a100_80g"), (None, None)])
def test_activation_comm_cost_equals_jax(artifact, devs):
    cfg, jcfg = tcr.reduced("qwen2-0.5b"), jcr.reduced("qwen2-0.5b")
    args = dict(dtype="bfloat16", device_a=devs[0], device_b=devs[1])
    before = P.activation_comm_cost(cfg, 4, 128, **args)
    assert before == JP.activation_comm_cost(jcfg, 4, 128, **args)
    CC.CommCalibration(fits={"a100_80g": _fit(),
                             "l4": CC.CommFit("pcie-tree", 3e9, 9e-6, 0.2)}
                       ).save(artifact)
    after = P.activation_comm_cost(cfg, 4, 128, **args)
    assert after == JP.activation_comm_cost(jcfg, 4, 128, **args)
    # a None endpoint's default NIC stays the bottleneck
    assert (after != before) == (None not in devs)


@pytest.mark.parametrize("name", ["a100_80g", "h100_sxm", "l4", "tpu_v5e"])
def test_profile_calibrated_interconnect_equals_jax(artifact, name):
    prof, jprof = D.get_profile(name), JD.get_profile(name)
    assert prof.calibrated_interconnect() == prof.interconnect
    assert dataclasses.asdict(prof.calibrated_interconnect()) == \
        dataclasses.asdict(jprof.calibrated_interconnect())
    CC.CommCalibration(fits={name: _fit()}).save(artifact)
    assert prof.calibrated_interconnect() == _fit().interconnect()
    assert dataclasses.asdict(prof.calibrated_interconnect()) == \
        dataclasses.asdict(jprof.calibrated_interconnect())
    assert prof.interconnect != prof.calibrated_interconnect()
