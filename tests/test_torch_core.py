"""The port's prediction math against the JAX package's: one TableStore JSON,
built by hand here and loaded into both sides, must give bit-identical
answers (``==`` on floats, no tolerance).  Table, oracle, memory model and
predictor are numpy on both sides."""
import dataclasses
import json
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import device as jdevice  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core import opgraph as jog  # noqa: E402
from repro.core import oracle as jor  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro.core.predictor import PM2Lat as JPM2Lat  # noqa: E402
from repro_torch.core import device as tdevice  # noqa: E402
from repro_torch.core.devices.profiles import H100_SXM  # noqa: E402
from repro_torch.core import memory_model as tmm  # noqa: E402
from repro_torch.core import opgraph as tog  # noqa: E402
from repro_torch.core import oracle as tor  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core.predictor import PM2Lat as TPM2Lat  # noqa: E402

DEV = "shared_test_dev"

# Kernel ids both packages know (the JAX package's own families).
MM_IDS = {"xla_default@64x256": (64, 256), "xla_default@256x256": (256, 256),
          "xla_default@1024x1024": (1024, 1024),
          "mm_128x128x128": (256, 256), "mm_8x128x128": (16, 256),
          "mm_64x64x64": (128, 128)}
BMM_IDS = {"xla_default@8x256x256": (8, 256, 256),
           "xla_default@32x64x64": (32, 64, 64),
           "xla_default@2x512x512": (2, 512, 512)}
ATTN_IDS = {"fa_jnp": 4096, "fa_128x128": 1024, "fa_64x64": 512}


def _store_json(path):
    """A store with every table family, anchors drawn from a seeded rng,
    and a memory model; written by the JAX package's TableStore."""
    rng = np.random.default_rng(0)
    st = jtab.TableStore()
    for dtype in ("float32", "bfloat16"):
        for kern, (m0, n0) in MM_IDS.items():
            anchors = {k: float(rng.uniform(1e11, 5e13))
                       for k in (32, 64, 128, 256, 512, 1024, 2048)}
            st.add(jtab.ThroughputTable(
                key=jtab.KernelKey("matmul", kern, dtype, DEV),
                anchors=anchors, org_dur=float(rng.uniform(1e-5, 1e-3)),
                k_max=2048, ref_grid=(m0, n0),
                ref_tiles=int(rng.integers(1, 5))))
        for kern, (b0, m0, n0) in BMM_IDS.items():
            anchors = {k: float(rng.uniform(1e11, 5e13))
                       for k in (32, 128, 512, 4096)}
            st.add(jtab.ThroughputTable(
                key=jtab.KernelKey("bmm", kern, dtype, DEV), anchors=anchors,
                org_dur=float(rng.uniform(1e-5, 1e-3)), k_max=4096,
                ref_grid=(m0, n0), ref_tiles=1, ref_batch=b0))
        for kern, smax in ATTN_IDS.items():
            anchors = {s: float(rng.uniform(1e11, 5e13))
                       for s in (128, 256, 512, 1024, 2048, 4096) if s <= smax}
            st.add(jtab.ThroughputTable(
                key=jtab.KernelKey("attention", kern, dtype, DEV),
                anchors=anchors, org_dur=float(rng.uniform(1e-4, 1e-2)),
                k_max=smax, ref_grid=(8 * smax, smax), ref_tiles=1,
                ref_head_dim=64 if kern != "fa_64x64" else 128))
    st.memory_model = jmm.fit_memory_model(_samples()).to_json()
    st.meta = {"device": DEV}
    st.save(str(path))
    return str(path)


def _samples(n=60, seed=1):
    rng = np.random.default_rng(seed)
    names = ("softmax", "rmsnorm", "add", "gelu", "assoc_scan", "relu")
    out = []
    for i in range(n):
        b = float(rng.uniform(1e4, 1e9))
        out.append({"name": f"{names[i % len(names)]}_{i}",
                    "features": {"bytes": b,
                                 "flops": float(rng.uniform(0, 2) * b / 4),
                                 "transcendentals": float(
                                     rng.uniform(0, 1) * b / 8)},
                    "duration": float(b / 1e12 * rng.uniform(0.8, 1.3)
                                      + 3e-6)})
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    path = _store_json(tmp_path_factory.mktemp("store") / "store.json")
    return jtab.TableStore.load(path), ttab.TableStore.load(path)


def test_store_round_trip_is_identical(stores, tmp_path):
    js, ts = stores
    ts.save(str(tmp_path / "port.json"))
    js.save(str(tmp_path / "ref.json"))
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "ref.json").read_text()))


def test_table_math_bit_identical(stores):
    js, ts = stores
    assert sorted(js.tables) == sorted(ts.tables)
    rng = np.random.default_rng(2)
    for key, jt in js.tables.items():
        tt = ts.tables[key]
        for k in [1, 16, 32, 100, 777, 2048, 5000] + list(
                rng.integers(1, 9000, 20)):
            k = int(k)
            assert tt.interpolate_throughput(k) == jt.interpolate_throughput(k)
            assert tt.duration_at_ref(k) == jt.duration_at_ref(k)
            m, n, b = (int(x) for x in rng.integers(1, 5000, 3))
            assert tt.predict(m, n, k, batch=b) == jt.predict(m, n, k, batch=b)
            assert (tt.predict(m, n, k, tile=(128, 64))
                    == jt.predict(m, n, k, tile=(128, 64)))
            assert tt.rational_throughput(k) == jt.rational_throughput(k)
        assert tt.fit_rational() == jt.fit_rational()


def test_kernel_provider_on_shared_ids():
    ids = list(MM_IDS) + list(BMM_IDS) + list(ATTN_IDS) + [
        "xla_default", "mm_256x256x256", "fa_512x512", "fa_jnp_v2"]
    for kid in ids:
        assert tor.kernel_provider(kid) == jor.kernel_provider(kid), kid
    assert tor.PROVIDER_PALLAS == jor.PROVIDER_PALLAS == "pallas"


def test_kernel_provider_classifies_port_ids_explicitly():
    """The port's framework ids join the framework pool; a new ``fa_*`` id
    is no longer filed as a hand kernel by default, it raises."""
    for kid in ("cublas@1024x1024", "cublas@8x256x256", "fa_model"):
        assert tor.kernel_provider(kid) == tor.PROVIDER_FRAMEWORK
    for kid in ("mm_128x32x128", "fa_64x64"):
        assert tor.kernel_provider(kid) == tor.PROVIDER_PALLAS
    for kid in ("fa_sdpa", "mm_fast", "triton_mm"):
        with pytest.raises(ValueError):
            tor.kernel_provider(kid)
    # the JAX package's prefix rule would file the first one as Pallas
    assert jor.kernel_provider("fa_sdpa") == jor.PROVIDER_PALLAS


def test_oracle_selection_bit_identical(stores):
    js, ts = stores
    jo, to = jor.KernelOracle(js, DEV), tor.KernelOracle(ts, DEV)
    rng = np.random.default_rng(3)
    shapes = [(1, 1), (64, 256), (4096, 896), (896, 151936)] + [
        tuple(int(x) for x in rng.integers(1, 8192, 2)) for _ in range(30)]
    for dtype in ("float32", "bfloat16", "float16"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for prov in (jor.PROVIDER_FRAMEWORK, jor.PROVIDER_PALLAS, None):
                for m, n in shapes:
                    for b in (1, 8):
                        kind = "bmm" if (b > 1 and prov != jor.PROVIDER_PALLAS) \
                            else "matmul"
                        assert (to.select_matmul(kind, dtype, m, n, batch=b,
                                                 provider=prov).key.id()
                                == jo.select_matmul(kind, dtype, m, n, batch=b,
                                                    provider=prov).key.id())
                for s in (1, 64, 300, 1024, 4096, 10000):
                    for hd in (None, 32, 64, 128):
                        assert (to.select_attention(dtype, s, head_dim=hd,
                                                    provider=prov).key.id()
                                == jo.select_attention(dtype, s, head_dim=hd,
                                                       provider=prov).key.id())
                    assert (to.select("attention", dtype, (s, 64),
                                      provider=prov).key.id()
                            == jo.select("attention", dtype, (s, 64),
                                         provider=prov).key.id())
            assert (to.explain("matmul", dtype, (512, 512))
                    == jo.explain("matmul", dtype, (512, 512)))
            assert (to.lookup("matmul", "mm_128x128x128", dtype).key.id()
                    == jo.lookup("matmul", "mm_128x128x128", dtype).key.id())
    m = np.array([64.0, 512.0, 4096.0])
    cands = to.candidates("matmul", "float32", provider=None)
    assert np.array_equal(tor.score_matmul(cands, m, m[::-1]),
                          jor.score_matmul(cands, m, m[::-1]))
    assert np.array_equal(tor.score_attention(cands, m, 64),
                          jor.score_attention(cands, m, 64))
    assert tor.dtype_preference("bfloat16", ["float32", "int8"]) == \
        jor.dtype_preference("bfloat16", ["float32", "int8"])


def test_fit_memory_model_bit_identical():
    samples = _samples(90, seed=4)
    jm, tm = jmm.fit_memory_model(samples), tmm.fit_memory_model(samples)
    assert np.array_equal(tm.coef, jm.coef)
    assert tm.train_rel_err == jm.train_rel_err
    assert sorted(tm.class_coef) == sorted(jm.class_coef)
    for cls in jm.class_coef:
        assert np.array_equal(tm.class_coef[cls], jm.class_coef[cls])
    for s in samples:
        cls = jmm.class_of(s["name"])
        assert tmm.class_of(s["name"]) == cls
        assert tm.predict(s["features"], cls) == jm.predict(s["features"], cls)
    assert tm.to_json() == jm.to_json()
    cc = tmm.CacheCorrection(l2_bytes=5e7, hit_rate=0.5, speedup=3.0)
    jc = jmm.CacheCorrection(l2_bytes=5e7, hit_rate=0.5, speedup=3.0)
    w = np.array([1e3, 4e7, 1e9])
    assert np.array_equal(cc.factor(w), jc.factor(w))
    tcm = dataclasses.replace(tm, cache=cc)
    jcm = dataclasses.replace(jm, cache=jc)
    assert tcm.predict(samples[0]["features"], "softmax") == \
        jcm.predict(samples[0]["features"], "softmax")


def test_predictor_ops_bit_identical(stores):
    js, ts = stores
    jp, tp = JPM2Lat(js, DEV), TPM2Lat(ts, DEV)
    rng = np.random.default_rng(5)
    for dtype in ("float32", "bfloat16"):
        for _ in range(25):
            m, n, k = (int(x) for x in rng.integers(1, 6000, 3))
            for kind, batch in (("matmul", 1), ("bmm", int(rng.integers(2, 64)))):
                jr = jp.predict_op(jog.MatmulOp("x", m=m, n=n, k=k, batch=batch,
                                                count=3, dtype=dtype, kind=kind))
                tr = tp.predict_op(tog.MatmulOp("x", m=m, n=n, k=k, batch=batch,
                                                count=3, dtype=dtype, kind=kind))
                assert (tr.seconds, tr.kernel) == (jr.seconds, jr.kernel)
            b, h, g = (int(x) for x in rng.integers(1, 9, 3))
            s = int(rng.integers(16, 5000))
            hd = int(rng.choice([32, 64, 128]))
            kw = dict(batch=b, heads=h * g, kv_heads=h, sq=s, skv=s, hd=hd,
                      count=2, dtype=dtype)
            jr = jp.predict_op(jog.AttentionOp("a", **kw))
            tr = tp.predict_op(tog.AttentionOp("a", **kw))
            assert (tr.seconds, tr.kernel) == (jr.seconds, jr.kernel)
            assert tp.predict_attention(tog.AttentionOp("a", **kw),
                                        "fa_128x128") == \
                jp.predict_attention(jog.AttentionOp("a", **kw), "fa_128x128")
            assert tp.predict_matmul(tog.MatmulOp("y", m=m, n=n, k=k,
                                                  dtype=dtype),
                                     "mm_64x64x64") == \
                jp.predict_matmul(jog.MatmulOp("y", m=m, n=n, k=k, dtype=dtype),
                                  "mm_64x64x64")


def test_peak_lookup_matches_reference():
    peaks = {"bfloat16": 989e12, "float32": 67e12}
    for dt in ("bfloat16", "float32"):
        assert tdevice.peak_lookup(peaks, dt, "t") == \
            jdevice.peak_lookup(peaks, dt, "t")
    with pytest.raises(KeyError):
        tdevice.peak_lookup(peaks, "int4", "t", strict=True)
    assert H100_SXM.peak("bfloat16") == 989e12
    assert H100_SXM.peak("float32") == 67e12 and H100_SXM.hbm_bw == 3.35e12


def test_measure_host_flops_on_the_cpu():
    assert tdevice._measure_host_flops(n=64, reps=2, device="cpu") > 0


def test_device_resolution_refuses_a_missing_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tdevice.resolve("cuda")
    assert tdevice.resolve("cpu").type == "cpu"


def test_utility_workloads_mirror_the_jax_set():
    """Same names, same seed-0 shapes and inputs; each kind of workload
    (its first shape) computes the same values."""
    import torch
    jw = jmm.utility_workloads(max_feat=512)
    tw = tmm.utility_workloads(max_feat=512, device="cpu")
    assert [n for n, _, _ in tw] == [n for n, _, _ in jw]
    checked = set()
    for (name, tfn, targs), (_, jfn, jargs) in zip(tw, jw):
        assert [tuple(a.shape) for a in targs] == [a.shape for a in jargs]
        for ta, ja in zip(targs, jargs):
            assert np.array_equal(ta.numpy(), np.asarray(ja))
        kind = name.rsplit("_", 1)[0]
        if kind in checked:
            continue
        checked.add(kind)
        with torch.no_grad():
            got = tfn(*targs).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(*jargs)), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    assert len(checked) == 10


def test_dtype_bytes_matches_reference():
    from repro.core import collectives as jcol
    from repro_torch.core import collectives as tcol
    for dt in ("float32", "tf32", "bfloat16", "float16", "int8", "fp8",
               "float64"):
        assert tcol.dtype_bytes(dt) == jcol.dtype_bytes(dt)
    with pytest.raises(KeyError):
        tcol.dtype_bytes("int4", strict=True)
    with pytest.raises(ValueError):
        tcol.CollectiveOp("x", "gossip", 1.0, 2)
