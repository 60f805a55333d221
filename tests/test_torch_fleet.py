"""The port's device fleet against the JAX package's: the α–β collective
model (``core/collectives.py``), the fleet profiles and registry
(``core/devices/``), roofline transfer (``core/transfer.py``), the batch
engine's ``for_device`` and the NAS precompute (``core/nas.py``).  All of it
is numpy on both sides, so every comparison is ``==``: no tolerance."""
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import registry as jcr  # noqa: E402
from repro.core import batch_predict as jbp  # noqa: E402
from repro.core import collectives as jcol  # noqa: E402
from repro.core import devices as jdev  # noqa: E402
from repro.core import nas as jnas  # noqa: E402
from repro.core import predictor as jpred  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro.core import transfer as jtr  # noqa: E402
from repro.core.devices import profiles as jprof  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import batch_predict as tbp  # noqa: E402
from repro_torch.core import collectives as tcol  # noqa: E402
from repro_torch.core import devices as tdev  # noqa: E402
from repro_torch.core import nas as tnas  # noqa: E402
from repro_torch.core import predictor as tpred  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core import transfer as ttr  # noqa: E402
from repro_torch.core.devices import profiles as tprof  # noqa: E402
from tests.test_torch_core import DEV, _store_json  # noqa: E402

FLEET_NAMES = [p.name for p in tprof.FLEET]


def _ic_pair(rng):
    """One random interconnect, as (port, JAX) objects with equal fields."""
    kw = dict(topology=str(rng.choice(tcol.TOPOLOGIES)),
              link_bw=float(rng.uniform(1e8, 1e11)),
              link_latency=float(rng.uniform(0, 3e-5)),
              links_per_gpu=int(rng.integers(1, 19)),
              eff_gamma=None if rng.random() < 0.5
              else float(rng.uniform(0, 0.5)))
    return tcol.Interconnect(**kw), jcol.Interconnect(**kw)


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    return _store_json(tmp_path_factory.mktemp("fleet_store") / "store.json")


@pytest.fixture(scope="module")
def stores(store_path):
    return ttab.TableStore.load(store_path), jtab.TableStore.load(store_path)


# ---------------------------------------------------------------------------
# the α–β model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coll", tcol.COLLECTIVES)
@pytest.mark.parametrize("algorithm", [None, "ring", "tree"])
def test_collective_time_equals_reference(coll, algorithm):
    """Seeded random (bytes, world, interconnect), arrays and scalars: the
    times and the ring/tree choice are the reference's, bit for bit."""
    rng = np.random.default_rng(
        [tcol.COLLECTIVES.index(coll), (None, "ring", "tree").index(algorithm)])
    for _ in range(12):
        tic, jic = _ic_pair(rng)
        nbytes = rng.uniform(0, 1e10, 200)
        world = rng.integers(1, 1025, 200)
        t, ta = tcol.collective_time(coll, nbytes, world, tic, algorithm)
        j, ja = jcol.collective_time(coll, nbytes, world, jic, algorithm)
        np.testing.assert_array_equal(t, j)
        assert list(ta) == list(ja)
        n0, w0 = float(nbytes[0]), int(world[0])
        t0, a0 = tcol.collective_time(coll, n0, w0, tic, algorithm)
        j0, b0 = jcol.collective_time(coll, n0, w0, jic, algorithm)
        assert (float(t0), str(a0)) == (float(j0), str(b0))


def test_collective_time_picks_both_algorithms_and_world_one_is_free():
    ic = tprof.H100_SXM.interconnect
    small, sa = tcol.collective_time("all_reduce", 8.0, 64, ic)
    big, ba = tcol.collective_time("all_reduce", 1e10, 64, ic)
    assert (str(sa), str(ba)) == ("tree", "ring") and big > small
    t, a = tcol.collective_time("all_reduce", [1e6, 1e6], [1, 2], ic)
    assert t[0] == 0.0 and a[0] == "none" and t[1] > 0
    with pytest.raises(ValueError):
        tcol.collective_time("all_reduce", 1.0, 2, ic, algorithm="star")
    with pytest.raises(ValueError):
        tcol._ring_time("gossip", 1.0, 2, 1e-6, 1e9)


def test_interconnect_methods_and_errors_equal_reference():
    rng = np.random.default_rng(9)
    worlds = np.array([1, 2, 3, 8, 100])
    for _ in range(20):
        tic, jic = _ic_pair(rng)
        assert tic.raw_bus_bw() == jic.raw_bus_bw()
        assert tic.gamma() == jic.gamma()
        np.testing.assert_array_equal(tic.bus_bw(worlds), jic.bus_bw(worlds))
        assert tic.efficiency(7) == jic.efficiency(7)
        assert isinstance(tic.efficiency(7), float)
    for bad in (dict(topology="torus", link_bw=1.0, link_latency=0.0),
                dict(topology="ethernet", link_bw=0.0, link_latency=0.0),
                dict(topology="ethernet", link_bw=1.0, link_latency=-1.0),
                dict(topology="ethernet", link_bw=1.0, link_latency=0.0,
                     links_per_gpu=0),
                dict(topology="ethernet", link_bw=1.0, link_latency=0.0,
                     eff_gamma=-0.1)):
        with pytest.raises(ValueError):
            tcol.Interconnect(**bad)
        with pytest.raises(ValueError):
            jcol.Interconnect(**bad)
    assert (dataclasses.asdict(tcol.DEFAULT_INTERCONNECT)
            == dataclasses.asdict(jcol.DEFAULT_INTERCONNECT))


def test_interconnect_from_fit():
    fit = type("Fit", (), dict(topology="pcie-tree", link_bw=3e10,
                               link_latency=4e-6, links_per_gpu=1,
                               eff_gamma=0.2))()
    assert (dataclasses.asdict(tcol.Interconnect.from_fit(fit))
            == dataclasses.asdict(jcol.Interconnect.from_fit(fit)))


def test_predict_collective_and_p2p_equal_reference():
    rng = np.random.default_rng(10)
    for _ in range(50):
        tic, jic = _ic_pair(rng)
        coll = str(rng.choice(tcol.COLLECTIVES))
        n, w, c = float(rng.uniform(1, 1e9)), int(rng.integers(1, 64)), \
            int(rng.integers(1, 5))
        assert (tcol.predict_collective(tcol.CollectiveOp("x", coll, n, w, c),
                                        tic)
                == jcol.predict_collective(jcol.CollectiveOp("x", coll, n, w, c),
                                           jic))
        assert tcol.p2p_time(n, tic) == jcol.p2p_time(n, jic)


@pytest.mark.parametrize("devs", [(None,), ("h100_sxm",), ("unknown_dev",),
                                  ("a100_80g", "rtx_4090"),
                                  ("tpu_v5e", "l4", "v100"), ()])
def test_interconnect_lookup_equals_reference(devs):
    if devs:
        assert (dataclasses.asdict(tcol.interconnect_for(devs[0]))
                == dataclasses.asdict(jcol.interconnect_for(devs[0])))
    assert (dataclasses.asdict(tcol.slowest_interconnect(*devs))
            == dataclasses.asdict(jcol.slowest_interconnect(*devs)))


def test_scalar_predictor_prices_collectives_as_reference(stores):
    tstore, jstore = stores
    tp, jp = tpred.PM2Lat(tstore, DEV), jpred.PM2Lat(jstore, DEV)
    assert (dataclasses.asdict(tp.interconnect)
            == dataclasses.asdict(jp.interconnect))
    for coll in tcol.COLLECTIVES:
        tr = tp.predict_op(tcol.CollectiveOp("c", coll, 3e7, 8, count=2))
        jr = jp.predict_op(jcol.CollectiveOp("c", coll, 3e7, 8, count=2))
        assert dataclasses.astuple(tr) == dataclasses.astuple(jr)
    h = tpred.PM2Lat(tstore, "h100_sxm")
    assert h.interconnect == tprof.H100_SXM.interconnect


# ---------------------------------------------------------------------------
# profiles and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FLEET_NAMES)
def test_fleet_profile_equals_reference(name):
    """Field by field, interconnect included.  The TPU's ``notes`` name the
    JAX package's module it mirrors, so only they may differ."""
    t = dataclasses.asdict(tdev.get_profile(name))
    j = dataclasses.asdict(jdev.get_profile(name))
    if name == "tpu_v5e":
        t.pop("notes"), j.pop("notes")
    assert t == j
    assert [p.name for p in tprof.FLEET] == [p.name for p in jprof.FLEET]


@pytest.mark.parametrize("name", FLEET_NAMES)
def test_profile_methods_equal_reference(name):
    t, j = tdev.get_profile(name), jdev.get_profile(name)
    for dt in t.peak_flops:
        assert t.peak(dt) == j.peak(dt) and t.ridge(dt) == j.ridge(dt)
        for ai in (0.1, 1.0, 37.5, 300.0, 1e4):
            assert t.roofline_throughput(ai, dt) == j.roofline_throughput(ai, dt)
    for r in (0.0, 0.1, 0.5):
        assert t.usable_hbm(r) == j.usable_hbm(r)
    with pytest.raises(ValueError):
        t.usable_hbm(1.0)
    assert (dataclasses.asdict(t.calibrated_interconnect())
            == dataclasses.asdict(t.interconnect))


def test_registry_register_and_errors():
    assert tdev.list_devices() == sorted(tdev.REGISTRY)
    assert set(FLEET_NAMES) <= set(tdev.list_devices())
    with pytest.raises(KeyError, match="unknown device"):
        tdev.get_profile("no_such_card")
    h = tdev.get_profile("h100_sxm")
    assert tdev.register(h) is h                       # identical: a no-op
    other = dataclasses.replace(h, sm_count=1)
    with pytest.raises(ValueError, match="already registered"):
        tdev.register(other)
    try:
        assert tdev.register(other, overwrite=True) is other
        assert tdev.get_profile("h100_sxm").sm_count == 1
    finally:
        tdev.register(h, overwrite=True)
    assert tdev.get_profile("h100_sxm") == h


def test_host_profile_equals_reference_on_a_cpu_store(stores):
    tstore, jstore = stores
    t = tdev.host_profile_from_store(tstore, DEV)
    j = jdev.host_profile_from_store(jstore, DEV)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.kind == "cpu" and t.sm_count == (os.cpu_count() or 1)
    # no name: the store's own device
    assert tdev.host_profile_from_store(tstore).name == DEV


def test_host_profile_of_a_card_store_reads_its_sizes(store_path):
    store = ttab.TableStore.load(store_path)
    cpu = tdev.host_profile_from_store(store, DEV)
    store.meta = {**store.meta, "sm_count": 132, "hbm_bytes": 85520809984,
                  "l2_bytes": 52428800, "smem_bytes": 233472}
    card = tdev.host_profile_from_store(store, DEV)
    assert card.kind == "gpu"
    assert (card.sm_count, card.hbm_bytes, card.l2_bytes, card.smem_bytes) \
        == (132, 85520809984, 52428800, 233472)
    # everything transfer reads is derived as on the CPU store
    assert (card.peak_flops, card.hbm_bw, card.interconnect) == \
        (cpu.peak_flops, cpu.hbm_bw, cpu.interconnect)


def test_host_profile_fallbacks():
    st = ttab.TableStore()
    p = tdev.host_profile_from_store(st)
    assert p.name == "cpu_host" and p.peak_flops == {"float32": 5e10}
    assert p.hbm_bw == 2e10
    assert dataclasses.asdict(p) == dataclasses.asdict(
        jdev.host_profile_from_store(jtab.TableStore()))


# ---------------------------------------------------------------------------
# transfer
# ---------------------------------------------------------------------------

def _json(store, path):
    store.save(str(path))
    return json.loads(path.read_text())


@pytest.mark.parametrize("target", FLEET_NAMES)
def test_transfer_store_equals_reference(stores, tmp_path, target):
    tstore, jstore = stores
    tsrc = tdev.host_profile_from_store(tstore, DEV)
    jsrc = jdev.host_profile_from_store(jstore, DEV)
    t = ttr.transfer_store(tstore, tsrc, tdev.get_profile(target))
    j = jtr.transfer_store(jstore, jsrc, jdev.get_profile(target))
    assert _json(t, tmp_path / "t.json") == _json(j, tmp_path / "j.json")
    assert {tb.key.device for tb in t.tables.values()} == {target}
    assert t.meta["transferred_from"] == DEV


def test_identity_transfer_is_exact(stores, tmp_path):
    tstore, _ = stores
    src = tdev.host_profile_from_store(tstore, DEV)
    out = ttr.transfer_store(tstore, src, src)
    assert sorted(out.tables) == sorted(tstore.tables)
    for key, t in tstore.tables.items():
        assert out.tables[key] == t and out.tables[key] is not t
    assert out.memory_model == tstore.memory_model
    got, want = _json(out, tmp_path / "o.json"), _json(tstore, tmp_path / "s.json")
    assert got.pop("meta") == {**want.pop("meta"), "transferred_from": DEV,
                               "transfer": "roofline-ratio"}
    assert got == want


def test_transfer_drops_other_devices_tables(stores):
    tstore, _ = stores
    st = ttab.TableStore()
    for t in tstore.tables.values():
        st.add(t)
        st.add(dataclasses.replace(t, key=dataclasses.replace(
            t.key, device="elsewhere")))
    src = tdev.host_profile_from_store(tstore, DEV)
    out = ttr.transfer_store(st, src, tdev.get_profile("l4"))
    assert len(out.tables) == len(tstore.tables)


def test_transfer_pieces_equal_reference(stores):
    tstore, jstore = stores
    for key, tt in tstore.tables.items():
        jt = jstore.tables[key]
        for k in tt.anchors:
            assert (ttr.arithmetic_intensity(tt, k)
                    == jtr.arithmetic_intensity(jt, k))
    for a in FLEET_NAMES:
        for b in FLEET_NAMES:
            assert ttr._ratio_dtype(tdev.get_profile(a), tdev.get_profile(b)) \
                == jtr._ratio_dtype(jdev.get_profile(a), jdev.get_profile(b))
    bf16_only = dataclasses.replace(tprof.H100_SXM, name="x",
                                    peak_flops={"bfloat16": 1e15})
    assert ttr._ratio_dtype(bf16_only, tprof.A100_80G) == "bfloat16"


@pytest.mark.parametrize("target", ["h100_sxm", "tpu_v5e"])
def test_transfer_memory_model_with_cache_equals_reference(stores, target):
    """The L2 correction moves to the target's L2 size, or goes where the
    target has none."""
    tstore, jstore = stores
    mm = {**tstore.memory_model,
          "cache": {"l2_bytes": 1e6, "hit_rate": 0.5, "speedup": 2.0}}
    t = ttr.transfer_memory_model(mm, tdev.host_profile_from_store(tstore, DEV),
                                  tdev.get_profile(target))
    j = jtr.transfer_memory_model(mm, jdev.host_profile_from_store(jstore, DEV),
                                  jdev.get_profile(target))
    assert t == j
    assert ("cache" in t) == (target != "tpu_v5e")


# ---------------------------------------------------------------------------
# the engine's fleet
# ---------------------------------------------------------------------------

def test_for_device_identity_caching_and_rekeying(store_path):
    bp = tbp.BatchPredictor(ttab.TableStore.load(store_path), DEV)
    assert bp.for_device(None) is bp and bp.for_device(DEV) is bp
    h = bp.for_device("h100_sxm")
    assert h is bp.for_device("h100_sxm")              # built once
    assert h.device == "h100_sxm" and h is not bp
    assert {t.key.device for t in h.store.tables.values()} == {"h100_sxm"}
    assert h._feat_cache is bp._feat_cache             # shared feature rows
    assert tdev.get_profile(DEV) == bp.host_profile()  # registered
    with pytest.raises(KeyError, match="unknown device"):
        bp.for_device("no_such_card")
    cfg = tcr.reduced("qwen2-0.5b")
    assert bp.predict_model(cfg, 2, 32, device="h100_sxm")[0] == \
        h.predict_model(cfg, 2, 32)[0]
    np.testing.assert_array_equal(
        bp.predict_model_grid(cfg, (1, 2), (16,), device="h100_sxm"),
        h.predict_model_grid(cfg, (1, 2), (16,)))
    np.testing.assert_array_equal(
        bp.predict_decode_grid(cfg, (1, 2), (16,), device="h100_sxm"),
        h.predict_decode_grid(cfg, (1, 2), (16,)))
    assert bp.predict_blocks(cfg, 1, 16, device="h100_sxm") == \
        h.predict_blocks(cfg, 1, 16)
    cache = tbp.PredictionCache()
    a = bp.predict_model_cached(cfg, 1, 16, cache=cache)
    b = bp.predict_model_cached(cfg, 1, 16, cache=cache, device="h100_sxm")
    assert len(cache) == 2 and a != b                  # kept apart by device


@pytest.mark.parametrize("target", ["h100_sxm", "l4", "tpu_v5e"])
def test_fleet_grid_equals_jax_engine(store_path, target):
    teng = tbp.BatchPredictor(ttab.TableStore.load(store_path), DEV)
    jeng = jbp.BatchPredictor(jtab.TableStore.load(store_path), DEV)
    t = teng.predict_model_grid(tcr.reduced("qwen2-0.5b"), (1, 4), (16, 64),
                                "bfloat16", device=target)
    jeng._feat_cache.update(teng._feat_cache)
    j = jeng.predict_model_grid(jcr.reduced("qwen2-0.5b"), (1, 4), (16, 64),
                                "bfloat16", device=target)
    np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# NAS precompute
# ---------------------------------------------------------------------------

SMALL_GRID = dict(features=(128, 192, 512, 1000, 4096),
                  batches=(1, 2, 3, 8, 33), seq_lens=(64, 100, 2048))


@pytest.mark.parametrize("limit", [10 ** 6, 200, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_precompute_cache_equals_reference(stores, limit, dtype):
    tstore, jstore = stores
    tc, _, tus, tn = tnas.precompute_cache(
        tstore, DEV, grid=tnas.NASGrid(**SMALL_GRID), dtype=dtype,
        limit=limit, chunk=37)
    jc, _, jus, jn = jnas.precompute_cache(
        jstore, DEV, grid=jnas.NASGrid(**SMALL_GRID), dtype=dtype,
        limit=limit, chunk=37)
    assert tn == jn == tc.size and tus > 0
    np.testing.assert_array_equal(tc, jc)


def test_nas_grid_size_and_precompute_through_a_given_engine(stores):
    tstore, _ = stores
    assert tnas.NASGrid().n_configs == jnas.NASGrid().n_configs == 32 * 32 * 256 * 8
    bp = tbp.BatchPredictor(tstore, DEV)
    grid = tnas.NASGrid(**SMALL_GRID)
    c, _, _, n = tnas.precompute_cache(tstore, DEV, grid=grid, predictor=bp)
    # entry 0: M = 1 * 64, out = in = 128
    assert n == 5 * 5 * 15
    assert c[0] == float(bp.predict_matmul_batch(64, 128, 128))
