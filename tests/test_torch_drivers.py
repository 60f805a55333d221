"""The port's paper drivers (``repro_torch.benchmarks``: Table VI, NAS speed,
the fleet, strategy, serving, parallel and overlap sweeps, comm
validation, and ``run``) against the JAX package's ``benchmarks/`` on one
shared host store (``tests/test_torch_core._store_json``'s, with the two
matmul tables Table VI needs besides).

Each reference driver runs as it is, reading the store through a patched
``benchmarks.common.get_calibration``, writing no ``BENCH_*`` file (its
``write_bench`` is patched), and pricing memory ops from the port's
feature rows (every JAX ``BatchPredictor`` made during a test is seeded
with the rows of the port's, which ran first): the prediction rows must be
equal bit for bit.  Table VI times kernels, so it is compared on its
sampled shapes and the oracle's picks; its errors mean nothing on a host
that is not the card.  The port's drivers write only under the
``REPRO_ARTIFACTS`` of the test.
"""
import io
import json
import contextlib
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import benchmarks.common as jcommon  # noqa: E402
from benchmarks import comm_validation as jcomm  # noqa: E402
from benchmarks import fleet_compare as jfleet  # noqa: E402
from benchmarks import nas_speed as jnas  # noqa: E402
from benchmarks import overlap_scaling as joverlap  # noqa: E402
from benchmarks import parallel_scaling as jparallel  # noqa: E402
from benchmarks import serving_sweep as jserving  # noqa: E402
from benchmarks import strategy_sweep as jstrategy  # noqa: E402
from benchmarks import table6_custom_kernels as jtable6  # noqa: E402
from repro.core import batch_predict as jbp  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import comm_calibrate as jcc  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro.core.nas import precompute_cache as jprecompute  # noqa: E402
from repro_torch.benchmarks import comm_validation  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.benchmarks import fleet_compare  # noqa: E402
from repro_torch.benchmarks import nas_speed  # noqa: E402
from repro_torch.benchmarks import overlap_scaling  # noqa: E402
from repro_torch.benchmarks import parallel_scaling  # noqa: E402
from repro_torch.benchmarks import run as run_mod  # noqa: E402
from repro_torch.benchmarks import serving_sweep  # noqa: E402
from repro_torch.benchmarks import strategy_sweep  # noqa: E402
from repro_torch.benchmarks import table6_custom_kernels as table6  # noqa: E402
from repro_torch.core import batch_predict as tbp  # noqa: E402
from repro_torch.core import calibrate  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core.nas import NASGrid  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import matmul as mk  # noqa: E402
from tests.test_torch_baselines import _synthetic  # noqa: E402
from tests.test_torch_core import DEV, _store_json  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HOST = "torch_cpu_host"
ARCH = "qwen2-0.5b-reduced"
T6_SAMPLES = 2
NAS_LIMIT = 2000
# Table VI's configs beside the shared store's: the reference's second
# matmul config and the port's fourth, at grids no sampled shape is near
EXTRA_MM = {"mm_256x256x256": (8192, 8192), "mm_128x32x128": (16384, 64)}


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    """The shared store with ``EXTRA_MM``, and ``fa_64x64`` profiled at a
    head dim no call uses, so that the oracle picks only configs the
    reference's Table VI runs (``mm_128x128x128``, ``fa_128x128``)."""
    path = tmp_path_factory.mktemp("drivers") / "shared.json"
    _store_json(path)
    st = jtab.TableStore.load(str(path))
    rng = np.random.default_rng(5)
    for dtype in ("float32", "bfloat16"):
        for kern, grid in EXTRA_MM.items():
            st.add(jtab.ThroughputTable(
                key=jtab.KernelKey("matmul", kern, dtype, DEV),
                anchors={k: float(rng.uniform(1e11, 5e13))
                         for k in (32, 64, 128, 256, 512, 1024, 2048)},
                org_dur=float(rng.uniform(1e-5, 1e-3)), k_max=2048,
                ref_grid=grid, ref_tiles=2))
    for t in st.tables.values():
        if t.key.kernel == "fa_64x64":
            t.ref_head_dim = 4096
    st.save(str(path))
    return str(path)


@pytest.fixture
def port_store(store_path):
    return ttab.TableStore.load(store_path)


@pytest.fixture
def reference(store_path, monkeypatch):
    """The JAX package's drivers on the shared store, writing nothing,
    every ``BatchPredictor`` they make seeded with the feature rows of the
    port's (``port_rows``, filled by the port's drivers, which run
    first)."""
    monkeypatch.setattr(jcal, "device_name", lambda *a, **k: DEV)
    monkeypatch.setattr(jcommon, "get_calibration",
                        lambda: jtab.TableStore.load(store_path))
    monkeypatch.setattr(jcommon, "write_bench", lambda *a, **k: None)
    port = []
    t_init, j_init = tbp.BatchPredictor.__init__, jbp.BatchPredictor.__init__

    def port_init(self, *a, **k):
        t_init(self, *a, **k)
        port.append(self)

    def ref_init(self, *a, **k):
        j_init(self, *a, **k)
        for p in port:
            self._feat_cache.update({key: v.copy()
                                     for key, v in p._feat_cache.items()})
    monkeypatch.setattr(tbp.BatchPredictor, "__init__", port_init)
    monkeypatch.setattr(jbp.BatchPredictor, "__init__", ref_init)
    return port


def _quiet(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue()


def test_table6_shapes_and_picks(reference, port_store):
    _, text = _quiet(jtable6.run, samples=T6_SAMPLES)
    want_mm = [((int(m), int(n), int(k)), pick) for m, n, k, pick in
               re.findall(r"mm (\d+)x(\d+)x(\d+): oracle=(\S+)", text)]
    want_fa = [((int(bh), int(s)), pick) for bh, s, pick in
               re.findall(r"fa bh=(\d+) S=(\d+): oracle=(\S+)", text)]
    want_bmm = [(tuple(int(x) for x in g[:4]), g[4]) for g in re.findall(
        r"bmm (\d+)x(\d+)x(\d+)x(\d+): oracle=(\S+) ", text)]
    out, _ = _quiet(table6.run, port_store, samples=T6_SAMPLES,
                    dtypes=("float32",), device="cpu")
    assert len(want_mm) == len(want_fa) == len(want_bmm) == T6_SAMPLES
    for dname in ("float32",):
        mm = [r for r in out["mm"] if r["dtype"] == dname]
        fa = [r for r in out["fa"] if r["dtype"] == dname]
        bmm = [r for r in out["bmm"] if r["dtype"] == dname]
        assert [(tuple(r["shape"]), r["pick"]) for r in mm] == want_mm
        assert [((r["bh"], r["s"]), r["pick"]) for r in fa] == want_fa
        # (batch, m, n, k) in the reference's print order
        assert [(tuple(r["shape"]), r["pick"]) for r in bmm] == want_bmm
        for r in mm:
            assert set(r["ms"]) == set(r["rel_err"]) == \
                {c.name for c in mk.CONFIGS}
            assert r["fastest"] in r["ms"] and min(r["ms"].values()) > 0
        for r in fa:
            assert set(r["ms"]) == {c.name for c in fk.CONFIGS}
    summary = out["summary"]
    assert set(summary) == {"mm/float32", "fa/float32", "bmm/float32"}
    assert all(np.isfinite(v) for s in summary.values() for v in s.values())


def test_nas_speed(reference, port_store):
    got, _ = _quiet(nas_speed.run, port_store, limit=NAS_LIMIT,
                    include_neusight=False, device="cpu")
    want, _ = _quiet(jnas.run, limit=NAS_LIMIT, include_neusight=False)
    assert got["n_sampled"] == want["n_sampled"]
    assert got["model_grid_models"] == want["model_grid_models"]
    cache, *_ = jprecompute(jcommon.get_calibration(), DEV, grid=NASGrid(),
                            limit=NAS_LIMIT)
    np.testing.assert_array_equal(got["cache"], cache)
    jgrid = jbp.BatchPredictor(jcommon.get_calibration(), DEV) \
        .predict_model_grid(jnas.cr.get_any("qwen3-mini"),
                            nas_speed.MODEL_GRID_BATCHES,
                            nas_speed.MODEL_GRID_SEQS)
    np.testing.assert_array_equal(got["model_grid"], np.asarray(jgrid))


def test_fleet_compare(reference, port_store):
    kw = dict(archs=["qwen3-mini", ARCH], devices=["a100_80g", "l4"])
    got, _ = _quiet(fleet_compare.run, port_store, device="cpu", **kw)
    want, _ = _quiet(jfleet.run, **kw)
    assert got == want
    assert set(got) == set(kw["archs"])


def test_strategy_sweep(reference, port_store):
    got, text = _quiet(strategy_sweep.dry_run, port_store)
    assert "dry-run golden check ok" in text
    want, _ = _quiet(
        jstrategy.run, arch=ARCH, batch=4, seq=64, dp=(1, 2), tp=(1,),
        pp=(1, 2), microbatches=(1, 2), buckets=(1.0, 25.0),
        schedules=("gpipe", "1f1b", "interleaved"), loop_limit=0)
    for key in ("arch", "device", "n_specs", "n_feasible", "hbm_bytes",
                "best", "schedule_vs_gpipe", "max_rel_err"):
        assert got[key] == want[key], key
    assert got["forward"]["max_rel_err"] == want["forward"]["max_rel_err"]
    assert len(got["seconds"]) == got["n_specs"]


def test_serving_sweep(reference, port_store):
    got, text = _quiet(serving_sweep.dry_run, port_store)
    assert "dry-run golden check ok" in text
    (want, _, _), _ = _quiet(
        jserving.run, arch=ARCH, capacities=(1, 2, 4), tps=(1, 2),
        prompts=(16, 32), outputs=(4, 8), requests=16, mix_variants=2)
    strip = lambda pts: [{k: v for k, v in p.items() if k != "cached"}
                         for p in pts]
    assert strip(got["points"]) == strip(want["points"])
    assert got["max_rel_err"] == want["max_rel_err"]
    assert got["mix"] == want["mix"] and got["n_points"] == want["n_points"]


def test_parallel_scaling(reference, port_store):
    got, _ = _quiet(parallel_scaling.dry_run, port_store)
    want, _ = _quiet(jparallel.run, batch=2, seq=64, worlds=(1, 2),
                     strategies=["tp", "pp"], devices=["a100_80g"],
                     archs=[ARCH])
    assert got == want and len(got) == 4


def test_overlap_scaling(reference, port_store):
    got, _ = _quiet(overlap_scaling.dry_run, port_store)
    want, _ = _quiet(joverlap.run, batch=4, seq=64, worlds=(2,),
                     microbatches=(1, 2), buckets=(1.0, 25.0),
                     devices=["a100_80g"], archs=[ARCH])
    assert got == want
    assert len(got[0]) == 2 and len(got[1]) == 2


def test_comm_validation(reference, tmp_path):
    out = tmp_path / "comm_dry.json"
    got, text = _quiet(comm_validation.run, dry=True, path=str(out))
    want, _ = _quiet(jcomm.run, dry=True)
    assert got == want
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    assert "perturbed replays correctly failed" in text
    assert len(got["perturbed"]) == len(comm_validation.TRACE_TRUTHS)


def test_regen_traces_bit_identical(tmp_path):
    """The port's pinned truths rebuild the bundled traces byte for byte,
    into the directory given (never the bundled one)."""
    _, _ = _quiet(comm_validation.regen_traces, str(tmp_path))
    bundled = Path(jcc.default_traces_dir())
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == sorted(p.name for p in bundled.glob("*.json"))
    for name in names:
        assert (tmp_path / name).read_bytes() == (bundled / name).read_bytes()


@pytest.fixture
def host_artifacts(store_path, tmp_path, monkeypatch):
    """The shared store as the host's at ``$REPRO_ARTIFACTS/torch/``, and
    a NeuSight model (trained on synthetic samples) at its cached path."""
    root = tmp_path / "artifacts"
    path = root / "torch" / f"calibration_{HOST}.json"
    path.parent.mkdir(parents=True)
    path.write_text(open(store_path).read().replace(DEV, HOST))
    shutil.copytree(ROOT / "artifacts" / "traces", root / "traces")
    monkeypatch.setenv("REPRO_ARTIFACTS", str(root))
    assert calibrate.default_store_path("cpu") == str(path)
    samples, mem, peak = _synthetic()
    from repro_torch.core.baselines import neusight as tns
    model = tns.train(samples, mem, peak_flops=peak, steps=20, device="cpu")
    torch.save(model.state(), common.neusight_path("float32", "cpu"))
    return root


def test_run_every_sweep_on_the_host(host_artifacts):
    """``run --fast`` on the host: the drivers that need no model forward,
    each at its dry-run size with its self-checks; every record lands
    under ``$REPRO_ARTIFACTS/torch``."""
    before = {p: p.stat().st_mtime for p in ROOT.glob("BENCH_*.json")}
    only = ["nas", "fleet", "strategy", "serving", "parallel", "overlap",
            "comm"]
    out, text = _quiet(run_mod.run, only, fast=True, device="cpu")
    assert set(out) == set(only)
    assert "benchmarks/total_wall_s" in text
    assert out["nas"]["n_sampled"] > 0 and out["nas"]["neusight_us"] > 0
    assert set(out["fleet"]) == {"qwen3-mini"}
    written = {p.name for p in (host_artifacts / "torch").iterdir()}
    assert "BENCH_comm_validation_dry.json" in written
    assert {p: p.stat().st_mtime for p in ROOT.glob("BENCH_*.json")} \
        == before
    with pytest.raises(SystemExit):
        run_mod.run(["table7"], device="cpu")
    assert set(run_mod.DRIVERS) == set(only) | {
        "fig3", "table2", "table4", "table6", "partition", "roofline"}
    assert Path(common.write_bench("x", {"a": 1})).parent \
        == host_artifacts / "torch"
