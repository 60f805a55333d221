"""The port's paper-table scripts (``repro_torch.benchmarks``), its shape
cells (``configs/shapes.py``) and its planner CLI (``launch/plan.py``) on
the CPU, against the JAX package where the arithmetic is shared.

The planner reaches its store as a user's run would, through
``REPRO_ARTIFACTS`` (``tests/test_torch_core._store_json``'s shared store,
renamed to the host's store name).  Fig. 3 is numpy on both sides: within
1e-12 relative of the JAX script on one table's anchors (filed as
``xla_default@512x512`` for it, ``cublas@512x512`` for the port).  Tables
II and IV and the partition application are smoke-run at small sizes
(``gpt2-mini`` and ``qwen3-mini`` at B 1 x S 16): finite, positive, one row
per case; their errors mean nothing on a host that is not the card.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig3_throughput_vs_k as jfig3  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.benchmarks import fig3_throughput_vs_k as fig3  # noqa: E402
from repro_torch.benchmarks import partition_app  # noqa: E402
from repro_torch.benchmarks import table2_per_layer as table2  # noqa: E402
from repro_torch.benchmarks import table4_model_wise as table4  # noqa: E402
from repro_torch.configs import base as C  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.core import calibrate  # noqa: E402
from repro_torch.core import opgraph as og  # noqa: E402
from repro_torch.core import partition as P  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core.baselines import neusight as tns  # noqa: E402
from repro_torch.core.predictor import PM2Lat  # noqa: E402
from repro_torch.launch import plan  # noqa: E402
from tests.test_torch_baselines import _synthetic  # noqa: E402
from tests.test_torch_core import DEV, _store_json  # noqa: E402

HOST = "torch_cpu_host"
SMOKE_MODELS = ("gpt2-mini", "qwen3-mini")
FIG3_RTOL = 1e-12


@pytest.fixture
def host_store(tmp_path, monkeypatch):
    """The shared store as the host's, at ``$REPRO_ARTIFACTS/torch/``."""
    src = _store_json(tmp_path / "shared.json")
    path = tmp_path / "artifacts" / "torch" / f"calibration_{HOST}.json"
    path.parent.mkdir(parents=True)
    path.write_text(open(src).read().replace(DEV, HOST))
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path / "artifacts"))
    monkeypatch.setenv("PM2LAT_COMM_CALIBRATION",
                       str(tmp_path / "absent_comm_calibration.json"))
    assert calibrate.default_store_path("cpu") == str(path)
    return ttab.TableStore.load(str(path))


@pytest.fixture(scope="module")
def neusight():
    samples, mem, peak = _synthetic()
    return tns.train(samples, mem, peak_flops=peak, steps=50, device="cpu")


def test_shapes_equal_jax():
    assert [dataclasses.asdict(s) for s in shapes.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jshapes.ALL_SHAPES]
    assert sorted(shapes.SHAPES) == sorted(jshapes.SHAPES)
    assert shapes.SUBQUADRATIC_ARCHS == jshapes.SUBQUADRATIC_ARCHS
    names = tcr.ARCH_NAMES
    got = [(a, dataclasses.asdict(s)) for a, s in shapes.cells(names)]
    want = [(a, dataclasses.asdict(s)) for a, s in jshapes.cells(names)]
    assert got == want and len(got) == 3 * len(names) + 2
    for a in names:
        for s, js in zip(shapes.ALL_SHAPES, jshapes.ALL_SHAPES):
            assert shapes.applicable(a, s) == jshapes.applicable(a, js)


@pytest.mark.parametrize("argv", [
    [],
    ["--stages", "4"],
    ["--stages", "3", "--batch", "4", "--seq", "128"],
    ["--device-b-scale", "0.4"],
    ["--device-b-scale", "0.4", "--comm-cost", "0.0005"],
])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_plan_cli_equals_planners(host_store, arch, argv):
    args = plan.parse_args(["--arch", arch, "--reduced", "--device", "cpu"]
                           + argv)
    got = plan.run(args)
    lat = PM2Lat(host_store, HOST).predict_blocks(tcr.reduced(arch),
                                                  args.batch, args.seq)
    if args.device_b_scale == 1.0:
        want = P.plan_stages(lat, args.stages)
        ref = JP.plan_stages(lat, args.stages)
    else:
        lat_b = [t * args.device_b_scale for t in lat]
        want = P.plan_two_devices(lat, lat_b, comm_cost=args.comm_cost)
        ref = JP.plan_two_devices(lat, lat_b, comm_cost=args.comm_cost)
    assert dataclasses.astuple(got) == dataclasses.astuple(want) \
        == dataclasses.astuple(ref)
    assert len(got.boundaries) == args.stages + 1


def test_plan_cli_defaults_to_the_card():
    args = plan.parse_args(["--arch", "qwen2-0.5b", "--reduced"])
    assert args.device == "cuda" and args.stages == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            plan.run(args)


def _fig3_stores(dtype, seed):
    """One table's anchors, as the JAX package files them (float32,
    ``xla_default@512x512``, JAX's host name) and as the port does."""
    rng = np.random.default_rng(seed)
    ks = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
    thr = np.sort(rng.uniform(1e11, 6e13, len(ks)))
    anchors = {k: float(t) for k, t in zip(ks, thr)}
    fields = dict(anchors=anchors, org_dur=2.0 * 512 * 512 * 8192 / thr[-1],
                  k_max=8192, ref_grid=(512, 512), ref_tiles=16)
    js = jtab.TableStore()
    js.add(jtab.ThroughputTable(key=jtab.KernelKey(
        "matmul", "xla_default@512x512", "float32", jcal.device_name()),
        **fields))
    ts = ttab.TableStore()
    ts.add(ttab.ThroughputTable(key=ttab.KernelKey(
        "matmul", fig3.KERNEL, dtype, HOST), **fields))
    ts.meta = {"device": HOST}
    return js, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_fig3_equals_jax(monkeypatch, dtype, seed):
    js, ts = _fig3_stores(dtype, seed)
    monkeypatch.setattr(jcommon, "get_calibration", lambda: js)
    want = jfig3.run(verbose=False)
    got = fig3.run(ts, dtype)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert math.isfinite(got[k])
        assert got[k] == pytest.approx(v, rel=FIG3_RTOL, abs=0.0), k


def _positive(x):
    return math.isfinite(x) and x > 0


def test_table2_smoke(host_store, neusight):
    out = table2.run(host_store, {"float32": neusight, "bfloat16": neusight},
                     samples_per_layer=1, device="cpu")
    assert len(out["rows"]) == 2 * len(table2.LAYERS)
    for row in out["rows"]:
        assert all(_positive(row[f"{k}_ms"]) for k in
                   ("measured",) + table2.PREDICTORS), row
    for dt in table2.DTYPES:
        assert sorted(out["errors"][dt]) == sorted(table2.LAYERS)
        for errs in out["errors"][dt].values():
            assert sorted(errs) == sorted(table2.PREDICTORS)
            assert all(math.isfinite(e["mean"]) and e["max"] >= e["mean"]
                       for e in errs.values())
    # both dtypes draw the same shapes
    by = lambda dt: [r["shape"] for r in out["rows"] if r["dtype"] == dt]
    assert by("float32") == by("bfloat16")


def test_table4_smoke(host_store, neusight):
    out = table4.run(host_store, {"float32": neusight, "bfloat16": neusight},
                     models=SMOKE_MODELS, batches=(1,), seq=16, device="cpu")
    rows = out["rows"]
    pm = PM2Lat(host_store, HOST)
    assert [(r["model"], r["dtype"]) for r in rows] == \
        [(m, d) for m in SMOKE_MODELS for d in table4.DTYPES]
    for r in rows:
        assert r["logits_finite"] and r["batch"] == 1 and r["seq"] == 16
        assert all(_positive(r[f"{k}_ms"])
                   for k in ("measured",) + table4.PREDICTORS), r
        assert all(math.isfinite(r[f"{k}_pct"]) for k in table4.PREDICTORS)
        # CPU tensors take the flash kernel's plain version: no launch
        assert r["flash_launches"] == 0
        assert r["flash_calls"] == tcr.get_any(r["model"]).n_layers
        # each row prices its own dtype's ops (not enumerate_ops' float32)
        cfg = dataclasses.replace(tcr.get_any(r["model"]),
                                  compute_dtype=r["dtype"])
        ops = og.enumerate_ops(cfg, 1, 16, dtype=r["dtype"])
        assert {o.dtype for o in ops if hasattr(o, "dtype")} == {r["dtype"]}
        assert r["pm2lat_ms"] == pm.predict_ops(ops)[0] * 1e3
        assert r["neusight_ms"] == neusight.predict_ops(ops)[0] * 1e3
    for dt in table4.DTYPES:
        assert all(_positive(v) for v in out["mean_abs_err_pct"][dt].values())


def test_flash_calls_count_attention_blocks():
    assert table4.flash_calls(tcr.get("qwen2-0.5b")) == 24
    rg = tcr.get("recurrentgemma-2b")
    assert table4.flash_calls(rg) == sum(k == C.LOCAL_ATTN
                                         for k in rg.layer_kinds) == 8
    w = tcr.get("whisper-small")     # 12 decoder self + 12 cross + 12 encoder
    assert table4.flash_calls(w) == 36
    assert table4.flash_calls(tcr.get("yi-6b")) == 32


def test_partition_app_smoke(host_store, neusight):
    out = partition_app.run(host_store, neusight, batch=1, seq=16,
                            device="cpu")
    assert out["blocks"] == 12 and out["flash_launches"] == 0
    for key in ("measured_block_ms", "pm2lat_block_ms", "neusight_block_ms"):
        assert len(out[key]) == 12 and all(_positive(t) for t in out[key])
    for name in ("oracle", "pm2lat", "neusight"):
        r = out[name]
        assert 0 <= r["split"] <= 12
        assert _positive(r["true_bottleneck_ms"])
        assert _positive(r["completion_100_s"])
        assert r["true_bottleneck_ms"] >= out["oracle"]["true_bottleneck_ms"]
    assert "bottleneck_pred_err_pct" in out["pm2lat"]


def test_neusight_cache_round_trip(host_store, tmp_path, monkeypatch):
    """``get_neusight`` trains once, caches under ``artifacts/torch/`` (not
    the JAX package's ``artifacts/neusight_model.pkl``), then loads."""
    calls = []
    samples, mem, _ = _synthetic()
    monkeypatch.setattr(tns, "collect_matmul_dataset",
                        lambda **kw: calls.append(kw) or samples)
    monkeypatch.setattr(common.mm, "collect_utility_samples",
                        lambda device: mem)
    path = common.neusight_path("bfloat16", "cpu")
    assert path == str(tmp_path / "artifacts" / "torch"
                       / f"neusight_{HOST}_bfloat16.pt")
    a = common.get_neusight(host_store, dtype="bfloat16", device="cpu",
                            steps=20)
    b = common.get_neusight(host_store, dtype="bfloat16", device="cpu",
                            steps=20)
    assert len(calls) == 1 and calls[0]["dtype"] == "bfloat16"
    assert a.peak_flops == max(
        max(t.anchors.values()) for t in host_store.tables.values()
        if t.key.op == "matmul" and t.key.dtype == "bfloat16")
    assert b.predict_matmul(512, 512, 512) == a.predict_matmul(512, 512, 512)
