"""The port's whole slice on the CPU at a tiny budget: calibrate (each
kernel family at tiny grids) into a temporary directory, predict
qwen3-mini, measure its forward pass, and hold the predictor's rows against
the JAX package's ``PM2Lat`` on the same store and the same features
(bit-identical).  The H100 run of the same path is ``chip_smoke.py``."""
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core import memory_model as jmm  # noqa: E402
from repro.core import opgraph as jog  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro.core.predictor import PM2Lat as JPM2Lat  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import memory_model as mm  # noqa: E402
from repro_torch.core import opgraph as tog  # noqa: E402
from repro_torch.core import profiler  # noqa: E402
from repro_torch.core.predictor import PM2Lat  # noqa: E402
from repro_torch.core.table import TableStore  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.models import registry as tmr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ = 1, 64


def _tiny_store(path: str) -> TableStore:
    """The calibration pass of ``calibrate_device`` on the CPU, family by
    family at tiny grids, anchors and utility shapes."""
    store = TableStore()
    cal.calibrate_matmul(store, device="cpu", grids=((64, 64), (128, 256)),
                         k_anchors=(32, 64, 128))
    cal.calibrate_bmm(store, device="cpu", grids=((2, 32, 32),),
                      k_anchors=(32, 64))
    cal.calibrate_attention(store, device="cpu", s_anchors=(64, 128))
    store.memory_model = mm.fit_memory_model(mm.collect_utility_samples(
        mm.utility_workloads(256, device="cpu"), device="cpu")).to_json()
    store.meta = {"device": cal.device_name("cpu"), "seconds": 0.0}
    store.save(path)
    return store


def _tree_state(root: Path):
    return {str(p): p.stat().st_mtime_ns for p in root.rglob("*")
            if p.is_file()} if root.exists() else {}


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    watched = [ROOT / "artifacts", ROOT / "build"]
    before = [_tree_state(p) for p in watched]
    path = str(tmp / "store.json")
    store = _tiny_store(path)
    cfg = dataclasses.replace(tcr.get_any("qwen3-mini"),
                              compute_dtype="float32")
    pm = PM2Lat(TableStore.load(path), cal.device_name("cpu"))
    total, rows = pm.predict_model(cfg, BATCH, SEQ, dtype="float32")
    model = tmr.build(cfg, device="cpu", seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(0))
    fk.flash_attention_kernel.launches = 0
    with torch.no_grad():
        logits = model(tokens)
        measured = profiler.measure(model, tokens, min_reps=2,
                                    min_total_s=0.01, device="cpu")
    after = [_tree_state(p) for p in watched]
    return dict(tmp=tmp, path=path, store=store, cfg=cfg, total=total,
                rows=rows, logits=logits, measured=measured,
                written=(before, after))


def test_store_holds_the_framework_tables(slice_run):
    store = TableStore.load(slice_run["path"])
    kernels = {t.key.kernel for t in store.tables.values()}
    assert kernels == {"cublas@64x64", "cublas@128x256", "cublas@2x32x32",
                       "fa_model"}
    assert {t.key.device for t in store.tables.values()} == {"torch_cpu_host"}
    assert store.memory_model["coef"] and store.meta["device"] == \
        "torch_cpu_host"
    # the hand-kernel tables are profiled on the card only
    assert not any(k.startswith(("mm_", "fa_")) and k != "fa_model"
                   for k in kernels)


def test_prediction_and_measurement(slice_run):
    total, rows = slice_run["total"], slice_run["rows"]
    assert np.isfinite(total) and total > 0
    assert all(r.seconds >= 0 and np.isfinite(r.seconds) for r in rows)
    assert {r.kernel for r in rows if r.kind == "attention"} == {"fa_model"}
    assert slice_run["measured"] > 0
    lg = slice_run["logits"]
    assert lg.shape == (BATCH, SEQ, 2048) and torch.isfinite(lg).all()
    assert fk.flash_attention_kernel.launches == 0


def test_rows_bit_identical_to_jax_predictor(slice_run):
    """Same store JSON, same op list, same memory features: every row of
    the port's predictor equals the JAX package's."""
    dev = cal.device_name("cpu")
    jp = JPM2Lat(jtab.TableStore.load(slice_run["path"]), dev)
    cfg = slice_run["cfg"]
    tops = tog.enumerate_ops(cfg, BATCH, SEQ, dtype="float32")
    jops = jog.enumerate_ops(cfg, BATCH, SEQ, dtype="float32")
    for row, t, j in zip(slice_run["rows"], tops, jops):
        assert row.name == t.name == j.name
        if t.kind == "memory":
            want = jp.memory_model.predict(
                t.features(), jmm.class_of(j.snippet)) * j.count
            assert row.seconds == want and row.kernel == "linreg"
        elif t.kind == "attention":
            # the JAX provider rule files ``fa_model`` as a Pallas id, so its
            # framework pool cannot see it: look the table up by name
            assert row.seconds == jp.predict_attention(j, "fa_model")
        else:
            jr = jp.predict_op(j)
            assert (row.seconds, row.kernel) == (jr.seconds, jr.kernel)


def test_nothing_written_outside_tmp(slice_run):
    before, after = slice_run["written"]
    assert before == after
    assert sorted(os.listdir(slice_run["tmp"])) == ["store.json"]


def test_load_or_calibrate_reads_the_store(slice_run):
    st = cal.load_or_calibrate(slice_run["path"], device="cpu")
    assert sorted(st.tables) == sorted(slice_run["store"].tables)


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        cal.calibrate_device(str(tmp_path / "x.json"), device="cuda",
                             verbose=False)
    with pytest.raises(RuntimeError):
        profiler.measure(lambda: None, device="cuda")
    with pytest.raises(RuntimeError):
        cal.device_name("cuda")
    assert not (tmp_path / "x.json").exists()
