"""The port's baselines (``core/baselines/``) against the JAX package's.

Roofline and Habitat are numpy arithmetic on both sides: ``==`` on
``tests/test_torch_core._store_json``'s shared store.  MemoryOp features
differ by design (the port counts aten ops, ``tests/test_torch_opgraph.py``),
so memory rows are held on the same feature dicts: a stub op carrying the
JAX op's features goes to both packages.

NeuSight's MLPs are float32 on both sides (JAX with x64 off, torch), and
XLA's and torch's CPU GEMMs sum in different orders.  So a JAX model's
weights carried across (``from_jax``) predict within a relative 1e-5, and
Adam from one numpy init stays within an absolute 1e-4 of the reference's
weights after 50 steps (the steps are ~lr = 1e-2 each).  The memory MLP's
first layer is not compared after training: its inputs are raw log2 byte
counts (10-23), its tanh units saturate, and there 1 - tanh^2 is rounding
(the two packages' gradients differ by tens of percent), which Adam
normalises into whole steps; its predictions still agree (1e-4).
"""
import dataclasses
import io

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jcr  # noqa: E402
from repro.core import opgraph as jog  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro.core.baselines import habitat as jhab  # noqa: E402
from repro.core.baselines import neusight as jns  # noqa: E402
from repro.core.baselines import roofline as jroof  # noqa: E402
from repro.core.predictor import PM2Lat as JPM2Lat  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import opgraph as tog  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core.baselines import habitat as thab  # noqa: E402
from repro_torch.core.baselines import neusight as tns  # noqa: E402
from repro_torch.core.baselines import roofline as troof  # noqa: E402
from repro_torch.core.predictor import PM2Lat as TPM2Lat  # noqa: E402
from tests.test_torch_core import DEV, _store_json  # noqa: E402

DTYPES = ("float32", "bfloat16")
CONFIGS = ("qwen2-0.5b", "moonshot-v1-16b-a3b", "recurrentgemma-2b")
FROM_JAX_RTOL = 1e-5     # float32 MLP, XLA's and torch's sums
ADAM_ATOL = 1e-4         # weights after 50 Adam steps of lr 1e-2
TRAIN_PRED_RTOL = 1e-3   # predict_matmul after 50 steps: util's rel error
MEM_PRED_RTOL = 1e-4


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    path = _store_json(tmp_path_factory.mktemp("store") / "store.json")
    return jtab.TableStore.load(path), ttab.TableStore.load(path)


@dataclasses.dataclass
class SharedMemory:
    """A memory op both packages price from the same features."""
    name: str
    snippet: str
    count: int
    feats: dict
    kind: str = "memory"

    def features(self):
        return self.feats


def _op_pairs(name, batch, seq, dtype, decode=False):
    """(JAX op, port op) pairs of one op list; a memory op is one
    ``SharedMemory`` on both sides."""
    jcfg, tcfg = jcr.reduced(name), tcr.reduced(name)
    if decode:
        jops = jog.enumerate_decode_ops(jcfg, batch, seq, dtype=dtype)
        tops = tog.enumerate_decode_ops(tcfg, batch, seq, dtype=dtype)
    else:
        jops = jog.enumerate_ops(jcfg, batch, seq, dtype=dtype)
        tops = tog.enumerate_ops(tcfg, batch, seq, dtype=dtype)
    assert len(jops) == len(tops)
    out = []
    for j, t in zip(jops, tops):
        if j.kind == "memory":
            s = SharedMemory(j.name, j.snippet, j.count, j.features())
            out.append((s, s))
        else:
            out.append((j, t))
    return out


OP_LISTS = [(n, b, s, dt, dec) for n in CONFIGS for dt in DTYPES
            for b, s, dec in ((1, 128, False), (4, 512, False),
                              (8, 1024, True))]


@pytest.mark.parametrize("dtype", DTYPES)
def test_roofline_from_store_equals_jax(stores, dtype):
    js, ts = stores
    j = jroof.RooflineBaseline.from_store(js, DEV, dtype)
    t = troof.RooflineBaseline.from_store(ts, DEV, dtype)
    assert t.peak_flops == j.peak_flops > 0
    assert t.mem_bw == j.mem_bw > 0
    assert troof.best_matmul_throughput(ts, dtype) == j.peak_flops


@pytest.mark.parametrize("name,batch,seq,dtype,decode", OP_LISTS)
def test_roofline_rows_equal_jax(stores, name, batch, seq, dtype, decode):
    js, ts = stores
    j = jroof.RooflineBaseline.from_store(js, DEV, dtype)
    t = troof.RooflineBaseline.from_store(ts, DEV, dtype)
    pairs = _op_pairs(name, batch, seq, dtype, decode)
    jt, jrows = j.predict_ops([a for a, _ in pairs])
    tt, trows = t.predict_ops([b for _, b in pairs])
    assert [dataclasses.astuple(r) for r in trows] == \
        [(r.name, r.kind, r.seconds, r.kernel) for r in jrows]
    assert tt == jt > 0


@pytest.mark.parametrize("ratios", [(1.0, 1.0), (0.5, 2.0), (1.7, 0.3)])
@pytest.mark.parametrize("name,batch,seq,dtype,decode", OP_LISTS[::2])
def test_habitat_equals_jax(stores, ratios, name, batch, seq, dtype, decode):
    js, ts = stores
    pairs = _op_pairs(name, batch, seq, dtype, decode)
    jt, jrows = jhab.HabitatScaler(JPM2Lat(js, DEV), *ratios).predict_ops(
        [a for a, _ in pairs])
    tt, trows = thab.HabitatScaler(TPM2Lat(ts, DEV), *ratios).predict_ops(
        [b for _, b in pairs])
    assert [dataclasses.astuple(r) for r in trows] == \
        [(r.name, r.kind, r.seconds, r.kernel) for r in jrows]
    assert tt == jt > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_habitat_at_unit_ratios_is_pm2lat(stores, name):
    """The identity ``chip_smoke.py`` holds on the card: every row's seconds
    are PM2Lat's, the total their left-to-right sum."""
    _, ts = stores
    pm = TPM2Lat(ts, DEV)
    ops = tog.enumerate_ops(tcr.reduced(name), 2, 256)
    total, rows = thab.HabitatScaler(pm, 1.0, 1.0).predict_ops(ops)
    want = [pm.predict_op(op) for op in ops]
    assert [(r.name, r.kind, r.seconds) for r in rows] == \
        [(r.name, r.kind, r.seconds) for r in want]
    acc = 0.0
    for r in want:
        acc += r.seconds
    assert total == acc


def test_matmul_features_equal_jax():
    rng = np.random.default_rng(3)
    m, n, k = (rng.integers(1, 9000, 64) for _ in range(3))
    b = rng.integers(1, 64, 64)
    assert np.array_equal(tns.matmul_features(m, n, k, b),
                          jns.matmul_features(m, n, k, b))
    for args in ((512, 512, 512), (3, 77, 4096, 8), (1, 1, 1)):
        assert np.array_equal(tns.matmul_features(*args),
                              jns.matmul_features(*args))
    assert tns.TILE == jns.TILE


def _synthetic(seed=0, n=40, peak=5e10):
    """The reference's in-distribution set (tests/test_predictor.py)."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(n):
        m, n_, k = (int(2 ** rng.uniform(5, 10)) for _ in range(3))
        util = 0.3 + 0.5 * (min(m, n_, k) / 1024)
        samples.append({"m": m, "n": n_, "k": k, "batch": 1,
                        "duration": 2 * m * n_ * k / (peak * util)})
    mem = [{"features": {"bytes": 10 ** rng.uniform(3, 7), "flops": 0,
                         "transcendentals": 0},
            "duration": 10 ** rng.uniform(-5, -3)} for _ in range(20)]
    return samples, mem, peak


@pytest.fixture(scope="module")
def jax_model():
    samples, mem, peak = _synthetic()
    return jns.train(samples, mem, peak_flops=peak, steps=50)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_from_jax_predict_matmul_and_memory(jax_model):
    t = tns.from_jax(jax_model, device="cpu")
    assert t.peak_flops == jax_model.peak_flops
    assert t.mem_scale == jax_model.mem_scale
    assert np.array_equal(t.feat_mean, jax_model.feat_mean)
    assert np.array_equal(t.feat_std, jax_model.feat_std)
    rng = np.random.default_rng(4)
    for _ in range(40):
        m, n, k = (int(x) for x in rng.integers(1, 8192, 3))
        b = int(rng.integers(1, 96))
        assert _rel(t.predict_matmul(m, n, k, b),
                    jax_model.predict_matmul(m, n, k, b)) <= FROM_JAX_RTOL
        feats = {"bytes": float(10 ** rng.uniform(2, 10))}
        assert _rel(t.predict_memory(feats),
                    jax_model.predict_memory(feats)) <= FROM_JAX_RTOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,seq,decode", [(1, 128, False),
                                              (8, 512, False),
                                              (4, 1024, True)])
def test_from_jax_predict_op_over_qwen2(jax_model, dtype, batch, seq, decode):
    t = tns.from_jax(jax_model, device="cpu")
    pairs = _op_pairs("qwen2-0.5b", batch, seq, dtype, decode)
    for j, p in pairs:
        jr, tr = jax_model.predict_op(j), t.predict_op(p)
        assert (tr.name, tr.kind, tr.kernel) == (jr.name, jr.kind, jr.kernel)
        assert _rel(tr.seconds, jr.seconds) <= FROM_JAX_RTOL, jr.name
    jt, _ = jax_model.predict_ops([a for a, _ in pairs])
    tt, _ = t.predict_ops([b for _, b in pairs])
    assert _rel(tt, jt) <= FROM_JAX_RTOL


def _np_init(seed, sizes):
    rng = np.random.default_rng(100 + seed)
    return [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
             "b": np.zeros(b, np.float32)} for a, b in zip(sizes, sizes[1:])]


@pytest.mark.parametrize("loss,steps", [("smape", 50), ("relative", 1),
                                        ("relative", 10)])
def test_adam_equals_jax(loss, steps):
    """The port's ``_adam`` against the reference's from one numpy init on
    the matmul MLP's loss (normalised features): 50 steps of SMAPE, the
    loss ``train`` uses.  The relative loss |pred - y| / y is held for 1
    and 10 steps only: near the fit its kink at pred = y makes each
    sample's gradient sign a matter of rounding, so the two packages part
    after ~20 steps (1.2e-5 apart at 20, 8.7e-3 at 50) though each step
    is the same update."""
    samples, _, peak = _synthetic(seed=5)
    f = jns.matmul_features(*(np.array([s[k] for s in samples])
                              for k in ("m", "n", "k", "batch")))
    X = (f - f.mean(0)) / (f.std(0) + 1e-9)
    y = np.array([s["duration"] for s in samples])
    fl = np.array([2.0 * s["m"] * s["n"] * s["k"] for s in samples])
    init = _np_init(0, (6, 64, 64, 1))

    Xj, yj, flj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(fl)

    def jloss(params):
        import jax
        util = jax.nn.sigmoid(jns._mlp(params, Xj))[:, 0]
        pred = flj / (peak * jnp.maximum(util, 1e-4))
        if loss == "smape":
            return jnp.mean(jnp.abs(pred - yj) / (jnp.abs(pred) + jnp.abs(yj)))
        return jnp.mean(jnp.abs(pred - yj) / yj)

    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    Xt, yt, flt = f32(X), f32(y), f32(fl)

    def tloss(mlp):
        util = torch.sigmoid(mlp(Xt))[:, 0]
        pred = flt / (peak * torch.clamp(util, min=1e-4))
        if loss == "smape":
            return torch.mean(torch.abs(pred - yt)
                              / (torch.abs(pred) + torch.abs(yt)))
        return torch.mean(torch.abs(pred - yt) / yt)

    jp = jns._adam(jloss, [{k: jnp.asarray(v) for k, v in p.items()}
                           for p in init], steps, 1e-2)
    mlp = tns._adam(tloss, tns.MLP.from_numpy(init), steps, 1e-2)
    moved = 0.0
    for a, b, p0 in zip(jp, mlp.to_numpy(), init):
        for key in ("w", "b"):
            np.testing.assert_allclose(b[key], np.asarray(a[key]), rtol=0,
                                       atol=ADAM_ATOL)
            moved = max(moved, float(np.abs(b[key] - p0[key]).max()))
    assert moved >= 0.9e-2 * min(steps, 10)     # each step moved them ~lr
    with torch.no_grad():
        assert abs(float(tloss(mlp)) - float(jloss(jp))) <= 1e-4


def test_train_equals_jax_from_same_init(monkeypatch):
    """``train`` on both sides from one numpy init (each ``_init_mlp``
    patched), 50 steps."""
    samples, mem, peak = _synthetic(seed=6)
    monkeypatch.setattr(jns, "_init_mlp", lambda key, sizes: [
        {k: jnp.asarray(v) for k, v in p.items()}
        for p in _np_init(len(sizes), sizes)])
    monkeypatch.setattr(tns, "_init_mlp", lambda seed, sizes, dev:
                        tns.MLP.from_numpy(_np_init(len(sizes), sizes), dev))
    j = jns.train(samples, mem, peak_flops=peak, steps=50)
    t = tns.train(samples, mem, peak_flops=peak, steps=50, device="cpu")
    assert t.peak_flops == j.peak_flops and t.mem_scale == j.mem_scale
    assert np.array_equal(t.feat_mean, j.feat_mean)
    assert np.array_equal(t.feat_std, j.feat_std)
    for a, b in zip(j.mlp_params, t.mlp.to_numpy()):
        for key in ("w", "b"):
            np.testing.assert_allclose(b[key], np.asarray(a[key]), rtol=0,
                                       atol=ADAM_ATOL)
    for s in samples:
        shape = (s["m"], s["n"], s["k"])
        assert _rel(t.predict_matmul(*shape),
                    j.predict_matmul(*shape)) <= TRAIN_PRED_RTOL
    for s in mem:
        assert _rel(t.predict_memory(s["features"]),
                    j.predict_memory(s["features"])) <= MEM_PRED_RTOL


def test_neusight_trains_in_distribution():
    """The reference's in-distribution test (tests/test_predictor.py), on
    the port."""
    samples, mem, peak = _synthetic()
    model = tns.train(samples, mem, peak_flops=peak, steps=300, device="cpu")
    errs = [abs(model.predict_matmul(s["m"], s["n"], s["k"]) - s["duration"])
            / s["duration"] for s in samples]
    assert float(np.mean(errs)) < 0.5


def test_init_is_seeded_and_scaled():
    a = tns._init_mlp(0, (6, 64, 64, 1), "cpu").to_numpy()
    b = tns._init_mlp(0, (6, 64, 64, 1), "cpu").to_numpy()
    c = tns._init_mlp(1, (6, 64, 64, 1), "cpu").to_numpy()
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x["w"], y["w"]) and not np.array_equal(x["w"],
                                                                     z["w"])
        assert not x["b"].any()
        assert x["w"].dtype == np.float32
    # normal / sqrt(fan-in): the 64 x 64 layer's weights have std 1/8
    assert abs(float(a[1]["w"].std()) - 1 / 8) < 0.01


def test_state_round_trip_is_exact(jax_model):
    t = tns.from_jax(jax_model, device="cpu")
    buf = io.BytesIO()
    torch.save(t.state(), buf)
    buf.seek(0)
    back = tns.NeuSightModel.from_state(torch.load(buf, weights_only=True),
                                        device="cpu")
    for shape in ((512, 512, 512), (64, 4096, 77, 8)):
        assert back.predict_matmul(*shape) == t.predict_matmul(*shape)
    assert back.predict_memory({"bytes": 1e6}) == \
        t.predict_memory({"bytes": 1e6})


def test_collect_matmul_dataset_draws_the_reference_shapes():
    """The port draws the reference's (M, N, K) from the same seed and
    times ``torch.matmul`` in the dtype asked for (small sizes on the
    CPU)."""
    rng = np.random.default_rng(7)
    want = []
    for _ in range(3):
        want.append((int(2 ** rng.uniform(5, np.log2(64))),
                     int(2 ** rng.uniform(5, np.log2(64))),
                     int(2 ** rng.uniform(5, np.log2(128)))))
    for dtype in DTYPES:
        got = tns.collect_matmul_dataset(3, dtype=dtype, seed=7, max_mn=64,
                                         max_k=128, device="cpu")
        assert [(s["m"], s["n"], s["k"]) for s in got] == want
        assert all(s["batch"] == 1 and s["duration"] > 0 for s in got)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    samples, mem, peak = _synthetic()
    with pytest.raises(RuntimeError, match="CUDA"):
        tns.collect_matmul_dataset(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tns.train(samples, mem, peak_flops=peak, steps=1)
