"""The port's batch engine (``core/batch_predict.py``): against the port's
scalar ``PM2Lat`` at 1e-9 relative (the JAX package's own contract in
``tests/test_batch_predict.py``), against the JAX package's engine bit for
bit (``==``) on one shared store with the same feature rows, and the
prediction cache.

The shared store is ``tests/test_torch_core.py``'s: every table family,
seeded anchors, a fitted memory model, device ``shared_test_dev`` (which no
comm-calibration artifact names, so both engines take the datasheet
interconnect and no cache correction).  Memory-bound rows use features the
port counts on meta tensors; the JAX engine's ``_feat_cache`` is seeded
with the port's rows before the two are compared."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import registry as jcr  # noqa: E402
from repro.core import batch_predict as jbp  # noqa: E402
from repro.core import collectives as jcol  # noqa: E402
from repro.core import opgraph as jog  # noqa: E402
from repro.core import table as jtab  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.core import collectives as tcol  # noqa: E402
from repro_torch.core import opgraph as og  # noqa: E402
from repro_torch.core import table as ttab  # noqa: E402
from repro_torch.core.batch_predict import (BatchPredictor,  # noqa: E402
                                            PredictionCache, config_key,
                                            enumerate_grid_ops)
from repro_torch.core.predictor import PM2Lat  # noqa: E402
from tests.test_torch_core import DEV, _store_json  # noqa: E402

RTOL = 1e-9

# one arch per op-graph branch of the symbolic grid enumeration
GRID_ARCHS = ("qwen2-0.5b",            # dense attn
              "moonshot-v1-16b-a3b",   # MoE capacity dispatch
              "recurrentgemma-2b",     # RG-LRU + local attn
              "xlstm-1.3b",            # mLSTM/sLSTM
              "whisper-small")         # encoder + cross-attn
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    return _store_json(tmp_path_factory.mktemp("bp_store") / "store.json")


@pytest.fixture(scope="module")
def engine(store_path):
    store = ttab.TableStore.load(store_path)
    return PM2Lat(store, DEV), BatchPredictor(store, DEV)


@pytest.fixture
def engines(store_path):
    """Fresh port and JAX engines on the same store file."""
    return (BatchPredictor(ttab.TableStore.load(store_path), DEV),
            jbp.BatchPredictor(jtab.TableStore.load(store_path), DEV))


def _seed(jeng, teng):
    """Hand the port's counted feature rows to the JAX engine."""
    jeng._feat_cache.update({k: v.copy() for k, v in teng._feat_cache.items()})


# ---------------------------------------------------------------------------
# batch vs the port's scalar predictor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["matmul", "bmm"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_matmul_matches_scalar(engine, kind, dtype):
    """Vectorized oracle + Eq(1)/(2) == scalar predict_matmul, ≤1e-9 rel,
    over seeded random (m, n, k, batch) configs, one call and op by op."""
    scalar, bp = engine
    rng = np.random.default_rng(3)
    m, n = rng.integers(8, 8192, 200), rng.integers(8, 8192, 200)
    k, b = rng.integers(8, 16384, 200), rng.integers(1, 64, 200)
    got = bp.predict_matmul_batch(m, n, k, b, dtype=dtype, kind=kind)
    for i in range(len(m)):
        op = og.MatmulOp("op", m=int(m[i]), n=int(n[i]), k=int(k[i]),
                         batch=int(b[i]), kind=kind, dtype=dtype)
        assert float(got[i]) == pytest.approx(scalar.predict_matmul(op),
                                              rel=RTOL)
        one = float(bp.predict_matmul_batch(op.m, op.n, op.k, op.batch,
                                            dtype=dtype, kind=kind))
        assert one == float(got[i])


def test_batch_matmul_returns_the_scalar_kernels(engine):
    scalar, bp = engine
    rng = np.random.default_rng(4)
    m, n, k = (rng.integers(8, 4096, 100) for _ in range(3))
    _, kernels = bp.predict_matmul_batch(m, n, k, return_kernels=True)
    for i in range(len(m)):
        row = scalar.predict_op(og.MatmulOp("op", m=int(m[i]), n=int(n[i]),
                                            k=int(k[i])))
        assert kernels[i] == row.kernel


def test_batch_matmul_explicit_kernel_matches_scalar(engine):
    scalar, bp = engine
    op = og.MatmulOp("op", m=300, n=700, k=900, count=3)
    got = float(bp.predict_matmul_batch(300, 700, 900, count=3,
                                        kernel="mm_64x64x64"))
    assert got == pytest.approx(scalar.predict_matmul(op, "mm_64x64x64"),
                                rel=RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [None, 64, 128])
def test_batch_attention_matches_scalar(engine, dtype, hd):
    scalar, bp = engine
    skvs = [16, 100, 128, 777, 2048, 3000, 4096, 8192]
    ops = [og.AttentionOp("a", batch=2, heads=4, kv_heads=2, sq=s, skv=s,
                          hd=hd or 64, count=3, dtype=dtype) for s in skvs]
    got, kernels = bp.predict_attention_batch(
        [o.skv for o in ops], [o.flops for o in ops],
        None if hd is None else [o.hd for o in ops], dtype=dtype,
        return_kernels=True)
    for op, sec, kern in zip(ops, got, kernels):
        if hd is None:
            t = scalar.oracle.select_attention(dtype, op.skv)
            want = op.flops / t.interpolate_throughput(op.skv)
        else:
            row = scalar.predict_op(op)
            want, t = row.seconds, scalar.oracle.lookup("attention",
                                                        row.kernel, dtype)
        assert float(sec) == pytest.approx(want, rel=RTOL)
        assert kern == t.key.kernel


def test_batch_memory_matches_scalar(engine):
    scalar, bp = engine
    ops = [og.MemoryOp("ln", "rmsnorm", (64, 256), count=2),
           og.MemoryOp("res", "add", (64, 256)),
           og.MemoryOp("act", "silu_mul", (32, 512), count=3),
           og.MemoryOp("sm", "softmax", (16, 128)),
           og.MemoryOp("rope", "rope", (32, 4, 16), dtype="bfloat16"),
           og.MemoryOp("scan", "assoc_scan", (2, 16, 32), count=2)]
    got = bp.predict_memory_batch(ops)
    for op, sec in zip(ops, got):
        assert float(sec) == pytest.approx(scalar.predict_memory(op), rel=RTOL)


@pytest.mark.parametrize("ctx", [1, 513, 4096])
def test_batch_decode_attention_matches_scalar(engine, ctx):
    scalar, bp = engine
    cfg = tcr.reduced("qwen2-0.5b")
    ops = [op for op in og.enumerate_decode_ops(cfg, 4, ctx)
           if op.kind == "attention"]
    secs, kernels = bp.predict_decode_attention_batch(ops, return_kernels=True)
    for op, sec, kern in zip(ops, secs, kernels):
        row = scalar.predict_op(op)
        assert (float(sec), kern) == (row.seconds, row.kernel)


def test_batch_collectives_match_scalar(engine):
    scalar, bp = engine
    rng = np.random.default_rng(5)
    for coll in tcol.COLLECTIVES:
        ops = [tcol.CollectiveOp("c", coll, float(rng.uniform(1, 1e9)),
                                 int(rng.integers(1, 65)),
                                 count=int(rng.integers(1, 4)))
               for _ in range(20)]
        secs, algos = bp.predict_collective_batch(ops, return_algos=True)
        for op, sec, algo in zip(ops, secs, algos):
            row = scalar.predict_op(op)
            assert row.kind == "collective"
            assert float(sec) == pytest.approx(row.seconds, rel=RTOL)
            assert algo == row.kernel


def test_empty_batches(engine):
    _, bp = engine
    assert bp.predict_memory_batch([]).shape == (0,)
    assert bp.predict_decode_attention_batch([]).shape == (0,)
    secs, algos = bp.predict_collective_batch([], return_algos=True)
    assert secs.shape == algos.shape == (0,)


@pytest.mark.parametrize("name", GRID_ARCHS)
def test_predict_ops_rows_match_scalar(engine, name):
    """A mixed op list through the grouped vectorized path: totals and
    per-row seconds/kind/kernel match the scalar predictor."""
    scalar, bp = engine
    ops = og.enumerate_ops(tcr.reduced(name), 2, 32)
    want_total, want_rows = scalar.predict_ops(ops)
    got_total, got_rows = bp.predict_ops(ops)
    assert got_total == pytest.approx(want_total, rel=RTOL)
    for w, g in zip(want_rows, got_rows):
        assert (g.name, g.kind, g.kernel) == (w.name, w.kind, w.kernel)
        assert g.seconds == pytest.approx(w.seconds, rel=RTOL)


# ---------------------------------------------------------------------------
# grids vs loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GRID_ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_predict_model_grid_matches_loop(engine, name, dtype):
    """Symbolic grid enumeration + broadcast == per-point predict_model."""
    scalar, bp = engine
    cfg = tcr.reduced(name)
    batches, seqs = (1, 2), (16, 32)
    grid = bp.predict_model_grid(cfg, batches, seqs, dtype)
    assert grid.shape == (len(batches), len(seqs))
    for i, b in enumerate(batches):
        for j, s in enumerate(seqs):
            want, _ = scalar.predict_model(cfg, b, s, dtype=dtype)
            assert float(grid[i, j]) == pytest.approx(want, rel=RTOL), (b, s)
            want_bp, _ = bp.predict_model(cfg, b, s, dtype=dtype)
            assert float(grid[i, j]) == pytest.approx(want_bp, rel=RTOL)


def test_predict_model_grid_dtype_dict(engines):
    """The port takes one dtype a call; each of its grids equals the entry
    of the JAX engine's ``{dtype: array}`` answer for that dtype."""
    bp, jeng = engines
    cfg = tcr.reduced("qwen2-0.5b")
    grids = {dt: bp.predict_model_grid(cfg, (1, 2), (16,), dt)
             for dt in DTYPES}
    _seed(jeng, bp)
    out = jeng.predict_model_grid(jcr.reduced("qwen2-0.5b"), (1, 2), (16,),
                                  DTYPES)
    assert sorted(out) == sorted(DTYPES)
    for dt in DTYPES:
        np.testing.assert_array_equal(out[dt], grids[dt])
    np.testing.assert_array_equal(
        bp.predict_model_grid(cfg, (1, 2), (16,)),
        bp.predict_model_grid(cfg, (1, 2), (16,), "float32"))


@pytest.mark.parametrize("name", GRID_ARCHS)
def test_predict_decode_grid_matches_scalar_step(engine, name):
    """The decode grid == the scalar predictor over one decode step's ops
    at every (batch, ctx)."""
    scalar, bp = engine
    cfg = tcr.reduced(name)
    batches, ctxs = (1, 4), (1, 64, 513)
    grid = bp.predict_decode_grid(cfg, batches, ctxs)
    assert grid.shape == (len(batches), len(ctxs))
    for i, b in enumerate(batches):
        for j, c in enumerate(ctxs):
            want, _ = scalar.predict_ops(og.enumerate_decode_ops(cfg, b, c))
            assert float(grid[i, j]) == pytest.approx(want, rel=RTOL), (b, c)


def _scalarize(v):
    return float(v[0]) if isinstance(v, np.ndarray) else float(v)


@pytest.mark.parametrize("name", tcr.ARCH_NAMES)
def test_grid_enumeration_mirrors_scalar_opgraph(name):
    """For every registered arch the grid enumeration reproduces the port's
    scalar op list field for field."""
    cfg = tcr.reduced(name)
    gops = enumerate_grid_ops(cfg, np.array([3]), np.array([48]))
    sops = og.enumerate_ops(cfg, 3, 48)
    assert len(gops) == len(sops), name
    for gop, sop in zip(gops, sops):
        assert gop.name == sop.name, name
        if sop.kind in ("matmul", "bmm"):
            assert gop.kind == sop.kind
            for attr in ("m", "n", "k", "batch", "count"):
                assert _scalarize(getattr(gop, attr)) == getattr(sop, attr), \
                    (name, sop.name, attr)
        elif sop.kind == "attention":
            assert _scalarize(gop.flops) == sop.flops, (name, sop.name)
            assert _scalarize(gop.skv) == sop.skv, (name, sop.name)
            assert gop.hd == sop.hd, (name, sop.name)
        else:
            assert gop.snippet == sop.snippet, (name, sop.name)
            assert tuple(_scalarize(x) for x in gop.shape) == tuple(
                float(x) for x in sop.shape), (name, sop.name)
            assert _scalarize(gop.count) == sop.count, (name, sop.name)


def test_predict_blocks_matches_scalar(engine):
    scalar, bp = engine
    cfg = tcr.reduced("qwen2-0.5b", n_layers=4)
    want = scalar.predict_blocks(cfg, 2, 32)
    got = bp.predict_blocks(cfg, 2, 32)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=RTOL)


# ---------------------------------------------------------------------------
# the port's engine against the JAX package's, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["matmul", "bmm"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_family_equals_jax_engine(engines, kind, dtype):
    teng, jeng = engines
    rng = np.random.default_rng(6)
    args = [rng.integers(1, 9000, 500) for _ in range(3)] + [
        rng.integers(1, 64, 500), rng.integers(1, 5, 500)]
    t, tk = teng.predict_matmul_batch(*args, dtype=dtype, kind=kind,
                                      return_kernels=True)
    j, jk = jeng.predict_matmul_batch(*args, dtype=dtype, kind=kind,
                                      return_kernels=True)
    np.testing.assert_array_equal(t, j)
    assert list(tk) == list(jk)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_family_equals_jax_engine(engines, dtype):
    teng, jeng = engines
    rng = np.random.default_rng(7)
    skv = rng.integers(1, 10000, 300)
    flops = rng.uniform(1e6, 1e12, 300)
    hd = rng.choice([16, 32, 64, 128], 300)
    for h in (None, hd):
        t, tk = teng.predict_attention_batch(skv, flops, h, dtype=dtype,
                                             return_kernels=True)
        j, jk = jeng.predict_attention_batch(skv, flops, h, dtype=dtype,
                                             return_kernels=True)
        np.testing.assert_array_equal(t, j)
        assert list(tk) == list(jk)


@pytest.mark.parametrize("name", GRID_ARCHS)
def test_decode_attention_family_equals_jax_engine(engines, name):
    teng, jeng = engines
    tops = [op for op in og.enumerate_decode_ops(tcr.reduced(name), 3, 700)
            if op.kind == "attention"]
    jops = [op for op in jog.enumerate_decode_ops(jcr.reduced(name), 3, 700)
            if op.kind == "attention"]
    t, tk = teng.predict_decode_attention_batch(tops, return_kernels=True)
    j, jk = jeng.predict_decode_attention_batch(jops, return_kernels=True)
    np.testing.assert_array_equal(t, j)
    assert list(tk) == list(jk)


@pytest.mark.parametrize("coll", tcol.COLLECTIVES)
def test_collective_family_equals_jax_engine(engines, coll):
    teng, jeng = engines
    rng = np.random.default_rng(8)
    spec = [(float(rng.uniform(1, 1e10)), int(rng.integers(1, 513)),
             int(rng.integers(1, 5))) for _ in range(64)]
    t, ta = teng.predict_collective_batch(
        [tcol.CollectiveOp("c", coll, n, w, count=c) for n, w, c in spec],
        return_algos=True)
    j, ja = jeng.predict_collective_batch(
        [jcol.CollectiveOp("c", coll, n, w, count=c) for n, w, c in spec],
        return_algos=True)
    np.testing.assert_array_equal(t, j)
    assert list(ta) == list(ja)


@pytest.mark.parametrize("name", GRID_ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_model_grid_equals_jax_engine(engines, name, dtype):
    teng, jeng = engines
    batches, seqs = (1, 3, 8), (16, 48, 128)
    t = teng.predict_model_grid(tcr.reduced(name), batches, seqs, dtype)
    _seed(jeng, teng)
    n_rows = len(jeng._feat_cache)
    j = jeng.predict_model_grid(jcr.reduced(name), batches, seqs, dtype)
    assert len(jeng._feat_cache) == n_rows     # every row came from the port
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name", GRID_ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_grid_equals_jax_engine(engines, name, dtype):
    teng, jeng = engines
    batches, ctxs = (1, 4, 16), (1, 100, 512, 2048)
    t = teng.predict_decode_grid(tcr.reduced(name), batches, ctxs, dtype)
    _seed(jeng, teng)
    n_rows = len(jeng._feat_cache)
    j = jeng.predict_decode_grid(jcr.reduced(name), batches, ctxs, dtype)
    assert len(jeng._feat_cache) == n_rows
    np.testing.assert_array_equal(t, j)


def test_predict_ops_and_blocks_equal_jax_engine(engines):
    teng, jeng = engines
    tcfg, jcfg = tcr.reduced("qwen2-0.5b", n_layers=3), \
        jcr.reduced("qwen2-0.5b", n_layers=3)
    tt, trows = teng.predict_ops(og.enumerate_ops(tcfg, 2, 40))
    tb = teng.predict_blocks(tcfg, 2, 40)
    _seed(jeng, teng)
    jt, jrows = jeng.predict_ops(jog.enumerate_ops(jcfg, 2, 40))
    assert tt == jt
    assert [dataclasses.astuple(r) for r in trows] == \
        [dataclasses.astuple(r) for r in jrows]
    assert tb == jeng.predict_blocks(jcfg, 2, 40)


@pytest.mark.parametrize("name", tcr.ARCH_NAMES)
def test_config_key_equals_jax(name):
    assert config_key(tcr.get(name)) == jbp.config_key(jcr.get(name))
    assert config_key(tcr.reduced(name)) == jbp.config_key(jcr.reduced(name))


@pytest.mark.parametrize("name", tcr.ARCH_NAMES)
def test_grid_enumeration_equals_jax(name):
    """The two symbolic enumerations give the same op list, field for field,
    over a grid of points."""
    b, s = np.array([1, 3, 8]), np.array([16, 48, 256])
    tops = enumerate_grid_ops(tcr.reduced(name), b, s, "bfloat16")
    jops = jbp.enumerate_grid_ops(jcr.reduced(name), b, s, "bfloat16")
    assert [type(o).__name__ for o in tops] == [type(o).__name__ for o in jops]
    for t, j in zip(tops, jops):
        for f in dataclasses.fields(t):
            tv, jv = getattr(t, f.name), getattr(j, f.name)
            if f.name == "shape":
                assert len(tv) == len(jv)
                for x, y in zip(tv, jv):
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(tv, jv)


# ---------------------------------------------------------------------------
# prediction cache
# ---------------------------------------------------------------------------

def test_cache_schema_and_keys_equal_jax():
    assert PredictionCache.SCHEMA == jbp.PredictionCache.SCHEMA == 8
    for args in (("m", "dev", None, 2, 64), ("m", "dev", "bfloat16", 1, 8),
                 ("m", "dev", "float32", 4, 16)):
        assert (PredictionCache.make_key(*args)
                == jbp.PredictionCache.make_key(*args))


def test_cache_lru_and_persistence_roundtrip(tmp_path):
    cache = PredictionCache(maxsize=3)
    keys = [PredictionCache.make_key("m", "dev", None, b, 64) for b in range(5)]
    for i, key in enumerate(keys):
        cache.put(key, i * 1e-3)
    assert len(cache) == 3                       # LRU evicted the oldest two
    assert cache.get(keys[0]) is None and cache.get(keys[1]) is None
    assert cache.get(keys[4]) == 4e-3
    cache.get(keys[2])                           # 2 is now the newest
    cache.put("extra", 1)
    assert keys[3] not in cache and keys[2] in cache
    path = str(tmp_path / "latency_cache.json")
    cache.save(path)
    cache2 = PredictionCache(maxsize=8, path=path)
    assert len(cache2) == 3
    assert cache2.get(keys[2]) == 2e-3
    assert type(cache2.get("extra")) is float
    assert cache2.stats == {"size": 3, "hits": 2, "misses": 0, "maxsize": 8}
    # the JAX package's cache reads the port's file, entry for entry
    jcache = jbp.PredictionCache(maxsize=8, path=path)
    assert list(jcache._od.items()) == list(cache2._od.items())


def test_cache_save_needs_a_path():
    with pytest.raises(ValueError):
        PredictionCache().save()


def test_cache_survives_corrupt_file(tmp_path):
    """A truncated/corrupt persisted cache loads as empty (or keeps its
    well-formed entries) and the next save atomically replaces it."""
    path = str(tmp_path / "c.json")
    schema = PredictionCache.SCHEMA
    for garbage in ('{"entries": [["a|b|float32|1|',   # truncated mid-write
                    "null",                            # external partial write
                    '{"schema": %d, "entries": '
                    '[["a", 1, 2], "x", ["b", true], ["d", {"busy": 1.0}], '
                    '["ok|k", 2e-3]]}'
                    % schema):
        with open(path, "w") as f:
            f.write(garbage)
        cache = PredictionCache(maxsize=4, path=path)
        assert len(cache) <= 1                      # only well-formed entries
    assert cache.get("ok|k") == 2e-3
    cache.put("k", 1e-3)
    cache.save()
    assert PredictionCache(maxsize=4, path=path).get("k") == 1e-3
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


def test_cache_discards_other_schema_versions(tmp_path):
    path = str(tmp_path / "c.json")
    for stale in ('{"entries": [["legacy|k", 1e-3]]}',          # pre-schema
                  '{"schema": 1, "entries": [["old|k", 1e-3]]}',
                  '{"schema": 9, "entries": [["new|k", 1e-3]]}'):
        with open(path, "w") as f:
            f.write(stale)
        assert len(PredictionCache(maxsize=4, path=path)) == 0
    cache = PredictionCache(maxsize=4, path=path)
    cache.put("new|k", 2e-3)
    cache.save()
    assert PredictionCache(maxsize=4, path=path).get("new|k") == 2e-3


def test_cached_predict_hits_after_miss(engine, tmp_path):
    _, bp = engine
    cfg = tcr.reduced("qwen2-0.5b")
    path = str(tmp_path / "pred_cache.json")
    cache = PredictionCache(maxsize=16, path=path)
    first = bp.predict_model_cached(cfg, 2, 32, cache=cache)
    assert cache.stats == {"size": 1, "hits": 0, "misses": 1, "maxsize": 16}
    second = bp.predict_model_cached(cfg, 2, 32, cache=cache)
    assert second == first and cache.hits == 1
    assert first == bp.predict_model(cfg, 2, 32)[0]
    cache.save()
    key = PredictionCache.make_key(config_key(cfg), bp.cache_device, None, 2, 32)
    assert bp.cache_device == DEV
    assert PredictionCache(path=path).get(key) == first
    # no cache: computed every time
    assert BatchPredictor(bp.store, DEV).predict_model_cached(cfg, 2, 32) \
        == first


def test_cached_predict_uses_the_engine_cache(store_path):
    cache = PredictionCache(maxsize=4)
    bp = BatchPredictor(ttab.TableStore.load(store_path), DEV, cache=cache)
    cfg = tcr.reduced("qwen2-0.5b")
    a = bp.predict_model_cached(cfg, 1, 16)
    b = bp.predict_model_cached(cfg, 1, 16)
    assert a == b and cache.stats["hits"] == 1 and len(cache) == 1


def test_cache_distinguishes_replaced_configs(engine):
    """dataclasses.replace keeps cfg.name; the architecture fingerprint in
    config_key keeps variants from colliding in the cache."""
    _, bp = engine
    cfg = tcr.reduced("qwen2-0.5b", n_layers=2)
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    assert cfg.name == cfg4.name and config_key(cfg) != config_key(cfg4)
    cache = PredictionCache(maxsize=8)
    t2 = bp.predict_model_cached(cfg, 2, 32, cache=cache)
    t4 = bp.predict_model_cached(cfg4, 2, 32, cache=cache)
    assert cache.stats["misses"] == 2 and t4 > t2
