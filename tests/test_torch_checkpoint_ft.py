"""The port's checkpoint store and fault-tolerant driver
(``checkpoint/store.py``, ``ft/driver.py``), as ``tests/test_checkpoint_ft.py``
holds the JAX package's: the restart path must reproduce an uninterrupted
run exactly (the data pipeline is step-indexed), and a restored state
equals the saved one bit for bit, bfloat16 included."""
import gc
import json
import os
import weakref
import zipfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store as store_mod
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.ft import driver as ftd
from repro_torch.training import optimizer as opt


def _toy_problem():
    """Deterministic quadratic 'training' that updates its state in place,
    as the port's train step does: state {'w': vec}, loss |w - t|^2."""
    target = torch.arange(4.0)

    class Data:
        def batch_at(self, step):
            return {"step": step}

    def step_fn(state, batch):
        w = state["w"]
        w.sub_(0.1 * 2 * (w - target))
        return state, {"loss": float(torch.sum((w - target) ** 2))}

    return {"w": torch.zeros(4)}, step_fn, Data()


def test_roundtrip_and_keep_k(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2, async_write=False)
    state = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for s in (1, 2, 3, 4):
        store.save(s, state)
    assert store.list_steps() == [3, 4]
    like = {"a": torch.zeros(2, 3, dtype=torch.int64),
            "b": {"c": torch.zeros(4)}}
    restored, step = store.restore_latest(like)
    assert step == 4 and restored is like
    assert torch.equal(like["a"], state["a"])
    assert torch.equal(like["b"]["c"], state["b"]["c"])


def test_atomic_no_tmp_left(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=3, async_write=False)
    store.save(7, {"x": torch.zeros(3)})
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    assert sorted(os.listdir(tmp_path / "step_00000007")) == [
        "leaves.npz", "tree.json"]


def test_async_writer_copies_at_save(tmp_path):
    """The writer thread writes what the state held at ``save``, though
    the live tensor changes in place right after."""
    store = CheckpointStore(str(tmp_path), keep=3, async_write=True)
    x = torch.ones(8)
    store.save(1, {"x": x})
    x.fill_(5.0)
    store.wait()
    assert store.list_steps() == [1]
    like = {"x": torch.zeros(8)}
    store.restore(1, like)
    assert torch.equal(like["x"], torch.ones(8))
    assert [w["step"] for w in store.writes] == [1]


def test_async_writer_lets_go_of_the_host_copy(tmp_path, monkeypatch):
    """Once a write is on disk no host copy of the state stays alive: the
    writer thread outlives the run, and a full-width state's copy is tens
    of GB (xlstm-1.3b's step-0 checkpoint: 43.8 GB)."""
    copies, flatten = [], store_mod._flatten

    def tracked(state):
        arrays = flatten(state)
        copies.extend(weakref.ref(a) for a, _ in arrays.values())
        return arrays
    monkeypatch.setattr(store_mod, "_flatten", tracked)
    store = CheckpointStore(str(tmp_path), keep=3, async_write=True)
    store.save(1, {"x": torch.ones(8), "y": torch.zeros(3)})
    store.wait()
    gc.collect()
    assert len(copies) == 2 and all(ref() is None for ref in copies)
    assert store.list_steps() == [1]


def test_leaves_file_holds_np_savez_entries(tmp_path):
    """``leaves.npz`` has the entries ``np.savez`` writes for the same
    arrays, byte for byte (names, CRCs, .npy headers and data): 0-d,
    empty, bool, Fortran-ordered and strided arrays among them."""
    arrays = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
              "step": np.array(7, np.int32), "e": np.zeros((0, 3)),
              "b": np.array([True, False]),
              "bits": np.arange(5, dtype=np.uint16),
              "f": np.asfortranarray(np.arange(6.0).reshape(2, 3)),
              "s": np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2]}
    store_mod._save_npz(str(tmp_path / "port.npz"), arrays)
    np.savez(tmp_path / "numpy.npz", **arrays)
    with zipfile.ZipFile(tmp_path / "port.npz") as a, \
            zipfile.ZipFile(tmp_path / "numpy.npz") as b:
        assert [(i.filename, i.CRC) for i in a.infolist()] == \
            [(i.filename, i.CRC) for i in b.infolist()]
        assert all(a.read(n) == b.read(n) for n in b.namelist())


def test_async_write_error_surfaces_at_wait(tmp_path):
    store = CheckpointStore(str(tmp_path / "d"), keep=3, async_write=True)
    os.rmdir(tmp_path / "d")
    (tmp_path / "d").write_text("not a directory")
    store.save(1, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError):
        store.wait()


def test_bf16_and_optimizer_state_round_trip_bit_for_bit(tmp_path):
    """bfloat16 has no numpy type: its bits are stored and its type is
    recorded, so it comes back exactly; so do an ``OptState``'s int32 step
    and f32 moments under the port's state names."""
    gen = torch.Generator().manual_seed(0)
    params = {"embed.w": torch.randn(5, 3, generator=gen).bfloat16(),
              "blocks.0.ln1.scale": torch.randn(3, generator=gen)}
    state = (params, opt.init_opt_state(params))
    state[1].m["embed.w"].normal_(generator=gen)
    store = CheckpointStore(str(tmp_path), async_write=False)
    store.save(0, state)
    meta = json.loads((tmp_path / "step_00000000" / "tree.json").read_text())
    assert meta["dtypes"]["0;embed.w"] == "bfloat16"
    assert meta["dtypes"]["1;step"] == "int32"
    assert "1;m;embed.w" in meta["shapes"]
    like = ({k: torch.zeros_like(v) for k, v in params.items()},
            opt.init_opt_state(params))
    store.restore(0, like)
    for key, a in params.items():
        b = like[0][key]
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(like[0]["embed.w"].view(torch.int16),
                       params["embed.w"].view(torch.int16))
    assert torch.equal(like[1].m["embed.w"], state[1].m["embed.w"])


def test_restore_rejects_a_foreign_state(tmp_path):
    store = CheckpointStore(str(tmp_path), async_write=False)
    store.save(0, {"x": torch.zeros(4)})
    with pytest.raises(ValueError):
        store.restore(0, {"x": torch.zeros(5)})
    with pytest.raises(ValueError):
        store.restore(0, {"x": torch.zeros(4, dtype=torch.bfloat16)})
    with pytest.raises(TypeError):
        store.save(1, {"x": np.zeros(4)})


def test_restart_reproduces_uninterrupted_run(tmp_path):
    init, step_fn, data = _toy_problem()
    store1 = CheckpointStore(str(tmp_path / "a"), async_write=False)
    _, log1 = ftd.run_training(step_fn=step_fn, init_state=init, data=data,
                               num_steps=20, store=store1, ckpt_every=5)
    init2, _, _ = _toy_problem()
    store2 = CheckpointStore(str(tmp_path / "b"), async_write=True)
    inj = ftd.FailureInjector(fail_at_steps=(7, 13))
    state2, log2 = ftd.run_training(step_fn=step_fn, init_state=init2,
                                    data=data, num_steps=20, store=store2,
                                    ckpt_every=5, injector=inj)
    assert log2.restarts == 2
    d1 = dict(zip(log1.steps, log1.losses))
    d2 = dict(zip(log2.steps, log2.losses))
    assert d1 == d2
    assert torch.equal(state2["w"], init["w"])
    # a third run resumes from the newest checkpoint and has nothing to do
    init3, _, _ = _toy_problem()
    state3, log3 = ftd.run_training(step_fn=step_fn, init_state=init3,
                                    data=data, num_steps=16, store=store2,
                                    ckpt_every=5)
    assert log3.steps == [] and store2.list_steps()[-1] == 15


def test_step_zero_is_always_saved_and_a_failure_there_restarts(tmp_path):
    init, step_fn, data = _toy_problem()
    store = CheckpointStore(str(tmp_path), async_write=False)
    inj = ftd.FailureInjector(fail_at_steps=(0,))
    _, log = ftd.run_training(step_fn=step_fn, init_state=init, data=data,
                              num_steps=3, store=store, ckpt_every=100,
                              injector=inj)
    assert log.restarts == 1 and log.steps == [0, 1, 2]
    assert store.list_steps() == [0]


def test_too_many_restarts_raise(tmp_path):
    init, step_fn, data = _toy_problem()
    store = CheckpointStore(str(tmp_path), async_write=False)
    inj = ftd.FailureInjector(fail_at_steps=(1, 2, 3))
    with pytest.raises(ftd.SimulatedFailure):
        ftd.run_training(step_fn=step_fn, init_state=init, data=data,
                         num_steps=5, store=store, injector=inj,
                         max_restarts=2)


def test_straggler_monitor_flags_outliers():
    mon = ftd.StragglerMonitor(tau=3.0)
    for i in range(10):
        assert not mon.observe(i, 0.1)
    assert mon.observe(10, 1.0)
    assert len(mon.events) == 1


# ----- against the JAX package: the on-disk format and the loop -----

def _jax():
    return pytest.importorskip("jax")


def _nest_np(seed=0):
    """A state as numpy leaves: parameters by the port's names, an
    optimizer state (a NamedTuple of an int32 step and f32 moments), a
    tuple of an int32 and a bfloat16 leaf (bfloat16 as its 16 bits)."""
    rng = np.random.default_rng(seed)
    params = {"embed.w": rng.standard_normal((5, 3)).astype(np.float32),
              "blocks.0.ln1.scale": rng.standard_normal(3).astype(np.float32)}
    moment = lambda: {k: rng.standard_normal(v.shape).astype(np.float32)
                      for k, v in params.items()}
    bf16_bits = (rng.standard_normal(6).astype(np.float32)
                 .view(np.uint32) >> 16).astype(np.uint16)
    return {"params": params, "step": np.array(3, np.int32), "m": moment(),
            "v": moment(), "data": np.arange(6, dtype=np.int32).reshape(2, 3),
            "bf16_bits": bf16_bits}


def _port_state(nest, zero=False):
    f = (lambda a: torch.zeros_like(torch.from_numpy(a))) if zero else \
        (lambda a: torch.from_numpy(a.copy()))
    params = {k: f(a) for k, a in nest["params"].items()}
    st = opt.OptState(f(nest["step"]), {k: f(a) for k, a in nest["m"].items()},
                      {k: f(a) for k, a in nest["v"].items()})
    bf = f(nest["bf16_bits"].view(np.int16)).view(torch.bfloat16)
    return (params, st, (f(nest["data"]), bf))


def _jax_state(nest, zero=False):
    jnp = _jax().numpy
    from repro.training import optimizer as jopt
    f = (lambda a: jnp.zeros_like(a)) if zero else jnp.asarray
    params = {k: f(a) for k, a in nest["params"].items()}
    st = jopt.OptState(f(nest["step"]), {k: f(a) for k, a in nest["m"].items()},
                       {k: f(a) for k, a in nest["v"].items()})
    bf = jnp.asarray(nest["bf16_bits"]).view(jnp.bfloat16)
    if zero:
        bf = jnp.zeros_like(bf)
    return (params, st, (f(nest["data"]), bf))


def _bits(a):
    """An array's bytes as unsigned integers of its width (the reference
    stores bfloat16 as a 2-byte void, the port as uint16)."""
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def test_on_disk_format_is_the_references(tmp_path):
    """The same state written by both packages: the same directory, the
    same ``tree.json`` (step, keys, dtypes, shapes) and the same
    ``leaves.npz`` keys, each leaf equal bit for bit."""
    _jax()
    from repro.checkpoint.store import CheckpointStore as JaxStore
    nest = _nest_np()
    CheckpointStore(str(tmp_path / "port"), async_write=False).save(
        5, _port_state(nest))
    JaxStore(str(tmp_path / "jax"), async_write=False).save(
        5, _jax_state(nest))
    got, want = (tmp_path / d / "step_00000005" for d in ("port", "jax"))
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    meta = json.loads((got / "tree.json").read_text())
    assert meta == json.loads((want / "tree.json").read_text())
    assert meta["dtypes"]["1;step"] == "int32"
    assert meta["dtypes"]["2;1"] == "bfloat16"
    assert meta["shapes"]["1;m;embed.w"] == [5, 3]
    with np.load(got / "leaves.npz") as a, np.load(want / "leaves.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].shape == b[key].shape, key
            assert (_bits(a[key]) == _bits(b[key])).all(), key


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_restore_across_packages(tmp_path, writer):
    """A checkpoint written by one package restores in the other, every
    leaf equal bit for bit.  The reference restores a bfloat16 leaf as
    its stored bits (it keeps no type on restore), the port as bfloat16."""
    _jax()
    from repro.checkpoint.store import CheckpointStore as JaxStore
    nest = _nest_np(seed=1)
    if writer == "port":
        CheckpointStore(str(tmp_path), async_write=False).save(
            2, _port_state(nest))
        got, step = JaxStore(str(tmp_path), async_write=False).restore_latest(
            _jax_state(nest, zero=True))
        bf = _bits(got[2][1])
    else:
        JaxStore(str(tmp_path), async_write=False).save(2, _jax_state(nest))
        got, step = CheckpointStore(str(tmp_path),
                                    async_write=False).restore_latest(
            _port_state(nest, zero=True))
        assert got[2][1].dtype == torch.bfloat16
        bf = got[2][1].view(torch.int16).numpy().view(np.uint16)
        got = (got[0], got[1], (got[2][0], None))
    assert step == 2
    assert (bf == nest["bf16_bits"]).all()
    params, st, (data, _) = got
    for key, a in nest["params"].items():
        assert (_bits(params[key]) == _bits(a)).all(), key
        assert (_bits(st.m[key]) == _bits(nest["m"][key])).all(), key
        assert (_bits(st.v[key]) == _bits(nest["v"][key])).all(), key
    assert int(np.asarray(st.step)) == 3
    assert (np.asarray(data) == nest["data"]).all()


def _jax_toy():
    """The reference's toy quadratic, in the same f32 arithmetic as
    ``_toy_port``."""
    jnp = _jax().numpy
    target = jnp.arange(4.0)

    def step_fn(state, batch):
        w = state["w"] - 0.1 * (2 * (state["w"] - target))
        return {"w": w}, {"loss": float(jnp.sum((w - target) ** 2))}

    return {"w": jnp.zeros(4)}, step_fn


def _toy_port():
    target = torch.arange(4.0)

    def step_fn(state, batch):
        w = state["w"]
        w.sub_(0.1 * (2 * (w - target)))
        return state, {"loss": float(torch.sum((w - target) ** 2))}

    return {"w": torch.zeros(4)}, step_fn


class _StepData:
    def batch_at(self, step):
        return {"step": step}


@pytest.mark.parametrize("fail_at,ckpt_every",
                         [((), 5), ((7, 13), 5), ((0,), 100), ((3, 4, 9), 2)])
def test_run_training_matches_the_references(tmp_path, fail_at, ckpt_every):
    """The port's loop and the JAX package's on the same toy problem with
    the same injected failures: the same steps in the same order, the
    same restarts and checkpoints, and losses and a final state equal to
    rtol 1e-6 (float32 on both sides; the two libraries may sum the four
    terms of the loss in another order)."""
    _jax()
    from repro.checkpoint.store import CheckpointStore as JaxStore
    from repro.ft import driver as jftd
    jinit, jstep = _jax_toy()
    jstore = JaxStore(str(tmp_path / "jax"), keep=10, async_write=True)
    jstate, jlog = jftd.run_training(
        step_fn=jstep, init_state=jinit, data=_StepData(), num_steps=20,
        store=jstore, ckpt_every=ckpt_every,
        injector=jftd.FailureInjector(fail_at_steps=fail_at))
    tinit, tstep = _toy_port()
    tstore = CheckpointStore(str(tmp_path / "port"), keep=10,
                             async_write=True)
    tstate, tlog = ftd.run_training(
        step_fn=tstep, init_state=tinit, data=_StepData(), num_steps=20,
        store=tstore, ckpt_every=ckpt_every,
        injector=ftd.FailureInjector(fail_at_steps=fail_at))
    assert tlog.steps == jlog.steps
    assert tlog.restarts == jlog.restarts == len(fail_at)
    assert tstore.list_steps() == jstore.list_steps()
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tstate["w"].numpy(), np.asarray(jstate["w"]),
                               rtol=1e-6, atol=0)


def test_port_resumes_the_references_run(tmp_path):
    """The reference's loop stops after 10 steps (checkpoints at 0 and 5);
    the port's loop, given the same directory, resumes at step 6 and logs
    the losses of an uninterrupted reference run to rtol 1e-6."""
    _jax()
    from repro.checkpoint.store import CheckpointStore as JaxStore
    from repro.ft import driver as jftd
    jinit, jstep = _jax_toy()
    _, whole = jftd.run_training(
        step_fn=jstep, init_state=jinit, data=_StepData(), num_steps=20,
        store=JaxStore(str(tmp_path / "whole"), async_write=False),
        ckpt_every=5)
    jftd.run_training(step_fn=jstep, init_state=jinit, data=_StepData(),
                      num_steps=10, store=JaxStore(str(tmp_path / "run"),
                                                   async_write=False),
                      ckpt_every=5)
    tinit, tstep = _toy_port()
    _, log = ftd.run_training(
        step_fn=tstep, init_state=tinit, data=_StepData(), num_steps=20,
        store=CheckpointStore(str(tmp_path / "run"), async_write=False),
        ckpt_every=5)
    assert log.steps == list(range(6, 20)) and log.restarts == 0
    np.testing.assert_allclose(log.losses, whole.losses[6:], rtol=1e-6,
                               atol=0)
