"""The port's distributed stack (``distributed/{sharding,specs}.py``,
``ft/elastic.py``, ``launch/mesh.py``, the sharded train step, decode and
launcher) against the JAX package's, on the CPU.

The JAX side runs once, in a subprocess with 8 fake devices
(``--xla_force_host_platform_device_count``) on Auto-axis
``jax.sharding.Mesh``es (``jax.make_mesh`` builds Explicit axes, on which
the reference's ``constrain`` raises); it dumps every arch's specs, runs
the reference's train step on a (2, 2) mesh and saves the weights it
starts from.  The port's multi-process runs are gloo processes started
with torchrun's environment (``tests/_torch_dist.py``).

Tolerances:
- specs: equal, entry for entry (the port's per-layer leaves against the
  reference's stacked ones with the layer dim stripped; caches through the
  (B, W, Hkv, hd) -> (B, Hkv, W, hd) layout map);
- sharded training: losses within 2e-4 relative of one process, and of the
  reference's (2, 2) run (``tests/test_distributed.py``'s limit);
- a restart under 2x2: bit-equal to an uninterrupted 2x2 run;
- sharded decode: logits within 1e-4 of the largest logit (float32
  ``DECODE_TOL``);
- elastic re-mesh: every value equal.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import registry as jcr  # noqa: E402
from repro.ft import elastic as jelastic  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import specs as sp  # noqa: E402
from repro_torch.ft import elastic  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from tests import _torch_dist as td  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ARCHS = tuple(jcr.ARCH_NAMES)
BATCHES = ((8, 32), (6, 32), (1, 32))
CACHE = (8, 64)
TRAIN = ("qwen2-0.5b", 2)
LOSS_RTOL = 2e-4
DECODE_TOL = 1e-4

_REFERENCE = """
import json, sys, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry as cr
from repro.models import registry as mr
from repro.distributed import sharding as sh, specs as sp
from repro.training import optimizer as opt, step as tstep
from repro.data.pipeline import DataConfig, SyntheticLM

meshes, archs, batches, cache_shape, train, out_dir = json.loads(sys.argv[1])

def ents(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))[0]
    return {"/".join(sh._key_str(k) for k in kp): ents(s) for kp, s in leaves}

def mesh_of(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), tuple(names))

out = {}
for arch in archs:
    cfg = cr.reduced(arch)
    model = mr.build(cfg)
    params = model.abstract_params()
    cache = model.abstract_cache(*cache_shape, dtype=jnp.float32)
    o_abs = jax.eval_shape(opt.init_opt_state, params)
    for key, (shape, names) in meshes.items():
        with sh.mesh_context(mesh_of(shape, names)):
            p_specs = sp.params_specs(params)
            o_specs = sp.opt_specs(o_abs, p_specs)
            out[f"{arch}@{key}"] = {
                "params": flat(p_specs),
                "serve": flat(sp.params_specs(params, serve=True)),
                "opt_m_is_params": flat(o_specs.m) == flat(p_specs),
                "opt_v_is_params": flat(o_specs.v) == flat(p_specs),
                "opt_step": ents(o_specs.step),
                "batch": [flat(sp.batch_specs(
                    {"tokens": jax.ShapeDtypeStruct(b, jnp.int32),
                     "labels": jax.ShapeDtypeStruct(b, jnp.int32)}))
                    for b in batches],
                "cache": flat(sp.cache_specs(cache, cfg)),
            }

for arch in archs:   # full width: shapes only (eval_shape), nothing held
    cfg = cr.get(arch)
    params = mr.build(cfg).abstract_params()
    with sh.mesh_context(mesh_of(*meshes["2x4"])):
        out[f"{arch}@full@2x4"] = {"params": flat(sp.params_specs(params))}

arch, n_layers = train
cfg = dataclasses.replace(cr.reduced(arch, n_layers=n_layers),
                          compute_dtype="float32")
model = mr.build(cfg)
init = model.init(jax.random.key(0))
np.savez(out_dir + "/params.npz", **{
    "/".join(sh._key_str(k) for k in kp): np.asarray(v)
    for kp, v in jax.tree_util.tree_flatten_with_path(init)[0]})
data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=8, seed=0))
mesh = mesh_of((2, 2), ("data", "model"))
with sh.mesh_context(mesh):
    ns = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                                   is_leaf=lambda s: isinstance(s, P))
    p_specs = sp.params_specs(init)
    params = jax.device_put(init, ns(p_specs))
    o = opt.init_opt_state(params)
    o = jax.device_put(o, ns(sp.opt_specs(o, p_specs)))
    step = jax.jit(tstep.build_train_step(model, opt.AdamWConfig(lr=1e-3)))
    losses = []
    for s in range(3):
        params, o, m = step(params, o, data.batch_at(s))
        losses.append(float(m["loss"]))
out["train_2x2"] = losses
with open(out_dir + "/reference.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's specs, its (2, 2) losses and the weights they
    start from (``params.npz``), from one 8-fake-device subprocess."""
    d = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    arg = json.dumps([{k: [list(s), list(n)] for k, (s, n) in MESHES.items()},
                      ARCHS, BATCHES, CACHE, TRAIN, str(d)])
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                          arg], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = json.loads((d / "reference.json").read_text())
    ref["params_npz"] = str(d / "params.npz")
    return ref


def _norm(e):
    """One name for a 1-tuple of names (``PartitionSpec`` stores
    ("data",) as "data"; both split the dim over that one mesh dim)."""
    return e[0] if isinstance(e, list) and len(e) == 1 else e


def _ents(spec):
    return [_norm(e) for e in json.loads(json.dumps(list(spec)))]


def _ref_param_path(name: str, cfg) -> tuple:
    """(the JAX package's leaf path, whether it is stacked) of a port
    parameter name."""
    parts = name.split(".")
    period = len(cfg.block_pattern)
    n_stacked = cfg.n_layers // period * period
    if parts[0] == "blocks":
        layer, rest = int(parts[1]), "/".join(parts[2:])
        if layer < n_stacked:
            return f"blocks/sub{layer % period}/{rest}", True
        return f"rem{layer - n_stacked}/{rest}", False
    if parts[:2] == ["encoder", "blocks"]:
        return "encoder/blocks/" + "/".join(parts[3:]), True
    return "/".join(parts), False


def _ref_cache_path(field: str, layer: int, cfg) -> tuple:
    period = len(cfg.block_pattern)
    n_stacked = cfg.n_layers // period * period
    where = (f"layers/scan/sub{layer % period}" if layer < n_stacked
             else f"layers/rem{layer - n_stacked}")
    kind = {"k": "self/k", "v": "self/v", "xk": "cross/k",
            "xv": "cross/v"}.get(field, f"rec/{field}")
    return f"{where}/{kind}", layer < n_stacked


def _meta_model(arch):
    return Transformer(tcr.reduced(arch), device=torch.device("meta"))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(reference, arch, mesh):
    ref = reference[f"{arch}@{mesh}"]
    model = _meta_model(arch)
    with sh.mesh_context(sh.MeshShape(*MESHES[mesh])):
        got = sp.params_specs(model)
        serve = sp.params_specs(model, serve=True)
        o = sp.opt_specs(got)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name in got:
        path, stacked = _ref_param_path(name, model.cfg)
        for mine, theirs in ((got, ref["params"]), (serve, ref["serve"])):
            want = theirs[path]
            if stacked:
                assert want[0] is None, (path, want)
                want = want[1:]
            assert _ents(mine[name]) == _ents(want), (name, path)
    assert o.m is got and o.v is got and ref["opt_m_is_params"] \
        and ref["opt_v_is_params"]
    assert _ents(o.step) == ref["opt_step"] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_specs_match_reference(reference, arch):
    """At full width (a meta-device model: shapes only) on (2, 4): the
    FSDP fallback for rule-less leaves of >= 1 Mi elements counts the
    port's per-layer leaf and the reference's stacked one, and still
    decides alike at every registry config."""
    ref = reference[f"{arch}@full@2x4"]["params"]
    model = Transformer(tcr.get(arch), device=torch.device("meta"))
    with sh.mesh_context(sh.MeshShape(*MESHES["2x4"])):
        got = sp.params_specs(model)
    for name, spec_ in got.items():
        path, stacked = _ref_param_path(name, model.cfg)
        want = ref[path][1:] if stacked else ref[path]
        assert _ents(spec_) == _ents(want), (name, path)


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_specs_match_reference(reference, mesh):
    ref = reference[f"{ARCHS[0]}@{mesh}"]["batch"]
    with sh.mesh_context(sh.MeshShape(*MESHES[mesh])):
        for b, want in zip(BATCHES, ref):
            got = sp.batch_specs({"tokens": torch.empty(b),
                                  "labels": torch.empty(b)})
            assert {k: _ents(v) for k, v in got.items()} == \
                {k: _ents(v) for k, v in want.items()}, b


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference_through_layout(reference, arch, mesh):
    """The port's head-major (B, Hkv, W, hd) caches take the reference's
    (B, W, Hkv, hd) specs with dims 1 and 2 swapped; recurrent states the
    same specs."""
    ref = reference[f"{arch}@{mesh}"]["cache"]
    model = _meta_model(arch)
    cache = model.init_cache(*CACHE, dtype=torch.float32)
    with sh.mesh_context(sh.MeshShape(*MESHES[mesh])):
        got = sp.cache_specs(cache, model.cfg)
    n = 0
    for field, per_layer in got.items():
        if field == "pos":
            assert _ents(per_layer) == [None] and ref["pos"] == []
            continue
        for layer, spec_ in enumerate(per_layer):
            if spec_ is None:
                continue
            path, stacked = _ref_cache_path(field, layer, model.cfg)
            want = ref[path][1:] if stacked else ref[path]
            if field in ("k", "v", "xk", "xv"):
                want = [want[0], want[2], want[1], want[3]]
            assert _ents(spec_) == _ents(want), (field, layer, path)
            n += 1
    assert n == sum(1 for k in ref if k != "pos" and
                    not k.startswith("layers/scan")) + sum(
        len(model.cfg.layer_kinds) // len(model.cfg.block_pattern)
        for k in ref if k.startswith("layers/scan"))


def test_placements_follow_specs():
    """Each mesh dim an entry names shards that tensor dim; the first
    named dim of a tuple is the major split (the pod dim before data)."""
    m = sh.MeshShape((2, 2, 2), ("pod", "data", "model"))
    pl = sh.placements((("pod", "data"), "model", None), m)
    assert [str(p) for p in pl] == ["S(0)", "S(0)", "S(1)"]
    assert [str(p) for p in sh.placements((None, None), m)] == ["R"] * 3


def test_constrain_outside_a_mesh_returns_its_input():
    x = torch.randn(2, 3, 4)
    assert sh.constrain(x, "dp", None, "tp") is x
    assert sh.constrain_hidden(x) is x
    with sh.mesh_context(sh.MeshShape((2, 2), ("data", "model")),
                         act_mode="sp", remat=False):
        # a plain tensor inside a mesh is untouched too
        assert sh.constrain(x, "dp", None, "tp") is x
        assert sh.dp_size() == 2 and sh.tp_size() == 2
        assert sh.act_mode() == "sp" and not sh.remat_enabled()
        assert sh.spec("dp", None, "tp") == (("data",), None, "model")
    assert sh.current_mesh() is None and sh.dp_size() == 1
    assert sh.act_mode() == "tp" and sh.spec("dp", "tp") == (None, None)


def test_production_mesh_keeps_the_reference_device_counts():
    assert tmesh.production_mesh_shape() == ((32, 8), ("data", "model"))
    assert tmesh.production_mesh_shape(multi_pod=True) == (
        (2, 32, 8), ("pod", "data", "model"))
    for multi in (False, True):
        shape, _ = tmesh.production_mesh_shape(multi_pod=multi)
        n = 1
        for d in shape:
            n *= d
        assert n == (512 if multi else 256)


@pytest.mark.parametrize("n,model,batch", [
    (256, 16, 256), (240, 16, 256), (8, 16, 256), (6, 2, 8), (3, 2, 8),
    (7, 1, 12), (16, 4, 6)])
def test_plan_elastic_mesh_equals_reference(n, model, batch):
    assert elastic.plan_elastic_mesh(n, model_degree=model,
                                     global_batch=batch) == \
        jelastic.plan_elastic_mesh(n, model_degree=model, global_batch=batch)


def test_sharded_training_matches_one_process_and_reference(reference,
                                                            tmp_path):
    """Reduced qwen2-0.5b (2 layers, B 8 x S 32, float32, 3 steps) from the
    reference's weights: 2x2, 1x4 and (pod, data, model) 2x1x2 on 4 gloo
    processes against one process, and 2x2 against the reference's (2, 2)
    run."""
    arch, layers = TRAIN
    one = td.train_losses(arch, layers, reference["params_npz"])["losses"]
    runs = {}
    for mesh in ((2, 2), (1, 4), (2, 1, 2)):
        res = td.spawn(4, "train_losses", tmp_path, arch=arch,
                       n_layers=layers, params_npz=reference["params_npz"],
                       mesh=list(mesh))
        assert all(r["losses"] == res[0]["losses"] for r in res)
        runs[mesh] = res[0]
    for mesh, res in runs.items():
        for a, b in zip(res["losses"], one):
            assert abs(a - b) / abs(b) < LOSS_RTOL, (mesh, res["losses"], one)
    for a, b in zip(runs[(2, 2)]["losses"], reference["train_2x2"]):
        assert abs(a - b) / abs(b) < LOSS_RTOL, (runs[(2, 2)], reference)
    # on 2x2 the 14 / 2 heads split over 'model'; on 1x4 wq (224 columns)
    # still splits over 'model' (56 each), the attention heads do not
    assert runs[(2, 2)]["placements"]["blocks.0.attn.wk.w"] == ["S(0)", "S(1)"]
    assert runs[(1, 4)]["placements"]["blocks.0.attn.wq.w"] == ["S(0)", "S(1)"]
    assert runs[(1, 4)]["placements"]["embed.w"] == ["S(1)", "S(0)"]
    # pod and data both split the batch and the FSDP dims, pod the major
    assert runs[(2, 1, 2)]["placements"]["blocks.0.attn.wq.w"] == \
        ["S(0)", "S(0)", "S(1)"]


def test_remat_backward_on_another_thread(tmp_path):
    """On the card autograd runs the backward, and so each block's remat
    recompute, on a device thread of its own; the recompute must see the
    forward's mesh context there (reduced qwen2-0.5b at 1x4, whose 14
    heads are replicated before their reshape only under it).  The
    gradients equal those of a backward on the forward's thread."""
    res = td.spawn(4, "remat_grads_off_thread", tmp_path, arch="qwen2-0.5b",
                   n_layers=2, mesh=[1, 4])
    for r in res:
        assert r.get("max_diff") == 0.0, r


def _launch(tmp_path, name, mesh, extra=()):
    args = ["--arch", "qwen2-0.5b", "--reduced", "--mesh", mesh, "--device",
            "cpu", "--steps", "6", "--ckpt-every", "2", "--batch", "8",
            "--seq", "32", "--ckpt-dir", str(tmp_path / f"ckpt_{name}"),
            "--result-json", str(tmp_path / f"{name}.json"), *extra]
    return args


def test_launcher_restart_on_2x2_is_bit_equal(tmp_path):
    """4 processes with torchrun's environment run the launcher at 2x2 with
    a failure at step 3: the losses equal an uninterrupted 2x2 run's bit
    for bit; that run and one at 1x4 lie within 2e-4 of the launcher's 1x1
    run."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train"]
    for name, mesh, extra in (("fail", "2x2", ("--fail-at", "3")),
                              ("clean", "2x2", ()), ("tp4", "1x4", ())):
        args = _launch(tmp_path, name, mesh, extra)
        td.run_ranks([cmd + args] * 4, tmp_path, timeout=150)
    fail, clean, tp4 = (json.loads((tmp_path / f"{n}.json").read_text())
                        for n in ("fail", "clean", "tp4"))
    assert fail["restarts"] == 1 and fail["steps"] == list(range(6))
    assert fail["losses"] == clean["losses"]
    assert fail["mesh"] == {"data": 2, "model": 2} and fail["world"] == 4
    assert tp4["mesh"] == {"data": 1, "model": 4}
    one = train.run(train.parse_args(_launch(tmp_path, "one", "1x1")))
    for run in (clean, tp4):
        for a, b in zip(run["losses"], one["losses"]):
            assert abs(a - b) / abs(b) < LOSS_RTOL, (run, one)
    # rank 0 alone wrote the checkpoints, those of a one-device run
    steps = sorted(p.name for p in (tmp_path / "ckpt_clean").iterdir())
    assert steps == sorted(p.name for p in (tmp_path / "ckpt_one").iterdir())


def test_launcher_mesh_without_process_group_raises(tmp_path):
    with pytest.raises(ValueError, match="no process group"):
        train.run(train.parse_args(_launch(tmp_path, "x", "2x2")))


def test_elastic_reshard_2x2_onto_three_healthy_ranks(tmp_path):
    """4 processes: reduced qwen2-0.5b's weights on 2x2 move onto the plan
    for 3 healthy ranks, (1, 2) over ranks 0 and 1; every value equal."""
    res = td.spawn(4, "reshard", tmp_path, arch="qwen2-0.5b", n_layers=2,
                   healthy=3, batch=8)
    assert [r["plan"] for r in res] == [[1, 2]] * 4
    assert [r["in_mesh"] for r in res] == [True, True, False, False]
    for r in res[:2]:
        assert r["equal"] and r["mesh"] == [1, 2]
        assert r["placements"]["blocks.0.attn.wq.w"] == ["S(0)", "S(1)"]


# an MoE arch runs in the dispatch mode after its '/' (``moe_ffn``'s modes:
# routing, scatter and combine on each rank's groups, experts over 'model')
SERVE_KINDS = [
    ("moonshot-v1-16b-a3b/einsum", ["S(0)", "S(1)"]),   # batch, kv heads
    ("moonshot-v1-16b-a3b/gather", ["S(0)", "S(1)"]),
    ("xlstm-1.3b", ["S(0)", "S(2)"]),      # the mLSTM conv state: batch, di
    ("whisper-small", ["S(0)", "S(1)"])]   # self and cross caches


@pytest.mark.parametrize("arch,cache_pl", [
    ("qwen2-0.5b", ["S(0)", "S(1)"]),            # batch, kv heads (2 / 2)
    ("yi-6b", ["S(0)", "S(1)"])] + SERVE_KINDS)  # batch, kv heads (4 / 2)
def test_sharded_prefill_matches_one_process(tmp_path, arch, cache_pl):
    """Reduced ``arch`` (2 layers, float32): a prefill of 16 tokens with
    serving specs on a 2x2 mesh of 4 gloo processes, the caches seeded on
    each rank's batch and KV heads (``attention.seed_kv_cache`` on
    DTensors), recurrent states and cross caches on each rank's shards;
    gathered logits and every cache tensor within ``DECODE_TOL`` of one
    process's."""
    arch, _, dispatch = arch.partition("/")
    res = td.spawn(4, "prefill", tmp_path, arch=arch, n_layers=2,
                   mesh=[2, 2], dispatch=dispatch or None)
    # per layer: k and v; whisper's cross k and v besides; xlstm's mLSTM
    # C, n, m and conv state
    n_caches = {"whisper-small": 8, "xlstm-1.3b": 8}.get(arch, 4)
    for r in res:
        assert r["prefill_err"] < DECODE_TOL, res
        assert r["cache_err"] < DECODE_TOL, res
        assert r["n_caches"] == n_caches
        assert r["cache_placements"] == cache_pl
        assert r["pos"] == 16


@pytest.mark.parametrize("arch,mesh,cache_pl", [
    ("yi-6b", (2, 2), ["S(0)", "S(1)"]),         # batch, kv heads (4 / 2)
    ("qwen2-0.5b", (1, 4), ["S(0)", "S(2)"])]    # 2 kv heads: the sequence
    + [(a, (2, 2), pl) for a, pl in SERVE_KINDS])
def test_sharded_decode_matches_one_process(tmp_path, arch, mesh, cache_pl):
    """Reduced ``arch`` (2 layers, float32): 4 decode steps with serving
    specs and every cache tensor under ``cache_specs`` on 4 gloo
    processes; qwen2's cache is split over its sequence, written on the
    shard that holds the slot, and gathered for the attention (14 / 2
    heads do not split); xlstm's recurrent states and whisper's cross
    caches are stepped on each rank's shards."""
    arch, _, dispatch = arch.partition("/")
    res = td.spawn(4, "decode", tmp_path, arch=arch, n_layers=2,
                   mesh=list(mesh), dispatch=dispatch or None)
    for r in res:
        assert max(r["step_errs"]) < DECODE_TOL, res
        assert r["cache_placements"] == cache_pl
        assert r["pos"] == 16 + 4
