"""The port's dry run (``repro_torch/launch/dryrun.py``) and roofline
benchmark (``repro_torch/benchmarks/roofline.py``).

A fake process group is process-wide state, so no test starts one here:
every run on a fake mesh is a ``python -m repro_torch.launch.dryrun``
subprocess with a timeout, killed on expiry, at a reduced configuration
(2 layers), S <= 128 and meshes of at most 8 ranks.  The production (32,
8) mesh runs only from the command line and on the card."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry as cr
from repro_torch.configs import shapes as shp
from repro_torch.core.devices.profiles import H100_SXM
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import specs as sp
from repro_torch.launch import dryrun
from repro_torch.models import registry as mr

ROOT = Path(__file__).resolve().parents[1]
ARCH, N_LAYERS, B, S = "qwen2-0.5b", 2, 8, 128
TIMEOUT = 120


def run_cli(args, out: Path) -> list:
    """The dry run's command line in a process of its own (killed at
    TIMEOUT); its JSON reports."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--reduced", "--n-layers", str(N_LAYERS), *args, "--json", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def train_reports(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "dryrun_train.json"
    cell = ["--batch", str(B), "--seq", str(S)]
    reps = run_cli(cell + ["--mesh", "8x1", "2x4", "1x1"], out)
    reps += run_cli(cell + ["--device-mesh", "none"],
                    out.with_name("dryrun_none.json"))
    out.write_text(json.dumps(reps))
    return {r["mesh"]: r for r in reps}, out


@pytest.fixture(scope="module")
def serve_reports(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_serve") / "dryrun_serve.json"
    return run_cli(["--batch", str(B), "--seq", str(S), "--kind", "prefill",
                    "decode", "--mesh", "2x4"], out)


def _cfg():
    return cr.reduced(ARCH, n_layers=N_LAYERS)


def test_every_cell_traced(train_reports, serve_reports):
    reps, _ = train_reports
    assert set(reps) == {"8x1", "2x4", "1x1", "none"}
    for r in list(reps.values()) + serve_reports:
        assert r["ok"], r["error"]
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert r["jaxpr_flops_global"] > 0
        assert r["n_params"] == _cfg().param_count()
    for r in list(reps.values()) + serve_reports:
        assert r["launches"] == {"matmul": 0, "flash_attention": 0,
                                 "flash_attention_bwd": 0}
    for r in reps.values():
        # remat runs each layer's forward again in the backward
        assert r["kernel_calls"] == {"flash_attention": 2 * N_LAYERS,
                                     "flash_attention_bwd": N_LAYERS}
        assert r["kernel_calls_per_device"] == r["kernel_calls"]
    for r in serve_reports:
        assert r["collectives"], r["shape"]
    assert serve_reports[0]["kernel_calls"] == {"flash_attention": N_LAYERS}
    assert serve_reports[1]["kernel_calls"] == {}


@pytest.mark.parametrize("mesh", ["8x1", "2x4"])
def test_per_device_flops_cover_the_global_count(train_reports, mesh):
    r = train_reports[0][mesh]
    assert r["flops_per_device"] * 8 >= r["jaxpr_flops_global"]
    assert r["flops_per_device"] < r["jaxpr_flops_global"]


def test_one_device_mesh_is_the_unsharded_count(train_reports):
    """At 1x1 the local shards are the whole tensors: no collective, the
    same arguments, the same kernel calls, the same flops but for the
    label logit DTensor's path takes (``objective._label_logit``)."""
    reps, _ = train_reports
    one, none = reps["1x1"], reps["none"]
    assert one["collectives"] == {} and none["collectives"] == {}
    assert one["memory"] == none["memory"]
    assert one["flops_per_device"] == pytest.approx(none["flops_per_device"],
                                                    rel=1e-3)


def _shard_specs(mesh_shape):
    model = mr.build(_cfg(), device="meta")
    with sh.mesh_context(sh.MeshShape(mesh_shape, ("data", "model"))):
        specs = sp.params_specs(model)
    ext = dict(zip(("data", "model"), mesh_shape))

    def parts(spec):
        n = 1
        for e in spec:
            for a in (() if e is None else (e,) if isinstance(e, str) else e):
                n *= ext[a]
        return n

    return {k: (p, parts(specs[k])) for k, p in model.named_parameters()}


def _operand_bytes(key: str, dtype: str = "float32") -> int:
    """Bytes of a ``dtype[shape]`` collective operand key."""
    shape = json.loads(key[len(dtype):])
    return math.prod(shape) * torch.empty((), dtype=getattr(torch, dtype)
                                          ).element_size()


def test_gradient_reduce_scatters_match_the_specs(train_reports):
    """On 8x1 each parameter's f32 gradient is laid out as ``params_specs``
    lays the parameter out: one reduce-scatter of the whole gradient over
    the 8 ranks where it is sharded over 'data', one all-reduce where it
    is replicated.  Two exceptions, named: the tied embedding is
    reduce-scattered once for each of its two uses (the lookup and the
    logits head), inside the backward, before autograd sums them; and
    ``wq.b``'s gradient needs none, since DTensor's backward already
    gives it replicated (the q projection's gradient reaches the bias add
    whole on every rank).  Every other reduce-scatter is of a bf16
    activation (B, S, ...): a product that contracts over the
    FSDP-sharded d_model, reduce-scattered onto the batch shard."""
    r = train_reports[0]["8x1"]
    specs = _shard_specs((8, 1))
    grad = {k: p.numel() * 4 for k, (p, n) in specs.items()}
    want_rs = Counter(grad[k] for k, (_, n) in specs.items() if n > 1)
    want_rs[grad["embed.w"]] += 1
    want_ar = Counter(grad[k] for k, (_, n) in specs.items()
                      if n == 1 and not k.endswith("attn.wq.b"))
    assert sum(want_rs.values()) == N_LAYERS * 7 + 2
    assert sum(want_ar.values()) == N_LAYERS * 4 + 1
    ops = r["collective_operands"]
    got_rs, got_ar, other = Counter(), Counter(), Counter()
    for kind, got in (("reduce-scatter", got_rs), ("all-reduce", got_ar)):
        for key, n in ops[kind].items():
            if key.startswith("float32[") and key != "float32[]":
                got[_operand_bytes(key)] += n
            else:
                other[(kind, key)] += n
    assert got_rs == want_rs and got_ar == want_ar, (ops, want_rs, want_ar)
    for (kind, key), n in other.items():
        if kind == "reduce-scatter":
            assert key.startswith(f"bfloat16[{B}, {S}, "), key
        else:        # the grad norm's and the metrics' scalars, activations
            assert key == "float32[]" or key.startswith("bfloat16["), key
    rs = r["collectives"]["reduce-scatter"]
    act = sum(_operand_bytes(k[1], "bfloat16") * n for k, n in other.items()
              if k[0] == "reduce-scatter")
    assert rs[0] == sum(want_rs.values()) + sum(
        n for k, n in other.items() if k[0] == "reduce-scatter")
    assert rs[1] == sum(b * n for b, n in want_rs.items()) + act
    assert rs[2] == sum(int(7 / 8 * b) * n for b, n in want_rs.items()) + \
        sum(int(7 / 8 * _operand_bytes(k[1], "bfloat16")) * n
            for k, n in other.items() if k[0] == "reduce-scatter")


@pytest.mark.parametrize("mesh", ["8x1", "2x4", "none"])
def test_argument_bytes_are_the_local_shards(train_reports, mesh):
    """Parameters, both moments (f32), the step and the batch, each a
    device's share as the specs lay it out."""
    r = train_reports[0][mesh]
    dims = (1, 1) if mesh == "none" else tuple(map(int, mesh.split("x")))
    state = sum(p.numel() // n * 4 * 3
                for p, n in _shard_specs(dims).values())
    batch = 2 * (B // dims[0]) * S * 8
    assert r["memory"]["argument_size_in_bytes"] == state + 4 + batch
    assert r["memory"]["alias_size_in_bytes"] == state


def test_roofline_terms_by_hand(train_reports):
    r = train_reports[0]["2x4"]
    rep = dryrun.CellReport(**r)
    for dtype in ("bfloat16", "float32"):
        t = dryrun.roofline_terms(rep, H100_SXM, dtype)
        want = {"compute_s": r["flops_per_device"] / H100_SXM.peak_flops[dtype],
                "memory_s": r["bytes_per_device"] / 3350e9,
                "collective_s": r["ici_bytes"] / 450e9}
        for k, v in want.items():
            assert t[k] == pytest.approx(v, rel=1e-12)
        assert t["step_s_lower_bound"] == max(want.values())
        assert t["dominant"] == max(want, key=want.get)[:-2]


def test_roofline_benchmark_writes_markdown(train_reports, tmp_path):
    from repro_torch.benchmarks import roofline
    _, path = train_reports
    (tmp_path / "dryrun_train.json").write_text(path.read_text())
    rows = roofline.run(out_dir=str(tmp_path))
    assert len(rows) == 4 and all(r["ok"] for r in rows)
    md = (tmp_path / "roofline.md").read_text()
    assert md.startswith("## train") and md.count("| qwen2-0.5b |") == 4
    shape = shp.ShapeCell("train_8x128", S, B, "train")
    assert rows[0]["model_flops"] == 6.0 * _cfg().active_param_count() * B * S
    assert roofline.model_flops(ARCH, shape) == \
        6.0 * cr.get(ARCH).active_param_count() * B * S


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_roofline_benchmark_uses_the_dry_runs_terms(train_reports, dtype):
    """The benchmark's terms are ``roofline_terms``' on the per-device counts
    at the cell's compute dtype's peak; its global column is the JAX
    package's compute term."""
    from repro_torch.benchmarks import roofline
    reps = [dict(r, options=dict(r["options"], compute_dtype=dtype))
            for r in train_reports[0].values()]
    for rep, row in zip(reps, roofline.analyze(reps)):
        t = dryrun.roofline_terms(dryrun.CellReport(**rep), H100_SXM, dtype)
        assert row["dtype"] == dtype and row["dominant"] == t["dominant"]
        for k in ("compute_s", "memory_s", "collective_s"):
            assert row[k] == t[k]
        assert row["step_lower_bound_s"] == t["step_s_lower_bound"]
        chips = dryrun.mesh_devices(rep["mesh"])
        assert row["compute_s_global"] == pytest.approx(
            rep["jaxpr_flops_global"] / chips / H100_SXM.peak_flops[dtype],
            rel=1e-12)


@pytest.mark.parametrize("knob", dryrun.MISSING_KNOBS)
def test_missing_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match=knob):
        dryrun.lower_cell(ARCH, "train_4k", cfg=_cfg(), **{knob: 64},
                          verbose=False)


def test_decode_write_knob_raises(monkeypatch):
    monkeypatch.setenv("REPRO_DECODE_WRITE", "where")
    with pytest.raises(NotImplementedError, match="REPRO_DECODE_WRITE"):
        dryrun.lower_cell(ARCH, "decode_32k", cfg=_cfg(), verbose=False)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_are_meta(kind):
    """Every input of the cell on meta at its full shape, nothing drawn."""
    shape = shp.ShapeCell("c", 4096, 64, kind)
    spec = dryrun.input_specs(ARCH, shape, cfg=_cfg())
    tensors = [t for v in spec.values() if isinstance(v, dict)
               for t in v.values()]
    if kind == "train":
        assert spec["batch"]["tokens"].shape == (64, 4096)
        tensors += list(spec["opt_state"].m.values())
    elif kind == "decode":
        tensors += spec["cache"].tensors()
        assert spec["cache"].k[0].shape[2] == 4096
    else:
        assert spec["tokens"].shape == (64, 4096)
    assert tensors and all(t.is_meta for t in tensors)


def test_mesh_names():
    assert dryrun.mesh_name((32, 8)) == "pod256"
    assert dryrun.mesh_name((2, 32, 8)) == "pod2x256"
    assert dryrun.mesh_name(None) == "none"
    assert dryrun.mesh_devices("2x4") == 8
    assert dryrun.mesh_devices("pod2x256") == 512
    assert dryrun.parse_mesh("2x2x2") == ((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError):
        dryrun.parse_mesh("none")
    rep = dryrun.CellReport(ARCH, "train_4k", "pod256", True,
                            jaxpr_flops_global=256e12,
                            memory={"argument_size_in_bytes": 2 ** 30})
    assert "flops/dev=1.000e+12" in rep.row() and "1.00GiB" in rep.row()
    assert "FAIL" in dataclasses.replace(rep, ok=False, error="x").row()


def test_import_starts_no_process_group():
    assert not torch.distributed.is_initialized()
