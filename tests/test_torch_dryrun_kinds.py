"""The dry run (``repro_torch.launch.dryrun``) of the MoE and xLSTM kinds
on a fake 2x4 mesh: every cell of their steps traces on meta DTensors,
launches no kernel, and prefill runs the hand flash kernel on each rank's
heads as it does unsharded (``tests/test_torch_dryrun_cross.py``: the
cross-attention kinds on 2x8).

Each run is the command line in a process of its own (a fake process group
is process-wide), killed at ``TIMEOUT``, at a reduced configuration of 2
layers, B 8 x S 128, on meshes of at most 16 fake ranks.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
CELL = ["--batch", "8", "--seq", "128"]
KINDS = ["train", "prefill", "decode"]

CASES = [
    ("moonshot-v1-16b-a3b", 2, "2x4", KINDS),
    ("llama4-scout-17b-16e", 2, "2x4", KINDS),
    ("xlstm-1.3b", 2, "2x4", KINDS),
]


def run_cli(arch, n_layers, args, out: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--reduced", "--n-layers", str(n_layers), *args, "--json", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=TIMEOUT)
    reps = json.loads(out.read_text()) if out.exists() else []
    assert proc.returncode == 0, (
        [r["error"] for r in reps if not r["ok"]],
        proc.stdout[-2000:] + proc.stderr[-2000:])
    return reps


def check_cells(arch, n_layers, mesh, kinds, tmp_path):
    reps = run_cli(arch, n_layers, CELL + ["--kind", *kinds,
                                           "--mesh", mesh],
                   tmp_path / "d.json")
    assert [r["options"]["kind"] for r in reps] == kinds
    for r in reps:
        assert r["ok"], r["error"]
        assert r["mesh"] == mesh and r["collectives"]
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert r["launches"] == {"matmul": 0, "flash_attention": 0,
                                 "flash_attention_bwd": 0}
        # a rank runs every call that one process runs, on its own heads
        assert r["kernel_calls_per_device"] == r["kernel_calls"]
        if r["options"]["kind"] == "prefill" and arch != "xlstm-1.3b":
            assert r["kernel_calls"]["flash_attention"] > 0


@pytest.mark.parametrize("arch,n_layers,mesh,kinds", CASES,
                         ids=[c[0] for c in CASES])
def test_every_cell_traces_on_a_mesh(arch, n_layers, mesh, kinds, tmp_path):
    check_cells(arch, n_layers, mesh, kinds, tmp_path)
