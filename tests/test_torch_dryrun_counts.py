"""What the dry run counts on a fake mesh, against what it counts without
one (``tests/_torch_meta_count.py``, each in a process of its own, killed
at ``TIMEOUT``):

  - expert parallelism: on 2x4 the experts of reduced moonshot-v1-16b-a3b
    lie over 'model' (4 ranks) and its groups over 'data' (2), so each
    device's expert products are exactly an eighth of the global count, in
    both dispatch modes;
  - the recurrent loops priced as the reference prices a scan: run once
    and counted as many times as they have trips (``jaxpr_cost.scan``,
    installed by the counter in ``core/cost.loop_trips``),
    the sLSTM scan and the mLSTM chunk loop count exactly what every
    iteration counts (flops, bytes, transcendentals, collectives), at
    reduced xlstm-1.3b (2 layers, one of each kind), S 256 (two mLSTM
    chunks), on 2x4 and without a mesh.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120


def count(**spec) -> dict:
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_meta_count.py"),
         json.dumps(spec)], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dispatch,kind", [("einsum", "prefill"),
                                           ("gather", "prefill"),
                                           ("einsum", "decode")])
def test_expert_flops_split_over_the_mesh(dispatch, kind):
    got = count(what="experts", arch="moonshot-v1-16b-a3b", n_layers=2,
                batch=8, seq=128, kind=kind, mesh="2x4", dispatch=dispatch)
    assert got["ok"], got["error"]
    assert got["global"] > 0
    assert got["device"] * 8 == got["global"]


def test_scanned_loops_count_every_iteration():
    full = count(what="scan", n_layers=2, batch=8, seq=256, kind="prefill",
                 full=True)
    scanned = count(what="scan", n_layers=2, batch=8, seq=256,
                    kind="prefill", full=False)
    for mesh in ("2x4", "none"):
        assert full[mesh]["ok"], full[mesh]["error"]
        assert scanned[mesh] == full[mesh], mesh
        # S 256: the sLSTM's 256 steps and the mLSTM's two chunks, once
        # each where scanned
        assert full["loops"][mesh] == [[2, 2], [256, 256]], full["loops"]
        assert scanned["loops"][mesh] == [[2, 1], [256, 1]], \
            scanned["loops"]
    assert full["2x4"]["collectives"] and not full["none"]["collectives"]
    assert full["none"]["jaxpr_transcendentals_global"] > 0
