"""The dry run (``repro_torch.launch.dryrun``) of the cross-attention kinds
on a fake 2x8 mesh, whose 'model' extent of 8 divides neither model's heads
at its reduced configuration: before the hidden state was reduced over
'model' ahead of the cross attention's norm, their decode step failed
there (an in-place add that needs a placement change).  The checks are
``tests/test_torch_dryrun_kinds.py``'s: every cell ``ok``, no launch, the
flash calls of one process on each rank.

whisper-small runs at 2 layers (and its 2 encoder layers);
llama-3.2-vision at 5, one period of its block pattern, the least depth
that holds its cross-attention layer.
"""
import pytest

from tests.test_torch_dryrun_kinds import KINDS, check_cells

CASES = [
    ("whisper-small", 2, "2x8", KINDS),
    ("llama-3.2-vision-11b", 5, "2x8", ["prefill", "decode"]),
]


@pytest.mark.parametrize("arch,n_layers,mesh,kinds", CASES,
                         ids=[c[0] for c in CASES])
def test_cross_attention_cells_trace_on_a_mesh(arch, n_layers, mesh, kinds,
                                               tmp_path):
    check_cells(arch, n_layers, mesh, kinds, tmp_path)
