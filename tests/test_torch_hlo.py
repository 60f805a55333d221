"""The port's collective and memory accounting (``repro_torch/core/hlo.py``)
against the JAX package's ``core/hlo.py``: the ring formulas bit for bit
on synthetic HLO lines, the stats' layout, and the memory summary.

No process group is started here: the counter's runs on a fake mesh are
``tests/test_torch_dryrun.py``'s, in subprocesses."""
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import hlo
from repro_torch.core import jaxpr_cost as jc

GROUPS = (1, 2, 8, 256)


def _line(kind: str, g: int) -> str:
    """One optimized-HLO line of ``kind`` over groups of ``g`` devices:
    bf16 operands, f32 for the all-reduce and the permute."""
    groups = f"replica_groups=[{256 // g},{g}]<=[256]"
    if kind == "all-gather":
        return (f"  %ag = bf16[{64 * g},896]{{1,0}} all-gather(bf16[64,896]"
                f"{{1,0}} %p), channel_id=1, {groups}, dimensions={{0}}")
    if kind == "reduce-scatter":
        return (f"  %rs = f32[64,4864]{{1,0}} reduce-scatter(f32[{64 * g},"
                f"4864]{{1,0}} %g), channel_id=2, {groups}, dimensions={{0}},"
                f" to_apply=%add")
    if kind == "all-reduce":
        return (f"  %ar = f32[151936,56]{{1,0}} all-reduce(f32[151936,56]"
                f"{{1,0}} %x), channel_id=3, {groups}, to_apply=%add")
    if kind == "all-to-all":
        return (f"  %a2a = bf16[8,512,14,64]{{3,2,1,0}} all-to-all(bf16[8,512,"
                f"14,64]{{3,2,1,0}} %y), channel_id=4, {groups}, "
                f"dimensions={{2}}")
    return (f"  %cp = f32[3,1024]{{1,0}} collective-permute(f32[3,1024]{{1,0}}"
            f" %z), channel_id=5, source_target_pairs={{{{0,1}},{{1,0}}}}")


def _shape_bytes(text: str) -> int:
    dt, dims = text.split("[")
    n = 1
    for d in dims.rstrip("]").split(","):
        n *= int(d)
    return n * {"bf16": 2, "f32": 4}[dt]


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("kind", hlo.COLLECTIVES)
def test_ring_formula_bit_equal_to_reference(kind, g):
    """``accumulate`` on the operand and output bytes and group size of a
    line gives the reference's ``collective_stats`` of that line, bit for
    bit (a permute has no replica groups: group 1)."""
    rhlo = pytest.importorskip("repro.core.hlo")
    line = _line(kind, g)
    want = rhlo.collective_stats("ENTRY %main () -> f32[] {\n" + line
                                 + "\n}").by_kind
    lhs, call = line.split(f" {kind}(")
    out_bytes = _shape_bytes(lhs.split("= ")[1].split("{")[0])
    operand = _shape_bytes(call.split("{")[0])
    got = hlo.empty_stats().by_kind
    hlo.accumulate(got, kind, operand, out_bytes,
                   1 if kind == "collective-permute" else g)
    assert got == want
    assert all(type(x) is int for x in got[kind])


@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter"])
def test_ring_formula_recovers_a_missing_operand(kind):
    """An operand of 0 bytes is recovered from the output, as the
    reference does for lines printed without operand types."""
    rhlo = pytest.importorskip("repro.core.hlo")
    line = {"all-gather": "  %ag = bf16[512,896]{1,0} all-gather(%p), "
                          "replica_groups=[32,8]<=[256], dimensions={0}",
            "reduce-scatter": "  %rs = f32[64,896]{1,0} reduce-scatter(%g), "
                              "replica_groups=[32,8]<=[256], to_apply=%add"
            }[kind]
    want = rhlo.collective_stats("ENTRY %m () -> f32[] {\n" + line + "\n}")
    got = hlo.empty_stats().by_kind
    out = 512 * 896 * 2 if kind == "all-gather" else 64 * 896 * 4
    hlo.accumulate(got, kind, 0, out, 8)
    assert got == want.by_kind


def test_stats_layout_and_properties():
    stats = hlo.empty_stats()
    assert set(stats.by_kind) == set(hlo.COLLECTIVES)
    hlo.accumulate(stats.by_kind, "all-gather", 100, 800, 8)
    hlo.accumulate(stats.by_kind, "all-reduce", 64, 64, 4)
    assert stats.total_count == 2
    assert stats.total_operand_bytes == 164
    assert stats.total_ici_bytes == int(7 / 8 * 800) + int(2 * 3 / 4 * 64)
    assert "all-gather: n=1" in stats.summary()
    assert hlo.empty_stats().summary() == "none"


def test_memory_summary_counts_arguments_outputs_and_aliases():
    p = torch.empty((64, 32), device="meta")
    m = torch.empty((64, 32), device="meta")
    tok = torch.empty((8, 16), dtype=torch.int64, device="meta")
    new = torch.empty((), device="meta")
    mem = hlo.memory_summary(({"w": p}, {"m": m}, tok), ({"w": p}, new))
    assert mem == {"argument_size_in_bytes": 2 * 64 * 32 * 4 + 8 * 16 * 8,
                   "output_size_in_bytes": 64 * 32 * 4 + 4,
                   "alias_size_in_bytes": 64 * 32 * 4}
    assert "temp_size_in_bytes" not in mem


def test_cost_summary_reads_the_counter():
    c = jc.count(lambda a, b: torch.exp(a @ b),
                 torch.empty((16, 8), device="meta"),
                 torch.empty((8, 4), device="meta"))
    s = hlo.cost_summary(c)
    assert s["flops"] == 2 * 16 * 8 * 4 + 16 * 4
    assert s["transcendentals"] == 16 * 4
    assert s["bytes"] == c.cost.bytes


def test_counter_ignores_plain_ops():
    """Without a process group nothing is a collective: the counter sees
    plain ops and counts none."""
    with hlo.CollectiveCounter() as cc:
        x = torch.empty((8, 8), device="meta")
        (x @ x).sum()
    assert cc.stats.total_count == 0
    assert not isinstance(x, DTensor)
