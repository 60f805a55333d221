"""Assigned input-shape cells and (arch x shape) applicability.

Each LM shape is (seq_len, global_batch).  ``train_4k`` lowers train_step;
``prefill_32k`` lowers a prefill serve step; ``decode_32k``/``long_500k`` lower
serve_step (one new token against a KV cache of seq_len).

``long_500k`` requires a sub-quadratic decode path: it runs only for the
SSM/hybrid archs (xlstm-1.3b, recurrentgemma-2b) whose decode state is O(1)
(plus a bounded local-attention window).  For the 8 pure full-attention archs
it is skipped — see DESIGN.md §5.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCell("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeCell, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}

# Archs with a sub-quadratic long-context decode path.
SUBQUADRATIC_ARCHS = frozenset({"xlstm-1.3b", "recurrentgemma-2b"})


def applicable(arch_name: str, shape: ShapeCell) -> bool:
    if shape.name == "long_500k":
        return arch_name in SUBQUADRATIC_ARCHS
    return True


def cells(arch_names):
    """All applicable (arch, shape) cells, in a stable order."""
    out = []
    for a in arch_names:
        for s in ALL_SHAPES:
            if applicable(a, s):
                out.append((a, s))
    return out
