"""Collective-communication op IR: the part of the JAX package's
``core/collectives.py`` that the op graph needs (``CollectiveOp`` and
``dtype_bytes``).  The α–β cost model comes with the collectives slice.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

from repro_torch.core.device import STRICT_DTYPE_ENV

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
               "all_to_all", "p2p")

_DTYPE_BYTES = {"float32": 4, "tf32": 4, "bfloat16": 2, "float16": 2,
                "int8": 1, "fp8": 1, "float64": 8}
_WARNED_DTYPES: set = set()


def dtype_bytes(dtype: str, *, strict: Optional[bool] = None) -> int:
    """Element size in bytes, with a LOUD fallback: an unknown dtype is
    priced as float32 (4 bytes) — so warn (once per dtype), and raise when
    strict (arg or ``REPRO_STRICT_DTYPE=1``), the same policy as
    ``DeviceModel.peak()``."""
    dt = str(dtype)
    if dt in _DTYPE_BYTES:
        return _DTYPE_BYTES[dt]
    if strict is None:
        strict = os.environ.get(STRICT_DTYPE_ENV, "") not in ("", "0")
    msg = (f"dtype_bytes: unknown dtype {dt!r} "
           f"(known: {sorted(_DTYPE_BYTES)})")
    if strict:
        raise KeyError(msg)
    if dt not in _WARNED_DTYPES:
        _WARNED_DTYPES.add(dt)
        warnings.warn(f"{msg}; assuming float32 (4 bytes)", stacklevel=2)
    return 4


@dataclasses.dataclass
class CollectiveOp:
    """One communication step in the op graph.  ``nbytes`` is the FULL
    (unsharded) tensor payload."""
    name: str
    coll: str                 # one of COLLECTIVES
    nbytes: float             # full tensor payload in bytes
    world: int
    count: int = 1
    dtype: str = "float32"
    kind: str = "collective"

    def __post_init__(self):
        if self.coll not in COLLECTIVES:
            raise ValueError(f"unknown collective {self.coll!r}; "
                             f"expected one of {COLLECTIVES}")
