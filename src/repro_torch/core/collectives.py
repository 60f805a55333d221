"""Collective-communication op IR and the analytical α–β (Hockney) latency
model: a numpy copy of the JAX package's ``core/collectives.py``, which
gives bit-identical times from the same interconnect.

Every collective is costed from two interconnect constants,

    α  — per-message link latency (seconds/hop), ``Interconnect.link_latency``
    β  — inverse bus bandwidth (seconds/byte), 1 / ``Interconnect.bus_bw(p)``

with the standard ring and binomial-tree algorithm costs and a per-world
bus-bandwidth correction (protocol efficiency decays with world size, per
topology).  Ring or tree is selected by message size: small messages are
latency-bound (tree wins, fewer rounds), large messages bandwidth-bound
(ring wins, optimal volume).

Cost formulas (n = FULL tensor bytes, p = world size, B = bus bandwidth):

    ring  all-reduce       2(p-1)·α + 2·n·(p-1)/p / B
    ring  all-gather       (p-1)·α  +   n·(p-1)/p / B      (reduce-scatter =)
    ring  broadcast        (p-1)·α  +   n / B              (pipelined)
    ring  all-to-all       (p-1)·α  +   n·(p-1)/p / B      (pairwise exchange)
    tree  all-reduce       2·⌈log2 p⌉·(α + n/B)
    tree  all-gather       ⌈log2 p⌉·α + n·(p-1)/p / B      (recursive doubling)
    tree  broadcast        ⌈log2 p⌉·(α + n/B)
    tree  all-to-all       ⌈log2 p⌉·(α + (n/2)/B)          (Bruck)
    p2p                    α + n/B

The measured α–β fit lives in ``core/comm_calibrate.py``: predictors ask
``calibrated_interconnect``, which falls back to ``interconnect_for``'s
datasheet interconnect without an artifact.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.device import STRICT_DTYPE_ENV

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
               "all_to_all", "p2p")
TOPOLOGIES = ("nvlink-mesh", "pcie-tree", "ethernet")

_DTYPE_BYTES = {"float32": 4, "tf32": 4, "bfloat16": 2, "float16": 2,
                "int8": 1, "fp8": 1, "float64": 8}
_WARNED_DTYPES: set = set()

# Bus-bandwidth correction per world size: effective bandwidth decays as
# eff(p) = 1 / (1 + γ·log2(p)), more steeply on shared trees than on
# dedicated meshes.
_EFF_GAMMA: Dict[str, float] = {
    "nvlink-mesh": 0.03,
    "pcie-tree": 0.12,
    "ethernet": 0.25,
}


def dtype_bytes(dtype: str, *, strict: Optional[bool] = None) -> int:
    """Element size in bytes, with a LOUD fallback: an unknown dtype is
    priced as float32 (4 bytes) — so warn (once per dtype), and raise when
    strict (arg or ``REPRO_STRICT_DTYPE=1``), the same policy as
    ``DeviceProfile.peak()``."""
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


@dataclasses.dataclass(frozen=True)
class Interconnect:
    """The α–β spec of one device's links (per direction).  ``topology``
    selects how per-link bandwidth aggregates into bus bandwidth: a mesh
    drives all ``links_per_gpu`` at once during a ring step, a PCIe tree or
    an ethernet NIC funnels everything through one shared upstream link."""
    topology: str            # 'nvlink-mesh' | 'pcie-tree' | 'ethernet'
    link_bw: float           # bytes/s per link, per direction (1/β per link)
    link_latency: float      # α: seconds per message hop
    links_per_gpu: int = 1
    # measured efficiency decay γ; None keeps the per-topology _EFF_GAMMA
    eff_gamma: Optional[float] = None

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}; "
                             f"expected one of {TOPOLOGIES}")
        if self.link_bw <= 0 or self.link_latency < 0 or self.links_per_gpu < 1:
            raise ValueError(f"invalid Interconnect: {self}")
        if self.eff_gamma is not None and self.eff_gamma < 0:
            raise ValueError(f"invalid Interconnect: {self}")

    @classmethod
    def from_fit(cls, fit) -> "Interconnect":
        """Build from a measured fit record (anything with ``topology``,
        ``link_bw``, ``link_latency``, ``links_per_gpu`` and ``eff_gamma``):
        the fitted α, β and γ replace the datasheet constants wholesale."""
        return cls(topology=str(fit.topology), link_bw=float(fit.link_bw),
                   link_latency=float(fit.link_latency),
                   links_per_gpu=int(fit.links_per_gpu),
                   eff_gamma=float(fit.eff_gamma))

    def raw_bus_bw(self) -> float:
        """Aggregate per-GPU injection bandwidth, before the world-size
        efficiency correction."""
        if self.topology == "nvlink-mesh":
            return self.link_bw * self.links_per_gpu
        return self.link_bw   # tree/NIC: one shared upstream path

    def gamma(self) -> float:
        """The efficiency-decay constant in effect: ``eff_gamma`` when set,
        the topology default otherwise."""
        if self.eff_gamma is not None:
            return self.eff_gamma
        return _EFF_GAMMA[self.topology]

    def efficiency(self, world):
        """Achieved fraction of ``raw_bus_bw`` at world size ``world``
        (continuous in ``world``).  Scalar ``world`` returns a ``float``,
        array ``world`` an ``np.ndarray``."""
        g = self.gamma()
        p = np.maximum(np.asarray(world, np.float64), 1.0)
        eff = 1.0 / (1.0 + g * np.log2(p))
        if np.ndim(world) == 0:
            return float(eff)
        return eff

    def bus_bw(self, world):
        """Effective bytes/s per GPU at world size ``world`` (the B in the
        module formulas); same scalar/array contract as ``efficiency``."""
        return self.raw_bus_bw() * self.efficiency(world)


# The default for devices with no registered interconnect: ~10 GbE with
# typical RDMA-less round-trip latency.
DEFAULT_INTERCONNECT = Interconnect("ethernet", link_bw=1.25e9,
                                    link_latency=25e-6, links_per_gpu=1)


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


# ---------------------------------------------------------------------------
# algorithm costs (vectorized over nbytes/world)
# ---------------------------------------------------------------------------

def _ring_time(coll: str, n, p, alpha: float, B) -> np.ndarray:
    n, p = np.asarray(n, np.float64), np.asarray(p, np.float64)
    steps = p - 1.0
    frac = np.divide(steps, p, out=np.zeros_like(p), where=p > 0)
    if coll == "all_reduce":
        return 2.0 * steps * alpha + 2.0 * n * frac / B
    if coll in ("all_gather", "reduce_scatter", "all_to_all"):
        # all-to-all: pairwise exchange, p-1 rounds of n/p bytes each
        return steps * alpha + n * frac / B
    if coll == "broadcast":
        return steps * alpha + n / B
    if coll == "p2p":
        return np.full_like(n, alpha) + n / B
    raise ValueError(f"unknown collective {coll!r}")


def _tree_time(coll: str, n, p, alpha: float, B) -> np.ndarray:
    n, p = np.asarray(n, np.float64), np.asarray(p, np.float64)
    rounds = np.ceil(np.log2(np.maximum(p, 1.0)))
    frac = np.divide(p - 1.0, p, out=np.zeros_like(p), where=p > 0)
    if coll == "all_reduce":
        return 2.0 * rounds * (alpha + n / B)
    if coll in ("all_gather", "reduce_scatter"):
        return rounds * alpha + n * frac / B
    if coll == "broadcast":
        return rounds * (alpha + n / B)
    if coll == "all_to_all":
        # Bruck: ⌈log2 p⌉ rounds, each moving half the local payload
        return rounds * (alpha + 0.5 * n / B)
    if coll == "p2p":
        return np.full_like(n, alpha) + n / B
    raise ValueError(f"unknown collective {coll!r}")


def collective_time(coll: str, nbytes, world, ic: Interconnect,
                    algorithm: Optional[str] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Seconds (and the selected algorithm) for one collective of ``nbytes``
    full-tensor bytes over ``world`` ranks on ``ic``.  Vectorized: ``nbytes``
    and ``world`` broadcast; a world of 1 costs exactly 0.  Without an
    explicit ``algorithm`` the cheaper of ring/tree is selected per entry."""
    nbytes, world = np.broadcast_arrays(np.asarray(nbytes, np.float64),
                                        np.asarray(world, np.float64))
    B = ic.bus_bw(world)
    alpha = ic.link_latency
    if algorithm == "ring":
        t = _ring_time(coll, nbytes, world, alpha, B)
        algos = np.full(nbytes.shape, "ring", object)
    elif algorithm == "tree":
        t = _tree_time(coll, nbytes, world, alpha, B)
        algos = np.full(nbytes.shape, "tree", object)
    elif algorithm is None:
        ring = _ring_time(coll, nbytes, world, alpha, B)
        tree = _tree_time(coll, nbytes, world, alpha, B)
        t = np.minimum(ring, tree)
        algos = np.where(ring <= tree, "ring", "tree").astype(object)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    trivial = world <= 1.0
    t = np.where(trivial, 0.0, t)
    algos = np.where(trivial, "none", algos)
    return t, algos


def predict_collective(op: CollectiveOp, ic: Interconnect,
                       algorithm: Optional[str] = None
                       ) -> Tuple[float, str]:
    """(seconds, algorithm) for one ``CollectiveOp`` — seconds include the
    op's repetition ``count``."""
    t, algo = collective_time(op.coll, op.nbytes, op.world, ic, algorithm)
    return float(t) * op.count, str(algo)


def p2p_time(nbytes: float, ic: Interconnect) -> float:
    """One point-to-point activation hand-off: α + n/B."""
    t, _ = collective_time("p2p", nbytes, 2, ic)
    return float(t)


# ---------------------------------------------------------------------------
# registry plumbing
# ---------------------------------------------------------------------------

def interconnect_for(device: Optional[str]) -> Interconnect:
    """The interconnect of a registered device, ``DEFAULT_INTERCONNECT`` for
    unknown/unregistered names (or profiles without one)."""
    if device is None:
        return DEFAULT_INTERCONNECT
    from repro_torch.core import devices as D
    try:
        prof = D.get_profile(device)
    except KeyError:
        return DEFAULT_INTERCONNECT
    return getattr(prof, "interconnect", None) or DEFAULT_INTERCONNECT


def slowest_interconnect(*devices: Optional[str]) -> Interconnect:
    """The bottleneck interconnect among ``devices`` (lowest raw bus
    bandwidth) — a cross-device transfer moves at the slower endpoint."""
    ics = [interconnect_for(d) for d in devices] or [DEFAULT_INTERCONNECT]
    return min(ics, key=lambda ic: ic.raw_bus_bw())
