"""Pipeline partition planning from predicted per-block latencies (paper
application §IV-D1, generalized; the JAX package's ``core/partition.py``).

Two-device case: single split point minimizing the max stage time (the
paper's heuristic).  N-device case: contiguous min-max partition via binary
search over the bottleneck + greedy feasibility.  The ``*_model`` planners
price the planned stages as a micro-batched pipeline through
``schedule.pipeline_stage_schedule``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import collectives as CC
from repro_torch.core.comm_calibrate import calibrated_interconnect
from repro_torch.core.schedule import pipeline_stage_schedule


@dataclasses.dataclass
class PartitionPlan:
    boundaries: List[int]        # stage i = blocks [boundaries[i], boundaries[i+1])
    stage_times: List[float]
    bottleneck: float
    # schedule-aware cost (filled by the *_model planners): the end-to-end
    # makespan of the planned stages run as a micro-batched pipeline, and
    # the microbatch count it assumed
    makespan: Optional[float] = None
    microbatches: int = 1

    @property
    def split_point(self) -> int:  # two-device convenience
        return self.boundaries[1]


def _attach_makespan(plan: PartitionPlan, pure_stage_times: List[float],
                     mb_handoff: float, microbatches: int) -> PartitionPlan:
    """Price the planned stages as a micro-batched pipeline schedule:
    per-microbatch stage cost is ``stage/mb``, ``mb_handoff`` the
    per-microbatch hand-off on the per-link comm streams."""
    sched = pipeline_stage_schedule(pure_stage_times, mb_handoff,
                                    microbatches=microbatches)
    plan.makespan = sched.makespan
    plan.microbatches = int(microbatches)
    return plan


def _mb_handoff(cfg, batch: int, seq: int, microbatches: int, *,
                derived: bool, comm_cost: float, dtype, device_a,
                device_b) -> float:
    """The per-microbatch stage hand-off: when the full-batch cost was
    derived from the α–β model, re-price it at the microbatch batch
    ``⌈batch/mb⌉`` (the α latency term is paid per transfer); an explicit
    scalar override is opaque, so it is split evenly across microbatches."""
    mb = max(int(microbatches), 1)
    if mb == 1:
        return comm_cost
    if derived:
        return activation_comm_cost(cfg, -(-batch // mb), seq, dtype=dtype,
                                    device_a=device_a, device_b=device_b)
    return comm_cost / mb


def plan_two_devices(lat_a: Sequence[float], lat_b: Sequence[float],
                     comm_cost: float = 0.0) -> PartitionPlan:
    """Device A runs blocks [0, s), device B runs [s, L). lat_a/lat_b are
    per-block latencies of the SAME blocks measured/predicted per device."""
    L = len(lat_a)
    assert len(lat_b) == L
    pre = [0.0]
    for t in lat_a:
        pre.append(pre[-1] + t)
    suf = [0.0]
    for t in reversed(lat_b):
        suf.append(suf[-1] + t)
    suf = suf[::-1]
    best_s, best = 0, float("inf")
    for s in range(L + 1):
        bottleneck = max(pre[s], suf[s] + (comm_cost if 0 < s < L else 0.0))
        if bottleneck < best:
            best, best_s = bottleneck, s
    return PartitionPlan(boundaries=[0, best_s, L],
                         stage_times=[pre[best_s], suf[best_s]],
                         bottleneck=best)


def plan_stages(latencies: Sequence[float], n_stages: int,
                comm_cost: float = 0.0) -> PartitionPlan:
    """Homogeneous devices: contiguous min-max partition (binary search +
    greedy packing).  ``comm_cost`` charges every non-first, non-empty stage
    one activation hand-off inside the min-max search, so the boundaries are
    optimal under the reported cost model."""
    lats = list(latencies)
    lo, hi = max(lats), sum(lats) + comm_cost

    def feasible(cap: float):
        stages, cur, used = [0], 0.0, 1
        budget = cap                      # later stages pay the hand-off
        for i, t in enumerate(lats):
            if cur + t > budget and cur > 0:
                used += 1
                stages.append(i)
                cur = 0.0
                budget = cap - comm_cost
                if used > n_stages or budget <= 0:
                    return None
            if cur == 0.0 and t > budget:
                return None               # one block overflows this stage
            cur += t
        stages.append(len(lats))
        while len(stages) < n_stages + 1:
            stages.insert(-1, stages[-1])
        return stages

    for _ in range(50):
        mid = (lo + hi) / 2
        if feasible(mid) is not None:
            hi = mid
        else:
            lo = mid
    stages = feasible(hi)
    times = [sum(lats[a:b]) + (comm_cost if i > 0 and b > a else 0.0)
             for i, (a, b) in enumerate(zip(stages, stages[1:]))]
    return PartitionPlan(boundaries=stages, stage_times=times,
                         bottleneck=max(times))


# ---------------------------------------------------------------------------
# Predictor-backed planning (per-block latencies from ONE batched call)
# ---------------------------------------------------------------------------

def _blocks_on(predictor, cfg, batch, seq, dtype, device):
    """Per-block latencies on ``device`` (None = the predictor's own).  Fleet
    devices need a fleet-capable predictor (``BatchPredictor.for_device``);
    the scalar PM2Lat still works for single-device plans."""
    if device is not None:
        predictor = predictor.for_device(device)
    return [float(t) for t in predictor.predict_blocks(cfg, batch, seq,
                                                       dtype=dtype)]


def activation_comm_cost(cfg, batch: int, seq: int,
                         dtype: Optional[str] = None,
                         device_a: Optional[str] = None,
                         device_b: Optional[str] = None) -> float:
    """Predicted seconds for one stage-boundary activation hand-off: a p2p
    transfer of the (batch, seq, d_model) hidden state over the bottleneck
    interconnect of the two endpoints (``core/collectives.py`` α–β model,
    measured fits when a comm-calibration artifact carries them; an
    unregistered/None device costs the conservative default NIC)."""
    nbytes = float(batch) * seq * cfg.d_model * CC.dtype_bytes(
        dtype or "float32")
    ics = [calibrated_interconnect(d) for d in (device_a, device_b)]
    return CC.p2p_time(nbytes, min(ics, key=lambda ic: ic.raw_bus_bw()))


def plan_two_devices_model(predictor, cfg, batch: int, seq: int, *,
                           b_speed: float = 1.0,
                           comm_cost: Optional[float] = None,
                           dtype: Optional[str] = None,
                           device_a: Optional[str] = None,
                           device_b: Optional[str] = None,
                           microbatches: int = 1
                           ) -> Tuple[PartitionPlan, List[float]]:
    """Two-device split for a model config: per-block latencies from one
    batched predictor pass per device.  Name fleet devices via
    ``device_a``/``device_b``; without ``device_b``, device B is a uniform
    ``b_speed`` multiple of device A.  ``comm_cost`` defaults to the
    predicted activation transfer between the two devices
    (``activation_comm_cost``); an explicit scalar overrides it.
    ``microbatches`` prices the plan as a micro-batched pipeline schedule
    (``plan.makespan``).  Returns (plan, blocks_a)."""
    blocks = _blocks_on(predictor, cfg, batch, seq, dtype, device_a)
    if device_b is not None:
        blocks_b = _blocks_on(predictor, cfg, batch, seq, dtype, device_b)
    else:
        blocks_b = [t * b_speed for t in blocks]
    derived = comm_cost is None
    if derived:
        comm_cost = activation_comm_cost(cfg, batch, seq, dtype=dtype,
                                         device_a=device_a, device_b=device_b)
    plan = plan_two_devices(blocks, blocks_b, comm_cost)
    s = plan.split_point
    pure = [sum(blocks[:s]), sum(blocks_b[s:])]
    handoff = _mb_handoff(cfg, batch, seq, microbatches, derived=derived,
                          comm_cost=comm_cost, dtype=dtype,
                          device_a=device_a, device_b=device_b)
    return _attach_makespan(plan, pure, handoff, microbatches), blocks


def plan_stages_model(predictor, cfg, batch: int, seq: int, n_stages: int, *,
                      comm_cost: Optional[float] = None,
                      dtype: Optional[str] = None,
                      device: Optional[str] = None,
                      microbatches: int = 1
                      ) -> Tuple[PartitionPlan, List[float]]:
    """N-stage contiguous min-max partition from one batched prediction,
    optionally planned for a named fleet device.  Every stage after the
    first is charged one activation hand-off (``comm_cost`` defaults to the
    predicted p2p transfer on the device's own interconnect).  The plan
    also carries the scheduled end-to-end cost (``plan.makespan``): the
    planned stages run as a ``microbatches``-deep pipeline."""
    blocks = _blocks_on(predictor, cfg, batch, seq, dtype, device)
    derived = comm_cost is None
    if derived:
        comm_cost = activation_comm_cost(cfg, batch, seq, dtype=dtype,
                                         device_a=device, device_b=device)
    plan = plan_stages(blocks, n_stages, comm_cost)
    pure = [sum(blocks[a:b])
            for a, b in zip(plan.boundaries, plan.boundaries[1:])]
    handoff = _mb_handoff(cfg, batch, seq, microbatches, derived=derived,
                          comm_cost=comm_cost, dtype=dtype,
                          device_a=device, device_b=device)
    return _attach_makespan(plan, pure, handoff, microbatches), blocks
