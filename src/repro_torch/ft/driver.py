"""Fault-tolerant training driver: checkpoint and restart, failure
injection, straggler detection (the JAX package's ``ft/driver.py``; the
elastic re-mesh is ``ft/elastic.py``).  On a mesh every rank runs the
loop: the failures are injected at the same steps on every rank, and the
store's ``wait`` holds every rank until rank 0's checkpoint is on disk
before any restores it.

  - ``FailureInjector`` raises ``SimulatedFailure`` at configured steps (a
    stand-in for a dead host or a preempted job).
  - ``run_training`` catches a failure, restores the latest checkpoint and
    goes on: the loss curve equals an uninterrupted run's, because the
    data pipeline is step-indexed and the state is restored bit for bit.
  - ``StragglerMonitor`` keeps each step's wall time; a step slower than
    ``tau`` x the rolling median is logged as a straggler event.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.checkpoint.store import CheckpointStore


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    tau: float = 3.0
    window: int = 32
    times: List[float] = dataclasses.field(default_factory=list)
    events: List[dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        med = float(np.median(hist))
        is_straggler = len(hist) >= 8 and dt > self.tau * med
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "median": med})
        return is_straggler


@dataclasses.dataclass
class TrainLog:
    steps: List[int] = dataclasses.field(default_factory=list)
    losses: List[float] = dataclasses.field(default_factory=list)
    restarts: int = 0
    straggler_events: int = 0


def run_training(*, step_fn: Callable, init_state, data, num_steps: int,
                 store: CheckpointStore, ckpt_every: int = 10,
                 injector: Optional[FailureInjector] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 max_restarts: int = 10) -> tuple:
    """The fault-tolerant loop.

    step_fn(state, batch) -> (state, metrics with 'loss'); data.batch_at(step)
    -> batch.  Returns (state, TrainLog).  The state is a nest of tensors
    that ``step_fn`` may update in place; a restore writes the checkpoint
    into those same tensors (``CheckpointStore.restore``).  Step 0 is
    always saved, after its update, so a failure at any later step finds a
    checkpoint; one before step 0's update meets the untouched state."""
    log = TrainLog()
    state = init_state
    start = 0
    restored = store.restore_latest(state)
    if restored is not None:
        state, start = restored
        start += 1
    step = start
    while step < num_steps:
        try:
            t0 = time.perf_counter()
            if injector is not None:
                injector.maybe_fail(step)
            batch = data.batch_at(step)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])       # waits for the step
            dt = time.perf_counter() - t0
            if monitor is not None and monitor.observe(step, dt):
                log.straggler_events += 1
            log.steps.append(step)
            log.losses.append(loss)
            if step % ckpt_every == 0:
                store.save(step, state)
            step += 1
        except SimulatedFailure:
            log.restarts += 1
            if log.restarts > max_restarts:
                raise
            store.wait()
            restored = store.restore_latest(state)
            if restored is None:
                step = 0
            else:
                state, last = restored
                step = last + 1
    store.wait()
    return state, log
