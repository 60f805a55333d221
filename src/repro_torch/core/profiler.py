"""Measurement protocol (paper §III-C): warm-up, repeated timed runs with a
minimum total-time budget, robust (median-of-groups) aggregation.

The paper uses >=25 reps / >=500 ms per kernel via CUPTI on a dedicated GPU.
The protocol here is the JAX package's: (a) warm up until timings
stabilize, (b) batch calls into groups of >=2 ms and (c) report the MEDIAN
of group means.  Set ``PM2LAT_PAPER_BUDGET=1`` for the paper's full budget.

On a CUDA device every group is timed by a pair of ``torch.cuda.Event``s
and a synchronize — PyTorch returns before the card finishes, so a host
clock alone would time the enqueue.  On the CPU the host clock is exact.
"""
from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.device import resolve

PAPER = bool(int(os.environ.get("PM2LAT_PAPER_BUDGET", "0")))
MIN_REPS = 25 if PAPER else 9
MIN_TOTAL_S = 0.5 if PAPER else 0.06
GROUP_TARGET_S = 0.002
MAX_TOTAL_S = 2.0 if PAPER else 0.6


def _timer(dev: torch.device):
    """``run(fn, args, n) -> seconds`` for ``n`` back-to-back calls."""
    if dev.type == "cuda":
        def run(fn, args, n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
        return run

    def run(fn, args, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        return time.perf_counter() - t0
    return run


def measure(fn: Callable, *args, min_reps: int = None,
            min_total_s: float = None, device="cuda") -> float:
    """Robust seconds-per-call estimate for ``fn(*args)`` on ``device``."""
    dev = resolve(device)
    run = _timer(dev)
    min_reps = min_reps or MIN_REPS
    min_total_s = min_total_s or MIN_TOTAL_S
    # warm-up: build/autotune + frequency ramp (two timed singles, keep
    # warming while the second is much faster than the first)
    run(fn, args, 1)
    t1 = run(fn, args, 1)
    for _ in range(3):
        t2 = run(fn, args, 1)
        if t2 > 0.75 * t1:
            t1 = min(t1, t2)
            break
        t1 = t2
    group = max(1, int(GROUP_TARGET_S / max(t1, 1e-9)))
    means = []
    reps = 0
    elapsed = 0.0
    while True:
        g = run(fn, args, group)
        means.append(g / group)
        reps += group
        elapsed += g
        if (reps >= min_reps and elapsed >= min_total_s) or elapsed > MAX_TOTAL_S:
            break
    return float(np.median(means))
