"""Latency-query service: the serving-side endpoint over the batch
prediction engine.

``LatencyService.latency_query(model, batch, seq, dtype)`` answers "how long
will one forward pass take on this device?" from the LRU + JSON-persistent
``PredictionCache``, falling through to the vectorized ``BatchPredictor`` on
a miss.  ``latency_grid`` bulk-fills the cache with one symbolic grid
prediction — the admission-control / autoscaling primitive: a router can
sweep every (batch, seq) bucket it serves in a single call and afterwards
answer every query from cache.

``latency_breakdown`` is the explainability endpoint: per-op rows with the
kernel id the selection oracle (``core/oracle.py``) actually picked, and
``explain_kernels`` exposes the oracle's scored candidate list for one op
shape — "which profiled kernel would the library run here, and why".

``plan_training`` is the fleet-planning endpoint: one call enumerates the
(dp, tp, pp, microbatches, schedule, bucket_mb) grid for an N-device
budget, filters it by estimated peak memory, and returns the fastest
feasible ``TrainingPlan`` — cached point-by-point under the same keys as
``latency_train`` / ``sweep_train``.

The JAX package's ``serving/latency_service.py``, endpoint for endpoint:
the prediction math is numpy on both sides, so the same store answers
with the same floats, and a cache file one package writes the other
reads.  ``device=`` everywhere names a store or fleet profile
(``core/devices``); only a missing store is calibrated, on the torch
device ``torch_device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core import calibrate
from repro_torch.core import devices as D
from repro_torch.core import opgraph as og
from repro_torch.core import schedule as S
from repro_torch.core.batch_predict import (BatchPredictor, PredictionCache,
                                            config_key)
from repro_torch.core.collectives import dtype_bytes


@dataclasses.dataclass
class LatencyQueryResult:
    model: str
    device: str
    dtype: str
    batch: int
    seq: int
    seconds: float
    cached: bool

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class _CommShareMixin:
    """Shared derived view for results carrying ``seconds`` +
    ``comm_seconds``."""
    @property
    def comm_share(self) -> float:
        return self.comm_seconds / self.seconds if self.seconds > 0 else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["comm_share"] = self.comm_share
        return d


@dataclasses.dataclass
class ParallelLatencyResult(_CommShareMixin):
    """One rank's predicted forward latency under a parallelism strategy,
    with the compute/communication split (``comm_share`` is the planning
    signal: the fraction of the end-to-end time spent in collectives).
    ``seconds`` is the schedule MAKESPAN; with micro-batched overlap it can
    be smaller than ``compute_seconds + comm_seconds`` (total work).
    ``exposed_comm_seconds`` is the wall-clock span during which no compute
    runs anywhere — communication/bubble time not hidden behind compute
    (``Schedule.exposed_comm_seconds``)."""
    model: str
    device: str
    dtype: str
    batch: int
    seq: int
    dp: int
    tp: int
    pp: int
    act_mode: str
    world: int
    seconds: float
    compute_seconds: float
    comm_seconds: float
    exposed_comm_seconds: float = 0.0
    microbatches: int = 1
    cached: bool = False
    schedule: str = "gpipe"
    peak_bytes: float = 0.0


@dataclasses.dataclass
class TrainLatencyResult(_CommShareMixin):
    """One TRAINING step (fwd + bwd + gradient comm + optimizer update)
    under a parallelism strategy: schedule makespan plus the busy-time
    split.  ``exposed_comm_seconds`` is the communication/bubble time not
    hidden behind compute — the overlap-planning signal."""
    model: str
    device: str
    dtype: str
    batch: int
    seq: int
    dp: int
    tp: int
    pp: int
    act_mode: str
    microbatches: int
    world: int
    optimizer: str
    bucket_mb: float
    seconds: float
    fwd_seconds: float
    bwd_seconds: float
    comm_seconds: float
    optimizer_seconds: float
    exposed_comm_seconds: float
    cached: bool = False
    schedule: str = "gpipe"
    peak_bytes: float = 0.0


@dataclasses.dataclass
class TrainingPlan:
    """The answer to "what is the fastest *feasible* way to train this
    model on N devices": the min-makespan point of the swept
    (dp, tp, pp, microbatches, schedule, bucket_mb) grid that fits in
    device memory.  ``breakdown`` is the winning spec's full sweep row
    (fwd/bwd/comm/optimizer splits, bubble share, exposed comm,
    peak bytes); ``alternatives`` holds the next-fastest feasible rows —
    the runner-ups a capacity- or topology-constrained deployment would
    fall back to."""
    model: str
    device: str
    dtype: str
    global_batch: int
    seq: int
    devices: int
    memory_bytes: Optional[float]
    dp: int
    tp: int
    pp: int
    microbatches: int
    schedule: str
    act_mode: str
    optimizer: str
    bucket_mb: float
    world: int
    seconds: float
    peak_bytes: float
    breakdown: dict
    n_candidates: int
    n_feasible: int
    alternatives: list

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServeLatencyResult:
    """One (model, traffic-mix, capacity, tp) serving prediction: the
    continuous-batching occupancy simulation (``schedule.simulate_serving``)
    run over PREDICTED per-phase latencies — prefill forwards priced like
    ``latency_query`` / ``latency_parallel``, decode steps priced
    memory-bound over the (batch, ctx) grid
    (``BatchPredictor.predict_decode_grid``).  ``decode_step_seconds`` is
    the worst-case step (full capacity, longest context);
    ``gqa_ratio`` / ``kv_cache_bytes`` say what sets the KV traffic."""
    model: str
    device: str
    dtype: str
    capacity: int
    tp: int
    mix_tag: str
    n_requests: float
    makespan: float
    tokens_out: float
    tokens_per_sec: float
    ttft_p50: float
    ttft_p95: float
    tpot_p50: float
    tpot_p95: float
    latency_p50: float
    latency_p95: float
    occupancy: float
    decode_step_seconds: float
    gqa_ratio: float
    kv_cache_bytes: float
    cached: bool = False

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServingPlan:
    """The answer to "how should N devices serve this traffic": the
    max-throughput point of the (capacity, tp) grid whose weights + KV
    cache fit in device memory and whose predicted p95 TTFT/TPOT meet the
    SLO.  ``breakdown`` is the winning point's full ``ServeLatencyResult``
    record; ``alternatives`` the next-best feasible points."""
    model: str
    device: str
    dtype: str
    devices: int
    memory_bytes: Optional[float]
    slo_ttft: Optional[float]
    slo_tpot: Optional[float]
    capacity: int
    tp: int
    tokens_per_sec: float
    ttft_p95: float
    tpot_p95: float
    weight_bytes: float
    kv_cache_bytes: float
    breakdown: dict
    n_candidates: int
    n_feasible: int
    alternatives: list

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _sched_entry(sched) -> dict:
    """One scalar ``Schedule`` as the full sweep-metric cache entry
    (``schedule.SWEEP_METRICS`` field set) — the same shape
    ``sweep_parallel`` persists, so scalar and sweep queries hit each
    other's entries."""
    busy = sched.busy()
    return {"seconds": sched.makespan,
            "compute_seconds": sched.compute_seconds,
            "comm_seconds": sched.comm_seconds,
            "exposed_comm_seconds": sched.exposed_comm_seconds,
            "sequential_seconds": sched.sequential_seconds,
            "bubble_share": sched.bubble_share,
            "max_stream_busy": max(busy.values()) if busy else 0.0}


class LatencyService:
    def __init__(self, store=None, device: Optional[str] = None, *,
                 cache_path: Optional[str] = None, cache_size: int = 65536,
                 torch_device="cuda"):
        """``store``/``device``: the calibrated ``TableStore`` and its
        device name.  Either one missing is taken from
        ``calibrate.load_or_calibrate`` / ``calibrate.device_name`` on
        ``torch_device``, which raises without a card unless it is
        ``"cpu"``."""
        if store is None or device is None:
            store = store or calibrate.load_or_calibrate(
                device=torch_device, verbose=False)
            device = device or calibrate.device_name(torch_device)
        self.device = device
        self.cache = PredictionCache(maxsize=cache_size, path=cache_path)
        self.predictor = BatchPredictor(store, device, cache=self.cache)

    def _resolve(self, model: Union[str, ModelConfig]) -> ModelConfig:
        if isinstance(model, ModelConfig):
            return model
        return registry.get_any(model)

    def latency_query(self, model: Union[str, ModelConfig], batch: int,
                      seq: int, dtype: Optional[str] = None,
                      device: Optional[str] = None) -> LatencyQueryResult:
        """One (model, batch, seq, dtype[, device]) latency: cache hit or
        batch-predict.  ``device`` names any registry profile
        (``core/devices``); None answers for the calibrated host.  One
        service instance serves the whole fleet — per-device predictors are
        derived lazily over roofline-transferred tables and share this
        service's cache under device-fingerprinted keys."""
        cfg = self._resolve(model)
        pred = self.predictor.for_device(device)
        key = PredictionCache.make_key(config_key(cfg), pred.cache_device,
                                       dtype, batch, seq)
        hit = self.cache.get(key)
        if hit is not None:
            return LatencyQueryResult(cfg.name, pred.device,
                                      dtype or "float32", int(batch),
                                      int(seq), hit, cached=True)
        seconds, _ = pred.predict_model(cfg, batch, seq, dtype=dtype)
        self.cache.put(key, seconds)
        return LatencyQueryResult(cfg.name, pred.device, dtype or "float32",
                                  int(batch), int(seq), seconds, cached=False)

    def latency_grid(self, model: Union[str, ModelConfig],
                     batches: Sequence[int], seqs: Sequence[int],
                     dtype: Optional[str] = None,
                     device: Optional[str] = None) -> np.ndarray:
        """Bulk query: one symbolic grid prediction, every point written to
        the cache so subsequent ``latency_query`` calls are hits."""
        cfg = self._resolve(model)
        pred = self.predictor.for_device(device)
        grid = pred.predict_model_grid(cfg, batches, seqs, dtype)
        for i, b in enumerate(batches):
            for j, s in enumerate(seqs):
                self.cache.put(
                    PredictionCache.make_key(config_key(cfg),
                                             pred.cache_device,
                                             dtype, b, s), float(grid[i, j]))
        return grid

    def latency_parallel(self, model: Union[str, ModelConfig], batch: int,
                         seq: int, dp: int = 1, tp: int = 1, pp: int = 1,
                         act_mode: str = "tp", microbatches: int = 1,
                         schedule: str = "gpipe",
                         dtype: Optional[str] = None,
                         device: Optional[str] = None
                         ) -> ParallelLatencyResult:
        """End-to-end one-rank latency under a (dp, tp, pp[, microbatches])
        strategy: the schedule-aware op graph (``core/schedule.py``) priced
        through the vectorized engine, collectives by the device's α–β
        interconnect model (``core/collectives.py``), reported as the
        two-stream schedule MAKESPAN.  With ``dp=tp=pp=1, microbatches=1``
        the answer is bit-identical to ``latency_query`` (same op list,
        same accumulation).  Cached on the spec tag, like ``latency_query``
        — planners sweeping strategy grids hit the cache on repeats."""
        cfg = self._resolve(model)
        pred = self.predictor.for_device(device)
        spec = og.ParallelismSpec(dp=dp, tp=tp, pp=pp, act_mode=act_mode,
                                  microbatches=microbatches,
                                  schedule=schedule)

        def result(d, cached):
            return ParallelLatencyResult(
                model=cfg.name, device=pred.device, dtype=dtype or "float32",
                batch=int(batch), seq=int(seq), dp=int(dp), tp=int(tp),
                pp=int(pp), act_mode=act_mode, world=spec.world,
                seconds=d["seconds"], compute_seconds=d["compute_seconds"],
                comm_seconds=d["comm_seconds"],
                exposed_comm_seconds=d["exposed_comm_seconds"],
                microbatches=int(microbatches), cached=cached,
                schedule=schedule, peak_bytes=d.get("peak_bytes", 0.0))

        key = PredictionCache.make_key(config_key(cfg), pred.cache_device,
                                       dtype, batch, seq, spec=spec.tag())
        hit = self.cache.get(key)
        # a persisted entry missing expected fields (foreign writer,
        # hand-edited file) is treated as a miss, not a crash
        if isinstance(hit, dict) and {"seconds", "compute_seconds",
                                      "comm_seconds", "exposed_comm_seconds",
                                      "peak_bytes"} <= hit.keys():
            return result(hit, True)
        sched = pred.schedule_parallel(cfg, batch, seq, spec, dtype=dtype)
        d = _sched_entry(sched)
        d["peak_bytes"] = S.peak_memory_bytes(cfg, batch, seq, spec,
                                              dtype=dtype)
        self.cache.put(key, d)
        return result(d, False)

    def latency_train(self, model: Union[str, ModelConfig], batch: int,
                      seq: int, dp: int = 1, tp: int = 1, pp: int = 1,
                      act_mode: str = "tp", microbatches: int = 1,
                      schedule: str = "gpipe",
                      optimizer: str = "adamw", bucket_mb: float = 25.0,
                      dtype: Optional[str] = None,
                      device: Optional[str] = None) -> TrainLatencyResult:
        """One TRAINING-step latency: forward + backward (≈2× forward
        compute), the bucketed data-parallel gradient all-reduce overlapped
        with backward, pipeline microbatching, and the optimizer update —
        all priced as the two-stream schedule makespan
        (``core/schedule.py``).  Cached on the spec + training tags."""
        cfg = self._resolve(model)
        pred = self.predictor.for_device(device)
        spec = og.ParallelismSpec(dp=dp, tp=tp, pp=pp, act_mode=act_mode,
                                  microbatches=microbatches,
                                  schedule=schedule)
        train = S.TrainingStepSpec(optimizer=optimizer, bucket_mb=bucket_mb)

        def result(d, cached):
            return TrainLatencyResult(
                model=cfg.name, device=pred.device, dtype=dtype or "float32",
                batch=int(batch), seq=int(seq), dp=int(dp), tp=int(tp),
                pp=int(pp), act_mode=act_mode,
                microbatches=int(microbatches), world=spec.world,
                optimizer=optimizer, bucket_mb=float(bucket_mb),
                seconds=d["seconds"], fwd_seconds=d["fwd_seconds"],
                bwd_seconds=d["bwd_seconds"], comm_seconds=d["comm_seconds"],
                optimizer_seconds=d["optimizer_seconds"],
                exposed_comm_seconds=d["exposed_comm_seconds"],
                cached=cached, schedule=schedule,
                peak_bytes=d.get("peak_bytes", 0.0))

        key = PredictionCache.make_key(
            config_key(cfg), pred.cache_device, dtype, batch, seq,
            spec=f"{spec.tag()}+{train.tag()}+train")
        _FIELDS = {"seconds", "fwd_seconds", "bwd_seconds", "comm_seconds",
                   "optimizer_seconds", "exposed_comm_seconds", "peak_bytes"}
        hit = self.cache.get(key)
        # tolerate persisted entries missing expected fields: miss, recompute
        if isinstance(hit, dict) and _FIELDS <= hit.keys():
            return result(hit, True)
        sched = pred.schedule_step(cfg, batch, seq, spec=spec, train=train,
                                   dtype=dtype)
        fwd = bwd = opt = 0.0
        for r in sched.rows:
            if r.kind == "collective":
                continue
            if r.name.startswith("bwd."):
                bwd += r.seconds
            elif r.name.startswith("opt."):
                opt += r.seconds
            else:
                fwd += r.seconds
        d = _sched_entry(sched)
        d.update(fwd_seconds=fwd, bwd_seconds=bwd, optimizer_seconds=opt,
                 peak_bytes=S.peak_memory_bytes(cfg, batch, seq, spec,
                                                train=train, dtype=dtype))
        self.cache.put(key, d)
        return result(d, False)

    def sweep_parallel(self, model: Union[str, ModelConfig], batch: int,
                       seq: int, specs, dtype: Optional[str] = None,
                       hbm_bytes: Optional[float] = None,
                       device: Optional[str] = None):
        """Price MANY forward parallelism strategies in one vectorized
        pass (``schedule.sweep_strategies``): cached specs are answered
        from their ``latency_parallel`` entries, the misses go through a
        single template/bind/simulate-batch call, and every fresh result
        is written back under its spec-tagged key — so a follow-up
        ``latency_parallel`` on any swept spec is a cache hit.  Returns a
        ``schedule.StrategySweep`` with the per-spec ``cached`` mask (and
        the ``feasible`` mask when ``hbm_bytes`` is given)."""
        cfg = self._resolve(model)
        pred = self.predictor.for_device(device)
        specs = list(specs)
        keys = [PredictionCache.make_key(config_key(cfg), pred.cache_device,
                                         dtype, batch, seq, spec=sp.tag())
                for sp in specs]
        return self._sweep(pred, cfg, batch, seq, specs, keys,
                           S.SWEEP_METRICS + S.MEM_METRICS, dtype,
                           trains=None, hbm_bytes=hbm_bytes)

    def sweep_train(self, model: Union[str, ModelConfig], batch: int,
                    seq: int, specs, train=None,
                    dtype: Optional[str] = None,
                    hbm_bytes: Optional[float] = None,
                    device: Optional[str] = None):
        """``sweep_parallel`` for TRAINING steps: each spec priced as one
        optimizer step (fwd + bwd + bucketed gradient all-reduce +
        optimizer update).  ``train`` is None (default ``TrainingStepSpec``),
        one shared spec, or a per-spec sequence — so a (strategy ×
        bucket_mb) grid is a single call.  Entries share keys (and the
        field superset) with ``latency_train``."""
        cfg = self._resolve(model)
        pred = self.predictor.for_device(device)
        specs = list(specs)
        if train is None:
            train = S.TrainingStepSpec()
        if isinstance(train, S.TrainingStepSpec):
            trains = [train] * len(specs)
        else:
            trains = list(train)
            if len(trains) != len(specs):
                raise ValueError(f"train sequence length {len(trains)} != "
                                 f"{len(specs)} specs")
        keys = [PredictionCache.make_key(
                    config_key(cfg), pred.cache_device, dtype, batch, seq,
                    spec=f"{sp.tag()}+{tr.tag()}+train")
                for sp, tr in zip(specs, trains)]
        return self._sweep(pred, cfg, batch, seq, specs, keys,
                           S.SWEEP_METRICS + S.TRAIN_METRICS + S.MEM_METRICS,
                           dtype, trains=trains, hbm_bytes=hbm_bytes)

    def _sweep(self, pred, cfg, batch, seq, specs, keys, fields, dtype,
               trains, hbm_bytes=None):
        """Shared cache-or-compute core of ``sweep_parallel`` /
        ``sweep_train``: answer hits from the cache, vector-price the
        misses in ONE ``sweep_strategies`` call, persist them.  The
        ``feasible`` mask is derived locally (``peak_bytes`` is part of
        every entry; capacity is a query parameter, not cache state)."""
        need = set(fields)
        hits = [self.cache.get(k) for k in keys]
        cached = np.array([isinstance(h, dict) and need <= h.keys()
                           for h in hits], dtype=bool)
        out = {name: np.zeros(len(specs)) for name in fields}
        for i, h in enumerate(hits):
            if cached[i]:
                for name in fields:
                    out[name][i] = h[name]
        miss = [i for i in range(len(specs)) if not cached[i]]
        if miss:
            sw = pred.sweep_strategies(
                cfg, batch, seq, [specs[i] for i in miss],
                train=[trains[i] for i in miss] if trains else None,
                dtype=dtype)
            for j, i in enumerate(miss):
                entry = {name: float(getattr(sw, name)[j])
                         for name in fields}
                self.cache.put(keys[i], entry)
                for name in fields:
                    out[name][i] = entry[name]
        feasible = (out["peak_bytes"] <= float(hbm_bytes)
                    if hbm_bytes is not None else None)
        return S.StrategySweep(specs=specs, trains=trains, cached=cached,
                               feasible=feasible, **out)

    def plan_training(self, model: Union[str, ModelConfig],
                      global_batch: int, seq: int, *, devices: int,
                      memory_gb: Optional[float] = None,
                      optimizer: str = "adamw",
                      bucket_mbs: Sequence[float] = (25.0,),
                      schedules: Sequence[str] = ("gpipe", "1f1b",
                                                  "interleaved"),
                      act_mode: str = "tp", top_k: int = 3,
                      dtype: Optional[str] = None,
                      device: Optional[str] = None) -> TrainingPlan:
        """Strategy auto-search under a memory constraint: enumerate the
        power-of-two (dp, tp, pp) grid with ``dp*tp*pp <= devices``,
        crossed with microbatch counts dividing the per-replica batch,
        every schedule kind, and every gradient-bucket size; price the
        whole grid in one ``sweep_train`` call; reject points whose
        estimated peak memory (``schedule.peak_memory_bytes``) exceeds
        the capacity; return the min-makespan survivor.

        Capacity is ``memory_gb`` (GiB per device) when given, else the
        target device profile's ``hbm_bytes``, else unconstrained.  Every
        priced point is cached under the same spec-tagged keys as
        ``latency_train`` / ``sweep_train`` — replanning with a different
        capacity or device count re-answers from cache."""
        cfg = self._resolve(model)
        pred = self.predictor.for_device(device)
        devices = int(devices)
        if devices < 1:
            raise ValueError("devices must be >= 1")

        cap: Optional[float] = None
        if memory_gb is not None:
            cap = float(memory_gb) * 2**30
        else:
            self.predictor.host_profile()   # register host in the fleet
            try:
                cap = float(D.get_profile(pred.device).hbm_bytes)
            except KeyError:
                cap = None                  # unknown device: unconstrained

        pows2 = [1 << i for i in range(devices.bit_length())
                 if 1 << i <= devices]
        grid = S.strategy_grid(
            dp=[d for d in pows2 if global_batch % d == 0],
            tp=pows2, pp=[p for p in pows2 if p <= cfg.n_layers],
            microbatches=pows2, act_modes=(act_mode,),
            schedules=schedules, max_world=devices)
        grid = [sp for sp in grid
                if global_batch % (sp.dp * sp.microbatches) == 0]
        if not grid:
            raise ValueError(f"no candidate strategy fits {devices} "
                             f"device(s) at global batch {global_batch}")
        specs, trains = [], []
        for bkt in bucket_mbs:
            tr = S.TrainingStepSpec(optimizer=optimizer,
                                    bucket_mb=float(bkt))
            specs.extend(grid)
            trains.extend([tr] * len(grid))
        sw = self.sweep_train(cfg, global_batch, seq, specs, train=trains,
                              dtype=dtype, hbm_bytes=cap, device=device)
        if sw.feasible is not None and not sw.feasible.any():
            raise ValueError(
                f"no strategy fits in {cap / 2**30:.1f} GiB: smallest "
                f"footprint is {float(sw.peak_bytes.min()) / 2**30:.2f} "
                f"GiB — lower the batch or raise devices/memory")
        best = sw.best()
        order = np.argsort(sw.seconds, kind="stable")
        runners = [int(i) for i in order
                   if i != best
                   and (sw.feasible is None or sw.feasible[i])]
        sp = specs[best]
        return TrainingPlan(
            model=cfg.name, device=pred.device, dtype=dtype or "float32",
            global_batch=int(global_batch), seq=int(seq), devices=devices,
            memory_bytes=cap, dp=sp.dp, tp=sp.tp, pp=sp.pp,
            microbatches=sp.microbatches, schedule=sp.schedule,
            act_mode=sp.act_mode, optimizer=optimizer,
            bucket_mb=trains[best].bucket_mb, world=sp.world,
            seconds=float(sw.seconds[best]),
            peak_bytes=float(sw.peak_bytes[best]),
            breakdown=sw.row(best),
            n_candidates=len(specs),
            n_feasible=int(sw.feasible.sum()) if sw.feasible is not None
            else len(specs),
            alternatives=[sw.row(i) for i in runners[:max(top_k - 1, 0)]])

    # ----- serving (prefill/decode) endpoints -----
    _SERVE_EXTRAS = ("decode_step_seconds", "gqa_ratio", "kv_cache_bytes")

    def _serve_tables(self, cfg, prompt_lens, max_ctx: int, *,
                      capacity: int, tp: int, dtype: Optional[str],
                      device: Optional[str]):
        """One (device, tp) ``schedule.ServingTables``: a prefill entry
        per distinct prompt length through the CACHED scalar endpoints —
        the same keys/float path as ``latency_query`` /
        ``latency_parallel``, so the zero-decode degenerate mix stays
        bit-identical and prefill entries are shared with them — plus
        ONE ``predict_decode_grid`` call sized ``(capacity, max_ctx)``
        (the in-cache twin of ``BatchPredictor.serving_tables``)."""
        pred = self.predictor.for_device(device)
        if tp == 1:
            pre = {int(p): self.latency_query(cfg, 1, int(p), dtype=dtype,
                                              device=device).seconds
                   for p in set(prompt_lens)}
        else:
            pre = {int(p): self.latency_parallel(cfg, 1, int(p), tp=tp,
                                                 dtype=dtype,
                                                 device=device).seconds
                   for p in set(prompt_lens)}
        spec = None if tp == 1 else og.ParallelismSpec(tp=tp)
        grid = pred.predict_decode_grid(cfg, np.arange(1, capacity + 1),
                                        np.arange(1, max_ctx + 1),
                                        dtype=dtype, spec=spec)
        return S.ServingTables(prefill=pre, decode=grid)

    def _sweep_serve_points(self, cfg, mix, points, dtype, device,
                            tables_for=None) -> list:
        """Price a ``[(capacity, tp), ...]`` list for one mix: cache hits
        answer directly; ALL misses run through one
        ``simulate_serving_batch`` call over tables from
        ``tables_for(tp, capacity)`` (default: one decode grid per tp,
        sized to the largest missing capacity).  Grid rows and cells are
        batch/ctx-independent, so every entry is bit-identical to pricing
        that point alone, under the same ``serve.capN.tpN.<mix-tag>``
        key ``latency_serve`` reads."""
        pred = self.predictor.for_device(device)
        mix_tag = mix.tag()
        fields = set(S.ServingStats.FIELDS) | set(self._SERVE_EXTRAS)

        def result(point, d, cached):
            c, tp = point
            return ServeLatencyResult(
                model=cfg.name, device=pred.device,
                dtype=dtype or "float32", capacity=int(c), tp=int(tp),
                mix_tag=mix_tag, cached=cached,
                **{f: d[f] for f in S.ServingStats.FIELDS
                   if f != "capacity"},
                **{f: d[f] for f in self._SERVE_EXTRAS})

        keys = [PredictionCache.make_key(
                    config_key(cfg), pred.cache_device, dtype, int(c),
                    mix.max_ctx,
                    spec=f"serve.cap{int(c)}.tp{int(tp)}.{mix_tag}")
                for c, tp in points]
        out: list = [None] * len(points)
        miss = []
        for i, key in enumerate(keys):
            hit = self.cache.get(key)
            # entries missing expected fields (foreign writer) are misses
            if isinstance(hit, dict) and fields <= hit.keys():
                out[i] = result(points[i], hit, True)
            else:
                miss.append(i)
        if miss:
            if tables_for is None:
                maxcap: dict = {}
                for i in miss:
                    c, tp = points[i]
                    maxcap[int(tp)] = max(maxcap.get(int(tp), 0), int(c))
                shared = {tp: self._serve_tables(
                              cfg, mix.prompt_lens, mix.max_ctx,
                              capacity=c, tp=tp, dtype=dtype, device=device)
                          for tp, c in maxcap.items()}
                tables_for = lambda tp, c: shared[int(tp)]
            caps = [int(points[i][0]) for i in miss]
            tabs = [tables_for(int(points[i][1]), int(points[i][0]))
                    for i in miss]
            stats = S.simulate_serving_batch(mix, caps, tabs)
            gqa = float(max(1, cfg.n_heads // max(1, cfg.n_kv_heads)))
            for i, st, tab in zip(miss, stats, tabs):
                c, tp = points[i]
                d = st.to_entry()
                d.update(
                    decode_step_seconds=float(
                        tab.decode[int(c) - 1, mix.max_ctx - 1]),
                    gqa_ratio=gqa,
                    kv_cache_bytes=float(og.kv_cache_bytes(
                        cfg, int(c), mix.max_ctx, dtype=dtype)))
                self.cache.put(keys[i], d)
                out[i] = result(points[i], d, False)
        return out

    def latency_serve(self, model: Union[str, ModelConfig], mix, *,
                      capacity: int = 8, tp: int = 1,
                      dtype: Optional[str] = None,
                      device: Optional[str] = None) -> ServeLatencyResult:
        """Serving throughput + latency-distribution prediction for one
        (model, ``schedule.TrafficMix``, decode capacity, tp) point, from
        ONE cached call.  Prefill forwards are priced exactly like
        ``latency_query`` (``latency_parallel`` under tp > 1) — the
        zero-decode degenerate mix is bit-identical to ``latency_query``
        — and decode steps come from ``predict_decode_grid``: sq=1
        KV-cache-read attention priced memory-bound, the GQA ratio visible
        in the breakdown (``kv_read@gqaN`` kernel rows, ``gqa_ratio``
        here).  The simulation is the event-driven
        ``schedule.simulate_serving_batch`` over precomputed tables; the
        full record is cached under a ``serve.capN.tpN.<mix-tag>`` spec
        key (schema 8)."""
        cfg = self._resolve(model)
        capacity, tp = int(capacity), int(tp)
        if capacity < 1 or tp < 1:
            raise ValueError(f"capacity/tp must be >=1: {capacity}, {tp}")
        return self._sweep_serve_points(cfg, mix, [(capacity, tp)],
                                        dtype, device)[0]

    def sweep_serve(self, model: Union[str, ModelConfig], mix,
                    capacities: Sequence[int], *,
                    tps: Sequence[int] = (1,),
                    dtype: Optional[str] = None,
                    device: Optional[str] = None) -> list:
        """``latency_serve`` over the (mix, capacity, tp) product grid in
        ONE batched pass per mix: all missing points share one decode
        grid per tp (sized to the largest requested capacity and the
        longest mix — smaller points read the same rows bit-identically)
        and one ``simulate_serving_batch`` call per mix.  Every point
        still lands in (or answers from) the shared cache under its own
        ``serve.capN.tpN.<mix-tag>`` key, bit-identical to the scalar
        call, so follow-up ``latency_serve`` queries on any swept point
        are hits.  ``mix`` may be a single ``schedule.TrafficMix`` or a
        sequence of mix variants sharing the table work.  Returns the
        ``ServeLatencyResult`` list mix-major, then capacity-major (the
        historical grid order)."""
        cfg = self._resolve(model)
        mixes = list(mix) if isinstance(mix, (list, tuple)) else [mix]
        if not mixes:
            return []
        tps = [int(t) for t in tps]
        capacities = [int(c) for c in capacities]
        if (any(c < 1 for c in capacities) or any(t < 1 for t in tps)):
            raise ValueError(
                f"capacity/tp must be >=1: {capacities}, {tps}")
        points = [(c, t) for c in capacities for t in tps]
        # lazy shared tables: prefill over the union of prompt lengths,
        # ctx to the longest mix, one decode grid per tp on first miss
        plens = tuple(sorted({int(p) for m in mixes
                              for p in m.prompt_lens}))
        max_ctx = max(m.max_ctx for m in mixes)
        top = max(capacities)
        shared: dict = {}

        def tables_for(tp, c):
            tab = shared.get(tp)
            if tab is None:
                tab = self._serve_tables(cfg, plens, max_ctx, capacity=top,
                                         tp=tp, dtype=dtype, device=device)
                shared[tp] = tab
            return tab

        out: list = []
        for m in mixes:
            out.extend(self._sweep_serve_points(cfg, m, points, dtype,
                                                device, tables_for))
        return out

    def plan_serving(self, model: Union[str, ModelConfig], mix, *,
                     devices: int = 1,
                     slo_ttft: Optional[float] = None,
                     slo_tpot: Optional[float] = None,
                     memory_gb: Optional[float] = None,
                     max_capacity: int = 32, top_k: int = 3,
                     dtype: Optional[str] = None,
                     device: Optional[str] = None) -> ServingPlan:
        """Serving auto-search, mirroring ``plan_training``: enumerate the
        power-of-two (capacity, tp) grid with ``tp <= devices``, reject
        points whose per-device weights + full KV cache
        (``opgraph.kv_cache_bytes``, both sharded by tp) exceed capacity,
        reject points whose predicted p95 TTFT/TPOT miss the SLO, and
        return the max-tokens/sec survivor.  The whole feasible grid is
        priced in ONE batched pass (one decode grid per tp, one
        ``simulate_serving_batch`` call), and every point shares cache
        entries with ``latency_serve`` / ``sweep_serve`` bit-identically
        — a 32-devices/32-capacity question (36 grid points) is one
        cached call."""
        cfg = self._resolve(model)
        pred = self.predictor.for_device(device)
        devices = int(devices)
        if devices < 1:
            raise ValueError("devices must be >= 1")

        cap: Optional[float] = None
        if memory_gb is not None:
            cap = float(memory_gb) * 2**30
        else:
            self.predictor.host_profile()   # register host in the fleet
            try:
                cap = float(D.get_profile(pred.device).hbm_bytes)
            except KeyError:
                cap = None                  # unknown device: unconstrained

        esz = dtype_bytes(dtype or "float32")
        wbytes = float(cfg.param_count()) * esz
        tps = [1 << i for i in range(devices.bit_length())
               if 1 << i <= devices]
        caps = [1 << i for i in range(int(max_capacity).bit_length())
                if 1 << i <= max_capacity]
        candidates = [(c, t) for c in caps for t in tps]
        feasible = []
        for c, t in candidates:
            kvb = float(og.kv_cache_bytes(cfg, c, mix.max_ctx, dtype=dtype))
            if cap is None or (wbytes + kvb) / t <= cap:
                feasible.append((c, t, kvb))
        if not feasible:
            raise ValueError(
                f"no (capacity, tp) point fits in {cap / 2**30:.1f} GiB: "
                f"weights alone are {wbytes / 2**30:.2f} GiB — raise "
                f"devices/memory or shorten the mix")
        priced = self._sweep_serve_points(
            cfg, mix, [(c, t) for c, t, _ in feasible], dtype, device)
        scored = []
        for (c, t, kvb), r in zip(feasible, priced):
            ok = ((slo_ttft is None or r.ttft_p95 <= slo_ttft)
                  and (slo_tpot is None or r.tpot_p95 <= slo_tpot))
            scored.append((r, kvb, ok))
        meeting = [s for s in scored if s[2]]
        if not meeting:
            best_ttft = min(r.ttft_p95 for r, _, _ in scored)
            best_tpot = min(r.tpot_p95 for r, _, _ in scored)
            raise ValueError(
                f"no feasible point meets the SLO "
                f"(ttft<={slo_ttft}, tpot<={slo_tpot}): best reachable "
                f"p95 ttft={best_ttft:.4f}s tpot={best_tpot:.4f}s")
        meeting.sort(key=lambda s: -s[0].tokens_per_sec)
        win, win_kvb, _ = meeting[0]
        return ServingPlan(
            model=cfg.name, device=pred.device, dtype=dtype or "float32",
            devices=devices, memory_bytes=cap, slo_ttft=slo_ttft,
            slo_tpot=slo_tpot, capacity=win.capacity, tp=win.tp,
            tokens_per_sec=win.tokens_per_sec, ttft_p95=win.ttft_p95,
            tpot_p95=win.tpot_p95, weight_bytes=wbytes,
            kv_cache_bytes=win_kvb, breakdown=win.to_json(),
            n_candidates=len(candidates), n_feasible=len(feasible),
            alternatives=[r.to_json()
                          for r, _, _ in meeting[1:max(top_k, 1)]])

    def decode_oracle(self, model: Union[str, ModelConfig],
                      dtype: Optional[str] = None,
                      device: Optional[str] = None, *,
                      maxsize: int = 4096,
                      capacity: Optional[int] = None,
                      max_ctx: Optional[int] = None):
        """A memoized ``(batch, ctx) -> per-decode-step seconds`` callable
        — the admission-control oracle ``serving/engine.py`` consults
        before seating a request in the decode batch.  The memo is an
        LRU bounded at ``maxsize`` (long engine runs previously grew it
        without limit); pass ``capacity``/``max_ctx`` to pre-price the
        whole ``(1..capacity, 1..max_ctx)`` grid in one
        ``predict_decode_grid`` call, making every in-grid step a pure
        array lookup that never touches the memo.
        ``step_seconds.cache_info()`` reports size/maxsize/grid."""
        cfg = self._resolve(model)
        pred = self.predictor.for_device(device)
        memo: "OrderedDict" = OrderedDict()
        maxsize = max(1, int(maxsize))
        grid = None
        if capacity is not None and max_ctx is not None:
            grid = pred.predict_decode_grid(
                cfg, np.arange(1, int(capacity) + 1),
                np.arange(1, int(max_ctx) + 1), dtype=dtype)

        def step_seconds(batch: int, ctx: int) -> float:
            b, c = int(batch), max(int(ctx), 1)
            if (grid is not None and 1 <= b <= grid.shape[0]
                    and c <= grid.shape[1]):
                return float(grid[b - 1, c - 1])
            val = memo.get((b, c))
            if val is None:
                val = float(pred.predict_decode_grid(
                    cfg, [b], [c], dtype=dtype)[0, 0])
                memo[(b, c)] = val
                if len(memo) > maxsize:
                    memo.popitem(last=False)
            else:
                memo.move_to_end((b, c))
            return val

        step_seconds.cache_info = lambda: {
            "size": len(memo), "maxsize": maxsize,
            "grid": None if grid is None else tuple(grid.shape)}
        return step_seconds

    def latency_breakdown(self, model: Union[str, ModelConfig], batch: int,
                          seq: int, dtype: Optional[str] = None,
                          device: Optional[str] = None) -> dict:
        """Per-op latency rows with oracle-selected kernel attribution (not
        family defaults): the debugging/reporting view behind
        ``latency_query``.  Uncached — the row set is recomputed."""
        cfg = self._resolve(model)
        pred = self.predictor.for_device(device)
        seconds, rows = pred.predict_model(cfg, batch, seq, dtype=dtype)
        return {"model": cfg.name, "device": pred.device,
                "dtype": dtype or "float32", "batch": int(batch),
                "seq": int(seq), "seconds": seconds,
                "rows": [dataclasses.asdict(r) for r in rows]}

    def explain_kernels(self, op_family: str, shape,
                        dtype: Optional[str] = None,
                        device: Optional[str] = None,
                        provider: Optional[str] = "framework") -> list:
        """The oracle's scored candidate list (best first) for one op shape:
        ``shape`` is ``(m, n[, batch])`` for matmul/bmm, ``(skv[, hd])`` for
        attention.  Defaults to the framework provider — the pool
        ``latency_query``/``latency_breakdown`` actually select from — so
        the explanation names the kernel the service runs; pass
        ``provider=None`` to score the full pool (Pallas included)."""
        pred = self.predictor.for_device(device)
        return pred.oracle.explain(op_family, dtype or "float32", shape,
                                   provider=provider)

    def fleet(self) -> list:
        """Devices this service can answer for: the calibrated host plus
        every registered profile."""
        self.predictor.host_profile()       # ensure the host is registered
        return D.list_devices()

    def save_cache(self, path: Optional[str] = None):
        self.cache.save(path)

    @property
    def stats(self) -> dict:
        return self.cache.stats
