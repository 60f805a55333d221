"""Batched serving engine: waves of requests over the model's prefill and
decode steps, with greedy/temperature sampling (the JAX package's
``serving/engine.py``).

The engine seats up to ``max_batch`` requests a wave, left-pads their
prompts to one length, prefills them together (with the model's stub
context, ``make_ctx``, where it takes one) and decodes them in lockstep.  The JAX engine compiles its decode step once (``jax.jit``,
fixed shapes); here the counterpart on the card is a CUDA graph of one
decode step, captured once per (wave batch, cache capacity) and replayed
for every token, so a step costs one launch instead of the ~1,000 eager
PyTorch calls.  On the CPU the same step runs eagerly.  The choice is
made by the tensors' device, as the kernel wrappers make theirs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: Optional[list] = None
    t_submit: float = 0.0
    t_first_token: float = 0.0    # set at the prefill that seats the slot
    t_done: float = 0.0


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    tokens_out: int = 0
    ttfts: List[float] = dataclasses.field(default_factory=list)
    tpots: List[float] = dataclasses.field(default_factory=list)

    def throughput(self, wall_s: float) -> float:
        return self.tokens_out / max(wall_s, 1e-9)

    def _pct(self, xs: List[float], q: float) -> float:
        return float(np.percentile(xs, q)) if xs else 0.0

    @property
    def ttft_p50(self) -> float:
        return self._pct(self.ttfts, 50)

    @property
    def ttft_p95(self) -> float:
        return self._pct(self.ttfts, 95)

    @property
    def tpot_p50(self) -> float:
        return self._pct(self.tpots, 50)

    @property
    def tpot_p95(self) -> float:
        return self._pct(self.tpots, 95)


class DecodeGraph:
    """One decode step of ``model`` captured as a CUDA graph over static
    buffers: a token vector, a ``KVCache`` shaped like ``like`` and the
    logits.  ``load`` copies a prefilled cache in; each call copies the
    tokens in and replays, which advances the static cache's ``pos`` on
    the device.  A failed capture raises."""

    def __init__(self, model, like):
        self.model = model
        self.cache = like.clone()
        self.token = torch.zeros(like.batch, dtype=torch.int64,
                                 device=like.pos.device)
        # warm up on a side stream (cuBLAS handles, allocator pools), then
        # capture; the warm-up's writes land in the static cache, which
        # ``load`` overwrites before any replay
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.no_grad():
            with torch.cuda.stream(side):
                model.decode_step(self.token, self.cache)
            torch.cuda.current_stream().wait_stream(side)
            self.cache.copy_(like)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.logits, _ = model.decode_step(self.token, self.cache)

    def load(self, cache) -> "DecodeGraph":
        self.cache.copy_(cache)
        return self

    def __call__(self, token: torch.Tensor) -> torch.Tensor:
        self.token.copy_(token)
        self.graph.replay()
        return self.logits


class ServingEngine:
    def __init__(self, model, *, max_batch: int = 4, max_len: int = 256,
                 seed: int = 0, admission_oracle=None,
                 slo_tpot: Optional[float] = None):
        """``model``: a ``models.transformer.Transformer`` (its weights
        included).  ``admission_oracle`` is a ``(batch, ctx) -> seconds``
        per-decode-step latency predictor; with an ``slo_tpot`` bound the
        engine consults it BEFORE seating a wave and shrinks the decode
        batch until the predicted per-token latency at the wave's
        worst-case context meets the bound."""
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.rng = np.random.default_rng(seed)
        self.stats = EngineStats()
        self.admission_oracle = admission_oracle
        self.slo_tpot = slo_tpot
        self._graphs: Dict[Tuple[int, int], DecodeGraph] = {}

    def _admit(self, queue: List[Request]) -> List[Request]:
        """Next wave under admission control: start from ``max_batch``
        candidates and shrink while the oracle predicts the decode step at
        the wave's worst-case context would violate ``slo_tpot``; a single
        request is always admitted (shrinking to zero would starve)."""
        k = min(self.max_batch, len(queue))
        if self.admission_oracle is not None and self.slo_tpot is not None:
            while k > 1:
                ctx = max(len(r.prompt) + r.max_new_tokens
                          for r in queue[:k])
                if self.admission_oracle(k, ctx) <= self.slo_tpot:
                    break
                k -= 1
        return queue[:k]

    def _sample(self, logits: torch.Tensor, wave: List[Request]) -> np.ndarray:
        """One token a row: the argmax of the logits cut to ``vocab_size``
        at temperature 0, taken on the logits' device so that only the
        indices cross to the host; above it a draw from softmax(logits /
        temperature) by the engine's seeded numpy generator, as the JAX
        engine draws."""
        vocab = self.model.cfg.vocab_size
        cut = logits[:, :vocab]
        out = cut.argmax(-1).cpu().numpy().astype(np.int32)
        for i, r in enumerate(wave):
            if r.temperature > 0:
                z = cut[i].float().cpu().numpy() / r.temperature
                z -= z.max()
                p = np.exp(z)
                p /= p.sum()
                out[i] = int(self.rng.choice(vocab, p=p))
        return out

    def _stepper(self, cache):
        """The wave's decode step, token (B,) -> logits (B, Vp): the CUDA
        graph for the cache's (batch, capacity), captured at first use, on
        the card; the eager step on the CPU."""
        if not cache.pos.is_cuda:
            return lambda tok: self.model.decode_step(tok, cache)[0]
        key = (cache.batch, cache.capacity)
        if key not in self._graphs:
            self._graphs[key] = DecodeGraph(self.model, cache)
        return self._graphs[key].load(cache)

    def run(self, requests: List[Request]) -> List[Request]:
        """Batched prefill + batched decode, wave after wave (one host)."""
        with torch.no_grad():
            return self._run(requests)

    def _run(self, requests: List[Request]) -> List[Request]:
        t_start = time.perf_counter()
        dev = self.model.embed.w.device
        queue = list(requests)
        for r in queue:
            r.t_submit = time.perf_counter()
            r.out_tokens = []
        done: List[Request] = []
        # serve in waves of max_batch with identical prompt lengths per wave
        while queue:
            wave = self._admit(queue)
            queue = queue[len(wave):]
            S = max(len(r.prompt) for r in wave)
            steps = max(r.max_new_tokens for r in wave)
            if S + steps - 1 > max(self.max_len, S):
                raise ValueError(f"a wave of prompt length {S} and {steps} "
                                 f"new tokens needs max_len >= "
                                 f"{S + steps - 1}, got {self.max_len}")
            toks = np.zeros((len(wave), S), np.int32)
            for i, r in enumerate(wave):
                toks[i, S - len(r.prompt):] = r.prompt  # left-pad
            ctx = self.model.make_ctx(len(wave))
            logits, cache = self.model.prefill(
                torch.from_numpy(toks).long().to(dev), ctx_embed=ctx,
                max_len=self.max_len)
            self.stats.prefills += 1
            next_tok = self._sample(logits, wave)
            t_first = time.perf_counter()   # first token sampled at prefill
            for r in wave:
                r.t_first_token = t_first
            live = list(range(len(wave)))
            step = None
            for _ in range(steps):
                for i in live:
                    wave[i].out_tokens.append(int(next_tok[i]))
                live = [i for i in live
                        if len(wave[i].out_tokens) < wave[i].max_new_tokens]
                if not live:
                    break
                if step is None:
                    step = self._stepper(cache)
                logits = step(torch.from_numpy(next_tok).long().to(dev))
                self.stats.decode_steps += 1
                next_tok = self._sample(logits, wave)
            for r in wave:
                r.t_done = time.perf_counter()
                self.stats.tokens_out += len(r.out_tokens)
                self.stats.ttfts.append(r.t_first_token - r.t_submit)
                if len(r.out_tokens) > 1:
                    self.stats.tpots.append(
                        (r.t_done - r.t_first_token)
                        / (len(r.out_tokens) - 1))
                done.append(r)
        self.wall_s = time.perf_counter() - t_start
        return done
