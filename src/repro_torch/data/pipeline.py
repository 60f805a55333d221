"""Deterministic synthetic token pipeline (the JAX package's
``data/pipeline.py``).

Reproducible, host-shardable LM batches: Zipf-like unigram tokens with
short copied motifs written over random spans, so that a small model's
loss visibly falls within a few hundred steps.  ``batch_at(step)`` is a
pure function of (seed, step, host): a checkpoint restart resumes
mid-stream with no stored iterator state.  The draws are the reference's,
numpy's, so the tokens equal its tokens; they go to the requested device.
Every rank of a mesh draws the same global batch from ``seed``;
``lay_out`` makes it DTensors laid out by ``specs.batch_specs``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import specs as sp


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pattern_len: int = 8          # copy-motif length
    zipf_a: float = 1.2


class SyntheticLM:
    def __init__(self, cfg: DataConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)
        rng = np.random.default_rng(cfg.seed)
        # fixed bank of motifs the stream repeats (learnable structure)
        self.motifs = rng.integers(
            0, cfg.vocab_size, size=(64, cfg.pattern_len)).astype(np.int32)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self.unigram = (p / p.sum()).astype(np.float64)

    def batch_at(self, step: int, *, host_id: int = 0, num_hosts: int = 1):
        """Returns {"tokens", "labels"}, each (B / num_hosts, seq_len)
        int64 on the pipeline's device; labels are the tokens shifted by
        one."""
        cfg = self.cfg
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        B = cfg.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        S = cfg.seq_len + 1
        noise = rng.choice(cfg.vocab_size, size=(B, S), p=self.unigram)
        seq = noise.astype(np.int32)
        # overwrite random spans with repeated motifs
        n_spans = max(1, S // (4 * cfg.pattern_len))
        for b in range(B):
            for _ in range(n_spans):
                m = self.motifs[rng.integers(0, len(self.motifs))]
                reps = 1 + int(rng.integers(0, 3))
                start = int(rng.integers(0, max(S - reps * cfg.pattern_len, 1)))
                span = np.tile(m, reps)[: S - start]
                seq[b, start:start + len(span)] = span
        seq = torch.from_numpy(seq.astype(np.int64)).to(self.device)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def lay_out(batch: dict) -> dict:
    """Under a ``sharding.mesh_context``: each leaf of the global batch as a
    DTensor laid out by ``specs.batch_specs`` (the batch over dp where it
    divides; each rank keeps its chunk); without a mesh the batch itself."""
    if sh.current_mesh() is None:
        return batch
    specs = sp.batch_specs(batch)
    return {k: sh.distribute(t, specs[k]) for k, t in batch.items()}
