"""NAS-preprocessing batch prediction (paper application §IV-D2).

The paper's example: a Transformer search space where a single MatMul layer
has >400M (feature, batch, seqlen) configurations; precomputing a latency
cache takes ~0.045 ms/prediction with PM2Lat (the paper's number).
``precompute_cache`` runs the vectorized ``BatchPredictor`` — including the
nearest-grid kernel-selection oracle — over (a sample of) the grid in
chunked numpy calls and reports microseconds/prediction.  A copy of the
JAX package's module.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.batch_predict import BatchPredictor
from repro_torch.core.table import TableStore


@dataclasses.dataclass
class NASGrid:
    features: Sequence[int] = (128, 160, 192, 224, 256, 320, 384, 448, 512,
                               576, 640, 704, 768, 832, 896, 960, 1024, 1152,
                               1280, 1408, 1536, 1664, 1792, 1920, 2048, 2560,
                               3072, 3584, 4096, 5120, 6144, 8192)  # 32 choices
    batches: Sequence[int] = tuple(range(1, 257))              # 1..256
    seq_lens: Sequence[int] = (64, 128, 256, 512, 1024, 2048, 4096, 8192)

    @property
    def n_configs(self) -> int:
        # (in_feat x out_feat) x batch x seq
        return (len(self.features) ** 2) * len(self.batches) * len(self.seq_lens)


def precompute_cache(store: TableStore, device: str, *,
                     grid: NASGrid = NASGrid(), dtype: str = "float32",
                     limit: int = 2_000_000, chunk: int = 1 << 22,
                     predictor: Optional[BatchPredictor] = None):
    """Predict latency for (a sample of) the NAS grid through the batch
    engine (kernel-selection oracle + vectorized Eq(1)/(2)).  Returns
    (cache array, seconds_total, us_per_prediction, n)."""
    pred = predictor or BatchPredictor(store, device)
    f = np.asarray(grid.features, np.int64)
    bsz = np.asarray(grid.batches, np.int64)
    sl = np.asarray(grid.seq_lens, np.int64)
    # layer: (batch*seq, out_feat) = (batch*seq, in_feat) @ (in_feat, out_feat)
    M = (bsz[:, None] * sl[None, :]).reshape(-1)       # batch x seq
    n_total = len(f) * len(f) * len(M)
    stride = max(1, n_total // max(int(limit), 1))
    ms = M[::stride] if stride > 1 else M
    nf, nm = len(f), len(ms)
    count = nf * nf * nm
    cache = np.empty(count)
    t0 = time.perf_counter()
    # full (in_feat, out_feat, M) mesh, enumerated by flat index per chunk
    for off in range(0, count, chunk):
        idx = np.arange(off, min(off + chunk, count))
        fin = f[idx // (nf * nm)]
        fout = f[(idx // nm) % nf]
        mv = ms[idx % nm]
        cache[idx] = pred.predict_matmul_batch(mv, fout, fin, dtype=dtype)
    dt = time.perf_counter() - t0
    return cache, dt, dt / count * 1e6, count
