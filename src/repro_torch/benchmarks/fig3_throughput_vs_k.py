"""Fig. 3/4 reproduction: (a) duration vs K is near-linear at fixed grid
(SIMT/systolic lockstep claim) but linear regression degrades at small K;
(b) throughput vs K follows a rational trend — rational fit beats both
linear-duration and log fits.

Reads the store's ``cublas@512x512`` table of ``dtype`` (the counterpart of
the JAX package's ``xla_default@512x512``); the arithmetic is the JAX
package's.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_throughput_vs_k
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core.table import KernelKey

KERNEL = "cublas@512x512"


def run(store, dtype="float32") -> dict:
    t = store.get(KernelKey("matmul", KERNEL, dtype, store.meta["device"]))
    ks = np.array(sorted(t.anchors), dtype=np.float64)
    thr = np.array([t.anchors[int(k)] for k in ks])
    durs = 2.0 * 512 * 512 * ks / thr

    # linear duration fit (the naive model the paper critiques)
    A = np.stack([ks, np.ones_like(ks)], 1)
    coef, *_ = np.linalg.lstsq(A, durs, rcond=None)
    lin_pred = A @ coef
    lin_err = np.abs(lin_pred - durs) / durs
    # rational throughput fit (the paper's observed trend)
    a, b, c, d = t.fit_rational()
    rat_thr = (a * ks + b) / (c * ks + d)
    rat_dur = 2.0 * 512 * 512 * ks / rat_thr
    rat_err = np.abs(rat_dur - durs) / durs
    # log fit of throughput (the alternative the paper found poor)
    lcoef, *_ = np.linalg.lstsq(np.stack([np.log(ks), np.ones_like(ks)], 1),
                                thr, rcond=None)
    log_thr = np.log(ks) * lcoef[0] + lcoef[1]
    log_err = np.abs(2.0 * 512 * 512 * ks / np.maximum(log_thr, 1e3) - durs) / durs

    return {
        "linear_dur_fit_err_pct_all": float(lin_err.mean()) * 100,
        "linear_dur_fit_err_pct_smallK": float(lin_err[ks <= 256].mean()) * 100,
        "rational_fit_err_pct": float(rat_err.mean()) * 100,
        "log_fit_err_pct": float(log_err.mean()) * 100,
        "throughput_saturation_ratio": float(thr.max() / thr.min()),
    }


if __name__ == "__main__":
    store = common.get_calibration()
    print(json.dumps({dt: run(store, dt) for dt in ("float32", "bfloat16")},
                     indent=1))
