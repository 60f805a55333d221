"""Table VI reproduction: PM2Lat error on custom kernels, the port's hand
CUDA kernels (the ports of the JAX package's two Pallas kernels): the
tiled matmul (every ``mm_<cfg>`` of ``kernels.matmul.CONFIGS``) and the
flash-attention forward (every ``fa_<cfg>`` of
``kernels.flash_attention.CONFIGS``), and cuBLAS batched products through
the oracle's nearest-grid pick.

Selection is driven by the kernel-selection oracle (``core/oracle.py``):
for every sampled shape the oracle picks the profiled table it believes
the library would run, every hand config is measured, and each row holds
the pick, the measured fastest and every config's error, so the report
has the oracle's pick against the measured fastest (the paper's
kernel-differentiation claim) beside the error of the pick and of every
config.  The shapes are drawn from ``seed`` in the JAX package's order
(matmuls, flash calls, batched products), taken again for each dtype,
from one of two ranges (``DRAWS``): the JAX package's own, or wider ones.

    PYTHONPATH=src python -m repro_torch.benchmarks.table6_custom_kernels
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.core import profiler
from repro_torch.core.device import resolve
from repro_torch.core.oracle import PROVIDER_PALLAS
from repro_torch.core.predictor import PM2Lat
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import matmul as mk

DTYPES = ("float32", "bfloat16")
HEAD_DIM = 64
# The ranges of the sampled shapes: the matmuls' (block, then the upper
# bounds, exclusive, of m, n and k in blocks) and the flash calls' (upper
# bounds of b·h and of S in 128-row blocks).  "reference" is the JAX
# package's draw, sized for its interpret mode (on an H100 its calls take
# 0.015-0.14 ms: launch-bound, under one wave); "wide" reaches 1024 x 1024
# x 2048 matmuls and b·h 16 x S 1024 flash calls.
DRAWS = {"reference": {"mm": (256, 3, 3, 6), "fa": (6, 6)},
         "wide": {"mm": (128, 9, 9, 17), "fa": (17, 9)}}


def _mm_rows(oracle, rng, samples, dname, dev, draw):
    dt = getattr(torch, dname)
    blk, m_hi, n_hi, k_hi = draw  # every config runs a multiple of its tiles
    rows = []
    for _ in range(samples):
        m = blk * int(rng.integers(1, m_hi))
        n = blk * int(rng.integers(1, n_hi))
        k = blk * int(rng.integers(1, k_hi))
        a = torch.ones((m, k), dtype=dt, device=dev)
        b = torch.ones((k, n), dtype=dt, device=dev)
        pick = oracle.select_matmul("matmul", dname, m, n,
                                    provider=PROVIDER_PALLAS).key.kernel
        meas, err = {}, {}
        for cfg in mk.CONFIGS:
            meas[cfg.name] = profiler.measure(
                lambda a, b, cfg=cfg: mk.matmul_kernel(a, b, cfg), a, b,
                device=dev)
            pred = oracle.lookup("matmul", cfg.name, dname).predict(
                m, n, k, tile=(cfg.bm, cfg.bn))
            err[cfg.name] = common.rel_err(pred, meas[cfg.name])
        rows.append({"dtype": dname, "shape": [m, n, k], "pick": pick,
                     "fastest": min(meas, key=meas.get),
                     "ms": {c: s * 1e3 for c, s in meas.items()},
                     "rel_err": err})
    return rows


def _fa_rows(oracle, rng, samples, dname, dev, draw):
    dt = getattr(torch, dname)
    bh_hi, s_hi = draw
    rows = []
    for _ in range(samples):
        bh = int(rng.integers(2, bh_hi))
        s = 128 * int(rng.integers(1, s_hi))
        q = torch.ones((bh, s, HEAD_DIM), dtype=dt, device=dev)
        pick = oracle.select_attention(dname, s, head_dim=HEAD_DIM,
                                       provider=PROVIDER_PALLAS).key.kernel
        flops = 4.0 * bh * s * s * HEAD_DIM
        meas, err = {}, {}
        for cfg in fk.CONFIGS:
            meas[cfg.name] = profiler.measure(
                lambda q, k, v, cfg=cfg: fk.flash_attention_kernel(
                    q, k, v, cfg, causal=True), q, q, q, device=dev)
            t = oracle.lookup("attention", cfg.name, dname)
            err[cfg.name] = common.rel_err(
                flops / t.interpolate_throughput(s), meas[cfg.name])
        rows.append({"dtype": dname, "bh": bh, "s": s, "hd": HEAD_DIM,
                     "pick": pick, "fastest": min(meas, key=meas.get),
                     "ms": {c: x * 1e3 for c, x in meas.items()},
                     "rel_err": err})
    return rows


def _bmm_rows(oracle, rng, samples, dname, dev):
    dt = getattr(torch, dname)
    rows = []
    for _ in range(samples):
        b0 = int(2 ** rng.integers(1, 5))
        m = int(2 ** rng.integers(6, 9))
        n = int(2 ** rng.integers(6, 9))
        k = int(2 ** rng.integers(6, 11))
        sel = oracle.select_matmul("bmm", dname, m, n, batch=b0)
        a = torch.ones((b0, m, k), dtype=dt, device=dev)
        b = torch.ones((b0, k, n), dtype=dt, device=dev)
        meas = profiler.measure(torch.bmm, a, b, device=dev)
        rows.append({"dtype": dname, "shape": [b0, m, n, k],
                     "pick": sel.key.kernel, "ms": meas * 1e3,
                     "rel_err": common.rel_err(
                         sel.predict(m, n, k, batch=b0), meas)})
    return rows


def summarize(out: dict) -> dict:
    """Per family and dtype: the mean error of the oracle's pick (%), of
    every hand config, and the share of rows whose pick was the measured
    fastest (%)."""
    summary = {}
    for fam in ("mm", "fa"):
        for dname in sorted({r["dtype"] for r in out[fam]}):
            rows = [r for r in out[fam] if r["dtype"] == dname]
            summary[f"{fam}/{dname}"] = {
                "oracle_pick_err_pct": 100 * float(np.mean(
                    [r["rel_err"][r["pick"]] for r in rows])),
                "all_configs_err_pct": 100 * float(np.mean(
                    [e for r in rows for e in r["rel_err"].values()])),
                "oracle_picked_fastest_pct": 100 * float(np.mean(
                    [r["pick"] == r["fastest"] for r in rows]))}
    for dname in sorted({r["dtype"] for r in out["bmm"]}):
        summary[f"bmm/{dname}"] = {"oracle_pick_err_pct": 100 * float(
            np.mean([r["rel_err"] for r in out["bmm"]
                     if r["dtype"] == dname]))}
    return summary


def run(store=None, *, samples=6, seed=0, dtypes=DTYPES, device="cuda",
        draws="reference", verbose=True) -> dict:
    """``{"mm", "fa", "bmm"}``: one row per sampled shape and dtype, and
    ``"summary"`` (``summarize``), the shapes from ``DRAWS[draws]``.
    ``store``: default the device's (``common.get_calibration``)."""
    dev = resolve(device)
    store = store or common.get_calibration(dev)
    oracle = PM2Lat(store, store.meta["device"]).oracle
    out = {"mm": [], "fa": [], "bmm": []}
    for dname in dtypes:
        rng = np.random.default_rng(seed)
        out["mm"] += _mm_rows(oracle, rng, samples, dname, dev,
                              DRAWS[draws]["mm"])
        out["fa"] += _fa_rows(oracle, rng, samples, dname, dev,
                              DRAWS[draws]["fa"])
        out["bmm"] += _bmm_rows(oracle, rng, samples, dname, dev)
    if verbose:
        for r in out["mm"]:
            m, n, k = r["shape"]
            print(f"  mm {r['dtype']} {m}x{n}x{k}: oracle={r['pick']} "
                  f"fastest={r['fastest']} "
                  f"err={r['rel_err'][r['pick']] * 100:.1f}%")
        for r in out["fa"]:
            print(f"  fa {r['dtype']} bh={r['bh']} S={r['s']}: "
                  f"oracle={r['pick']} fastest={r['fastest']} "
                  f"err={r['rel_err'][r['pick']] * 100:.1f}%")
    out["summary"] = summarize(out)
    for name, s in out["summary"].items():
        for metric, v in s.items():
            common.emit(f"table6/{draws}/{name}/{metric}", 0.0, f"{v:.1f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", choices=sorted(DRAWS), default="reference")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = run(samples=args.samples, seed=args.seed, device=args.device,
              draws=args.draws)
    print(f"wrote {common.write_bench('table6', out, path=args.json)}")


if __name__ == "__main__":
    main()
