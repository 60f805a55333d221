"""Fleet comparison: every registered architecture x device x dtype, one
per-device latency matrix (the cross-device sweep the paper runs over its
five GPUs, here over the fleet registry).  The JAX package's
``benchmarks/fleet_compare.py`` on the device's store.

The store's tables are re-anchored onto each target by the roofline-ratio
transfer (``core/transfer.py``); each cell is a whole-model forward's
latency from one symbolic grid prediction per (arch, device, dtype).

    PYTHONPATH=src python -m repro_torch.benchmarks.fleet_compare
        [--batch 8] [--seq 256] [--devices a100_80g,l4]
        [--archs qwen3-mini] [--dtypes float32] [--json PATH]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.benchmarks import common
from repro_torch.configs import registry as cr
from repro_torch.core import devices as D
from repro_torch.core.batch_predict import BatchPredictor
from repro_torch.core.device import resolve


def sweep_archs():
    """The paper's miniatures and every architecture's reduced stand-in
    (the predictor never allocates a model; reduced keeps the features'
    enumeration small)."""
    names = list(cr.PAPER_MODELS) + [f"{n}-reduced" for n in cr.ARCH_NAMES]
    return {n: cr.get_any(n) for n in names}


def run(store=None, *, batch=8, seq=256, devices=None, archs=None,
        dtypes=None, device="cuda", verbose=True) -> dict:
    """{arch: {dtype: {device: seconds}}}."""
    store = store or common.get_calibration(resolve(device))
    bp = BatchPredictor(store, store.meta["device"])
    bp.host_profile()                       # register the store's device
    devices = devices or D.list_devices()
    dtypes = dtypes or sorted({t.key.dtype for t in store.tables.values()})
    cfgs = {n: cr.get_any(n) for n in archs} if archs else sweep_archs()

    matrix = {}
    for name, cfg in cfgs.items():
        matrix[name] = {}
        for dt in dtypes:
            matrix[name][dt] = {
                dev: float(bp.predict_model_grid(cfg, [batch], [seq], dt,
                                                 device=dev)[0, 0])
                for dev in devices}
    if verbose:
        for dt in dtypes:
            hdr = f"{'arch (b=%d s=%d %s)' % (batch, seq, dt):34s}"
            print(hdr + "".join(f"{d:>12s}" for d in devices))
            for name in matrix:
                row = matrix[name][dt]
                print(f"{name:34s}"
                      + "".join(f"{row[d]*1e3:11.3f}m" for d in devices))
    for name in matrix:
        for dt in dtypes:
            for dev, sec in matrix[name][dt].items():
                common.emit(f"fleet/{name}/{dt}/{dev}_ms", sec * 1e3,
                            f"{sec*1e3:.4f}")
    return matrix


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--devices", default=None,
                    help="comma-separated registry names (default: all)")
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch names (default: full sweep)")
    ap.add_argument("--dtypes", default=None,
                    help="comma-separated dtypes (default: calibrated ones)")
    ap.add_argument("--json", default=None, help="write the matrix here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    split = lambda s: s.split(",") if s else None
    matrix = run(batch=args.batch, seq=args.seq, devices=split(args.devices),
                 archs=split(args.archs), dtypes=split(args.dtypes),
                 device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"batch": args.batch, "seq": args.seq,
                       "latency_s": matrix}, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
