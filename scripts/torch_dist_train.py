"""One rank of the port's sharded training launcher, with what the rank
saw: run under torchrun, one process a rank.

    python3 -m torch.distributed.run --standalone --nproc_per_node N \\
        scripts/torch_dist_train.py --record OUT/prefix [--psum-check] \\
        [-- <repro_torch.launch.train arguments>]

Joins the process group (``launch.train.maybe_init_distributed``), runs
``launch.train.run`` with the arguments after ``--`` (``--mesh``,
``--device``, ...) on ``--dist-backend`` (default: NCCL on the card), and
writes ``<prefix><rank>.json``:
the launcher's result (losses, step seconds, mesh), this rank's device and
its hand-kernel launches, counted from 0 in this process (the flash
forward and backward, the matmul).  With ``--psum-check`` (a gloo group)
it then runs ``compressed_psum`` over every rank on CUDA tensors and on
CPU tensors holding the same seeded rows and records whether the two sums
are equal bit for bit.  Without launcher arguments it trains nothing and
joins the group on ``--device``.  Exits non-zero
on any failure.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fkb  # noqa: E402
from repro_torch.kernels import matmul as mk  # noqa: E402
from repro_torch.launch import train  # noqa: E402

PSUM_N = 1 << 16          # elements a rank: 256 chunks of the codec


def psum_check(device: str) -> dict:
    """``compressed_psum`` of each rank's seeded row on ``device`` and on
    the CPU, over the world: the largest difference and bit equality."""
    rank = dist.get_rank()
    row = np.random.default_rng(rank).standard_normal(PSUM_N).astype(
        np.float32)
    on_card = comp.compressed_psum(torch.from_numpy(row).to(device),
                                   dist.group.WORLD).cpu()
    on_host = comp.compressed_psum(torch.from_numpy(row), dist.group.WORLD)
    return {"n": PSUM_N, "bit_equal": bool(torch.equal(on_card, on_host)),
            "max_abs_diff": float((on_card - on_host).abs().max())}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--record", required=True)
    ap.add_argument("--psum-check", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"])
    own = ap.parse_args(argv[:split])
    args = train.parse_args(argv[split + 1:]) if argv[split + 1:] else None
    device, owns = train.maybe_init_distributed(
        args.device if args else own.device, own.dist_backend)
    try:
        result = None
        if args is not None:
            args.device = device
            result = train.run(args)
        rec = {"rank": dist.get_rank(), "world": dist.get_world_size(),
               "backend": dist.get_backend(), "device": device,
               "result": result,
               "launches": {"flash_attention": fk.flash_attention_kernel.launches,
                            "flash_attention_bwd":
                                fkb.flash_attention_bwd_kernel.launches,
                            "matmul": mk.matmul_kernel.launches}}
        if own.psum_check:
            rec["psum"] = psum_check(device)
        Path(f"{own.record}{rec['rank']}.json").write_text(json.dumps(rec))
    finally:
        if owns:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
