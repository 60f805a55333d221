"""Which collectives gloo carries on CUDA tensors of ranks that share one
card, and the codec's division on the card against the host's.

    python3 scripts/torch_gloo_cuda_check.py [--out chiprun_out/gloo_cuda_check.json]

For each case it starts ``torch.distributed.run --standalone
--nproc_per_node 2`` on this script with ``--case NAME`` (gloo, both ranks
on ``cuda:0``), so a case that crashes a rank takes only its own run down,
and records its exit code and the last line of its output: gloo's own
collectives (all-reduce sum, max and int32, all-gather, all-gather into a
tensor, reduce-scatter, broadcast, all-to-all, barrier), a ``DeviceMesh``
over the two ranks, and DTensor's redistribution (``full_tensor``, and a
sharded matmul gathered).  Then, in this process, the int8 codec's scale
(a chunk's largest |value| over 127) on the card and on the host, with
127 as a Python number and as a tensor: how many of 65,536 scales differ.
Prints one JSON line (and writes it to ``--out``).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

CASES = ("all_reduce", "all_reduce_max", "all_reduce_int", "all_gather",
         "all_gather_into_tensor", "reduce_scatter_tensor", "broadcast",
         "all_to_all_single", "barrier", "device_mesh", "dtensor_full_tensor",
         "dtensor_matmul")


def run_case(name: str) -> str:
    """One case on this rank (gloo, ``cuda:0``); returns what it got."""
    import torch.distributed as dist
    dist.init_process_group("gloo")
    try:
        rank, dev = dist.get_rank(), "cuda:0"
        torch.cuda.set_device(0)
        x = torch.ones(8, device=dev) * (rank + 1)
        out = x
        if name == "all_reduce":
            dist.all_reduce(x)
        elif name == "all_reduce_max":
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
        elif name == "all_reduce_int":
            out = x.int()
            dist.all_reduce(out)
        elif name == "all_gather":
            parts = [torch.empty(8, device=dev) for _ in range(2)]
            dist.all_gather(parts, x)
            out = torch.cat(parts)
        elif name == "all_gather_into_tensor":
            out = torch.empty(16, device=dev)
            dist.all_gather_into_tensor(out, x)
        elif name == "reduce_scatter_tensor":
            out = torch.empty(4, device=dev)
            dist.reduce_scatter_tensor(out, x)
        elif name == "broadcast":
            dist.broadcast(x, 0)
        elif name == "all_to_all_single":
            out = torch.empty(8, device=dev)
            dist.all_to_all_single(out, x)
        elif name == "barrier":
            dist.barrier()
        else:
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import (Replicate, Shard,
                                                  distribute_tensor)
            mesh = init_device_mesh("cuda", (1, 2),
                                    mesh_dim_names=("data", "model"))
            a = distribute_tensor(
                torch.arange(16.0, device=dev).reshape(4, 4), mesh,
                [Replicate(), Shard(1)], src_data_rank=None)
            if name == "dtensor_full_tensor":
                out = a.full_tensor()
            elif name == "dtensor_matmul":
                b = distribute_tensor(torch.eye(4, device=dev), mesh,
                                      [Replicate(), Shard(0)],
                                      src_data_rank=None)
                out = (a @ b).full_tensor()
            else:
                out = a.to_local()
        torch.cuda.synchronize()
        return json.dumps({"case": name, "rank": rank,
                           "sum": float(out.float().sum())})
    finally:
        dist.destroy_process_group()


def codec_division() -> dict:
    """The codec's scales on the card against the host's."""
    gen = torch.Generator().manual_seed(0)
    amax = torch.rand(1 << 16, generator=gen) * 10
    host = amax / 127.0
    by_number = (amax.cuda() / 127.0).cpu()
    by_tensor = (amax.cuda() / torch.full_like(amax.cuda(), 127.0)).cpu()
    return {"n": amax.numel(),
            "differ_dividing_by_a_number": int((by_number != host).sum()),
            "differ_dividing_by_a_tensor": int((by_tensor != host).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=CASES)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.case:
        print(run_case(args.case), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 2
    cases = {}
    for name in CASES:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", __file__, "--case", name],
            capture_output=True, text=True, timeout=180,
            env=dict(os.environ, PYTHONFAULTHANDLER="1"))
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        err = [ln for ln in proc.stderr.splitlines()
               if "Error" in ln or "Signal" in ln or "Fatal" in ln]
        cases[name] = {"rc": proc.returncode, "ranks_done": len(lines),
                       "error": err[-1].strip() if err else None}
    rec = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cases": cases, "codec_division": codec_division()}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
