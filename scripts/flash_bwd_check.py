"""Build, check and time the hand flash backward alone on one card.

    python3 scripts/flash_bwd_check.py                  # build, check, time
    python3 scripts/flash_bwd_check.py --time           # the times only
    python3 scripts/flash_bwd_check.py --time --src DIR # another tree's
    python3 scripts/flash_bwd_check.py --train [--src DIR]
    python3 scripts/flash_bwd_check.py --kinds [ARCH ...]
    python3 scripts/flash_bwd_check.py --profile [--src DIR]

Without ``--time``: ``chip_smoke.py``'s build phase (registers, spills,
SASS, blocks per SM and the tile bounds of every kernel) and its
``check_flash_bwd`` (every backward case in both types against the plain
version, and a second launch bit-equal to the first).  Then the
``kernels`` line's backward row (``chip_smoke.bwd_line``): the kernel's
``ms`` and ``device_ms``, the plain version's and SDPA's backward at the
train path's attention (qwen2-0.5b, B 8 x S 512, 14/2 heads of 64,
causal) and at recurrentgemma-2b's (B 1 x S 4096, 10/1 heads of 256,
window 2,048), bf16 and float32.  ``--train``: instead, phase ``train``'s
step (``chip_smoke.train_step_times``: qwen2-0.5b at full width, B 8 x S
512, remat on, split into forward, backward and optimizer) in float32 and
bf16.  ``--kinds``: instead, phase ``train``'s records of the other model
kinds (``chip_smoke.train_kind`` over ``TRAIN_KINDS``, or the archs named,
in that order; a kind that fails is reported and the next one runs),
without PM2Lat's prediction (no calibrated store).
``--profile``: instead, each of the backward's kernels' device
time a call at that attention (``torch.profiler`` over 20 calls, after a
warm-up), in both types.  ``--src`` takes ``repro_torch`` from another
checkout's ``src`` (an older commit unpacked with ``git archive`` into a
directory ``.gitignore`` lists), so that two versions are timed on one
card in one call.  One JSON line a step; the card's name and power limit
first.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true",
                    help="time the backward only (no build report, no checks)")
    ap.add_argument("--train", action="store_true",
                    help="time the training step only")
    ap.add_argument("--kinds", nargs="*", default=None,
                    help="phase train's other model kinds only (all, or "
                         "the archs named)")
    ap.add_argument("--profile", action="store_true",
                    help="each kernel's device time a call only")
    ap.add_argument("--src", help="the src directory of another checkout")
    args = ap.parse_args()
    if args.src:
        # imported first, so that chip_smoke's imports find this tree's
        sys.path.insert(0, str(Path(args.src).resolve()))
        import repro_torch.kernels.flash_attention_bwd  # noqa: F401
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("flash_bwd_check: torch finds no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    src = Path(cs.fkb.__file__).resolve().parents[2]
    print(json.dumps({"nvidia_smi": cs.nvidia_smi(), "src": str(src)}),
          flush=True)
    if args.train:
        import dataclasses
        for dname in cs.DTYPES:
            cfg = dataclasses.replace(cs.cfg_registry.get(cs.MODEL),
                                      compute_dtype=dname)
            print(json.dumps({"train_step": dname,
                              **cs.train_step_times(cfg)}), flush=True)
        return 0
    if args.kinds is not None:
        shapes = {k[0]: k[1:] for k in cs.TRAIN_KINDS}
        failed = []
        for arch in args.kinds or list(shapes):
            try:
                rec = cs.train_kind(None, arch, *shapes[arch])
                print(json.dumps({"train_kind": arch, **rec}), flush=True)
            except Exception as exc:       # report it, go on with the next
                failed.append(arch)
                print(json.dumps({"train_kind": arch, "error": repr(exc)}),
                      flush=True)
        return 1 if failed else 0
    if args.profile:
        gen = torch.Generator(device="cuda").manual_seed(2)
        for dt in (torch.bfloat16, torch.float32):
            a, _, kw = cs.bwd_inputs(cs.bwd_path_cases()[0], dt, gen)
            cs.fkb.flash_attention_bwd_kernel(*a, **kw)
            torch.cuda.synchronize()
            with cs.profile_cuda() as prof:
                for _ in range(20):
                    cs.fkb.flash_attention_bwd_kernel(*a, **kw)
                torch.cuda.synchronize()
            rows = cs.device_rows(prof)
            print(json.dumps({"profile": str(dt).split(".")[1],
                              "us_a_call": {name: ms * 1e3 / 20 for name, (_, ms)
                                            in rows.items()}}), flush=True)
        return 0
    if not args.time:
        cs.phase_build()
        worst, rows = cs.check_flash_bwd(("float32", "bfloat16"))
        print(json.dumps({"bwd_checks": len(rows), "max_rel_err": worst,
                          "rows": rows}), flush=True)
    cs.fkb.flash_attention_bwd_kernel.launches = 0
    gen = torch.Generator(device="cuda").manual_seed(2)
    line = cs.bwd_line(gen, {"train": {"flash_attention_bwd": 0}}, {})
    print(json.dumps({"bwd_line": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
