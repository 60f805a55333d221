"""The first optimizer steps of one model kind at full width on one card.

    python3 scripts/train_first_steps.py starcoder2-15b --depth 4 \\
        --lr 3e-5 1e-5 3e-6 [--plain] [--steps 4]

For each learning rate and compute dtype (float32, then bf16): the model,
AdamW and data of ``chip_smoke.py``'s phase ``train`` (``train_model``:
seed 0, float32 weights, B 8 x S 512, warm-up 5 steps), then ``--steps``
train steps (remat on); after each, the step's loss and the loss of batch
0 under the updated weights, so that a first step that raises the loss on
the very batch it was taken on shows apart from one batch's loss against
another's.  ``--plain`` runs the float32 steps a second time with the
attention's forward and backward through their plain versions on the card
(``chip_smoke.PlainAttentionOnCard``), the hand kernels out of the path.
One JSON line a run; the card's name and power limit first.  Needs a
card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--lr", type=float, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("train_first_steps: torch finds no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"nvidia_smi": cs.nvidia_smi()}), flush=True)
    cfg0 = cs.cfg_registry.get(args.arch)
    if args.depth is not None:
        cfg0 = dataclasses.replace(cfg0, n_layers=args.depth)
    B, S = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    runs = [(lr, d, False) for lr in args.lr for d in cs.DTYPES]
    if args.plain:
        runs += [(lr, "float32", True) for lr in args.lr]
    for lr, dname, plain in runs:
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        model, params, adamw, batch_at = cs.train_model(cfg, B, S,
                                                        args.steps, lr)
        step = cs.tstep.build_train_step(model, adamw, remat=True)
        state = cs.topt.init_opt_state(params)
        rows = []
        with cs.PlainAttentionOnCard() if plain else contextlib.nullcontext():
            for i in range(args.steps):
                params, state, m = step(params, state, batch_at(i))
                with torch.no_grad():
                    after, _ = cs.tobj.loss_fn(model, batch_at(0))
                rows.append({"loss": float(m["loss"]), "lr": float(m["lr"]),
                             "grad_norm": float(m["grad_norm"]),
                             "batch0_loss_after": float(after)})
        print(json.dumps({"arch": args.arch, "n_layers": cfg.n_layers,
                          "lr": lr, "dtype": dname, "plain": plain,
                          "steps": rows}), flush=True)
        del model, params, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
