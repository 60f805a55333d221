"""The port's fault-tolerant training on one card: a run with injected
failures against an uninterrupted one, and a checkpoint restored bit for
bit.

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 scripts/torch_train_restart.py DIR

Runs ``launch.train.run`` twice at ``--reduced`` size on the card, under
``torch.use_deterministic_algorithms(True, warn_only=True)``: uninterrupted,
and with ``--fail-at`` (two restarts from the latest checkpoint).  Then
trains the reduced model two steps, saves its state (float32 parameters,
AdamW's step and moments, and a bfloat16 copy of the parameters) and
restores it into zeroed tensors.  ``chip_smoke.py`` runs it in a process of
its own because cuBLAS reads ``CUBLAS_WORKSPACE_CONFIG`` once, at its
first call.  Checkpoints go under DIR (removed at the end).  Prints one
JSON line: the losses of both runs, whether they are equal bit for bit,
their largest difference, the restarts, each operation PyTorch warned has
no deterministic implementation, and whether every restored leaf equals
the saved one bit for bit.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import shutil
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint.store import CheckpointStore, leaves  # noqa: E402
from repro_torch.configs import registry as cfg_registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402

ARCH = "qwen2-0.5b"
ARGS = ["--arch", ARCH, "--reduced", "--steps", "10", "--batch", "8",
        "--seq", "128", "--ckpt-every", "3"]
FAIL_AT = ["--fail-at", "4", "8"]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def restored_bitwise(directory: Path) -> dict:
    """Train the reduced model two steps, save its state with a bf16 copy
    of its parameters, restore into zeros: every leaf equal, bit for bit."""
    cfg = cfg_registry.reduced(ARCH)
    model = model_registry.build(cfg, device="cuda", seed=1)
    params = tstep.trainable_params(model)
    step = tstep.build_train_step(model, topt.AdamWConfig(lr=1e-3))
    state = topt.init_opt_state(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=4), device="cuda")
    for s in range(2):
        params, state, _ = step(params, state, data.batch_at(s))
    saved = (params, state,
             {k: p.detach().bfloat16() for k, p in params.items()})
    store = CheckpointStore(str(directory), async_write=False)
    store.save(2, saved)
    zeros = lambda d: {k: torch.zeros_like(v) for k, v in d.items()}
    like = (zeros(params), topt.OptState(step=torch.zeros_like(state.step),
                                         m=zeros(state.m), v=zeros(state.v)),
            zeros(saved[2]))
    store.restore(2, like)
    pairs = list(zip(leaves(saved), leaves(like)))
    equal = all(pa == pb and a.dtype == b.dtype and torch.equal(bits(a),
                                                                bits(b))
                for (pa, a), (pb, b) in pairs)
    return {"restored_bitwise": equal, "leaves": len(pairs),
            "bf16_leaves": sum(a.dtype == torch.bfloat16 for _, a in
                               leaves(saved)),
            "checkpoint_bytes": store.writes[0]["bytes"]}


def main(directory: Path) -> int:
    if not torch.cuda.is_available():
        print("torch_train_restart: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    shutil.rmtree(directory, ignore_errors=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            base = train.run(train.parse_args(
                ARGS + ["--ckpt-dir", str(directory / "a")]))
            failed = train.run(train.parse_args(
                ARGS + FAIL_AT + ["--ckpt-dir", str(directory / "b")]))
        nondet = sorted({str(w.message).split(" does not have")[0]
                         for w in caught
                         if "deterministic" in str(w.message)})
        d1 = dict(zip(base["steps"], base["losses"]))
        d2 = dict(zip(failed["steps"], failed["losses"]))
        out = {"arch": ARCH, "args": ARGS + FAIL_AT,
               "losses": base["losses"], "losses_failed": failed["losses"],
               "steps_failed": failed["steps"],
               "restarts": failed["restarts"],
               "bitwise_equal": d1 == d2 and set(d1) == set(d2),
               "max_abs_diff": max(abs(d1[s] - d2[s]) for s in d1),
               "nondeterministic_ops": nondet,
               **restored_bitwise(directory / "c")}
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1])))
