"""The JAX package's own bf16 MoE decode steps against its forward, with
the routing held to the forward's, by depth: the reference reading that
``chip_smoke.py``'s ``moe_step_tol`` takes its bf16 limit from past 24
layers.

For each depth and seed: reduced moonshot-v1-16b-a3b (``reduced(...,
n_layers=depth)``: d 64, 8 experts top-2 and 1 shared, a capacity that
drops nothing) in bf16, weights from ``jax.random.key(seed)``, batch 8
of 96 tokens from ``numpy.random.default_rng(seed)``.  The forward over
the 96 tokens ranks each layer's experts; then a prefill of 64 tokens and
32 decode steps run with each layer's top-k held to the forward's ranking
at their positions (``jax.lax.top_k`` replaced under ``jax.disable_jit()``,
where ``lax.scan`` runs its body once a layer, so the calls come one a
layer, in order: each model call checks that it made exactly one a
layer).  The error of a step is ``chip_smoke.py``'s: max |step logits -
forward logits| over max |forward logits| (positions 63 onwards).  Then
the faults ``chip_smoke.py`` plants: the first step with the experts of
one layer only (the first, the middle, the last) shifted one rank down.

Run (on the CPU; about a minute a 48-layer seed a process):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/moe_forced_drift.py \\
        [--depths 12,24,48] [--seeds 8] [--workers 4]

Prints one JSON line a (depth, seed), then one a depth: the largest step
error over the seeds, the mean over the seeds of each seed's largest
(``step_rel_err_max_seed_mean``: the limit's source), the mean step
error, and each planted fault's smallest effect.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing

import numpy as np

ARCH = "moonshot-v1-16b-a3b"
BATCH, PROMPT, STEPS = 8, 64, 32


def one(depth: int, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as cr
    from repro.models import registry as mr

    cfg = dataclasses.replace(cr.reduced(ARCH, n_layers=depth),
                              compute_dtype="bfloat16")
    model = mr.build(cfg)
    params = model.init(jax.random.key(seed))
    T = PROMPT + STEPS
    tokens = jnp.asarray(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, T)))
    top_k = jax.lax.top_k
    state = {"calls": 0, "ranked": [], "pos": None, "shifted": None}

    def forced(x, k):
        i = state["calls"]
        state["calls"] += 1
        if state["pos"] is None:                  # the forward: rank
            state["ranked"].append(top_k(x, min(k + 1, x.shape[-1]))[1])
            return top_k(x, k)
        s = 1 if i == state["shifted"] else 0
        want = state["ranked"][i][:, state["pos"], s:s + k]
        return jnp.take_along_axis(x, want, -1), want

    def call(pos, run, shifted=None):
        state.update(calls=0, pos=pos, shifted=shifted)
        out = run()
        if state["calls"] != depth:
            raise AssertionError(f"{state['calls']} top-k calls, {depth} "
                                 f"layers")
        return out

    jax.lax.top_k = forced
    try:
        with jax.disable_jit():
            want = np.asarray(call(None, lambda: model.forward(
                params, tokens)[0])[:, PROMPT - 1:], np.float32)
            scale = np.abs(want).max()

            def rel(x, t):
                return float(np.abs(np.asarray(x, np.float32)
                                    - want[:, t]).max() / scale)
            last, cache = call(slice(0, PROMPT), lambda: model.prefill(
                params, tokens[:, :PROMPT], max_len=T))
            start, errs = cache, []
            for t in range(STEPS):
                pos = slice(PROMPT + t, PROMPT + t + 1)
                logits, cache = call(pos, lambda: model.decode_step(
                    params, tokens[:, PROMPT + t], cache))
                errs.append(rel(logits, t + 1))
            faults = {}
            for layer in sorted({0, depth // 2, depth - 1}):
                logits, _ = call(slice(PROMPT, PROMPT + 1),
                                 lambda: model.decode_step(
                                     params, tokens[:, PROMPT], start),
                                 shifted=layer)
                faults[layer] = rel(logits, 1)
    finally:
        jax.lax.top_k = top_k
    return {"arch": cfg.name, "dtype": "bfloat16", "depth": depth,
            "seed": seed, "prefill_rel_err": rel(last, 0),
            "step_rel_err_max": max(errs),
            "step_rel_err_mean": float(np.mean(errs)),
            "one_layer_shift_rel_err": faults}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="12,24,48")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    depths = [int(d) for d in args.depths.split(",")]
    jobs = [(d, s) for d in depths for s in range(args.seeds)]
    ctx = multiprocessing.get_context("spawn")
    rows = []
    with cf.ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
        for row in pool.map(one, *zip(*jobs)):
            print(json.dumps(row), flush=True)
            rows.append(row)
    for d in depths:
        at = [r for r in rows if r["depth"] == d]
        largest = [r["step_rel_err_max"] for r in at]
        print(json.dumps({
            "depth": d, "seeds": len(at),
            "step_rel_err_max": max(largest),
            "step_rel_err_max_seed_mean": float(np.mean(largest)),
            "step_rel_err_mean": float(np.mean(
                [r["step_rel_err_mean"] for r in at])),
            "one_layer_shift_rel_err_min": {
                k: min(r["one_layer_shift_rel_err"][k] for r in at)
                for k in at[0]["one_layer_shift_rel_err"]}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
