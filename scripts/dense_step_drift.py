"""The JAX package's own bf16 decode step against its forward, by depth, for
the dense archs of ``chip_smoke.py``'s phase ``archs``: the reference
reading that ``archs_step_tol`` takes its bf16 limit from past 24 layers.

For each arch, depth, seed and context: the arch at reduced width
(``reduced(arch, n_layers=depth)``, heads of 16: gemma-7b d 64 at 4 heads
over 4 with GeGLU and tied embeddings, starcoder2-15b d 768 at 48 over 4
with QKV bias, llama-3.2-vision-11b d 256 at 16 over 4 with a
cross-attention layer every 5th over a 16-position context; vocab 512)
in bf16, weights from ``jax.random.key(seed)``, batch 8 of ``ctx`` tokens
from ``numpy.random.default_rng(seed)`` (and the context, where the arch
takes one, drawn there in f32 and cast to bf16, as ``make_ctx`` casts
it).  ``decode_check``'s measure: the forward over the ``ctx``
tokens, a prefill of ``ctx - 1`` at capacity ``ctx``, then one decode step;
its error is max |step logits - forward's last logits| over max |forward's
last logits|.  The planted fault is the same step one slot early (``pos``
= ctx - 2), which the limit must still see.

Run (on the CPU; a few minutes an (arch, depth) a process):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/dense_step_drift.py \\
        [--archs gemma-7b,starcoder2-15b,llama-3.2-vision-11b] \\
        [--depths 24,28,40] [--ctxs 512,2048] [--seeds 8] [--workers 4]

Prints one JSON line an (arch, depth, seed, ctx), then one a depth: the
largest step error over the archs, seeds and contexts (the limit's
source), the largest by arch, and the smallest planted fault's error.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing

import numpy as np

ARCHS = ("gemma-7b", "starcoder2-15b", "llama-3.2-vision-11b")
BATCH = 8


def one(arch: str, depth: int, seeds: int, ctxs) -> list:
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as cr
    from repro.models import registry as mr

    cfg = dataclasses.replace(cr.reduced(arch, n_layers=depth),
                              compute_dtype="bfloat16")
    model = mr.build(cfg)
    forward = jax.jit(lambda p, t, c: model.forward(p, t, ctx_embed=c)[0])
    prefill = jax.jit(lambda p, t, c, n: model.prefill(
        p, t, ctx_embed=c, max_len=n), static_argnums=3)
    step = jax.jit(model.decode_step)
    rows = []
    for seed in range(seeds):
        params = model.init(jax.random.key(seed))
        rng = np.random.default_rng(seed)
        for ctx in ctxs:
            tokens = jnp.asarray(rng.integers(0, cfg.vocab_size,
                                              (BATCH, ctx)))
            c = None
            if model.needs_ctx():
                c = jnp.asarray(rng.standard_normal(
                    (BATCH, model.ctx_len(), cfg.d_model)).astype(
                        np.float32)).astype(jnp.bfloat16)
            want = np.asarray(forward(params, tokens, c)[:, -1], np.float32)
            scale = np.abs(want).max()
            _, cache = prefill(params, tokens[:, :-1], c, ctx)
            tok = tokens[:, -1]
            rel = lambda x: float(np.abs(np.asarray(x, np.float32)
                                         - want).max() / scale)
            err = rel(step(params, tok, cache)[0])
            fault = rel(step(params, tok, dict(
                cache, pos=jnp.array(ctx - 2, jnp.int32)))[0])
            row = {"arch": arch, "dtype": "bfloat16", "depth": depth,
                   "seed": seed, "batch": BATCH, "ctx": ctx,
                   "d_model": cfg.d_model,
                   "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
                   "step_rel_err": err, "planted_fault_rel_err": fault}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--depths", default="24,28,40")
    ap.add_argument("--ctxs", default="512,2048")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    archs = args.archs.split(",")
    depths = [int(d) for d in args.depths.split(",")]
    ctxs = tuple(int(c) for c in args.ctxs.split(","))
    jobs = [(a, d) for d in depths for a in archs]
    mp = multiprocessing.get_context("spawn")
    rows = []
    with cf.ProcessPoolExecutor(args.workers, mp_context=mp) as pool:
        futs = [pool.submit(one, a, d, args.seeds, ctxs) for a, d in jobs]
        for fut in futs:
            rows += fut.result()
    for d in depths:
        at = [r for r in rows if r["depth"] == d]
        print(json.dumps({
            "depth": d, "runs": len(at),
            "step_rel_err_max": max(r["step_rel_err"] for r in at),
            "step_rel_err_max_by_arch": {
                a: max(r["step_rel_err"] for r in at if r["arch"] == a)
                for a in archs},
            "step_rel_err_mean": float(np.mean(
                [r["step_rel_err"] for r in at])),
            "planted_fault_rel_err_min": min(
                r["planted_fault_rel_err"] for r in at)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
