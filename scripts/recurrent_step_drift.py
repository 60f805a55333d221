"""The JAX package's own decode steps of its recurrent models against its
forward, in bf16 and float32: the reference readings that
``chip_smoke.py``'s phase ``xlstm`` takes its limits from, and the answer
to whether recurrentgemma-2b's bf16 ring steps drift in the reference as
they do in the port.

For each model, dtype and seed, at reduced width and the model's full
depth, weights from ``jax.random.key(seed)`` and tokens from
``numpy.random.default_rng(seed)``:

- xlstm-1.3b (``reduced(..., n_layers=48)``: d 64, 4 heads, mLSTM hd 32,
  42 mLSTM and 6 sLSTM layers), batch 8: the forward over 544 tokens, a
  prefill of 512 and 32 decode steps (phase ``xlstm``'s shape).  Each
  step's error is ``chip_smoke.py``'s: max |step logits - forward logits|
  over max |forward logits| (positions 511 onwards).  The states after
  the steps (mLSTM C, n, m, conv; sLSTM c, n, h, m) against a prefill of
  all 544 tokens: per tensor kind, the largest over the layers of max
  |Δ| / max |prefill's|.  Then each layer alone, teacher-forced: its
  mixer (``mlstm_block`` / ``slstm_block``) over the normed inputs the
  forward gives it, against a prefill of 512 of them and 32 steps
  (``*_block_step``) on the rest: the largest step error over the layers
  (max |Δ| over max |the mixer's forward output| from position 512) and
  the states' as above.
- recurrentgemma-2b (``reduced(..., n_layers=26)``: d 160, window 64),
  batch 2: a prefill of 100 tokens at capacity 140 (the 64-slot rings
  have wrapped), then 32 steps, against the forward over 132 tokens
  (phase ``hybrid``'s shape, the window cut as ``reduced`` cuts it).

Run (on the CPU; about a minute a seed a process):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/recurrent_step_drift.py \\
        [--models xlstm-1.3b,recurrentgemma-2b] [--dtypes bfloat16,float32] \\
        [--seeds 8] [--workers 4]

Prints one JSON line a (model, dtype, seed), then one a (model, dtype):
the largest step error over the seeds, the mean over the seeds of each
seed's largest (``step_rel_err_max_seed_mean``), the mean step error,
the states' largest errors and, for xlstm-1.3b, the layers' (``layer_``).
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing

import numpy as np

# model: (depth, batch, prompt, steps, capacity or None for prompt + 64)
RUNS = {"xlstm-1.3b": (48, 8, 512, 32, None),
        "recurrentgemma-2b": (26, 2, 100, 32, 140)}
STATE_KEYS = ("C", "n", "m", "conv", "c", "h")


def _layer_states(cache):
    """{key: [array, ...]} of a JAX cache's recurrent states, layer by
    layer (every period of a ``scan`` entry, then each ``rem``)."""
    out = {}
    layers = cache["layers"]
    entries = []
    for sub in sorted(layers.get("scan", {})):
        rec = layers["scan"][sub].get("rec")
        if rec is not None:
            n = next(iter(rec.values())).shape[0]
            entries += [{k: np.asarray(v[p], np.float32)
                         for k, v in rec.items()} for p in range(n)]
    for key in sorted(k for k in layers if k.startswith("rem")):
        rec = layers[key].get("rec")
        if rec is not None:
            entries.append({k: np.asarray(v, np.float32)
                            for k, v in rec.items()})
    for rec in entries:
        for k, v in rec.items():
            out.setdefault(k, []).append(v)
    return out


def _rel_states(got, want):
    """Per key of ``want``: the largest over the layers of max |Δ| / max
    |want's|."""
    return {k: max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
                   for g, w in zip(got[k], want[k]))
            for k in STATE_KEYS if k in want}


def _layers_alone(model, params, tokens, prompt, steps):
    """Each xLSTM layer alone, teacher-forced on the forward's own inputs
    to it: (the largest step error over the layers, the states' errors)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as C
    from repro.models import layers as L
    from repro.models import recurrent as R
    from repro.models import transformer as T

    cfg = model.cfg
    cdt = jnp.dtype(cfg.compute_dtype)
    mixers = {
        C.MLSTM: ("mlstm", jax.jit(lambda p, h: R.mlstm_block(
            p, h, cfg, compute_dtype=cdt, return_state=True)),
            jax.jit(lambda p, h, c: R.mlstm_block_step(p, h, c, cfg, cdt))),
        C.SLSTM: ("slstm_blk", jax.jit(lambda p, h: R.slstm_block(
            p, h, cfg, cdt, return_state=True)),
            jax.jit(lambda p, h, c: R.slstm_block_step(p, h, c, cfg, cdt)))}
    x = L.embed(params["embed"], tokens, cdt)
    worst, got, want = 0.0, {}, {}
    for li, kind in enumerate(cfg.layer_kinds):
        lp = T._layer_params(params, cfg, li)
        key, block, block_step = mixers[kind]
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y_all, full = block(lp[key], h)
        ref = np.asarray(y_all[:, prompt:], np.float32)
        scale = np.abs(ref).max()
        _, cache = block(lp[key], h[:, :prompt])
        for t in range(steps):
            y, cache = block_step(lp[key], h[:, prompt + t:prompt + t + 1],
                                  cache)
            worst = max(worst, float(np.abs(np.asarray(y[:, 0], np.float32)
                                            - ref[:, t]).max() / scale))
        for k in cache:
            got.setdefault(k, []).append(np.asarray(cache[k], np.float32))
            want.setdefault(k, []).append(np.asarray(full[k], np.float32))
        x = x + y_all
    return worst, _rel_states(got, want)


def one(arch: str, dtype: str, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as cr
    from repro.models import registry as mr

    depth, batch, prompt, steps, capacity = RUNS[arch]
    cfg = dataclasses.replace(cr.reduced(arch, n_layers=depth),
                              compute_dtype=dtype)
    model = mr.build(cfg)
    params = model.init(jax.random.key(seed))
    T = prompt + steps
    cap = capacity or T + 64
    tokens = jnp.asarray(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, T)))
    forward = jax.jit(lambda p, t: model.forward(p, t)[0])
    prefill = jax.jit(lambda p, t: model.prefill(p, t, max_len=cap))
    step = jax.jit(lambda p, t, c: model.decode_step(p, t, c))
    want = np.asarray(forward(params, tokens)[:, prompt - 1:], np.float32)
    scale = np.abs(want).max()

    def rel(x, t):
        return float(np.abs(np.asarray(x, np.float32) - want[:, t]).max()
                     / scale)
    last, cache = prefill(params, tokens[:, :prompt])
    errs = []
    for t in range(steps):
        logits, cache = step(params, tokens[:, prompt + t], cache)
        errs.append(rel(logits, t + 1))
    row = {"arch": cfg.name, "dtype": dtype, "depth": depth,
           "batch": batch, "prompt": prompt, "steps": steps,
           "capacity": cap, "seed": seed, "prefill_rel_err": rel(last, 0),
           "step_rel_err_max": max(errs),
           "step_rel_err_mean": float(np.mean(errs))}
    if arch == "xlstm-1.3b":
        row["state_rel_err"] = _rel_states(
            _layer_states(cache), _layer_states(prefill(params, tokens)[1]))
        row["layer_step_rel_err_max"], row["layer_state_rel_err"] = \
            _layers_alone(model, params, tokens, prompt, steps)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=",".join(RUNS))
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    archs, dtypes = args.models.split(","), args.dtypes.split(",")
    jobs = [(a, d, s) for a in archs for d in dtypes
            for s in range(args.seeds)]
    ctx = multiprocessing.get_context("spawn")
    rows = []
    with cf.ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
        for row in pool.map(one, *zip(*jobs)):
            print(json.dumps(row), flush=True)
            rows.append(row)
    for a in archs:
        for d in dtypes:
            at = [r for r in rows
                  if r["arch"].startswith(a) and r["dtype"] == d]
            largest = [r["step_rel_err_max"] for r in at]
            summary = {"arch": a, "dtype": d, "seeds": len(at),
                       "step_rel_err_max": max(largest),
                       "step_rel_err_max_seed_mean": float(np.mean(largest)),
                       "step_rel_err_mean": float(np.mean(
                           [r["step_rel_err_mean"] for r in at])),
                       "prefill_rel_err_max": max(r["prefill_rel_err"]
                                                  for r in at)}
            for key in ("state_rel_err", "layer_state_rel_err"):
                if key in at[0]:
                    summary[key + "_max"] = {
                        k: max(r[key][k] for r in at) for k in at[0][key]}
            if "layer_step_rel_err_max" in at[0]:
                summary["layer_step_rel_err_max"] = max(
                    r["layer_step_rel_err_max"] for r in at)
            print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
