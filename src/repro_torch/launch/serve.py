"""Serving launcher: batched decode over synthetic requests (the JAX
package's ``launch/serve.py``, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \
      --requests 8 --max-new 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --prompt-len 64 --max-new 32 --compute-dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --prompt-len 512 --compute-dtype bfloat16

Runs on the card unless ``--device cpu``; weights are random from
``--seed``.  A model that takes a context (whisper-small's 1,500 stub
frames, llama-3.2-vision's patches) gets the engine's stub context each
wave.  The left-padded prompts of a recurrent model (recurrentgemma-2b,
xlstm-1.3b) run through its recurrence, the padding included, as in the
JAX engine.  The weights are stored in the compute dtype, drawn and cast one
part at a time (``models.registry.build(dtype=)``:
the values the per-call cast gives), so moonshot-v1-16b-a3b's 57.8 GB of
bf16 weights are built on one 80 GB card.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry as cr
from repro_torch.models import registry as mr
from repro_torch.serving.engine import Request, ServingEngine


def serve(args):
    """Build the model and engine ``args`` describe and serve its requests:
    (engine, finished requests)."""
    cfg = cr.reduced(args.arch) if args.reduced else cr.get_any(args.arch)
    cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    model = mr.build(cfg, device=args.device, seed=args.seed,
                     dtype=getattr(torch, args.compute_dtype))
    engine = ServingEngine(model, max_batch=args.max_batch,
                           max_len=args.prompt_len + args.max_new + 8)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for i in range(args.requests)]
    return engine, engine.run(reqs)


def summary(engine, done, verbose=False) -> dict:
    tput = engine.stats.throughput(engine.wall_s)
    lat = [r.t_done - r.t_submit for r in done]
    out = {"tokens_out": engine.stats.tokens_out,
           "decode_steps": engine.stats.decode_steps,
           "throughput_tok_s": tput,
           "mean_latency_s": float(np.mean(lat)),
           "p99_latency_s": float(np.quantile(lat, 0.99))}
    if verbose:
        print(f"[serve] arch={engine.model.cfg.name} reqs={len(done)} "
              f"tput={tput:.1f} tok/s mean_lat={out['mean_latency_s']*1e3:.0f}ms")
    return out


def run(args) -> dict:
    return summary(*serve(args), verbose=args.verbose)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # the JAX launcher's flag, kept for its command lines: it is always on
    ap.add_argument("--verbose", action="store_true", default=True)
    return ap.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
