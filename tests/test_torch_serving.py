"""The port's serving engine and ``serve`` launcher on the CPU, against
repeated forward passes and against the JAX package's engine on the same
weights (``convert.from_jax_params``) and the same numpy prompts, at
``reduced("qwen2-0.5b", n_layers=2)``, ``qwen3-mini``, the hybrid
``reduced("recurrentgemma-2b", n_layers=5)``, the xLSTM
``reduced("xlstm-1.3b")`` and the encoder–decoder
``reduced("whisper-small")`` in f32.  The engine gives a model that takes
a context the model's ``make_ctx`` each wave; against the JAX engine both
``make_ctx``s are patched to one numpy context.

Tolerances: none.  Greedy tokens are argmaxes, compared for equality;
stats are counts and orderings of host times.  On the CPU the decode step
runs eagerly; the CUDA-graph step is checked on the card by
``chip_smoke.py`` (phase ``decode``: replay against the eager step, bit
for bit).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jcr  # noqa: E402
from repro.models import registry as jmr  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import registry as tcr  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as tmr  # noqa: E402
from repro_torch.serving.engine import (EngineStats, Request,  # noqa: E402
                                        ServingEngine)

CASES = {"qwen2-0.5b-reduced": lambda m: m.reduced("qwen2-0.5b", n_layers=2),
         "qwen3-mini": lambda m: m.get_any("qwen3-mini"),
         "recurrentgemma-2b-reduced": lambda m: m.reduced("recurrentgemma-2b",
                                                          n_layers=5),
         "xlstm-1.3b-reduced": lambda m: m.reduced("xlstm-1.3b"),
         "whisper-small-reduced": lambda m: m.reduced("whisper-small"),
         "gemma-7b-reduced": lambda m: m.reduced("gemma-7b", n_layers=2),
         "starcoder2-15b-reduced": lambda m: m.reduced("starcoder2-15b",
                                                       n_layers=2),
         "llama-3.2-vision-reduced": lambda m: m.reduced(
             "llama-3.2-vision-11b")}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _both(name):
    jcfg, tcfg = _f32(CASES[name](jcr)), _f32(CASES[name](tcr))
    params = jax.tree.map(np.asarray, jmr.build(jcfg).init(jax.random.key(0)))
    return (jmr.build(jcfg), jax.tree.map(jnp.asarray, params),
            convert.from_jax_params(params, tcfg, device="cpu"))


def _model(seed=0):
    return tmr.build(_f32(tcr.reduced("qwen2-0.5b", n_layers=2)),
                     device="cpu", seed=seed)


def _prompts(n, length, seed, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_decode_matches_forward_argmax(name):
    _, _, model = _both(name)
    [prompt] = _prompts(1, 8, 1, model.cfg.vocab_size)
    engine = ServingEngine(model, max_batch=1, max_len=64)
    [req] = engine.run([Request(rid=0, prompt=prompt, max_new_tokens=4)])
    toks = list(prompt)
    ctx = model.make_ctx(1)                 # the engine's context for a wave of 1
    with torch.no_grad():
        for _ in range(4):
            logits = model(torch.tensor([toks]), ctx_embed=ctx)
            toks.append(int(logits[0, -1, :model.cfg.vocab_size].argmax()))
    assert req.out_tokens == toks[len(prompt):]
    assert engine.stats.prefills == 1 and engine.stats.decode_steps == 3


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_tokens_equal_the_jax_engine(name, monkeypatch):
    """Two waves of left-padded prompts of unequal length: the same greedy
    tokens as the JAX engine on the same weights (and, for a model that
    takes one, the same context: the first rows of one numpy array)."""
    jmodel, jparams, model = _both(name)
    if model.needs_ctx():
        ctx = np.random.default_rng(5).standard_normal(
            (3, model.ctx_len(), model.cfg.d_model)).astype(np.float32)
        monkeypatch.setattr(type(jmodel), "make_ctx",
                            lambda self, key, batch: jnp.asarray(ctx[:batch]))
        monkeypatch.setattr(model, "make_ctx",
                            lambda batch: torch.from_numpy(ctx[:batch]))
    vocab = model.cfg.vocab_size
    prompts = [p[:n] for p, n in zip(_prompts(5, 9, 2, vocab),
                                     (9, 6, 9, 4, 7))]
    reqs = lambda R: [R(rid=i, prompt=p, max_new_tokens=3 + i % 2)
                      for i, p in enumerate(prompts)]
    done = ServingEngine(model, max_batch=3, max_len=24).run(
        reqs(Request))
    jdone = jeng.ServingEngine(jmodel, jparams, max_batch=3,
                               max_len=24).run(reqs(jeng.Request))
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert [len(r.out_tokens) for r in done] == [3, 4, 3, 4, 3]


def test_engine_batched_throughput_and_stats():
    model = _model()
    engine = ServingEngine(model, max_batch=4, max_len=48)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=3) for i, p in
            enumerate(_prompts(6, 8, 0, model.cfg.vocab_size))]
    done = engine.run(reqs)
    assert len(done) == 6
    assert engine.stats.tokens_out == 18
    assert engine.stats.prefills == 2 and engine.stats.decode_steps == 4
    assert engine.stats.throughput(engine.wall_s) > 0
    assert all(len(r.out_tokens) == 3 for r in done)


def test_engine_records_ttft_and_tpot():
    model = _model()
    engine = ServingEngine(model, max_batch=2, max_len=48)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=3) for i, p in
            enumerate(_prompts(4, 8, 1, model.cfg.vocab_size))]
    done = engine.run(reqs)
    for r in done:
        # first token sampled at the prefill that seats the slot
        assert r.t_submit < r.t_first_token <= r.t_done
    assert len(engine.stats.ttfts) == 4
    assert len(engine.stats.tpots) == 4          # 3 tokens > 1 each
    assert engine.stats.ttft_p95 >= engine.stats.ttft_p50 > 0
    assert engine.stats.tpot_p95 >= engine.stats.tpot_p50 > 0
    # single-token requests produce a TTFT but no TPOT sample
    engine2 = ServingEngine(model, max_batch=2, max_len=48)
    engine2.run([Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=1)])
    assert len(engine2.stats.ttfts) == 1 and engine2.stats.tpots == []
    assert engine2.stats.tpot_p95 == 0.0 == EngineStats().ttft_p50


def test_engine_admission_oracle_shrinks_wave():
    model = _model()
    calls = []

    def oracle(batch, ctx):
        calls.append((batch, ctx))
        return 0.1 * batch          # 2+ co-scheduled slots violate the SLO

    engine = ServingEngine(model, max_batch=4, max_len=48,
                           admission_oracle=oracle, slo_tpot=0.15)
    prompts = _prompts(3, 8, 2, model.cfg.vocab_size)
    done = engine.run([Request(rid=i, prompt=p, max_new_tokens=2)
                       for i, p in enumerate(prompts)])
    assert len(done) == 3
    assert engine.stats.prefills == 3            # one wave per request
    assert calls and all(b >= 1 for b, _ in calls)
    assert all(ctx == 8 + 2 for _, ctx in calls)  # worst-case kv length
    # a permissive oracle admits the full wave
    engine2 = ServingEngine(model, max_batch=4, max_len=48,
                            admission_oracle=lambda b, c: 0.0, slo_tpot=0.15)
    done2 = engine2.run([Request(rid=i, prompt=p, max_new_tokens=2)
                         for i, p in enumerate(prompts)])
    assert engine2.stats.prefills == 1
    # admission control must not change the decoded tokens
    assert [r.out_tokens for r in done] == [r.out_tokens for r in done2]


def test_engine_temperature_sampling_is_seeded():
    model = _model()
    prompts = _prompts(2, 8, 3, model.cfg.vocab_size)
    runs = []
    for _ in range(2):
        engine = ServingEngine(model, max_batch=2, max_len=32, seed=7)
        runs.append([r.out_tokens for r in engine.run(
            [Request(rid=i, prompt=p, max_new_tokens=5, temperature=5.0)
             for i, p in enumerate(prompts)])])
    assert runs[0] == runs[1]
    assert all(0 <= t < model.cfg.vocab_size for r in runs[0] for t in r)


def test_engine_refuses_a_wave_beyond_max_len():
    model = _model()
    [prompt] = _prompts(1, 8, 4, model.cfg.vocab_size)
    engine = ServingEngine(model, max_batch=1, max_len=10)
    with pytest.raises(ValueError):
        engine.run([Request(rid=0, prompt=prompt, max_new_tokens=4)])
    # 8 prompt tokens + 3 decode steps fill 11 slots; the capacity never
    # falls below the prompt
    done = ServingEngine(model, max_batch=1, max_len=11).run(
        [Request(rid=0, prompt=prompt, max_new_tokens=4)])
    assert len(done[0].out_tokens) == 4


def test_serve_launcher_on_the_cpu(capsys):
    args = serve.parse_args(["--arch", "qwen2-0.5b", "--reduced",
                             "--requests", "3", "--prompt-len", "8",
                             "--max-new", "3", "--max-batch", "2",
                             "--device", "cpu"])
    assert args.device == "cpu" and args.compute_dtype == "float32"
    out = serve.run(args)
    assert sorted(out) == ["decode_steps", "mean_latency_s", "p99_latency_s",
                           "throughput_tok_s", "tokens_out"]
    assert out["tokens_out"] == 9 and out["decode_steps"] == 4
    assert out["throughput_tok_s"] > 0
    assert out["p99_latency_s"] >= out["mean_latency_s"] > 0
    assert "[serve] arch=qwen2-0.5b-reduced reqs=3" in capsys.readouterr().out


def test_serve_launcher_bf16_casts_the_weights_once():
    args = serve.parse_args(["--arch", "qwen2-0.5b", "--reduced",
                             "--requests", "2", "--prompt-len", "6",
                             "--max-new", "2", "--compute-dtype", "bfloat16",
                             "--device", "cpu"])
    engine, done = serve.serve(args)
    assert engine.model.blocks[0].attn.wq.w.dtype == torch.bfloat16
    assert engine.model.blocks[0].ln1.scale.dtype == torch.float32
    assert [len(r.out_tokens) for r in done] == [2, 2]
    assert engine.max_len == 6 + 2 + 8


def test_serve_defaults_to_the_card():
    assert serve.parse_args(["--arch", "qwen2-0.5b"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        serve.run(serve.parse_args(["--arch", "qwen2-0.5b", "--reduced"]))
