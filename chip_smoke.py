"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main path, the paper's loop on one device: time kernels
on the card (calibration), turn the timings into throughput tables and the
memory-bound regression, predict qwen2-0.5b at full width, and measure the
same forward pass on the same card.  Before that it builds the hand-written
CUDA kernels from ``src/repro_torch/kernels/csrc`` and holds each against its
plain PyTorch version on the card.  Then the decode path: prefill and one
decode step of qwen2-0.5b at batch 8 and two contexts, eager and as a
replayed CUDA graph, measured and predicted; and the serving path: the
``serve`` launcher's engine over 16 requests in two waves.  Then the grid
path: the batch engine (``core/batch_predict.py``) held against the scalar
predictor over a (batch, seq) and a (batch, ctx) grid on the card's store,
forwards and CUDA-graph decode steps measured at some of its points, the
engine's speed, its prediction cache, the NAS precompute against
``torch.matmul`` and the device fleet.  Then the schedule path: the
parallel enumeration, list-schedule simulator, strategy sweep, serving
simulator and partition planner held against the scalar predictor and
against the card (microbatched forwards, planned pipeline stages timed
alone, the serving engine at capacity 1).  Then the service path: the
latency service (``serving/latency_service.py``) held against the engine
and its own persisted cache, comm calibration on the card (a loopback
sweep, the bundled traces, the L2 sweep and its correction, the traces
replayed against their budgets), what the correction does to the forward
and decode predictions, and the bf16 serving engine under the service's
decode admission oracle.  Then the hybrid path: recurrentgemma-2b at
full width (RG-LRU blocks and sliding-window attention through the flash
kernel's hd-256 instances), float32 and bf16, its forward measured and
predicted, decode steps over a wrapped ring buffer held against the
forward (with a planted ring fault that must fail), and the ``serve``
launcher's engine.  Then the encoder–decoder path: whisper-small at full
width (12 encoder and 12 decoder layers over 1,500 stub frames: non-causal
and cross attention through the flash kernel), float32 and bf16, its
forward measured, split and predicted, its encoder on the card held
against the CPU's (with a causal encoder planted, which must fail), decode
steps held against the forward (with cross caches from a foreign context
planted, which must fail), and the ``serve`` launcher's engine.  Then the
MoE path: moonshot-v1-16b-a3b at full width (64 experts top-6 through
capacity dispatch, flash at hd 128), bf16 at full depth and float32 at a
cut depth, and llama4-scout-17b-16e (top-1 of 16, GQA group 5) in bf16 at
a cut depth, each forward measured, split and predicted with the share of
pairs capacity drops, decode steps held against the forward at a
capacity that drops nothing with the routing held to the forward's (each
gate on the next expert down, in every layer and in the middle layer,
planted, which must fail; freely routed steps, eager and as a CUDA
graph, reported), and the ``serve`` launcher's engine.  Then the archs
path: the dense archs no other path runs, gemma-7b (attention at hd 256
over 16 KV heads, a tied 256,000-row vocabulary), llama-3.2-vision-11b (a
cross-attention layer every 5th over a 1,601-position stub context,
non-causal at hd 128) and starcoder2-15b (GQA 48:4, QKV bias), each at full
width and depth in bf16 and float32, its forward measured and predicted
with the flash launches its layers make, decode steps held against the
forward, and the ``serve`` launcher's engine in bf16.  Then the xLSTM
path: xlstm-1.3b at full width (42 mLSTM and 6 sLSTM layers, plain
PyTorch: no hand kernel), float32 and bf16, its forward measured, split by
layer kind and predicted, decode steps held against the forward (the whole
model and each layer alone, with a stale conv state planted, which must
fail), the graph step against its price and bytes floor, and the
``serve`` launcher's engine.  Then the paper
path: the JAX package's paper tables on the card (``repro_torch.benchmarks``):
NeuSight trained per dtype, Table II, Table IV over the reference's six
models and qwen2-0.5b and yi-6b at full width, Fig. 3, the partition
application and the planner CLI, pricing the same measured work with
PM2Lat, NeuSight and the FLOPs/bytes proxy.  Then the drivers path: the
paper's other drivers (``repro_torch.benchmarks``: NAS speed, the fleet,
strategy, serving, parallel and overlap sweeps, comm validation) on the
card's store at their ``--fast`` and ``--dry-run`` sizes, each with its
own self-checks.  Then the training path:
qwen2-0.5b at full width trained through ``launch/train.py`` (float32
weights and AdamW moments, float32 and bf16 compute, attention's backward
through the hand flash backward kernel) with its step-0 checkpoint, the
step timed and split into forward, backward and optimizer against PM2Lat's
training step, one step's gradients against the plain attention on the
card, and a run with injected failures at reduced size held against an
uninterrupted one (``scripts/torch_train_restart.py``); then every other
model kind at full width, float32 and bf16: recurrentgemma-2b at B 1 x S
4096 (its sliding-window attention's backward through the hand kernel's
hd-256 instances), whisper-small at B 8 x S 448 over the launcher's
1,500-frame context (the encoder's and the cross attention's backwards
too), xlstm-1.3b at B 1 x S 512 (no hand kernel) and moonshot-v1-16b-a3b
with its depth cut to 4 layers, each step timed, split and priced, its
losses falling, its launches those its layer kinds make, and, for a kind
with attention, its gradients against the plain attention's.  Then the
distributed path: the same launcher on a ``DeviceMesh`` under torchrun
(``scripts/torch_dist_train.py``, one process a rank): one NCCL rank at
``--mesh 1x1`` through the DTensor path in float32 and bf16, its float32
losses held against the training path's, and two gloo ranks sharing the
card, ``compressed_psum`` over them on the card held against the host's,
bit for bit (gloo cannot carry DTensor's collectives on CUDA tensors in
this torch, so no two-rank training runs on one card), and one NCCL rank
a model serving moonshot-v1-16b-a3b (bf16, 4 layers at full width) and
whisper-small (float32) through the sharded path at ``--mesh 1x1``
(``scripts/torch_dist_serve.py``), its logits held against the model
without a mesh.  Then the dry-run path: ``launch/dryrun.py`` in host
processes, counting the training step on meta tensors (unsharded and on a
fake 1x1 mesh, both dtypes) and held against the training path's measured
step (flash calls against launches, argument bytes against the live state
and batch, its roofline bound at or below the step), the reference's
``train_4k``, ``prefill_32k`` and ``decode_32k`` cells on a fake (32, 8)
mesh, and the MoE, encoder–decoder and xLSTM kinds' ``decode_32k`` there.
Table VI (phase ``table6``, on the main path) runs through its driver, on
the JAX package's shapes and on wider ones.
Every phase prints one JSON line, also appended to
``chiprun_out/phases.jsonl``; the full record (and the calibrated store)
goes to ``chiprun_out/``.  The
comm-calibration artifact is this run's own
(``chiprun_out/comm_calibration.json``, deleted at the start).

The last line is ``{"ok": true, "device": {...}}``.  Any failing phase, a
missing card, or a checkout without ``src/repro_torch`` (the import fails)
exits non-zero and prints no result.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.benchmarks import comm_validation  # noqa: E402
from repro_torch.benchmarks import fig3_throughput_vs_k as fig3  # noqa: E402
from repro_torch.benchmarks import fleet_compare  # noqa: E402
from repro_torch.benchmarks import nas_speed  # noqa: E402
from repro_torch.benchmarks import overlap_scaling  # noqa: E402
from repro_torch.benchmarks import parallel_scaling  # noqa: E402
from repro_torch.benchmarks import partition_app  # noqa: E402
from repro_torch.benchmarks import serving_sweep  # noqa: E402
from repro_torch.benchmarks import strategy_sweep  # noqa: E402
from repro_torch.benchmarks import table2_per_layer as table2  # noqa: E402
from repro_torch.benchmarks import table4_model_wise as table4  # noqa: E402
from repro_torch.benchmarks import table6_custom_kernels as table6_driver  # noqa: E402
from repro_torch.configs import base as C  # noqa: E402
from repro_torch.configs import registry as cfg_registry  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import comm_calibrate as comm  # noqa: E402
from repro_torch.core import memory_model as memmod  # noqa: E402
from repro_torch.core import opgraph as og  # noqa: E402
from repro_torch.core import partition  # noqa: E402
from repro_torch.core import profiler  # noqa: E402
from repro_torch.core import schedule as sched  # noqa: E402
from repro_torch.core import validate  # noqa: E402
from repro_torch.core.baselines import neusight as ns  # noqa: E402
from repro_torch.core.baselines.habitat import HabitatScaler  # noqa: E402
from repro_torch.core.baselines.roofline import RooflineBaseline  # noqa: E402
from repro_torch.core.batch_predict import (BatchPredictor,  # noqa: E402
                                            PredictionCache, config_key)
from repro_torch.core.devices.profiles import H100_SXM  # noqa: E402
from repro_torch.core.devices.profiles import FLEET  # noqa: E402
from repro_torch.core.nas import NASGrid, precompute_cache  # noqa: E402
from repro_torch.core.oracle import PROVIDER_PALLAS  # noqa: E402
from repro_torch.core.predictor import PM2Lat  # noqa: E402
from repro_torch.core.transfer import transfer_store  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fkb  # noqa: E402
from repro_torch.kernels import matmul as mk  # noqa: E402
from repro_torch.launch import dryrun as dryrun_mod  # noqa: E402
from repro_torch.launch import plan as plan_launcher  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.models.transformer import (Transformer,  # noqa: E402
                                             cast_weights_)
from repro_torch.serving.engine import (DecodeGraph, Request,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.latency_service import LatencyService  # noqa: E402
from repro_torch.training import objective as tobj  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402

MODEL = "qwen2-0.5b"
BATCH, SEQ = 8, 512
TABLE6_SAMPLES = 6

MM_SHAPE = (768, 640, 1408)   # (M, N, K) at which the matmul configs are timed
MM_FULL = (2048, 4224, 4096)  # 528 tiles of 128 x 128: 4 full waves on 132 SMs

# Tolerances of the kernels against their plain versions.  Matmul: the JAX
# package's kernel tests (f32 atol 1e-4*sqrt(K), rtol 1e-4; bf16 atol
# 8e-2*sqrt(K), rtol 5e-2).  Flash f32: the JAX kernel tests' atol 2e-5.
# Flash bf16, per element: the atol is 2^-8 sum_j p_j |v_j| / l, which is
# flash_attention_plain(q, k, |v|): what one rounding of P to bf16 (unit
# roundoff 2^-8) may move sum_j p_j v_j / l by; the rtol 2^-8 is one
# rounding of the output to bf16.  The kernel gives P V its P as a bf16
# head and a bf16 remainder (to ~2^-16), so it differs from the plain
# version by the two outputs' roundings to bf16, at most a bf16 ulp, which
# the two terms hold (plain(q, k, |v|) >= |output|); P rounded once to
# bf16 would take the whole atol in a row of few keys, and the second
# rounding would pass them.  The rest (S scaled after the product instead
# of q before it, the order of f32 sums, exp2f) is f32 rounding, orders of
# magnitude below.
MM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-2, 5e-2)}   # (atol/sqrt(K), rtol)
FA_TOL = {"float32": (2e-5, 0.0),                              # (atol, rtol)
          "bfloat16": ("2^-8 * flash_attention_plain(q, k, |v|)", 2 ** -8)}

# The decode phase: batch 8 at two contexts; the decode step's logits
# against the last position of a forward over the same ctx tokens, as
# max|d| / max|logits|.  float32 is true f32 on both sides (TF32 off), so
# only the order of f32 sums differs; bf16 rounds every projection's output
# and the cache, in other places on the two paths.
DECODE_CTXS = (512, 2048)
DECODE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# The serve phase: the launcher's flags; two waves of 8 prompts of 512.
SERVE_ARGS = ["--arch", MODEL, "--requests", "16", "--prompt-len", "512",
              "--max-new", "32", "--max-batch", "8", "--temperature", "0",
              "--compute-dtype", "bfloat16", "--seed", "0"]
# The grid phase: the engine's (batch, seq) and (batch, ctx) grids, held
# against the scalar predictor at the JAX package's own contract (1e-9
# relative, tests/test_batch_predict.py); the points whose forward (at most
# 16,384 tokens: the float32 logits alone are 10 GB there) and CUDA-graph
# decode step are measured; the NAS sample and its largest operand.
DTYPES = ("float32", "bfloat16")
GRID_BATCHES, GRID_SEQS = (1, 2, 4, 8, 16), (128, 256, 512, 1024, 2048)
GRID_DECODE_BATCHES, GRID_CTXS = (1, 4, 8, 16), (512, 1024, 2048)
GRID_RTOL = 1e-9
GRID_MEASURED = ((1, 128), (1, 1024), (4, 512), (8, 512), (8, 2048),
                 (16, 1024))
GRID_DECODE_MEASURED = ((1, 512), (4, 2048), (16, 1024))
NAS_POINTS, NAS_MAX_OPERAND = 32, 1 << 30
PAPER_US_PER_PREDICTION = 45.0      # the paper's 0.045 ms a prediction
# The schedule phase: the engine against the scalar predictor on a fixed
# spec list (1e-9 relative, the JAX package's contract); the sweep against
# the per-spec loop over SCHED_GRID (1e-9; exposed comm and bubble share,
# which reach exact zeros, 1e-6 relative + 1e-12 absolute as the JAX
# package's tests hold them); a trivial spec against ``predict_model``
# (1e-12: ``sum()`` is compensated on Python 3.12, the schedule adds left
# to right).  Measured: B 8 x S 512 in SCHED_MB sequential chunks, each
# stage of SCHED_STAGES-way plans (SCHED_PLAN_MB microbatches) alone, and
# the serve launcher at capacity 1 (SERVE1_ARGS), run twice: the second
# run over fresh prompts is the one timed.
SCHED_SPECS = (dict(tp=2), dict(tp=2, act_mode="sp"), dict(dp=2, tp=2),
               dict(pp=2, microbatches=4),
               dict(pp=2, microbatches=4, schedule="1f1b"),
               dict(pp=2, microbatches=4, schedule="interleaved"),
               dict(dp=2, tp=2, pp=2, microbatches=4))
SCHED_GRID = dict(dp=(1, 2), tp=(1, 2, 4), pp=(1, 2), microbatches=(1, 2, 4))
SCHED_RTOL, SCHED_TRIVIAL_RTOL = 1e-9, 1e-12
SCHED_MB = (1, 2, 4, 8)
SCHED_STAGES, SCHED_PLAN_MB = (2, 4), 4
SCHED_DECODE = dict(batches=(1, 4, 8), ctxs=(512, 1024, 2048), spec=dict(tp=2))
SERVE1_ARGS = ["--arch", MODEL, "--requests", "4", "--prompt-len", "512",
               "--max-new", "32", "--max-batch", "1", "--temperature", "0",
               "--compute-dtype", "bfloat16", "--seed", "0"]
SCHED_CAPACITIES = (1, 2, 4, 8)
SCHED_WORLDS = (8, 64)
# The service phase: the comm-calibration artifact this run writes (and
# deletes first: no artifact moves the phases before ``service``); the
# trivial spec against ``latency_query`` at 1e-12, as SCHED_TRIVIAL_RTOL;
# the admission run: SERVICE_PROMPTS prompts of SEQ tokens, SERVICE_NEW new
# each, capacity SERVICE_CAPACITY, bf16, the SLO the oracle's own value at
# (SERVICE_SLO_BATCH, ctx); the planners on SERVICE_DEVICES devices.
COMM_CAL = OUT / "comm_calibration.json"
SERVICE_PROMPTS, SERVICE_NEW, SERVICE_CAPACITY = 12, 32, 8
SERVICE_SLO_BATCH = 4
SERVICE_DEVICES = 8
SERVICE_MM_SHAPE = (BATCH * SEQ, 4864)      # the MLP's w_in at (8, 512)
# The hybrid phase: recurrentgemma-2b (RG-LRU and local attention at hd 256,
# window 2048) at full width, built from a seed on the card in float32 and
# then in bf16, one at a time.  Its forward is measured at HYBRID_FORWARDS
# ((1, 4096) is where the window masks); the ring check prefills
# HYBRID_RING_PROMPT tokens at capacity HYBRID_RING_CAPACITY (the 2048-slot
# ring has wrapped) and takes HYBRID_RING_STEPS decode steps, eagerly and
# as a CUDA graph, each held against the forward over the whole sequence
# (the prefill's logits at DECODE_TOL, the steps' at HYBRID_STEP_TOL) and
# its rings against a prefill of the same tokens (``ring_slots_wrong``);
# the serving engine runs the launcher's HYBRID_SERVE_ARGS (two waves of 4).
HYBRID = "recurrentgemma-2b"
HYBRID_FORWARDS = ((8, 512), (1, 4096))
HYBRID_RING_BATCH, HYBRID_RING_PROMPT = 2, 2100
HYBRID_RING_CAPACITY, HYBRID_RING_STEPS = 2200, 32
# The ring steps' logits limit: DECODE_TOL in float32.  bf16: no sound
# step of this model meets DECODE_TOL's 3e-2 (PERF.md, the hybrid phase),
# so the limit is the largest sound step recorded on the H100, 5.77e-2,
# rounded up.  The planted fault's step moves bf16 logits less (4.81e-2),
# so no bf16 logits limit sees a ring fault: in bf16 only
# ``ring_slots_wrong`` does.
HYBRID_STEP_TOL = {"float32": DECODE_TOL["float32"], "bfloat16": 6e-2}
HYBRID_SERVE_ARGS = ["--arch", HYBRID, "--requests", "8", "--prompt-len",
                     "512", "--max-new", "16", "--max-batch", "4",
                     "--temperature", "0", "--compute-dtype", "bfloat16",
                     "--seed", "0"]
# The encoder–decoder phase: whisper-small at full width (12 encoder and 12
# decoder layers, d 768, 12 heads of 64, d_ff 3072 GELU, vocab 51,865
# padded to 51,968, 1,500 stub frames), built from a seed on the card in
# float32 and then in bf16, one at a time.  Its forward is measured at
# ENCDEC_FORWARDS over a 1,500-frame context: (8, 448) is batched
# transcription at Whisper's 448-token decoder context, (1, 64) one short
# transcript, where the encoder dominates.  The decode check prefills
# ENCDEC_PROMPT tokens at batch ENCDEC_BATCH and capacity ENCDEC_CAPACITY
# and takes ENCDEC_STEPS steps, eagerly and as a CUDA graph, the prefill's
# and every step's logits held against the forward over the whole sequence
# at DECODE_TOL; the serving engine runs the launcher's ENCDEC_SERVE_ARGS
# (two waves of 4).
ENCDEC = "whisper-small"
ENCDEC_FORWARDS = ((8, 448), (1, 64))
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_CAPACITY, ENCDEC_STEPS = 8, 64, 128, 32
# The card's encoder at batch 1 in float32 against the same weights and
# context on the CPU (the plain flash), as max|d| / max|out|: both sides are
# true f32 (TF32 off) and differ only in the order of f32 sums (cuBLAS's
# GEMMs and the kernel's tiles against the CPU's GEMMs and the plain
# version's), as a decode step and a forward do: DECODE_TOL's float32
# limit.  The planted causal encoder changes what every frame but the last
# attends to.
ENCDEC_ENCODER_TOL = DECODE_TOL["float32"]
ENCDEC_SERVE_ARGS = ["--arch", ENCDEC, "--requests", "8", "--prompt-len",
                     "64", "--max-new", "32", "--max-batch", "4",
                     "--temperature", "0", "--compute-dtype", "bfloat16",
                     "--seed", "0"]
# The MoE phase: moonshot-v1-16b-a3b (48 layers, d 2048, 16 heads of 128
# over 16 KV heads, 64 experts of d_ff 1408 top-6 and 2 shared, vocab
# 163,840; 28.9 B parameters) and llama4-scout-17b-16e (d 5120, 40 heads of
# 128 over 8, 16 experts of d_ff 8192 top-1 and 1 shared, vocab 202,048),
# each built from seed 0 on the card and freed before the next, at
# MOE_RUNS' (dtype, layers): moonshot in bf16 at full depth (57.8 GB,
# drawn and cast one part at a time: ``build(dtype=)``) and in float32 at
# 12 of 48 layers (30.9 GB; 48 would be 115.6 GB, and 24, 59.1 GB, fit:
# the cut pays for phase ``archs``' time), llama4-scout in bf16 at 12 of 48
# (57.0 GB; 48 would be 215.5 GB).  The forward is measured at
# MOE_FORWARD at the configs' capacity factor 1.25.  The decode check
# prefills MOE_PROMPT tokens at batch MOE_BATCH and capacity MOE_PROMPT +
# MOE_STEPS and takes MOE_STEPS steps, each held against the forward over
# the whole sequence at ``moe_step_tol`` with the routing held to the
# forward's, at a capacity factor that drops nothing (``moe_no_drop``);
# the freely routed steps, eagerly and as a CUDA graph, are reported; the
# serving engine runs the launcher's MOE_SERVE_ARGS (moonshot at full
# depth, two waves of 4, capacity 1.25: the engine and ``check_served``
# prefill the same waves, so both drop alike).
MOE, MOE_SCOUT = "moonshot-v1-16b-a3b", "llama4-scout-17b-16e"
MOE_RUNS = ((MOE, "bfloat16", 48), (MOE, "float32", 12),
            (MOE_SCOUT, "bfloat16", 12))
MOE_FORWARD = (8, 512)
MOE_BATCH, MOE_PROMPT, MOE_STEPS = 8, 64, 32
# The decode check's logits limit (``moe_step_tol``): DECODE_TOL at 24
# layers or fewer (it was set at qwen2-0.5b's 24).  Deeper, in bf16, the
# JAX package's own step error at that depth with the routing held to its
# forward's: MOE_REF_STEP_ERR[layers], the largest over seeds 0-7 of
# reduced moonshot-v1-16b-a3b (``scripts/moe_forced_drift.py``, on the
# CPU), rounded up to two digits.
MOE_TOL_LAYERS = 24
MOE_REF_STEP_ERR = {48: 6.9e-2}
MOE_SERVE_ARGS = ["--arch", MOE, "--requests", "8", "--prompt-len", "64",
                  "--max-new", "32", "--max-batch", "4", "--temperature",
                  "0", "--compute-dtype", "bfloat16", "--seed", "0"]
# The archs phase: the dense archs no other phase runs, each at full width,
# built from seed 0 on the card in its dtype (``build(dtype=)``) and freed
# before the next: gemma-7b (28 layers, d 3072, 16 heads of 256 over 16,
# GeGLU at d_ff 24,576, a tied 256,000-row vocabulary; 8.54 B parameters),
# llama-3.2-vision-11b (40 layers, d 4096, 32 heads of 128 over 8, SiLU at
# d_ff 14,336, vocab 128,256; every 5th layer adds cross attention over a
# 1,601-position stub context, ``make_ctx``; 10.11 B) and starcoder2-15b
# (40 layers, d 6144, 48 heads of 128 over 4, QKV bias, GELU at d_ff
# 24,576, vocab 49,152; 15.96 B), at ARCHS_RUNS' (dtype, layers): every run
# at full depth (starcoder2-15b's float32 weights take 63.8 GB of the
# card's 80).  The forward is measured at ARCHS_FORWARD; the decode check
# (``decode_record``: a prefill of ctx - 1 tokens at capacity ctx, one step
# eagerly, planted one slot early and as a CUDA graph) runs at batch
# ARCHS_FORWARD[0] over ARCHS_DECODE_CTXS[dtype]: float32 stops at 512,
# since gemma-7b's float32 cache at 2048 is 15.0 GB a copy and the check
# holds four copies beside 34.2 GB of weights.  The serving engine runs
# the launcher's ARCHS_SERVE_ARGS (one wave of 4) for each arch in bf16.
ARCHS = ("gemma-7b", "llama-3.2-vision-11b", "starcoder2-15b")
ARCHS_RUNS = (("gemma-7b", "bfloat16", 28), ("gemma-7b", "float32", 28),
              ("llama-3.2-vision-11b", "bfloat16", 40),
              ("llama-3.2-vision-11b", "float32", 40),
              ("starcoder2-15b", "bfloat16", 40),
              ("starcoder2-15b", "float32", 40))
ARCHS_FORWARD = (8, 512)
ARCHS_DECODE_CTXS = {"bfloat16": (512, 2048), "float32": (512,)}
# The decode check's logits limit (``archs_step_tol``): DECODE_TOL in
# float32 and at ARCHS_TOL_LAYERS layers or fewer (it was set at
# qwen2-0.5b's 24).  Deeper, in bf16, the JAX package's own step error at
# that depth: ARCHS_REF_STEP_ERR[layers], the largest over the three archs
# at reduced width, seeds 0-7 and contexts 512 and 2048
# (``scripts/dense_step_drift.py``, on the CPU), rounded up to two digits.
ARCHS_TOL_LAYERS = 24
ARCHS_REF_STEP_ERR = {28: 4.3e-2, 40: 4.3e-2}
ARCHS_SERVE_ARGS = ["--requests", "4", "--prompt-len", "64", "--max-new",
                    "16", "--max-batch", "4", "--temperature", "0",
                    "--compute-dtype", "bfloat16", "--seed", "0"]
# The xLSTM phase: xlstm-1.3b at full width (48 layers, 42 mLSTM and 6
# sLSTM, d 2048, 4 heads, mLSTM inner width 4096 at hd 1024, vocab 50,304
# padded to 50,432; 3.65 B parameters: 14.60 GB in float32, 7.30 GB in
# bf16), built from seed 0 on the card in float32 and then in bf16, one at a
# time.  Its forward is measured at XLSTM_FORWARDS[dtype] ((1, 4096) in
# bf16 only: its sLSTM loop takes seconds a call) and traced at (8, 512)
# in bf16 only (a profiled forward takes ~20 s to read back).  The decode check
# prefills XLSTM_PROMPT tokens at batch XLSTM_BATCH and takes XLSTM_STEPS
# steps, eagerly and as a CUDA graph.  The whole model: the prefill's and
# each step's logits against the forward over all the tokens within
# XLSTM_STEP_TOL.  The seeded model amplifies rounding through its depth
# (the JAX package's own float32 steps at 48 layers miss its forward by up
# to 2.17 % at reduced width, its bf16 steps by 132 %), so no limit of
# DECODE_TOL's size holds for the whole model in either package:
# XLSTM_STEP_TOL is the JAX package's own largest step error over seeds
# 0-7 at 48 layers (``scripts/recurrent_step_drift.py``, reduced width, on
# the CPU), rounded up to two digits.  The states after the whole model's
# steps against a prefill of all the tokens are reported beside the JAX
# package's (XLSTM_REF_STATE_ERR).  Each layer alone, teacher-forced on
# the forward's own inputs to it (a prefill of XLSTM_PROMPT of them, then
# XLSTM_STEPS block steps against the block's forward over all), in
# float32: its steps within DECODE_TOL (the JAX package's own layers reach
# 3.0e-5) and its states within XLSTM_LAYER_STATE_TOL, the JAX package's
# own limit for its chunkwise state against its recurrent one (rtol 1e-3,
# ``tests/test_recurrent.py``): the forward's GEMMs round by their shape
# on the card, and the states sum 512 positions.  In bf16 the layers are
# reported: their largest error is an outlier of the mLSTM's normaliser
# (the port on the JAX package's own layer inputs errs as it does; see
# ``tests/test_torch_xlstm.py``).  The planted fault leaves the middle
# mLSTM layer's conv state stale for one step: the float32 layer check
# must reject it.  The serving engine runs the launcher's XLSTM_SERVE_ARGS
# (two waves of 4).
XLSTM = "xlstm-1.3b"
XLSTM_FORWARDS = {"float32": ((8, 512),), "bfloat16": ((8, 512), (1, 4096))}
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_STEPS = 8, 512, 32
XLSTM_STEP_TOL = {"float32": 2.2e-2, "bfloat16": 1.4}
XLSTM_LAYER_TOL, XLSTM_LAYER_STATE_TOL = DECODE_TOL["float32"], 1e-3
# the JAX package's own whole-model state errors (same script), reported
XLSTM_REF_STATE_ERR = {"float32": {"C": 2.72e-2, "n": 1.53e-1, "m": 2.02e-2,
                                   "conv": 1.66e-2, "c": 1.39e-1,
                                   "h": 7.35e-2},
                       "bfloat16": {"C": 1.62, "n": 1.71, "m": 1.77,
                                    "conv": 1.71, "c": 1.55, "h": 1.53}}
XLSTM_SERVE_ARGS = ["--arch", XLSTM, "--requests", "8", "--prompt-len",
                    "512", "--max-new", "16", "--max-batch", "4",
                    "--temperature", "0", "--compute-dtype", "bfloat16",
                    "--seed", "0"]
# The paper phase: the JAX package's paper tables on the card, each pricing
# the same measured work with PM2Lat, NeuSight and the FLOPs/bytes proxy.
# NeuSight is trained per dtype on PAPER_NS_SAMPLES timed ``torch.matmul``
# calls and the float32 utility ops' samples, PAPER_NS_STEPS Adam steps
# (``benchmarks/common.py``'s defaults).  Table II draws
# PAPER_TABLE2_SAMPLES shapes a layer; Table IV runs the reference's six
# models and, at full width, qwen2-0.5b and yi-6b (32 layers, d 4096, 32 /
# 4 heads of 128: 24.2 GB in float32) at PAPER_BATCHES x PAPER_SEQ in both
# dtypes; the planner CLI plans yi-6b at PAPER_PLAN_ARGS (its defaults: B 8
# x S 64); NeuSight's prediction cost is PAPER_NS_REPS ``predict_matmul``
# calls (``benchmarks/nas_speed.py``).  Errors are reported, not gated.
PAPER_MODELS = table4.MODELS + ("qwen2-0.5b", "yi-6b")
PAPER_BATCHES, PAPER_SEQ = table4.BATCHES, table4.SEQ
PAPER_NS_SAMPLES, PAPER_NS_STEPS = 40, 800
PAPER_TABLE2_SAMPLES = 10
PAPER_PLAN_ARGS = ["--arch", "yi-6b", "--stages", "4"]
PAPER_NS_REPS = 200
# The ``kernels`` line's flash rows for the paper path's narrow heads: hd 32
# (qwen3-mini, 8 heads over 4) and hd 16 (a reduced config's 4 over 4) at
# (B, S) PAPER_TIMED, causal.
PAPER_TIMED = (8, PAPER_SEQ)
PAPER_TIMED_ARCHS = ("qwen3-mini", "moonshot-v1-16b-a3b-reduced")
# The flash backward against its plain version, per tensor, as max |got -
# want| / max |want|.  float32: both sum in f32, in another order (up to
# G Sq = 3,584 products a dK element at qwen2-0.5b's geometry): 2e-5.
# bfloat16: both widen the same bf16 inputs and sum in f32, then round
# each gradient to bf16 once (unit roundoff 2^-8 of the value); a sum that
# lands near a rounding boundary can round the other way, one unit more:
# 2 * 2^-8.  The forward's lse against the plain version's: f32 2e-5
# (log of a sum in another order); bf16 1e-3 (the kernel's scores come
# from wgmma's f32 sums and its exponentials from exp2f).
BWD_TOL = {"float32": 2e-5, "bfloat16": 2 * 2.0 ** -8}
LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-3}
# The train phase: qwen2-0.5b at full width, B 8 x S 512, trained through
# launch/train.py for TRAIN_STEPS steps a dtype with the checkpoint period
# past the last step, so that only step 0's state is written (float32
# weights, m and v: ~5.9 GB), into TRAIN_CKPT, removed after each run.
# The step is timed over TRAIN_TIMED steps after TRAIN_WARM, split by CUDA
# events into forward (loss), backward (autograd) and optimizer.  One
# step's gradients on the hand path against the same model with attention
# through the plain versions on the card, as each parameter's max |d| /
# max |g|: float32 1e-3 (the two attentions differ by f32 sums in another
# order, ~1e-6 of their outputs, carried through 24 layers and the loss);
# bf16 1e-1 (the hand backward rounds P and dS to bf16 as the A operands
# of its products and the plain version does not, ~2^-8 of each gradient
# term, carried the same way).
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_STEPS = 6
TRAIN_WARM, TRAIN_TIMED = 2, 5
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
TRAIN_GRAD_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
TRAIN_RESTART = ROOT / "scripts" / "torch_train_restart.py"
# The train phase's other model kinds, each at full width, (arch, B, S, depth
# or None for the config's, learning rate): recurrentgemma-2b (2.89 B
# parameters, 46.3 GB of f32 weights, gradients and moments) at the hybrid
# phase's long shape, past its 2,048-key window, so that the window's tile
# bound is on the hd-256 backward's path; whisper-small at its decoder's 448
# positions over the launcher's context of 1,500 frames; xlstm-1.3b at B 1 x
# S 512 with its depth cut to 8 layers (one period: 7 mLSTM and 1 sLSTM; its
# 48 took 9.5-11.3 s a step of host-bound sLSTM launches and its launcher a
# 43.8 GB checkpoint, 85 s of the phase, and the cut pays for phase
# ``archs``' time); moonshot-v1-16b-a3b with its depth cut to 4 layers (3.02
# B parameters, 48.4 GB of state: its 48 would need 462 GB).  The launcher
# runs the kinds of TRAIN_KIND_LAUNCHER once each, at their depth, in bf16,
# for TRAIN_KIND_STEPS steps (the step-0 checkpoint into TRAIN_CKPT,
# removed); moonshot runs the step and the gradient check only; each dtype's
# step is timed
# over TRAIN_KIND_TIMED steps after TRAIN_KIND_WARM, whose losses must be
# finite and falling.  The launcher's default learning rate, 1e-3, sends the
# loss of recurrentgemma-2b, whisper-small and moonshot up past its start in
# the first steps (the first update is the largest Adam makes, ~lr on every
# weight); they train at 3e-5 (``--lr``), xlstm-1.3b at the default.
TRAIN_KINDS = (("recurrentgemma-2b", 1, 4096, None, 3e-5),
               ("whisper-small", 8, 448, None, 3e-5),
               ("xlstm-1.3b", 1, 512, 8, 1e-3),
               ("moonshot-v1-16b-a3b", 8, 512, 4, 3e-5))
TRAIN_KIND_STEPS = 2
TRAIN_KIND_LAUNCHER = ("recurrentgemma-2b", "whisper-small", "xlstm-1.3b")
TRAIN_KIND_WARM, TRAIN_KIND_TIMED = 1, 1
# The restart run's losses against the uninterrupted run's where PyTorch
# names an operation with no deterministic implementation (else they must
# be equal): a nondeterministic sum moves a gradient's last bits (~1e-7 of
# it), which ten steps at lr 1e-3 carry to well under 1e-5 of the loss.
TRAIN_RESTART_RTOL = 1e-5
# The distributed path (``phase_dist``): the launcher under torchrun, one
# process a rank, at the training path's full width and shape.  Its losses
# against the training path's unsharded launcher at the same steps (the
# learning rate is in warm-up there, so the schedules agree): 2e-4
# relative, the JAX package's sharded-against-one-device limit
# (tests/test_distributed.py).
DIST_SCRIPT = ROOT / "scripts" / "torch_dist_train.py"
DIST_CKPT = ROOT / "build" / "dist_ckpt"
DIST_ONE_STEPS = 3          # one NCCL rank, each dtype
DIST_PSUM_RANKS = 2         # gloo ranks sharing the card: the codec only
DIST_RTOL = 2e-4
DIST_TIMEOUT = 300
# (c) sharded serving (``scripts/torch_dist_serve.py``): one NCCL rank at
# --mesh 1x1 serving each model through the DTensor path (the flash kernel
# on the rank's heads through ``local_map``, an MoE's routing and experts
# on the rank's groups and experts) against the same model without a
# mesh: a prefill of DIST_SERVE_PROMPT tokens a row and DIST_SERVE_STEPS
# decode steps, logits at DECODE_TOL.  (arch, depth or None for the
# config's, dtype, the head dim every flash launch must have)
DIST_SERVE_SCRIPT = ROOT / "scripts" / "torch_dist_serve.py"
DIST_SERVE = (("moonshot-v1-16b-a3b", 4, "bfloat16", 128),
              ("whisper-small", None, "float32", 64))
DIST_SERVE_BATCH, DIST_SERVE_PROMPT, DIST_SERVE_STEPS = 8, 64, 8
# The dry-run path (``phase_dryrun``): ``launch/dryrun.py`` on the host, in
# processes of its own (the fake process group is process-wide), (a) at
# the training path's shape, unsharded and on a fake 1x1 mesh, held
# against phase ``train``'s step, (b) at the production cells on the fake
# (32, 8) mesh.  Each train-shape mesh is a process of its own: "none"
# runs as ``--device-mesh none``, the others as ``--mesh``.
DRYRUN_MESHES = ("none", "1x1")
DRYRUN_CELLS = ("train_4k", "prefill_32k", "decode_32k")
# (c) the MoE, encoder-decoder and xLSTM kinds' decode cells on the same
# mesh, each a process of its own beside the others
DRYRUN_KINDS = ("moonshot-v1-16b-a3b", "whisper-small", "xlstm-1.3b")
DRYRUN_KIND_CELL = "decode_32k"
DRYRUN_TIMEOUT = 300


def emit(phase: str, **fields):
    """One phase line on stdout, and appended to ``chiprun_out/phases.jsonl``
    (the tool keeps only the end of stdout)."""
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    with open(OUT / "phases.jsonl", "a") as f:
        f.write(line + "\n")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def close(got, want, atol, rtol):
    """(max |got - want|, whether |got - want| <= atol + rtol |want|
    everywhere), both in float32."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return float(err.max()), bool((err <= atol + rtol * w.abs()).all())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         capability=list(cap), count=torch.cuda.device_count())
    if cap < (9, 0):
        raise RuntimeError(f"compute capability {cap} < (9, 0): the kernels "
                           f"are built for sm_90a")
    return smi


# the bf16 instances (wgmma) and the float32 ones (FFMA), the flash
# backward's tile kernels among them
WGMMA_KERNELS = ("mm_wgmma_kernel", "fa_wgmma_kernel")
FFMA_KERNELS = ("mm_kernel", "fa_fwd_kernel")
BWD_WGMMA = ("fa_bwd_dkdv_wgmma_kernel", "fa_bwd_dq_wgmma_kernel")
BWD_FFMA = ("fa_bwd_dkdv_ffma_kernel", "fa_bwd_dq_ffma_kernel")
# the flash backward's passes around them, in both types (the type is their
# template argument): no tensor-core op
BWD_PASSES = ("fa_bwd_prep_kernel", "fa_bwd_sum_kernel")


def kernel_label(mangled: str) -> str:
    """``fa_wgmma_kernel<128,128,64,bf16>`` from a mangled template name."""
    base = re.search(r"(" + "|".join(BWD_WGMMA + BWD_FFMA + BWD_PASSES)
                     + r"|mm_wgmma_kernel|fa_wgmma_kernel|mm_kernel|"
                     r"fa_fwd_kernel)", mangled)
    ints = re.findall(r"Li(\d+)E", mangled)
    if not base:
        return mangled[:60]
    if base.group(1) in BWD_PASSES:
        kind = "bf16" if "__nv_bfloat16" in mangled else "f32"
    else:
        kind = "bf16" if base.group(1) in WGMMA_KERNELS + BWD_WGMMA else "f32"
    return f"{base.group(1)}<{','.join(ints)},{kind}>"


def phase_build():
    t0 = time.time()
    logs = build.build_all()
    OUT.mkdir(exist_ok=True)
    summary = {}
    for name, log in logs.items():
        (OUT / f"nvcc_{name}.log").write_text(log)
        fns, cur = {}, None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                cur = kernel_label(m.group(1))
                fns.setdefault(cur, {})
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                fns[cur]["spill_stores"] = int(m.group(1))
                fns[cur]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                fns[cur]["regs"] = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                fns[cur]["static_smem"] = int(smem.group(1)) if smem else 0
        summary[name] = fns
        if not fns or any("regs" not in f for f in fns.values()):
            raise AssertionError(f"no ptxas report for every kernel of "
                                 f"{name}: {fns}")
    build_s = time.time() - t0
    for name in build.SOURCES:
        build.load(name)
    # every bf16 instance runs on the tensor cores; every float32 instance
    # runs FFMA and no tensor-core instruction (true f32, no TF32); the
    # backward's passes run no tensor-core instruction
    hgmma, ffma, passes = {}, {}, {}
    count = lambda code: {op: len(re.findall(rf"\b{op}\b", code))
                          for op in ("FFMA", "HMMA", "HGMMA")}
    for name in build.SOURCES:
        for mangled, code in build.sass(name).items():
            label = kernel_label(mangled)
            if label.startswith(WGMMA_KERNELS + BWD_WGMMA):
                hgmma[label] = code.count("HGMMA")
            elif label.startswith(FFMA_KERNELS + BWD_FFMA):
                ffma[label] = count(code)
            elif label.startswith(BWD_PASSES):
                passes[label] = count(code)
    want = len(mk.CONFIGS) + len(fk.INSTANCES) \
        + len(BWD_WGMMA) * len(fkb.HEAD_DIMS)
    if len(hgmma) != want or not all(hgmma.values()):
        raise AssertionError(f"HGMMA missing from the SASS of a bf16 "
                             f"instance ({want} expected): {hgmma}")
    if len(ffma) != want or not all(c["FFMA"] and not c["HMMA"] and
                                    not c["HGMMA"] for c in ffma.values()):
        raise AssertionError(f"a float32 instance lacks FFMA or uses the "
                             f"tensor cores ({want} expected): {ffma}")
    want = len(fkb.DTYPES) * (len(fkb.HEAD_DIMS) + 1)    # prep per hd; sum
    if len(passes) != want or any(c["HMMA"] or c["HGMMA"]
                                  for c in passes.values()):
        raise AssertionError(f"a flash backward pass uses the tensor cores "
                             f"({want} expected): {passes}")
    for fns in summary.values():
        for label, f in fns.items():
            if f.get("spill_stores", 0) or f.get("spill_loads", 0):
                raise AssertionError(f"{label} spills: {f}")
    serialised = [line for log in logs.values() for line in log.splitlines()
                  if "Performance Loss" in line]
    if serialised:
        raise AssertionError(f"ptxas serialised wgmma: {serialised}")
    # the shared memory the library launches with is what Python budgets,
    # and it has no instance where Python has none (-1)
    dynamic_smem, bad = {}, []
    for dt in (torch.float32, torch.bfloat16):
        for c in mk.CONFIGS:
            py, lib = c.smem_bytes(dt), mk.library_smem(c, dt)
            dynamic_smem[f"{c.name}/{dt}"] = lib
            bad += [(c.name, str(dt), py, lib)] if py != lib else []
        for c in fk.CONFIGS:
            for hd in fk.HEAD_DIMS:
                py = c.smem_bytes(hd, dt) if (c, hd) in fk.INSTANCES else -1
                lib = fk.library_smem(c, hd, dt)
                dynamic_smem[f"{c.name}/hd{hd}/{dt}"] = lib
                bad += [(c.name, hd, str(dt), py, lib)] if py != lib else []
        for hd in fk.HEAD_DIMS:
            for kern in fkb.KERNELS:
                py = fkb.smem_bytes(hd, kern, dt) if hd in fkb.HEAD_DIMS \
                    else -1
                lib = fkb.library_smem(hd, kern, dt)
                dynamic_smem[f"fa_bwd_{kern}/hd{hd}/{dt}"] = lib
                bad += [("bwd", kern, hd, str(dt), py, lib)] \
                    if py != lib else []
    if bad:
        raise AssertionError(f"dynamic shared memory differs from Python's "
                             f"smem_bytes: {bad}")
    occupancy = float32_occupancy(summary, ffma)
    bwd = bwd_occupancy(summary)
    spans = bwd_tile_spans()
    # ptxas says "Potential Performance Loss" where it serialises wgmma
    warnings = sorted({line.strip() for log in logs.values()
                       for line in log.splitlines()
                       if "warning" in line.lower() or "Performance Loss" in line})
    out = dict(seconds=build_s, ptxas=summary, hgmma_count=hgmma,
               float32_sass=ffma, bwd_pass_sass=passes,
               float32_occupancy=occupancy, bwd_occupancy=bwd,
               bwd_tile_spans=spans, dynamic_smem_bytes=dynamic_smem,
               compiler_warnings=warnings)
    emit("build", **out)
    return out


def float32_occupancy(summary, sass):
    """Per float32 instance: registers, spills, shared memory and resident
    blocks per SM from the card's occupancy calculator, held equal to
    ``build.blocks_per_sm``'s estimate from the same threads, registers and
    shared memory; every flash instance at hd <= 64 must hold 8 warps an SM
    or more."""
    rows, bad = {}, []
    instances = [(f"mm_kernel<{c.bm},{c.bk},{c.bn},{tm},{tn},f32>", "matmul",
                  c.ffma_threads, c.smem_bytes(torch.float32),
                  mk.library_blocks_per_sm(c), None)
                 for c in mk.CONFIGS for tm, tn in [c.ffma_tile]]
    instances += [(f"fa_fwd_kernel<{c.bq},{c.bk},{hd},f32>", "flash_attention",
                   c.threads(hd, torch.float32), c.smem_bytes(hd, torch.float32),
                   fk.library_blocks_per_sm(c, hd), hd)
                  for c, hd in fk.INSTANCES]
    for label, source, threads, smem, lib, hd in instances:
        f = summary[source].get(label)
        if f is None:
            raise AssertionError(f"no ptxas report for {label}: "
                                 f"{sorted(summary[source])}")
        est = build.blocks_per_sm(threads, f["regs"], smem + f["static_smem"])
        warps = lib * threads // 32
        rows[label] = {"regs": f["regs"], "threads": threads,
                       "spill_bytes": f.get("spill_stores", 0)
                       + f.get("spill_loads", 0), "smem_bytes": smem,
                       "blocks_per_sm": lib, "estimate": est,
                       "warps_per_sm": warps,
                       "ffma_in_sass": sass[label]["FFMA"]}
        if lib != est or (hd is not None and hd <= 64 and warps < 8):
            bad.append((label, rows[label]))
    if bad:
        raise AssertionError(f"float32 occupancy differs from the estimate or "
                             f"holds fewer than 8 warps an SM: {bad}")
    return rows


def bwd_occupancy(summary):
    """Per flash backward tile kernel and type: registers (ptxas), resident
    blocks per SM (the card's occupancy calculator, held equal to
    ``build.blocks_per_sm``'s estimate), shared memory, and its grid and
    longest block (tiles visited) at the train path's attention (B 8 x S
    512, 14 query heads, causal).  The float32 kernels up to hd 64 must
    hold two blocks an SM."""
    rows, bad = {}, []
    B, S, H = TRAIN_BATCH, TRAIN_SEQ, 14
    n = -(-S // fkb.TILE)
    for dt, kinds in ((torch.bfloat16, BWD_WGMMA), (torch.float32, BWD_FFMA)):
        threads = 128 if dt == torch.bfloat16 else 256
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for hd in fkb.HEAD_DIMS:
            for kern, name in zip(fkb.KERNELS, kinds):
                label = f"{name}<{hd},{tag}>"
                f = summary["flash_attention_bwd"].get(label)
                if f is None:
                    raise AssertionError(
                        f"no ptxas report for {label}: "
                        f"{sorted(summary['flash_attention_bwd'])}")
                smem = fkb.smem_bytes(hd, kern, dt)
                lib = fkb.library_blocks_per_sm(hd, kern, dt)
                est = build.blocks_per_sm(threads, f["regs"],
                                          smem + f["static_smem"])
                axis = "q" if kern == "dkdv" else "kv"
                tiles = [hi - lo for lo, hi in
                         (fkb.tile_range(t, axis, S, S) for t in range(n))]
                rows[label] = {"regs": f["regs"], "threads": threads,
                               "smem_bytes": smem, "blocks_per_sm": lib,
                               "estimate": est,
                               "train_grid": [B * H, n],
                               "train_blocks": B * H * n,
                               "train_longest_block_tiles": max(tiles),
                               "train_tiles": B * H * sum(tiles)}
                if lib != est or (dt == torch.float32 and hd <= 64
                                  and lib < 2):
                    bad.append((label, rows[label]))
    if bad:
        raise AssertionError(f"flash backward occupancy differs from the "
                             f"estimate, or a float32 kernel up to hd 64 "
                             f"holds fewer than two blocks an SM: {bad}")
    return rows


def bwd_tile_spans():
    """The library's ``tile_span`` against ``tile_range`` (its Python
    mirror, which the CPU tests hold against the JAX package's mask) on
    every tile of the backward's cases and of masks with rows that keep no
    key; the count of tiles compared."""
    masks = [(Sq, Skv, causal, window, Skv - Sq)
             for _, Sq, Skv, _, _, _, causal, window in bwd_path_cases()]
    masks += [(200, 100, True, None, -100), (128, 64, True, 16, 200),
              (300, 300, True, 1, 0), (130, 700, True, 70, 570)]
    n, bad = 0, []
    for Sq, Skv, causal, window, q_offset in masks:
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        for axis, count in (("q", Skv), ("kv", Sq)):
            for t in range(-(-count // fkb.TILE)):
                got = fkb.library_tile_range(t, axis, Sq, Skv, **kw)
                want = fkb.tile_range(t, axis, Sq, Skv, **kw)
                n += 1
                if tuple(got) != tuple(want):
                    bad.append((Sq, Skv, kw, axis, t, got, want))
    if bad:
        raise AssertionError(f"tile_span differs from tile_range: {bad[:5]}")
    return n


def offset(shape, dt, gen, by=1):
    """A contiguous tensor of ``shape`` whose base address is ``by``
    elements past an allocation's (2 bytes off alignment in bf16)."""
    n = int(np.prod(shape))
    flat = torch.randn(n + by, generator=gen, device="cuda").to(dt)
    return flat[by:].view(*shape)


def check_matmul(dtypes):
    """Every config, both types: aligned shapes (TMA), ragged edges with
    16-byte row strides (TMA, zero-filled boxes), odd K or N, tiny shapes
    and operands 2 bytes off alignment (the second load path)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    rows = []
    for cfg in mk.CONFIGS:
        for dname in dtypes:
            dt = getattr(torch, dname)
            atol_k, rtol = MM_TOL[dname]
            cases = [((2 * cfg.bm, 3 * cfg.bk, 2 * cfg.bn), None),
                     ((2 * cfg.bm + 37, 2 * cfg.bk + 24, cfg.bn + 40), None),
                     ((2 * cfg.bm + 37, 2 * cfg.bk + 19, cfg.bn + 23), None),
                     ((5, 7, 3), None),
                     ((2 * cfg.bm, 2 * cfg.bk, cfg.bn), "a"),   # a[:, 1:]
                     ((cfg.bm + 3, cfg.bk, 2 * cfg.bn), "b")]   # b 2 bytes off
            for (M, K, N), off in cases:
                if off == "a":
                    a = torch.randn(M, K + 1, generator=gen,
                                    device="cuda").to(dt)[:, 1:]
                else:
                    a = torch.randn(M, K, generator=gen, device="cuda").to(dt)
                b = (offset((K, N), dt, gen) if off == "b" else
                     torch.randn(K, N, generator=gen, device="cuda").to(dt))
                path = mk.load_path(a, b)
                got = mk.matmul_kernel(a, b, cfg)
                torch.cuda.synchronize()
                err, ok = close(got, mk.matmul_plain(a, b),
                                atol_k * K ** 0.5, rtol)
                rows.append({"cfg": cfg.name, "dtype": dname, "path": path,
                             "shape": [M, K, N], "offset": off,
                             "max_abs_err": err, "ok": ok})
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(f"matmul {cfg.name} {dname} {path} "
                                         f"{(M, K, N)}: max err {err}")
    return worst, rows


def flash_tol(q, k, v, cfg, dname, kw):
    """(atol, rtol) of FA_TOL for these inputs; bf16's atol is per element."""
    if dname == "float32":
        return FA_TOL[dname]
    return (2 ** -8 * fk.flash_attention_plain(q, k, v.abs(), cfg, **kw).float(),
            FA_TOL[dname][1])


def decode_path_cases():
    """The flash calls of the decode and serve paths, qwen2-0.5b's causal
    attention at batch 8: each ctx's prefill of ctx - 1 tokens and forward
    over ctx (ragged where ctx - 1 is no multiple of a tile); the serve
    path's prefill of 512 is the forward at ctx 512."""
    c = cfg_registry.get(MODEL)
    return [(BATCH, S, S, c.n_heads, c.n_kv_heads, c.head_dim, True, None,
             None) for ctx in DECODE_CTXS for S in (ctx - 1, ctx)]


def grid_path_cases():
    """The flash calls of the grid path that ``decode_path_cases`` lacks:
    each measured forward (B, S) and each measured decode point's prefill
    of ctx - 1 tokens and forward over ctx."""
    c = cfg_registry.get(MODEL)
    have = {(B, S) for B, S, *_ in decode_path_cases()}
    shapes = sorted(set(GRID_MEASURED)
                    | {(b, S) for b, ctx in GRID_DECODE_MEASURED
                       for S in (ctx - 1, ctx)})
    return [(B, S, S, c.n_heads, c.n_kv_heads, c.head_dim, True, None, None)
            for B, S in shapes if (B, S) not in have]


def schedule_path_cases():
    """The flash calls of the schedule path that the earlier paths lack:
    the microbatch chunks' forwards (8 / mb, 512), which include the
    planned stages' (8, 512) and the capacity-1 serve's prefill (1, 512)."""
    c = cfg_registry.get(MODEL)
    have = {(B, S) for B, S, *_ in decode_path_cases() + grid_path_cases()}
    shapes = sorted({(BATCH // mb, SEQ) for mb in SCHED_MB})
    return [(B, S, S, c.n_heads, c.n_kv_heads, c.head_dim, True, None, None)
            for B, S in shapes if (B, S) not in have]


def hybrid_path_cases():
    """The flash calls of the hybrid path (recurrentgemma-2b's local
    attention: 10 query heads over 1 KV head at hd 256, causal, window
    2048): the measured forwards HYBRID_FORWARDS, the ring check's prefill
    and forward, and the serving engine's prefill (``check_served``'s
    too)."""
    c = cfg_registry.get(HYBRID)
    serve = serve_launcher.parse_args(HYBRID_SERVE_ARGS)
    shapes = sorted(set(HYBRID_FORWARDS) | {
        (HYBRID_RING_BATCH, HYBRID_RING_PROMPT),
        (HYBRID_RING_BATCH, HYBRID_RING_PROMPT + HYBRID_RING_STEPS),
        (serve.max_batch, serve.prompt_len)})
    return [(B, S, S, c.n_heads, c.n_kv_heads, c.head_dim, True,
             c.sliding_window, None) for B, S in shapes]


def encdec_path_cases():
    """The flash calls of the encoder–decoder path (whisper-small: 12
    heads of 64 over 12 KV heads, 1,500 frames) at each (B, S) the path
    runs: the measured forwards ENCDEC_FORWARDS (whose (1, 64) batch is
    the encoder check's), the decode check's prefill and forward, and the
    serving engine's prefill (``check_served``'s too).  Each is the
    encoder (B, 1500, 1500) and cross attention (B, S, 1500), non-causal,
    and the decoder's self-attention (B, S, S), causal."""
    c = cfg_registry.get(ENCDEC)
    serve = serve_launcher.parse_args(ENCDEC_SERVE_ARGS)
    shapes = sorted(set(ENCDEC_FORWARDS) | {
        (ENCDEC_BATCH, ENCDEC_PROMPT),
        (ENCDEC_BATCH, ENCDEC_PROMPT + ENCDEC_STEPS),
        (serve.max_batch, serve.prompt_len)})
    L, heads = c.encoder.n_frames, (c.n_heads, c.n_kv_heads, c.head_dim)
    return ([(B, L, L, *heads, False, None, None)
             for B in sorted({B for B, _ in shapes})]
            + [(B, S, L, *heads, False, None, None) for B, S in shapes]
            + [(B, S, S, *heads, True, None, None) for B, S in shapes])


def moe_path_cases():
    """The flash calls of the MoE path, causal at hd 128: moonshot's 16
    heads over 16 KV heads and llama4-scout's 40 over 8 (GQA group 5), at
    each (B, S) the path runs: the forward MOE_FORWARD, the decode check's
    prefill and forward, and (moonshot) the serving engine's prefill
    (``check_served``'s too)."""
    serve = serve_launcher.parse_args(MOE_SERVE_ARGS)
    shapes = {MOE_FORWARD, (MOE_BATCH, MOE_PROMPT),
              (MOE_BATCH, MOE_PROMPT + MOE_STEPS)}
    out = []
    for arch in (MOE, MOE_SCOUT):
        c = cfg_registry.get(arch)
        run = shapes | ({(serve.max_batch, serve.prompt_len)}
                        if arch == MOE else set())
        out += [(B, S, S, c.n_heads, c.n_kv_heads, c.head_dim, True, None,
                 None) for B, S in sorted(run)]
    return out


def archs_path_cases():
    """The flash calls of the archs path (ARCHS at full width), at each
    (B, S) the path runs: the forward ARCHS_FORWARD, each decode check's
    prefill of ctx - 1 tokens and forward over ctx (every dtype's ctxs),
    and the serving engine's prefill (``check_served``'s too).  Each is the
    self attention, causal over S keys at the arch's heads (gemma-7b's 16
    of 256 over 16, llama-3.2-vision-11b's 32 of 128 over 8,
    starcoder2-15b's 48 of 128 over 4), and llama-3.2-vision-11b's cross
    attention, non-causal over its 1,601 context positions (its last KV
    tile holds one key)."""
    serve = serve_launcher.parse_args(["--arch", ARCHS[0],
                                       *ARCHS_SERVE_ARGS])
    B = ARCHS_FORWARD[0]
    shapes = sorted({ARCHS_FORWARD, (serve.max_batch, serve.prompt_len)}
                    | {(B, S) for ctxs in ARCHS_DECODE_CTXS.values()
                       for ctx in ctxs for S in (ctx - 1, ctx)})
    out = []
    for arch in ARCHS:
        c = cfg_registry.get(arch)
        heads = (c.n_heads, c.n_kv_heads, c.head_dim)
        out += [(B, S, S, *heads, True, None, None) for B, S in shapes]
        if C.CROSS_ATTN in c.layer_kinds:
            out += [(B, S, c.cross_attn_context_len, *heads, False, None,
                     None) for B, S in shapes]
    return out


def paper_path_cases():
    """The flash calls of the paper path that the earlier paths lack: each
    Table IV forward (B, PAPER_SEQ) of each of PAPER_MODELS, causal, at the
    model's heads and window (a local-attention layer's); they include the
    partition application's blocks (qwen3-mini at its default (4, 128))."""
    have = set(decode_path_cases() + grid_path_cases()
               + schedule_path_cases() + hybrid_path_cases()
               + encdec_path_cases() + moe_path_cases())
    out = []
    for arch in PAPER_MODELS:
        c = cfg_registry.get_any(arch)
        window = c.sliding_window if C.LOCAL_ATTN in c.layer_kinds else None
        for B in PAPER_BATCHES:
            case = (B, PAPER_SEQ, PAPER_SEQ, c.n_heads, c.n_kv_heads,
                    c.head_dim, True, window, None)
            if case not in have and case not in out:
                out.append(case)
    return out


def check_flash(dtypes):
    """Causal and not, window 64, every instantiated head dim, GQA, ragged
    and unequal lengths (bottom-right causal alignment), every config
    instantiated at the case's head dim (``fk.INSTANCES``: fa_64x64 alone
    at hd 256); in bf16 every (config, hd) goes through TMA, and strided
    views (TMA) and tensors 2 bytes off alignment or with an odd row
    stride (the second load path) are added; then the decode and serve
    paths' shapes (``decode_path_cases``), the grid path's
    (``grid_path_cases``), the schedule path's (``schedule_path_cases``),
    the hybrid path's (``hybrid_path_cases``), the encoder–decoder
    path's (``encdec_path_cases``: non-causal over 1,500 keys, ragged
    against both tiles), the MoE path's (``moe_path_cases``: hd 128), the
    archs path's (``archs_path_cases``: hd 256 over 16 KV heads, GQA 12 at
    hd 128, non-causal over 1,601 keys) and the paper path's
    (``paper_path_cases``: hd 16, 32, 64 and 128 at S 128)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (B, Sq, Skv, H, Hkv, hd, causal, window, layout)
        (2, 256, 256, 3, 3, 64, True, None, None),
        (2, 256, 256, 3, 3, 64, False, None, None),
        (1, 256, 256, 2, 2, 32, True, 64, None),
        (1, 256, 256, 4, 4, 16, True, None, None),
        (1, 128, 128, 2, 2, 128, True, None, None),
        (2, 512, 512, 14, 2, 64, True, None, None),     # qwen2-0.5b's geometry
        (1, 200, 200, 4, 2, 32, True, None, None),      # ragged S
        (1, 100, 300, 4, 1, 64, True, None, None),      # Sq < Skv, ragged
        (1, 77, 77, 2, 2, 64, False, None, None),
        (1, 96, 160, 2, 2, 16, False, None, None),
        (2, 130, 130, 4, 2, 128, True, 40, None),
        (2, 256, 256, 4, 2, 64, True, None, "fused"),    # q, k, v slices of qkv
        (1, 150, 201, 4, 2, 64, True, None, "offset"),   # 2 bytes off
        (1, 129, 129, 2, 1, 128, False, None, "offset"),
        (1, 100, 100, 2, 2, 32, True, None, "odd_row"),  # odd sequence stride
        (2, 130, 130, 4, 2, 256, True, 40, None),       # hd 256
        (1, 77, 77, 2, 2, 256, False, None, None),
        (1, 150, 201, 4, 2, 256, True, None, "offset"),
    ] + decode_path_cases() + grid_path_cases() + schedule_path_cases() \
        + hybrid_path_cases() + encdec_path_cases() + moe_path_cases() \
        + archs_path_cases() + paper_path_cases()
    worst = 0.0
    rows = []
    for cfg in fk.CONFIGS:
        for dname in dtypes:
            dt = getattr(torch, dname)
            for B, Sq, Skv, H, Hkv, hd, causal, window, layout in cases:
                if (cfg, hd) not in fk.INSTANCES:
                    continue
                if layout == "fused":
                    qkv = torch.randn(B, Sq, H + 2 * Hkv, hd, generator=gen,
                                      device="cuda").to(dt)
                    q, k, v = qkv.split([H, Hkv, Hkv], dim=2)
                elif layout == "offset":
                    q = offset((B, Sq, H, hd), dt, gen)
                    k = offset((B, Skv, Hkv, hd), dt, gen)
                    v = offset((B, Skv, Hkv, hd), dt, gen, by=3)
                elif layout == "odd_row":
                    rand = lambda S, n: torch.randn(
                        B, S, n * hd + 1, generator=gen,
                        device="cuda").to(dt)[..., :n * hd].unflatten(2, (n, hd))
                    q, k, v = rand(Sq, H), rand(Skv, Hkv), rand(Skv, Hkv)
                else:
                    q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dt)
                    k = torch.randn(B, Skv, Hkv, hd, generator=gen, device="cuda").to(dt)
                    v = torch.randn(B, Skv, Hkv, hd, generator=gen, device="cuda").to(dt)
                kw = dict(causal=causal, window=window, q_offset=Skv - Sq)
                path = fk.load_path(q, k, v)
                got = fk.flash_attention_kernel(q, k, v, cfg, **kw)
                torch.cuda.synchronize()
                want = fk.flash_attention_plain(q, k, v, cfg, **kw)
                err, ok = close(got, want, *flash_tol(q, k, v, cfg, dname, kw))
                rows.append({"cfg": cfg.name, "dtype": dname, "path": path,
                             "case": [B, Sq, Skv, H, Hkv, hd, causal, window,
                                      layout],
                             "max_abs_err": err, "ok": ok})
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(
                        f"flash {cfg.name} {dname} {path} "
                        f"{(B, Sq, Skv, H, Hkv, hd)} causal={causal} "
                        f"window={window} layout={layout}: max err {err}")
    return worst, rows


def bwd_path_cases():
    """The flash backward's cases: (B, Sq, Skv, H, Hkv, hd, causal,
    window): the train path's geometry (qwen2-0.5b at B 8 x S 512, GQA 7),
    recurrentgemma-2b's (B 1 x S 4096, 10 query heads over 1 at hd 256,
    under its 2,048-key window) and at hd 256 a ragged windowed case and a
    non-causal one, whisper-small's encoder (8 x 1,500 frames, 12 heads of
    64, non-causal) and cross attention (448 over 1,500 keys),
    non-causal over a ragged Skv (Sq != Skv), a window, GQA 1 at hd 128,
    bottom-right causal over a ragged Skv, a window at hd 128 with ragged
    lengths, the reduced configs' narrow heads (hd 16 and 32: phase
    ``train``'s restart run trains one), a q_offset > 0 (Sq < Skv) under
    a window narrower than a tile (the tile skip's both bounds), GQA groups
    of 10 and 11, and a q_offset < 0 (Sq > Skv: rows that keep no key, so
    every tile is visited)."""
    return [(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 14, 2, 64, True, None),
            (1, 4096, 4096, 10, 1, 256, True, 2048),
            (2, 190, 333, 10, 1, 256, True, 100),
            (1, 300, 500, 10, 1, 256, False, None),
            (8, 1500, 1500, 12, 12, 64, False, None),
            (8, 448, 1500, 12, 12, 64, False, None),
            (2, 200, 333, 14, 2, 64, False, None),
            (2, 256, 256, 8, 1, 64, True, 64),
            (2, 300, 300, 4, 4, 128, True, None),
            (3, 100, 229, 14, 2, 64, True, None),
            (1, 190, 190, 2, 1, 128, True, 50),
            (2, 128, 128, 4, 2, 16, True, None),
            (1, 96, 160, 8, 4, 32, False, None),
            (2, 160, 300, 8, 2, 64, True, 40),
            (1, 128, 128, 20, 2, 64, True, None),
            (1, 100, 100, 11, 1, 32, True, None),
            (1, 150, 90, 4, 2, 64, True, None)]


def bwd_inputs(case, dt, gen):
    """q, k, v, do of a backward case in ``dt`` and the hand forward's o
    and lse over them."""
    B, Sq, Skv, H, Hkv, hd, causal, window = case
    rand = lambda *shape: torch.randn(*shape, generator=gen,
                                      device="cuda").to(dt)
    q, k, v = rand(B, Sq, H, hd), rand(B, Skv, Hkv, hd), rand(B, Skv, Hkv, hd)
    do = rand(B, Sq, H, hd)
    kw = dict(causal=causal, window=window, q_offset=Skv - Sq)
    cfg = fk.select_config(Sq, Skv, hd, dt)
    o, lse = fk.flash_attention_kernel(q, k, v, cfg, return_lse=True, **kw)
    return (q, k, v, o, lse, do), cfg, kw


def rel_max(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def check_flash_bwd(dtypes):
    """The hand backward against ``flash_attention_bwd_plain`` on the same
    (q, k, v, o, lse, do) at ``bwd_path_cases``, per gradient at
    ``BWD_TOL``; a second launch on the same inputs bit-equal to the first
    (no atomics); and the forward's lse against ``flash_attention_plain``'s
    at ``LSE_TOL``."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, worst = [], 0.0
    for dname in dtypes:
        dt = getattr(torch, dname)
        for case in bwd_path_cases():
            args, cfg, kw = bwd_inputs(case, dt, gen)
            q, k, v, o, lse, do = args
            got = fkb.flash_attention_bwd_kernel(*args, **kw)
            again = fkb.flash_attention_bwd_kernel(*args, **kw)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            want = fkb.flash_attention_bwd_plain(*args, **kw)
            errs = {name: rel_max(g, w) for name, g, w in
                    zip(("dq", "dk", "dv"), got, want)}
            _, lse_plain = fk.flash_attention_plain(q, k, v, cfg,
                                                    return_lse=True, **kw)
            lse_err = float((lse - lse_plain).abs().max())
            ok = all(e <= BWD_TOL[dname] for e in errs.values()) \
                and lse_err <= LSE_TOL[dname] and bitwise
            rows.append({"dtype": dname, "case": list(case), **errs,
                         "lse_max_abs_err": lse_err,
                         "bitwise_repeat": bitwise, "ok": ok})
            worst = max(worst, *errs.values())
            if not ok:
                raise AssertionError(f"flash backward {dname} {case}: "
                                     f"{errs}, lse {lse_err}, bit-equal "
                                     f"repeat {bitwise}")
    return worst, rows


def phase_calibrate():
    path = cal.default_store_path("cuda")      # artifacts/torch/
    store = cal.calibrate_device(path, device="cuda", verbose=False)
    store.save(str(OUT / os.path.basename(path)))
    kinds = {}
    for t in store.tables.values():
        kern = t.key.kernel
        fam = ("cublas" if kern.startswith("cublas@") else "fa_model"
               if kern == "fa_model" else "mm" if kern.startswith("mm_")
               else "fa" if kern.startswith("fa_") else kern)
        kinds.setdefault(t.key.dtype, set()).add(fam)
    want = {"cublas", "fa_model", "mm", "fa"}
    for dt in ("float32", "bfloat16"):
        if kinds.get(dt, set()) != want:
            raise AssertionError(f"store lacks tables for {dt}: has "
                                 f"{sorted(kinds.get(dt, ()))}")
    mm = store.memory_model
    out = dict(seconds=store.meta["seconds"], device=store.meta["device"],
               tables=len(store.tables),
               families={k: sorted(v) for k, v in kinds.items()},
               memory_model_train_rel_err=mm["train_rel_err"])
    emit("calibrate", **out)
    return store, out


def phase_table6(store):
    """Table VI through its driver (``benchmarks/table6_custom_kernels.py``),
    on each of its draws (the JAX package's sampled shapes, whose calls are
    launch-bound on the card, and wider ones), in both dtypes: the oracle's
    pick among the hand kernels' tables, every hand config measured, and
    each config's prediction error; cuBLAS batched products through the
    oracle's nearest grid.  Each draw is reported on a line of its own
    (``table6``, ``table6_wide``).  Fails on a time that is not positive or
    an error that is not finite."""
    out = {}
    for draws, name in (("reference", "table6"), ("wide", "table6_wide")):
        rec = out[draws] = table6_driver.run(
            store, samples=TABLE6_SAMPLES, device="cuda", draws=draws,
            verbose=False)
        emit(name, draws=draws, summary=rec["summary"],
             samples={k: rec[k] for k in ("mm", "fa", "bmm")})
        times = [t for fam in ("mm", "fa") for r in rec[fam]
                 for t in r["ms"].values()] + [r["ms"] for r in rec["bmm"]]
        errs = [e for fam in ("mm", "fa") for r in rec[fam]
                for e in r["rel_err"].values()] + [r["rel_err"]
                                                    for r in rec["bmm"]]
        if min(times) <= 0 or not np.isfinite(errs).all():
            raise AssertionError(f"table6 {draws}: a time not positive or "
                                 f"an error not finite: {rec['summary']}")
    return out


def phase_model(store):
    cfg0 = cfg_registry.get(MODEL)
    pm = PM2Lat(store, store.meta["device"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg0.vocab_size, (BATCH, SEQ), generator=gen,
                           device="cuda")
    model = model_registry.build(dataclasses.replace(cfg0,
                                                     compute_dtype="float32"),
                                 device="cuda", seed=0)
    results = {}
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        model.cfg = cfg
        if dname == "bfloat16":
            cast_weights_(model, torch.bfloat16)   # once, before timing
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = fk.flash_attention_kernel.launches
            logits = model(tokens)
            torch.cuda.synchronize()
            per_forward = fk.flash_attention_kernel.launches - before
            peak = torch.cuda.max_memory_allocated()
            finite = bool(torch.isfinite(logits).all())
            shape = list(logits.shape)
            del logits
            trace = forward_trace(model, tokens)
            measured = profiler.measure(model, tokens)
        total, rows = pm.predict_model(cfg, BATCH, SEQ, dtype=dname)
        top = sorted(rows, key=lambda r: -r.seconds)[:5]
        res = {"dtype": dname, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "padded_vocab": model.padded_vocab, "batch": BATCH, "seq": SEQ,
               "logits_shape": shape, "logits_finite": finite,
               "flash_launches_per_forward": per_forward,
               "predicted_ms": total * 1e3, "measured_ms": measured * 1e3,
               "err_pct": 100 * abs(total - measured) / measured,
               "top5_predicted": [[r.name, r.kernel, r.seconds * 1e3]
                                  for r in top],
               "peak_mem_gb": peak / 1e9}
        res["device_trace"] = trace
        emit("model", **res)
        if not finite or shape != [BATCH, SEQ, model.padded_vocab]:
            raise AssertionError(f"{MODEL} {dname}: logits {shape}, finite="
                                 f"{finite}")
        if per_forward != cfg.n_layers:
            raise AssertionError(f"flash kernel launched {per_forward} times "
                                 f"in one forward, expected {cfg.n_layers}")
        if not (total > 0 and measured > 0):
            raise AssertionError(f"prediction {total} / measurement {measured}")
        results[dname] = res
    return results


def device_ms(fn, *args, n=20, reps=5, stream=None):
    """Device time of one call: ``n`` calls captured once as a CUDA graph
    (after a warm-up call on a side stream), the graph replayed ``reps``
    times between two CUDA events, divided by ``n * reps``.  A replay
    launches the calls' kernels with no host work between them, so the
    reading is the device's (the gaps between its kernels included), and
    no profiler event can be dropped from it.  ``stream``: warm up and
    capture on that stream (autograd runs a backward on the stream of its
    forward, so a backward is captured where its forward ran)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(n):
            fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del graph
    return ms


def host_ms(fn, *args, n=20):
    """The host's time to enqueue one call, over ``n`` back-to-back calls
    (synchronized before, not after)."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def profile_cuda():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_rows(prof):
    """``{name: [calls, device ms]}`` of a trace's device-side events
    (kernels and copies), summed from the events themselves.
    ``key_averages()`` also gives each CPU op the device time of the
    kernels it launched, so summing its rows counts that time twice."""
    from torch.autograd import DeviceType
    rows = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = rows.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us() / 1e3
    return rows


# cuBLAS/cuBLASLt GEMM and GEMV kernels (and their split-K reductions)
# by name, for the share of a trace's busy time that the matmul rows price;
# the hand flash kernel's instances by name
GEMM_KERNEL = re.compile(r"gemm|gemv|nvjet|xmma|splitKreduce", re.IGNORECASE)
FLASH_KERNEL = re.compile(r"fa_wgmma_kernel|fa_fwd_kernel")
# the MoE routing's top-k (radix select) and cumsum (scan) kernels by name
ROUTING_KERNEL = re.compile(r"topk|kth|scan", re.IGNORECASE)


def forward_trace(fn, *args):
    """Where one call's time goes (a forward, a decode step).  Without the
    profiler: the host's time to enqueue it and the device's span from its
    first to its last kernel (CUDA events); where the two are close, the
    host sets the pace.  Under ``torch.profiler``: the device's busy time,
    the part of it in cuBLAS GEMM/GEMV kernels (``GEMM_KERNEL``), its idle
    share of that span, the part of it in the hand flash kernel
    (``FLASH_KERNEL``), the part in top-k and cumsum kernels
    (``ROUTING_KERNEL``: MoE routing), and the 10 kernels that take the
    most time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn(*args)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    span = start.elapsed_time(end)
    with profile_cuda() as prof:
        fn(*args)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(t for _, t in rows.values())
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:10]
    return {"host_enqueue_ms": host_ms, "span_ms": span,
            "device_busy_ms": busy,
            "gemm_ms": sum(t for name, (_, t) in rows.items()
                           if GEMM_KERNEL.search(name)),
            "flash_ms": sum(t for name, (_, t) in rows.items()
                            if FLASH_KERNEL.search(name)),
            "topk_scan_ms": sum(t for name, (_, t) in rows.items()
                                if ROUTING_KERNEL.search(name)),
            "idle_share": (1 - busy / span) if busy else None,
            "kernel_launches": sum(c for c, _ in rows.values()),
            "top10": [[name[:90], c, t] for name, (c, t) in top]}


def hand_launches():
    """Each hand kernel's launches, the flash kernel's by head dim
    (``flash_attention@hd<hd>``) and by mask (``flash_attention@causal``,
    ``flash_attention@noncausal``) and its backward's by head dim
    (``flash_attention_bwd@hd<hd>``), as the wrappers count them."""
    fa, fb = fk.flash_attention_kernel, fkb.flash_attention_bwd_kernel
    return {"matmul": mk.matmul_kernel.launches,
            "flash_attention": fa.launches,
            "flash_attention_bwd": fb.launches,
            **{f"flash_attention@hd{hd}": n
               for hd, n in sorted(fa.launches_by_hd.items())},
            **{f"flash_attention@{'causal' if c else 'noncausal'}": n
               for c, n in sorted(fa.launches_by_causal.items())},
            **{f"flash_attention_bwd@hd{hd}": n
               for hd, n in sorted(fb.launches_by_hd.items())}}


def reset_launches():
    mk.matmul_kernel.launches = 0
    fk.flash_attention_kernel.launches = 0
    fkb.flash_attention_bwd_kernel.launches = 0
    fk.flash_attention_kernel.launches_by_hd.clear()
    fk.flash_attention_kernel.launches_by_causal.clear()
    fkb.flash_attention_bwd_kernel.launches_by_hd.clear()


def phase_decode(store):
    """qwen2-0.5b at batch 8, float32 then bf16, ctx in DECODE_CTXS: prefill
    ctx - 1 random tokens with ``max_len = ctx`` (so that the step attends
    over the W = ctx slots the predictor prices), then one decode step,
    eager and as a replayed CUDA graph.  Fails unless the cache holds
    ``kv_cache_bytes``, the step's logits match the last position of a
    forward over the same ctx tokens within DECODE_TOL, the replay gives
    the eager step's logits bit for bit, and no hand kernel launches inside
    the step, and unless the logits check rejects a step planted one slot
    early.  Returns the records and the bytes floors."""
    cfg0 = cfg_registry.get(MODEL)
    pm = PM2Lat(store, store.meta["device"])
    model = model_registry.build(dataclasses.replace(
        cfg0, compute_dtype="float32"), device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    records, floors = [], []
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        model.cfg = cfg
        if dname == "bfloat16":
            cast_weights_(model, torch.bfloat16)
        weight_bytes = sum(p.nbytes for p in model.parameters())
        for ctx in DECODE_CTXS:
            tokens = torch.randint(0, cfg.vocab_size, (BATCH, ctx),
                                   generator=gen, device="cuda")
            with torch.no_grad():
                rec = decode_record(model, pm, cfg, tokens)
            kv = og.kv_cache_bytes(cfg, BATCH, ctx, dname)
            floor = (weight_bytes + kv) / H100_SXM.hbm_bw * 1e3
            floors.append({"dtype": dname, "batch": BATCH, "ctx": ctx,
                           "weight_bytes": weight_bytes, "kv_read_bytes": kv,
                           "floor_ms": floor, "graph_ms": rec["graph_ms"],
                           "floor_share": floor / rec["graph_ms"]})
            emit("decode", **rec)
            records.append(rec)
            bad = decode_failures(rec)
            if bad:
                raise AssertionError(f"decode {dname} ctx {ctx}: failed {bad}")
    emit("decode_floors", rows=floors)
    return records, floors


DECODE_CHECKS = ("cache_bytes_ok", "logits_ok", "graph_bitwise",
                 "planted_fault_caught")


def decode_failures(rec):
    """The DECODE_CHECKS ``rec`` failed, and a hand launch inside the step."""
    bad = [k for k in DECODE_CHECKS if not rec[k]]
    if rec["hand_launches_in_step"]:
        bad.append(f"hand launches in the step {rec['hand_launches_in_step']}")
    return bad


def decode_check(model, cfg, tokens, ctx_embed=None, tol=None):
    """One decode step at (B, ctx) = ``tokens.shape``: prefill ctx - 1
    tokens at capacity ctx, step eagerly, as a step planted one slot early
    and as a CUDA graph, and time the graph.  ``ctx_embed``: the context of
    a model that takes one, given to the forward and the prefill; ``tol``:
    the logits limit (default DECODE_TOL).  Returns the record of
    DECODE_CHECKS, the eager and graph step callables and the hand-kernel
    counts taken before the first step (``hand_launches_in_step`` covers
    the steps made here)."""
    dname = cfg.compute_dtype
    tol = DECODE_TOL[dname] if tol is None else tol
    B, ctx = tokens.shape
    logits = model(tokens, ctx_embed=ctx_embed)
    want = logits[:, -1].float()
    del logits
    _, cache = model.prefill(tokens[:, :-1], ctx_embed=ctx_embed,
                             max_len=ctx)
    kv = og.kv_cache_bytes(cfg, B, ctx, dname)
    tok = tokens[:, -1].contiguous()
    start = cache.clone()
    before = hand_launches()
    eager, _ = model.decode_step(tok, cache)
    # a planted fault: the same step one slot early (rope and cache write
    # at ctx - 2), which the logits check must catch
    fault = start.clone()
    fault.pos.fill_(ctx - 2)
    wrong, _ = model.decode_step(tok, fault)
    del fault
    graph = DecodeGraph(model, start)
    replay = graph.load(start)(tok).clone()
    torch.cuda.synchronize()
    rel = lambda x: float((x.float() - want).abs().max() / want.abs().max())
    err, fault_err = rel(eager), rel(wrong)

    def eager_step():
        cache.pos.fill_(ctx - 1)
        return model.decode_step(tok, cache)

    def graph_step():
        graph.cache.pos.fill_(ctx - 1)
        return graph(tok)

    graph_s = profiler.measure(graph_step)
    rec = {"dtype": dname, "batch": B, "ctx": ctx,
           "capacity": cache.capacity,
           "cache_bytes": cache.nbytes, "kv_cache_bytes": kv,
           "cache_bytes_ok": cache.nbytes == kv,
           "logits_rel_err": err, "logits_tol": tol,
           "logits_ok": err <= tol,
           "planted_fault_rel_err": fault_err,
           "planted_fault_caught": fault_err > tol,
           "graph_bitwise": bool(torch.equal(eager, replay)),
           "hand_launches_in_step": launches_since(before),
           "graph_ms": graph_s * 1e3}
    return rec, eager_step, graph_step, before


def launches_since(before):
    return {k: v - before.get(k, 0) for k, v in hand_launches().items()
            if v != before.get(k, 0)}


def decode_record(model, pm, cfg, tokens, ctx_embed=None, tol=None):
    """``decode_check`` (with ``ctx_embed`` and ``tol``) plus the eager
    step's time, both steps' traces and the scalar predictor's step."""
    dname = cfg.compute_dtype
    B, ctx = tokens.shape
    rec, eager_step, graph_step, before = decode_check(model, cfg, tokens,
                                                       ctx_embed, tol)
    eager_s = profiler.measure(eager_step)
    eager_trace = forward_trace(eager_step)
    graph_trace = forward_trace(graph_step)
    total, rows = pm.predict_ops(og.enumerate_decode_ops(cfg, B, ctx,
                                                         dtype=dname))
    top = sorted(rows, key=lambda r: -r.seconds)[:5]
    by_kind = {}
    for r in rows:
        by_kind[r.kind] = by_kind.get(r.kind, 0.0) + r.seconds * 1e3
    graph_s = rec["graph_ms"] / 1e3
    rec.update({"hand_launches_in_step": launches_since(before),
                "eager_ms": eager_s * 1e3,
                "predicted_ms": total * 1e3, "predicted_ms_by_kind": by_kind,
                "err_pct": 100 * abs(total - graph_s) / graph_s,
                "top5_predicted": [[r.name, r.kernel, r.seconds * 1e3]
                                   for r in top],
                "eager_trace": eager_trace, "graph_trace": graph_trace})
    return rec


def phase_serve(store):
    """The ``serve`` launcher's engine (SERVE_ARGS): 16 requests of 512
    tokens, 32 new each, in two waves of 8, greedy, bf16.  Fails unless
    every request ends with 32 tokens, 512 come out, the flash kernel
    launched once a layer a wave and every served token equals the eager
    steps' (``check_served``, run after the path's launch counts are read;
    they are returned with the record).  Prices the prompt as the JAX
    package does (``predict_model`` at (8, 512)) and the decode steps over
    the contexts they ran at (513-543)."""
    args = serve_launcher.parse_args(SERVE_ARGS)
    cfg = dataclasses.replace(cfg_registry.get(MODEL),
                              compute_dtype=args.compute_dtype)
    engine, done = serve_launcher.serve(args)
    launches = hand_launches()
    flash = launches["flash_attention"]
    out = serve_launcher.summary(engine, done)
    served = check_served(engine, done)
    pm = PM2Lat(store, store.meta["device"])
    dt = args.compute_dtype
    prefill_s, _ = pm.predict_model(cfg, args.max_batch, args.prompt_len,
                                    dtype=dt)
    ctxs = range(args.prompt_len + 1, args.prompt_len + args.max_new)
    step_s = float(np.mean([pm.predict_ops(og.enumerate_decode_ops(
        cfg, args.max_batch, c, dtype=dt))[0] for c in ctxs]))
    waves = [done[i:i + args.max_batch]
             for i in range(0, len(done), args.max_batch)]
    st = engine.stats
    rec = {**out, "requests": len(done), "prefills": st.prefills,
           "out_tokens_each": sorted({len(r.out_tokens) for r in done}),
           "ttft_p50_ms": st.ttft_p50 * 1e3, "ttft_p95_ms": st.ttft_p95 * 1e3,
           "tpot_p50_ms": st.tpot_p50 * 1e3, "tpot_p95_ms": st.tpot_p95 * 1e3,
           "wave_ttft_ms": [(w[0].t_first_token - w[0].t_submit) * 1e3
                            for w in waves],
           "wave_tpot_ms": [float(np.mean([(r.t_done - r.t_first_token)
                                           / (len(r.out_tokens) - 1)
                                           for r in w])) * 1e3 for w in waves],
           "flash_launches": flash, "served_vs_eager": served,
           "predicted_prefill_ms": prefill_s * 1e3,
           "predicted_decode_step_ms": step_s * 1e3,
           "predicted_decode_ctx": [ctxs.start, ctxs.stop - 1],
           "wall_s": engine.wall_s}
    emit("serve", **rec)
    want_flash = cfg.n_layers * len(waves)
    if (rec["out_tokens_each"] != [args.max_new]
            or st.tokens_out != args.requests * args.max_new
            or flash != want_flash or served["mismatched"]):
        raise AssertionError(f"serve: tokens each {rec['out_tokens_each']}, "
                             f"out {st.tokens_out}, flash launches {flash} "
                             f"(expected {want_flash}), requests unlike the "
                             f"eager steps {served['mismatched']}")
    return rec, launches


def check_served(engine, done, waves=None):
    """What the engine served (its CUDA graphs, reloaded for the second
    wave, and its argmax on the card) against an eager ``prefill`` and
    ``decode_step`` of each wave's prompts, greedy, on the card, over the
    wave's context where the model takes one (``make_ctx``, as the engine
    draws it): the rids whose tokens differ, and each one's first differing
    step.  ``waves``
    gives the wave sizes the engine seated (default: ``max_batch`` each)."""
    model, vocab = engine.model, engine.model.cfg.vocab_size
    if waves is None:
        waves = [engine.max_batch] * -(-len(done) // engine.max_batch)
    mismatched = {}
    start = 0
    with torch.no_grad():
        for size in waves:
            wave = done[start:start + size]
            start += size
            if len({len(r.prompt) for r in wave}) != 1:
                raise AssertionError("check_served needs one prompt length "
                                     "a wave (no left padding)")
            toks = torch.from_numpy(np.stack([r.prompt for r in wave]))
            logits, cache = model.prefill(
                toks.long().cuda(), ctx_embed=model.make_ctx(len(wave)),
                max_len=engine.max_len)
            nxt = logits[:, :vocab].argmax(-1)
            out = [nxt]
            for _ in range(wave[0].max_new_tokens - 1):
                logits, _ = model.decode_step(nxt, cache)
                nxt = logits[:, :vocab].argmax(-1)
                out.append(nxt)
            want = torch.stack(out, 1).cpu().numpy()
            for r, w in zip(wave, want):
                diff = np.flatnonzero(np.asarray(r.out_tokens) != w)
                if diff.size:
                    mismatched[r.rid] = int(diff[0])
    return {"requests": len(done), "mismatched": mismatched}


def phase_grid(store):
    """The batch engine on the card's store (qwen2-0.5b, float32 and bf16).
    Fails unless the engine's prefill and decode grids equal the scalar
    predictor within GRID_RTOL, every measured forward gives finite logits
    with one flash launch a layer, the identity transfer reproduces the
    store, ``for_device`` of the store's device is the engine itself, and a
    ``PredictionCache`` comes back from its JSON file equal, every measured
    decode step passes DECODE_CHECKS, and the engine's re-anchored
    ``h100_sxm`` prediction equals the scalar predictor's.  Reports the
    engine's and the NAS precompute's speed, the error across the grid
    against forwards and CUDA-graph decode steps measured on the card, the
    NAS sample's error against ``torch.matmul`` and the fleet."""
    dev = store.meta["device"]
    cfg0 = cfg_registry.get(MODEL)
    engines, agree = {}, []
    for dname in DTYPES:
        bp, row, grids = grid_agreement(store, dev, dataclasses.replace(
            cfg0, compute_dtype=dname))
        engines[dname] = (bp, grids)
        agree.append(row)
        emit("grid_agreement", **row)
    bad = [r for r in agree if not r["ok"]]
    if bad:
        raise AssertionError(f"engine against the scalar predictor: {bad}")
    prefill, decode = grid_measure(cfg0, engines)
    speed, nas_vals = engine_speed(cfg0, engines, dev, store)
    nas = {d: nas_vs_card(nas_vals[d], d) for d in DTYPES}
    fleet = grid_fleet(cfg0, engines, store, dev, prefill)
    summary = {}
    for d in DTYPES:
        for name, rows in (("prefill", prefill), ("decode", decode)):
            err = [r["err_pct"] for r in rows if r["dtype"] == d]
            summary.setdefault(d, {}).update({
                f"{name}_mean_err_pct": float(np.mean(err)),
                f"{name}_max_err_pct": float(np.max(err))})
    emit("grid_summary", **summary)
    return {"agreement": agree, "prefill": prefill, "decode": decode,
            "speed": speed, "nas": nas, "fleet": fleet, "summary": summary}


def grid_agreement(store, dev, cfg):
    """One dtype: the engine's grids (a fresh engine with no feature rows,
    timed cold and warm) against ``PM2Lat`` point by point, prefill as
    ``predict_model`` and decode as ``phase_decode`` prices a step."""
    dname = cfg.compute_dtype
    og._snippet_features.cache_clear()
    bp = BatchPredictor(store, dev)
    t0 = time.perf_counter()
    grid = bp.predict_model_grid(cfg, GRID_BATCHES, GRID_SEQS, dname)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = bp.predict_model_grid(cfg, GRID_BATCHES, GRID_SEQS, dname)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    dgrid = bp.predict_decode_grid(cfg, GRID_DECODE_BATCHES, GRID_CTXS, dname)
    dtime = time.perf_counter() - t0
    pm = PM2Lat(store, dev)
    t0 = time.perf_counter()
    want = np.array([[pm.predict_model(cfg, b, s, dtype=dname)[0]
                      for s in GRID_SEQS] for b in GRID_BATCHES])
    scalar_s = time.perf_counter() - t0
    dwant = np.array([[pm.predict_ops(og.enumerate_decode_ops(
        cfg, b, c, dtype=dname))[0] for c in GRID_CTXS]
        for b in GRID_DECODE_BATCHES])
    rel = float(np.max(np.abs(grid - want) / want))
    drel = float(np.max(np.abs(dgrid - dwant) / dwant))
    n = grid.size
    row = {"dtype": dname, "batches": GRID_BATCHES, "seqs": GRID_SEQS,
           "max_rel_diff": rel, "decode_batches": GRID_DECODE_BATCHES,
           "ctxs": GRID_CTXS, "decode_max_rel_diff": drel,
           "rtol": GRID_RTOL, "warm_equals_cold": bool(np.array_equal(grid,
                                                                      again)),
           "ok": rel <= GRID_RTOL and drel <= GRID_RTOL
           and bool(np.array_equal(grid, again)),
           "grid_ms": (grid * 1e3).tolist(),
           "decode_grid_ms": (dgrid * 1e3).tolist(),
           "cold_points_per_s": n / cold, "warm_points_per_s": n / warm,
           "decode_points_per_s": dgrid.size / dtime,
           "scalar_points_per_s": n / scalar_s}
    return bp, row, (grid, dgrid)


def grid_measure(cfg0, engines):
    """qwen2-0.5b with random weights (seed 0) measured at GRID_MEASURED
    (``profiler.measure`` of the forward) and GRID_DECODE_MEASURED (the
    CUDA-graph decode step of ``decode_check``, which also holds the step
    to DECODE_CHECKS as ``phase_decode`` does), beside the engine's grids."""
    model = model_registry.build(dataclasses.replace(
        cfg0, compute_dtype="float32"), device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    prefill, decode = [], []
    for dname in DTYPES:
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        model.cfg = cfg
        if dname == "bfloat16":
            cast_weights_(model, torch.bfloat16)
        grid, dgrid = engines[dname][1]
        for b, s in GRID_MEASURED:
            tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                   device="cuda")
            with torch.no_grad():
                before = fk.flash_attention_kernel.launches
                logits = model(tokens)
                torch.cuda.synchronize()
                flash = fk.flash_attention_kernel.launches - before
                finite = bool(torch.isfinite(logits).all())
                shape = list(logits.shape)
                del logits
                meas = profiler.measure(model, tokens)
            pred = float(grid[GRID_BATCHES.index(b), GRID_SEQS.index(s)])
            row = {"dtype": dname, "batch": b, "seq": s, "tokens": b * s,
                   "predicted_ms": pred * 1e3, "measured_ms": meas * 1e3,
                   "err_pct": 100 * abs(pred - meas) / meas,
                   "flash_launches": flash, "logits_finite": finite}
            emit("grid_prefill", **row)
            prefill.append(row)
            if (not finite or flash != cfg.n_layers
                    or shape != [b, s, model.padded_vocab]):
                raise AssertionError(f"grid forward {dname} {(b, s)}: logits "
                                     f"{shape} finite={finite}, {flash} "
                                     f"flash launches")
        for b, ctx in GRID_DECODE_MEASURED:
            tokens = torch.randint(0, cfg.vocab_size, (b, ctx), generator=gen,
                                   device="cuda")
            with torch.no_grad():
                rec = decode_check(model, cfg, tokens)[0]
            torch.cuda.empty_cache()
            pred = float(dgrid[GRID_DECODE_BATCHES.index(b),
                               GRID_CTXS.index(ctx)])
            meas = rec["graph_ms"] / 1e3
            rec.update({"predicted_ms": pred * 1e3,
                        "err_pct": 100 * abs(pred - meas) / meas})
            emit("grid_decode", **rec)
            decode.append(rec)
            bad = decode_failures(rec)
            if bad:
                raise AssertionError(f"grid decode {dname} {(b, ctx)}: "
                                     f"failed {bad}")
    del model
    torch.cuda.empty_cache()
    return prefill, decode


def engine_speed(cfg0, engines, dev, store):
    """``predict_model_cached`` miss against hit, a ``PredictionCache``
    round trip through a JSON file under ``chiprun_out/`` (fails unless
    every value comes back equal), and ``precompute_cache`` at the
    reference defaults over the whole NAS grid (its arrays are returned)."""
    path = OUT / "grid_prediction_cache.json"
    if path.exists():
        path.unlink()
    cache = PredictionCache(path=str(path))
    miss, hit, keys = [], [], []
    for dname in DTYPES:
        bp = engines[dname][0]
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        for b in GRID_BATCHES:
            for s in GRID_SEQS:
                t0 = time.perf_counter()
                v = bp.predict_model_cached(cfg, b, s, dtype=dname,
                                            cache=cache)
                t1 = time.perf_counter()
                w = bp.predict_model_cached(cfg, b, s, dtype=dname,
                                            cache=cache)
                t2 = time.perf_counter()
                miss.append(t1 - t0)
                hit.append(t2 - t1)
                if v != w:
                    raise AssertionError(f"cache hit {w} != miss {v}")
                keys.append((PredictionCache.make_key(
                    config_key(cfg), bp.cache_device, dname, b, s), v))
    cache.save()
    back = PredictionCache(path=str(path))
    round_trip = len(back) == len(keys) and all(back.get(k) == v
                                                for k, v in keys)
    out = {"cached_miss_us": 1e6 * float(np.mean(miss)),
           "cached_hit_us": 1e6 * float(np.mean(hit)),
           "cache_entries": len(keys), "cache_round_trip_equal": round_trip,
           "cache_file": str(path.relative_to(ROOT))}
    nas_vals = {}
    for dname in DTYPES:
        vals, secs, us, n = precompute_cache(store, dev, dtype=dname,
                                             predictor=engines[dname][0])
        out[f"nas_{dname}"] = {"n_predictions": n, "seconds": secs,
                               "us_per_prediction": us,
                               "paper_us_per_prediction":
                                   PAPER_US_PER_PREDICTION,
                               "finite": bool(np.isfinite(vals).all())}
        nas_vals[dname] = vals
    emit("grid_speed", **out)
    if not round_trip:
        raise AssertionError("the prediction cache did not come back equal "
                             "from its JSON file")
    return out, nas_vals


def spearman(a, b) -> float:
    """Spearman rank correlation (ties broken by position)."""
    rank = lambda x: np.argsort(np.argsort(x, kind="stable"), kind="stable")
    return float(np.corrcoef(rank(a), rank(b))[0, 1])


def nas_vs_card(vals, dname):
    """NAS_POINTS entries of ``precompute_cache``'s array ``vals``, spread
    over its sorted predictions among those whose largest operand is at
    most NAS_MAX_OPERAND bytes, each timed as ``torch.matmul`` (the cuBLAS
    call whose ``cublas@*`` table priced it) in ``dname``: median and p90
    of the error, and the Spearman rank correlation (NAS ranks by them)."""
    grid = NASGrid()
    f = np.asarray(grid.features, np.int64)
    rows = (np.asarray(grid.batches, np.int64)[:, None]
            * np.asarray(grid.seq_lens, np.int64)[None, :]).reshape(-1)
    nf, nm = len(f), len(rows)
    if vals.size != nf * nf * nm:       # the default limit takes every row
        raise AssertionError(f"NAS cache of {vals.size} != {nf * nf * nm}")
    idx = np.arange(vals.size)
    M, N, K = rows[idx % nm], f[(idx // nm) % nf], f[idx // (nf * nm)]
    esz = torch.finfo(getattr(torch, dname)).bits // 8
    largest = np.maximum(np.maximum(M * K, K * N), M * N) * esz
    ok = np.flatnonzero(largest <= NAS_MAX_OPERAND)
    order = ok[np.argsort(vals[ok], kind="stable")]
    pick = order[np.linspace(0, order.size - 1, NAS_POINTS).round()
                 .astype(np.int64)]
    dt = getattr(torch, dname)
    pred, meas, points = [], [], []
    for i in pick:
        m, n, k = int(M[i]), int(N[i]), int(K[i])
        a = torch.randn(m, k, device="cuda", dtype=dt)
        b = torch.randn(k, n, device="cuda", dtype=dt)
        t = profiler.measure(torch.matmul, a, b)
        del a, b
        pred.append(float(vals[i]))
        meas.append(t)
        points.append([m, n, k, float(vals[i]) * 1e3, t * 1e3])
    pred, meas = np.array(pred), np.array(meas)
    err = 100 * np.abs(pred - meas) / meas
    rho = spearman(pred, meas)
    out = {"dtype": dname, "points": NAS_POINTS,
           "max_operand_bytes": NAS_MAX_OPERAND,
           "median_err_pct": float(np.median(err)),
           "p90_err_pct": float(np.percentile(err, 90)),
           "spearman_rho": rho,
           "mnk_predicted_ms_measured_ms": points}
    emit("grid_nas", **out)
    return out


def grid_fleet(cfg0, engines, store, dev, prefill):
    """``for_device`` of the store's own device is the engine, and the
    identity transfer reproduces every table and the memory model (both
    structural: early returns of ``for_device`` and ``transfer_table``),
    and the engine's prediction on the store re-anchored to the datasheet
    ``h100_sxm`` equals ``PM2Lat`` on that store within GRID_RTOL (fails
    otherwise); qwen2-0.5b (8, 512) predicted on every FLEET device from
    this store, and the same-chip transfer: the ``h100_sxm`` prediction
    against the forward measured here."""
    bp = engines["float32"][0]
    host = bp.host_profile()
    ident = transfer_store(store, host, host)
    exact = (sorted(ident.tables) == sorted(store.tables)
             and all(ident.tables[k] == t for k, t in store.tables.items())
             and ident.memory_model == store.memory_model)
    itself = bp.for_device(dev) is bp and bp.for_device(None) is bp
    b, s = BATCH, SEQ
    fleet = {}
    for name in [dev] + [p.name for p in FLEET]:
        fleet[name] = {d: engines[d][0].predict_model(
            cfg0, b, s, dtype=d, device=name)[0] * 1e3 for d in DTYPES}
    # the engine's re-anchored answer against the scalar predictor on a
    # store transferred apart from the engine's fleet
    scalar = PM2Lat(transfer_store(store, host, H100_SXM), H100_SXM.name)
    same_chip, worst = {}, 0.0
    for d in DTYPES:
        meas = next(r["measured_ms"] for r in prefill
                    if r["dtype"] == d and (r["batch"], r["seq"]) == (b, s))
        pred = fleet["h100_sxm"][d]
        want = scalar.predict_model(cfg0, b, s, dtype=d)[0] * 1e3
        worst = max(worst, abs(pred - want) / want)
        same_chip[d] = {"predicted_ms": pred, "measured_ms": meas,
                        "err_pct": 100 * abs(pred - meas) / meas,
                        "host_predicted_ms": fleet[dev][d],
                        "scalar_predicted_ms": want}
    out = {"identity_transfer_exact": exact, "for_device_is_engine": itself,
           "transfer_engine_vs_scalar_max_rel_diff": worst,
           "host_profile": dataclasses.asdict(host),
           "predicted_ms_8x512": fleet, "same_chip_transfer": same_chip}
    emit("grid_fleet", **out)
    if not (exact and itself and worst <= GRID_RTOL):
        raise AssertionError(f"fleet: identity transfer exact={exact}, "
                             f"for_device is the engine={itself}, engine "
                             f"against scalar on h100_sxm {worst}")
    return out


def phase_schedule(store, serve_rec):
    """The schedule layer on the card's store (qwen2-0.5b, float32 and
    bf16).  Fails unless a trivial spec prices as ``predict_model``
    (SCHED_TRIVIAL_RTOL), the engine equals ``PM2Lat`` on SCHED_SPECS, the
    sweep equals the per-spec loop over SCHED_GRID forward and training,
    the decode grid under a spec equals its scalar loop (SCHED_RTOL), the
    serving simulators agree (``schedule_serving_agree``), and every
    measured forward, stage and served request passes its check.  Reports,
    with no limit: (a) the microbatch axis, predicted by the sweep and
    measured as sequential chunks; (b) the planned pipeline stages,
    predicted and timed alone; (c) the serve launcher at capacity 1 against
    the simulator on the engine's ``serving_tables``; (d) the simulator on
    phase ``serve``'s mix beside that phase's numbers; (e) the sweep's best
    spec on 8 and 64 devices with its peak memory (predictions only)."""
    dev = store.meta["device"]
    cfg0 = cfg_registry.get(MODEL)
    engines = {d: (PM2Lat(store, dev), BatchPredictor(store, dev))
               for d in DTYPES}
    agree = []
    for d in DTYPES:
        row = schedule_agreement(store, dataclasses.replace(
            cfg0, compute_dtype=d), *engines[d])
        emit("schedule_agreement", **row)
        agree.append(row)
    bad = [(r["dtype"], k) for r in agree for k, ok in r["checks"].items()
           if not ok]
    if bad:
        raise AssertionError(f"schedule layer against its references: "
                             f"failed {bad}")
    microbatch, stages = schedule_measure(cfg0, engines)
    serve1 = schedule_serve(engines["bfloat16"][1], cfg0)
    mix8 = schedule_serve_mix(engines["bfloat16"][1], cfg0, serve_rec)
    best = schedule_best(cfg0, engines, store)
    return {"agreement": agree, "microbatch": microbatch, "stages": stages,
            "serve_capacity1": serve1, "serve_mix": mix8, "best": best}


def rel_diff(got, want) -> float:
    """Max |got - want| / |want|; where ``want`` is 0, 0 if ``got`` is too
    and infinite otherwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    return float(np.max(np.divide(d, np.abs(want),
                                  out=np.where(d > 0, np.inf, 0.0),
                                  where=want != 0)))


def sweep_vs_loop(sw, loop):
    """Max relative difference of the sweep's makespan and work splits to
    the per-spec ``Schedule``s, and whether exposed comm and bubble share
    agree within 1e-6 relative + 1e-12 absolute."""
    want = {"seconds": [x.makespan for x in loop],
            "compute_seconds": [x.compute_seconds for x in loop],
            "comm_seconds": [x.comm_seconds for x in loop],
            "sequential_seconds": [x.sequential_seconds for x in loop],
            "max_stream_busy": [max(x.busy().values()) for x in loop]}
    rel = max(rel_diff(getattr(sw, k), v) for k, v in want.items())
    split = all(np.allclose(getattr(sw, k), [getattr(x, k) for x in loop],
                            rtol=1e-6, atol=1e-12)
                for k in ("exposed_comm_seconds", "bubble_share"))
    return rel, split


def schedule_agreement(store, cfg, pm, bp):
    """One dtype: the scalar and engine entry points, the sweep against the
    loop, the decode grid under a spec and the serving simulators."""
    dname = cfg.compute_dtype
    total, rows = pm.predict_model(cfg, BATCH, SEQ, dtype=dname)
    mk, srows = pm.predict_parallel(cfg, BATCH, SEQ, og.ParallelismSpec(),
                                    dtype=dname)
    trivial = abs(mk - total) / total
    fixed = []
    for kw in SCHED_SPECS:
        spec = og.ParallelismSpec(**kw)
        row = {"spec": spec.tag()}
        for fn in ("predict_parallel", "predict_step"):
            want = getattr(pm, fn)(cfg, BATCH, SEQ, spec, dtype=dname)[0]
            got = getattr(bp, fn)(cfg, BATCH, SEQ, spec, dtype=dname)[0]
            row[f"{fn}_ms"] = got * 1e3
            row[f"{fn}_rel_diff"] = abs(got - want) / want
        fixed.append(row)
    engine_rel = max(v for r in fixed for k, v in r.items()
                     if k.endswith("_rel_diff"))
    specs = sched.strategy_grid(**SCHED_GRID)
    sweeps = {}
    for label, train in (("forward", None),
                         ("train", sched.TrainingStepSpec())):
        t0 = time.perf_counter()
        sw = bp.sweep_strategies(cfg, BATCH, SEQ, specs, train=train,
                                 dtype=dname,
                                 hbm_bytes=store.meta["hbm_bytes"])
        t1 = time.perf_counter()
        loop = [bp.schedule_parallel(cfg, BATCH, SEQ, sp, dtype=dname)
                if train is None else
                bp.schedule_step(cfg, BATCH, SEQ, sp, train, dtype=dname)
                for sp in specs]
        t2 = time.perf_counter()
        rel, split = sweep_vs_loop(sw, loop)
        sweeps[label] = {"specs": len(specs),
                         "n_feasible": int(sw.feasible.sum()),
                         "max_rel_diff": rel, "splits_agree": split,
                         "bounds_ok": bool(sw.bounds_ok().all()),
                         "sweep_s": t1 - t0, "loop_s": t2 - t1,
                         "best": sw.row(sw.best())}
    dspec = og.ParallelismSpec(**SCHED_DECODE["spec"])
    bs, cs = SCHED_DECODE["batches"], SCHED_DECODE["ctxs"]
    dgrid = bp.predict_decode_grid(cfg, bs, cs, dtype=dname, spec=dspec)
    dwant = np.array([[pm.predict_ops(og.enumerate_decode_parallel_ops(
        cfg, b, c, dspec, dtype=dname))[0] for c in cs] for b in bs])
    drel = rel_diff(dgrid, dwant)
    serving = schedule_serving_agree(bp, cfg)
    checks = {"trivial_spec": trivial <= SCHED_TRIVIAL_RTOL
              and [r.seconds for r in srows] == [r.seconds for r in rows],
              "engine_vs_scalar": engine_rel <= SCHED_RTOL,
              "decode_grid_spec": drel <= SCHED_RTOL,
              **{f"sweep_{k}": v["max_rel_diff"] <= SCHED_RTOL
                 and v["splits_agree"] and v["bounds_ok"]
                 for k, v in sweeps.items()},
              **serving["checks"]}
    return {"dtype": dname, "checks": checks,
            "trivial_rel_diff": trivial,
            "trivial_ms": [mk * 1e3, total * 1e3],
            "engine_vs_scalar_max_rel_diff": engine_rel, "fixed": fixed,
            "sweeps": sweeps, "decode_spec": dspec.tag(),
            "decode_grid_max_rel_diff": drel,
            "decode_grid_ms": (dgrid * 1e3).tolist(), "serving": serving}


def schedule_serving_agree(bp, cfg):
    """On the engine's ``serving_tables`` for three mixes (phase
    ``serve``'s, the capacity-1 serve's, and Poisson arrivals of two
    prompt lengths): ``simulate_serving`` against the token-by-token
    ``simulate_serving_steps`` (every time field bit for bit; occupancy,
    whose additions run per run against per step, 1e-9 relative), and
    ``simulate_serving_batch`` over SCHED_CAPACITIES against the scalar
    calls (every field bit for bit)."""
    dname = cfg.compute_dtype
    mixes = [sched.TrafficMix((SEQ,), (32,), n_requests=16),
             sched.TrafficMix((SEQ,), (32,), n_requests=4),
             sched.TrafficMix((128, SEQ), (8, 32), arrival_rate=50.0,
                              n_requests=32)]
    steps_ok = batch_ok = True
    occ_bitwise = True
    cap = max(SCHED_CAPACITIES)
    for mix in mixes:
        tab = bp.serving_tables(cfg, mix, capacity=cap, dtype=dname)
        scalar = [sched.simulate_serving(mix, c, tab.prefill, tab.decode)
                  for c in SCHED_CAPACITIES]
        for c, fast in zip(SCHED_CAPACITIES, scalar):
            slow = sched.simulate_serving_steps(mix, c, tab.prefill,
                                                tab.decode)
            for f in sched.ServingStats.FIELDS:
                a, b = getattr(fast, f), getattr(slow, f)
                if f == "occupancy":
                    steps_ok &= bool(np.isclose(a, b, rtol=1e-9, atol=0))
                    occ_bitwise &= a == b
                else:
                    steps_ok &= a == b
        batch = sched.simulate_serving_batch(mix, SCHED_CAPACITIES,
                                             [tab] * len(SCHED_CAPACITIES))
        batch_ok &= batch == scalar
    return {"mixes": [m.tag() for m in mixes],
            "occupancy_bitwise": bool(occ_bitwise),
            "checks": {"serving_event_vs_steps": bool(steps_ok),
                       "serving_batch_vs_scalar": bool(batch_ok)}}


def schedule_measure(cfg0, engines):
    """qwen2-0.5b with random weights (seed 0), float32 then bf16: (a) B 8
    x S 512 as mb sequential forwards of 8 / mb, against the sweep's
    ``ParallelismSpec(microbatches=mb)``; (b) each stage of the plan
    ``plan_stages_model`` makes for SCHED_STAGES stages (SCHED_PLAN_MB
    microbatches), its blocks driven alone on a random (8, 512, d) hidden
    state with RoPE factors for positions 0..511, against the stage's
    predicted blocks (``predict_blocks`` strips embed, final norm and
    unembed, and so does the timing).  Fails unless every forward gives
    finite logits of the right shape with one flash launch a layer, and
    every stage finite output with one a block."""
    model = model_registry.build(dataclasses.replace(
        cfg0, compute_dtype="float32"), device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg0.vocab_size, (BATCH, SEQ), generator=gen,
                           device="cuda")
    hidden = torch.randn(BATCH, SEQ, cfg0.d_model, generator=gen,
                         device="cuda")
    rope = attn.rope_tables(torch.arange(SEQ, device="cuda")[None, :],
                            cfg0.head_dim, cfg0.rope_theta)
    microbatch, stages = [], []
    for dname in DTYPES:
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        cdt = getattr(torch, dname)
        model.cfg = cfg
        if dname == "bfloat16":
            cast_weights_(model, torch.bfloat16)
        pm, bp = engines[dname]
        sw = bp.sweep_strategies(cfg, BATCH, SEQ, [
            og.ParallelismSpec(microbatches=m) for m in SCHED_MB],
            dtype=dname)
        rows = []
        with torch.no_grad():
            for m, pred in zip(SCHED_MB, sw.seconds):
                chunks = tokens.chunk(m)

                def run(chunks=chunks):
                    for c in chunks:
                        model(c)

                before = fk.flash_attention_kernel.launches
                outs = [model(c) for c in chunks]
                torch.cuda.synchronize()
                flash = fk.flash_attention_kernel.launches - before
                ok = (all(bool(torch.isfinite(o).all()) for o in outs)
                      and [list(o.shape) for o in outs]
                      == [[BATCH // m, SEQ, model.padded_vocab]] * m
                      and flash == cfg.n_layers * m)
                del outs
                meas = profiler.measure(run)
                rows.append({"dtype": dname, "microbatches": m,
                             "chunk": [BATCH // m, SEQ],
                             "predicted_ms": float(pred) * 1e3,
                             "measured_ms": meas * 1e3,
                             "err_pct": 100 * abs(pred - meas) / meas,
                             "flash_launches": flash, "ok": ok})
                if not ok:
                    raise AssertionError(f"microbatch forward {rows[-1]}")
            x = hidden.to(cdt)
            for n in SCHED_STAGES:
                stages.append(stage_record(model, pm, cfg, cdt, x, rope, n))
                emit("schedule_stages", **stages[-1])
        rec = {"dtype": dname, "rows": rows,
               "spearman_rho": spearman([r["predicted_ms"] for r in rows],
                                        [r["measured_ms"] for r in rows])}
        emit("schedule_microbatch", **rec)
        microbatch.append(rec)
    del model
    torch.cuda.empty_cache()
    return microbatch, stages


def stage_record(model, pm, cfg, cdt, x, rope, n_stages):
    """One ``plan_stages_model`` plan, each stage's blocks timed alone."""
    dname = cfg.compute_dtype
    plan, blocks = partition.plan_stages_model(
        pm, cfg, BATCH, SEQ, n_stages=n_stages, microbatches=SCHED_PLAN_MB,
        dtype=dname)
    rows = []
    for i, (a, b) in enumerate(zip(plan.boundaries, plan.boundaries[1:])):
        def run(a=a, b=b):
            y = x
            for blk in model.blocks[a:b]:
                y, _ = blk(y, cfg, cdt, rope)
            return y

        before = fk.flash_attention_kernel.launches
        y = run()
        torch.cuda.synchronize()
        flash = fk.flash_attention_kernel.launches - before
        ok = (bool(torch.isfinite(y).all()) and list(y.shape) == list(x.shape)
              and flash == b - a)
        del y
        if not ok:
            raise AssertionError(f"stage {i} of {n_stages} ({a}, {b}) "
                                 f"{dname}: {flash} flash launches")
        meas = profiler.measure(run) if b > a else 0.0
        pure = sum(blocks[a:b])
        rows.append({"blocks": [a, b], "predicted_ms": plan.stage_times[i]
                     * 1e3, "predicted_blocks_ms": pure * 1e3,
                     "measured_ms": meas * 1e3,
                     "err_pct": 100 * abs(pure - meas) / meas if meas else None})
    ratio = lambda v: max(v) / min(v)
    live = [r for r in rows if r["blocks"][1] > r["blocks"][0]]
    return {"dtype": dname, "n_stages": n_stages,
            "microbatches": SCHED_PLAN_MB, "boundaries": plan.boundaries,
            "bottleneck_ms": plan.bottleneck * 1e3,
            "makespan_ms": plan.makespan * 1e3, "stages": rows,
            "measured_max_min": ratio([r["measured_ms"] for r in live]),
            "predicted_blocks_max_min": ratio(
                [r["predicted_blocks_ms"] for r in live]),
            "predicted_max_min": ratio([r["predicted_ms"] for r in live])}


def schedule_serve(bp, cfg0):
    """The serve launcher at capacity 1 (SERVE1_ARGS), then the same engine
    (its decode graph captured) over fresh prompts, timed from the second
    run's request timestamps; against ``simulate_serving`` on the engine's
    ``serving_tables`` for the same mix.  Both schedule one prefill and
    then max_new - 1 decode steps, request after request, every request
    submitted at 0.  Fails unless every request of both runs ends with
    max_new tokens and the flash kernel launched once a layer a prefill."""
    args = serve_launcher.parse_args(SERVE1_ARGS)
    cfg = dataclasses.replace(cfg0, compute_dtype=args.compute_dtype)
    before = fk.flash_attention_kernel.launches
    engine, first = serve_launcher.serve(args)
    rng = np.random.default_rng(args.seed + 1)
    reqs = [Request(rid=args.requests + i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for i in range(args.requests)]
    done = engine.run(reqs)
    flash = fk.flash_attention_kernel.launches - before
    wall = engine.wall_s
    del engine
    torch.cuda.empty_cache()
    t0 = min(r.t_submit for r in done)
    ttft = np.array([r.t_first_token - r.t_submit for r in done])
    tpot = np.array([(r.t_done - r.t_first_token) / (len(r.out_tokens) - 1)
                     for r in done])
    ends = [t0] + [r.t_done for r in done]
    prefill = np.array([r.t_first_token - e for r, e in zip(done, ends)])
    makespan = max(r.t_done for r in done) - t0
    tokens = sum(len(r.out_tokens) for r in done)
    mix = sched.TrafficMix((args.prompt_len,), (args.max_new,),
                           n_requests=args.requests)
    tab = bp.serving_tables(cfg, mix, capacity=args.max_batch,
                            dtype=args.compute_dtype)
    st, det = sched.simulate_serving(mix, args.max_batch, tab.prefill,
                                     tab.decode, return_detail=True)
    pct = lambda v, q: float(np.percentile(v, q)) * 1e3
    err = lambda p, m: 100 * abs(p - m) / m
    meas = {"ttft_ms": (ttft * 1e3).tolist(),
            "ttft_p50_ms": pct(ttft, 50), "ttft_p95_ms": pct(ttft, 95),
            "tpot_p50_ms": pct(tpot, 50), "tpot_p95_ms": pct(tpot, 95),
            "prefill_ms": (prefill * 1e3).tolist(),
            "makespan_ms": makespan * 1e3, "tokens_per_s": tokens / makespan}
    pred = {"ttft_ms": (det["ttft"] * 1e3).tolist(),
            "ttft_p50_ms": st.ttft_p50 * 1e3, "ttft_p95_ms": st.ttft_p95 * 1e3,
            "tpot_p50_ms": st.tpot_p50 * 1e3, "tpot_p95_ms": st.tpot_p95 * 1e3,
            "prefill_ms": tab.prefill[args.prompt_len] * 1e3,
            "makespan_ms": st.makespan * 1e3,
            "tokens_per_s": st.tokens_per_sec}
    rec = {"args": SERVE1_ARGS, "mix": mix.tag(), "measured": meas,
           "predicted": pred,
           "err_pct": {k: err(pred[k], meas[k]) for k in
                       ("ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms",
                        "tpot_p95_ms", "makespan_ms", "tokens_per_s")},
           "flash_launches": flash, "wall_s": wall}
    emit("schedule_serve", **rec)
    counts = sorted({len(r.out_tokens) for r in first + done})
    want = cfg.n_layers * 2 * args.requests
    if counts != [args.max_new] or flash != want:
        raise AssertionError(f"capacity-1 serve: tokens each {counts}, "
                             f"flash launches {flash} (expected {want})")
    return rec


def schedule_serve_mix(bp, cfg0, serve_rec):
    """The simulator on phase ``serve``'s mix (16 x 512, 32 new, capacity
    8, bf16) beside that phase's measured numbers.  A different schedule:
    the engine prefills a wave of 8 at once and decodes it in lockstep, the
    simulator prefills one slot at a time (its TPOT carries the other
    slots' prefills); only TPOT is like for like, and the engine's first
    wave also carries the decode graph's capture, so its last wave's TPOT
    is the steady one."""
    args = serve_launcher.parse_args(SERVE_ARGS)
    cfg = dataclasses.replace(cfg0, compute_dtype=args.compute_dtype)
    mix = sched.TrafficMix((args.prompt_len,), (args.max_new,),
                           n_requests=args.requests)
    tab = bp.serving_tables(cfg, mix, capacity=args.max_batch,
                            dtype=args.compute_dtype)
    st = sched.simulate_serving(mix, args.max_batch, tab.prefill, tab.decode)
    rec = {"schedule": "simulator: one prefill a slot; engine: a wave of "
                       "8 prefilled at once", "like_for_like": "tpot",
           "simulated": {k: v * 1e3 if k.startswith(("ttft", "tpot",
                                                     "latency", "makespan"))
                         else v for k, v in st.to_entry().items()},
           "serve_phase": {k: serve_rec[k] for k in
                           ("ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms",
                            "tpot_p95_ms", "throughput_tok_s")},
           "serve_phase_steady_tpot_ms": serve_rec["wave_tpot_ms"][-1]}
    for name, meas in (("tpot_p50", serve_rec["tpot_p50_ms"]),
                       ("steady_tpot", rec["serve_phase_steady_tpot_ms"])):
        rec[f"{name}_err_pct"] = 100 * abs(st.tpot_p50 * 1e3 - meas) / meas
    emit("schedule_serve_mix", **rec)
    return rec


def schedule_best(cfg0, engines, store):
    """Predictions one card cannot check: the sweep's fastest feasible
    forward spec at (8, 512) using all of 8 and of 64 devices, with its
    peak memory (``peak_memory_bytes``, equal to the sweep's column), on
    the card's store (whose device name has no registered interconnect, so
    collectives are priced over ``DEFAULT_INTERCONNECT``) and re-anchored
    to the datasheet ``h100_sxm`` (NVLink)."""
    out = []
    for world in SCHED_WORLDS:
        specs = [s for s in sched.strategy_grid(
            dp=(1, 2, 4, 8), tp=(1, 2, 4, 8), pp=(1, 2, 4, 8),
            microbatches=(1, 2, 4, 8), act_modes=("tp", "sp"),
            schedules=og.SCHEDULE_KINDS, max_world=world)
            if s.world == world]
        for dname in DTYPES:
            cfg = dataclasses.replace(cfg0, compute_dtype=dname)
            for device in (store.meta["device"], H100_SXM.name):
                sw = engines[dname][1].sweep_strategies(
                    cfg, BATCH, SEQ, specs, dtype=dname, device=device,
                    hbm_bytes=store.meta["hbm_bytes"])
                i = sw.best()
                peak = sched.peak_memory_bytes(cfg, BATCH, SEQ, specs[i],
                                               dtype=dname)
                row = {"world": world, "dtype": dname, "device": device,
                       "specs": len(specs),
                       "n_feasible": int(sw.feasible.sum()), **sw.row(i),
                       "peak_memory_bytes": peak,
                       "peak_equals_sweep": peak == float(sw.peak_bytes[i])}
                emit("schedule_best", **row)
                out.append(row)
    return out


def phase_service(store, model_rec, decode_recs):
    """The latency service and the comm calibration on the card's store
    (qwen2-0.5b).  Before any artifact exists: the service against the
    engine, its cache and its persisted file (``service_agreement``).
    Then (a) ``calibrate_comm`` on the card (``service_calibrate``); the
    calibrated keys (``service_tagged``); (c) the L2 correction's effect on
    the forward and decode predictions beside phase ``model``'s and phase
    ``decode``'s measurements (reports only); (d) the bf16 serve path under
    the calibrated service's decode admission oracle
    (``service_admission``); (e) the planners, predicted only.  Fails if a
    check of (a), (b) or (d) fails."""
    t0 = time.perf_counter()
    dev = store.meta["device"]
    cfg0 = cfg_registry.get(MODEL)
    cache_path = OUT / "service_cache.json"
    if cache_path.exists():
        cache_path.unlink()
    pm_off = PM2Lat(store, dev)
    agree = service_agreement(store, dev, cfg0, cache_path)
    calib = service_calibrate(store, dev)
    tagged = service_tagged(store, dev, cfg0, cache_path)
    svc = LatencyService(store, dev)
    l2 = service_l2_effect(pm_off, PM2Lat(store, dev), cfg0, model_rec,
                           decode_recs)
    admission = service_admission(svc, cfg0)
    plans = service_plans(svc, cfg0)
    bad = [k for part in (agree, calib, tagged, admission)
           for k, ok in part["checks"].items() if not ok]
    if bad:
        raise AssertionError(f"service: failed {bad}")
    seconds = time.perf_counter() - t0
    emit("service_seconds", total=seconds)
    return {"agreement": agree, "calibration": calib, "tagged": tagged,
            "l2_effect": l2, "admission": admission, "plans": plans,
            "seconds": seconds}


def service_agreement(store, dev, cfg0, cache_path):
    """(b) on the datasheet path: ``latency_query`` against
    ``BatchPredictor.predict_model`` and against phase ``grid``'s cached
    engine prediction (bit for bit, under the same key), a second query
    cached, every ``latency_grid`` point a hit, the trivial spec within
    SCHED_TRIVIAL_RTOL of the query, and ``save_cache`` read back by a new
    service with equal values, dict-valued entries included."""
    svc = LatencyService(store, dev, cache_path=str(cache_path))
    grid_cache = PredictionCache(path=str(OUT / "grid_prediction_cache.json"))
    mix = sched.TrafficMix((SEQ,), (SERVICE_NEW,), n_requests=BATCH)
    checks, rows = {}, []
    for d in DTYPES:
        cfg = dataclasses.replace(cfg0, compute_dtype=d)
        key = PredictionCache.make_key(config_key(cfg), dev, d, BATCH, SEQ)
        q = svc.latency_query(cfg, BATCH, SEQ, dtype=d)
        again = svc.latency_query(cfg, BATCH, SEQ, dtype=d)
        engine_s = svc.predictor.predict_model(cfg, BATCH, SEQ, dtype=d)[0]
        checks[f"{d}_query_is_engine"] = (q.seconds == engine_s
                                          and not q.cached)
        checks[f"{d}_grid_phase_bitwise"] = q.seconds == grid_cache.get(key)
        checks[f"{d}_second_query_cached"] = (again.cached
                                              and again.seconds == q.seconds)
        grid = svc.latency_grid(cfg, GRID_BATCHES, GRID_SEQS, dtype=d)
        hits = [svc.latency_query(cfg, b, s, dtype=d) for b in GRID_BATCHES
                for s in GRID_SEQS]
        checks[f"{d}_grid_points_hit"] = all(
            r.cached and r.seconds == g for r, g in zip(hits, grid.ravel()))
        par = svc.latency_parallel(cfg, BATCH, SEQ, dtype=d)
        checks[f"{d}_trivial_spec"] = (
            rel_diff(par.seconds, q.seconds) <= SCHED_TRIVIAL_RTOL)
        tp2 = svc.latency_parallel(cfg, BATCH, SEQ, tp=2, dtype=d)
        serve = svc.latency_serve(cfg, mix, capacity=BATCH, dtype=d)
        rows.append({"dtype": d, "query_ms": q.seconds * 1e3,
                     "trivial_spec_rel_diff": rel_diff(par.seconds,
                                                       q.seconds),
                     "tp2_ms": tp2.seconds * 1e3,
                     "tp2_comm_share": tp2.comm_share,
                     "serve_tpot_p50_ms": serve.tpot_p50 * 1e3,
                     "serve_tokens_per_s": serve.tokens_per_sec})
    svc.save_cache()
    back = LatencyService(store, dev, cache_path=str(cache_path))
    checks["reloaded_entries_equal"] = (list(back.cache._od.items())
                                        == list(svc.cache._od.items()))
    for d in DTYPES:
        cfg = dataclasses.replace(cfg0, compute_dtype=d)
        pairs = [(svc.latency_query(cfg, BATCH, SEQ, dtype=d),
                  back.latency_query(cfg, BATCH, SEQ, dtype=d)),
                 (svc.latency_parallel(cfg, BATCH, SEQ, tp=2, dtype=d),
                  back.latency_parallel(cfg, BATCH, SEQ, tp=2, dtype=d)),
                 (svc.latency_serve(cfg, mix, capacity=BATCH, dtype=d),
                  back.latency_serve(cfg, mix, capacity=BATCH, dtype=d))]
        checks[f"{d}_reloaded_hits_equal"] = all(
            b.cached and a.to_json() == b.to_json() for a, b in pairs)
    rec = {"checks": checks, "rows": rows, "stats": back.stats,
           "cache_entries": len(back.cache),
           "dict_entries": sum(isinstance(v, dict)
                               for v in back.cache._od.values())}
    emit("service_agreement", **rec)
    return rec


def service_calibrate(store, dev):
    """(a) ``calibrate_comm`` on the card into COMM_CAL: the loopback
    sweep's fit, the two trace fits, the L2 sweep and its fit.  Fails
    unless the fit's L2 size is the card's, every bundled trace passes its
    budget under the fitted constants, and a fit with a third of the link
    bandwidth fails the collective budget on both collective traces."""
    t0 = time.perf_counter()
    c = comm.calibrate_comm(str(COMM_CAL), device="cuda", verbose=False)
    seconds = time.perf_counter() - t0
    fits = {name: {"link_bw_gb_s": f.link_bw / 1e9,
                   "link_latency_us": f.link_latency * 1e6,
                   "eff_gamma": f.eff_gamma, "rel_err": f.rel_err,
                   "n_points": f.n_points, "topology": f.topology}
            for name, f in c.fits.items()}
    cache = c.cache[dev]
    samples = [{"bytes": s["bytes"], "ms": s["duration"] * 1e3,
                "gb_s": s["bytes"] / s["duration"] / 1e9}
               for s in c.meta["cache_samples"]]
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    reports = validate.run_validation(calibration=c)
    perturbed = []
    for path in validate.list_traces():
        trace = validate.load_trace(path)
        if trace["kind"] != "collective":
            continue
        fit = c.fits[trace["device"]]
        bad = validate.validate_collective_trace(trace, ic=dataclasses.replace(
            fit.interconnect(), link_bw=fit.link_bw / 3.0))
        perturbed.append({"name": bad.name, "mean_rel_err": bad.mean_rel_err,
                          "budget": bad.budget, "passed": bad.passed})
    checks = {"l2_bytes_is_the_cards": cache["l2_bytes"] == l2,
              "four_traces": len(reports) == 4,
              "traces_pass": all(r.passed for r in reports),
              "perturbed_fail": len(perturbed) == 2
              and not any(p["passed"] for p in perturbed),
              "device_fit": dev in c.fits}
    rec = {"checks": checks, "seconds": seconds, "fits": fits,
           "cache_samples": samples, "cache_fit": {
               **cache, "rel_err": c.meta["cache_rel_err"],
               "card_l2_bytes": l2},
           "tag": comm.calibration_tag(dev),
           "validation": [r.to_json() for r in reports],
           "perturbed": perturbed, "artifact": str(COMM_CAL.relative_to(ROOT))}
    emit("service_calibrate", **rec)
    return rec


def service_tagged(store, dev, cfg0, cache_path):
    """(b), once the artifact is in effect: a service on the saved cache
    keys the card as ``<device>+cc<tag>`` and misses the datasheet keys,
    which its cache still holds."""
    svc = LatencyService(store, dev, cache_path=str(cache_path))
    tag = comm.calibration_tag(dev)
    cfg = dataclasses.replace(cfg0, compute_dtype="bfloat16")
    plain = PredictionCache.make_key(config_key(cfg), dev, "bfloat16",
                                     BATCH, SEQ)
    q = svc.latency_query(cfg, BATCH, SEQ, dtype="bfloat16")
    checks = {"cache_device_tagged":
              svc.predictor.cache_device == f"{dev}+cc{tag}",
              "datasheet_key_held": plain in svc.cache,
              "datasheet_key_missed": not q.cached}
    rec = {"checks": checks, "cache_device": svc.predictor.cache_device,
           "calibrated_query_ms": q.seconds * 1e3,
           "datasheet_query_ms": svc.cache.get(plain) * 1e3}
    emit("service_tagged", **rec)
    return rec


def service_l2_effect(pm_off, pm_on, cfg0, model_rec, decode_recs):
    """(c) the qwen2-0.5b predictions without (``pm_off``, built before the
    artifact) and with (``pm_on``) the L2 correction, beside phase
    ``model``'s (8, 512) forwards and phase ``decode``'s CUDA-graph steps,
    and each memory-priced decode row's factor at its working set (its
    bytes feature).  Reports only."""
    cc = pm_on.memory_model.cache
    err = lambda p, m: 100 * abs(p - m) / m
    forward, decode = [], []
    for d in DTYPES:
        cfg = dataclasses.replace(cfg0, compute_dtype=d)
        off = pm_off.predict_model(cfg, BATCH, SEQ, dtype=d)[0] * 1e3
        on = pm_on.predict_model(cfg, BATCH, SEQ, dtype=d)[0] * 1e3
        meas = model_rec[d]["measured_ms"]
        forward.append({"dtype": d, "batch": BATCH, "seq": SEQ,
                        "measured_ms": meas, "without_ms": off,
                        "with_ms": on, "err_without_pct": err(off, meas),
                        "err_with_pct": err(on, meas)})
    for rec in decode_recs:
        d, ctx = rec["dtype"], rec["ctx"]
        ops = og.enumerate_decode_ops(dataclasses.replace(
            cfg0, compute_dtype=d), BATCH, ctx, dtype=d)
        off, off_rows = pm_off.predict_ops(ops)
        on, on_rows = pm_on.predict_ops(ops)
        rows = []
        for op, a, b in zip(ops, off_rows, on_rows):
            if op.kind == "memory":
                w = op.features()["bytes"]
            elif op.kind == "attention":
                w = og.decode_attention_features(op)["bytes"]
            else:
                continue
            rows.append({"op": op.name, "bytes": w, "factor": cc.factor(w),
                         "without_ms": a.seconds * 1e3,
                         "with_ms": b.seconds * 1e3})
        meas = rec["graph_ms"]
        decode.append({"dtype": d, "batch": BATCH, "ctx": ctx,
                       "measured_graph_ms": meas, "without_ms": off * 1e3,
                       "with_ms": on * 1e3,
                       "err_without_pct": err(off * 1e3, meas),
                       "err_with_pct": err(on * 1e3, meas), "rows": rows})
    out = {"correction": cc.to_json(), "forward": forward, "decode": decode}
    emit("service_l2_effect", **out)
    return out


def service_admission(svc, cfg0):
    """(d) the bf16 serve path at full width under the calibrated service's
    decode oracle, SERVICE_PROMPTS prompts of SEQ tokens, SERVICE_NEW new
    each, capacity SERVICE_CAPACITY, and an SLO read off the oracle's own
    grid at (SERVICE_SLO_BATCH, ctx).  Fails unless every wave is the
    largest k with oracle(k, ctx) <= SLO (1 if none), computed here from
    the grid, every served token equals the eager steps' and the flash
    kernel launched once a layer a prefill.  Reports each wave's measured
    TPOT p50 beside the SLO and ``latency_serve``'s TPOT at that
    capacity."""
    cfg = dataclasses.replace(cfg0, compute_dtype="bfloat16")
    ctx = SEQ + SERVICE_NEW
    oracle = svc.decode_oracle(cfg, "bfloat16", capacity=SERVICE_CAPACITY,
                               max_ctx=ctx)
    grid = [oracle(k, ctx) for k in range(1, SERVICE_CAPACITY + 1)]
    slo = grid[SERVICE_SLO_BATCH - 1]
    want, left = [], SERVICE_PROMPTS
    while left:
        k = max([k for k in range(1, min(SERVICE_CAPACITY, left) + 1)
                 if grid[k - 1] <= slo] or [1])
        want.append(k)
        left -= k
    model = model_registry.build(cfg, device="cuda", seed=0,
                                 dtype=torch.bfloat16)
    engine = ServingEngine(model, max_batch=SERVICE_CAPACITY,
                           max_len=ctx + 8, admission_oracle=oracle,
                           slo_tpot=slo)
    sizes, admit = [], engine._admit

    def record_wave(queue):
        wave = admit(queue)
        sizes.append(len(wave))
        return wave
    engine._admit = record_wave
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=SEQ)
                    .astype(np.int32), max_new_tokens=SERVICE_NEW)
            for i in range(SERVICE_PROMPTS)]
    before = fk.flash_attention_kernel.launches
    done = engine.run(reqs)
    flash = fk.flash_attention_kernel.launches - before
    served = check_served(engine, done, sizes)
    waves, start = [], 0
    for k in sizes:
        w = done[start:start + k]
        start += k
        tpot = [(r.t_done - r.t_first_token) / (len(r.out_tokens) - 1)
                for r in w]
        mix = sched.TrafficMix((SEQ,), (SERVICE_NEW,), n_requests=k)
        pred = svc.latency_serve(cfg, mix, capacity=k, dtype="bfloat16")
        waves.append({"size": k, "measured_tpot_p50_ms":
                      float(np.median(tpot)) * 1e3,
                      "slo_ms": slo * 1e3,
                      "oracle_step_ms": grid[k - 1] * 1e3,
                      "latency_serve_tpot_p50_ms": pred.tpot_p50 * 1e3})
    checks = {"waves_as_the_grid_says": sizes == want,
              "served_tokens_equal_eager": not served["mismatched"],
              "tokens_each": all(len(r.out_tokens) == SERVICE_NEW
                                 for r in done),
              "flash_once_a_layer_a_prefill":
                  flash == cfg.n_layers * len(sizes)}
    rec = {"checks": checks, "oracle_grid_ms": [g * 1e3 for g in grid],
           "oracle_cache_info": oracle.cache_info(), "slo_ms": slo * 1e3,
           "slo_batch": SERVICE_SLO_BATCH, "ctx": ctx, "wave_sizes": sizes,
           "expected_wave_sizes": want, "waves": waves,
           "flash_launches": flash, "served_vs_eager": served,
           "wall_s": engine.wall_s}
    emit("service_admission", **rec)
    del engine, model
    torch.cuda.empty_cache()
    return rec


def service_plans(svc, cfg0):
    """(e) predictions one card cannot check: ``plan_training`` and
    ``plan_serving`` for SERVICE_DEVICES devices on the card's store and
    re-anchored to ``h100_sxm``, bf16, and the oracle's explanation of one
    matmul shape."""
    cfg = dataclasses.replace(cfg0, compute_dtype="bfloat16")
    mix = sched.TrafficMix((SEQ,), (SERVICE_NEW,), n_requests=16)
    out = {"training": [], "serving": []}
    for device in (None, H100_SXM.name):
        tp = svc.plan_training(cfg, BATCH, SEQ, devices=SERVICE_DEVICES,
                               dtype="bfloat16", device=device)
        sp = svc.plan_serving(cfg, mix, devices=SERVICE_DEVICES,
                              dtype="bfloat16", device=device)
        out["training"].append({k: v for k, v in tp.to_json().items()
                                if k != "alternatives"})
        out["serving"].append({k: v for k, v in sp.to_json().items()
                               if k != "alternatives"})
    out["explain"] = {
        "shape": SERVICE_MM_SHAPE,
        "candidates": svc.explain_kernels("matmul", SERVICE_MM_SHAPE,
                                          dtype="bfloat16")}
    emit("service_plans", **out)
    return out


def phase_hybrid(store):
    """recurrentgemma-2b at full width (26 layers, d 2560, 10/1 heads at hd
    256, window 2048, vocab 256,000), float32 then bf16, each built from
    seed 0 on the card and freed before the next.  (b) the forward at
    HYBRID_FORWARDS, measured and against the store's prediction
    (``hybrid_forward``); (c) the wrapped ring's decode steps against the
    forward and (d) a ring write one slot off, which (c)'s check must
    reject (``hybrid_ring``); (e) the launcher's bf16 engine over two
    waves, every token held against eager steps (``hybrid_serve``).  The
    hd-256 flash instances are held against their plain version at this
    path's shapes by ``check_flash`` ((a), ``hybrid_path_cases``) and timed
    in the ``kernels`` line ((f)).  Fails if a check of (b)-(e) fails."""
    t0 = time.perf_counter()
    cfg0 = cfg_registry.get(HYBRID)
    pm = PM2Lat(store, store.meta["device"])
    gen = torch.Generator(device="cuda").manual_seed(4)
    forwards, rings = [], []
    for dname in DTYPES:
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        model = model_registry.build(cfg, device="cuda", seed=0,
                                     dtype=getattr(torch, dname))
        with torch.no_grad():
            for B, S in HYBRID_FORWARDS:
                tokens = torch.randint(0, cfg.vocab_size, (B, S),
                                       generator=gen, device="cuda")
                forwards.append(hybrid_forward(model, pm, cfg, tokens))
            tokens = torch.randint(
                0, cfg.vocab_size, (HYBRID_RING_BATCH, HYBRID_RING_PROMPT
                                    + HYBRID_RING_STEPS),
                generator=gen, device="cuda")
            rings.append(hybrid_ring(model, pm, cfg, tokens))
        del model
    torch.cuda.empty_cache()
    served = hybrid_serve(pm)
    torch.cuda.empty_cache()
    rec = {"forwards": forwards, "rings": rings, "serve": served,
           "l2_correction": pm.memory_model.cache is not None,
           "seconds": time.perf_counter() - t0}
    emit("hybrid", seconds=rec["seconds"])
    bad = [f"forward {r['dtype']} {r['batch']}x{r['seq']}: {r['failed']}"
           for r in forwards if r["failed"]]
    bad += [f"ring {r['dtype']}: {r['failed']}" for r in rings if r["failed"]]
    bad += [f"serve: {served['failed']}"] if served["failed"] else []
    if bad:
        raise AssertionError(f"hybrid: {bad}")
    return rec


def hybrid_forward(model, pm, cfg, tokens):
    """(b) One forward at (B, S) = ``tokens.shape``: finite logits of the
    padded vocab, one flash launch a local-attention layer; its time
    (CUDA events, ``profiler.measure``) and trace against ``predict_model``
    (its top rows, and the share of the time each layer kind's rows
    take)."""
    B, S = tokens.shape
    dname = cfg.compute_dtype
    before = fk.flash_attention_kernel.launches
    logits = model(tokens)
    torch.cuda.synchronize()
    flash = fk.flash_attention_kernel.launches - before
    finite = bool(torch.isfinite(logits).all())
    shape = list(logits.shape)
    del logits
    measured = profiler.measure(model, tokens)
    trace = forward_trace(model, tokens)
    total, rows = pm.predict_model(cfg, B, S, dtype=dname)
    by_kind = {}
    for r in rows:
        kind = r.name.split(".")[0]
        by_kind[kind] = by_kind.get(kind, 0.0) + r.seconds * 1e3
    n_local = cfg.layer_kinds.count(C.LOCAL_ATTN)
    failed = [] if finite else ["logits not finite"]
    failed += [] if shape == [B, S, model.padded_vocab] else [f"shape {shape}"]
    failed += [] if flash == n_local else [f"{flash} flash launches, "
                                           f"expected {n_local}"]
    rec = {"dtype": dname, "batch": B, "seq": S, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "window": cfg.sliding_window,
           "logits_shape": shape, "logits_finite": finite,
           "flash_launches_per_forward": flash,
           "measured_ms": measured * 1e3, "predicted_ms": total * 1e3,
           "err_pct": 100 * abs(total - measured) / measured,
           "predicted_ms_by_kind": by_kind,
           "top5_predicted": [[r.name, r.kernel, r.seconds * 1e3] for r in
                              sorted(rows, key=lambda r: -r.seconds)[:5]],
           "device_trace": trace, "failed": failed}
    emit("hybrid_forward", **rec)
    return rec


def ring_slots_wrong(cfg, cache, seeded):
    """The ring slots of ``cache``'s local-attention layers (K and V, each
    batch row and KV head) whose nearest slot of ``seeded``, the caches of
    a prefill over the same tokens, is another slot: 0 when every slot
    holds the position it should.  No limit: two positions' K or V differ
    far more than two paths' rounding of one position's."""
    wrong = 0
    for i, kind in enumerate(cfg.layer_kinds):
        if kind == C.LOCAL_ATTN:
            for got, want in ((cache.k[i], seeded.k[i]),
                              (cache.v[i], seeded.v[i])):
                near = torch.cdist(got.float(), want.float()).argmin(-1)
                slot = torch.arange(near.shape[-1], device=near.device)
                wrong += int((near != slot).sum())
    return wrong


def hybrid_ring(model, pm, cfg, tokens):
    """(c) Prefill HYBRID_RING_PROMPT tokens at capacity
    HYBRID_RING_CAPACITY, so that every local layer's ring of min(2048,
    capacity) slots has wrapped, then HYBRID_RING_STEPS decode steps
    eagerly and the same steps as a replayed CUDA graph (``DecodeGraph``):
    the prefill's and each step's logits against the forward over all the
    tokens at that position (max |d| / max |logits|; the prefill within
    DECODE_TOL, the steps within HYBRID_STEP_TOL), the rings after the
    steps slot for slot against a prefill of all the tokens
    (``ring_slots_wrong``), the replay equal to the eager step bit for bit,
    no hand kernel launched in a step.  (d) The first step again with
    every ring write one slot late (``attn.ring_slots`` patched for that
    step): its rings must fail the slot check against a prefill of one
    token more, and in float32 its logits the limit (bf16's limit lies
    above what the fault moves there: its error is reported).  Times both
    steps (the graph's is the one predicted)."""
    dname = cfg.compute_dtype
    B, T = tokens.shape
    P, n = HYBRID_RING_PROMPT, T - HYBRID_RING_PROMPT
    want = model(tokens)[:, P - 1:].float().clone()   # positions P - 1 ..
    scale = want.abs().max()
    rel = lambda x, t: float((x.float() - want[:, t]).abs().max() / scale)
    # the caches a prefill seeds over all the tokens and over one more
    # than the prompt: the rings the steps and the faulty step must reach
    full, one_more = (model.prefill(tokens[:, :S],
                                    max_len=HYBRID_RING_CAPACITY)[1]
                      for S in (T, P + 1))
    last, cache = model.prefill(tokens[:, :P], max_len=HYBRID_RING_CAPACITY)
    prefill_err = rel(last, 0)
    tol = HYBRID_STEP_TOL[dname]
    ring = min(cache.k[i].shape[2] for i, k in enumerate(cfg.layer_kinds)
               if k == C.LOCAL_ATTN)
    start = cache.clone()
    before = hand_launches()
    eager, errs = [], []
    for t in range(n):
        logits, _ = model.decode_step(tokens[:, P + t], cache)
        eager.append(logits.clone())
        errs.append(rel(logits, t + 1))
    slots_wrong = ring_slots_wrong(cfg, cache, full)
    late = start.clone()
    ring_slots = attn.ring_slots
    attn.ring_slots = lambda pos, W: ((pos + 1) % W, ring_slots(pos, W)[1])
    try:
        wrong, _ = model.decode_step(tokens[:, P], late)
    finally:
        attn.ring_slots = ring_slots
    fault_err = rel(wrong, 1)
    fault_slots_wrong = ring_slots_wrong(cfg, late, one_more)
    del late, wrong, full, one_more
    graph = DecodeGraph(model, start).load(start)
    graph_errs, bitwise = [], True
    for t in range(n):
        logits = graph(tokens[:, P + t])
        graph_errs.append(rel(logits, t + 1))
        bitwise = bitwise and bool(torch.equal(logits, eager[t]))
    in_step = launches_since(before)
    tok = tokens[:, T - 1].contiguous()

    def eager_step():
        cache.pos.fill_(T - 1)
        return model.decode_step(tok, cache)

    def graph_step():
        graph.cache.pos.fill_(T - 1)
        return graph(tok)

    eager_s, graph_s = profiler.measure(eager_step), profiler.measure(graph_step)
    predicted, _ = pm.predict_ops(og.enumerate_decode_ops(cfg, B, T,
                                                          dtype=dname))
    checks = {"prefill_logits_ok": prefill_err <= DECODE_TOL[dname],
              "logits_ok": max(errs + graph_errs) <= tol,
              "ring_slots_ok": slots_wrong == 0,
              "graph_bitwise": bitwise,
              "planted_fault_in_ring": fault_slots_wrong > 0,
              "no_hand_launch_in_step": not in_step}
    if dname == "float32":
        checks["planted_fault_in_logits"] = fault_err > tol
    rec = {"dtype": dname, "batch": B, "prompt": P, "steps": n,
           "capacity": cache.capacity, "ring_slots": ring,
           "wrapped": P > ring, "prefill_logits_rel_err": prefill_err,
           "logits_rel_err": max(errs), "graph_logits_rel_err":
           max(graph_errs), "logits_rel_err_by_step": errs,
           "prefill_logits_tol": DECODE_TOL[dname], "logits_tol": tol,
           "ring_slots_wrong": slots_wrong,
           "planted_fault_rel_err": fault_err,
           "planted_fault_ring_slots_wrong": fault_slots_wrong,
           "hand_launches_in_step": in_step,
           "cache_bytes": cache.nbytes,
           "kv_cache_bytes_predictor": og.kv_cache_bytes(cfg, B, T, dname),
           "eager_ms": eager_s * 1e3, "graph_ms": graph_s * 1e3,
           "predicted_step_ms": predicted * 1e3,
           "err_pct": 100 * abs(predicted - graph_s) / graph_s,
           "checks": checks,
           "failed": [k for k, ok in checks.items() if not ok]}
    emit("hybrid_ring", **rec)
    return rec


def hybrid_serve(pm):
    """(e) The ``serve`` launcher's engine at HYBRID_SERVE_ARGS: 8 prompts
    of 512 tokens, 16 new each, in two waves of 4, greedy, bf16.  Fails
    unless every request ends with its 16 tokens, the flash kernel launched
    once a local layer a wave and every served token equals eager steps'
    (``check_served``, run after the launches are read).  Prices the prompt
    and the decode steps over the contexts they ran at."""
    args = serve_launcher.parse_args(HYBRID_SERVE_ARGS)
    cfg = dataclasses.replace(cfg_registry.get(HYBRID),
                              compute_dtype=args.compute_dtype)
    before = hand_launches()
    engine, done = serve_launcher.serve(args)
    flash = launches_since(before).get("flash_attention", 0)
    out = serve_launcher.summary(engine, done)
    served = check_served(engine, done)
    dt = args.compute_dtype
    prefill_s, _ = pm.predict_model(cfg, args.max_batch, args.prompt_len,
                                    dtype=dt)
    ctxs = range(args.prompt_len + 1, args.prompt_len + args.max_new)
    step_s = float(np.mean([pm.predict_ops(og.enumerate_decode_ops(
        cfg, args.max_batch, c, dtype=dt))[0] for c in ctxs]))
    st = engine.stats
    waves = -(-args.requests // args.max_batch)
    want_flash = cfg.layer_kinds.count(C.LOCAL_ATTN) * waves
    failed = [] if sorted({len(r.out_tokens) for r in done}) == [
        args.max_new] else ["tokens each"]
    failed += [] if flash == want_flash else [f"{flash} flash launches, "
                                              f"expected {want_flash}"]
    failed += [f"requests unlike the eager steps {served['mismatched']}"] \
        if served["mismatched"] else []
    rec = {**out, "requests": len(done), "prefills": st.prefills,
           "capacity": engine.max_len,
           "ttft_p50_ms": st.ttft_p50 * 1e3, "tpot_p50_ms": st.tpot_p50 * 1e3,
           "tpot_p95_ms": st.tpot_p95 * 1e3, "flash_launches": flash,
           "served_vs_eager": served,
           "predicted_prefill_ms": prefill_s * 1e3,
           "predicted_decode_step_ms": step_s * 1e3,
           "wall_s": engine.wall_s, "failed": failed}
    emit("hybrid_serve", **rec)
    del engine
    return rec


def phase_encdec(store):
    """whisper-small at full width (12 encoder and 12 decoder layers, d
    768, 12 heads of 64, vocab 51,865, 1,500 stub frames), float32 then
    bf16, each built from seed 0 on the card and freed before the next.
    (b) the forward at ENCDEC_FORWARDS, measured, split and against the
    store's prediction, 36 flash launches (24 non-causal) each
    (``encdec_forward``); (c) the float32 encoder on the card against the
    CPU's, and a causal encoder, which must fail that check
    (``encdec_encoder``); (d) decode steps against the forward, eager and
    graph, and a step over a foreign context's cross caches, which must
    fail (``encdec_decode``); (e) the launcher's bf16 engine over two waves,
    every token held against eager steps (``encdec_serve``).  The flash
    kernel is held against its plain version at this path's shapes by
    ``check_flash`` ((a), ``encdec_path_cases``) and timed at the encoder's
    and the cross attention's in the ``kernels`` line ((f)).  Fails if a
    check of (b)-(e) fails."""
    t0 = time.perf_counter()
    cfg0 = cfg_registry.get(ENCDEC)
    pm = PM2Lat(store, store.meta["device"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    forwards, decodes, encoder = [], [], None
    for dname in DTYPES:
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        model = model_registry.build(cfg, device="cuda", seed=0,
                                     dtype=getattr(torch, dname))
        with torch.no_grad():
            if dname == "float32":
                encoder = encdec_encoder(model)
            for B, S in ENCDEC_FORWARDS:
                tokens = torch.randint(0, cfg.vocab_size, (B, S),
                                       generator=gen, device="cuda")
                forwards.append(encdec_forward(model, pm, cfg, tokens))
            tokens = torch.randint(
                0, cfg.vocab_size,
                (ENCDEC_BATCH, ENCDEC_PROMPT + ENCDEC_STEPS), generator=gen,
                device="cuda")
            decodes.append(encdec_decode(model, pm, cfg, tokens))
        del model
    torch.cuda.empty_cache()
    served = encdec_serve(pm)
    torch.cuda.empty_cache()
    rec = {"forwards": forwards, "encoder": encoder, "decodes": decodes,
           "serve": served, "seconds": time.perf_counter() - t0}
    emit("encdec", seconds=rec["seconds"])
    bad = [f"forward {r['dtype']} {r['batch']}x{r['seq']}: {r['failed']}"
           for r in forwards if r["failed"]]
    bad += [f"encoder: {encoder['failed']}"] if encoder["failed"] else []
    bad += [f"decode {r['dtype']}: {r['failed']}" for r in decodes
            if r["failed"]]
    bad += [f"serve: {served['failed']}"] if served["failed"] else []
    if bad:
        raise AssertionError(f"encdec: {bad}")
    return rec


def encdec_flash_launches(cfg):
    """A forward's (or prefill's) flash launches and the non-causal ones:
    each encoder layer's self-attention and each decoder layer's cross
    attention are non-causal, each decoder layer's self-attention causal."""
    noncausal = cfg.encoder.n_layers + cfg.n_layers
    return noncausal + cfg.n_layers, noncausal


def encdec_forward(model, pm, cfg, tokens):
    """(b) One forward at (B, S) = ``tokens.shape`` over a 1,500-frame
    context (``make_ctx``): finite logits of the padded vocab, 36 flash
    launches, 24 of them non-causal (counted by the wrapper's mask flag);
    its time (CUDA events, ``profiler.measure``), its trace and the
    encoder's alone (the split: encoder, decoder = the rest, flash, GEMMs,
    idle), against ``predict_model`` (its encoder segment, ``enc.*`` rows,
    against the encoder's device time)."""
    B, S = tokens.shape
    dname = cfg.compute_dtype
    ctx = model.make_ctx(B)
    fa = fk.flash_attention_kernel
    before = fa.launches, fa.launches_by_causal.get(False, 0)
    logits = model(tokens, ctx_embed=ctx)
    torch.cuda.synchronize()
    flash = fa.launches - before[0]
    noncausal = fa.launches_by_causal.get(False, 0) - before[1]
    finite = bool(torch.isfinite(logits).all())
    shape = list(logits.shape)
    del logits
    run = lambda: model(tokens, ctx_embed=ctx)
    measured = profiler.measure(run)
    trace = forward_trace(run)
    enc_trace = forward_trace(model.encode, ctx)
    total, rows = pm.predict_model(cfg, B, S, dtype=dname)
    by_kind = {}
    for r in rows:
        kind = r.name.split(".")[0]
        by_kind[kind] = by_kind.get(kind, 0.0) + r.seconds * 1e3
    want = encdec_flash_launches(cfg)
    failed = [] if finite else ["logits not finite"]
    failed += [] if shape == [B, S, model.padded_vocab] else [f"shape {shape}"]
    failed += [] if (flash, noncausal) == want else [
        f"{flash} flash launches, {noncausal} non-causal, expected {want}"]
    split = {"encoder_busy_ms": enc_trace["device_busy_ms"],
             "decoder_busy_ms": trace["device_busy_ms"]
             - enc_trace["device_busy_ms"],
             "flash_ms": trace["flash_ms"], "encoder_flash_ms":
             enc_trace["flash_ms"], "gemm_ms": trace["gemm_ms"],
             "idle_share": trace["idle_share"]}
    rec = {"dtype": dname, "batch": B, "seq": S, "frames": ctx.shape[1],
           "n_layers": cfg.n_layers, "encoder_layers": cfg.encoder.n_layers,
           "d_model": cfg.d_model, "logits_shape": shape,
           "logits_finite": finite, "flash_launches_per_forward": flash,
           "noncausal_flash_launches": noncausal,
           "measured_ms": measured * 1e3, "predicted_ms": total * 1e3,
           "err_pct": 100 * abs(total - measured) / measured,
           "predicted_ms_by_kind": by_kind, "split": split,
           "encoder_predicted_ms": by_kind.get("enc", 0.0),
           "top5_predicted": [[r.name, r.kernel, r.seconds * 1e3] for r in
                              sorted(rows, key=lambda r: -r.seconds)[:5]],
           "device_trace": trace, "encoder_trace": enc_trace,
           "failed": failed}
    emit("encdec_forward", **rec)
    return rec


def encdec_encoder(model):
    """(c) The float32 encoder on the card at batch 1 against the same
    weights and context on the CPU (the plain flash), as max|d| /
    max|out| within ENCDEC_ENCODER_TOL; then the card's encoder run causal
    (each encoder block's ``causal`` set for the call), which must miss
    it."""
    ctx = model.make_ctx(1, torch.Generator(device="cuda").manual_seed(6))
    got = model.encode(ctx).cpu()
    cpu = Transformer(model.cfg, device=torch.device("cpu"))
    cpu.load_state_dict(model.state_dict())
    want = cpu.encode(ctx.cpu())
    del cpu
    rel = lambda x: float((x.float() - want).abs().max() / want.abs().max())
    blocks = model.encoder.blocks
    for blk in blocks:
        blk.causal = True
    try:
        causal = model.encode(ctx).cpu()
    finally:
        for blk in blocks:
            blk.causal = False
    err, fault_err = rel(got), rel(causal)
    checks = {"encoder_ok": err <= ENCDEC_ENCODER_TOL,
              "planted_fault_caught": fault_err > ENCDEC_ENCODER_TOL}
    rec = {"dtype": model.cfg.compute_dtype, "batch": 1,
           "frames": ctx.shape[1], "rel_err": err, "tol": ENCDEC_ENCODER_TOL,
           "causal_encoder_rel_err": fault_err, "checks": checks,
           "failed": [k for k, ok in checks.items() if not ok]}
    emit("encdec_encoder", **rec)
    return rec


def encdec_decode(model, pm, cfg, tokens):
    """(d) Prefill ENCDEC_PROMPT tokens over a context at capacity
    ENCDEC_CAPACITY, then ENCDEC_STEPS decode steps eagerly and the same
    steps as a replayed CUDA graph: the prefill's and each step's logits
    against the forward over all the tokens at that position (max |d| /
    max |logits| within DECODE_TOL), the replay equal to the eager step bit
    for bit, the cache's bytes equal to ``kv_cache_bytes`` at the capacity,
    no hand kernel launched in a step.  The planted fault: the first step
    over cross caches from another context (another seed's prefill of the
    same tokens), which must miss DECODE_TOL.  Times both steps (the
    graph's is the one predicted, at the capacity, the slots the step
    reads)."""
    dname = cfg.compute_dtype
    B, T = tokens.shape
    P, n = ENCDEC_PROMPT, T - ENCDEC_PROMPT
    ctx = model.make_ctx(B)
    want = model(tokens, ctx_embed=ctx)[:, P - 1:].float().clone()
    scale = want.abs().max()
    rel = lambda x, t: float((x.float() - want[:, t]).abs().max() / scale)
    other = model.make_ctx(B, torch.Generator(device="cuda").manual_seed(7))
    foreign = model.prefill(tokens[:, :P], ctx_embed=other,
                            max_len=ENCDEC_CAPACITY)[1]
    last, cache = model.prefill(tokens[:, :P], ctx_embed=ctx,
                                max_len=ENCDEC_CAPACITY)
    prefill_err = rel(last, 0)
    kv = og.kv_cache_bytes(cfg, B, ENCDEC_CAPACITY, dname)
    start = cache.clone()
    before = hand_launches()
    eager, errs = [], []
    for t in range(n):
        logits, _ = model.decode_step(tokens[:, P + t], cache)
        eager.append(logits.clone())
        errs.append(rel(logits, t + 1))
    fault = start.clone()
    fault.xk, fault.xv = foreign.xk, foreign.xv
    wrong, _ = model.decode_step(tokens[:, P], fault)
    fault_err = rel(wrong, 1)
    del fault, foreign, wrong
    graph = DecodeGraph(model, start).load(start)
    graph_errs, bitwise = [], True
    for t in range(n):
        logits = graph(tokens[:, P + t])
        graph_errs.append(rel(logits, t + 1))
        bitwise = bitwise and bool(torch.equal(logits, eager[t]))
    in_step = launches_since(before)
    tok = tokens[:, T - 1].contiguous()

    def eager_step():
        cache.pos.fill_(T - 1)
        return model.decode_step(tok, cache)

    def graph_step():
        graph.cache.pos.fill_(T - 1)
        return graph(tok)

    eager_s, graph_s = profiler.measure(eager_step), profiler.measure(graph_step)
    graph_trace = forward_trace(graph_step)
    predicted, rows = pm.predict_ops(og.enumerate_decode_ops(
        cfg, B, ENCDEC_CAPACITY, dtype=dname))
    by_kind = {}
    for r in rows:
        by_kind[r.kind] = by_kind.get(r.kind, 0.0) + r.seconds * 1e3
    tol = DECODE_TOL[dname]
    checks = {"prefill_logits_ok": prefill_err <= tol,
              "logits_ok": max(errs + graph_errs) <= tol,
              "graph_bitwise": bitwise,
              "planted_fault_caught": fault_err > tol,
              "cache_bytes_ok": cache.nbytes == kv,
              "no_hand_launch_in_step": not in_step}
    rec = {"dtype": dname, "batch": B, "prompt": P, "steps": n,
           "capacity": cache.capacity, "prefill_logits_rel_err": prefill_err,
           "logits_rel_err": max(errs), "graph_logits_rel_err":
           max(graph_errs), "logits_rel_err_by_step": errs,
           "logits_tol": tol, "planted_fault_rel_err": fault_err,
           "hand_launches_in_step": in_step,
           "cache_bytes": cache.nbytes, "kv_cache_bytes": kv,
           "eager_ms": eager_s * 1e3, "graph_ms": graph_s * 1e3,
           "predicted_step_ms": predicted * 1e3,
           "predicted_ms_by_kind": by_kind,
           "err_pct": 100 * abs(predicted - graph_s) / graph_s,
           "graph_trace": graph_trace, "checks": checks,
           "failed": [k for k, ok in checks.items() if not ok]}
    emit("encdec_decode", **rec)
    return rec


def encdec_serve(pm):
    """(e) The ``serve`` launcher's engine at ENCDEC_SERVE_ARGS: 8 prompts
    of 64 tokens, 32 new each, in two waves of 4, greedy, bf16, each wave
    over the engine's 1,500-frame context.  Fails unless every request ends
    with its 32 tokens, the flash kernel launched 36 times a wave (the
    prefill's) and every served token equals eager steps' over the same
    context (``check_served``, run after the launches are read).  Prices
    the prompt and the decode steps over the contexts they ran at."""
    args = serve_launcher.parse_args(ENCDEC_SERVE_ARGS)
    cfg = dataclasses.replace(cfg_registry.get(ENCDEC),
                              compute_dtype=args.compute_dtype)
    before = hand_launches()
    engine, done = serve_launcher.serve(args)
    flash = launches_since(before).get("flash_attention", 0)
    out = serve_launcher.summary(engine, done)
    served = check_served(engine, done)
    dt = args.compute_dtype
    prefill_s, _ = pm.predict_model(cfg, args.max_batch, args.prompt_len,
                                    dtype=dt)
    ctxs = range(args.prompt_len + 1, args.prompt_len + args.max_new)
    step_s = float(np.mean([pm.predict_ops(og.enumerate_decode_ops(
        cfg, args.max_batch, c, dtype=dt))[0] for c in ctxs]))
    st = engine.stats
    waves = -(-args.requests // args.max_batch)
    want_flash = encdec_flash_launches(cfg)[0] * waves
    failed = [] if sorted({len(r.out_tokens) for r in done}) == [
        args.max_new] else ["tokens each"]
    failed += [] if flash == want_flash else [f"{flash} flash launches, "
                                              f"expected {want_flash}"]
    failed += [f"requests unlike the eager steps {served['mismatched']}"] \
        if served["mismatched"] else []
    rec = {**out, "requests": len(done), "prefills": st.prefills,
           "capacity": engine.max_len,
           "ttft_p50_ms": st.ttft_p50 * 1e3, "ttft_p95_ms": st.ttft_p95 * 1e3,
           "tpot_p50_ms": st.tpot_p50 * 1e3, "tpot_p95_ms": st.tpot_p95 * 1e3,
           "flash_launches": flash, "served_vs_eager": served,
           "predicted_prefill_ms": prefill_s * 1e3,
           "predicted_decode_step_ms": step_s * 1e3,
           "wall_s": engine.wall_s, "failed": failed}
    emit("encdec_serve", **rec)
    del engine
    return rec


def phase_moe(store):
    """The MoE path: moonshot-v1-16b-a3b and llama4-scout-17b-16e at full
    width, at MOE_RUNS' dtypes and depths, each built from seed 0 on the
    card and freed before the next.  (b, c, e) the forward at MOE_FORWARD:
    finite logits, one flash launch a layer, all at hd 128, its time and
    trace against ``predict_model``, its per-layer split, and the share of
    (token, choice) pairs capacity 1.25 drops in each layer
    (``moe_forward``); (d) decode steps against the forward at a capacity
    that drops nothing with the routing held to the forward's, a step
    with each gate on the next expert down (in every layer, and in the
    middle layer), which must fail, and freely routed steps, eager and
    graph (``moe_decode``);
    (f) the launcher's bf16 engine on moonshot at full depth, every token
    held against eager steps (``moe_serve``).  The flash kernel is held
    against its plain version at this path's shapes by ``check_flash``
    ((a), ``moe_path_cases``) and timed at moonshot's (8, 512) in the
    ``kernels`` line ((g), ``hd128``).  Fails if a check of (b)-(f)
    fails."""
    t0 = time.perf_counter()
    pm = PM2Lat(store, store.meta["device"])
    gen = torch.Generator(device="cuda").manual_seed(8)
    builds, forwards, decodes = [], [], []
    for arch, dname, n_layers in MOE_RUNS:
        torch.cuda.empty_cache()
        full = cfg_registry.get(arch)
        cfg = dataclasses.replace(full, compute_dtype=dname, n_layers=n_layers)
        dt = getattr(torch, dname)
        torch.cuda.reset_peak_memory_stats()
        t_build = time.perf_counter()
        model = model_registry.build(cfg, device="cuda", seed=0, dtype=dt)
        torch.cuda.synchronize()
        builds.append({"arch": arch, "dtype": dname, "n_layers": n_layers,
                       "full_layers": full.n_layers,
                       "build_s": time.perf_counter() - t_build,
                       "weight_bytes": sum(p.nbytes
                                           for p in model.parameters()),
                       "build_peak_bytes": torch.cuda.max_memory_allocated()})
        emit("moe_build", **builds[-1])
        with torch.no_grad():
            tokens = torch.randint(0, cfg.vocab_size, MOE_FORWARD,
                                   generator=gen, device="cuda")
            forwards.append(moe_forward(model, pm, cfg, tokens))
            tokens = torch.randint(0, cfg.vocab_size,
                                   (MOE_BATCH, MOE_PROMPT + MOE_STEPS),
                                   generator=gen, device="cuda")
            decodes.append(moe_decode(model, pm, cfg, tokens))
        del model
    torch.cuda.empty_cache()
    served = moe_serve(pm)
    torch.cuda.empty_cache()
    rec = {"builds": builds, "forwards": forwards, "decodes": decodes,
           "serve": served, "seconds": time.perf_counter() - t0}
    emit("moe", seconds=rec["seconds"])
    bad = [f"forward {r['arch']} {r['dtype']}: {r['failed']}"
           for r in forwards if r["failed"]]
    bad += [f"decode {r['arch']} {r['dtype']}: {r['failed']}"
            for r in decodes if r["failed"]]
    bad += [f"serve: {served['failed']}"] if served["failed"] else []
    if bad:
        raise AssertionError(f"moe: {bad}")
    return rec


def moe_no_drop(cfg):
    """``cfg`` at a capacity factor that drops nothing: E / top_k + 1, as
    ``reduced()`` sets it, so that every expert's capacity is at least a
    group's tokens.  At 1.25 a forward over MOE_PROMPT + MOE_STEPS tokens
    a row drops late pairs that a one-token decode group (capacity
    max(top_k, 4) >= top_k) never drops, so a sound port would miss a
    decode-against-forward check there."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k + 1.0))


class MoeRouting:
    """Within the block: each MoE layer's routing in the calls made (one
    group a batch row, the default grouping), from its input at the
    capacity it is called with: ``shares``, the share of (token, choice)
    pairs ``_top_k_routing`` drops, a float a layer and call; ``ranked``,
    the top_k + 1 experts of highest probability, in descending order,
    (B, S, top_k + 1), a tensor a layer and call.  Both are read after
    the block."""

    def __init__(self, model):
        self.model, self.kept, self.ranked = model, [], []

    def hook(self, mod, args):
        x, moe = args[0], args[1]
        probs = torch.softmax(mod.router(x.float()), dim=-1)
        cap = moe_mod.expert_capacity(x.shape[1], moe)
        self.kept.append(moe_mod._top_k_routing(probs, moe, cap)[2]
                         .float().mean())
        self.ranked.append(torch.topk(
            probs, min(moe.top_k + 1, moe.num_experts), dim=-1).indices)

    def __enter__(self):
        self.handles = [blk.moe.register_forward_pre_hook(self.hook)
                        for blk in self.model.blocks]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.shares = [1.0 - float(k) for k in self.kept]


class ForcedRouting:
    """Within the block, the MoE layers' routing (``moe_mod._top_k``) is
    held to ``routing`` (a ``MoeRouting`` of the forward over the whole
    sequence): each model call ``forced(pos, run)`` runs ``run()``
    with every layer choosing the experts the forward ranked at positions
    ``pos``, ``shift`` ranks down in the layers ``shifted`` (all by
    default; shift 1 is a planted fault: each gate weighs the next expert
    down), their gates the caller's own probabilities renormalised.  A
    forward pre-hook on each layer's ``moe`` names the layer; a call that
    does not route every layer exactly once, in order, raises.
    ``differ``: the (layer, row, position) where the caller's own top-k
    would have chosen other experts."""

    def __init__(self, model, routing, shift=0, shifted=None):
        self.model, self.ranked, self.shift = model, routing.ranked, shift
        self.L = len(model.blocks)
        self.shifted = set(range(self.L) if shifted is None else shifted)
        self.entered, self.routed, self.found = [], [], []

    def top_k(self, probs, moe):
        i = self.entered[-1]
        self.routed.append(i)
        s = self.shift if i in self.shifted else 0
        want = self.ranked[i][:, self.pos, s:s + moe.top_k]
        own = self.orig(probs, moe)[1]
        self.found.append((own.sort(-1).values != want.sort(-1).values)
                          .any(-1).sum())
        return moe_mod._renormalise(probs.gather(-1, want)), want

    def __call__(self, pos, run):
        self.pos, self.entered, self.routed = pos, [], []
        out = run()
        if not self.entered == self.routed == list(range(self.L)):
            raise AssertionError(f"forced routing: layers entered "
                                 f"{self.entered}, routed {self.routed}")
        return out

    def __enter__(self):
        self.handles = [blk.moe.register_forward_pre_hook(
            lambda mod, args, i=i: self.entered.append(i))
            for i, blk in enumerate(self.model.blocks)]
        self.orig, moe_mod._top_k = moe_mod._top_k, self.top_k
        return self

    def __exit__(self, *exc):
        moe_mod._top_k = self.orig
        for h in self.handles:
            h.remove()
        self.differ = int(sum(int(f) for f in self.found))


def moe_forward(model, pm, cfg, tokens):
    """(b, c, e) One forward at (B, S) = ``tokens.shape``: finite logits
    of the padded vocab, one flash launch a layer, every one at hd 128;
    the share of pairs each layer drops at capacity 1.25 (a reported
    number, not a check); its time (CUDA events, ``profiler.measure``),
    its trace (GEMM, flash, top-k and cumsum kernels, idle share) and the
    first layer's MoE stages timed alone (``moe_split``), against
    ``predict_model`` (by op)."""
    B, S = tokens.shape
    dname = cfg.compute_dtype
    fa = fk.flash_attention_kernel
    before = fa.launches, fa.launches_by_hd.get(128, 0)
    with MoeRouting(model) as drops:
        logits = model(tokens)
    torch.cuda.synchronize()
    flash, hd128 = fa.launches - before[0], fa.launches_by_hd.get(128, 0) \
        - before[1]
    finite = bool(torch.isfinite(logits).all())
    shape = list(logits.shape)
    del logits
    measured = profiler.measure(model, tokens)
    trace = forward_trace(model, tokens)
    split = moe_split(model, cfg, tokens)
    total, rows = pm.predict_model(cfg, B, S, dtype=dname)
    by_op = {}
    for r in rows:
        op = r.name.split(".")[1] if "." in r.name else r.name
        by_op[op] = by_op.get(op, 0.0) + r.seconds * 1e3
    failed = [] if finite else ["logits not finite"]
    failed += [] if shape == [B, S, model.padded_vocab] else [f"shape {shape}"]
    failed += [] if flash == hd128 == cfg.n_layers else [
        f"{flash} flash launches, {hd128} at hd 128, expected {cfg.n_layers}"]
    rec = {"arch": cfg.name, "dtype": dname, "batch": B, "seq": S,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "experts": [cfg.moe.num_experts, cfg.moe.top_k,
                       cfg.moe.num_shared_experts],
           "capacity_factor": cfg.moe.capacity_factor,
           "capacity": moe_mod.expert_capacity(S, cfg.moe),
           "logits_shape": shape, "logits_finite": finite,
           "flash_launches_per_forward": flash, "flash_hd128": hd128,
           "dropped_share_by_layer": drops.shares,
           "dropped_share": float(np.mean(drops.shares)),
           "measured_ms": measured * 1e3, "predicted_ms": total * 1e3,
           "err_pct": 100 * abs(total - measured) / measured,
           "predicted_ms_by_op": by_op, "split": split,
           "top5_predicted": [[r.name, r.kernel, r.seconds * 1e3] for r in
                              sorted(rows, key=lambda r: -r.seconds)[:5]],
           "device_trace": trace, "failed": failed}
    emit("moe_forward", **rec)
    return rec


def moe_split(model, cfg, tokens):
    """The first layer's MoE at this forward's input, each stage timed
    alone (``timed``: CUDA events, and device time where the profiler
    shows it), a layer's worth of the forward's: the router and softmax;
    the routing (top-k, the one-hot comparisons, the cumsum positions:
    ``_top_k_mask``); the dispatch product; the experts' three products
    and activation (``_experts``); the combine product; the shared
    experts.  Beside them, the forward's device busy time is the
    whole."""
    moe, m = model.blocks[0].moe, cfg.moe
    cdt = getattr(torch, cfg.compute_dtype)
    got = []
    handle = moe.register_forward_pre_hook(
        lambda mod, args: got.append(args[0]))
    try:
        model.blocks[0](model.embed(tokens, cdt), cfg, cdt)
    finally:
        handle.remove()
    x = got[0]
    G, S, d = x.shape
    cap = moe_mod.expert_capacity(S, m)
    probs = torch.softmax(moe.router(x.float()), dim=-1)
    dispatch, combine = moe_mod._top_k_mask(probs, m, cap)
    disp = dispatch.to(cdt).reshape(G, S, -1)
    xe = torch.bmm(disp.transpose(1, 2), x).view(G, m.num_experts, cap, d)
    ye = moe_mod._experts(moe, xe, cfg.mlp_act)
    comb = combine.to(cdt).reshape(G, S, -1)
    ye_flat = ye.reshape(G, -1, d)
    stages = {
        "router": lambda: torch.softmax(moe.router(x.float()), dim=-1),
        "routing": lambda: moe_mod._top_k_mask(probs, m, cap),
        "dispatch": lambda: torch.bmm(disp.transpose(1, 2), x),
        "experts": lambda: moe_mod._experts(moe, xe, cfg.mlp_act),
        "combine": lambda: torch.bmm(comb, ye_flat),
        "shared": lambda: [getattr(moe, f"shared{i}")(x, cdt)
                           for i in range(m.num_shared_experts)]}
    return {name: {**timed(fn), "n_layers": cfg.n_layers}
            for name, fn in stages.items()}


def moe_decode(model, pm, cfg, tokens):
    """(d) At the no-drop capacity (``moe_no_drop``), against the forward
    over all the tokens (max |d| / max |logits| at each position).
    Routing is discontinuous: rounding that differs between two paths
    tips near ties to other experts, and a tipped choice moves a token's
    output far past DECODE_TOL (the JAX package's own bf16 steps do so at
    reduced width).  So the decode path is held with its routing held to
    the forward's (``ForcedRouting``): prefill MOE_PROMPT tokens at
    capacity MOE_PROMPT + MOE_STEPS and take MOE_STEPS eager steps, the
    prefill's and each step's logits within ``moe_step_tol`` (DECODE_TOL,
    or past 24 bf16 layers the JAX package's own step error at that
    depth).  The planted faults, the first step with each gate on the
    next expert down in every layer, and in the middle layer only, must
    miss it; the same fault in each one layer in turn is reported, with
    how many of them the limit sees.
    The engine's path, routing freely, runs the same prefill and steps
    eagerly and as a replayed CUDA graph, which must equal the eager steps
    bit for bit; their logits errors and the routing decisions that differ
    from the forward's (``routing_flips``) are reported.  Also: the
    forward drops no pair, the cache holds ``kv_cache_bytes``, no hand
    kernel launches in a step.  Times both steps; the graph's is the one
    predicted."""
    run_cfg, model.cfg = model.cfg, moe_no_drop(cfg)
    try:
        return moe_decode_steps(model, pm, model.cfg, tokens)
    finally:
        model.cfg = run_cfg


def moe_step_tol(cfg) -> float:
    """The decode check's logits limit for ``cfg`` (MOE_REF_STEP_ERR)."""
    if cfg.compute_dtype == "float32" or cfg.n_layers <= MOE_TOL_LAYERS:
        return DECODE_TOL[cfg.compute_dtype]
    return MOE_REF_STEP_ERR[cfg.n_layers]


def moe_decode_steps(model, pm, cfg, tokens):
    """``moe_decode``'s checks, with ``model.cfg`` = ``cfg``."""
    dname = cfg.compute_dtype
    B, T = tokens.shape
    P, n, L = MOE_PROMPT, T - MOE_PROMPT, cfg.n_layers
    with MoeRouting(model) as fwd:
        want = model(tokens)[:, P - 1:].float().clone()
    scale = want.abs().max()
    rel = lambda x, t: float((x.float() - want[:, t]).abs().max() / scale)
    with ForcedRouting(model, fwd) as forced:
        last, cache = forced(slice(0, P), lambda: model.prefill(
            tokens[:, :P], max_len=T))
        prefill_err = rel(last, 0)
        start = cache.clone()
        errs = []
        for t in range(n):
            logits, _ = forced(slice(P + t, P + t + 1),
                               lambda: model.decode_step(tokens[:, P + t],
                                                         cache))
            errs.append(rel(logits, t + 1))

    def shifted(layers):
        with ForcedRouting(model, fwd, shift=1, shifted=layers) as planted:
            wrong, _ = planted(slice(P, P + 1), lambda: model.decode_step(
                tokens[:, P], start.clone()))
        return rel(wrong, 1)
    fault_err = shifted(None)
    layer_faults = [shifted({i}) for i in range(L)]
    # the engine's path: routing freely, eager and as a CUDA graph
    free_last, cache = model.prefill(tokens[:, :P], max_len=T)
    free_prefill_err = rel(free_last, 0)
    kv = og.kv_cache_bytes(cfg, B, T, dname)
    start = cache.clone()
    before = hand_launches()
    eager, free_errs = [], []
    with MoeRouting(model) as steps:
        for t in range(n):
            logits, _ = model.decode_step(tokens[:, P + t], cache)
            eager.append(logits.clone())
            free_errs.append(rel(logits, t + 1))
    chosen = lambda r: r[..., :cfg.moe.top_k].sort(-1).values
    flips = sum(int((chosen(steps.ranked[t * L + i][:, 0])
                     != chosen(fwd.ranked[i][:, P + t])).any(-1).sum())
                for t in range(n) for i in range(L))
    graph = DecodeGraph(model, start).load(start)
    graph_errs, bitwise = [], True
    for t in range(n):
        logits = graph(tokens[:, P + t])
        graph_errs.append(rel(logits, t + 1))
        bitwise = bitwise and bool(torch.equal(logits, eager[t]))
    in_step = launches_since(before)
    tok = tokens[:, T - 1].contiguous()

    def eager_step():
        cache.pos.fill_(T - 1)
        return model.decode_step(tok, cache)

    def graph_step():
        graph.cache.pos.fill_(T - 1)
        return graph(tok)

    eager_s, graph_s = profiler.measure(eager_step), profiler.measure(graph_step)
    graph_trace = forward_trace(graph_step)
    predicted, rows = pm.predict_ops(og.enumerate_decode_ops(
        cfg, B, T, dtype=dname))
    by_kind = {}
    for r in rows:
        by_kind[r.kind] = by_kind.get(r.kind, 0.0) + r.seconds * 1e3
    weight_bytes = sum(p.nbytes for p in model.parameters())
    floor = (weight_bytes + kv) / H100_SXM.hbm_bw * 1e3
    tol = moe_step_tol(cfg)
    checks = {"prefill_logits_ok": prefill_err <= tol,
              "logits_ok": max(errs) <= tol,
              "graph_bitwise": bitwise,
              "no_pair_dropped": max(fwd.shares) == 0.0,
              "planted_fault_caught": fault_err > tol,
              "planted_mid_layer_fault_caught": layer_faults[L // 2] > tol,
              "cache_bytes_ok": cache.nbytes == kv,
              "no_hand_launch_in_step": not in_step}
    rec = {"arch": cfg.name, "dtype": dname, "n_layers": cfg.n_layers,
           "batch": B, "prompt": P, "steps": n, "capacity": cache.capacity,
           "capacity_factor": cfg.moe.capacity_factor,
           "forward_capacity": moe_mod.expert_capacity(T, cfg.moe),
           "step_capacity": moe_mod.expert_capacity(1, cfg.moe),
           "prefill_logits_rel_err": prefill_err,
           "logits_rel_err": max(errs), "logits_rel_err_by_step": errs,
           "logits_tol": tol, "planted_fault_rel_err": fault_err,
           "one_layer_fault_rel_err_by_layer": layer_faults,
           "one_layer_faults_caught": sum(e > tol for e in layer_faults),
           "forced_own_choice_differs": forced.differ,
           "free_prefill_logits_rel_err": free_prefill_err,
           "free_logits_rel_err": max(free_errs),
           "free_graph_logits_rel_err": max(graph_errs),
           "free_logits_rel_err_by_step": free_errs,
           "routing_flips": flips, "routing_decisions": n * L * B,
           "hand_launches_in_step": in_step,
           "cache_bytes": cache.nbytes, "kv_cache_bytes": kv,
           "eager_ms": eager_s * 1e3, "graph_ms": graph_s * 1e3,
           "weight_bytes": weight_bytes, "bytes_floor_ms": floor,
           "predicted_step_ms": predicted * 1e3,
           "predicted_ms_by_kind": by_kind,
           "err_pct": 100 * abs(predicted - graph_s) / graph_s,
           "graph_trace": graph_trace, "checks": checks,
           "failed": [k for k, ok in checks.items() if not ok]}
    emit("moe_decode", **rec)
    return rec


def moe_serve(pm):
    """(f) The ``serve`` launcher's engine at MOE_SERVE_ARGS: moonshot at
    full depth in bf16 (built in its dtype), 8 prompts of 64 tokens, 32
    new each, in two waves of 4, greedy.  Fails unless every request ends
    with its 32 tokens, the flash kernel launched once a layer a wave (the
    prefill's), all at hd 128, and every served token equals eager steps'
    (``check_served``, run after the launches are read).  Prices the
    prompt and the decode steps over the contexts they ran at."""
    args = serve_launcher.parse_args(MOE_SERVE_ARGS)
    cfg = dataclasses.replace(cfg_registry.get(MOE),
                              compute_dtype=args.compute_dtype)
    before = hand_launches()
    engine, done = serve_launcher.serve(args)
    since = launches_since(before)
    flash = since.get("flash_attention", 0)
    out = serve_launcher.summary(engine, done)
    served = check_served(engine, done)
    dt = args.compute_dtype
    prefill_s, _ = pm.predict_model(cfg, args.max_batch, args.prompt_len,
                                    dtype=dt)
    ctxs = range(args.prompt_len + 1, args.prompt_len + args.max_new)
    step_s = float(np.mean([pm.predict_ops(og.enumerate_decode_ops(
        cfg, args.max_batch, c, dtype=dt))[0] for c in ctxs]))
    st = engine.stats
    want_flash = cfg.n_layers * -(-args.requests // args.max_batch)
    failed = [] if sorted({len(r.out_tokens) for r in done}) == [
        args.max_new] else ["tokens each"]
    failed += [] if flash == since.get("flash_attention@hd128", 0) \
        == want_flash else [f"{flash} flash launches, expected {want_flash}"
                            f" at hd 128"]
    failed += [f"requests unlike the eager steps {served['mismatched']}"] \
        if served["mismatched"] else []
    rec = {**out, "requests": len(done), "prefills": st.prefills,
           "capacity": engine.max_len,
           "ttft_p50_ms": st.ttft_p50 * 1e3, "ttft_p95_ms": st.ttft_p95 * 1e3,
           "tpot_p50_ms": st.tpot_p50 * 1e3, "tpot_p95_ms": st.tpot_p95 * 1e3,
           "flash_launches": flash, "served_vs_eager": served,
           "predicted_prefill_ms": prefill_s * 1e3,
           "predicted_decode_step_ms": step_s * 1e3,
           "wall_s": engine.wall_s, "failed": failed}
    emit("moe_serve", **rec)
    del engine
    return rec


def phase_archs(store):
    """The dense archs no other phase runs: ARCHS at full width, at
    ARCHS_RUNS' dtypes and depths, each built from seed 0 on the card and
    freed before the next (its build's seconds, its weights' bytes beside
    ``param_count``'s, its peak).  (b) The forward at ARCHS_FORWARD:
    finite logits of the padded vocab and exactly the flash launches its
    layers make (``archs_flash``: gemma-7b's all at hd 256, the others' at
    hd 128, llama-3.2-vision-11b's cross calls non-causal), its time and
    trace against ``predict_model`` (``archs_forward``).  (c) Decode at
    ARCHS_DECODE_CTXS (``decode_record``: DECODE_CHECKS at
    ``archs_step_tol``, no hand launch in the step), over a seeded context
    where the arch takes one.  (d) The launcher's bf16 engine for each arch,
    every token held against eager steps (``archs_serve``).  The flash
    kernel is held against its plain version at this path's shapes by
    ``check_flash`` ((a), ``archs_path_cases``) and timed at each arch's
    (8, 512) in the ``kernels`` line ((e), ``archs``).  Returns the
    records and each arch's hand launches (``launches_by_arch``).  Fails if
    a check of (b)-(d) fails."""
    t0 = time.perf_counter()
    pm = PM2Lat(store, store.meta["device"])
    gen = torch.Generator(device="cuda").manual_seed(9)
    builds, forwards, decodes, serves = [], [], [], []
    launches = {arch: {} for arch in ARCHS}

    def count(arch, before):
        for k, n in launches_since(before).items():
            launches[arch][k] = launches[arch].get(k, 0) + n

    for arch, dname, n_layers in ARCHS_RUNS:
        before = hand_launches()
        torch.cuda.empty_cache()
        full = cfg_registry.get(arch)
        cfg = dataclasses.replace(full, compute_dtype=dname, n_layers=n_layers)
        dt = getattr(torch, dname)
        torch.cuda.reset_peak_memory_stats()
        t_build = time.perf_counter()
        model = model_registry.build(cfg, device="cuda", seed=0, dtype=dt)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in model.parameters())
        builds.append({"arch": arch, "dtype": dname, "n_layers": n_layers,
                       "full_layers": full.n_layers,
                       "build_s": time.perf_counter() - t_build,
                       "weight_bytes": sum(p.nbytes
                                           for p in model.parameters()),
                       "param_count_bytes": cfg.param_count() * dt.itemsize,
                       "n_params": n, "param_count": cfg.param_count(),
                       "build_peak_bytes": torch.cuda.max_memory_allocated()})
        emit("archs_build", **builds[-1])
        B, S = ARCHS_FORWARD
        with torch.no_grad():
            tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                   device="cuda")
            forwards.append(archs_forward(model, pm, cfg, tokens,
                                          model.make_ctx(B, gen)))
            for ctx in ARCHS_DECODE_CTXS[dname]:
                tokens = torch.randint(0, cfg.vocab_size, (B, ctx),
                                       generator=gen, device="cuda")
                rec = decode_record(model, pm, cfg, tokens,
                                    model.make_ctx(B, gen),
                                    archs_step_tol(cfg))
                rec = {"arch": arch, "n_layers": n_layers, **rec,
                       "failed": decode_failures(rec)}
                emit("archs_decode", **rec)
                decodes.append(rec)
        del model
        count(arch, before)
    torch.cuda.empty_cache()
    for arch in ARCHS:
        before = hand_launches()
        serves.append(archs_serve(pm, arch))
        torch.cuda.empty_cache()
        count(arch, before)
    rec = {"builds": builds, "forwards": forwards, "decodes": decodes,
           "serves": serves, "launches_by_arch": launches,
           "seconds": time.perf_counter() - t0}
    emit("archs", seconds=rec["seconds"], launches_by_arch=launches)
    bad = [f"{kind} {r['arch']} {r['dtype']}: {r['failed']}"
           for kind, recs in (("forward", forwards), ("decode", decodes),
                              ("serve", serves))
           for r in recs if r["failed"]]
    if bad:
        raise AssertionError(f"archs: {bad}")
    return rec


def archs_step_tol(cfg) -> float:
    """The decode check's logits limit for ``cfg`` (ARCHS_REF_STEP_ERR)."""
    if cfg.compute_dtype == "float32" or cfg.n_layers <= ARCHS_TOL_LAYERS:
        return DECODE_TOL[cfg.compute_dtype]
    return ARCHS_REF_STEP_ERR[cfg.n_layers]


def archs_flash(cfg, calls=1):
    """The flash launches of ``calls`` calls over ``cfg``'s every layer, as
    ``hand_launches`` names them: one a layer, and a cross-attention
    layer's cross call besides, non-causal; all at ``cfg``'s head dim."""
    n_cross = sum(kind == C.CROSS_ATTN for kind in cfg.layer_kinds)
    n = train_attention_calls(cfg)
    want = {"flash_attention": n, f"flash_attention@hd{cfg.head_dim}": n,
            "flash_attention@causal": n - n_cross}
    if n_cross:
        want["flash_attention@noncausal"] = n_cross
    return {k: v * calls for k, v in want.items()}


def archs_forward(model, pm, cfg, tokens, ctx):
    """(b) One forward at (B, S) = ``tokens.shape`` over the context
    ``ctx`` (None for an arch that takes none): finite logits of the padded
    vocab, its hand launches exactly ``archs_flash``'s; its peak memory,
    its time (``profiler.measure``) and trace (GEMM, flash, idle, top 10)
    against ``predict_model`` (by op kind)."""
    B, S = tokens.shape
    dname = cfg.compute_dtype
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = hand_launches()
    logits = model(tokens, ctx)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    flash = launches_since(before)
    finite = bool(torch.isfinite(logits).all())
    shape = list(logits.shape)
    del logits
    measured = profiler.measure(model, tokens, ctx)
    trace = forward_trace(model, tokens, ctx)
    total, rows = pm.predict_model(cfg, B, S, dtype=dname)
    by_kind = {}
    for r in rows:
        by_kind[r.kind] = by_kind.get(r.kind, 0.0) + r.seconds * 1e3
    want = archs_flash(cfg)
    failed = [] if finite else ["logits not finite"]
    failed += [] if shape == [B, S, model.padded_vocab] else [f"shape {shape}"]
    failed += [] if flash == want else [f"launches {flash}, expected {want}"]
    rec = {"arch": cfg.name, "dtype": dname, "batch": B, "seq": S,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "context": None if ctx is None else list(ctx.shape),
           "logits_shape": shape, "logits_finite": finite,
           "launches_per_forward": flash, "peak_mem_gb": peak / 1e9,
           "measured_ms": measured * 1e3, "predicted_ms": total * 1e3,
           "err_pct": 100 * abs(total - measured) / measured,
           "predicted_ms_by_kind": by_kind,
           "top5_predicted": [[r.name, r.kernel, r.seconds * 1e3] for r in
                              sorted(rows, key=lambda r: -r.seconds)[:5]],
           "device_trace": trace, "failed": failed}
    emit("archs_forward", **rec)
    return rec


def archs_serve(pm, arch):
    """(d) The ``serve`` launcher's engine at ARCHS_SERVE_ARGS for ``arch``
    at full depth in bf16 (built in its dtype): 4 prompts of 64 tokens, 16
    new each, in one wave, greedy, over the engine's context where the arch
    takes one.  Fails unless every request ends with its 16 tokens, the
    hand launches are exactly ``archs_flash``'s a wave (the prefill's), and
    every served token equals eager steps' (``check_served``, run after the
    launches are read).  Prices the prompt and the decode steps over the
    contexts they ran at."""
    args = serve_launcher.parse_args(["--arch", arch, *ARCHS_SERVE_ARGS])
    cfg = dataclasses.replace(cfg_registry.get(arch),
                              compute_dtype=args.compute_dtype)
    before = hand_launches()
    engine, done = serve_launcher.serve(args)
    since = launches_since(before)
    out = serve_launcher.summary(engine, done)
    served = check_served(engine, done)
    dt = args.compute_dtype
    prefill_s, _ = pm.predict_model(cfg, args.max_batch, args.prompt_len,
                                    dtype=dt)
    ctxs = range(args.prompt_len + 1, args.prompt_len + args.max_new)
    step_s = float(np.mean([pm.predict_ops(og.enumerate_decode_ops(
        cfg, args.max_batch, c, dtype=dt))[0] for c in ctxs]))
    st = engine.stats
    want = archs_flash(cfg, -(-args.requests // args.max_batch))
    failed = [] if sorted({len(r.out_tokens) for r in done}) == [
        args.max_new] else ["tokens each"]
    failed += [] if since == want else [f"launches {since}, expected {want}"]
    failed += [f"requests unlike the eager steps {served['mismatched']}"] \
        if served["mismatched"] else []
    rec = {"arch": arch, "dtype": dt, **out, "requests": len(done),
           "prefills": st.prefills, "capacity": engine.max_len,
           "ttft_p50_ms": st.ttft_p50 * 1e3, "ttft_p95_ms": st.ttft_p95 * 1e3,
           "tpot_p50_ms": st.tpot_p50 * 1e3, "tpot_p95_ms": st.tpot_p95 * 1e3,
           "launches": since, "served_vs_eager": served,
           "predicted_prefill_ms": prefill_s * 1e3,
           "predicted_decode_step_ms": step_s * 1e3,
           "wall_s": engine.wall_s, "failed": failed}
    emit("archs_serve", **rec)
    del engine
    return rec


def archs_launch_faults(by_arch, total):
    """What is wrong with the archs path's hand launches: each arch's must
    be flash forwards only, all at its head dim (gemma-7b's at 256, the
    others' at 128), causal but for llama-3.2-vision-11b's cross calls
    (``archs_flash``'s keys: no backward, no matmul), and their sum the
    path's count.  Each call's own count is held by the record that made
    it (``archs_forward``, ``archs_serve``)."""
    bad = []
    for arch, got in by_arch.items():
        cfg = cfg_registry.get(arch)
        n = got.get("flash_attention", 0)
        mask = got.get("flash_attention@causal", 0) \
            + got.get("flash_attention@noncausal", 0)
        if (set(got) != set(archs_flash(cfg)) or not n or mask != n
                or got[f"flash_attention@hd{cfg.head_dim}"] != n):
            bad.append(f"{arch}: {got}")
    summed = {}
    for got in by_arch.values():
        for k, n in got.items():
            summed[k] = summed.get(k, 0) + n
    if summed != {k: n for k, n in total.items() if n}:
        bad.append(f"the arch counts sum to {summed}, the path's are {total}")
    return bad


def phase_xlstm(store):
    """xlstm-1.3b at full width, float32 then bf16, each built from seed 0
    on the card and freed before the next.  (b) the forward at
    XLSTM_FORWARDS, measured and against the store's prediction, with the
    time its mLSTM and sLSTM layers take (``xlstm_forward``); (c) decode
    steps against the forward, the layers alone against theirs, the graph
    against the eager steps and (d) a conv state left stale, which the
    float32 layer check must reject (``xlstm_decode``); (e) the launcher's
    bf16 engine over two waves, every token held against eager steps
    (``xlstm_serve``).  The path launches no hand kernel: the model's
    products are ``torch.matmul`` and it has no attention.  Fails if a
    check of (b)-(e) fails or a hand kernel launched."""
    t0 = time.perf_counter()
    cfg0 = cfg_registry.get(XLSTM)
    pm = PM2Lat(store, store.meta["device"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    builds, forwards, decodes = [], [], []
    for dname in DTYPES:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        t_build = time.perf_counter()
        model = model_registry.build(cfg, device="cuda", seed=0,
                                     dtype=getattr(torch, dname))
        torch.cuda.synchronize()
        builds.append({"dtype": dname, "build_s": time.perf_counter()
                       - t_build, "parameters": sum(
                           p.numel() for p in model.parameters()),
                       "weight_bytes": sum(p.nbytes
                                           for p in model.parameters())})
        with torch.no_grad():
            for j, (B, S) in enumerate(XLSTM_FORWARDS[dname]):
                tokens = torch.randint(0, cfg.vocab_size, (B, S),
                                       generator=gen, device="cuda")
                forwards.append(xlstm_forward(
                    model, pm, cfg, tokens, first=j == 0,
                    trace=j == 0 and dname == "bfloat16"))
            tokens = torch.randint(0, cfg.vocab_size,
                                   (XLSTM_BATCH, XLSTM_PROMPT + XLSTM_STEPS),
                                   generator=gen, device="cuda")
            decodes.append(xlstm_decode(model, pm, cfg, tokens))
        del model
    gc.collect()
    torch.cuda.empty_cache()
    served = xlstm_serve(pm)
    gc.collect()
    torch.cuda.empty_cache()
    launched = {k: n for k, n in hand_launches().items() if n}
    rec = {"builds": builds, "forwards": forwards, "decodes": decodes,
           "serve": served, "hand_launches": launched,
           "seconds": time.perf_counter() - t0}
    emit("xlstm", builds=builds, hand_launches=launched,
         seconds=rec["seconds"])
    bad = [f"forward {r['dtype']} {r['batch']}x{r['seq']}: {r['failed']}"
           for r in forwards if r["failed"]]
    bad += [f"decode {r['dtype']}: {r['failed']}" for r in decodes
            if r["failed"]]
    bad += [f"serve: {served['failed']}"] if served["failed"] else []
    bad += [f"hand kernels launched: {launched}"] if launched else []
    if bad:
        raise AssertionError(f"xlstm: {bad}")
    return rec


def kind_split(model, fn, *args):
    """One call of ``fn`` with a CUDA event before and after it and each
    block: (its output, {block kind: ms summed over its layers}, the
    call's ms).  The events are recorded as the host reaches them, so a
    host-bound layer's time is its span on the device, idle gaps
    included."""
    marks = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def mark(kind):
        def hook(*_):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            marks.append((kind, event))
        return hook

    hooks = [h for blk in model.blocks for h in (
        blk.register_forward_pre_hook(mark(blk.kind)),
        blk.register_forward_hook(mark(None)))]
    start.record()
    try:
        out = fn(*args)
    finally:
        for h in hooks:
            h.remove()
    end.record()
    torch.cuda.synchronize()
    split = {}
    for (kind, a), (_, b) in zip(marks[::2], marks[1::2]):
        split[kind] = split.get(kind, 0.0) + a.elapsed_time(b)
    return out, split, start.elapsed_time(end)


def xlstm_forward(model, pm, cfg, tokens, first, trace):
    """(b) One forward at (B, S) = ``tokens.shape``: finite logits of the
    padded vocab; the time its mLSTM and sLSTM layers take and their
    share of that call (``kind_split``); its time against
    ``predict_model`` (the share of the
    price each layer kind's rows take).  The ``first`` forward of a dtype
    is timed by ``profiler.measure``, a later one, of seconds, by one call
    (``calls_ms``); with ``trace``, where its device time goes
    (``forward_trace``: a profiled forward at (8, 512) takes ~20 s to
    read back, so only bf16's, where the host sets the pace, is
    traced)."""
    t0 = time.perf_counter()
    B, S = tokens.shape
    dname = cfg.compute_dtype
    logits, split, split_ms = kind_split(model, model, tokens)
    finite = bool(torch.isfinite(logits).all())
    shape = list(logits.shape)
    del logits
    measured = profiler.measure(model, tokens) if first else \
        calls_ms(model, tokens) / 1e3
    total, rows = pm.predict_model(cfg, B, S, dtype=dname)
    by_kind = {}
    for r in rows:
        kind = r.name.split(".")[0]
        by_kind[kind] = by_kind.get(kind, 0.0) + r.seconds * 1e3
    failed = [] if finite else ["logits not finite"]
    failed += [] if shape == [B, S, model.padded_vocab] else [f"shape {shape}"]
    rec = {"dtype": dname, "batch": B, "seq": S, "n_layers": cfg.n_layers,
           "logits_shape": shape, "logits_finite": finite,
           "measured_ms": measured * 1e3, "layer_ms_by_kind": split,
           "split_call_ms": split_ms,
           "layer_share_by_kind": {k: v / split_ms for k, v in split.items()},
           "predicted_ms": total * 1e3,
           "err_pct": 100 * abs(total - measured) / measured,
           "predicted_ms_by_kind": by_kind,
           "top5_predicted": [[r.name, r.kernel, r.seconds * 1e3] for r in
                              sorted(rows, key=lambda r: -r.seconds)[:5]],
           "timed_by": "profiler.measure" if first else "calls_ms",
           "device_trace": forward_trace(model, tokens) if trace
           else "not traced", "failed": failed}
    rec["seconds"] = time.perf_counter() - t0
    emit("xlstm_forward", **rec)
    return rec


def calls_ms(fn, *args):
    """One call timed by CUDA events (after ``kind_split``'s call of the
    same shape)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def rel_err(got, want, scale=None) -> float:
    """max |got - want| / ``scale`` (by default max |want|), in float32."""
    w = want.float()
    scale = w.abs().max() if scale is None else scale
    return float((got.float() - w).abs().max() / scale)


def state_errs(cache, other):
    """Per state tensor kind of the xLSTM layers (mLSTM C, n, m, conv;
    sLSTM c, n, h, m): the largest over the layers of ``rel_err`` of
    ``cache``'s against ``other``'s."""
    out = {}
    for i, kind in enumerate(cache_kinds(cache)):
        names = ("C", "n", "m", "conv") if kind == C.MLSTM else \
            ("c", "n", "h", "m")
        for name, a, b in zip(names, cache.layer(i), other.layer(i)):
            out[name] = max(out.get(name, 0.0), rel_err(a, b))
    return out


def cache_kinds(cache):
    return [C.MLSTM if cache.C[i] is not None else C.SLSTM
            for i in range(len(cache.C))]


def xlstm_decode(model, pm, cfg, tokens):
    """(c) The forward over all T tokens of ``tokens`` (B, T), each
    layer's mixer input captured; a prefill of XLSTM_PROMPT, then T -
    XLSTM_PROMPT decode steps eagerly and as a replayed CUDA graph: the
    prefill's and each step's logits against the forward's at that
    position (``rel_err`` over max |forward logits| from position
    XLSTM_PROMPT - 1, as the JAX package's drift is read; within
    XLSTM_STEP_TOL), the graph equal to the
    eager steps bit for bit, no hand kernel launched, and the states after
    the steps against a prefill of all the tokens (reported beside the JAX
    package's XLSTM_REF_STATE_ERR).  Each layer alone (``xlstm_layers``):
    in float32 within XLSTM_LAYER_TOL and XLSTM_LAYER_STATE_TOL, in bf16
    reported.  (d) The middle
    mLSTM layer's conv state left stale for the second step: the float32
    layer check must reject that step; its bf16 error, its state error
    after the steps and its effect on the whole model's logits are
    reported.  Times both steps (the graph's is
    the one predicted) against ``enumerate_decode_ops``'s price and the
    bytes floor: the weights read and every C read and written once.  The
    cache held against ``kv_cache_bytes``."""
    t0 = time.perf_counter()
    dname = cfg.compute_dtype
    B, T = tokens.shape
    P, n = XLSTM_PROMPT, T - XLSTM_PROMPT
    inputs = {}
    hooks = [getattr(blk, blk._mixer()).register_forward_pre_hook(
        lambda m, a, i=i: inputs.__setitem__(i, a[0]))
        for i, blk in enumerate(model.blocks)]
    try:
        want = model(tokens)[:, P - 1:].float().clone()
    finally:
        for h in hooks:
            h.remove()
    scale = want.abs().max()
    at = lambda x, t: rel_err(x, want[:, t], scale)
    last, cache = model.prefill(tokens[:, :P])
    prefill_err = at(last, 0)
    start = cache.clone()
    before = hand_launches()
    eager, errs = [], []
    for t in range(n):
        logits, _ = model.decode_step(tokens[:, P + t], cache)
        eager.append(logits.clone())
        errs.append(at(logits, t + 1))
    seeded = model.prefill(tokens)[1]
    states = state_errs(cache, seeded)
    del seeded
    kinds = cache_kinds(cache)
    fault_layer = [i for i, k in enumerate(kinds) if k == C.MLSTM][
        kinds.count(C.MLSTM) // 2]
    stale = start.clone()
    model.decode_step(tokens[:, P], stale)
    conv = stale.conv[fault_layer]
    conv.copy_(start.conv[fault_layer])
    fault_model_err = at(model.decode_step(tokens[:, P + 1], stale)[0], 2)
    del stale, conv
    graph = DecodeGraph(model, start).load(start)
    graph_errs, bitwise = [], True
    for t in range(n):
        logits = graph(tokens[:, P + t])
        graph_errs.append(at(logits, t + 1))
        bitwise = bitwise and bool(torch.equal(logits, eager[t]))
    in_step = launches_since(before)
    del eager
    layers = xlstm_layers(model, cfg, inputs, P, n, fault_layer)
    inputs.clear()
    tok = tokens[:, T - 1].contiguous()

    def eager_step():
        return model.decode_step(tok, cache)

    eager_s = profiler.measure(eager_step)
    graph_s = profiler.measure(graph, tok)
    graph_trace = forward_trace(graph, tok)
    predicted, rows = pm.predict_ops(og.enumerate_decode_ops(cfg, B, T,
                                                             dtype=dname))
    weight_bytes = sum(p.nbytes for p in model.parameters())
    c_bytes = sum(t.nbytes for t in cache.C if t is not None)
    floor_ms = (weight_bytes + 2 * c_bytes) / H100_SXM.hbm_bw * 1e3
    priced = og.kv_cache_bytes(cfg, B, T, dname)
    ltol, stol = XLSTM_LAYER_TOL, XLSTM_LAYER_STATE_TOL
    tol = XLSTM_STEP_TOL[dname]
    checks = {"prefill_logits_ok": prefill_err <= tol,
              "logits_ok": max(errs + graph_errs) <= tol,
              "graph_bitwise": bitwise,
              "no_hand_launch_in_step": not in_step}
    if dname == "float32":
        checks.update({
            "layer_steps_ok": layers["step_rel_err"] <= ltol,
            "layer_states_ok": max(layers["state_rel_err"].values()) <= stol,
            "planted_fault_caught": layers["fault"]["step_rel_err"] > ltol})
    rec = {"dtype": dname, "batch": B, "prompt": P, "steps": n,
           "prefill_logits_rel_err": prefill_err,
           "logits_rel_err": max(errs), "graph_logits_rel_err":
           max(graph_errs), "logits_rel_err_by_step": errs,
           "logits_tol": tol, "state_rel_err": states,
           "ref_state_rel_err": XLSTM_REF_STATE_ERR[dname],
           "layers": layers, "layer_tol": ltol if dname == "float32"
           else "reported", "layer_state_tol": stol if dname == "float32"
           else "reported",
           "planted_fault_layer": fault_layer,
           "planted_fault_rel_err": layers["fault"]["step_rel_err"],
           "planted_fault_state_rel_err": layers["fault"]["state_rel_err"],
           "planted_fault_model_rel_err": fault_model_err,
           "hand_launches_in_step": in_step,
           "cache_bytes": cache.nbytes, "kv_cache_bytes_predictor": priced,
           "cache_over_priced": cache.nbytes / priced,
           "c_state_bytes": c_bytes, "weight_bytes": weight_bytes,
           "eager_ms": eager_s * 1e3, "graph_ms": graph_s * 1e3,
           "predicted_step_ms": predicted * 1e3,
           "err_pct": 100 * abs(predicted - graph_s) / graph_s,
           "top5_predicted": [[r.name, r.kernel, r.seconds * 1e3] for r in
                              sorted(rows, key=lambda r: -r.seconds)[:5]],
           "bytes_floor_ms": floor_ms, "floor_share": floor_ms
           / (graph_s * 1e3), "graph_trace": graph_trace, "checks": checks,
           "failed": [k for k, ok in checks.items() if not ok],
           "seconds": time.perf_counter() - t0}
    emit("xlstm_decode", **rec)
    del graph, cache, start
    return rec


def xlstm_layers(model, cfg, inputs, P, n, fault_layer):
    """Each layer's mixer alone on ``inputs[i]``, the normed input the
    forward gave it (B, P + n, d): its forward over all of them, a prefill
    of P, then n steps on the rest, eagerly.  Returns the largest step
    error (``rel_err`` against the forward's outputs over their max from
    position P) and
    each state's (against the forward's state) over the layers, the error
    by layer, and layer ``fault_layer``'s steps with the conv state put
    back after the first step (stale for the second): the second step's
    error and the largest of its states' after the steps."""
    cdt = getattr(torch, cfg.compute_dtype)
    by_layer, states, fault = [], {}, None
    for i, blk in enumerate(model.blocks):
        mixer = getattr(blk, blk._mixer())
        h = inputs[i]
        y_all, full = mixer(h, cdt)
        ref = y_all[:, P:].float()
        scale = ref.abs().max()
        del y_all
        _, state = mixer(h[:, :P], cdt)
        start = tuple(t.clone() for t in state) if i == fault_layer else None
        errs = [rel_err(mixer.step(h[:, P + t:P + t + 1], *state, cdt)[:, 0],
                        ref[:, t], scale) for t in range(n)]
        by_layer.append(max(errs))
        names = ("C", "n", "m", "conv") if blk.kind == C.MLSTM else \
            ("c", "n", "h", "m")
        for name, a, b in zip(names, state, full):
            states[name] = max(states.get(name, 0.0), rel_err(a, b))
        if start is not None:
            conv, errs = start[3].clone(), []
            for t in range(n):
                y = mixer.step(h[:, P + t:P + t + 1], *start, cdt)[:, 0]
                if t == 0:
                    start[3].copy_(conv)
                errs.append(rel_err(y, ref[:, t], scale))
            fault = {"step_rel_err": errs[1], "state_rel_err": max(
                rel_err(a, b) for a, b in zip(start, full))}
    return {"step_rel_err": max(by_layer), "state_rel_err": states,
            "step_rel_err_by_layer": by_layer, "fault": fault}


def xlstm_serve(pm):
    """(e) The ``serve`` launcher's engine at XLSTM_SERVE_ARGS: 8 prompts
    of 512 tokens, 16 new each, in two waves of 4, greedy, bf16, its
    decode step a CUDA graph.  Fails unless every request ends with its 16
    tokens and every served token equals eager steps' (``check_served``).
    Prices the prompt and the decode steps over the contexts they ran
    at."""
    args = serve_launcher.parse_args(XLSTM_SERVE_ARGS)
    cfg = dataclasses.replace(cfg_registry.get(XLSTM),
                              compute_dtype=args.compute_dtype)
    engine, done = serve_launcher.serve(args)
    out = serve_launcher.summary(engine, done)
    served = check_served(engine, done)
    dt = args.compute_dtype
    prefill_s, _ = pm.predict_model(cfg, args.max_batch, args.prompt_len,
                                    dtype=dt)
    ctxs = range(args.prompt_len + 1, args.prompt_len + args.max_new)
    step_s = float(np.mean([pm.predict_ops(og.enumerate_decode_ops(
        cfg, args.max_batch, c, dtype=dt))[0] for c in ctxs]))
    st = engine.stats
    failed = [] if sorted({len(r.out_tokens) for r in done}) == [
        args.max_new] else ["tokens each"]
    failed += [f"requests unlike the eager steps {served['mismatched']}"] \
        if served["mismatched"] else []
    rec = {**out, "requests": len(done), "prefills": st.prefills,
           "graphs": len(engine._graphs),
           "ttft_p50_ms": st.ttft_p50 * 1e3, "ttft_p95_ms": st.ttft_p95 * 1e3,
           "tpot_p50_ms": st.tpot_p50 * 1e3, "tpot_p95_ms": st.tpot_p95 * 1e3,
           "served_vs_eager": served,
           "predicted_prefill_ms": prefill_s * 1e3,
           "predicted_decode_step_ms": step_s * 1e3,
           "wall_s": engine.wall_s, "failed": failed}
    emit("xlstm_serve", **rec)
    del engine
    return rec


def phase_paper(store, grid):
    """The paper's tables on the card, on the store phase ``calibrate``
    wrote: (a) NeuSight trained per dtype (training seconds, in-sample
    error); (b) Table II; (c) Table IV over PAPER_MODELS at PAPER_BATCHES x
    PAPER_SEQ in both dtypes, each model freed before the next; (d) Fig. 3
    in both dtypes; (e) the partition application; (f) the planner CLI at
    PAPER_PLAN_ARGS against ``plan_stages`` over ``predict_blocks``; (g)
    NeuSight's µs a prediction beside phase ``grid``'s PM2Lat µs; (h)
    ``HabitatScaler`` at ratios 1 against PM2Lat on every Table IV op list
    (each row's seconds equal, the total their left-to-right sum); (i)
    roofline's peak against the store's best matmul anchor.  Errors are
    reported; fails on a non-finite or non-positive time, a forward whose
    flash launches are not one per attention layer, logits not finite, or
    an identity (f, h, i) unequal."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = store.meta["device"]
    pm = PM2Lat(store, dev)
    bad = []
    positive = lambda *xs: all(np.isfinite(x) and x > 0 for x in xs)
    rec = {"allocated_at_start_bytes": torch.cuda.memory_allocated(),
           "l2_correction": pm.memory_model.cache is not None}

    # (a) NeuSight, one model a dtype
    t = time.perf_counter()
    mem_samples = memmod.collect_utility_samples(device="cuda")
    rec["neusight_mem_samples_s"] = time.perf_counter() - t
    neusight, rec["neusight"] = {}, []
    for dname in DTYPES:
        t = time.perf_counter()
        samples = ns.collect_matmul_dataset(PAPER_NS_SAMPLES, dtype=dname,
                                            seed=0, device="cuda")
        t_collect = time.perf_counter() - t
        t = time.perf_counter()
        model = ns.train(samples, mem_samples,
                         peak_flops=best_matmul_anchor(store, dname),
                         steps=PAPER_NS_STEPS, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t
        neusight[dname] = model
        rec.setdefault("neusight_paths", {})[dname] = path = str(
            OUT / f"neusight_{dname}.pt")
        torch.save(model.state(), path)
        err = [abs(model.predict_matmul(s["m"], s["n"], s["k"])
                   - s["duration"]) / s["duration"] for s in samples]
        mem_err = [abs(model.predict_memory(s["features"]) - s["duration"])
                   / s["duration"] for s in mem_samples]
        rec["neusight"].append({
            "dtype": dname, "samples": len(samples),
            "mem_samples": len(mem_samples), "steps": PAPER_NS_STEPS,
            "collect_s": t_collect, "train_s": t_train,
            "peak_flops": model.peak_flops,
            "in_sample_mean_err_pct": 100 * float(np.mean(err)),
            "in_sample_mem_mean_err_pct": 100 * float(np.mean(mem_err)),
            "device": str(model.device)})
        if not positive(*(s["duration"] for s in samples)):
            bad.append(f"neusight {dname}: a sample's time is not positive")
    emit("paper_neusight", mem_samples_s=rec["neusight_mem_samples_s"],
         models=rec["neusight"])

    # (b) Table II
    t2 = table2.run(store, neusight, samples_per_layer=PAPER_TABLE2_SAMPLES,
                    device="cuda")
    rec["table2"] = t2
    mean_over_layers = {d: {k: float(np.mean([e[k]["mean"] for e in
                                              t2["errors"][d].values()]))
                            for k in table2.PREDICTORS} for d in DTYPES}
    emit("paper_table2", errors=t2["errors"],
         mean_over_layers_pct=mean_over_layers, samples=len(t2["rows"]))
    bad += [f"table2 {r['dtype']} {r['layer']} {r['shape']}: {r}"
            for r in t2["rows"] if not positive(
                r["measured_ms"], *(r[f"{k}_ms"] for k in table2.PREDICTORS))]

    # (c) Table IV
    t = time.perf_counter()
    t4 = table4.run(store, neusight, models=PAPER_MODELS,
                    batches=PAPER_BATCHES, seq=PAPER_SEQ, device="cuda")
    t4["seconds"] = time.perf_counter() - t
    rec["table4"] = t4
    summary = paper_table4_summary(t4["rows"])
    emit("paper_table4", seconds=t4["seconds"], summary=summary,
         rows=[{k: r[k] for k in ("model", "dtype", "batch", "measured_ms",
                                  "pm2lat_pct", "neusight_pct",
                                  "flops_proxy_pct", "flash_launches")}
               for r in t4["rows"]])
    for r in t4["rows"]:
        what = f"table4 {r['model']} {r['dtype']} B {r['batch']}"
        if not positive(r["measured_ms"],
                        *(r[f"{k}_ms"] for k in table4.PREDICTORS)):
            bad.append(f"{what}: a time is not finite and positive")
        if r["flash_launches"] != r["flash_calls"]:
            bad.append(f"{what}: {r['flash_launches']} flash launches, "
                       f"expected {r['flash_calls']}")
        if not r["logits_finite"]:
            bad.append(f"{what}: logits not finite")

    # (d) Fig. 3
    rec["fig3"] = {d: fig3.run(store, d) for d in DTYPES}
    emit("paper_fig3", **rec["fig3"])

    # (e) the partition application
    rec["partition"] = part = partition_app.run(store, neusight["float32"],
                                                device="cuda")
    emit("paper_partition", **part)
    if part["flash_launches"] != part["blocks"]:
        bad.append(f"partition: {part['flash_launches']} flash launches over "
                   f"{part['blocks']} blocks")
    if not positive(*part["measured_block_ms"], *part["pm2lat_block_ms"],
                    *part["neusight_block_ms"]):
        bad.append("partition: a block time is not finite and positive")

    # (f) the planner CLI
    args = plan_launcher.parse_args(PAPER_PLAN_ARGS)
    got = plan_launcher.run(args)
    cfg = (cfg_registry.reduced(args.arch) if args.reduced
           else cfg_registry.get_any(args.arch))
    want = partition.plan_stages(pm.predict_blocks(cfg, args.batch, args.seq),
                                 args.stages)
    rec["plan"] = {"args": PAPER_PLAN_ARGS, "boundaries": got.boundaries,
                   "stage_ms": [x * 1e3 for x in got.stage_times],
                   "bottleneck_ms": got.bottleneck * 1e3,
                   "equal": dataclasses.astuple(got)
                   == dataclasses.astuple(want)}
    emit("paper_plan", **rec["plan"])
    if not rec["plan"]["equal"]:
        bad.append(f"plan {got} != {want}")

    # (g) NeuSight's cost a prediction, beside PM2Lat's NAS cache
    rec["speed"] = {"device": torch.cuda.get_device_name(0)}
    for dname in DTYPES:
        model = neusight[dname]
        model.predict_matmul(512, 512, 512)
        t = time.perf_counter()
        for i in range(PAPER_NS_REPS):
            model.predict_matmul(512 + i, 512, 512)
        us = (time.perf_counter() - t) / PAPER_NS_REPS * 1e6
        pm_us = grid["speed"][f"nas_{dname}"]["us_per_prediction"]
        rec["speed"][dname] = {"neusight_us_per_prediction": us,
                               "pm2lat_us_per_prediction": pm_us,
                               "neusight_over_pm2lat": us / pm_us}
    emit("paper_speed", **rec["speed"])

    # (h) Habitat at ratios 1 is PM2Lat; (i) roofline's peak
    habitat = HabitatScaler(pm, 1.0, 1.0)
    unequal = []
    for r in t4["rows"]:
        cfg = dataclasses.replace(cfg_registry.get_any(r["model"]),
                                  compute_dtype=r["dtype"])
        ops = og.enumerate_ops(cfg, r["batch"], r["seq"], dtype=r["dtype"])
        total, rows = habitat.predict_ops(ops)
        want = [pm.predict_op(op) for op in ops]
        acc = 0.0
        for w in want:
            acc += w.seconds
        if total != acc or [(x.name, x.kind, x.seconds) for x in rows] != \
                [(x.name, x.kind, x.seconds) for x in want]:
            unequal.append([r["model"], r["dtype"], r["batch"]])
    peaks = {d: {"roofline": RooflineBaseline.from_store(store, dev, d)
                 .peak_flops, "best_anchor": best_matmul_anchor(store, d)}
             for d in DTYPES}
    rec["identities"] = {"habitat_op_lists": len(t4["rows"]),
                         "habitat_unequal": unequal, "roofline_peak": peaks}
    emit("paper_identities", **rec["identities"])
    bad += [f"habitat != pm2lat on {u}" for u in unequal]
    bad += [f"roofline peak {d}: {p}" for d, p in peaks.items()
            if p["roofline"] != p["best_anchor"] or not p["roofline"] > 0]

    rec["seconds"] = time.perf_counter() - t0
    emit("paper", seconds=rec["seconds"], failed=bad)
    if bad:
        raise AssertionError(f"paper: {bad}")
    return rec


def best_matmul_anchor(store, dname):
    """The best throughput anchor over the store's ``dname`` matmul
    tables (cuBLAS and the hand kernels)."""
    return max(max(t.anchors.values()) for t in store.tables.values()
               if t.key.op == "matmul" and t.key.dtype == dname)


def paper_table4_summary(rows):
    """Mean |signed error| (%) per dtype and predictor over Table IV's
    rows, all of them and split into the reference's models and the two
    full-width ones, with PM2Lat's error over NeuSight's (the paper's
    headline compares the two)."""
    groups = {"all": PAPER_MODELS, "reference": table4.MODELS,
              "full_width": PAPER_MODELS[len(table4.MODELS):]}
    out = {}
    for g, models in groups.items():
        for d in DTYPES:
            sel = [r for r in rows if r["dtype"] == d and r["model"] in models]
            mean = {k: float(np.mean([abs(r[f"{k}_pct"]) for r in sel]))
                    for k in table4.PREDICTORS}
            out.setdefault(g, {})[d] = {
                **{f"{k}_mean_abs_pct": v for k, v in mean.items()},
                "pm2lat_over_neusight": mean["pm2lat"] / mean["neusight"]}
    return out


def phase_train(store):
    """qwen2-0.5b at full width trained on the card, float32 then bf16
    compute (float32 weights and moments in both): (a) ``launch.train.run``
    for TRAIN_STEPS steps with the checkpoint's bytes and write seconds,
    (e) its losses finite and falling; (b) the step timed and split
    (``train_step_times``); (c) against PM2Lat's training step
    (``train_prediction``); (d) one step's gradients against the plain
    attention (``train_grad_check``); then (f) the restart run
    (``train_restart``); then every other model kind at full width
    (``train_kind`` over TRAIN_KINDS).  Fails on any check."""
    t0 = time.perf_counter()
    cfg0 = cfg_registry.get(MODEL)
    out = {"arch": MODEL, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "n_params": cfg0.param_count()}
    for dname in DTYPES:
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        rec = {"launcher": train_launch(dname)}
        rec["step"] = train_step_times(cfg)
        rec["prediction"] = train_prediction(store, cfg, rec["step"])
        rec["grads"] = train_grad_check(cfg)
        emit("train", dtype=dname, **rec)
        out[dname] = rec
    out["restart"] = train_restart()
    emit("train_restart", **out["restart"])
    out["kinds"] = {kind[0]: train_kind(store, *kind) for kind in TRAIN_KINDS}
    # one bf16 step's hand launches, each kind's
    out["launches_by_kind"] = {
        arch: rec["bfloat16"]["step"]["launches_per_step"]
        for arch, rec in [(MODEL, out), *out["kinds"].items()]}
    out["seconds"] = time.perf_counter() - t0
    emit("train", seconds=out["seconds"],
         launches_by_kind=out["launches_by_kind"])
    return out


def train_kind(store, arch, B, S, depth, lr):
    """One model kind of TRAIN_KINDS at full width (its depth cut to
    ``depth`` where given), at (B, S) and learning rate ``lr``: (a)
    ``launch.train.run`` for TRAIN_KIND_STEPS steps in bf16 for the kinds
    of TRAIN_KIND_LAUNCHER; then in each dtype (b) the step timed and
    split (``train_step_times``, warm TRAIN_KIND_WARM, timed
    TRAIN_KIND_TIMED: its losses finite and falling, two flash forwards
    and one backward a call ``train_attention_calls`` counts), (c)
    PM2Lat's training step against it (no bar; none without a ``store``,
    as ``scripts/flash_bwd_check.py --kinds`` runs it) and, for a kind
    with attention, (d) the gradients against the plain attention on the
    card (``train_grad_check``).  Each model is freed before the next is
    built.  Fails on any check."""
    t0 = time.perf_counter()
    cfg0 = cfg_registry.get(arch)
    if depth is not None:
        cfg0 = dataclasses.replace(cfg0, n_layers=depth)
    calls = train_attention_calls(cfg0)
    n = n_params(cfg0)
    # f32 weights, gradients and AdamW's two moments: 16 bytes a parameter
    rec = {"arch": arch, "batch": B, "seq": S, "n_layers": cfg0.n_layers,
           "depth_cut": depth is not None, "lr": lr, "n_params": n,
           "state_gb": 16 * n / 1e9}
    if arch in TRAIN_KIND_LAUNCHER:
        rec["launcher"] = train_launch("bfloat16", arch, B, S,
                                       TRAIN_KIND_STEPS, lr, depth)
        emit("train_kind", arch=arch, launcher=rec["launcher"])
    for dname in DTYPES:
        cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        r = {"step": train_step_times(cfg, B, S, TRAIN_KIND_WARM,
                                      TRAIN_KIND_TIMED, lr)}
        losses = r["step"]["losses"]
        r["losses_ok"] = bool(np.isfinite(losses).all()
                              and losses[-1] < losses[0])
        if not r["losses_ok"]:
            raise AssertionError(f"train {arch} {dname}: losses {losses}")
        if store is not None:
            r["prediction"] = train_prediction(store, cfg, r["step"], B, S)
        if calls:
            r["grads"] = train_grad_check(cfg, B, S)
        emit("train_kind", arch=arch, dtype=dname, **r)
        rec[dname] = r
    rec["seconds"] = time.perf_counter() - t0
    return rec


def phase_dist(train):
    """The launcher on a ``DeviceMesh`` (``scripts/torch_dist_train.py``
    under torchrun) at the training path's full width and shape: (a) one
    NCCL rank at ``--mesh 1x1`` (parameters, moments and batches DTensors,
    the flash kernels through the ``local_map`` boundary), float32 and
    bf16, DIST_ONE_STEPS steps, its float32 losses within DIST_RTOL of
    phase ``train``'s launcher at the same steps and its step time beside
    that launcher's; (b) DIST_PSUM_RANKS gloo ranks sharing the card:
    ``compressed_psum`` of CUDA tensors over them equal bit for bit to the
    host's on the same rows; (c) DIST_SERVE: one NCCL rank a model at
    ``--mesh 1x1`` serving through the sharded path, the models side by
    side (``dist_serve``), and (b) beside them.  (a)'s two dtypes run side
    by side too, so their step times are read with another process on the
    card: no time here has a limit, and each process takes tens of seconds
    to start.  Two ranks train on no card here: gloo
    carries DTensor's functional collectives on CUDA tensors into a
    segfault in this torch (``PERF.md`` §7), and NCCL takes one rank a
    card.  The hand-kernel launches are counted in the rank processes,
    from 0, and summed (``launches``).  Fails on any check."""
    t0 = time.perf_counter()
    runs, launches = [], {"matmul": 0, "flash_attention": 0,
                          "flash_attention_bwd": 0}
    with cf.ThreadPoolExecutor(1) as pool:
        psum_run = pool.submit(dist_launch, DIST_PSUM_RANKS, [
            "--psum-check", "--dist-backend", "gloo"], "psum")
        serve = dist_serve()
        psum_recs = psum_run.result()
    for rec in serve:
        for part in ("plain_launches", "mesh_launches"):
            for k in ("matmul", "flash_attention"):
                launches[k] += rec[part][k]
    with cf.ThreadPoolExecutor(len(DTYPES)) as pool:
        one = {dname: pool.submit(dist_launch, 1, [
            "--", "--arch", MODEL, "--steps", str(DIST_ONE_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--compute-dtype",
            dname, "--mesh", "1x1"], f"1x1_{dname}") for dname in DTYPES}
    for dname in DTYPES:
        recs = one[dname].result()
        rec = dist_record(recs, dname, train[dname]["launcher"])
        emit("dist", **rec)
        runs.append(rec)
        for k, n in recs[0]["launches"].items():
            launches[k] += n
    psum = {"ranks": len(psum_recs), "backend": psum_recs[0]["backend"],
            "devices": [r["device"] for r in psum_recs],
            "by_rank": [r["psum"] for r in psum_recs]}
    psum["ok"] = all(p["bit_equal"] for p in psum["by_rank"])
    emit("dist_psum", **psum)
    if not psum["ok"]:
        raise AssertionError(f"dist: compressed_psum on the card differs "
                             f"from the host's: {psum}")
    here = hand_launches()
    if any(here.values()):
        raise AssertionError(f"phase dist launched in the parent: {here}")
    return {"runs": runs, "psum": psum, "serve": serve,
            "launches": launches, "seconds": time.perf_counter() - t0}


def dist_serve():
    """DIST_SERVE, one torchrun of ``scripts/torch_dist_serve.py`` (1x1) a
    model, all started together: each rank record with its checks (finite
    logits; the prefill's logits and caches and every step's logits within
    DECODE_TOL of the model without a mesh; the sharded run's flash
    launches those of the run without a mesh, at least one a layer, all at
    the model's head dim)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    t0 = time.perf_counter()
    try:
        for arch, depth, dname, _ in DIST_SERVE:
            prefix = OUT / f"dist_serve_{arch}_rank"
            for old in OUT.glob(f"dist_serve_{arch}_rank*.json"):
                old.unlink()
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node", "1",
                   str(DIST_SERVE_SCRIPT), "--record", str(prefix),
                   "--arch", arch, "--compute-dtype", dname, "--batch",
                   str(DIST_SERVE_BATCH), "--prompt", str(DIST_SERVE_PROMPT),
                   "--steps", str(DIST_SERVE_STEPS)]
            if depth:
                cmd += ["--n-layers", str(depth)]
            log = open(OUT / f"dist_serve_{arch}.log", "w")
            procs[arch] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT,
                                            env=env, cwd=ROOT), log, prefix)
        for arch, (proc, log, _) in procs.items():
            code = proc.wait(timeout=max(
                DIST_TIMEOUT - (time.perf_counter() - t0), 1))
            if code:
                raise AssertionError(
                    f"dist serve {arch}: exit {code}\n"
                    f"{(OUT / f'dist_serve_{arch}.log').read_text()[-4000:]}")
    finally:
        for proc, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    out = []
    for arch, depth, dname, hd in DIST_SERVE:
        rec = json.loads(Path(f"{procs[arch][2]}0.json").read_text())
        cfg = cfg_registry.get(arch)
        n_layers = depth or cfg.n_layers
        flash = rec["mesh_launches"]
        tol = DECODE_TOL[dname]
        rec["checks"] = {
            "finite": rec["finite"],
            "prefill_within_tol": rec["prefill_err"] < tol,
            "cache_within_tol": rec["cache_err"] < tol,
            "steps_within_tol": max(rec["step_errs"]) < tol,
            "flash_as_unsharded": flash == rec["plain_launches"],
            "flash_every_layer": flash["flash_attention"] >= n_layers,
            "flash_at_head_dim": set(flash["flash_by_hd"]) == {str(hd)}}
        emit("dist_serve", **rec)
        if not all(rec["checks"].values()):
            raise AssertionError(f"dist serve {arch}: {rec['checks']}: "
                                 f"{rec}")
        out.append(rec)
    return out


def phase_dryrun(train):
    """The dry run (``launch/dryrun.py``), which counts a step on meta
    tensors and launches nothing, in host processes started together:
    (a) MODEL at the training path's shape in float32 and bf16, unsharded
    and on a fake 1x1 mesh, each cell held against phase ``train``'s step
    on the card: its flash forward and backward calls equal the launches
    the wrappers counted in one step, its argument bytes equal the live
    parameters', AdamW state's and batch's, and its roofline bound
    (``roofline_terms`` on the card's datasheet, in the cell's dtype) is at
    or below the measured median step (the ratio is reported); (b) MODEL
    at DRYRUN_CELLS on the fake (32, 8) mesh, every row ``ok``; (c) each
    of DRYRUN_KINDS at DRYRUN_KIND_CELL on that mesh (expert parallelism,
    cross caches over a 'model' extent that does not divide the heads, the
    xLSTM states), every row ``ok``.  The wrappers' launches are counted
    in the dry-run processes, each cell's from where it starts, and summed
    (``launches``): all must be 0.  Fails on any check."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cell = ["--arch", MODEL, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--compute-dtype", *DTYPES]
    runs = {f"train_shape_{m}": cell + (["--device-mesh", "none"]
                                        if m == "none" else ["--mesh", m])
            for m in DRYRUN_MESHES}
    runs["production"] = ["--arch", MODEL, "--shape", *DRYRUN_CELLS]
    for arch in DRYRUN_KINDS:
        runs[f"production_{arch}"] = ["--arch", arch, "--shape",
                                      DRYRUN_KIND_CELL]
    procs = {}
    try:
        for tag, args in runs.items():
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   *args, "--json", str(OUT / f"dryrun_{tag}.json")]
            log = open(OUT / f"dryrun_{tag}.log", "w")
            procs[tag] = (subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT, env=env,
                                           cwd=ROOT), log)
        reports, seconds = {}, {}
        for tag, (proc, log) in procs.items():
            code = proc.wait(timeout=max(
                DRYRUN_TIMEOUT - (time.perf_counter() - t0), 1))
            seconds[tag] = time.perf_counter() - t0
            if code:
                raise AssertionError(
                    f"dryrun {tag}: exit {code}\n"
                    f"{(OUT / f'dryrun_{tag}.log').read_text()[-3000:]}")
            reports[tag] = json.loads((OUT / f"dryrun_{tag}.json").read_text())
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    launches = {"matmul": 0, "flash_attention": 0, "flash_attention_bwd": 0}
    for r in (r for reps in reports.values() for r in reps):
        for k, n in r["launches"].items():
            launches[k] += n
    rows = [dryrun_check(r, train) for m in DRYRUN_MESHES
            for r in reports[f"train_shape_{m}"]]
    for row in rows:
        emit("dryrun", **row)
    prod = []
    for r in (r for tag, reps in reports.items()
              if tag.startswith("production") for r in reps):
        row = {k: r[k] for k in ("arch", "shape", "mesh", "ok", "error",
                                 "compile_s", "flops_per_device",
                                 "bytes_per_device", "collectives",
                                 "ici_bytes", "memory",
                                 "kernel_calls_per_device")}
        if r["ok"]:
            row["roofline"] = dryrun_mod.roofline_terms(
                dryrun_mod.CellReport(**r), H100_SXM)
        emit("dryrun_production", **row)
        prod.append(row)
    out = {"train_shape": rows, "production": prod,
           "launches": launches, "seconds_until_done": seconds,
           "seconds": time.perf_counter() - t0}
    emit("dryrun", seconds_until_done=seconds, seconds=out["seconds"])
    bad = [r["checks"] for r in rows if not all(r["checks"].values())]
    failed = [r["shape"] for r in prod if not r["ok"]]
    if bad or failed or len(rows) != 2 * len(DRYRUN_MESHES) \
            or len(prod) != len(DRYRUN_CELLS) + len(DRYRUN_KINDS):
        raise AssertionError(f"dryrun: checks {bad}, production rows not ok "
                             f"{failed}")
    here = hand_launches()
    if any(here.values()):
        raise AssertionError(f"phase dryrun launched in the parent: {here}")
    return out


def phase_drivers(store, neusight_path):
    """The paper's other drivers (``repro_torch.benchmarks``) on the card's
    store, at the sizes of the JAX package's ``--fast`` and ``--dry-run``,
    each asserting its own self-checks: the NAS preprocessing speed (200k
    sampled configs, the full-model grid, NeuSight's µs a prediction from
    phase ``paper``'s float32 model at ``neusight_path``, which must
    exist), the fleet matrix (qwen3-mini on every
    fleet device), the strategy sweep (every point within 1e-9 of the
    per-spec loop, 1F1B never above GPipe), the serving sweep (the
    zero-decode mix equal to ``latency_query``, batched equal to the loop,
    faster), the parallel and overlap sweeps, and comm validation (every
    bundled trace within its budget, link_bw / 3 failing each, replay
    deterministic).  The drivers' own output goes to
    ``chiprun_out/drivers.log``; their records under ``chiprun_out/``.
    Fails on any check."""
    t0 = time.perf_counter()
    if not os.path.exists(neusight_path):
        raise AssertionError(f"drivers: phase paper's float32 NeuSight "
                             f"model is missing: {neusight_path}")
    with open(OUT / "drivers.log", "w") as log, \
            contextlib.redirect_stdout(log):
        nas = nas_speed.run(store, limit=200_000, device="cuda",
                            neusight_path=neusight_path)
        fleet = fleet_compare.run(store, archs=["qwen3-mini"],
                                  device="cuda")
        strategy = strategy_sweep.dry_run(store)
        serving = serving_sweep.dry_run(store)
        parallel = parallel_scaling.dry_run(store)
        pipe, train = overlap_scaling.dry_run(store)
        comm_rec = comm_validation.run(
            dry=True, path=str(OUT / "BENCH_comm_validation_dry.json"))
    out = {
        "nas": {k: nas[k] for k in ("pm2lat_us", "n_sampled",
                                    "model_grid_us_per_model",
                                    "model_grid_models", "neusight_us")},
        "fleet_ms": {dt: {dev: x * 1e3 for dev, x in row.items()}
                     for dt, row in fleet["qwen3-mini"].items()},
        "strategy": {k: strategy[k] for k in (
            "n_specs", "specs_per_sec", "speedup", "max_rel_err",
            "schedule_vs_gpipe", "best")},
        "serving": {k: serving[k] for k in (
            "n_points", "cold_points_per_sec", "warm_points_per_sec",
            "speedup", "max_rel_err")},
        "parallel": parallel, "overlap": {"pipeline": pipe,
                                          "training": train},
        "comm": {"reports": [(r["name"], r["mean_rel_err"], r["passed"])
                             for r in comm_rec["reports"]],
                 "perturbed": comm_rec["perturbed"]},
        "seconds": time.perf_counter() - t0}
    emit("drivers", **out)
    checks = {"nas": nas["n_sampled"] > 0 and nas["pm2lat_us"] > 0,
              "fleet": all(np.isfinite(x) and x > 0
                           for row in out["fleet_ms"].values()
                           for x in row.values()),
              "parallel": len(parallel) == 4,
              "overlap": len(pipe) == len(train) == 2}
    if not all(checks.values()):
        raise AssertionError(f"drivers: {checks}")
    here = hand_launches()
    if any(here.values()):
        raise AssertionError(f"phase drivers launched a hand kernel: {here}")
    return out


def dryrun_check(rep, train):
    """One train-shape dry-run cell against phase ``train``'s step in the
    cell's dtype: the row and its checks."""
    dname = rep["options"]["compute_dtype"]
    step = train[dname]["step"]
    live = sum(step["live_bytes"].values())
    launched = {k: step["launches_per_step"].get(k, 0)
                for k in ("flash_attention", "flash_attention_bwd")}
    measured_s = step["step_ms"] / 1e3
    row = {"mesh": rep["mesh"], "dtype": dname, "ok": rep["ok"],
           "error": rep["error"], "compile_s": rep["compile_s"],
           "kernel_calls": rep["kernel_calls_per_device"],
           "launches_per_step": launched,
           "argument_bytes": rep["memory"].get("argument_size_in_bytes"),
           "live_bytes": live, "flops_per_device": rep["flops_per_device"],
           "bytes_per_device": rep["bytes_per_device"],
           "jaxpr_flops_global": rep["jaxpr_flops_global"],
           "measured_step_s": measured_s}
    checks = {"ok": rep["ok"]}
    if rep["ok"]:
        terms = dryrun_mod.roofline_terms(dryrun_mod.CellReport(**rep),
                                          H100_SXM, dname)
        row.update(terms, bound_over_measured=terms["step_s_lower_bound"]
                   / measured_s)
        checks.update(
            flash_calls_equal_launches=launched == {
                k: rep["kernel_calls_per_device"].get(k, 0)
                for k in launched},
            argument_bytes_exact=row["argument_bytes"] == live,
            bound_at_or_below_step=terms["step_s_lower_bound"] <= measured_s)
    row["checks"] = checks
    return row


def dist_launch(nproc, args, tag):
    """torchrun of ``scripts/torch_dist_train.py`` with ``args`` (with a
    ``--ckpt-dir`` of its own after a launcher's): each rank's record."""
    prefix = OUT / f"dist_{tag}_rank"
    ckpt = DIST_CKPT / tag
    shutil.rmtree(ckpt, ignore_errors=True)
    for old in OUT.glob(f"dist_{tag}_rank*.json"):
        old.unlink()
    if "--" in args:
        args = args + ["--ckpt-dir", str(ckpt), "--ckpt-every",
                       str(DIST_ONE_STEPS + 1)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), str(DIST_SCRIPT), "--record",
           str(prefix), *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=DIST_TIMEOUT)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    (OUT / f"dist_{tag}.log").write_text(out.stdout + out.stderr)
    if out.returncode:
        raise AssertionError(f"dist {tag}: exit {out.returncode}\n"
                             f"{out.stderr[-4000:]}")
    return [json.loads(Path(f"{prefix}{r}.json").read_text())
            for r in range(nproc)]


def dist_record(recs, dname, ref):
    """One run's losses and step time against phase ``train``'s launcher
    (``ref``), its flash launches, checks."""
    res = recs[0]["result"]
    losses = res["losses"]
    want = ref["losses"][:len(losses)]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    step_ms = lambda r: float(np.median(r["step_seconds"][1:])) * 1e3
    rec = {"mesh": res["mesh"], "ranks": len(recs), "dtype": dname,
           "backend": recs[0]["backend"], "losses": losses,
           "train_losses": want, "rel_diff": rel,
           "step_ms": step_ms(res), "step_ms_all": res["step_seconds"],
           "train_step_ms": step_ms(ref), "wall_s": res["wall_s"],
           "launches": recs[0]["launches"], "device": recs[0]["device"]}
    checks = {"finite": bool(np.isfinite(losses).all()),
              "steps": res["steps"] == list(range(DIST_ONE_STEPS)),
              "flash_launched": recs[0]["launches"]["flash_attention"] > 0
              and recs[0]["launches"]["flash_attention_bwd"] > 0}
    if dname == "float32":
        checks["within_rtol"] = max(rel) < DIST_RTOL
    rec["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"dist 1x1 {dname}: {checks}: {rec}")
    return rec


def train_launch(dname, arch=MODEL, B=TRAIN_BATCH, S=TRAIN_SEQ,
                 steps=TRAIN_STEPS, lr=1e-3, n_layers=None):
    """``launch.train.run`` at full width (its depth cut to ``n_layers``
    where given): the losses (finite, the last below the first), the
    step-0 checkpoint (its bytes against the state's and its write
    seconds), then the directory removed."""
    ckpt = TRAIN_CKPT / dname
    shutil.rmtree(ckpt, ignore_errors=True)
    depth = ["--n-layers", str(n_layers)] if n_layers else []
    args = train_launcher.parse_args([
        "--arch", arch, "--steps", str(steps), "--batch", str(B), "--seq",
        str(S), "--lr", str(lr), "--compute-dtype", dname, "--ckpt-dir",
        str(ckpt), "--ckpt-every", str(steps + 1), *depth])
    try:
        res = train_launcher.run(args)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg_registry.get(arch)
    n = n_params(dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers))
    state_bytes = 3 * 4 * n + 4          # params, m, v in f32; the step
    ck = res["checkpoints"]
    losses = res["losses"]
    rec = {"n_layers": n_layers, "losses": losses, "wall_s": res["wall_s"],
           "step_seconds": res["step_seconds"],
           "restarts": res["restarts"],
           "straggler_events": res["straggler_events"],
           "checkpoints": ck, "state_bytes": state_bytes,
           "checkpoint_gb_per_s": [c["bytes"] / c["seconds"] / 1e9
                                   for c in ck]}
    checks = {"finite": bool(np.isfinite(losses).all()),
              "falls": losses[-1] < losses[0],
              "steps": res["steps"] == list(range(steps)),
              "step0_only": [c["step"] for c in ck] == [0],
              "checkpoint_holds_the_state": all(
                  state_bytes <= c["bytes"] <= 1.01 * state_bytes
                  for c in ck)}
    rec["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"train launcher {arch} {dname}: {checks}, "
                             f"losses {losses}, checkpoints {ck}")
    return rec


def train_model(cfg, B=TRAIN_BATCH, S=TRAIN_SEQ,
                steps=TRAIN_WARM + TRAIN_TIMED, lr=1e-3):
    """The launcher's model, parameters, optimizer (AdamW at ``lr``,
    warm-up 5 steps) and data: seed 0, float32 weights, ``cfg``'s compute
    dtype; ``batch_at(i)`` gives step
    i's batch with the launcher's context (``make_ctx(B)``, the same
    every step) where the model takes one."""
    model = model_registry.build(cfg, device="cuda", seed=0)
    params = tstep.trainable_params(model)
    adamw = topt.AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0), device="cuda")
    ctx = model.make_ctx(B)
    batch_at = lambda i: data.batch_at(i) if ctx is None \
        else dict(data.batch_at(i), ctx=ctx)
    return model, params, adamw, batch_at


def n_params(cfg) -> int:
    """The parameters of ``cfg``'s model, counted on a meta-device build
    (``param_count`` is the config's estimate, which misses some blocks'
    weights: xlstm-1.3b's 3.65 B are 2.59 B there)."""
    model = model_registry.build(cfg, device="meta", seed=0)
    return sum(p.numel() for p in model.parameters())


def train_attention_calls(cfg) -> int:
    """Flash calls of one training forward of ``cfg``: one a global or
    sliding-window attention layer, two a cross-attention layer (its
    self and its cross attention), one an encoder layer.  Under remat a
    step runs twice as many forwards and as many backwards."""
    per_kind = {C.ATTN: 1, C.LOCAL_ATTN: 1, C.CROSS_ATTN: 2}
    return sum(per_kind.get(k, 0) for k in cfg.layer_kinds) \
        + (cfg.encoder.n_layers if cfg.encoder is not None else 0)


def train_step_times(cfg, B=TRAIN_BATCH, S=TRAIN_SEQ, warm=TRAIN_WARM,
                     timed_steps=TRAIN_TIMED, lr=1e-3):
    """(b): the launcher's step (``build_train_step``, remat on as
    ``launch.train`` runs it) at (B, S) timed by CUDA events, median of
    ``timed_steps`` after ``warm``, with its hand-kernel launches, which
    must be two flash forwards and one backward a call
    ``train_attention_calls`` counts; the same steps split into forward,
    backward and optimizer by events that the step's ``mark`` hook
    records at its part boundaries, each part's median, and the backward
    / forward ratio; every step's loss; the bytes of the live parameters,
    AdamW state and batch (``live_bytes``, which phase ``dryrun`` holds
    its argument bytes against)."""
    model, params, adamw, batch_at = train_model(cfg, B, S,
                                                 warm + timed_steps, lr)
    events = {}

    def mark(part):
        events[part] = torch.cuda.Event(enable_timing=True)
        events[part].record()

    step = tstep.build_train_step(model, adamw, remat=True, mark=mark)
    state = topt.init_opt_state(params)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    live = {"params": nbytes(params.values()),
            "moments": nbytes(list(state.m.values()) + list(state.v.values())
                              + [state.step]),
            "batch": nbytes(batch_at(0).values())}
    parts = {"forward": [], "backward": [], "optimizer": []}
    whole, losses, launches = [], [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(warm + timed_steps):
        batch = batch_at(i)
        torch.cuda.synchronize()
        before = hand_launches()
        mark("start")
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        losses.append(float(m["loss"]))
        if i >= warm:
            whole.append(events["start"].elapsed_time(events["optimizer"]))
            prev = "start"
            for key in parts:
                parts[key].append(events[prev].elapsed_time(events[key]))
                prev = key
        launches = {k: v - before.get(k, 0) for k, v in hand_launches().items()
                    if v - before.get(k, 0)}
    med = {k: float(np.median(v)) for k, v in parts.items()}
    rec = {"step_ms": float(np.median(whole)), "step_ms_all": whole,
           **{f"{k}_ms": v for k, v in med.items()},
           "parts_ms_all": parts,
           "bwd_fwd_ratio": med["backward"] / med["forward"],
           "launches_per_step": launches, "remat": True,
           "live_bytes": live,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "final_loss": losses[-1], "losses": losses}
    del model, params, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    calls = train_attention_calls(cfg)
    if launches.get("flash_attention", 0) != 2 * calls \
            or launches.get("flash_attention_bwd", 0) != calls:
        raise AssertionError(f"one training step launched {launches}; "
                             f"expected {2 * calls} flash forwards (remat "
                             f"runs each again) and {calls} backwards")
    return rec


def train_prediction(store, cfg, measured, B=TRAIN_BATCH, S=TRAIN_SEQ):
    """(c): ``PM2Lat.schedule_step`` at (B, S) with the default
    ``TrainingStepSpec`` (backward 2.0 x forward, AdamW as one memory op),
    its forward / backward / optimizer split (row names: ``bwd.*``,
    ``opt.*``, the rest forward) against the measured parts."""
    pm = PM2Lat(store, store.meta["device"])
    sch = pm.schedule_step(cfg, B, S,
                           train=sched.TrainingStepSpec(),
                           dtype=cfg.compute_dtype)
    split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for r in sch.rows:
        key = ("backward" if r.name.startswith("bwd.") else
               "optimizer" if r.name.startswith("opt.") else "forward")
        split[key] += r.seconds * 1e3
    pred = sch.makespan * 1e3
    rec = {"predicted_ms": pred, "measured_ms": measured["step_ms"],
           "err_pct": 100 * abs(pred - measured["step_ms"])
           / measured["step_ms"],
           "predicted_split_ms": split,
           "split_err_pct": {k: 100 * abs(v - measured[f"{k}_ms"])
                             / measured[f"{k}_ms"] for k, v in split.items()},
           "predicted_bwd_fwd_ratio": split["backward"] / split["forward"],
           "measured_bwd_fwd_ratio": measured["bwd_fwd_ratio"]}
    if not (pred > 0 and all(v > 0 for v in split.values())):
        raise AssertionError(f"training-step prediction {rec}")
    return rec


class PlainAttentionOnCard:
    """Inside the block, the attention's forward and backward wrappers are
    their plain versions on the card's tensors (no launch, no count): the
    reference a hand-path gradient is held against."""

    def __enter__(self):
        self.saved = (fk.flash_attention_kernel, fkb.flash_attention_bwd_kernel)
        fk.flash_attention_kernel = \
            lambda q, k, v, cfg, **kw: fk.flash_attention_plain(q, k, v, cfg,
                                                                **kw)
        fkb.flash_attention_bwd_kernel = fkb.flash_attention_bwd_plain
        return self

    def __exit__(self, *exc):
        fk.flash_attention_kernel, fkb.flash_attention_bwd_kernel = self.saved


class SameRouting:
    """Within the block, the MoE layers of ``model`` record the experts
    each call of ``moe_mod._top_k`` chooses (``chosen`` None), or choose
    the ones recorded in ``chosen`` (gates: the caller's own probabilities
    of those experts, renormalised) and count in ``differ`` the (token,
    call) whose own top-k would have been other experts.  A forward
    pre-hook on each ``blk.moe`` names the layer; under remat a layer
    routes twice a step on the same input, so its first call's record
    serves both."""

    def __init__(self, model, chosen=None):
        self.model, self.replay = model, chosen is not None
        self.chosen = {} if chosen is None else chosen
        self.differ = 0

    def top_k(self, probs, moe):
        gates, own = self.orig(probs, moe)
        if not self.replay:
            self.chosen.setdefault(self.layer, own)
            return gates, own
        want = self.chosen[self.layer]
        self.differ += int((own.sort(-1).values != want.sort(-1).values)
                           .any(-1).sum())
        return moe_mod._renormalise(probs.gather(-1, want)), want

    def __enter__(self):
        self.handles = [blk.moe.register_forward_pre_hook(
            lambda mod, args, i=i: setattr(self, "layer", i))
            for i, blk in enumerate(self.model.blocks)
            if blk.moe is not None]
        self.orig, moe_mod._top_k = moe_mod._top_k, self.top_k
        return self

    def __exit__(self, *exc):
        moe_mod._top_k = self.orig
        for h in self.handles:
            h.remove()


def train_grad_check(cfg, B=TRAIN_BATCH, S=TRAIN_SEQ):
    """(d): one step's loss and gradients (``loss_fn`` at batch 0 of (B,
    S), remat on) through the hand kernels and through the plain attention
    on the card, each parameter's max |d| / max |g| held to
    TRAIN_GRAD_TOL; the hand pass launches one backward a call
    ``train_attention_calls`` counts, the plain pass none.  An MoE
    model's plain pass routes every token to the experts the hand pass
    chose (``SameRouting``): top-k is discrete, and the two attentions'
    outputs, ~2^-8 apart in bf16, flip near-tied choices and with them
    the capacity's drops, which move the router's and experts' gradients
    by up to 0.20 of their largest (measured on one H100); the flips are
    counted (``routing_differs``)."""
    model, params, _, batch_at = train_model(cfg, B, S)
    batch = batch_at(0)
    out, routing = [], None
    for plain in (False, True):
        before = hand_launches()
        with contextlib.ExitStack() as stack:
            if cfg.moe is not None:
                routing = stack.enter_context(SameRouting(
                    model, routing.chosen if plain else None))
            if plain:
                stack.enter_context(PlainAttentionOnCard())
            loss, _ = tobj.loss_fn(model, batch, remat=True)
            grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        launched = hand_launches()["flash_attention_bwd"] \
            - before["flash_attention_bwd"]
        out.append((float(loss.detach()), grads, launched))
    (l_hand, g_hand, n_hand), (l_plain, g_plain, n_plain) = out
    errs = {name: rel_max(a, b) for name, a, b in zip(params, g_hand, g_plain)}
    worst = max(errs, key=errs.get)
    bad = [n for n, e in errs.items()
           if not e <= TRAIN_GRAD_TOL[cfg.compute_dtype]]
    rec = {"loss_hand": l_hand, "loss_plain": l_plain,
           "loss_rel_diff": abs(l_hand - l_plain) / abs(l_plain),
           "max_rel_err": errs[worst], "worst_param": worst,
           "rel_err_by_param": dict(sorted(errs.items(),
                                           key=lambda kv: -kv[1])[:12]),
           "tol": TRAIN_GRAD_TOL[cfg.compute_dtype], "over_tol": bad,
           "bwd_launches": [n_hand, n_plain]}
    if routing is not None:
        rec["routing_differs"] = routing.differ
    del model, params, g_hand, g_plain, out, batch, routing
    gc.collect()
    torch.cuda.empty_cache()
    if bad or n_plain or n_hand != train_attention_calls(cfg):
        raise AssertionError(f"train gradients {cfg.name} "
                             f"{cfg.compute_dtype}: {rec}")
    return rec


def train_restart():
    """(f): ``scripts/torch_train_restart.py`` in a process of its own
    (deterministic algorithms, ``CUBLAS_WORKSPACE_CONFIG`` set before
    cuBLAS starts): the losses of a run with two injected failures equal
    the uninterrupted run's bit for bit, or, where PyTorch names an
    operation without a deterministic implementation, within
    TRAIN_RESTART_RTOL of them (the ops are reported); a restored state
    equals the saved one bit for bit."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(TRAIN_RESTART), str(ROOT / "build" /
                                                 "train_restart")],
        capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"train restart run failed ({proc.returncode}):"
                             f" {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    exact = not rec["nondeterministic_ops"]
    ok = rec["restarts"] == 2 and rec["restored_bitwise"] and (
        rec["bitwise_equal"] if exact else rec["max_abs_diff"]
        <= TRAIN_RESTART_RTOL * max(map(abs, rec["losses"])))
    rec["held_bit_for_bit"] = exact
    if not ok:
        raise AssertionError(f"train restart: {rec}")
    return rec


def bound(nbytes, flops, dname="bfloat16"):
    """(the least ms the card could take to move ``nbytes`` and do
    ``flops`` in ``dname``, which of the two bounds it)."""
    t_bytes = nbytes / H100_SXM.hbm_bw
    t_ops = flops / H100_SXM.peak(dname)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timed(run, *args, stream=None):
    """One call's ms (CUDA events around back-to-back calls,
    ``profiler.measure``), its device ms (a replayed CUDA graph,
    ``device_ms``) and its host ms (``host_ms``); on ``stream`` where
    given."""
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        return {"ms": profiler.measure(run, *args) * 1e3,
                "device_ms": device_ms(run, *args, stream=stream),
                "host_ms": host_ms(run, *args)}


def device_ms_faults(lines):
    """The ``device_ms`` readings of the ``kernels`` line that cannot be
    right: one below its row's ``bound_ms`` (past the card's peak), or
    below half its CUDA-events ``ms`` where the host enqueues a call in
    under half of that ``ms`` (so the device, not the host, sets the
    pace).  Config rows take their line's bound; library readings too."""
    bad = []

    def visit(row, bound, where):
        bound = row.get("bound_ms", bound)
        for dev, ms, host in (("device_ms", "ms", "host_ms"),
                              ("library_device_ms", "library_ms",
                               "library_host_ms")):
            if dev not in row:
                continue
            d, m, h = row[dev], row[ms], row[host]
            if bound is not None and d < bound:
                bad.append(f"{where} {dev} {d} below the bound {bound}")
            if d < 0.5 * m and h < 0.5 * m:
                bad.append(f"{where} {dev} {d} below half of {ms} {m} "
                           f"(host {h})")
        for key, val in row.items():
            subs = val if isinstance(val, list) else [val]
            for i, sub in enumerate(subs):
                if isinstance(sub, dict):
                    visit(sub, bound, f"{where}/{key}[{i}]")

    for line in lines:
        visit(line, None, line["name"])
    return bad


def kernel_lines(by_path, mm_pick, launches_by_kind, launches_by_arch):
    """Each hand kernel in bf16 at the main path's shapes: its time (and
    each config's), its own device time, its plain version's time, one
    PyTorch call's (a yardstick only), and the card's bound.  The matmul is
    timed at MM_SHAPE in every config, ``mm_pick`` marked; the flash kernel
    at qwen2-0.5b's prefill attention in both configs.  Under ``float32``,
    the same numbers for the float32 instances (FFMA) at the same shapes,
    headed by ``mm_128x128x128`` (matmul) or the config ``select_config``
    picks (flash); the matmul's adds its time at the card-filling shape
    MM_FULL.  The flash line's ``hd256`` holds the same numbers for the
    hd-256 instances at the hybrid path's shapes and their launches on each
    path; its ``encdec`` the same for whisper-small's non-causal calls,
    the encoder's (8, 1500) and the cross attention's (8, 448 x 1500), and
    the non-causal launches on each path (``flash_case``); its ``hd128``
    the same for moonshot-v1-16b-a3b's (8, 512), 16 heads of 128, causal,
    and the hd-128 launches on each path; its ``archs`` the same for the
    archs path's three calls at ARCHS_FORWARD (``archs_timed``: gemma-7b's
    16 heads of 256 over 16 and starcoder2-15b's 48 of 128 over 4, causal;
    llama-3.2-vision-11b's cross attention, 32 of 128 over 8, non-causal
    over 1,601 keys) and each arch's launches (``launches_by_arch``: phase
    ``archs``'); its ``paper`` the same for the
    paper path's narrow heads at PAPER_TIMED (PAPER_TIMED_ARCHS: hd 32,
    qwen3-mini's 8 over 4; hd 16, a reduced config's 4 over 4), causal,
    and the hd-32 and hd-16 launches on each path; the backward's line is
    ``bwd_line``'s (``launches_by_kind``: phase ``train``'s).  ``by_path``:
    each path's ``hand_launches``; ``launches`` is the main path's.  Every
    number here is measured, but ``bound_ms``."""
    launches = by_path["main"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32
    lines = []

    def each_config(configs, run, want, tol, args, extra=lambda c: {}):
        """One row per config: its error against ``want``, its times, and
        what ``extra`` adds."""
        rows = []
        for cfg in configs:
            err, ok = close(run(cfg, *args), want(cfg, *args), *tol)
            rows.append({"config": cfg.name, "max_abs_err": err, "ok": ok,
                         **timed(lambda *x, cfg=cfg: run(cfg, *x), *args),
                         **extra(cfg)})
        return rows

    def float32(head, configs, plain, args, lib, lib_args, nbytes, flops):
        """The float32 instances, timed as the bf16 line is, headed by the
        row of config ``head``; ``nbytes`` and ``flops`` are the bf16
        line's (the bytes double in float32)."""
        row = next(c for c in configs if c["config"] == head)
        bms, by = bound(2 * nbytes, flops, "float32")
        libt = timed(lib, *lib_args)
        return {**row, "ok": all(c["ok"] for c in configs),
                "max_abs_err": max(c["max_abs_err"] for c in configs),
                "plain_ms": profiler.measure(plain, *args) * 1e3,
                "bound_ms": bms, "bound_by": by, "library_ms": libt["ms"],
                "library_device_ms": libt["device_ms"],
                "library_host_ms": libt["host_ms"], "configs": configs}

    def flash_case(arch, B, Sq, Skv, dt, causal, window=None):
        """One flash call as model ``arch`` makes it: (B, Sq) queries of
        its heads over Skv keys in ``dt``, in the config ``select_config``
        picks.  Bounds count the pairs the masks keep (a causal square's
        ``window_pairs``, its window or the whole square; every pair
        without a mask); the
        library call is SDPA over KV heads repeated to the query heads,
        with a window as a boolean mask where it masks (Sq > window),
        causal or not as the call."""
        h = cfg_registry.get_any(arch)
        Hq, hd, dname = h.n_heads, h.head_dim, str(dt).split(".")[1]
        args = tuple(torch.randn(B, S, n, hd, generator=gen,
                                 device="cuda").to(dt)
                     for S, n in ((Sq, Hq), (Skv, h.n_kv_heads),
                                  (Skv, h.n_kv_heads)))
        fcfg = fk.select_config(Sq, Skv, hd)
        kw = dict(causal=causal, window=window, q_offset=Skv - Sq)
        run = lambda cfg, q, k, v: fk.flash_attention_kernel(q, k, v, cfg,
                                                             **kw)
        plain = lambda cfg, q, k, v: fk.flash_attention_plain(q, k, v, cfg,
                                                              **kw)
        row, = each_config([fcfg], run, plain,
                           flash_tol(*args, fcfg, dname, kw), args)
        pairs = window_pairs(Sq, window or Sq) if causal else Sq * Skv
        bms, by = bound(args[0].element_size() * 2 * (args[0].numel()
                                                      + args[1].numel()),
                        4.0 * B * Hq * hd * pairs, dname)
        i = torch.arange(Sq, device="cuda")
        mask = None if not window or Sq <= window else \
            (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        lib = timed(lambda q, k, v: torch.nn.functional
                    .scaled_dot_product_attention(
                        q, k, v, attn_mask=mask,
                        is_causal=causal and mask is None),
                    *(x.repeat_interleave(Hq // x.shape[2], dim=2)
                      .transpose(1, 2).contiguous() for x in args))
        return {**row, "shape": [B, Sq, Skv, Hq, h.n_kv_heads, hd],
                "causal": causal, "window": window, "dtype": dname,
                "path": fk.load_path(*args),
                "plain_ms": profiler.measure(
                    lambda *x: plain(fcfg, *x), *args) * 1e3,
                "bound_ms": bms, "bound_by": by, "library_ms": lib["ms"],
                "library_device_ms": lib["device_ms"],
                "library_host_ms": lib["host_ms"]}

    m, n, k = MM_SHAPE
    a = torch.randn(m, k, generator=gen, device="cuda").to(bf)
    b = torch.randn(k, n, generator=gen, device="cuda").to(bf)
    want = mk.matmul_plain(a, b)
    configs = []
    for cfg in mk.CONFIGS:
        run = lambda a, b, cfg=cfg: mk.matmul_kernel(a, b, cfg)
        err, ok = close(run(a, b), want, MM_TOL["bfloat16"][0] * k ** 0.5,
                        MM_TOL["bfloat16"][1])
        configs.append({"config": cfg.name, "pick": cfg.name == mm_pick,
                        "path": mk.load_path(a, b), "max_abs_err": err,
                        "ok": ok, **timed(run, a, b)})
    head = next(c for c in configs if c["config"] == "mm_128x128x128")
    nbytes, flops = 2 * (m * k + k * n + m * n), 2.0 * m * n * k
    bms, by = bound(nbytes, flops)
    lib = timed(torch.matmul, a, b)
    a32, b32 = a.float(), b.float()
    mm_tol = lambda K: (MM_TOL["float32"][0] * K ** 0.5, MM_TOL["float32"][1])
    f32_configs = each_config(
        mk.CONFIGS, lambda cfg, a, b: mk.matmul_kernel(a, b, cfg),
        lambda cfg, a, b: mk.matmul_plain(a, b), mm_tol(k), (a32, b32),
        lambda cfg: {"path": mk.load_path(a32, b32)})
    lines.append({
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:89",
        "launches": launches["matmul"],
        "max_abs_err": max(c["max_abs_err"] for c in configs),
        "ok": all(c["ok"] for c in configs),
        "config": head["config"], "shape": [m, n, k], "dtype": "bfloat16",
        "ms": head["ms"], "device_ms": head["device_ms"],
        "host_ms": head["host_ms"],
        "plain_ms": profiler.measure(mk.matmul_plain, a, b) * 1e3,
        "bound_ms": bms, "bound_by": by,
        "library_ms": lib["ms"], "library_device_ms": lib["device_ms"],
        "library_host_ms": lib["host_ms"],
        "configs": configs,
        "float32": {**float32("mm_128x128x128", f32_configs, mk.matmul_plain,
                              (a32, b32), torch.matmul, (a32, b32), nbytes,
                              flops),
                    "card_filling": card_filling_matmul(gen, timed, mm_tol)}})

    # flash: qwen2-0.5b's prefill attention, bf16, as the model calls it
    c = cfg_registry.get(MODEL)
    B, S, H, Hkv, hd = BATCH, SEQ, c.n_heads, c.n_kv_heads, c.head_dim
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(bf)
    kk = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(bf)
    vv = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(bf)
    pick = fk.select_config(S, S, hd, bf)
    kw = dict(causal=True, q_offset=0)
    configs = []
    for fcfg in fk.CONFIGS:
        run = lambda q, k, v, fcfg=fcfg: fk.flash_attention_kernel(
            q, k, v, fcfg, causal=True)
        err, ok = close(run(q, kk, vv),
                        fk.flash_attention_plain(q, kk, vv, fcfg, **kw),
                        *flash_tol(q, kk, vv, fcfg, "bfloat16", kw))
        configs.append({"config": fcfg.name, "pick": fcfg == pick,
                        "path": fk.load_path(q, kk, vv), "max_abs_err": err,
                        "ok": ok, **timed(run, q, kk, vv)})
    head = next(x for x in configs if x["pick"])
    plain = lambda q, k, v: fk.flash_attention_plain(q, k, v, pick, causal=True)
    # the causal mask needs S(S+1)/2 of the S^2 score pairs
    flops = 4.0 * B * H * hd * S * (S + 1) / 2
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
    bms, by = bound(nbytes, flops)
    per_head = lambda x: x.repeat_interleave(H // x.shape[2], dim=2) \
        .transpose(1, 2).contiguous()
    sdpa = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True)
    lib = timed(sdpa, *map(per_head, (q, kk, vv)))

    f32_args = tuple(x.float() for x in (q, kk, vv))
    pick32 = fk.select_config(S, S, hd, f32)
    f32_configs = each_config(
        fk.CONFIGS, lambda cfg, q, k, v: fk.flash_attention_kernel(
            q, k, v, cfg, causal=True),
        lambda cfg, q, k, v: fk.flash_attention_plain(q, k, v, cfg, **kw),
        FA_TOL["float32"], f32_args,
        lambda cfg: {"pick": cfg == pick32})
    lines.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:87",
        "launches": launches["flash_attention"],
        "max_abs_err": max(x["max_abs_err"] for x in configs),
        "ok": all(x["ok"] for x in configs),
        "config": head["config"], "shape": [B, S, H, Hkv, hd],
        "dtype": "bfloat16", "ms": head["ms"], "device_ms": head["device_ms"],
        "host_ms": head["host_ms"],
        "plain_ms": profiler.measure(plain, q, kk, vv) * 1e3,
        "bound_ms": bms, "bound_by": by,
        "library_ms": lib["ms"], "library_device_ms": lib["device_ms"],
        "library_host_ms": lib["host_ms"],
        "configs": configs,
        "float32": float32(
            pick32.name, f32_configs,
            lambda q, k, v: fk.flash_attention_plain(q, k, v, pick32,
                                                     causal=True),
            f32_args, sdpa, tuple(map(per_head, f32_args)), nbytes, flops),
        "hd256": {"launches_by_path": {p: n.get("flash_attention@hd256", 0)
                                       for p, n in by_path.items()},
                  "cases": [flash_case(HYBRID, B, S, S, dt, True,
                                       cfg_registry.get(HYBRID)
                                       .sliding_window)
                            for dt in (bf, f32) for B, S in HYBRID_FORWARDS]},
        "encdec": {"launches_by_path": {
            p: n.get("flash_attention@noncausal", 0)
            for p, n in by_path.items()},
            "cases": [flash_case(ENCDEC, B, Sq, L, dt, False)
                      for dt in (bf, f32) for B, Sq, L in encdec_timed()]},
        "hd128": {"launches_by_path": {p: n.get("flash_attention@hd128", 0)
                                       for p, n in by_path.items()},
                  "cases": [flash_case(MOE, *MOE_FORWARD, MOE_FORWARD[1], dt,
                                       True) for dt in (bf, f32)]},
        "archs": {"launches_by_arch": launches_by_arch,
                  "cases": [flash_case(arch, *ARCHS_FORWARD, Skv, dt, causal)
                            for arch, Skv, causal in archs_timed()
                            for dt in (bf, f32)]},
        "paper": {"launches_by_path": {
            p: {f"hd{hd}": n.get(f"flash_attention@hd{hd}", 0)
                for hd in (16, 32)} for p, n in by_path.items()},
            "cases": [flash_case(arch, *PAPER_TIMED, PAPER_TIMED[1], dt, True)
                      for arch in PAPER_TIMED_ARCHS for dt in (bf, f32)]}})
    lines.append(bwd_line(gen, by_path, launches_by_kind))
    for line in lines:
        line["launches_by_path"] = {p: n[line["name"]]
                                    for p, n in by_path.items()}
        f = line["float32"]
        if not (line["ok"] and f["ok"] and f.get("card_filling", f)["ok"]):
            raise AssertionError(
                f"{line['name']} at the main-path shape: max err "
                f"{line['max_abs_err']} (bf16), {f['max_abs_err']} (float32)")
    flash = next(x for x in lines if x["name"] == "flash_attention")
    for key in ("hd256", "encdec", "hd128", "archs", "paper"):
        cases = flash[key]["cases"]
        if not all(c["ok"] for c in cases):
            raise AssertionError(f"flash {key} cases: max errs "
                                 f"{[c['max_abs_err'] for c in cases]}")
    bad = device_ms_faults(lines)
    if bad:
        raise AssertionError(f"device_ms readings that cannot be right: "
                             f"{bad}")
    return lines


def bwd_line(gen, by_path, launches_by_kind):
    """The flash backward at the train path's attention (qwen2-0.5b, B 8 x
    S 512, 14 heads over 2 at hd 64, causal), bf16 and, under
    ``float32``, float32 (``bwd_case``); its ``hd256`` the same at
    recurrentgemma-2b's train shape (``bwd_path_cases()[1]``: B 1 x S
    4096, 10 heads over 1 at hd 256, causal under its 2,048-key window)
    and the hd-256 launches on each path; ``launches_by_kind``: one bf16
    training step's hand launches by model kind (phase ``train``)."""
    rows = {}
    for case in bwd_path_cases()[:2]:
        rows[case] = {str(dt).split(".")[1]: bwd_case(case, dt, gen)
                      for dt in (torch.bfloat16, torch.float32)}
    main, wide = rows.values()
    B, S, _, H, Hkv, hd, _, _ = bwd_path_cases()[0]
    _, S2, _, H2, Hkv2, hd2, _, window = bwd_path_cases()[1]
    line = {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:133",
            "launches": by_path["train"]["flash_attention_bwd"],
            "shape": [B, S, H, Hkv, hd], "dtype": "bfloat16",
            **main["bfloat16"], "float32": main["float32"],
            "hd256": {"launches_by_path": {
                p: n.get("flash_attention_bwd@hd256", 0)
                for p, n in by_path.items()},
                "shape": [1, S2, H2, Hkv2, hd2], "window": window, **wide},
            "launches_by_kind": launches_by_kind,
            "tolerance": "max |d| / max |plain| per gradient, BWD_TOL"}
    if not all(row["ok"] for row in wide.values()):
        raise AssertionError(f"flash backward at hd 256: max errs "
                             f"{[row['max_rel_err'] for row in wide.values()]}")
    return line


def bwd_case(case, dt, gen):
    """The backward at ``case`` (a causal square, or non-causal) in
    ``dt``: its time against its plain version's and SDPA's backward (one
    call of the backward node of ``scaled_dot_product_attention`` over KV
    heads repeated to the query heads, a window passed as a boolean mask:
    a yardstick only, never on the path; ``library_backend`` names the
    node, hence the backend PyTorch picked; its forward runs on a side
    stream, where its backward is captured for ``library_device_ms``), and
    SDPA's gradients against the same plain version
    (``library_max_rel_err``, the group's repeated KV heads summed in
    f32).  Bound: the five products over the pairs the mask keeps (10 hd
    flops a pair and head) and q, k, v, o, dO, dQ, dK, dV and lse moved
    once."""
    B, S, Skv, H, Hkv, hd, causal, window = case
    dname = str(dt).split(".")[1]
    pairs = window_pairs(S, window or S) if causal else S * Skv
    args, _, kw = bwd_inputs(case, dt, gen)
    run = lambda *a: fkb.flash_attention_bwd_kernel(*a, **kw)
    plain = lambda *a: fkb.flash_attention_bwd_plain(*a, **kw)
    got, want = run(*args), plain(*args)
    errs = [rel_max(g, w) for g, w in zip(got, want)]
    abs_err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
    del got
    esize = args[0].element_size()
    nbytes = esize * 4 * (B * S * H * hd + B * Skv * Hkv * hd) \
        + 4 * B * H * S
    bms, by = bound(nbytes, 10.0 * B * H * hd * pairs, dname)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        q, k, v = (x.repeat_interleave(H // x.shape[2], dim=2)
                   .transpose(1, 2).contiguous().requires_grad_()
                   for x in args[:3])
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window is None:
            o = sdpa(q, k, v, is_causal=causal)
        else:
            pos = torch.arange(S, device="cuda")
            d = pos[:, None] - pos[None, :]
            o = sdpa(q, k, v, attn_mask=(d >= 0) & (d < window))
        do = args[5].transpose(1, 2).contiguous()
        backend = type(o.grad_fn).__name__
        # SDPA's backward node called on this thread: one PyTorch call
        # into the library's backward, without the autograd engine's
        # thread hop, which set the pace of ``torch.autograd.grad`` here;
        # a forward PyTorch ran in plain operations has no such node
        if backend.startswith("ScaledDotProduct"):
            sdpa_bwd = lambda: o.grad_fn(do)[:3]
        else:
            sdpa_bwd = lambda: torch.autograd.grad(o, (q, k, v), do,
                                                   retain_graph=True)
        gq, gk, gv = sdpa_bwd()
        grouped = lambda g: g.transpose(1, 2).float().reshape(
            B, Skv, Hkv, H // Hkv, hd).sum(3)
        lib_errs = [rel_max(g, w) for g, w in
                    zip((gq.transpose(1, 2), grouped(gk), grouped(gv)),
                        want)]
        del gq, gk, gv
    lib = timed(sdpa_bwd, stream=side)
    torch.cuda.current_stream().wait_stream(side)
    row = {"max_rel_err": max(errs), "ok": all(
               e <= BWD_TOL[dname] for e in errs),
           "max_abs_err": abs_err, **timed(run, *args),
           "plain_ms": profiler.measure(plain, *args) * 1e3,
           "bound_ms": bms, "bound_by": by, "library_ms": lib["ms"],
           "library_device_ms": lib["device_ms"],
           "library_host_ms": lib["host_ms"],
           "library_backend": backend,
           "library_max_rel_err": max(lib_errs)}
    del q, k, v, o, do, want, args
    return row


def archs_timed():
    """(arch, Skv, causal) of each flash call the ``kernels`` line times at
    ARCHS_FORWARD: each arch's self attention, and llama-3.2-vision-11b's
    cross attention in place of its self attention."""
    out = []
    for arch in ARCHS:
        c = cfg_registry.get(arch)
        out.append((arch, c.cross_attn_context_len, False)
                   if C.CROSS_ATTN in c.layer_kinds
                   else (arch, ARCHS_FORWARD[1], True))
    return out


def encdec_timed():
    """The (B, Sq, Skv) of the ``kernels`` line's encoder–decoder rows:
    the encoder and the cross attention of the (8, 448) forward."""
    L = cfg_registry.get(ENCDEC).encoder.n_frames
    (B, S), _ = ENCDEC_FORWARDS
    return ((B, L, L), (B, S, L))


def window_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal mask with ``window`` keeps in an S x S
    square: query q sees min(q + 1, window) keys."""
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def matmul_floors(f32):
    """What each float32 matmul identity can reach where the ``kernels``
    line timed it (``f32``: that line's ``float32``, at MM_SHAPE, and its
    card-filling row at MM_FULL): its output tiles on the card's SMs, each
    tile at the per-SM FFMA rate (67 TFLOP/s over the SM count), in
    ceil(tiles / SMs) waves; the bytes its tiling streams (each block reads
    its A and B panels and writes its C tile), which bound the skinny
    mm_8x128x128; and the share of that floor the measured device time
    reaches.  Worked out from the shapes, so kept out of the ``kernels``
    line."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = H100_SXM.peak("float32") / sms
    by_name = {c.name: c for c in mk.CONFIGS}
    rows = [(c["config"], MM_SHAPE, c["device_ms"]) for c in f32["configs"]]
    full = f32["card_filling"]
    rows.append((full["config"], tuple(full["shape"]), full["device_ms"]))
    out = []
    for name, (m, n, k), dev in rows:
        cfg = by_name[name]
        tiles = -(-m // cfg.bm) * -(-n // cfg.bn)
        floor = -(-tiles // sms) * 2.0 * cfg.bm * cfg.bn * k / per_sm * 1e3
        out.append({"config": name, "shape": [m, n, k], "sms": sms,
                    "tiles": tiles, "per_sm_floor_ms": floor,
                    "streamed_bytes": 4 * tiles * (cfg.bm * k + k * cfg.bn
                                                   + cfg.bm * cfg.bn),
                    "device_ms": dev,
                    "floor_share": floor / dev if isinstance(dev, float)
                    else "not measured"})
    return out


def card_filling_matmul(gen, timed, tol):
    """mm_128x128x128 in float32 at MM_FULL (4 full waves of 128 x 128
    tiles) against torch.matmul, as TFLOP/s of device time."""
    m, n, k = MM_FULL
    a = torch.randn(m, k, generator=gen, device="cuda")
    b = torch.randn(k, n, generator=gen, device="cuda")
    cfg = mk.MatmulConfig(128, 128, 128)
    run = lambda a, b: mk.matmul_kernel(a, b, cfg)
    err, ok = close(run(a, b), mk.matmul_plain(a, b), *tol(k))
    t, lib = timed(run, a, b), timed(torch.matmul, a, b)
    flops = 2.0 * m * n * k
    tflops = lambda ms: flops / (ms * 1e-3) / 1e12 if isinstance(ms, float) \
        else "not measured"
    bms, by = bound(4 * (m * k + k * n + m * n), flops, "float32")
    return {"config": cfg.name, "shape": [m, n, k], "max_abs_err": err,
            "ok": ok, **t, "bound_ms": bms, "bound_by": by,
            "tflops": tflops(t["device_ms"]),
            "library_ms": lib["ms"], "library_device_ms": lib["device_ms"],
            "library_host_ms": lib["host_ms"],
            "library_tflops": tflops(lib["device_ms"]),
            "peak_share": (tflops(t["device_ms"]) * 1e12
                           / H100_SXM.peak("float32")
                           if isinstance(t["device_ms"], float) else
                           "not measured")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is true f32
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    # this run's comm-calibration artifact only, written in phase service
    os.environ[comm.CALIBRATION_ENV] = str(COMM_CAL)
    COMM_CAL.unlink(missing_ok=True)
    (OUT / "phases.jsonl").unlink(missing_ok=True)
    record = {}

    smi = phase_device()
    record["build"] = phase_build()

    mm_err, mm_rows = check_matmul(("float32", "bfloat16"))
    fa_err, fa_rows = check_flash(("float32", "bfloat16"))
    bwd_err, bwd_rows = check_flash_bwd(("float32", "bfloat16"))
    record["kernel_checks"] = {"matmul": mm_rows, "flash_attention": fa_rows,
                               "flash_attention_bwd": bwd_rows}
    for kernel, rows in record["kernel_checks"].items():
        for row in rows:
            emit("check", kernel=kernel, **row)
    emit("kernels_vs_plain", matmul_checks=len(mm_rows),
         matmul_max_abs_err=mm_err, flash_checks=len(fa_rows),
         flash_max_abs_err=fa_err, flash_bwd_checks=len(bwd_rows),
         flash_bwd_max_rel_err=bwd_err, all_ok=True,
         tolerances={"matmul (atol/sqrt(K), rtol)": MM_TOL,
                     "flash_attention (atol, rtol)": FA_TOL,
                     "flash_attention_bwd (max |d| / max |plain|)": BWD_TOL,
                     "lse (atol)": LSE_TOL})

    # --- the main path: counts from 0, read right after ---
    reset_launches()
    store, record["calibrate"] = phase_calibrate()
    table6 = phase_table6(store)
    model = phase_model(store)
    launches = hand_launches()
    emit("main_path_launches", **launches)
    for name in ("matmul", "flash_attention"):
        if launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}")

    # --- the decode and serving paths, each with counts from 0 ---
    reset_launches()
    decode, decode_floors = phase_decode(store)
    by_path = {"main": launches, "decode": hand_launches()}
    reset_launches()
    serving, by_path["serve"] = phase_serve(store)
    reset_launches()
    grid = phase_grid(store)
    by_path["grid"] = hand_launches()
    reset_launches()
    schedule = phase_schedule(store, serving)
    by_path["schedule"] = hand_launches()
    reset_launches()
    service = phase_service(store, model, decode)
    by_path["service"] = hand_launches()
    reset_launches()
    hybrid = phase_hybrid(store)
    by_path["hybrid"] = hand_launches()
    reset_launches()
    encdec = phase_encdec(store)
    by_path["encdec"] = hand_launches()
    reset_launches()
    moe = phase_moe(store)
    by_path["moe"] = hand_launches()
    reset_launches()
    archs = phase_archs(store)
    by_path["archs"] = hand_launches()
    reset_launches()
    xlstm = phase_xlstm(store)
    by_path["xlstm"] = hand_launches()
    reset_launches()
    paper = phase_paper(store, grid)
    by_path["paper"] = hand_launches()
    reset_launches()
    drivers = phase_drivers(store, paper["neusight_paths"]["float32"])
    by_path["drivers"] = hand_launches()
    reset_launches()
    train = phase_train(store)
    by_path["train"] = hand_launches()
    reset_launches()
    dist = phase_dist(train)
    by_path["dist"] = dist["launches"]
    reset_launches()
    dry = phase_dryrun(train)
    by_path["dryrun"] = dry["launches"]
    emit("path_launches", **by_path)
    if any(by_path["dryrun"].values()):
        raise AssertionError(f"the dryrun path launched a hand kernel: "
                             f"{by_path['dryrun']}")
    for path in ("train", "dist"):
        for name in ("flash_attention", "flash_attention_bwd"):
            if by_path[path][name] == 0:
                raise AssertionError(f"the {path} path never launched {name}")
    if any(by_path["xlstm"].values()):
        raise AssertionError(f"the xlstm path launched a hand kernel: "
                             f"{by_path['xlstm']}")
    for path in ("decode", "serve", "grid", "schedule", "service", "hybrid",
                 "encdec", "moe", "archs", "paper"):
        if by_path[path]["flash_attention"] == 0:
            raise AssertionError(f"the {path} path never launched "
                                 f"flash_attention")
    moe_flash = by_path["moe"]
    if moe_flash.get("flash_attention@hd128") != moe_flash["flash_attention"]:
        raise AssertionError(f"the moe path's flash launches are not all at "
                             f"hd 128: {moe_flash}")
    bad = archs_launch_faults(archs["launches_by_arch"], by_path["archs"])
    if bad:
        raise AssertionError(f"the archs path's hand launches: {bad}")

    gc.collect()        # the phases' garbage out before the kernels' timings
    m, n, _ = MM_SHAPE
    mm_pick = PM2Lat(store, store.meta["device"]).oracle.select_matmul(
        "matmul", "bfloat16", m, n, provider=PROVIDER_PALLAS).key.kernel
    kernels = kernel_lines(by_path, mm_pick, train["launches_by_kind"],
                           archs["launches_by_arch"])
    floors = matmul_floors(next(x for x in kernels
                                if x["name"] == "matmul")["float32"])
    emit("matmul_floors", rows=floors)
    record.update(table6=table6, model=model, decode=decode,
                  decode_floors=decode_floors, serve=serving, grid=grid,
                  schedule=schedule, service=service, hybrid=hybrid,
                  encdec=encdec, moe=moe, archs=archs, xlstm=xlstm,
                  paper=paper,
                  train=train, dist=dist, dryrun=dry, drivers=drivers,
                  kernels=kernels,
                  matmul_floors=floors,
                  nvidia_smi=smi, seconds=time.time() - t_start)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    emit("seconds", total=record["seconds"])

    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
