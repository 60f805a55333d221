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
decode admission oracle.  Every phase prints one JSON line; the full
record (and the calibrated store) goes to ``chiprun_out/``.  The
comm-calibration artifact is this run's own
(``chiprun_out/comm_calibration.json``, deleted at the start).

The last line is ``{"ok": true, "device": {...}}``.  Any failing phase, a
missing card, or a checkout without ``src/repro_torch`` (the import fails)
exits non-zero and prints no result.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
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

from repro_torch.configs import registry as cfg_registry  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import comm_calibrate as comm  # noqa: E402
from repro_torch.core import opgraph as og  # noqa: E402
from repro_torch.core import partition  # noqa: E402
from repro_torch.core import profiler  # noqa: E402
from repro_torch.core import schedule as sched  # noqa: E402
from repro_torch.core import validate  # noqa: E402
from repro_torch.core.batch_predict import (BatchPredictor,  # noqa: E402
                                            PredictionCache, config_key)
from repro_torch.core.devices.profiles import H100_SXM  # noqa: E402
from repro_torch.core.devices.profiles import FLEET  # noqa: E402
from repro_torch.core.nas import NASGrid, precompute_cache  # noqa: E402
from repro_torch.core.oracle import PROVIDER_PALLAS  # noqa: E402
from repro_torch.core.predictor import PM2Lat  # noqa: E402
from repro_torch.core.transfer import transfer_store  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import matmul as mk  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.serving.engine import (DecodeGraph, Request,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.latency_service import LatencyService  # noqa: E402

MODEL = "qwen2-0.5b"
BATCH, SEQ = 8, 512
TABLE6_SAMPLES = 6

MM_SHAPE = (768, 640, 1408)   # (M, N, K) at which the matmul configs are timed
MM_FULL = (2048, 4224, 4096)  # 528 tiles of 128 x 128: 4 full waves on 132 SMs

# Tolerances of the kernels against their plain versions.  Matmul: the JAX
# package's kernel tests (f32 atol 1e-4*sqrt(K), rtol 1e-4; bf16 atol
# 8e-2*sqrt(K), rtol 5e-2).  Flash f32: the JAX kernel tests' atol 2e-5.
# Flash bf16, per element: the kernel rounds P to bf16 (unit roundoff
# 2^-8) as the A operand of P V, so its sum sum_j p_j v_j / l may move by
# up to 2^-8 sum_j p_j |v_j| / l, which is flash_attention_plain(q, k, |v|);
# that is the atol.  Both outputs are then rounded to bf16 once: the rtol
# 2^-8.  The rest (S scaled after the product instead of q before it, the
# order of f32 sums, exp2f) is f32 rounding, orders of magnitude below.
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


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


WGMMA_KERNELS = ("mm_wgmma_kernel", "fa_wgmma_kernel")   # the bf16 instances
FFMA_KERNELS = ("mm_kernel", "fa_fwd_kernel")             # the float32 instances


def kernel_label(mangled: str) -> str:
    """``fa_wgmma_kernel<128,128,64,bf16>`` from a mangled template name."""
    base = re.search(r"(mm_wgmma_kernel|fa_wgmma_kernel|mm_kernel|"
                     r"fa_fwd_kernel)", mangled)
    ints = re.findall(r"Li(\d+)E", mangled)
    if not base:
        return mangled[:60]
    kind = "bf16" if base.group(1) in WGMMA_KERNELS else "f32"
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
    # runs FFMA and no tensor-core instruction (true f32, no TF32)
    hgmma, ffma = {}, {}
    for name in build.SOURCES:
        for mangled, code in build.sass(name).items():
            label = kernel_label(mangled)
            if label.startswith(WGMMA_KERNELS):
                hgmma[label] = code.count("HGMMA")
            elif label.startswith(FFMA_KERNELS):
                ffma[label] = {op: len(re.findall(rf"\b{op}\b", code))
                               for op in ("FFMA", "HMMA", "HGMMA")}
    want = len(mk.CONFIGS) + len(fk.CONFIGS) * len(fk.HEAD_DIMS)
    if len(hgmma) != want or not all(hgmma.values()):
        raise AssertionError(f"HGMMA missing from the SASS of a bf16 "
                             f"instance ({want} expected): {hgmma}")
    if len(ffma) != want or not all(c["FFMA"] and not c["HMMA"] and
                                    not c["HGMMA"] for c in ffma.values()):
        raise AssertionError(f"a float32 instance lacks FFMA or uses the "
                             f"tensor cores ({want} expected): {ffma}")
    for fns in summary.values():
        for label, f in fns.items():
            if f.get("spill_stores", 0) or f.get("spill_loads", 0):
                raise AssertionError(f"{label} spills: {f}")
    serialised = [line for log in logs.values() for line in log.splitlines()
                  if "Performance Loss" in line]
    if serialised:
        raise AssertionError(f"ptxas serialised wgmma: {serialised}")
    # the shared memory the library launches with is what Python budgets
    dynamic_smem, bad = {}, []
    for dt in (torch.float32, torch.bfloat16):
        for c in mk.CONFIGS:
            py, lib = c.smem_bytes(dt), mk.library_smem(c, dt)
            dynamic_smem[f"{c.name}/{dt}"] = lib
            bad += [(c.name, str(dt), py, lib)] if py != lib else []
        for c in fk.CONFIGS:
            for hd in fk.HEAD_DIMS:
                py, lib = c.smem_bytes(hd, dt), fk.library_smem(c, hd, dt)
                dynamic_smem[f"{c.name}/hd{hd}/{dt}"] = lib
                bad += [(c.name, hd, str(dt), py, lib)] if py != lib else []
    if bad:
        raise AssertionError(f"dynamic shared memory differs from Python's "
                             f"smem_bytes: {bad}")
    occupancy = float32_occupancy(summary, ffma)
    # ptxas says "Potential Performance Loss" where it serialises wgmma
    warnings = sorted({line.strip() for log in logs.values()
                       for line in log.splitlines()
                       if "warning" in line.lower() or "Performance Loss" in line})
    out = dict(seconds=build_s, ptxas=summary, hgmma_count=hgmma,
               float32_sass=ffma, float32_occupancy=occupancy,
               dynamic_smem_bytes=dynamic_smem, compiler_warnings=warnings)
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
                   c.threads, c.smem_bytes(hd, torch.float32),
                   fk.library_blocks_per_sm(c, hd), hd)
                  for c in fk.CONFIGS for hd in fk.HEAD_DIMS]
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


def check_flash(dtypes):
    """Causal and not, window 64, every instantiated head dim, GQA, ragged
    and unequal lengths (bottom-right causal alignment), both configs; in
    bf16 every (config, hd) goes through TMA, and strided views (TMA) and
    tensors 2 bytes off alignment or with an odd row stride (the second
    load path) are added; then the decode and serve paths' shapes
    (``decode_path_cases``), the grid path's (``grid_path_cases``) and
    the schedule path's (``schedule_path_cases``)."""
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
    ] + decode_path_cases() + grid_path_cases() + schedule_path_cases()
    worst = 0.0
    rows = []
    for cfg in fk.CONFIGS:
        for dname in dtypes:
            dt = getattr(torch, dname)
            for B, Sq, Skv, H, Hkv, hd, causal, window, layout in cases:
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
    """Sampled unseen shapes: the oracle's pick among the hand kernels, the
    measured fastest, and every config's prediction error."""
    dev = store.meta["device"]
    oracle = PM2Lat(store, dev).oracle
    rng = np.random.default_rng(0)
    out = {"mm": [], "fa": []}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for _ in range(TABLE6_SAMPLES):
            m = 128 * int(rng.integers(1, 9))
            n = 128 * int(rng.integers(1, 9))
            k = 128 * int(rng.integers(1, 17))
            a = torch.ones((m, k), dtype=dt, device="cuda")
            b = torch.ones((k, n), dtype=dt, device="cuda")
            pick = oracle.select_matmul("matmul", dname, m, n,
                                        provider=PROVIDER_PALLAS).key.kernel
            meas, err = {}, {}
            for cfg in mk.CONFIGS:
                meas[cfg.name] = profiler.measure(
                    lambda a, b, cfg=cfg: mk.matmul_kernel(a, b, cfg), a, b)
                t = oracle.lookup("matmul", cfg.name, dname)
                pred = t.predict(m, n, k, tile=(cfg.bm, cfg.bn))
                err[cfg.name] = abs(pred - meas[cfg.name]) / meas[cfg.name]
            out["mm"].append({"dtype": dname, "shape": [m, n, k], "pick": pick,
                              "fastest": min(meas, key=meas.get),
                              "ms": {c: s * 1e3 for c, s in meas.items()},
                              "rel_err": err})
        for _ in range(TABLE6_SAMPLES):
            bh = int(rng.integers(2, 17))
            s = 128 * int(rng.integers(1, 9))
            hd = 64
            q = torch.ones((bh, s, hd), dtype=dt, device="cuda")
            pick = oracle.select_attention(dname, s, head_dim=hd,
                                           provider=PROVIDER_PALLAS).key.kernel
            flops = 4.0 * bh * s * s * hd
            meas, err = {}, {}
            for cfg in fk.CONFIGS:
                meas[cfg.name] = profiler.measure(
                    lambda q, k, v, cfg=cfg: fk.flash_attention_kernel(
                        q, k, v, cfg, causal=True), q, q, q)
                t = oracle.lookup("attention", cfg.name, dname)
                pred = flops / t.interpolate_throughput(s)
                err[cfg.name] = abs(pred - meas[cfg.name]) / meas[cfg.name]
            out["fa"].append({"dtype": dname, "bh": bh, "s": s, "hd": hd,
                              "pick": pick,
                              "fastest": min(meas, key=meas.get),
                              "ms": {c: x * 1e3 for c, x in meas.items()},
                              "rel_err": err})
    summary = {}
    for fam, rows in out.items():
        summary[fam] = {
            "oracle_pick_err_pct": 100 * float(np.mean(
                [r["rel_err"][r["pick"]] for r in rows])),
            "all_configs_err_pct": 100 * float(np.mean(
                [e for r in rows for e in r["rel_err"].values()])),
            "oracle_picked_fastest_pct": 100 * float(np.mean(
                [r["pick"] == r["fastest"] for r in rows]))}
    emit("table6", summary=summary, samples=out)
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
            model.cast_weights_(torch.bfloat16)   # once, before timing
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


def device_ms(fn, *args, n=20):
    """Device time of one call, from ``torch.profiler``'s device events
    over ``n`` calls; None when the profiler shows no device time."""
    fn(*args)
    torch.cuda.synchronize()
    with profile_cuda() as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    ms = sum(t for _, t in device_rows(prof).values())
    return ms / n if ms > 0 else None


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
# by name, for the share of a trace's busy time that the matmul rows price
GEMM_KERNEL = re.compile(r"gemm|gemv|nvjet|xmma|splitKreduce", re.IGNORECASE)


def forward_trace(fn, *args):
    """Where one call's time goes (a forward, a decode step).  Without the
    profiler: the host's time to enqueue it and the device's span from its
    first to its last kernel (CUDA events); where the two are close, the
    host sets the pace.  Under ``torch.profiler``: the device's busy time,
    the part of it in cuBLAS GEMM/GEMV kernels (``GEMM_KERNEL``), its idle
    share of that span, and the 10 kernels that take the most time."""
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
            "idle_share": (1 - busy / span) if busy else None,
            "kernel_launches": sum(c for c, _ in rows.values()),
            "top10": [[name[:90], c, t] for name, (c, t) in top]}


def hand_launches():
    return {"matmul": mk.matmul_kernel.launches,
            "flash_attention": fk.flash_attention_kernel.launches}


def reset_launches():
    mk.matmul_kernel.launches = 0
    fk.flash_attention_kernel.launches = 0


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
            model.cast_weights_(torch.bfloat16)
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


def decode_check(model, cfg, tokens):
    """One decode step at (B, ctx) = ``tokens.shape``: prefill ctx - 1
    tokens at capacity ctx, step eagerly, as a step planted one slot early
    and as a CUDA graph, and time the graph.  Returns the record of
    DECODE_CHECKS, the eager and graph step callables and the hand-kernel
    counts taken before the first step (``hand_launches_in_step`` covers
    the steps made here)."""
    dname = cfg.compute_dtype
    B, ctx = tokens.shape
    logits = model(tokens)
    want = logits[:, -1].float()
    del logits
    _, cache = model.prefill(tokens[:, :-1], max_len=ctx)
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
           "logits_rel_err": err, "logits_tol": DECODE_TOL[dname],
           "logits_ok": err <= DECODE_TOL[dname],
           "planted_fault_rel_err": fault_err,
           "planted_fault_caught": fault_err > DECODE_TOL[dname],
           "graph_bitwise": bool(torch.equal(eager, replay)),
           "hand_launches_in_step": launches_since(before),
           "graph_ms": graph_s * 1e3}
    return rec, eager_step, graph_step, before


def launches_since(before):
    return {k: v - before[k] for k, v in hand_launches().items()
            if v != before[k]}


def decode_record(model, pm, cfg, tokens):
    """``decode_check`` plus the eager step's time, both steps' traces and
    the scalar predictor's step."""
    dname = cfg.compute_dtype
    B, ctx = tokens.shape
    rec, eager_step, graph_step, before = decode_check(model, cfg, tokens)
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
    ``decode_step`` of each wave's prompts, greedy, on the card: the rids
    whose tokens differ, and each one's first differing step.  ``waves``
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
            logits, cache = model.prefill(toks.long().cuda(),
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
            model.cast_weights_(torch.bfloat16)
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
            model.cast_weights_(torch.bfloat16)
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
    model = model_registry.build(cfg, device="cuda", seed=0)
    model.cast_weights_(torch.bfloat16)
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


def kernel_lines(launches, mm_pick):
    """Each hand kernel in bf16 at the main path's shapes: its time (and
    each config's), its own device time, its plain version's time, one
    PyTorch call's (a yardstick only), and the card's bound.  The matmul is
    timed at MM_SHAPE in every config, ``mm_pick`` marked; the flash kernel
    at qwen2-0.5b's prefill attention in both configs.  Under ``float32``,
    the same numbers for the float32 instances (FFMA) at the same shapes,
    headed by ``mm_128x128x128`` (matmul) or the config ``select_config``
    picks (flash); the matmul's adds its time at the card-filling shape
    MM_FULL.  Every number here is measured, but ``bound_ms``."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32
    lines = []

    def bound(nbytes, flops, dname="bfloat16"):
        t_bytes = nbytes / H100_SXM.hbm_bw
        t_ops = flops / H100_SXM.peak(dname)
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def timed(run, *args):
        dev = device_ms(run, *args)
        return {"ms": profiler.measure(run, *args) * 1e3,
                "device_ms": "not measured" if dev is None else dev}

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
                "library_device_ms": libt["device_ms"], "configs": configs}

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
        "plain_ms": profiler.measure(mk.matmul_plain, a, b) * 1e3,
        "bound_ms": bms, "bound_by": by,
        "library_ms": lib["ms"], "library_device_ms": lib["device_ms"],
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
        "plain_ms": profiler.measure(plain, q, kk, vv) * 1e3,
        "bound_ms": bms, "bound_by": by,
        "library_ms": lib["ms"], "library_device_ms": lib["device_ms"],
        "configs": configs,
        "float32": float32(
            pick32.name, f32_configs,
            lambda q, k, v: fk.flash_attention_plain(q, k, v, pick32,
                                                     causal=True),
            f32_args, sdpa, tuple(map(per_head, f32_args)), nbytes, flops)})
    for line in lines:
        f = line["float32"]
        if not (line["ok"] and f["ok"] and f.get("card_filling", f)["ok"]):
            raise AssertionError(
                f"{line['name']} at the main-path shape: max err "
                f"{line['max_abs_err']} (bf16), {f['max_abs_err']} (float32)")
    return lines


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
    return {"config": cfg.name, "shape": [m, n, k], "max_abs_err": err,
            "ok": ok, **t, "tflops": tflops(t["device_ms"]),
            "library_ms": lib["ms"], "library_device_ms": lib["device_ms"],
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
    record = {}

    smi = phase_device()
    record["build"] = phase_build()

    mm_err, mm_rows = check_matmul(("float32", "bfloat16"))
    fa_err, fa_rows = check_flash(("float32", "bfloat16"))
    record["kernel_checks"] = {"matmul": mm_rows, "flash_attention": fa_rows}
    for kernel, rows in record["kernel_checks"].items():
        for row in rows:
            emit("check", kernel=kernel, **row)
    emit("kernels_vs_plain", matmul_checks=len(mm_rows),
         matmul_max_abs_err=mm_err, flash_checks=len(fa_rows),
         flash_max_abs_err=fa_err, all_ok=True,
         tolerances={"matmul (atol/sqrt(K), rtol)": MM_TOL,
                     "flash_attention (atol, rtol)": FA_TOL})

    # --- the main path: counts from 0, read right after ---
    reset_launches()
    store, record["calibrate"] = phase_calibrate()
    table6 = phase_table6(store)
    model = phase_model(store)
    launches = hand_launches()
    emit("main_path_launches", **launches)
    for name, n in launches.items():
        if n == 0:
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
    emit("path_launches", **by_path)
    for path in ("decode", "serve", "grid", "schedule", "service"):
        if by_path[path]["flash_attention"] == 0:
            raise AssertionError(f"the {path} path never launched "
                                 f"flash_attention")

    m, n, _ = MM_SHAPE
    mm_pick = PM2Lat(store, store.meta["device"]).oracle.select_matmul(
        "matmul", "bfloat16", m, n, provider=PROVIDER_PALLAS).key.kernel
    kernels = kernel_lines(launches, mm_pick)
    for line in kernels:
        line["launches_by_path"] = {p: n[line["name"]]
                                    for p, n in by_path.items()}
    floors = matmul_floors(next(x for x in kernels
                                if x["name"] == "matmul")["float32"])
    emit("matmul_floors", rows=floors)
    record.update(table6=table6, model=model, decode=decode,
                  decode_floors=decode_floors, serve=serving, grid=grid,
                  schedule=schedule, service=service, kernels=kernels,
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
