"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main path, the paper's loop on one device: time kernels
on the card (calibration), turn the timings into throughput tables and the
memory-bound regression, predict qwen2-0.5b at full width, and measure the
same forward pass on the same card.  Before that it builds the hand-written
CUDA kernels from ``src/repro_torch/kernels/csrc`` and holds each against its
plain PyTorch version on the card.  Every phase prints one JSON line; the
full record (and the calibrated store) goes to ``chiprun_out/``.

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
from repro_torch.core import profiler  # noqa: E402
from repro_torch.core.device import H100_SXM  # noqa: E402
from repro_torch.core.oracle import PROVIDER_PALLAS  # noqa: E402
from repro_torch.core.predictor import PM2Lat  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import matmul as mk  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402

MODEL = "qwen2-0.5b"
BATCH, SEQ = 8, 512
TABLE6_SAMPLES = 6

# Tolerances of the kernels against their plain versions.  Matmul: the JAX
# package's kernel tests (f32 atol 1e-4*sqrt(K), rtol 1e-4; bf16 atol
# 8e-2*sqrt(K), rtol 5e-2).  Flash f32: the JAX kernel tests' atol 2e-5.
# Flash bf16: both sides compute in f32 from the same bf16 inputs and round
# once to bf16, so they differ by at most one bf16 ulp (2^-7 relative).
MM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-2, 5e-2)}   # (atol/sqrt(K), rtol)
FA_TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-3, 1e-2)}    # (atol, rtol)


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


def kernel_label(mangled: str) -> str:
    """``fa_fwd_kernel<128,128,64,bf16>`` from a mangled template name."""
    base = re.search(r"(mm_kernel|fa_fwd_kernel)", mangled)
    ints = re.findall(r"Li(\d+)E", mangled)
    kind = "bf16" if "bfloat16" in mangled else "f32"
    if not base:
        return mangled[:60]
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
    for name in build.SOURCES:
        build.load(name)
    dynamic_smem = {c.name: {"float32": c.smem_bytes(torch.float32),
                             "bfloat16": c.smem_bytes(torch.bfloat16)}
                    for c in mk.CONFIGS}
    dynamic_smem.update({c.name: {f"hd{hd}": c.smem_bytes(hd)
                                  for hd in fk.HEAD_DIMS} for c in fk.CONFIGS})
    emit("build", seconds=time.time() - t0, ptxas=summary,
         dynamic_smem_bytes=dynamic_smem)


def check_matmul(dtypes):
    """Every config, both types, aligned and ragged shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    rows = []
    for cfg in mk.CONFIGS:
        for dname in dtypes:
            dt = getattr(torch, dname)
            atol_k, rtol = MM_TOL[dname]
            for M, K, N in ((2 * cfg.bm, 3 * cfg.bk, 2 * cfg.bn),
                            (2 * cfg.bm + 37, 2 * cfg.bk + 19, cfg.bn + 23),
                            (5, 7, 3)):
                a = torch.randn(M, K, generator=gen, device="cuda").to(dt)
                b = torch.randn(K, N, generator=gen, device="cuda").to(dt)
                got = mk.matmul_kernel(a, b, cfg)
                torch.cuda.synchronize()
                err, ok = close(got, mk.matmul_plain(a, b),
                                atol_k * K ** 0.5, rtol)
                rows.append({"cfg": cfg.name, "dtype": dname,
                             "shape": [M, K, N], "max_abs_err": err, "ok": ok})
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(f"matmul {cfg.name} {dname} "
                                         f"{(M, K, N)}: max err {err}")
    return worst, rows


def check_flash(dtypes):
    """Causal and not, window 64, every instantiated head dim, GQA, ragged
    and unequal lengths (bottom-right causal alignment), both configs."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (B, Sq, Skv, H, Hkv, hd, causal, window)
        (2, 256, 256, 3, 3, 64, True, None),
        (2, 256, 256, 3, 3, 64, False, None),
        (1, 256, 256, 2, 2, 32, True, 64),
        (1, 256, 256, 4, 4, 16, True, None),
        (1, 128, 128, 2, 2, 128, True, None),
        (2, 512, 512, 14, 2, 64, True, None),     # qwen2-0.5b's geometry
        (1, 200, 200, 4, 2, 32, True, None),      # ragged S
        (1, 100, 300, 4, 1, 64, True, None),      # Sq < Skv, ragged
        (1, 77, 77, 2, 2, 64, False, None),
    ]
    worst = 0.0
    rows = []
    for cfg in fk.CONFIGS:
        for dname in dtypes:
            dt = getattr(torch, dname)
            atol, rtol = FA_TOL[dname]
            for B, Sq, Skv, H, Hkv, hd, causal, window in cases:
                q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dt)
                k = torch.randn(B, Skv, Hkv, hd, generator=gen, device="cuda").to(dt)
                v = torch.randn(B, Skv, Hkv, hd, generator=gen, device="cuda").to(dt)
                kw = dict(causal=causal, window=window, q_offset=Skv - Sq)
                got = fk.flash_attention_kernel(q, k, v, cfg, **kw)
                torch.cuda.synchronize()
                want = fk.flash_attention_plain(q, k, v, cfg, **kw)
                err, ok = close(got, want, atol, rtol)
                rows.append({"cfg": cfg.name, "dtype": dname,
                             "case": [B, Sq, Skv, H, Hkv, hd, causal, window],
                             "max_abs_err": err, "ok": ok})
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(
                        f"flash {cfg.name} {dname} {(B, Sq, Skv, H, Hkv, hd)}"
                        f" causal={causal} window={window}: max err {err}")
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
    emit("calibrate", seconds=store.meta["seconds"], device=store.meta["device"],
         tables=len(store.tables),
         families={k: sorted(v) for k, v in kinds.items()},
         memory_model_train_rel_err=mm["train_rel_err"])
    return store


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


def kernel_lines(table6, launches):
    """Each hand kernel at the main path's shape: its time, its plain
    version's, one PyTorch call's (a yardstick only), and the card's bound."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    lines = []

    def bound(nbytes, flops, dname):
        t_bytes = nbytes / H100_SXM.hbm_bw
        t_ops = flops / H100_SXM.peak(dname)
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")

    # matmul: the largest Table VI shape in bf16, at the oracle's pick
    big = max((r for r in table6["mm"] if r["dtype"] == "bfloat16"),
              key=lambda r: np.prod(r["shape"]))
    m, n, k = big["shape"]
    cfg = next(c for c in mk.CONFIGS if c.name == big["pick"])
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn(k, n, generator=gen, device="cuda").to(torch.bfloat16)
    err, ok = close(mk.matmul_kernel(a, b, cfg), mk.matmul_plain(a, b),
                    MM_TOL["bfloat16"][0] * k ** 0.5, MM_TOL["bfloat16"][1])
    bms, by = bound(2 * (m * k + k * n + m * n), 2.0 * m * n * k, "bfloat16")
    lines.append({
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:89",
        "launches": launches["matmul"], "max_abs_err": err, "ok": ok,
        "config": cfg.name, "shape": [m, n, k], "dtype": "bfloat16",
        "ms": profiler.measure(lambda a, b: mk.matmul_kernel(a, b, cfg),
                               a, b) * 1e3,
        "plain_ms": profiler.measure(mk.matmul_plain, a, b) * 1e3,
        "bound_ms": bms, "bound_by": by,
        "library_ms": profiler.measure(torch.matmul, a, b) * 1e3})

    # flash: qwen2-0.5b's prefill attention, bf16, as the model calls it
    c = cfg_registry.get(MODEL)
    B, S, H, Hkv, hd = BATCH, SEQ, c.n_heads, c.n_kv_heads, c.head_dim
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(torch.bfloat16)
    kk = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(torch.bfloat16)
    vv = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(torch.bfloat16)
    fcfg = fk.select_config(S, S, hd)
    run = lambda q, k, v: fk.flash_attention_kernel(q, k, v, fcfg, causal=True)
    plain = lambda q, k, v: fk.flash_attention_plain(q, k, v, fcfg, causal=True)
    err, ok = close(run(q, kk, vv), plain(q, kk, vv), *FA_TOL["bfloat16"])
    # the causal mask needs S(S+1)/2 of the S^2 score pairs
    flops = 4.0 * B * H * hd * S * (S + 1) / 2
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
    bms, by = bound(nbytes, flops, "bfloat16")
    qt = q.transpose(1, 2).contiguous()
    kt = kk.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vt = vv.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    sdpa = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True)
    lines.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:87",
        "launches": launches["flash_attention"], "max_abs_err": err, "ok": ok,
        "config": fcfg.name, "shape": [B, S, H, Hkv, hd], "dtype": "bfloat16",
        "ms": profiler.measure(run, q, kk, vv) * 1e3,
        "plain_ms": profiler.measure(plain, q, kk, vv) * 1e3,
        "bound_ms": bms, "bound_by": by,
        "library_ms": profiler.measure(sdpa, qt, kt, vt) * 1e3})
    for line in lines:
        if not line["ok"]:
            raise AssertionError(f"{line['name']} at the main-path shape: max "
                                 f"err {line['max_abs_err']}")
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is true f32
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    record = {}

    smi = phase_device()
    phase_build()

    mm_err, mm_rows = check_matmul(("float32", "bfloat16"))
    fa_err, fa_rows = check_flash(("float32", "bfloat16"))
    record["kernel_checks"] = {"matmul": mm_rows, "flash_attention": fa_rows}
    emit("kernels_vs_plain", matmul_checks=len(mm_rows),
         matmul_max_abs_err=mm_err, flash_checks=len(fa_rows),
         flash_max_abs_err=fa_err, all_ok=True,
         tolerances={"matmul (atol/sqrt(K), rtol)": MM_TOL,
                     "flash_attention (atol, rtol)": FA_TOL})

    # --- the main path: counts from 0, read right after ---
    mk.matmul_kernel.launches = 0
    fk.flash_attention_kernel.launches = 0
    store = phase_calibrate()
    table6 = phase_table6(store)
    model = phase_model(store)
    launches = {"matmul": mk.matmul_kernel.launches,
                "flash_attention": fk.flash_attention_kernel.launches}
    emit("main_path_launches", **launches)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {name}")

    kernels = kernel_lines(table6, launches)
    record.update(table6=table6, model=model, kernels=kernels,
                  nvidia_smi=smi, seconds=time.time() - t_start)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))

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
