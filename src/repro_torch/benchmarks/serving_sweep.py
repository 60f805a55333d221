"""Serving-prediction benchmark: the batched ``latency_serve`` over a
(capacity, tp, mix variant) grid, timed against the per-point loop (the
JAX package's ``benchmarks/serving_sweep.py`` on the card's store).

``LatencyService.sweep_serve`` prices the whole continuous-batching grid
in one batched pass: prefill forwards through the cached scalar endpoints,
one ``predict_decode_grid`` call per tp shared by every capacity and mix
variant, and one event-driven ``schedule.simulate_serving_batch`` call a
mix.  This benchmark times that sweep cold (predictions computed) and warm
(every point a cache hit), prices the same grid again point by point (each
point its own decode grid and the naive token-by-token
``simulate_serving_steps`` loop), and reports the ``speedup`` and the
``max_rel_err`` between the two answer sets (exactly zero everywhere but
occupancy, whose accumulation order differs).

    PYTHONPATH=src python -m repro_torch.benchmarks.serving_sweep
        [--arch qwen3-mini] [--device a100_80g] [--capacities 1,2,4,8,16,32]
        [--tps 1,2,4] [--prompts 128,512] [--outputs 32,512]
        [--requests 64] [--mix-variants 8] [--json PATH] [--dry-run]
        [--torch-device cuda]

``--dry-run`` sweeps a small grid on the reduced arch and asserts the JAX
package's goldens (``dry_run``): the zero-decode mix is bit-identical to
``latency_query``, decode attention carries the ``kv_read@gqaN`` kernel
attribution, and the batched sweep matches the per-point loop and is
faster.  The record goes to ``--json`` or
``artifacts/torch/BENCH_serving_sweep[_dry].json``.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.benchmarks import common
from repro_torch.configs import registry as cr
from repro_torch.core import opgraph as og
from repro_torch.core import schedule as S
from repro_torch.core.device import resolve
from repro_torch.core.schedule import ServingStats, TrafficMix
from repro_torch.serving.latency_service import LatencyService

DRY_ARCH = "qwen2-0.5b-reduced"


def _service(store) -> LatencyService:
    return LatencyService(store, store.meta["device"])


def _loop_sweep(store, arch, device, mixes, capacities, tps, dtype):
    """Every (mix, capacity, tp) point prices its own decode grid and runs
    the naive token-by-token loop (one decode step an iteration), on a
    fresh service."""
    svc = _service(store)
    cfg = svc._resolve(arch)
    out = []
    for mix in mixes:
        for c in capacities:
            for tp in tps:
                tab = svc._serve_tables(cfg, mix.prompt_lens, mix.max_ctx,
                                        capacity=int(c), tp=int(tp),
                                        dtype=dtype, device=device)
                out.append(S.simulate_serving_steps(mix, int(c), tab.prefill,
                                                    tab.decode))
    return out


def run(store=None, *, arch="qwen3-mini", device="a100_80g",
        capacities=(1, 2, 4, 8, 16, 32), tps=(1, 2, 4),
        prompts=(128, 512), outputs=(32, 512), requests=64, mix_variants=8,
        dtype=None, verbose=True, torch_device="cuda"):
    """(record, the service that swept, the base mix)."""
    store = store or common.get_calibration(resolve(torch_device))
    base = TrafficMix(prompt_lens=tuple(prompts), output_lens=tuple(outputs),
                      n_requests=int(requests))
    mixes = [dataclasses.replace(base, seed=s)
             for s in range(max(1, int(mix_variants)))]
    n = len(capacities) * len(tps) * len(mixes)
    svc = _service(store)

    # one-time warm-ups (oracle tables, per-shape kernel-scoring caches) on
    # a throwaway service, so that neither timed path pays for them
    wsvc = _service(store)
    wmix = dataclasses.replace(base, n_requests=2)
    for tp in tps:
        wsvc.latency_serve(arch, wmix, capacity=int(max(capacities)),
                           tp=int(tp), dtype=dtype, device=device)

    with common.timer() as t_cold:
        results = svc.sweep_serve(arch, mixes, capacities, tps=tps,
                                  dtype=dtype, device=device)
    with common.timer() as t_warm:
        warm = svc.sweep_serve(arch, mixes, capacities, tps=tps,
                               dtype=dtype, device=device)
    assert all(w.cached for w in warm), "warm sweep missed the cache"
    assert all(w.tokens_per_sec == r.tokens_per_sec
               for w, r in zip(warm, results)), "cache changed the answer"

    # the per-point decode grids and the naive step loop, in sweep_serve's
    # (mix, capacity, tp) order
    with common.timer() as t_loop:
        loop = _loop_sweep(store, arch, device, mixes, capacities, tps,
                           dtype)
    max_rel = 0.0
    for r, st in zip(results, loop):
        for f in ServingStats.FIELDS:
            a, b = float(getattr(st, f)), float(getattr(r, f))
            if f != "occupancy":
                assert a == b, ("batched != loop", r.capacity, r.tp,
                                r.mix_tag, f, a, b)
            if a != b:
                max_rel = max(max_rel, abs(a - b) / max(abs(a), abs(b)))

    cold_pps = n / t_cold.s
    warm_pps = n / t_warm.s
    speedup = t_loop.s / t_cold.s
    best = max(results, key=lambda r: r.tokens_per_sec)
    res = {
        "arch": results[0].model, "device": results[0].device,
        "dtype": dtype or "float32", "mix": {
            "prompt_lens": list(prompts), "output_lens": list(outputs),
            "n_requests": int(requests), "tag": base.tag(),
            "max_ctx": base.max_ctx},
        "mix_variants": len(mixes),
        "n_points": n, "cold_seconds": t_cold.s,
        "cold_points_per_sec": cold_pps,
        "warm_seconds": t_warm.s, "warm_points_per_sec": warm_pps,
        "warm_speedup": warm_pps / cold_pps,
        "loop_seconds": t_loop.s, "speedup": speedup,
        "max_rel_err": max_rel,
        "points": [r.to_json() for r in results],
        "best": best.to_json(),
    }
    if verbose:
        print(f"serve grid: {n} points  cold {t_cold.s*1e3:.1f}ms "
              f"({cold_pps:,.1f}/s)  warm {t_warm.s*1e3:.1f}ms "
              f"({warm_pps:,.0f}/s)")
        print(f"per-point loop: {t_loop.s*1e3:.1f}ms -> batched speedup "
              f"{speedup:.1f}x  max_rel_err {max_rel:.2e} "
              f"(exact everywhere but occupancy)")
        print(f"best point: cap{best.capacity}.tp{best.tp}  "
              f"{best.tokens_per_sec:,.0f} tok/s  "
              f"ttft_p95 {best.ttft_p95*1e3:.2f}ms  "
              f"tpot_p95 {best.tpot_p95*1e3:.3f}ms  "
              f"gqa {best.gqa_ratio:.0f}")
    common.emit("serving_sweep/cold_points_per_sec", 1e6 / cold_pps,
                f"{cold_pps:.1f}/s over {n} points")
    common.emit("serving_sweep/warm_points_per_sec", 1e6 / warm_pps,
                f"{warm_pps:.0f}/s (speedup {warm_pps / cold_pps:.0f}x)")
    common.emit("serving_sweep/batched_vs_loop_speedup", 1e3 / speedup,
                f"{speedup:.1f}x over the per-point loop")
    return res, svc, base


def dry_run(store=None, *, device="a100_80g", dtype=None,
            torch_device="cuda") -> dict:
    """A small grid on the reduced arch with the JAX package's goldens."""
    res, svc, _ = run(store, arch=DRY_ARCH, device=device,
                      capacities=(1, 2, 4), tps=(1, 2),
                      prompts=(16, 32), outputs=(4, 8), requests=16,
                      mix_variants=2, dtype=dtype, torch_device=torch_device)
    # golden 1: the zero-decode mix == latency_query, bit for bit
    dmix = TrafficMix(prompt_lens=(32,), output_lens=(1,), n_requests=1)
    rd = svc.latency_serve(DRY_ARCH, dmix, capacity=1, dtype=dtype,
                           device=device)
    q = svc.latency_query(DRY_ARCH, 1, 32, dtype=dtype, device=device)
    assert rd.ttft_p50 == q.seconds == rd.makespan, (rd.ttft_p50, q.seconds)
    # golden 2: decode attention carries the GQA kernel attribution
    cfg = cr.get_any(DRY_ARCH)
    _, rows = svc.predictor.predict_ops(og.enumerate_decode_ops(cfg, 2, 48))
    kres = {r.kernel for r in rows
            if r.kind == "attention" and r.kernel.startswith("kv_read")}
    assert kres, "no memory-bound decode-attention rows"
    # golden 3: the batched sweep == the per-point loop (run() asserts each
    # field but occupancy exactly) and is faster
    assert res["max_rel_err"] < 1e-9, res["max_rel_err"]
    assert res["speedup"] > 1.0, res["speedup"]
    print(f"dry-run golden check ok (degenerate == latency_query; "
          f"decode kernels {sorted(kres)}; batched==loop at "
          f"{res['speedup']:.1f}x, max_rel_err {res['max_rel_err']:.1e})")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-mini")
    ap.add_argument("--device", default="a100_80g")
    ap.add_argument("--capacities", default="1,2,4,8,16,32")
    ap.add_argument("--tps", default="1,2,4")
    ap.add_argument("--prompts", default="128,512")
    ap.add_argument("--outputs", default="32,512")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--mix-variants", type=int, default=8,
                    help="trace-seed variants of the mix; the batched "
                         "sweep shares tables across them, the per-point "
                         "loop cannot")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--dry-run", action="store_true",
                    help="small grid on the reduced arch + golden checks")
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)
    ints = lambda s: tuple(int(x) for x in s.split(","))
    store = common.get_calibration(resolve(args.torch_device))
    if args.dry_run:
        res = dry_run(store, device=args.device, dtype=args.dtype)
    else:
        res, _, _ = run(store, arch=args.arch, device=args.device,
                        capacities=ints(args.capacities),
                        tps=ints(args.tps), prompts=ints(args.prompts),
                        outputs=ints(args.outputs), requests=args.requests,
                        mix_variants=args.mix_variants, dtype=args.dtype)
    res["dry_run"] = bool(args.dry_run)
    path = common.write_bench("serving_sweep", res, dry=args.dry_run,
                              path=args.json)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
