"""Hold ``torch.profiler``'s device time against CUDA events on one card,
fresh and after each step of ``chip_smoke.py``'s phase ``paper``.

    python3 scripts/profiler_drift.py

``profiler_device_ms`` (the sum of a trace's device events over 20 calls,
divided by the calls made: how ``chip_smoke.py`` read ``device_ms`` until
it timed a replayed CUDA graph instead) and ``chip_smoke.py``'s
``device_ms`` against ``profiler.measure`` (CUDA events around
back-to-back calls) for one float32 GEMM at the card-filling 2048 x 4224 x
4096: ``torch.matmul`` (cuBLAS) and the hand ``mm_128x128x128``, with the
count of device events the 20 calls left in the trace.  Probed in a fresh
process, after calibrating the card (``calibrate_device``, the store the
paper phase reads), and after each step of the paper phase run as
``chip_smoke.phase_paper`` runs it: NeuSight's samples and training per
dtype, Table II, Table IV, the partition application.  Prints one JSON
line a probe and the card's name and power limit; exits non-zero without
a CUDA device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.benchmarks import partition_app  # noqa: E402
from repro_torch.benchmarks import table2_per_layer as table2  # noqa: E402
from repro_torch.benchmarks import table4_model_wise as table4  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import memory_model as memmod  # noqa: E402
from repro_torch.core import profiler  # noqa: E402
from repro_torch.core.baselines import neusight as ns  # noqa: E402
from repro_torch.kernels import matmul as mk  # noqa: E402


def profiled(fn, *args, n=20):
    """(device ms a call, device events) of a trace of ``n`` calls: the
    events' summed time divided by ``n``, the calls made."""
    fn(*args)
    torch.cuda.synchronize()
    with cs.profile_cuda() as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    rows = cs.device_rows(prof).values()
    return (sum(t for _, t in rows) / n, sum(calls for calls, _ in rows))


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_drift: torch finds no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    m, n, k = cs.MM_FULL
    a = torch.randn(m, k, generator=gen, device="cuda")
    b = torch.randn(k, n, generator=gen, device="cuda")
    cfg = mk.MatmulConfig(128, 128, 128)
    hand = lambda a, b: mk.matmul_kernel(a, b, cfg)

    def probe(tag):
        lib_ms, lib_events = profiled(torch.matmul, a, b)
        print(json.dumps({
            "probe": tag, "shape": [m, n, k],
            "torch_matmul_events_ms": profiler.measure(torch.matmul, a, b) * 1e3,
            "torch_matmul_profiler_device_ms": lib_ms,
            "torch_matmul_device_events": lib_events,
            "torch_matmul_device_ms": cs.device_ms(torch.matmul, a, b),
            "hand_events_ms": profiler.measure(hand, a, b) * 1e3,
            "hand_profiler_device_ms": profiled(hand, a, b)[0],
            "hand_device_ms": cs.device_ms(hand, a, b)}), flush=True)

    probe("fresh")
    store = cal.calibrate_device(device="cuda", verbose=False)
    probe("after_calibrate")
    mem_samples = memmod.collect_utility_samples(device="cuda")
    neusight = {}
    for dname in cs.DTYPES:
        samples = ns.collect_matmul_dataset(cs.PAPER_NS_SAMPLES, dtype=dname,
                                            seed=0, device="cuda")
        neusight[dname] = ns.train(
            samples, mem_samples, peak_flops=cs.best_matmul_anchor(store, dname),
            steps=cs.PAPER_NS_STEPS, seed=0, device="cuda")
    torch.cuda.synchronize()
    probe("after_neusight")
    table2.run(store, neusight, samples_per_layer=cs.PAPER_TABLE2_SAMPLES,
               device="cuda")
    probe("after_table2")
    table4.run(store, neusight, models=cs.PAPER_MODELS,
               batches=cs.PAPER_BATCHES, seq=cs.PAPER_SEQ, device="cuda")
    probe("after_table4")
    partition_app.run(store, neusight["float32"], device="cuda")
    probe("after_partition")
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
