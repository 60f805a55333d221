"""The hand flash forward alone on one card: the elements over their limit
in ``chip_smoke.py``'s ``check_flash``, or its bf16 times.

    python3 scripts/flash_fwd_check.py                  # elements over
    python3 scripts/flash_fwd_check.py --src DIR        # another tree's
    python3 scripts/flash_fwd_check.py --time [--src DIR]

Without ``--time``: builds the kernels (``phase_build``) and runs
``check_flash`` over the same cases and the same seeded draws, but where a
bf16 case misses its limit it records, instead of failing, up to 8 of the
elements over it: the index, the kernel's and the plain version's bf16
values, the element's atol and limit, and there the float32 kernel's and
the float32 plain version's outputs on the same inputs in float32.
Prints the list (an empty one is a pass) and writes it to
``chiprun_out/flash_diag<tag>.json``.  ``--time``: instead, the bf16
kernel's ``ms`` and ``device_ms`` (``chip_smoke.timed``) at the model
paths' attention (``TIMED``), in the config ``select_config`` picks.
``--src`` takes ``repro_torch`` from another checkout's ``src`` (an older
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists), so that two versions run on one card in one call.  The card's
name and power limit first.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (arch, B, Sq, Skv, causal, window): qwen2-0.5b's prefill, moonshot's,
# recurrentgemma-2b's local attention, and phase archs' three calls
TIMED = (("qwen2-0.5b", 8, 512, 512, True, None),
         ("moonshot-v1-16b-a3b", 8, 512, 512, True, None),
         ("recurrentgemma-2b", 8, 512, 512, True, 2048),
         ("gemma-7b", 8, 512, 512, True, None),
         ("llama-3.2-vision-11b", 8, 512, 1601, False, None),
         ("starcoder2-15b", 8, 512, 512, True, None))


def elements(cs, torch):
    fk = cs.fk
    close, kernel, plain = cs.close, fk.flash_attention_kernel, \
        fk.flash_attention_plain
    found, last = [], {}

    def recording_kernel(q, k, v, cfg, **kw):
        last["args"] = (q, k, v, cfg, kw)
        return kernel(q, k, v, cfg, **kw)

    # the wrapper's counters, which ``_launch`` moves on the module's name
    recording_kernel.launches = 0
    recording_kernel.launches_by_hd = {}
    recording_kernel.launches_by_causal = {}

    def recording_close(got, want, atol, rtol):
        err, ok = close(got, want, atol, rtol)
        if ok or got.dtype != torch.bfloat16:
            return err, ok
        g, w = got.float(), want.float()
        a = atol if torch.is_tensor(atol) else torch.full_like(w, atol)
        bad = (g - w).abs() > a + rtol * w.abs()
        q, k, v, cfg, kw = last["args"]
        k32 = kernel(q.float(), k.float(), v.float(), cfg, **kw)
        p32 = plain(q.float(), k.float(), v.float(), cfg, **kw)
        elems = []
        for i in map(tuple, bad.nonzero()[:8].tolist()):
            elems.append({"idx": list(i), "got": float(g[i]),
                          "want": float(w[i]), "atol": float(a[i]),
                          "tol": float(a[i] + rtol * w[i].abs()),
                          "kernel_f32_inputs_f32": float(k32[i]),
                          "plain_f32": float(p32[i])})
        found.append({"case": [list(q.shape), list(k.shape), cfg.name, kw,
                               fk.load_path(q, k, v)],
                      "n_bad": int(bad.sum()), "err": err, "elems": elems})
        return err, True

    fk.flash_attention_kernel = recording_kernel
    cs.close = recording_close
    try:
        cs.check_flash(("float32", "bfloat16"))
    finally:
        fk.flash_attention_kernel, cs.close = kernel, close
    return found


def times(cs, torch):
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for arch, B, Sq, Skv, causal, window in TIMED:
        c = cs.cfg_registry.get_any(arch)
        q, k, v = (torch.randn(B, S, n, c.head_dim, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for S, n in ((Sq, c.n_heads), (Skv, c.n_kv_heads),
                                (Skv, c.n_kv_heads)))
        cfg = cs.fk.select_config(Sq, Skv, c.head_dim)
        kw = dict(causal=causal, window=window, q_offset=Skv - Sq)
        run = lambda q, k, v: cs.fk.flash_attention_kernel(q, k, v, cfg, **kw)
        rows.append({"arch": arch, "shape": [B, Sq, Skv, c.n_heads,
                                             c.n_kv_heads, c.head_dim],
                     "causal": causal, "window": window, "config": cfg.name,
                     **cs.timed(run, q, k, v)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true",
                    help="the bf16 times only (no build report, no checks)")
    ap.add_argument("--src", help="the src directory of another checkout")
    args = ap.parse_args()
    if args.src:
        # imported first, so that chip_smoke's imports find this tree's
        sys.path.insert(0, str(Path(args.src).resolve()))
        import repro_torch.kernels.flash_attention  # noqa: F401
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    src = Path(cs.fk.__file__).resolve().parents[2]
    print(json.dumps({"nvidia_smi": cs.nvidia_smi(), "src": str(src)}),
          flush=True)
    cs.OUT.mkdir(exist_ok=True)
    if args.time:
        for row in times(cs, torch):
            print(json.dumps({"src": str(src), **row}), flush=True)
        return 0
    cs.phase_build()
    found = elements(cs, torch)
    tag = "_src" if args.src else ""
    (cs.OUT / f"flash_diag{tag}.json").write_text(json.dumps(found, indent=1))
    print(json.dumps({"src": str(src), "over_limit": found}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
