"""Time the port's qwen2-0.5b forward on one card in two forms of its norms
and rotary embedding, on the same host and card.

    python3 scripts/torch_forward_ops.py [ROUNDS]      # ROUNDS defaults to 2

``fused``: the model as it is: one ``F.rms_norm`` call a norm; the rope
factors built once a forward and each rotation five calls.  ``per_op``:
the norm as six PyTorch ops and the rope factors rebuilt for q and for k,
nine ops a rotation: the forms that ``core/opgraph.py``'s ``rmsnorm`` and
``rope`` snippets price.  (The forward still builds its factors once in
``per_op``; the layers do not use them.)  Both take the same f32
arithmetic.

The two forms alternate in one process (fused, per-op; per-op, fused; ...)
at B 8 x S 512, float32 and bfloat16, random weights from seed 0.  Prints
one JSON line per dtype: for each form the forward's time
(``profiler.measure``, one entry a round), the host's time to enqueue one
forward (the least of three), and the device kernels of one forward; and
the largest difference between the two forms' logits.  Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import registry as cfg_registry  # noqa: E402
from repro_torch.core import profiler  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.models.transformer import cast_weights_  # noqa: E402

MODEL = "qwen2-0.5b"
BATCH, SEQ = 8, 512


def rms_norm_ops(self, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * self.scale).to(dt)


def rope_ops(x, positions, theta: float):
    freqs = A.rope_freqs(x.shape[-1], theta, x.device)         # (hd/2,)
    ang = positions[..., None].float() * freqs                  # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def attention_ops(self, x, *, causal=True, window=None, compute_dtype=None,
                  rope=None):
    """``Attention.forward`` with ``rope_ops`` (``rope`` is not used):
    (out, (k, v))."""
    cfg = self.cfg
    B, S, _ = x.shape
    q = self.wq(x, compute_dtype).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = self.wk(x, compute_dtype).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = self.wv(x, compute_dtype).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    positions = torch.arange(S, device=x.device)[None, :]
    q = rope_ops(q, positions, cfg.rope_theta)
    k = rope_ops(k, positions, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return self.wo(o.reshape(B, S, -1), compute_dtype), (k, v)


@contextlib.contextmanager
def per_op():
    saved = L.RMSNorm.forward, A.Attention.forward
    L.RMSNorm.forward, A.Attention.forward = rms_norm_ops, attention_ops
    try:
        yield
    finally:
        L.RMSNorm.forward, A.Attention.forward = saved


FORMS = {"fused": contextlib.nullcontext, "per_op": per_op}


def host_enqueue_ms(model, tokens):
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(tokens)
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best * 1e3


def device_kernels(model, tokens):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model(tokens)
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_forward_ops: torch finds no CUDA device", file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is true f32
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg0 = cfg_registry.get(MODEL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg0.vocab_size, (BATCH, SEQ), generator=gen,
                           device="cuda")
    model = model_registry.build(
        dataclasses.replace(cfg0, compute_dtype="float32"), device="cuda",
        seed=0)
    for dname in ("float32", "bfloat16"):
        model.cfg = dataclasses.replace(cfg0, compute_dtype=dname)
        if dname == "bfloat16":
            cast_weights_(model, torch.bfloat16)
        out = {form: {"ms": []} for form in FORMS}
        with torch.no_grad():
            logits = {}
            for form, ctx in FORMS.items():
                with ctx():
                    logits[form] = model(tokens).float()
                    out[form]["host_enqueue_ms"] = host_enqueue_ms(model, tokens)
                    out[form]["device_kernels"] = device_kernels(model, tokens)
            diff = float((logits["fused"] - logits["per_op"]).abs().max())
            del logits
            for r in range(rounds):
                for form in (FORMS if r % 2 == 0 else reversed(FORMS)):
                    with FORMS[form]():
                        out[form]["ms"].append(
                            profiler.measure(model, tokens) * 1e3)
        print(json.dumps({"model": MODEL, "batch": BATCH, "seq": SEQ,
                          "dtype": dname, **out,
                          "max_abs_logit_diff": diff, "nvidia_smi": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
