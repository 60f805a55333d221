"""Training objective: causal-LM cross entropy over the padded vocab, the
router's auxiliary losses and the z-loss (the JAX package's
``training/objective.py``).

Two cross-entropy paths:
  - ``fused`` (default): never holds (tokens, vocab) logits for the whole
    sequence: a loop over sequence chunks computes each chunk's logits from
    the hidden states, its log-sum-exp and the label's log-probability,
    under non-reentrant ``torch.utils.checkpoint``, so the backward
    recomputes each chunk's logits in place of keeping them;
  - ``naive``: the full logits, then the softmax.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as sh

LB_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4
_CE_TARGET_ELEMS = 1 << 24  # per-chunk global logits budget (elements)


def _mask_padded(logits, vocab_size: int):
    """Logits of the padded vocab entries set to -1e30."""
    Vp = logits.shape[-1]
    if Vp > vocab_size:
        iota = sh.replicate_like(torch.arange(Vp, device=logits.device),
                                 logits)
        logits = torch.where(iota < vocab_size, logits, -1e30)
    return logits


def _label_logit(logits, labels):
    """logits (..., Vp) at each label (...,).  A DTensor's vocab may be
    sharded: there each rank keeps its own vocab slice's label logit and
    zeros (a sum over the vocab then adds one value to zeros, exactly)."""
    if not sh.is_sharded(logits):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    iota = sh.replicate_like(
        torch.arange(logits.shape[-1], device=logits.device), logits)
    return torch.where(iota == labels[..., None], logits, 0.0).sum(-1)


def cross_entropy(logits, labels, vocab_size: int):
    """Naive CE. logits (B, S, Vp); labels (B, S). Mean over tokens, f32."""
    logits = _mask_padded(logits.float(), vocab_size)
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - _label_logit(logits, labels)).mean()


def _ce_chunk(S: int, batch: int, padded_vocab: int) -> int:
    """Sequence positions a chunk: the largest divisor of S within the
    logits budget (at least 16 positions' worth)."""
    target = max(16, _CE_TARGET_ELEMS // max(batch * padded_vocab // 256, 1))
    ch = 1
    for c in range(1, S + 1):
        if S % c == 0 and c <= target:
            ch = c
    return ch


def _chunk_ce(x_c, y_c, w, vocab_size: int, compute_dtype):
    """Sum over one chunk's tokens of lse - the label's logit."""
    logits = sh.constrain(x_c.to(compute_dtype) @ w.T, "dp", None, "tp")
    logits = _mask_padded(logits.float(), vocab_size)
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - _label_logit(logits, y_c)).sum()


def fused_cross_entropy(hidden, unembed_w, labels, vocab_size: int,
                        compute_dtype=torch.bfloat16):
    """hidden (B, S, d) -> mean CE without holding (B, S, Vp) logits: a loop
    over ``_ce_chunk`` sequence positions at a time, each chunk checkpointed
    so that the backward recomputes its logits."""
    B, S, d = hidden.shape
    Vp = unembed_w.shape[0]
    ch = _ce_chunk(S, B, Vp)
    w = unembed_w.to(compute_dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, ch):
        total = total + checkpoint(_chunk_ce, hidden[:, s0:s0 + ch],
                                   labels[:, s0:s0 + ch], w, vocab_size,
                                   compute_dtype, use_reentrant=False,
                                   context_fn=sh.checkpoint_contexts)
    return total / (B * S)


def loss_fn(model, batch, *, block_skip: bool = False, fused_ce: bool = True,
            remat: bool = False):
    """batch: {"tokens", "labels"[, "ctx"]}.  Returns (loss, metrics) with
    metrics {"ce", "lb_loss", "z_loss"}, all f32 scalars.  ``remat``:
    ``Transformer.train_forward``'s per-block checkpointing."""
    cfg = model.cfg
    out, aux = model.train_forward(batch["tokens"], batch.get("ctx"),
                                   block_skip=block_skip,
                                   return_hidden=fused_ce, remat=remat)
    if fused_ce:
        ce = fused_cross_entropy(out, model.unembed_weight(), batch["labels"],
                                 cfg.vocab_size,
                                 compute_dtype=getattr(torch,
                                                       cfg.compute_dtype))
    else:
        ce = cross_entropy(out, batch["labels"], cfg.vocab_size)
    n_layers = max(cfg.n_layers, 1)
    loss = (ce + LB_LOSS_WEIGHT * aux["lb_loss"] / n_layers
            + Z_LOSS_WEIGHT * aux["z_loss"] / n_layers)
    return loss, {"ce": ce, "lb_loss": aux["lb_loss"],
                  "z_loss": aux["z_loss"]}
