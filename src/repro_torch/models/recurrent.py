"""The RG-LRU recurrent block of Griffin / RecurrentGemma (the RG-LRU half
of the JAX package's ``models/recurrent.py``).

A causal depthwise conv1d, the real-gated linear recurrent unit
h_t = a_t * h_{t-1} + b_t and the gated block around them.  Over a full
sequence the recurrence is an inclusive scan of (a, b) pairs under the JAX
package's ``combine``; here it runs by recursive doubling, log2(S)
elementwise passes over the whole sequence (the structure
``core/memory_model.py`` prices as ``assoc_scan``), never a loop over S.
Decode is one step with O(1) state: h (B, dl) in f32 and the conv's last
``width - 1`` inputs.

The JAX package has no Pallas kernel for any of this, so it is plain
PyTorch on every device.  Kept for parity with the reference: the gates run
in f32 whatever the compute dtype, with the gate weights kept in f32
(``keep_f32``: ``transformer.cast_weights_`` leaves them); the scan's output
is cast to its input's dtype and prefill carries that cast value's last row
as h, while a decode step carries its f32 h; the conv state is the block's
last ``width - 1`` rows of ``xb`` before the conv.  mLSTM and sLSTM come
with the xLSTM model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L

RGLRU_C = 8.0


def conv1d_causal(w, x):
    """x (B, S, C) -> (B, S, C), causal depthwise with taps w (width, C)
    cast to x's dtype: tap i multiplies x_{t - (width - 1 - i)}.  Each
    tap's product and each partial sum is rounded to x's dtype, as the JAX
    package's chain of adds is, eagerly and under ``jax.jit``."""
    w = w.to(x.dtype)
    width, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + S] * w[i]
    return out


def conv1d_step(w, x_t, conv_state):
    """x_t (B, 1, C); conv_state (B, width - 1, C), the previous inputs.
    Returns (y (B, 1, C), the new state (B, width - 1, C)), y summed in f32
    and rounded to x_t's dtype once (the reference's einsum)."""
    w = w.to(x_t.dtype)
    window = torch.cat([conv_state.to(x_t.dtype), x_t], dim=1)   # (B, width, C)
    y = torch.einsum("bwc,wc->bc", window.float(), w.float())[:, None, :]
    return y.to(x_t.dtype), (window[:, 1:] if w.shape[0] > 1 else conv_state)


class Conv1d(nn.Module):
    def __init__(self, width: int, channels: int, *, device=None):
        super().__init__()
        self.w = L._param(width, channels, device=device)

    def reset(self, gen: torch.Generator):
        self.w.normal_(0.0, 1.0, generator=gen).div_(self.w.shape[0])


class LRU(nn.Module):
    """The recurrence's parameters: Λ (``a_param``) and the recurrence and
    input gates' weights, which stay f32 (``keep_f32``)."""

    def __init__(self, dl: int, *, device=None):
        super().__init__()
        self.a_param = L._param(dl, device=device)
        self.w_r = L.Linear(dl, dl, device=device)
        self.w_i = L.Linear(dl, dl, device=device)
        self.w_r.keep_f32 = self.w_i.keep_f32 = True

    def reset(self, gen: torch.Generator):
        # Λ so that a^c = sigmoid(Λ)^c spans about [0.9, 0.999]
        dl = self.a_param.shape[0]
        self.a_param.copy_(torch.linspace(2.0, 6.0, dl))
        self.w_r.reset(gen)
        self.w_i.reset(gen)

    def gates(self, xb):
        """(a, b) of h = a * h + b, both f32, from xb in any dtype."""
        xf = xb.float()
        r = torch.sigmoid(self.w_r(xf))
        i = torch.sigmoid(self.w_i(xf))
        log_a = -RGLRU_C * F.softplus(self.a_param) * r
        a = torch.exp(log_a)
        b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
            * (i * xf)
        return a, b


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over dim 1 (h_{-1} = 0) by
    recursive doubling: pass d combines each t >= d with t - d under the
    JAX package's ``combine((al, bl), (ar, br)) = (al ar, ar bl + br)``,
    d = 1, 2, 4, ... < S."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(lru: LRU, xb, h0=None):
    """xb (B, S, dl) -> h (B, S, dl) in xb's dtype, from h0 (B, dl) or 0."""
    a, b = lru.gates(xb)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return linear_scan(a, b).to(xb.dtype)


def rglru_step(lru: LRU, x_t, h_prev):
    """x_t (B, 1, dl); h_prev (B, dl) f32.  Returns (y (B, 1, dl) in x_t's
    dtype, h (B, dl) f32)."""
    a, b = lru.gates(x_t)
    h = a[:, 0] * h_prev + b[:, 0]
    return h.to(x_t.dtype)[:, None, :], h


class RGLRUBlock(nn.Module):
    """Griffin's recurrent block, (B, S, d) -> (B, S, d):
    w_lru_out(RG-LRU(conv(wx x)) * silu(wg x))."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, dl = cfg.d_model, cfg.lru_dim or cfg.d_model
        self.wx = L.Linear(d, dl, device=device)
        self.wg = L.Linear(d, dl, device=device)
        self.conv = Conv1d(cfg.rglru_conv_width, dl, device=device)
        self.lru = LRU(dl, device=device)
        self.w_lru_out = L.Linear(dl, d, device=device)

    def reset(self, gen: torch.Generator):
        self.wx.reset(gen)
        self.wg.reset(gen)
        self.conv.reset(gen)
        self.lru.reset(gen)
        self.w_lru_out.reset(gen)

    def forward(self, x, compute_dtype=None):
        """Returns (out, (h, conv)): the decode state after the sequence, h
        (B, dl) f32 and the conv state (B, width - 1, dl) in xb's dtype
        (zero rows before the sequence's start where S < width - 1)."""
        g = F.silu(self.wg(x, compute_dtype))
        xb = self.wx(x, compute_dtype)
        n = self.conv.w.shape[0] - 1
        conv_state = F.pad(xb[:, -n:], (0, 0, max(n - xb.shape[1], 0), 0))
        h = rglru_scan(self.lru, conv1d_causal(self.conv.w, xb))
        out = self.w_lru_out(h * g, compute_dtype)
        return out, (h[:, -1].float(), conv_state)

    def step(self, x_t, h, conv, compute_dtype=None):
        """One token, x_t (B, 1, d) -> (B, 1, d); the state h (B, dl) and
        conv (B, width - 1, dl) is updated in place, so that a captured
        CUDA graph carries it from replay to replay."""
        g = F.silu(self.wg(x_t, compute_dtype))
        xb = self.wx(x_t, compute_dtype)
        xc, new_conv = conv1d_step(self.conv.w, xb, conv)
        y, new_h = rglru_step(self.lru, xc, h)
        conv.copy_(new_conv)
        h.copy_(new_h)
        return self.w_lru_out(y * g, compute_dtype)


def init_rglru_cache(cfg, batch: int, *, dtype=torch.float32, device=None):
    """Zeroed decode state of one RG-LRU layer: (h (B, dl) f32, conv
    (B, width - 1, dl) in ``dtype``)."""
    dl = cfg.lru_dim or cfg.d_model
    return (torch.zeros((batch, dl), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.rglru_conv_width - 1, dl), dtype=dtype,
                        device=device))
