"""The recurrent blocks of the JAX package's ``models/recurrent.py``: the
RG-LRU block of Griffin / RecurrentGemma and the xLSTM blocks (mLSTM and
sLSTM).

A causal depthwise conv1d, the real-gated linear recurrent unit
h_t = a_t * h_{t-1} + b_t and the gated block around them.  Over a full
sequence the recurrence is an inclusive scan of (a, b) pairs under the JAX
package's ``combine``; here it runs by recursive doubling, log2(S)
elementwise passes over the whole sequence (the structure
``core/memory_model.py`` prices as ``assoc_scan``), never a loop over S.
Decode is one step with O(1) state: h (B, dl) in f32 and the conv's last
``width - 1`` inputs.

The mLSTM's matrix memory runs chunkwise over a sequence (``chunk``
positions at a time: products within a chunk, the (B, H, hd, hd) state C
carried in f32 from chunk to chunk) and one position at a time in a
decode step (``mlstm_cell_recurrent``), both stabilised by the running
max m of the log gates, which starts at -inf.  The sLSTM is a scan over
the sequence with its hidden-to-gate product inside: a Python loop over S
here, as ``lax.scan`` is there.

On a mesh (DTensor activations) the chunkwise mLSTM cell runs on each
rank's own batch and heads through ``local_map``, laid out as at the flash
kernel's boundary; the sLSTM's state starts on the input's mesh and is
carried with the decode cache's layout (batch over the data-parallel dims,
the width over 'model'), so every step of the scan sees the same layout.
Both loops ask ``core/cost.loop_trips`` how many iterations to run: all
of them, except under the dry run's counter on ``meta`` tensors where no
gradient is recorded, which runs one and counts it as many times as the
loop has trips, as the reference prices a scan.

The JAX package has no Pallas kernel for any of this, so it is plain
PyTorch on every device.  Kept for parity with the reference: the gates
run in f32 whatever the compute dtype, with the gate weights kept in f32
(``keep_f32``: ``transformer.cast_weights_`` leaves them); the RG-LRU
scan's output is cast to its input's dtype and prefill carries that cast
value's last row as h, while a decode step carries its f32 h; the conv
state is the block's last ``width - 1`` rows of the conv's input.  In bf16
the chunkwise mLSTM keeps q, k and v in bf16 and sums every product in
f32 (exact f32 copies of the bf16 operands), rounding the carried state
and the intra-chunk weights to bf16 where the reference rounds them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor.experimental import local_map

from repro_torch.core import cost
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
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
        xb = sh.constrain(self.wx(x, compute_dtype), "dp", None, "tp")
        n = self.conv.w.shape[0] - 1
        conv_state = F.pad(xb[:, -n:], (0, 0, max(n - xb.shape[1], 0), 0))
        h = rglru_scan(self.lru, conv1d_causal(self.conv.w, xb))
        h = sh.constrain(h, "dp", None, "tp")
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


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

MLSTM_EXPAND = 2
MLSTM_CONV_WIDTH = 4
MLSTM_CHUNK = 128
MLSTM_NORM_EPS = 1e-6      # ``out_norm``'s: the reference's rmsnorm default


def mlstm_dims(cfg):
    """(di, H, hd): the inner width, the heads and the head dim of C."""
    di = MLSTM_EXPAND * cfg.d_model
    H = cfg.n_heads
    return di, H, di // H


def _mlstm_step_(C, n, m, q, k, v, i_raw, f_logsig):
    """One position of the mLSTM recurrence, in place: q, k, v (B, H, hd)
    and the gates (B, H) in f32; C (B, H, hd, hd), n (B, H, hd) and m (B,
    H) f32 are updated.  Returns h (B, H, hd) f32."""
    m_new = torch.maximum(f_logsig + m, i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(f_logsig + m - m_new)
    C.mul_(f_s[..., None, None]).add_((i_s[..., None] * v)[..., :, None]
                                      * k[..., None, :])
    n.mul_(f_s[..., None]).add_(i_s[..., None] * k)
    m.copy_(m_new)
    denom = torch.maximum((n * q).sum(-1).abs(), torch.exp(-m_new))
    return torch.matmul(C, q[..., None])[..., 0] / denom[..., None]


def mlstm_cell_recurrent(q, k, v, i_raw, f_logsig, state=None):
    """The step-by-step cell (the reference and the decode cell): q, k, v
    (B, S, H, hd), gates (B, S, H) f32, ``state`` (C, n, m) or None (zero
    C and n, m = -inf).  Returns h (B, S, H, hd) in q's dtype and the
    state after the sequence; ``state`` itself is left as it was."""
    B, S, H, hd = q.shape
    f32, dev = torch.float32, q.device
    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=f32, device=dev)
        n = torch.zeros((B, H, hd), dtype=f32, device=dev)
        m = torch.full((B, H), -math.inf, dtype=f32, device=dev)
    else:
        C, n, m = (t.clone() for t in state)
    hs = [_mlstm_step_(C, n, m, q[:, t].float(), k[:, t].float(),
                       v[:, t].float(), i_raw[:, t], f_logsig[:, t])
          for t in range(S)]
    return torch.stack(hs, 1).to(q.dtype), (C, n, m)


def mlstm_cell_chunkwise(q, k, v, i_raw, f_logsig, chunk: int = MLSTM_CHUNK):
    """The chunkwise-parallel cell (the reference's matmul form; equal to
    the recurrent cell up to rounding): one chunk where ``chunk`` does not
    divide S.  Every product sums exact f32 copies of q, k, v (their
    dtype's values) in f32; the carried C and n and the intra-chunk
    weights are rounded to q's dtype before the products they enter, as
    the reference rounds them.  Returns h (B, S, H, hd) in q's dtype and
    (C, n, m) f32.  DTensor inputs (a mesh) run on each rank's own batch
    and heads."""
    if sh.is_sharded(q):
        B, H = q.shape[0], q.shape[2]
        pl = lambda at: ops.attention_placements(q.device_mesh, B, H, H,
                                                 heads_at=at)

        def flat(*a):
            h, state = mlstm_cell_chunkwise(*a, chunk=chunk)
            return (h, *state)
        h, *state = local_map(
            flat, out_placements=(pl(2), pl(1), pl(1), pl(1)),
            in_placements=(pl(2),) * 5, device_mesh=q.device_mesh,
            redistribute_inputs=True)(q, k, v, i_raw, f_logsig)
        return h, tuple(state)
    B, S, H, hd = q.shape
    if S % chunk:
        chunk = S
    cdt, f32, dev = q.dtype, torch.float32, q.device
    nC = S // chunk
    up = lambda t: t.to(cdt).float()       # rounded to cdt, summed in f32
    qc, kc, vc = (t.float().reshape(B, nC, chunk, H, hd) for t in (q, k, v))
    ic = i_raw.reshape(B, nC, chunk, H)
    b = torch.cumsum(f_logsig.reshape(B, nC, chunk, H), dim=2)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=dev).tril()[None, :, :, None]
    C = torch.zeros((B, H, hd, hd), dtype=f32, device=dev)
    n = torch.zeros((B, H, hd), dtype=f32, device=dev)
    m = torch.full((B, H), -math.inf, dtype=f32, device=dev)
    hs = []
    with cost.loop_trips(nC, q) as trips:
        for j in range(trips):
            qj, kj, vj = qc[:, j], kc[:, j], vc[:, j]
            ij, bj = ic[:, j], b[:, j]
            btot = bj[:, -1]
            # log weight of key tau for query t (tau <= t):
            # b_t - b_tau + i_tau
            g = (bj[:, :, None] - bj[:, None] + ij[:, None]).masked_fill(
                ~tri, -math.inf)
            m_t = torch.maximum(bj + m[:, None], g.amax(dim=2))
            inter_w = torch.exp(bj + m[:, None] - m_t)
            SP = torch.einsum("blhd,bthd->blth", qj, kj) \
                * torch.exp(g - m_t[:, :, None]).masked_fill(~tri, 0.0)
            num = (inter_w[..., None]
                   * torch.einsum("blhd,bhvd->blhv", qj, up(C))
                   + torch.einsum("blth,bthv->blhv", up(SP), vj))
            den = (inter_w * torch.einsum("blhd,bhd->blh", qj, up(n))
                   + SP.sum(dim=2))
            den = torch.maximum(den.abs(), torch.exp(-m_t))
            hs.append(num / den[..., None])
            # the state at the chunk's end
            g_end = btot[:, None] - bj + ij
            m_end = torch.maximum(btot + m, g_end.amax(dim=1))
            w_end = up(torch.exp(g_end - m_end[:, None]))
            decay = torch.exp(btot + m - m_end)
            C = decay[..., None, None] * C + torch.einsum(
                "blhv,blhd->bhvd", w_end[..., None] * vj, kj)
            n = decay[..., None] * n + torch.einsum("blh,blhd->bhd",
                                                    w_end, kj)
            m = m_end
    h = torch.stack(cost.loop_outputs(hs, nC), 1)
    h = h.reshape(B, S, H, hd)
    return h.to(cdt), (C, n, m)


class MLSTMBlock(nn.Module):
    """The mLSTM block, (B, S, d) -> (B, S, d): w_down(norm(cell(q, k, v,
    gates)) * silu(z)), with x_m and z the halves of w_up x, q and k from
    silu(conv(x_m)), v and the input and forget gates from x_m."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d = cfg.d_model
        di, H, hd = self.dims = mlstm_dims(cfg)
        self.w_up = L.Linear(d, 2 * di, device=device)
        self.conv = Conv1d(MLSTM_CONV_WIDTH, di, device=device)
        self.wq = L.Linear(di, di, device=device)
        self.wk = L.Linear(di, di, device=device)
        self.wv = L.Linear(di, di, device=device)
        self.w_if = L.Linear(di, 2 * H, bias=True, device=device)
        self.w_if.keep_f32 = True
        self.out_norm = L.RMSNorm(di, device=device)
        self.w_down = L.Linear(di, d, device=device)

    def reset(self, gen: torch.Generator):
        for part in (self.w_up, self.conv, self.wq, self.wk, self.wv,
                     self.w_if, self.out_norm, self.w_down):
            part.reset(gen)

    def _qkv(self, c, x_m, compute_dtype):
        """q, k / sqrt(hd) (rounded to x_m's dtype) and v, (B, S, H, hd),
        from the conv's activated output ``c`` and ``x_m``."""
        B, S = x_m.shape[:2]
        _, H, hd = self.dims
        scale = torch.tensor(math.sqrt(hd)).to(x_m.dtype).item()

        def heads(y):
            # a width split over a 'model' extent that does not divide
            # the heads cannot be cut into whole heads: gather it first
            if H % sh.tp_size():
                y = sh.constrain(y, "dp", None, None)
            return y.reshape(B, S, H, hd)
        return (heads(self.wq(c, compute_dtype)),
                heads(self.wk(c, compute_dtype)) / scale,
                heads(self.wv(x_m, compute_dtype)))

    def _out(self, h, z, compute_dtype):
        B, S = z.shape[:2]
        # the norm runs over the whole width: on a mesh the heads are
        # gathered over 'model' first
        h = sh.constrain(h.reshape(B, S, -1), "dp", None, None)
        h = self.out_norm(h, MLSTM_NORM_EPS) * F.silu(z)
        return self.w_down(sh.constrain(h, "dp", None, "tp"), compute_dtype)

    def forward(self, x, compute_dtype=None, *, chunk: int = MLSTM_CHUNK):
        """Returns (out, (C, n, m, conv)): the decode state after the
        sequence, C, n and m f32 and the conv state (B, width - 1, di) in
        x_m's dtype (zero rows before the sequence's start where S <
        width - 1).  The gates come from ``w_if`` in the compute dtype,
        their output cast to f32."""
        x_m, z = self.w_up(x, compute_dtype).chunk(2, dim=-1)
        x_m = sh.constrain(x_m, "dp", None, "tp")
        q, k, v = self._qkv(F.silu(conv1d_causal(self.conv.w, x_m)), x_m,
                            compute_dtype)
        i_raw, f_raw = self.w_if(x_m, compute_dtype).float().chunk(2, dim=-1)
        h, (C, n, m) = mlstm_cell_chunkwise(q, k, v, i_raw,
                                            -F.softplus(-f_raw), chunk)
        w = MLSTM_CONV_WIDTH - 1
        conv = F.pad(x_m[:, -w:], (0, 0, max(w - x_m.shape[1], 0), 0))
        return self._out(h, z, compute_dtype), (C, n, m, conv)

    def step(self, x_t, C, n, m, conv, compute_dtype=None):
        """One token, x_t (B, 1, d) -> (B, 1, d), by the recurrent cell; C,
        n, m and conv are updated in place, so that a captured CUDA graph
        carries them from replay to replay.  The gates come from x_m and
        ``w_if`` in f32."""
        x_m, z = self.w_up(x_t, compute_dtype).chunk(2, dim=-1)
        c, new_conv = conv1d_step(self.conv.w, x_m, conv)
        q, k, v = self._qkv(F.silu(c), x_m, compute_dtype)
        i_raw, f_raw = self.w_if(x_m.float()).chunk(2, dim=-1)
        h = _mlstm_step_(C, n, m, q[:, 0].float(), k[:, 0].float(),
                         v[:, 0].float(), i_raw[:, 0],
                         -F.softplus(-f_raw[:, 0]))
        conv.copy_(new_conv)
        return self._out(h[:, None].to(q.dtype), z, compute_dtype)


def init_mlstm_cache(cfg, batch: int, *, dtype=torch.float32, device=None):
    """The decode state of one mLSTM layer before any token: (C (B, H, hd,
    hd), n (B, H, hd), m (B, H) = -inf, all f32; conv (B, width - 1, di)
    in ``dtype``)."""
    di, H, hd = mlstm_dims(cfg)
    f32 = torch.float32
    return (torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
            torch.zeros((batch, H, hd), dtype=f32, device=device),
            torch.full((batch, H), -math.inf, dtype=f32, device=device),
            torch.zeros((batch, MLSTM_CONV_WIDTH - 1, di), dtype=dtype,
                        device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_ff(cfg) -> int:
    """The sLSTM block's feed-forward width: 4 d / 3 rounded up to 128."""
    ff = int(round(4 * cfg.d_model / 3))
    return ((ff + 127) // 128) * 128


class SLSTMCell(nn.Module):
    """The input projection ``wx`` (with its bias) and the hidden-to-gate
    product ``rh``, both f32 (``keep_f32``)."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.wx = L.Linear(d, 4 * d, bias=True, device=device)
        self.rh = L.Linear(d, 4 * d, device=device)
        self.wx.keep_f32 = self.rh.keep_f32 = True

    def reset(self, gen: torch.Generator):
        self.wx.reset(gen)
        self.rh.reset(gen)


def _slstm_step(cell: SLSTMCell, wx_t, c, n, h, m):
    """One position: wx_t (B, 4d) and the state (c, n, h, m), each (B, d)
    f32 -> the next state."""
    z_raw, i_raw, f_raw, o_raw = (wx_t + cell.rh(h)).chunk(4, dim=-1)
    m_new = torch.maximum(f_raw + m, i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(f_raw + m - m_new)
    c = f_s * c + i_s * torch.tanh(z_raw)
    n = f_s * n + i_s
    h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1e-6)
    return c, n, h, m_new


def slstm_cell(cell: SLSTMCell, x, state=None):
    """x (B, S, d), a scan over S (a Python loop) -> (h (B, S, d) in x's
    dtype, the state (c, n, h, m) after it); ``state`` or the start: c and
    h 0, n 1e-6, m -1e30.  The input projection is one product over the
    sequence, in f32."""
    B, S, d = x.shape
    wx = cell.wx(x.float())
    if state is None:
        z = sh.replicate_like(
            torch.zeros((B, d), dtype=torch.float32, device=x.device), wx)
        state = (z, z + 1e-6, z, z - 1e30)
    carry = lambda st: tuple(sh.constrain(t, "dp", "tp") for t in st)
    state = carry(state)
    hs = []
    with cost.loop_trips(S, x) as trips:
        for t in range(trips):
            state = carry(_slstm_step(cell, wx[:, t], *state))
            hs.append(state[2])
    h = torch.stack(cost.loop_outputs(hs, S), 1)
    return h.to(x.dtype), state


class SLSTMBlock(nn.Module):
    """The sLSTM block, (B, S, d) -> (B, S, d): the cell (``slstm``), then
    a gelu MLP (``ff``) of width ``slstm_ff``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.slstm = SLSTMCell(cfg.d_model, device=device)
        self.ff = L.MLP(cfg.d_model, slstm_ff(cfg), "gelu", device=device)

    def reset(self, gen: torch.Generator):
        self.slstm.reset(gen)
        self.ff.reset(gen)

    def forward(self, x, compute_dtype=None):
        """Returns (out, (c, n, h, m)), the state after the sequence."""
        h, state = slstm_cell(self.slstm, x)
        return self.ff(sh.constrain_hidden(h), compute_dtype), state

    def step(self, x_t, c, n, h, m, compute_dtype=None):
        """One token, x_t (B, 1, d) -> (B, 1, d); c, n, h and m are
        updated in place."""
        y, new = slstm_cell(self.slstm, x_t, (c, n, h, m))
        for dst, src in zip((c, n, h, m), new):
            dst.copy_(src)
        return self.ff(y, compute_dtype)


def init_slstm_cache(cfg, batch: int, *, device=None):
    """The decode state of one sLSTM layer before any token: (c, n, h, m),
    each (B, d) f32: c and h 0, n 1e-6, m -1e30 (not -inf)."""
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return z, z + 1e-6, z.clone(), z - 1e30
