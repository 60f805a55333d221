"""NeuSight-style learned baseline (Lee et al., ASPLOS'25; paper §II).

The JAX package's baseline in PyTorch: a tile/wave-featurized MLP predicts
per-kernel GPU *utilization*; duration = flops / (peak * util).  Trained
with the same relative-error loss family (SMAPE) the paper critiques, on
measured (M, N, K) samples of ``torch.matmul`` on the device.  Memory-bound
ops use a second tiny MLP on byte counts.

The MLPs are float32 ``nn.Module``s, as the JAX package's run in float32
(x64 off); the features stay numpy float64 until they enter the MLP.  The
init draws normal / sqrt(fan-in) weights and zero biases from a CPU
``torch.Generator`` seeded ``seed`` (the matmul MLP) and ``seed + 1`` (the
memory MLP), as the reference seeds ``jax.random.key``; the bits differ, so
``from_jax`` carries a JAX model's weights across.

This is the comparison target for the Table II/IV reproductions
(``repro_torch.benchmarks``); its failure modes (loss imbalance,
out-of-distribution shapes) are the ones the paper documents.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import profiler
from repro_torch.core.device import resolve
from repro_torch.core.predictor import PredictionRow

TILE = 128  # assumed tile for wave counting


def matmul_features(m, n, k, batch=1.0):
    m, n, k, batch = (np.asarray(x, np.float64) for x in (m, n, k, batch))
    waves = np.ceil(m / TILE) * np.ceil(n / TILE) * batch
    flops = 2.0 * m * n * k * batch
    return np.stack([np.log2(m), np.log2(n), np.log2(k), np.log2(batch + 1),
                     np.log2(waves), np.log2(flops)], axis=-1)


class MLP(nn.Module):
    """float32 linear layers with tanh between them (the reference's
    ``_mlp``)."""

    def __init__(self, sizes: Sequence[int], device="cpu"):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device, dtype=torch.float32)
            for a, b in zip(sizes, sizes[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.tanh(x)
        return x

    @staticmethod
    def from_numpy(params, device="cpu") -> "MLP":
        """From the reference's parameter list: ``w`` (a, b), ``b`` (b,)
        each layer (the ``nn.Linear`` weight is ``w`` transposed)."""
        ws = [np.array(p["w"], np.float32) for p in params]
        mlp = MLP([ws[0].shape[0]] + [w.shape[1] for w in ws], device=device)
        with torch.no_grad():
            for layer, w, p in zip(mlp.layers, ws, params):
                layer.weight.copy_(torch.from_numpy(w.T.copy()))
                layer.bias.copy_(torch.from_numpy(np.array(p["b"], np.float32)))
        return mlp

    def to_numpy(self) -> List[Dict[str, np.ndarray]]:
        return [{"w": layer.weight.detach().cpu().numpy().T.copy(),
                 "b": layer.bias.detach().cpu().numpy().copy()}
                for layer in self.layers]


def _init_mlp(seed: int, sizes: Sequence[int], device) -> MLP:
    gen = torch.Generator().manual_seed(seed)
    params = [{"w": (torch.randn(a, b, generator=gen) / np.sqrt(a)).numpy(),
               "b": np.zeros(b, np.float32)}
              for a, b in zip(sizes, sizes[1:])]
    return MLP.from_numpy(params, device=device)


@dataclasses.dataclass
class NeuSightModel:
    mlp: MLP
    peak_flops: float
    mem_mlp: MLP
    feat_mean: np.ndarray
    feat_std: np.ndarray
    mem_scale: float

    @property
    def device(self) -> torch.device:
        return self.mlp.layers[0].weight.device

    @torch.no_grad()
    def predict_matmul(self, m, n, k, batch=1) -> float:
        f = (matmul_features(m, n, k, batch) - self.feat_mean) / self.feat_std
        x = torch.as_tensor(f, dtype=torch.float32, device=self.device)
        util = torch.sigmoid(self.mlp(x))[..., 0]
        flops = 2.0 * m * n * k * batch
        return float(flops / (self.peak_flops * np.maximum(float(util), 1e-4)))

    @torch.no_grad()
    def predict_memory(self, feats: Dict[str, float]) -> float:
        x = torch.tensor([np.log2(feats["bytes"] + 1)], dtype=torch.float32,
                         device=self.device)
        return float(torch.exp(self.mem_mlp(x))[0] * self.mem_scale)

    def predict_op(self, op) -> PredictionRow:
        if op.kind in ("matmul", "bmm"):
            s = self.predict_matmul(op.m, op.n, op.k, op.batch) * op.count
            return PredictionRow(op.name, op.kind, s, "neusight_mlp")
        if op.kind == "attention":
            # NeuSight decomposes attention into its two BMMs
            s = (self.predict_matmul(op.sq, op.skv, op.hd, op.batch * op.heads)
                 + self.predict_matmul(op.sq, op.hd, op.skv, op.batch * op.heads)
                 ) * op.count
            return PredictionRow(op.name, op.kind, s, "neusight_mlp")
        return PredictionRow(op.name, "memory",
                             self.predict_memory(op.features()) * op.count,
                             "neusight_mem")

    def predict_ops(self, ops: List) -> Tuple[float, List[PredictionRow]]:
        rows = [self.predict_op(o) for o in ops]
        return sum(r.seconds for r in rows), rows

    def state(self) -> dict:
        """Tensors and numbers only, for ``torch.save`` and a
        ``weights_only`` load (``from_state``)."""
        as_t = lambda params: [{k: torch.from_numpy(v) for k, v in p.items()}
                               for p in params]
        return {"mlp": as_t(self.mlp.to_numpy()),
                "mem_mlp": as_t(self.mem_mlp.to_numpy()),
                "peak_flops": self.peak_flops,
                "feat_mean": torch.from_numpy(self.feat_mean),
                "feat_std": torch.from_numpy(self.feat_std),
                "mem_scale": self.mem_scale}

    @staticmethod
    def from_state(state: dict, device="cuda") -> "NeuSightModel":
        dev = resolve(device)
        as_np = lambda params: [{k: v.numpy() for k, v in p.items()}
                                for p in params]
        return NeuSightModel(
            mlp=MLP.from_numpy(as_np(state["mlp"]), dev),
            peak_flops=state["peak_flops"],
            mem_mlp=MLP.from_numpy(as_np(state["mem_mlp"]), dev),
            feat_mean=state["feat_mean"].numpy(),
            feat_std=state["feat_std"].numpy(), mem_scale=state["mem_scale"])


def from_jax(model, device="cuda") -> NeuSightModel:
    """The port's model with a JAX ``NeuSightModel``'s weights (read as
    numpy arrays) and constants, on ``device``."""
    dev = resolve(device)
    return NeuSightModel(mlp=MLP.from_numpy(model.mlp_params, dev),
                         peak_flops=model.peak_flops,
                         mem_mlp=MLP.from_numpy(model.mem_mlp_params, dev),
                         feat_mean=np.asarray(model.feat_mean),
                         feat_std=np.asarray(model.feat_std),
                         mem_scale=model.mem_scale)


def collect_matmul_dataset(n_samples=60, *, dtype="float32", seed=0,
                           max_mn=2048, max_k=4096, device="cuda") -> List[dict]:
    """``n_samples`` (M, N, K) drawn log-uniform, each ``torch.matmul`` of
    ``torch.ones`` operands in ``dtype`` timed on ``device``."""
    dev = resolve(device)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_samples):
        m = int(2 ** rng.uniform(5, np.log2(max_mn)))
        n = int(2 ** rng.uniform(5, np.log2(max_mn)))
        k = int(2 ** rng.uniform(5, np.log2(max_k)))
        a = torch.ones((m, k), dtype=dt, device=dev)
        b = torch.ones((k, n), dtype=dt, device=dev)
        dur = profiler.measure(torch.matmul, a, b, min_reps=3,
                               min_total_s=0.02, device=dev)
        out.append({"m": m, "n": n, "k": k, "batch": 1, "duration": dur})
    return out


def train(samples: List[dict], mem_samples: List[dict], *, peak_flops: float,
          steps=2000, lr=1e-2, seed=0, loss="smape",
          device="cuda") -> NeuSightModel:
    dev = resolve(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    feats = matmul_features(np.array([s["m"] for s in samples]),
                            np.array([s["n"] for s in samples]),
                            np.array([s["k"] for s in samples]),
                            np.array([s["batch"] for s in samples]))
    mean, std = feats.mean(0), feats.std(0) + 1e-9
    X = f32((feats - mean) / std)
    y = f32(np.array([s["duration"] for s in samples]))
    fl = f32(np.array([2.0 * s["m"] * s["n"] * s["k"] * s["batch"]
                       for s in samples]))
    mlp = _init_mlp(seed, (X.shape[1], 64, 64, 1), dev)

    def loss_fn(mlp):
        util = torch.sigmoid(mlp(X))[:, 0]
        pred = fl / (peak_flops * torch.clamp(util, min=1e-4))
        if loss == "smape":
            return torch.mean(torch.abs(pred - y)
                              / (torch.abs(pred) + torch.abs(y)))
        return torch.mean(torch.abs(pred - y) / y)

    _adam(loss_fn, mlp, steps, lr)

    # memory MLP: log-bytes -> log-duration
    mb = np.array([[np.log2(s["features"]["bytes"] + 1)] for s in mem_samples])
    md = np.array([s["duration"] for s in mem_samples])
    scale = float(np.median(md))
    Xm, ym = f32(mb), f32(np.log(md / scale))
    mem_mlp = _init_mlp(seed + 1, (1, 32, 1), dev)
    _adam(lambda m: torch.mean((m(Xm)[:, 0] - ym) ** 2), mem_mlp,
          steps // 2, lr)
    return NeuSightModel(mlp=mlp, peak_flops=peak_flops, mem_mlp=mem_mlp,
                         feat_mean=mean, feat_std=std, mem_scale=scale)


def _adam(loss_fn, module: nn.Module, steps, lr):
    """``steps`` Adam steps on ``loss_fn(module)``: β (0.9, 0.999), eps
    1e-8, the reference's update."""
    opt = torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    for _ in range(steps):
        opt.zero_grad()
        loss_fn(module).backward()
        opt.step()
    return module
