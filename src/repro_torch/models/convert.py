"""Weights across frameworks: the JAX package's parameter tree, as numpy
arrays, becomes the port's ``Transformer``.

The JAX stack stacks the parameters of each block-pattern position
``sub<i>`` along a leading period axis (``blocks/sub<i>/...``) and keeps a
non-divisible remainder as ``rem<r>``; layer ``p * period + i`` is period
``p`` of ``sub<i>``.  An encoder's blocks are stacked over its layers
(``encoder/blocks/...``).  Module attribute names equal the JAX keys, so
each leaf lands on ``blocks.<layer>.<key path joined by dots>`` (or
``encoder.blocks.<layer>...``).  Weights keep the JAX ``(d_in, d_out)``
layout: nothing is transposed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs import base as C
from repro_torch.core.device import resolve
from repro_torch.models.transformer import Transformer


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def from_jax_params(params_np: Dict, cfg: C.ModelConfig, *,
                    device="cuda") -> Transformer:
    dev = resolve(device)
    model = Transformer(cfg, device=dev)
    period = len(cfg.block_pattern)
    n_periods = cfg.n_layers // period
    flat = {}
    for key, val in params_np.items():
        if key == "blocks":
            for sub, tree in val.items():
                i = int(sub[len("sub"):])
                for name, arr in _flatten(tree).items():
                    for p in range(n_periods):
                        flat[f"blocks.{p * period + i}.{name}"] = arr[p]
        elif key.startswith("rem"):
            layer = n_periods * period + int(key[len("rem"):])
            for name, arr in _flatten(val).items():
                flat[f"blocks.{layer}.{name}"] = arr
        elif key == "encoder":
            for name, arr in _flatten(val["blocks"]).items():
                for i in range(cfg.encoder.n_layers):
                    flat[f"encoder.blocks.{i}.{name}"] = arr[i]
            flat.update(_flatten({"final_norm": val["final_norm"]},
                                 "encoder."))
        else:
            flat.update(_flatten({key: val}))
    state = {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
             for k, v in flat.items()}
    model.load_state_dict(state, strict=True)
    return model


def jax_ndim(name: str, param: torch.Tensor, cfg: C.ModelConfig) -> int:
    """The dimensions of the JAX package's leaf that holds the port's
    parameter ``name``: one more than the tensor's for a block stacked along
    the period axis (layers below ``n_periods * period`` and every encoder
    block), the tensor's own for the remainder ``rem<r>`` and the rest.
    AdamW's decay rule (``ndim >= 2``) reads it there."""
    parts = name.split(".")
    period = len(cfg.block_pattern)
    stacked = (parts[0] == "blocks"
               and int(parts[1]) < cfg.n_layers // period * period) or \
        parts[:2] == ["encoder", "blocks"]
    return param.dim() + int(stacked)

