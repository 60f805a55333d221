"""Model facade: a ModelConfig (or its name) -> a ``Transformer`` on a
device, its weights drawn from a seeded ``torch.Generator``.  The model
holds its weights, so it is what the serving engine calls where the JAX
package's ``Model`` takes parameters: ``prefill``, ``decode_step``,
``init_cache``, ``padded_vocab`` and the stub context's ``needs_ctx``,
``ctx_len`` and ``make_ctx``."""
from __future__ import annotations

import torch

from repro_torch.configs import base as C
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.device import resolve
from repro_torch.models.transformer import Transformer


def build(cfg_or_name, *, device="cuda", seed: int = 0) -> Transformer:
    cfg = (cfg_registry.get_any(cfg_or_name)
           if isinstance(cfg_or_name, str) else cfg_or_name)
    if not isinstance(cfg, C.ModelConfig):
        raise TypeError(f"build: expected a ModelConfig or its name, got {cfg!r}")
    dev = resolve(device)
    model = Transformer(cfg, device=dev)
    model.reset(torch.Generator(device=dev).manual_seed(seed))
    return model
