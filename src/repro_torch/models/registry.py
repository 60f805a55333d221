"""Model facade: a ModelConfig (or its name) -> a ``Transformer`` on a
device, its weights drawn from a seeded ``torch.Generator``.  The model
holds its weights, so it is what the serving engine calls where the JAX
package's ``Model`` takes parameters: ``prefill``, ``decode_step``,
``init_cache``, ``padded_vocab`` and the stub context's ``needs_ctx``,
``ctx_len`` and ``make_ctx``.

The model is made on the ``meta`` device and each part (the embedding, a
block) is built on ``device``, drawn in f32 in ``Transformer.reset``'s
order and, with ``dtype``, stored in it as ``cast_weights_`` stores it
before the next part is made, so that only one part is ever held in f32:
moonshot-v1-16b-a3b is 115.6 GB in f32 and 57.8 GB in bf16, so it is
built on one 80 GB card only this way.  The weights equal, bit for bit,
those of a model made on ``device``, drawn by ``reset`` and cast.

``device="meta"`` makes every part on ``meta`` (shapes and dtypes, no
data) and draws nothing: the dry run's model (``launch/dryrun.py``)."""
from __future__ import annotations

import torch

from repro_torch.configs import base as C
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.device import resolve
from repro_torch.models.transformer import Transformer, cast_weights_


def build(cfg_or_name, *, device="cuda", seed: int = 0,
          dtype: torch.dtype = None) -> Transformer:
    cfg = (cfg_registry.get_any(cfg_or_name)
           if isinstance(cfg_or_name, str) else cfg_or_name)
    if not isinstance(cfg, C.ModelConfig):
        raise TypeError(f"build: expected a ModelConfig or its name, got {cfg!r}")
    dev = resolve(device)
    model = Transformer(cfg, device=torch.device("meta"))
    if dev.type == "meta":
        return model if dtype is None else cast_weights_(model, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for owner, name, make in model.parts():
        part = make(dev)
        part.reset(gen)
        if dtype is not None:
            cast_weights_(part, dtype)
        owner.add_module(name, part)
    return model
