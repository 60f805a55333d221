"""What the training parity tests share (``tests/test_torch_training.py``,
``tests/test_torch_training_kinds.py``): reduced configs of both packages
in float32, the JAX model with its numpy parameters and the port's model
holding the same values (``convert.from_jax_params``), numpy batches (with
a numpy context for a model that takes one, handed to both packages), and
the tolerances.

- gradients: atol 1e-5 / rtol 1e-3, ``test_training``'s fused-against-
  naive gradient limit;
- parameters after K steps: atol 1e-5 / rtol 1e-4, ``test_training``'s
  microbatch limit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jcr
from repro.models import registry as jmr
from repro_torch.configs import registry as tcr
from repro_torch.models import convert

GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)


def cfgs(name, layers=None, **changes):
    """(JAX config, port config): ``reduced(name, n_layers=layers)`` in
    float32 with ``changes`` (``dataclasses.replace``) on both sides."""
    f32 = lambda c: dataclasses.replace(c, compute_dtype="float32", **changes)
    return (f32(jcr.reduced(name, n_layers=layers)),
            f32(tcr.reduced(name, n_layers=layers)))


def setup(name, layers=None, B=2, S=32, seed=0, **changes):
    """(JAX model, its params as numpy, the port's model holding them, a
    numpy batch: tokens, labels and, where the model takes one, a context
    (B, ctx_len, d) drawn from the seed)."""
    jcfg, tcfg = cfgs(name, layers, **changes)
    jmodel = jmr.build(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))
    model = convert.from_jax_params(params, tcfg, device="cpu")
    rng = np.random.default_rng(seed + 1)
    seq = rng.integers(0, jcfg.vocab_size, (B, S + 1))
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    if model.needs_ctx():         # standard normal, as make_ctx draws it
        batch["ctx"] = rng.standard_normal(
            (B, model.ctx_len(), tcfg.d_model)).astype(np.float32)
    return jmodel, params, model, batch


def jbatch(batch):
    """JAX arrays: int32 tokens and labels, a float32 context."""
    return {k: jnp.asarray(v, jnp.float32 if k == "ctx" else jnp.int32)
            for k, v in batch.items()}


def tbatch(batch):
    """Tensors: int64 tokens and labels, a float32 context."""
    return {k: torch.from_numpy(np.array(v, np.float32 if k == "ctx"
                                         else np.int64))
            for k, v in batch.items()}


def as_port(tree_np, tcfg):
    """A JAX parameter-shaped tree (gradients, moments) by the port's
    parameter names."""
    return {k: v.numpy() for k, v in convert.from_jax_params(
        tree_np, tcfg, device="cpu").state_dict().items()}
