"""The port's dispatch-exact count (``repro_torch/core/jaxpr_cost.py``)
against the JAX package's jaxpr count (``repro/core/jaxpr_cost.py``) of
the same train step, at reduced configurations of every model kind, on the
CPU: the matrix products' flops outside the attention call on both sides,
and the whole counts.

  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_cost_parity.py \\
      [--batch 2] [--seq 64] [arch ...]

Prints one JSON line an architecture.  ``tests/test_torch_jaxpr_cost.py``
holds the same comparison at its tolerances.
"""
import argparse
import contextlib
import json

import torch

ARCHS = ("qwen2-0.5b", "yi-6b", "gemma-7b", "starcoder2-15b",
         "recurrentgemma-2b", "whisper-small", "llama-3.2-vision-11b",
         "moonshot-v1-16b-a3b", "llama4-scout-17b-16e", "xlstm-1.3b")
# one full block-pattern period for the hybrid and xLSTM kinds (every
# block kind), two layers for the rest
N_LAYERS = {"recurrentgemma-2b": None, "xlstm-1.3b": None}


@contextlib.contextmanager
def attention_scoped():
    """The JAX package's ``flash_attention`` run under a named scope, so
    that its equations (forward, backward and remat recompute) can be told
    apart in the staged jaxpr."""
    import jax
    from repro.models import attention as ra
    flash = ra.flash_attention

    def scoped(*a, **k):
        with jax.named_scope("attention_call"):
            return flash(*a, **k)

    ra.flash_attention = scoped
    try:
        yield
    finally:
        ra.flash_attention = flash


def reference(arch, n_layers, B, S):
    """(dot_general flops outside the attention call, the whole
    ``jaxpr_cost`` dict) of the JAX package's train step at reduced
    ``arch``; scan bodies count times their length."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as rcr
    from repro.core import jaxpr_cost as rjc
    from repro.models import registry as rmr
    from repro.training import optimizer as ropt, step as rstep

    with attention_scoped():
        model = rmr.build(rcr.reduced(arch, n_layers=n_layers))
        params = model.abstract_params()
        tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
        batch = {"tokens": tok, "labels": tok}
        if model.needs_ctx():
            batch["ctx"] = model.ctx_spec(B)
        jaxpr = jax.make_jaxpr(rstep.build_train_step(
            model, ropt.AdamWConfig()))(
            params, ropt.abstract_opt_state(params), batch).jaxpr

    def walk(j, mult, inside):
        total = 0.0
        for eqn in j.eqns:
            hit = inside or "attention_call" in str(eqn.source_info.name_stack)
            subs = rjc._sub_jaxprs(eqn)
            if subs is not None:
                total += sum(walk(s, mult * m, hit) for s, m in subs)
            elif eqn.primitive.name == "dot_general" and not hit:
                total += mult * rjc._dot_flops(eqn)
        return total

    return walk(jaxpr, 1.0, False), rjc.jaxpr_cost(jaxpr).as_dict()


def port(arch, n_layers, B, S):
    """The port's ``CostCounter`` after its train step at reduced ``arch``
    on meta tensors."""
    from repro_torch.configs import registry as cr
    from repro_torch.core import jaxpr_cost as jc
    from repro_torch.models import registry as mr
    from repro_torch.training import optimizer as opt, step as tstep

    cfg = cr.reduced(arch, n_layers=n_layers)
    model = mr.build(cfg, device="meta")
    params = tstep.trainable_params(model)
    meta = lambda *s, dtype=torch.int64: torch.empty(s, dtype=dtype,
                                                     device="meta")
    batch = {"tokens": meta(B, S), "labels": meta(B, S)}
    if model.needs_ctx():
        batch["ctx"] = meta(B, model.ctx_len(), cfg.d_model,
                            dtype=getattr(torch, cfg.compute_dtype))
    return jc.count(tstep.build_train_step(model, opt.AdamWConfig()), params,
                    opt.init_opt_state(params), batch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args(argv)
    for arch in args.archs:
        n = N_LAYERS.get(arch, 2)
        ref, ref_all = reference(arch, n, args.batch, args.seq)
        c = port(arch, n, args.batch, args.seq)
        print(json.dumps({
            "arch": arch, "n_layers": n, "batch": args.batch,
            "seq": args.seq, "products_port": c.product_flops(),
            "products_reference": ref,
            "products_rel_diff": c.product_flops() / ref - 1.0,
            "flops_port": c.cost.flops, "flops_reference": ref_all["flops"],
            "flops_ratio": c.cost.flops / ref_all["flops"],
            "bytes_ratio": c.cost.bytes / ref_all["bytes"],
            "kernel_calls": c.kernel_calls}), flush=True)


if __name__ == "__main__":
    main()
