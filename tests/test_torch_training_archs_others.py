"""``loss_fn`` of the port's training slice on yi-6b (GQA 8) and
llama4-scout-17b-16e (MoE, top-1 with a shared expert) against the JAX
package's, as ``tests/test_torch_training_archs.py`` holds the dense archs
that train on the card: value, metrics and gradients in both
cross-entropy modes, at that file's reduced configs and tolerances."""
import pytest

pytest.importorskip("jax")

from tests.test_torch_training_archs import (ARCHS, DENSE,  # noqa: E402
                                             check_loss_fn)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "naive"])
@pytest.mark.parametrize("name", sorted(set(ARCHS) - set(DENSE)))
def test_loss_fn_values_and_grads_match_jax(name, fused):
    check_loss_fn(name, fused)
