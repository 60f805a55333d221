"""Three AdamW steps of the port's train step on yi-6b (GQA 8) and
llama4-scout-17b-16e (MoE, top-1 with a shared expert) against the JAX
package's, as ``tests/test_torch_training_archs_steps.py`` holds the dense
archs that train on the card, at its eps and tolerances (the two files
split so that each runs alone in well under a minute)."""
import pytest

pytest.importorskip("jax")

from tests.test_torch_training_archs import ARCHS, DENSE  # noqa: E402
from tests.test_torch_training_archs_steps import (  # noqa: E402
    check_train_steps)


@pytest.mark.parametrize("name", sorted(set(ARCHS) - set(DENSE)))
def test_train_steps_match_jax(name):
    check_train_steps(name)
