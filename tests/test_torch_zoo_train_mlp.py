"""One f32 training step of each zoo model whose trunk is PointMLPs
alone (PointNet-Basic and VFE, in both modes) against the JAX package's
``make_train_step`` on the CPU, as ``tests/test_torch_zoo_train.py``
holds the others."""

import pytest

from tests.test_torch_zoo_train import check_zoo_step
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("combo", [
    ("pointnet_basic", "clas"), ("vfe", "clas"), ("pointnet_basic", "seg"),
    ("vfe", "seg")], ids="-".join)
def test_zoo_mlp_train_step_matches_jax(combo):
    check_zoo_step(combo)
