"""One f32 training step of each PointNet with the input and feature
T-Nets (clas, its Conv2D variant, seg) against the JAX package's
``make_train_step`` on the CPU, as ``tests/test_torch_zoo_train.py``
holds the others."""

import pytest

from tests.test_torch_zoo_train import F32_TOL, check_zoo_step
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

# PointNet seg on these inputs: one pre-activation of the seg head's
# fourth layer lies within rounding of 0 (-9.9e-7 in the port's f32
# step, +1.7e-6 in float64), so that ReLU gate flips and the port's f32
# gradients read 2.1e-3 of their module's largest from its float64 step
# (JAX's f32 step, where the gate holds, 5.5e-5: this model's deepest
# chain of BN layers). The float64 steps agree within 3.2e-8.
ROUNDED_GATE_TOL = dict(F32_TOL, port=5e-3, jax=2e-4)


@pytest.mark.parametrize("combo", [("pointnet", "clas"),
                                   ("pointnet_conv2d", "clas")], ids="-".join)
def test_tnet_train_step_matches_jax(combo):
    check_zoo_step(combo)


def test_pointnet_seg_train_step_matches_jax():
    check_zoo_step(("pointnet", "seg"), ROUNDED_GATE_TOL)
