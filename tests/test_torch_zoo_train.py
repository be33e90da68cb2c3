"""One training step of the zoo models against the JAX package's
``make_train_step`` on the CPU (the inputs, weights and dropout masks of
``tests/test_torch_zoo.py``): loss, every parameter's gradient, the
updated parameters and the BN running statistics, by
``torch_parity.check_f32_step``. This file: VoxNet, KD-Net and KD-UNet,
and PointNet-Basic's bf16 step against JAX's bf16 step by
``torch_parity.check_bf16_step``; the T-Net models are in
``tests/test_torch_zoo_train_tnet.py`` and the PointMLP-only ones in
``tests/test_torch_zoo_train_mlp.py`` (the files split the time)."""

import jax
import numpy as np
import pytest
import torch

from tests import torch_parity as P
from tests.test_torch_zoo import case
from tests.torch_parity import few_threads  # noqa: F401

LR = WD = 1e-3
# ``check_f32_step``'s limits, fractions of a module's largest float64
# gradient. Measured on these inputs, at worst over the ten combos: the
# port's f32 step 6.3e-6 from its float64 step, JAX's 1.2e-5 (VoxNet),
# the two float64 steps 6.1e-8 apart, the losses within 6.5e-7 of each
# other. The limits leave about three times that.
F32_TOL = {"loss": 1e-5, "port": 2e-5, "jax": 5e-5, "x64": 1e-6}

pytestmark = pytest.mark.usefixtures("few_threads")


def check_zoo_step(combo, tol=F32_TOL):
    """f32: the port's step against JAX's classic f32 step, with the
    port's and JAX's float64 steps as the references."""
    b, jmodel, variables, masks, make, kind = case(combo)
    mode = combo[1]
    exact = P.port_step(make, variables, b, masks, LR, WD, torch.float64)
    want = P.jax_step(jmodel, mode, variables, b, masks, LR, WD, False,
                      kind=kind)
    want64 = P.jax_step_x64(jmodel, mode, variables, b, masks, LR, WD, kind)
    port = P.port_step(make, variables, b, masks, LR, WD, P.F32)
    P.check_f32_step(port, want, exact, want64, variables, LR, WD, tol)


@pytest.mark.parametrize("combo", [("voxnet", "clas"), ("kdnet", "clas"),
                                   ("kdunet", "seg")], ids="-".join)
def test_zoo_train_step_matches_jax(combo):
    check_zoo_step(combo)


def _bf16(x):
    return np.asarray(torch.from_numpy(np.array(x)).to(torch.bfloat16)
                      .float())


def test_pointnet_basic_bf16_step_matches_jax_bf16_step():
    """``train_step(precision="bf16")`` against JAX's
    ``make_train_step(precision="bf16")`` (its classic path: the zoo's
    PointMLPs do not pool, so no fused pass runs on either side), both
    judged against the port's float64 step on the bf16-rounded points and
    parameters. Measured: the loss 1.7e-3 from JAX's, the statistics
    7.3e-5 of their largest, the gradients a median 4.7e-3 from JAX's in
    relative L2, each at most 1.17 times as far from the float64 step as
    JAX's (median 1.00), the Dense biases before a BN (rounding noise on
    both sides) within 2.0e-2 of their module's largest. The limits leave
    two to four times that."""
    b, jmodel, variables, masks, make, kind = case(("pointnet_basic", "clas"))
    want = P.jax_step(jmodel, "clas", variables, b, masks, LR, WD, False,
                      kind=kind, precision="bf16")
    port = P.port_step(make, variables, b, masks, LR, WD, P.F32,
                       precision="bf16")
    rounded = {"params": jax.tree_util.tree_map(_bf16, variables["params"]),
               "batch_stats": variables["batch_stats"]}
    exact = P.port_step(make, rounded, dict(b, points=_bf16(b["points"])),
                        masks, LR, WD, torch.float64)
    P.check_bf16_step(port, want, exact, variables, LR, WD,
                      {"loss": 5e-3, "stats": 3e-4, "ratio": 1.5,
                       "median_ratio": 1.25, "median_rel": 2e-2,
                       "noise": 5e-2})
