"""One training step of the port's PointNet2 MSG classifier against the
JAX package's ``make_train_step``, on the CPU, at full width (1.74 M
parameters) and B=4 clouds of 512 points.

B=4 and not 2: over two rows the head's BatchNorm normalises each
feature to ±1 and passes back a gradient that is 0 in exact arithmetic,
so everything below the head would hold rounding noise.
"""

import numpy as np
import pytest
import torch

from papc_tpu.models.classify import PointNet2MSGClas as JaxMSG

from papc_tpu_torch.models.classify import PointNet2MSGClas

from tests import torch_parity as P

LR = WD = 1e-3


def _make():
    return PointNet2MSGClas(num_classes=16)


@pytest.fixture(scope="module")
def case():
    """The batch, the JAX model, perturbed flax variables, the two head
    dropout masks (rates 0.4 and 0.5) and the port's float64 step."""
    b = P.batch(4, 512, seed=5)
    jmodel = JaxMSG(num_classes=16)
    variables = P.perturbed_variables(jmodel, "clas", b, 5)
    rs = np.random.RandomState(6)
    masks = [rs.uniform(size=(4, 512)) < 0.6, rs.uniform(size=(4, 256)) < 0.5]
    exact = P.port_step(_make, variables, b, masks, LR, WD, torch.float64)
    return b, jmodel, variables, masks, exact


def test_msg_clas_train_step_f32_matches_jax_classic_step(case):
    """f32 operands against ``make_train_step`` on JAX's classic CPU path
    (and its float64 twin), same weights, statistics and dropout masks.
    The MSG gather's backward is the row scatter-add; the max's cotangent
    goes to the first argmax where autodiff splits ties (duplicated
    ball-query rows, summed back onto one point). Measured on this input,
    as fractions of their module's largest gradient: the port's f32 step
    within 1.2e-2 of its float64 step, JAX's f32 step within 0.131 of it
    (loss 9.2e-5 relative), the two float64 steps within 7.9e-3 of each
    other. So: port 3e-2, JAX 0.25, float64 2e-2, loss 3e-4; the updated
    parameters and BN statistics as the SSG step."""
    b, jmodel, variables, masks, exact = case
    want = P.jax_step(jmodel, "clas", variables, b, masks, LR, WD,
                      fused=False)
    want64 = P.jax_step_x64(jmodel, "clas", variables, b, masks, LR, WD)
    port = P.port_step(_make, variables, b, masks, LR, WD, P.F32)
    P.check_f32_step(port, want, exact, want64, variables, LR, WD,
                     {"loss": 3e-4, "port": 3e-2, "jax": 0.25, "x64": 2e-2})


# Measured on this input (B=4): the two bf16 steps' losses 4.3e-3 apart
# (each 2e-3 from the float64 step's), statistics 1.1e-2 of their
# largest; the gradients 0.44 apart in median relative L2, because at
# four clouds each SA3 channel's gradient lands on one of 128 rows per
# cloud and bf16 ties move it; the port's at most 1.44 times (median
# 1.06) as far from float64 as JAX's; noise biases 7.5e-2. The SSG step
# at B=32 is held tighter (tests/test_torch_train.py): more groups
# average the flips out.
BF16_LIMITS = {"loss": 1e-2, "stats": 3e-2, "ratio": 2.0,
               "median_ratio": 1.25, "median_rel": 0.6, "noise": 0.15}


def test_msg_clas_train_step_bf16_matches_jax_fused_jnp_step(case,
                                                             monkeypatch):
    """bf16 operands and storage against ``make_train_step`` under
    ``override(enable=True, impl="jnp")``, every SA stage fused on the
    JAX side too (``permissive_fused_gate``), with the port's float64
    step as the exact reference, judged as the SSG bf16 step (each
    gradient against JAX's and both against float64), within
    ``BF16_LIMITS``."""
    b, jmodel, variables, masks, exact = case
    P.permissive_fused_gate(monkeypatch)
    want = P.jax_step(jmodel, "clas", variables, b, masks, LR, WD,
                      fused=True)
    port = P.port_step(_make, variables, b, masks, LR, WD, P.BF16)
    P.check_bf16_step(port, want, exact, variables, LR, WD, BF16_LIMITS)
