"""The port's PointNet++ MSG part-segmentation model against the JAX
package, on the CPU: full widths and depth (1.74 M parameters; the
model has no size override, in JAX or in the port), B=2 clouds of 512
points, 16 object classes, 50 parts. Its SA2 second branch is
128-196-256, the port's first width that is not a multiple of 16.
"""

import jax
import numpy as np
import pytest
import torch

from papc_tpu.models.segment import PointNet2MSGSeg as JaxMSGSeg

from papc_tpu_torch.convert import flatten, state_dict_to_flax
from papc_tpu_torch.models import init_model
from papc_tpu_torch.models.segment import PointNet2MSGSeg

from tests import torch_parity as P

LR = WD = 1e-3


def _make():
    return PointNet2MSGSeg(num_classes=16, num_parts=50)


@pytest.fixture(scope="module")
def case():
    b = P.batch(2, 512, seed=10)
    jmodel = JaxMSGSeg(num_classes=16, num_parts=50)
    variables = P.perturbed_variables(jmodel, "seg", b, 10)
    masks = [np.random.RandomState(11).uniform(size=(2, 512, 128)) < 0.5]
    return b, jmodel, variables, masks


def test_msg_seg_logits_match_jax(case):
    """Per-point logits in eval mode: f32 operands against flax's classic
    CPU path within rtol 1e-4, atol 1e-4; bf16 operands against
    ``override(enable=True, impl="jnp")`` (every SA stage fused) within
    rtol 1e-2, atol 1e-3; the argmax equal where JAX's top two logits
    are more than 1e-2 apart."""
    b, jmodel, variables, _ = case
    model = P.port_model(_make, variables)
    want = P.jax_eval(jmodel, "seg", variables, b)
    got = P.port_eval(model, "seg", b)
    assert got.shape == (2, 512, 50) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        P.permissive_fused_gate(mp)
        with P.jfused.override(enable=True, impl="jnp"):
            want16 = P.jax_eval(jmodel, "seg", variables, b)
    got16 = P.port_eval(model, "seg", b, torch.bfloat16)
    np.testing.assert_allclose(got16, want16, rtol=1e-2, atol=1e-3)
    top2 = np.sort(want16, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-2
    assert (got16.argmax(-1) == want16.argmax(-1))[clear].all()


def test_msg_seg_train_steps_match_jax(case, monkeypatch):
    """One step with f32 operands against ``make_train_step`` on JAX's
    classic path and its float64 twin, one with bf16 operands against
    the fused jnp step, the port's float64 step the exact reference for
    both, judged as the MSG classifier's steps
    (tests/test_torch_msg_train.py). Measured on this input, gradients
    as fractions of their module's largest: f32, the port 1.0e-5 from
    its float64 step, JAX 3.4e-2, the two float64 steps 1.4e-5 apart,
    losses within 2.2e-7; bf16: see ``BF16_LIMITS``."""
    b, jmodel, variables, masks = case
    exact = P.port_step(_make, variables, b, masks, LR, WD, torch.float64)
    want = P.jax_step(jmodel, "seg", variables, b, masks, LR, WD, False)
    want64 = P.jax_step_x64(jmodel, "seg", variables, b, masks, LR, WD)
    port = P.port_step(_make, variables, b, masks, LR, WD, P.F32)
    P.check_f32_step(port, want, exact, want64, variables, LR, WD,
                     {"loss": 1e-5, "port": 1e-4, "jax": 0.1, "x64": 1e-4})
    P.permissive_fused_gate(monkeypatch)
    want = P.jax_step(jmodel, "seg", variables, b, masks, LR, WD, True)
    port = P.port_step(_make, variables, b, masks, LR, WD, P.BF16)
    P.check_bf16_step(port, want, exact, variables, LR, WD, BF16_LIMITS)


# Measured on this input: the bf16 losses 7.7e-5 apart, statistics
# 2.9e-3 of their largest, median relative L2 to JAX 0.28 (SA3's last BN
# bias 1.44: at two clouds its gradient rides on two rows per channel,
# which bf16 ties move), distance from float64 at most 1.25 (median 1.03)
# times JAX's, noise biases 4.0e-3.
BF16_LIMITS = {"loss": 1e-3, "stats": 1e-2, "ratio": 2.0,
               "median_ratio": 1.25, "median_rel": 0.45, "noise": 2e-2}


def test_msg_seg_tree_round_trips(case):
    """flax → port → flax, leaf for leaf and bit for bit
    (``SetAbstractionMsg_i/PointMLP_j``, ``SetAbstraction_0``,
    ``FeaturePropagation_i``, ``_SegHead2_0``); the registry's model has
    flax's parameter count."""
    _, _, variables, _ = case
    flat = flatten(jax.tree_util.tree_map(np.asarray, variables))
    back = state_dict_to_flax(P.port_model(_make, variables).state_dict())
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value)
    kernel = flat["params/SetAbstractionMsg_1/PointMLP_1/Dense_1/kernel"]
    assert kernel.shape == (128, 196)
    n_params = sum(v.size for k, v in flat.items() if k.startswith("params/"))
    spec = init_model("pointnet2_msg", "seg", device="cpu")
    assert sum(p.numel() for p in spec.model.parameters()) == n_params \
        == 1_740_958
