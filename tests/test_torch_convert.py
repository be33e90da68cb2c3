"""flax variables → the port's state_dict (papc_tpu_torch.convert)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.models.classify import PointNet2SSGClas as JaxSSG

from papc_tpu_torch import convert
from papc_tpu_torch.models.classify import PointNet2SSGClas


@pytest.fixture(scope="module")
def flax_vars():
    """The flax tree of the full-width SSG (the SA sizes change no shape),
    every leaf filled with distinct seeded values."""
    x = jnp.zeros((1, 64, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: JaxSSG(num_classes=16, npoints=(16, 8),
                         nsamples=(4, 4)).init(jax.random.PRNGKey(0), x,
                                               train=False), x)
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


def _model():
    return PointNet2SSGClas(num_classes=16).eval()


def test_every_leaf_maps_exactly_once(flax_vars):
    flat = convert.flatten(flax_vars)
    model = _model()
    sd = convert.flax_to_state_dict(flax_vars, model)
    assert set(sd) == set(model.state_dict())
    # 3 SA stages x 3 layers x (2 Dense + 4 BN leaves), head 3 Dense + 2 BN
    assert len(flat) == len(sd) == 3 * 3 * 6 + 3 * 2 + 2 * 4
    # Dense kernels are transposed, everything else keeps its layout
    k = flat["params/SetAbstraction_1/PointMLP_0/Dense_0/kernel"]
    assert k.shape == (131, 128)  # rows 0-2 are the xyz channels
    np.testing.assert_array_equal(
        sd["SetAbstraction_1.PointMLP_0.Dense_0.weight"].numpy(), k.T)
    assert flat["params/SetAbstraction_2/PointMLP_0/Dense_0/kernel"].shape == (
        259, 256)
    np.testing.assert_array_equal(
        sd["MLPHead_0.BatchNorm_1.running_var"].numpy(),
        flat["batch_stats/MLPHead_0/BatchNorm_1/var"])
    np.testing.assert_array_equal(
        sd["MLPHead_0.BatchNorm_0.weight"].numpy(),
        flat["params/MLPHead_0/BatchNorm_0/scale"])


def test_npz_round_trip(flax_vars, tmp_path):
    flat = convert.flatten(flax_vars)
    path = tmp_path / "ssg.npz"
    np.savez(path, **flat)
    model = convert.load_flax_weights(_model(), path)
    back = convert.state_dict_to_flax(model.state_dict())
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    # the flat dict form loads the same tensors
    again = convert.flax_to_state_dict(flat, _model())
    for key, value in model.state_dict().items():
        torch.testing.assert_close(again[key], value, rtol=0, atol=0)


def test_missing_unused_and_misshapen_keys_fail(flax_vars):
    flat = convert.flatten(flax_vars)
    missing = dict(flat)
    del missing["batch_stats/SetAbstraction_0/PointMLP_0/BatchNorm_2/mean"]
    with pytest.raises(KeyError, match="left unfilled"):
        convert.flax_to_state_dict(missing, _model())
    extra = dict(flat)
    extra["params/SetAbstraction_0/PointMLP_0/Dense_9/kernel"] = np.zeros((2, 2))
    with pytest.raises(KeyError, match="Dense_9"):
        convert.flax_to_state_dict(extra, _model())
    odd = dict(flat)
    odd["params/Head/Conv_0/kernel"] = np.zeros((3, 3, 2, 2))
    with pytest.raises(KeyError, match="Conv_0"):
        convert.flax_to_state_dict(odd, _model())
    bad = dict(flat)
    bad["params/MLPHead_0/Dense_2/kernel"] = np.zeros((256, 40), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.flax_to_state_dict(bad, _model())


@pytest.fixture(scope="module")
def pillars_vars():
    """The flax tree of the full-width PointPillars car network (its
    weights' shapes do not depend on the grid, so a 16 x 16 grid serves),
    every leaf filled with distinct seeded values."""
    from papc_tpu.detect.model import PointPillars as JaxPointPillars

    args = (jnp.zeros((2, 8, 4, 4)), jnp.ones((2, 8), jnp.int32),
            jnp.zeros((2, 8, 3), jnp.int32))
    shapes = jax.eval_shape(lambda *a: JaxPointPillars(ny=16, nx=16).init(
        jax.random.PRNGKey(0), *a, train=False), *args)
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


def _pillars_model():
    from papc_tpu_torch.detect.model import PointPillars

    return PointPillars(ny=16, nx=16)


def test_pointpillars_tree_round_trips(pillars_vars, tmp_path):
    """flax → torch → flax on the PointPillars tree: Conv kernels HWIO →
    OIHW, ConvTranspose kernels mirrored into [in, out, s, s], Dense and
    BatchNorm as for the SSG tree."""
    flat = convert.flatten(pillars_vars)
    model = _pillars_model()
    sd = convert.flax_to_state_dict(pillars_vars, model)
    assert set(sd) == set(model.state_dict())
    n_params = sum(int(np.prod(v.shape)) for k, v in flat.items()
                   if k.startswith("params/"))
    assert n_params == sum(p.numel() for p in model.parameters()) == 4_814_804
    k = flat["params/rpn/_ConvBlock_1/Conv_0/kernel"]  # [3, 3, 64, 128]
    np.testing.assert_array_equal(sd["rpn._ConvBlock_1.Conv_0.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    for i, s in enumerate((1, 2, 4)):
        k = flat[f"params/rpn/ConvTranspose_{i}/kernel"]  # [s, s, in, out]
        w = sd[f"rpn.ConvTranspose_{i}.weight"].numpy()  # [in, out, s, s]
        assert k.shape[:2] == (s, s) and w.shape[2:] == (s, s)
        for p in range(s):
            for q in range(s):
                np.testing.assert_array_equal(w[:, :, p, q],
                                              k[s - 1 - p, s - 1 - q])
    np.testing.assert_array_equal(sd["pfn.PFNLayer_0.Dense_0.weight"].numpy(),
                                  flat["params/pfn/PFNLayer_0/Dense_0/kernel"].T)
    path = tmp_path / "pillars.npz"
    np.savez(path, **flat)
    back = convert.state_dict_to_flax(
        convert.load_flax_weights(_pillars_model(), path).state_dict())
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_pointpillars_misshapen_conv_kernels_fail(pillars_vars):
    flat = convert.flatten(pillars_vars)
    for key in ("params/rpn/ConvTranspose_2/kernel",
                "params/rpn/_ConvBlock_1/Conv_0/kernel"):
        bad = dict(flat)
        bad[key] = np.swapaxes(bad[key], 2, 3).copy()  # in and out swapped
        with pytest.raises(ValueError, match="shape"):
            convert.flax_to_state_dict(bad, _pillars_model())
    odd = dict(flat)
    odd["params/rpn/Conv_0/kernel"] = np.zeros((1, 1, 1, 384, 14), np.float32)
    with pytest.raises(KeyError, match="Conv_0"):
        convert.flax_to_state_dict(odd, _pillars_model())
