"""The rest of the clas/seg zoo against the JAX package: PointNet-Basic,
PointNet (and its Conv2D variant), VFE, VoxNet, KD-Net and KD-UNet, each
in the modes the registry builds. The same numpy inputs (seeded clouds,
their kd-trees, their occupancy grids) and the same flax variables
(``convert.py``, BN statistics perturbed) through the JAX model and its
port on the CPU: eval-mode logits, and the flax tree of every registry
model leaf for leaf. The training steps are in
``tests/test_torch_zoo_train.py``."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.models import registry as jregistry
from tests import torch_parity as P
from tests.torch_parity import few_threads  # noqa: F401

from papc_tpu_torch.convert import (flatten, flax_to_state_dict,
                                    load_flax_weights, state_dict_to_flax)
from papc_tpu_torch.data.kd import leaf_order
from papc_tpu_torch.data.voxel import normalized, rasterize
from papc_tpu_torch.models import init_model, registry_combos
from papc_tpu_torch.nn.layers import conv

T = torch.from_numpy
ZOO = tuple(c for c in registry_combos() if not c[0].startswith("pointnet2"))
B, N = 4, 32  # KD-UNet's five levels need N >= 32
NUM_CLASSES, NUM_PARTS = 16, 50

pytestmark = pytest.mark.usefixtures("few_threads")


def zoo_batch(kind, seed, batch=B, n=N):
    """``batch`` seeded clouds (``torch_parity.batch``) as the loader of
    ``kind`` gives them: the points, or in leaf order with their
    ``split_dims`` (the part labels reordered alike), or rasterised."""
    b = P.batch(batch, n, seed=seed)
    if kind == "kd":
        b["points"], splits, b["pid"] = leaf_order(b["points"], b["pid"])
        b["split_dims"] = tuple(splits)
    elif kind == "voxel":
        b["voxels"] = np.stack([rasterize(normalized(p))
                                for p in b.pop("points")])[..., None]
    return b


def dropout_masks(name, mode, seed):
    """One keep mask a dropout site: the clas heads' [B, 256] before the
    last Dense, VoxNet's [B, 128]; the other models have none."""
    rs = np.random.RandomState(seed)
    if name == "voxnet":
        return [rs.uniform(size=(B, 128)) < 0.8]
    if mode == "clas" and name != "kdnet":
        return [rs.uniform(size=(B, 256)) < 0.3]
    return []


@functools.lru_cache(maxsize=None)
def case(combo):
    """``(batch, JAX model, variables, masks, make, kind)`` of a combo at
    B x N, seeded by its place in the registry."""
    name, mode = combo
    seed = 20 + registry_combos().index(combo)
    jspec = jregistry.init_model(name, mode, NUM_CLASSES, NUM_PARTS, N)
    b = zoo_batch(jspec.input_kind, seed)
    variables = P.perturbed_variables(jspec.model, mode, b, seed,
                                      jspec.input_kind)

    def make():
        return init_model(name, mode, NUM_CLASSES, NUM_PARTS, N,
                          device="cpu").model

    return (b, jspec.model, variables, dropout_masks(name, mode, seed + 1),
            make, jspec.input_kind)


@pytest.mark.parametrize("combo", ZOO, ids="-".join)
def test_zoo_logits_match_jax(combo):
    """Eval mode, f32: the port's logits (log-probabilities for
    ``pointnet_conv2d``) against flax's CPU path within rtol 1e-4, atol
    1e-4, as the SSG slice is held (``test_slice_f32_matches_jax_cpu_path``)."""
    b, jmodel, variables, _, make, kind = case(combo)
    model = P.port_model(make, variables)
    assert model.input_kind == kind
    want = P.jax_eval(jmodel, combo[1], variables, b, kind)
    got = P.port_eval(model, combo[1], b)
    shape = (B, NUM_CLASSES) if combo[1] == "clas" else (B, N, NUM_PARTS)
    assert got.shape == want.shape == shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("combo", ZOO, ids="-".join)
def test_zoo_tree_round_trips(combo):
    """flax → port → flax, leaf for leaf and bit for bit."""
    _, _, variables, _, make, _ = case(combo)
    flat = flatten(jax.tree_util.tree_map(np.asarray, variables))
    back = state_dict_to_flax(P.port_model(make, variables).state_dict())
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value)


def _jax_shapes(name, mode, n):
    """Every leaf of the JAX model's variables at width n (eval_shape):
    ``{"params/.../kernel": shape}``."""
    jspec = jregistry.init_model(name, mode, NUM_CLASSES, NUM_PARTS, n)
    b = zoo_batch(jspec.input_kind, 0, batch=1, n=n)
    shapes = jax.eval_shape(lambda *x: jspec.model.init(
        jax.random.PRNGKey(0), *x, train=False),
        *P.inputs(mode, b, jspec.input_kind))
    return {"/".join(p.key for p in path): tuple(leaf.shape) for path, leaf
            in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("combo", jregistry.registry_combos(), ids="-".join)
def test_every_registry_model_places_every_flax_leaf(combo):
    """All 14 combos at the published width (N = 1024): the port's flax
    tree is JAX's, key for key and shape for shape, and random values
    placed by ``flax_to_state_dict`` come back bit for bit."""
    name, mode = combo
    want = _jax_shapes(name, mode, 1024)
    model = init_model(name, mode, NUM_CLASSES, NUM_PARTS, 1024,
                       device="cpu").model
    got = {k: v.shape for k, v in state_dict_to_flax(
        model.state_dict()).items()}
    assert got == want
    rs = np.random.RandomState(1)
    values = {k: rs.randn(*shape).astype(np.float32)
              for k, shape in want.items()}
    model.load_state_dict(flax_to_state_dict(values, model))
    back = state_dict_to_flax(model.state_dict())
    for key, value in values.items():
        np.testing.assert_array_equal(back[key], value)


def test_conv3d_and_conv_transpose_kernels_match_flax(rng):
    """A flax ``Conv`` over NDHWC (VoxNet's first layer) and a 1-D
    ``ConvTranspose(k=2, s=2)`` (KD-UNet's decoder, mirrored) through
    ``convert.py`` and the port's ``conv``: outputs within 1e-5, and each
    kernel flax → torch → flax bit for bit."""
    x3 = rng.rand(2, 12, 12, 12, 1).astype(np.float32)
    jc = fnn.Conv(8, (5, 5, 5), strides=2, padding="VALID")
    v3 = _named("Conv_0", jc.init(jax.random.PRNGKey(0), jnp.asarray(x3)))
    m3 = _holder("Conv_0", torch.nn.Conv3d(1, 8, 5, stride=2), v3)
    got = conv(m3.Conv_0, T(x3).permute(0, 4, 1, 2, 3), lambda x, w:
               torch.nn.functional.conv3d(x, w, stride=2))
    want = jc.apply({"params": v3["params"]["Conv_0"]}, jnp.asarray(x3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    x1 = rng.randn(2, 5, 6).astype(np.float32)
    jt = fnn.ConvTranspose(4, kernel_size=(2,), strides=(2,))
    v1 = _named("ConvTranspose_0",
                jt.init(jax.random.PRNGKey(1), jnp.asarray(x1)))
    m1 = _holder("ConvTranspose_0", torch.nn.ConvTranspose1d(6, 4, 2,
                                                             stride=2), v1)
    got = conv(m1.ConvTranspose_0, T(x1).transpose(1, 2), lambda x, w:
               torch.nn.functional.conv_transpose1d(x, w, stride=2))
    want = jt.apply({"params": v1["params"]["ConvTranspose_0"]},
                    jnp.asarray(x1))
    np.testing.assert_allclose(got.transpose(1, 2).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    for module, variables in ((m3, v3), (m1, v1)):
        back = state_dict_to_flax(module.state_dict())
        flat = flatten(variables)
        assert set(back) == set(flat)
        for key, value in flat.items():
            np.testing.assert_array_equal(back[key], value)


def _named(name, variables):
    """A layer's flax variables as the child ``name`` of a model."""
    return {"params": {name: jax.tree_util.tree_map(np.asarray,
                                                    variables["params"])}}


def _holder(name, layer, variables):
    """``layer`` as the child ``name`` of a module, filled from flax."""
    holder = torch.nn.Module()
    holder.add_module(name, layer)
    return load_flax_weights(holder, variables)
