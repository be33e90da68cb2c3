"""The port's SSG classifier slice against the JAX model, on the CPU.

A reduced ``PointNet2SSGClas`` is initialised in flax, given non-trivial
running statistics, converted with ``papc_tpu_torch.convert`` and run in
eval mode on both sides with the same numpy clouds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.models.classify import PointNet2SSGClas as JaxSSG
from papc_tpu.nn import layers as jlayers
from papc_tpu.ops import fused_mlp as jfused

from papc_tpu_torch.convert import load_flax_weights
from papc_tpu_torch.data import make_cloud
from papc_tpu_torch.models import init_model, registry_combos
from papc_tpu_torch.models.classify import PointNet2SSGClas
from papc_tpu_torch.nn import BN_EPS, BN_MOMENTUM, BatchNorm, MLPHead, PointMLP
from papc_tpu_torch.ops import fused_mlp


def _clouds(B, N, num_classes=16, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([make_cloud(rng, int(rng.randint(num_classes)), N,
                                num_classes)[0] for _ in range(B)])


def _perturb_stats(variables, seed=1):
    """Running statistics away from (0, 1), as a trained model's are."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "mean":
                out[k] = jnp.asarray(0.1 * rng.randn(*v.shape), jnp.float32)
            else:
                out[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape),
                                     jnp.float32)
        return out

    return {"params": variables["params"],
            "batch_stats": walk(variables["batch_stats"])}


def _pair(B, N, npoints, nsamples, seed=0):
    clouds = _clouds(B, N, seed=seed)
    jmodel = JaxSSG(num_classes=16, npoints=npoints, nsamples=nsamples)
    variables = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(seed), x,
                                              train=False))(jnp.asarray(clouds))
    variables = _perturb_stats(variables, seed + 1)
    model = PointNet2SSGClas(num_classes=16, npoints=npoints,
                             nsamples=nsamples).eval()
    load_flax_weights(model, jax.tree_util.tree_map(np.asarray, variables))
    return clouds, jmodel, variables, model


def _jax_logits(jmodel, variables, clouds):
    return jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(clouds))


def test_slice_f32_matches_jax_cpu_path():
    """(a) Port with f32 operands vs JAX's default CPU path (classic f32
    Dense/BN, no fused stage). The arithmetic differs only in where BN
    is folded and in f32 summation order: logits within 1e-4."""
    clouds, jmodel, variables, model = _pair(4, 256, (64, 32), (16, 32))
    want = np.asarray(_jax_logits(jmodel, variables, clouds))
    with fused_mlp.override(impl="plain", operand_dtype=torch.float32):
        with torch.inference_mode():
            got = model(torch.from_numpy(clouds)).numpy()
    assert got.shape == (4, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_slice_bf16_matches_jax_fused_jnp():
    """(b) Port with bf16 operands (the card's contract) vs JAX under
    ``fused_mlp.override(enable=True, impl='jnp')``. B=32 and 128 SA2
    centres make SA3's grouped tensor [32, 1, 128, 259], which passes
    ``fused_mlp.supported``, so all three SA stages fuse on both sides.
    Tolerance on the logits: each side rounds every activation to
    bf16, and a product summed in another order can land on the other
    side of a bf16 rounding boundary (2^-8 relative) and carry through
    the later layers. Measured 1.0e-4 on logits of magnitude 0.2 here,
    against 3.9e-4 between this and JAX's f32 path, so atol 1e-3 with
    rtol 1e-2 (the magnitudes of a trained model's logits)."""
    B, npoints, nsamples = 32, (128, 128), (16, 16)
    clouds, jmodel, variables, model = _pair(B, 192, npoints, nsamples)
    for shape, feats in [((B, 128, 16, 3), (64, 64, 128)),
                         ((B, 128, 16, 131), (128, 128, 256)),
                         ((B, 1, 128, 259), (256, 512, 1024))]:
        assert jfused.supported(shape, feats)
    with jfused.override(enable=True, impl="jnp"):  # read while tracing
        want = np.asarray(_jax_logits(jmodel, variables, clouds))
    with torch.inference_mode():
        got = model(torch.from_numpy(clouds)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-3)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_full_width_forward_shape_and_params():
    """The served width: 1.47 M parameters, [B, 16] logits (CPU, B=1)."""
    spec = init_model("pointnet2_ssg", "clas", num_classes=16, seed=0,
                      device="cpu")
    n_params = sum(p.numel() for p in spec.model.parameters())
    jmodel = JaxSSG(num_classes=16)
    clouds = _clouds(1, 1024)
    jvars = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x,
                                                 train=False),
                           jnp.asarray(clouds))
    j_params = sum(int(np.prod(v.shape))
                   for v in jax.tree_util.tree_leaves(jvars["params"]))
    assert n_params == j_params == 1_469_520
    with torch.inference_mode():
        out = spec.model(torch.from_numpy(clouds))
    assert out.shape == (1, 16) and torch.isfinite(out).all()


def test_seeded_init_follows_flax_families():
    a = init_model(seed=3, device="cpu").model.state_dict()
    b = init_model(seed=3, device="cpu").model.state_dict()
    c = init_model(seed=4, device="cpu").model.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["SetAbstraction_1.PointMLP_0.Dense_0.weight"]  # fan_in 131
    assert not torch.equal(w, c["SetAbstraction_1.PointMLP_0.Dense_0.weight"])
    assert abs(float(w.std()) - 131 ** -0.5) < 0.1 * 131 ** -0.5
    assert float(w.abs().max()) <= 2 * 131 ** -0.5 / 0.87962566103423978
    assert float(a["MLPHead_0.Dense_0.bias"].abs().max()) == 0.0
    assert float((a["MLPHead_0.BatchNorm_0.running_var"] - 1).abs().max()) == 0


def test_batchnorm_and_head_match_flax(rng):
    import flax.linen as fnn

    x = rng.randn(5, 12).astype(np.float32)
    jhead = jlayers.MLPHead((8, 6), 3, dropout_rate=0.4, bn=True,
                            per_layer_dropout=True)
    variables = _perturb_stats(jhead.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x), train=False))
    want = np.asarray(jhead.apply(variables, jnp.asarray(x), train=False))
    head = MLPHead(12, (8, 6), 3, bn=True).eval()
    load_flax_weights(head, jax.tree_util.tree_map(np.asarray, variables))
    with torch.inference_mode():
        got = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    jbn = fnn.BatchNorm(use_running_average=True, momentum=BN_MOMENTUM,
                        epsilon=BN_EPS)
    bvars = _perturb_stats(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    bn = BatchNorm(12).eval()
    load_flax_weights(bn, jax.tree_util.tree_map(np.asarray, bvars))
    with torch.inference_mode():
        np.testing.assert_allclose(
            bn(torch.from_numpy(x)).numpy(),
            np.asarray(jbn.apply(bvars, jnp.asarray(x))), rtol=1e-6,
            atol=1e-6)


def test_point_mlp_without_pool_matches_flax(rng):
    x = rng.randn(2, 10, 6).astype(np.float32)
    jm = jlayers.PointMLP((8, 16))
    variables = _perturb_stats(jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x), train=False))
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    m = PointMLP(6, (8, 16)).eval()
    load_flax_weights(m, jax.tree_util.tree_map(np.asarray, variables))
    with torch.inference_mode():
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-5, atol=1e-5)


def test_training_mode_and_other_models_raise():
    """Training mode runs (an nn.Module starts in it) and gives every
    parameter a gradient; the four ported combos construct (on the CPU
    when asked; the card is the default), and the models not ported yet
    still raise."""
    model = PointNet2SSGClas(npoints=(8, 4), nsamples=(4, 4))
    points = torch.from_numpy(_clouds(2, 16))
    logits = model(points, generator=torch.Generator().manual_seed(0))
    assert logits.shape == (2, 16) and bool(torch.isfinite(logits).all())
    logits.square().sum().backward()
    assert all(p.grad is not None for p in model.parameters())
    assert float(model.SetAbstraction_0.PointMLP_0.BatchNorm_0
                 .running_var.sub(1).abs().max()) > 0
    assert registry_combos() == (("pointnet2_ssg", "clas"),
                                 ("pointnet2_msg", "clas"),
                                 ("pointnet2_ssg", "seg"),
                                 ("pointnet2_msg", "seg"))
    for name, mode in registry_combos():
        spec = init_model(name, mode, device="cpu")
        assert spec.mode == spec.model.mode == mode
        assert not spec.model.training
        assert next(spec.model.parameters()).device.type == "cpu"
    for name, mode in [("pointnet", "clas"), ("pointnet", "seg"),
                       ("pointnet_basic", "clas"), ("pointnet_conv2d", "clas"),
                       ("vfe", "seg"), ("voxnet", "clas"), ("kdnet", "clas"),
                       ("kdunet", "seg")]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_model(name, mode, device="cpu")
    with pytest.raises(SystemExit):
        init_model("pointnet2_ssg", "detect", device="cpu")
