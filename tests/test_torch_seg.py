"""The port's feature propagation (``knn``, ``three_nn_interpolate``,
``FeaturePropagation``), the segmentation metrics and the PointNet++ SSG
part-segmentation model against the JAX package, on the CPU, and the
command line in ``--mode seg`` (the MSG segmentation model:
``tests/test_torch_seg_msg.py``).

Inputs are numpy arrays from one seed, weights come from flax through
``convert``. Tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.models.segment import PointNet2SSGSeg as JaxSSGSeg
from papc_tpu.nn import FeaturePropagation as JaxFP
from papc_tpu.ops import grouping as jgrouping
from papc_tpu.ops.interpolate import three_nn_interpolate as jinterp
from papc_tpu.train import metrics as jmetrics

from papc_tpu_torch import __main__ as cli
from papc_tpu_torch.convert import flatten, state_dict_to_flax
from papc_tpu_torch.models import init_model
from papc_tpu_torch.models.segment import PointNet2SSGSeg
from papc_tpu_torch.nn import FeaturePropagation
from papc_tpu_torch.ops import grouping, interpolate
from papc_tpu_torch.train import metrics

from tests import torch_parity as P
from tests.test_torch_train import _compare_fused, _fused_pair

T = torch.from_numpy


# ------------------------------------------------------- knn and weights

def _fp_clouds(seed, B=2, N=200, S=48):
    """Dense queries ``xyz1 [B, N, 3]`` and sparse sources ``xyz2 [B, S,
    3]`` taken from them (every source coincides with a query, as FPS
    centres do), with exact ties built in: sources 1 and 5 are copies of
    source 0, so every query sees equal distances to them."""
    rs = np.random.RandomState(seed)
    xyz1 = (0.5 * rs.randn(B, N, 3)).astype(np.float32)
    pick = np.stack([rs.choice(N, S, replace=False) for _ in range(B)])
    xyz2 = np.take_along_axis(xyz1, pick[..., None], axis=1).copy()
    xyz2[:, 1] = xyz2[:, 0]
    xyz2[:, 5] = xyz2[:, 0]
    return xyz1, xyz2


def test_knn_matches_jax_with_ties():
    """The 3 nearest sources: indices equal to ``lax.top_k``'s (ties to
    the lower index: a query at source 0 gets 0, 1, 5), squared
    distances within 1e-6 (the same expansion summed in another order)."""
    xyz1, xyz2 = _fp_clouds(1)
    d, idx = grouping.knn(3, T(xyz2), T(xyz1))
    jd, jidx = jgrouping.knn(3, jnp.asarray(xyz2), jnp.asarray(xyz1))
    assert idx.dtype == torch.int32 and idx.shape == (2, 200, 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    at_zero = np.all(xyz1 == xyz2[:, :1], axis=-1)  # queries at source 0
    assert at_zero.sum() == 2
    assert (idx.numpy()[at_zero] == [0, 1, 5]).all()


def test_three_nn_interpolate_matches_jax():
    """Values and the gradient of the source features (the row
    scatter-add) against JAX within rtol 1e-5, atol 1e-5, except where a
    query coincides with a source. There d ≈ 0 up to the expansion's
    rounding (a few 1e-8 either side, and not the same on both sides),
    so ``1 / (d + 1e-8)`` is huge, of either sign and unequal between
    them; normalised, that source's weight is within 1e-4 of 1 on both
    sides and the others' weights, ~(d + 1e-8) / d', differ by up to
    1e-7 / d': those rows within atol 1e-4, and equal to the coinciding
    source's feature within 1e-4."""
    xyz1, xyz2 = _fp_clouds(2)
    rs = np.random.RandomState(3)
    feats = rs.randn(2, 48, 7).astype(np.float32)
    cot = rs.randn(2, 200, 7).astype(np.float32)
    tf = T(feats).requires_grad_()
    got = interpolate.three_nn_interpolate(T(xyz1), T(xyz2), tf)
    got.backward(T(cot))
    want, vjp = jax.vjp(lambda f: jinterp(jnp.asarray(xyz1),
                                          jnp.asarray(xyz2), f),
                        jnp.asarray(feats))
    got, want = got.detach().numpy(), np.asarray(want)
    own = np.all(xyz1[:, :, None] == xyz2[:, None], axis=-1)  # [B, N, S]
    at = own.any(-1)
    assert at.sum() == 2 * 48 - 4  # sources 1 and 5 repeat source 0
    np.testing.assert_allclose(got[~at], want[~at], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[at], want[at], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=1e-4)
    _, idx = grouping.knn(3, T(xyz2), T(xyz1))
    b, n = np.nonzero(own.sum(-1) == 1)  # not the three copies of source 0
    first = own[b, n].argmax(-1)
    assert (idx.numpy()[b, n, 0] == first).all()
    np.testing.assert_allclose(got[b, n], feats[b, first], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("S", [1, 48])
def test_feature_propagation_matches_flax(S):
    """``FeaturePropagation`` (S=1 broadcast and 3-NN) in eval mode within
    1e-5, and in train mode (batch statistics over all B·N rows) its
    output, the gradients of both feature inputs and of its parameters
    within 1e-4 of the largest, against flax's autodiff."""
    xyz1, xyz2 = _fp_clouds(4, S=max(S, 6))
    xyz2 = xyz2[:, :S]
    rs = np.random.RandomState(5)
    p1 = rs.randn(2, 200, 9).astype(np.float32)
    p2 = rs.randn(2, S, 12).astype(np.float32)
    cot = rs.randn(2, 200, 16).astype(np.float32)
    jfp = JaxFP((32, 16))
    args = [jnp.asarray(a) for a in (xyz1, xyz2, p1, p2)]
    variables = P.perturb_stats(jfp.init(jax.random.PRNGKey(0), *args,
                                         train=False), 6)
    fp = P.port_model(lambda: FeaturePropagation(21, (32, 16)), variables)
    want = jfp.apply(variables, *args, train=False)
    with torch.inference_mode():
        got = fp.eval()(*(T(a) for a in (xyz1, xyz2, p1, p2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    def loss(params, a, b):
        y, _ = jfp.apply({"params": params,
                          "batch_stats": variables["batch_stats"]},
                         args[0], args[1], a, b, train=True,
                         mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(cot)), y

    (_, want_y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                            has_aux=True)(
        variables["params"], args[2], args[3])
    t1, t2 = T(p1).requires_grad_(), T(p2).requires_grad_()
    y = fp.train()(T(xyz1), T(xyz2), t1, t2)
    (y * T(cot)).sum().backward()
    P.close_to_max(y.detach().numpy(), np.asarray(want_y), 1e-5)
    P.close_to_max(t1.grad.numpy(), np.asarray(grads[1]), 1e-4)
    P.close_to_max(t2.grad.numpy(), np.asarray(grads[2]), 1e-4)
    port_grads = state_dict_to_flax({n: p.grad
                                     for n, p in fp.named_parameters()})
    want_grads = flatten({"params": grads[0]})
    for key, want_g in want_grads.items():
        # a Dense bias before a BN has a true gradient of 0: rounding noise
        scale = (P.module_scale(want_grads, key)
                 if P.is_noise(key, want_grads) else 0.0)
        P.close_to_max(port_grads[key], want_g, 1e-4, scale)


def test_fused_train_at_width_196_matches_jax_fused_jnp():
    """MSG segmentation's SA2 second branch, 323 → 128 → 196 → 256: the
    first output width of the port that is not a multiple of 16. The
    fused training Function against ``fused_mlp_max(train=True,
    impl="jnp")`` on the same inputs: with f32 operands under the SSG
    passes' tolerances (tests/test_torch_train.py: outputs and
    statistics 1e-5, gradients 1e-4); with bf16 operands, outputs and
    statistics within 1e-2 and every gradient at most 1.5 times as far
    from the f32 result as JAX's bf16 gradient is from JAX's f32 one
    (measured 1.12 at most): at 2048 rows a bf16 tie that flips moves
    a whole row of the input gradient, so an elementwise bound would
    measure the flips, not the port."""
    shape, widths = (2, 8, 16, 323), (128, 196, 256)
    port, want = _fused_pair(np.random.RandomState(11), P.F32, shape, widths)
    assert port[3][1][0].shape == (128, 196)
    _compare_fused(port, want, 1e-5, 1e-4)
    port16, want16 = _fused_pair(np.random.RandomState(11), P.BF16, shape,
                                 widths)
    P.close_to_max(port16[0], want16[0], 1e-2)
    for (m, v), (wm, wv) in zip(port16[1], want16[1]):
        P.close_to_max(m, wm, 1e-2)
        P.close_to_max(v, wv, 1e-2)
    norm = np.linalg.norm
    pairs = [(port16[2], want16[2], port[2], want[2])] + [
        (g16, w16, g, w) for l16, lw16, l, lw in zip(
            port16[3], want16[3], port[3], want[3])
        for g16, w16, g, w in zip(l16, lw16, l, lw)]
    for g16, w16, g, w in pairs:
        assert norm(g16 - g) <= 1.5 * norm(w16 - w) + 1e-6 * norm(w)


def test_mean_iou_and_seg_loss_match_jax():
    """``mean_iou`` (classes with a non-zero union; the ``[B]`` mask
    repeated over the points) and the per-point loss against JAX's, on
    a padded final batch (two mask-False rows) and without a mask, also
    from argmaxed predictions: equal up to f32 rounding (1e-6)."""
    rs = np.random.RandomState(7)
    logits = rs.randn(5, 30, 6).astype(np.float32)
    pid = rs.randint(0, 5, (5, 30)).astype(np.int32)  # class 5 never appears
    mask = np.array([1, 1, 1, 0, 0], bool)
    for m in (None, mask):
        tm = None if m is None else T(m)
        jm = None if m is None else jnp.asarray(m)
        for x in (logits, logits.argmax(-1)):
            got = float(metrics.mean_iou(T(x), T(pid), 6, tm))
            want = float(jmetrics.mean_iou(jnp.asarray(x), jnp.asarray(pid),
                                           6, jm))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
        got = float(metrics.softmax_cross_entropy(T(logits), T(pid), tm))
        want = float(jmetrics.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(pid), jm))
        assert got == pytest.approx(want, rel=1e-6)
    padded = logits.copy()
    padded[3:] = 100.0  # padding rows' values must not count
    assert float(metrics.mean_iou(T(padded), T(pid), 6, T(mask))) == \
        pytest.approx(float(metrics.mean_iou(T(logits), T(pid), 6, T(mask))))


# ------------------------------------------- the SSG segmentation model

NPOINTS, NSAMPLES = (128, 32), (16, 32)


def _make_ssg():
    return PointNet2SSGSeg(num_classes=16, num_parts=50, npoints=NPOINTS,
                           nsamples=NSAMPLES)


@pytest.fixture(scope="module")
def ssg_seg():
    b = P.batch(2, 256, seed=8)
    jmodel = JaxSSGSeg(num_classes=16, num_parts=50, npoints=NPOINTS,
                       nsamples=NSAMPLES)
    variables = P.perturbed_variables(jmodel, "seg", b, 8)
    masks = [np.random.RandomState(9).uniform(size=(2, 256, 128)) < 0.5]
    return b, jmodel, variables, masks


def test_ssg_seg_logits_match_jax(ssg_seg):
    """Full widths (1.41 M parameters) with the SA stages reduced to 128
    and 32 centres, B=2 x 256 points, eval mode: per-point logits with
    f32 operands against flax's classic CPU path within rtol 1e-4, atol
    1e-4; with bf16 operands against ``override(enable=True,
    impl="jnp")`` (every SA stage fused) within rtol 1e-2, atol 1e-3."""
    b, jmodel, variables, _ = ssg_seg
    model = P.port_model(_make_ssg, variables)
    want = P.jax_eval(jmodel, "seg", variables, b)
    got = P.port_eval(model, "seg", b)
    assert got.shape == (2, 256, 50) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        P.permissive_fused_gate(mp)
        with P.jfused.override(enable=True, impl="jnp"):
            want16 = P.jax_eval(jmodel, "seg", variables, b)
    got16 = P.port_eval(model, "seg", b, torch.bfloat16)
    np.testing.assert_allclose(got16, want16, rtol=1e-2, atol=1e-3)


def test_ssg_seg_train_steps_match_jax(ssg_seg, monkeypatch):
    """One step with f32 operands against ``make_train_step`` on JAX's
    classic path and its float64 twin, and one with bf16 operands
    against the fused jnp step, the port's float64 step the exact
    reference for both (the per-point loss over the valid clouds, the
    head's dropout mask given), judged as the MSG classifier's steps
    (tests/test_torch_msg_train.py). Measured on this input, gradients
    as fractions of their module's largest: f32, the port 6.0e-3 from
    its float64 step (the FP layers' BN takes flax's E[x²] - E[x]² in
    f32), JAX 7.5e-2, the two float64 steps 1.6e-5 apart, losses within
    5e-7; bf16, losses 9.3e-4 apart, statistics 3.5e-3, median relative
    L2 to JAX 0.29, distance from float64 at most 1.07 (median 0.97)
    times JAX's, noise biases 7.3e-3. The limits leave about twice
    that."""
    b, jmodel, variables, masks = ssg_seg
    lr = wd = 1e-3
    exact = P.port_step(_make_ssg, variables, b, masks, lr, wd,
                        torch.float64)
    want = P.jax_step(jmodel, "seg", variables, b, masks, lr, wd, False)
    want64 = P.jax_step_x64(jmodel, "seg", variables, b, masks, lr, wd)
    port = P.port_step(_make_ssg, variables, b, masks, lr, wd, P.F32)
    P.check_f32_step(port, want, exact, want64, variables, lr, wd,
                     {"loss": 1e-5, "port": 1.5e-2, "jax": 0.15, "x64": 1e-4})
    P.permissive_fused_gate(monkeypatch)
    want = P.jax_step(jmodel, "seg", variables, b, masks, lr, wd, True)
    port = P.port_step(_make_ssg, variables, b, masks, lr, wd, P.BF16)
    P.check_bf16_step(port, want, exact, variables, lr, wd,
                      {"loss": 3e-3, "stats": 1e-2, "ratio": 1.5,
                       "median_ratio": 1.25, "median_rel": 0.45,
                       "noise": 2e-2})


def test_ssg_seg_tree_round_trips(ssg_seg):
    """flax → port → flax, leaf for leaf and bit for bit
    (``FeaturePropagation_i``, ``_SegHead2_0``); the full-width model's
    parameter count equals flax's."""
    b, jmodel, variables, _ = ssg_seg
    flat = flatten(jax.tree_util.tree_map(np.asarray, variables))
    back = state_dict_to_flax(P.port_model(_make_ssg, variables).state_dict())
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value)
    assert "params/_SegHead2_0/Dense_1/kernel" in flat
    assert "batch_stats/FeaturePropagation_2/PointMLP_0/BatchNorm_2/var" in flat
    full = init_model("pointnet2_ssg", "seg", device="cpu").model
    jfull = jax.eval_shape(lambda *x: JaxSSGSeg().init(
        jax.random.PRNGKey(0), *x, train=False), *P.inputs("seg", b))
    assert sum(p.numel() for p in full.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(
            jfull["params"])) == 1_411_250


def test_cli_trains_and_serves_seg(tmp_path, capsys):
    """``python -m papc_tpu_torch --mode seg`` trains one tiny epoch of
    the MSG segmentation model on synthetic ``.h5`` shards (the part
    labels read with the clouds), logs ``miou``, writes flax-keyed
    weights, and ``--evaluate`` serves them."""
    from papc_tpu.data.synthetic import write_shapenet_h5

    data = write_shapenet_h5(str(tmp_path / "data"), n_train=2, n_test=2,
                             n_val=2, n_points=128, num_classes=16,
                             num_parts=50)
    model_dir = tmp_path / "model"
    common = ["--model_name", "pointnet2_msg", "--mode", "seg", "--path",
              data, "--max_point", "128", "--batchsize", "2", "--device",
              "cpu"]
    assert cli.main(common + ["--epoch_num", "1", "--model_dir",
                              str(model_dir)]) == 0
    out = capsys.readouterr().out
    assert "epoch: 0, batch_id: 0, loss is: [" in out and "miou is: [" in out
    weights = model_dir / "pointnet2_msg_0.npz"
    assert weights.exists()
    assert cli.main(common + ["--evaluate", "--weights", str(weights)]) == 0
    line = capsys.readouterr().out
    assert "eval[test]: loss=" in line and "miou=" in line
