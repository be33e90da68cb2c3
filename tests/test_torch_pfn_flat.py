"""The port's flat-points PFN against the JAX package, on the CPU.

``detect/pfn_fast.py::pfn_forward_flat`` against JAX's
``papc_tpu/detect/pfn_fast.py::pfn_forward_flat`` on the same flat
points (JAX's ``flatten_pillars`` of a seeded pillar grid at the car config's
cells and range), in training and in eval mode, with and without the
distance feature: the output, the new running statistics, and the
gradients with respect to the kernel, BatchNorm's scale and bias and the
points. The port's PFN on the flat points also against the same module
on the grid they were flattened from, and the whole ``PointPillars`` on
flat points against it on the grid and against JAX's flat one, all from one
state dict converted from one flax tree. Tolerances are those of JAX's
own ``tests/test_pfn_fast.py``: outputs rtol 1e-4 / atol 1e-5, the
running mean 1e-4 / 1e-6, the variance 1e-3 / 1e-6, gradients 2e-3 /
1e-4; whole head maps 1e-3 / 1e-4. On random data the gradients are
taken through the pillars and channels clear of a near-tie
(``_clear_of_ties``: the two largest activations of a pillar, its padded
slots' one among them, within 1e-5 of the larger or of 1): there two
correct f32 evaluations may pick either point for the max, and its
gradient moves to the other (a near-tie 1.7e-6 apart did so at the
seed of the ``with_distance`` case).

The ties are planted, since each decides where a gradient goes: points
repeated in a pillar (the scatter-max shares a tie's gradient evenly,
as JAX's does), channels whose BatchNorm shift makes every activation
negative (``seg == a0 == 0``: ``maximum`` splits 0.5 / 0.5), a channel
of exactly zero activations (``maximum(x, 0)``'s gradient 0.5 at 0),
full pillars (no padded slot) and empty ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.detect import pfn_fast as jpfn
from papc_tpu.detect.model import PillarFeatureNet as JaxPFN
from papc_tpu.detect.model import PointPillars as JaxPointPillars

from papc_tpu_torch import convert
from papc_tpu_torch.detect import pfn_fast
from papc_tpu_torch.detect.model import PillarFeatureNet, PointPillars
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

T = torch.from_numpy
VOXEL_SIZE = (0.16, 0.16, 4.0)
PC_RANGE = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
NY, NX = 496, 432
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
MEAN_TOL = dict(rtol=1e-4, atol=1e-6)
VAR_TOL = dict(rtol=1e-3, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)


def _grid(seed, B=2, V=256, P=16, D=4, with_distance=False):
    """Pillars at KITTI's range (JAX's ``tests/test_pfn_fast.py``
    fixture): ``(voxels, num_points, coords, variables)``, the flax PFN's
    initial variables with running statistics moved away from (0, 1);
    ten full pillars and an empty one."""
    rs = np.random.RandomState(seed)
    coords = np.stack([np.zeros((B, V), np.int32), rs.randint(0, NY, (B, V)),
                       rs.randint(0, NX, (B, V))], -1).astype(np.int32)
    num_points = rs.randint(1, P + 1, (B, V)).astype(np.int32)
    num_points[0, :10] = P
    num_points[1, 0] = 0
    px = coords[..., 2] * VOXEL_SIZE[0] + VOXEL_SIZE[0] / 2 + PC_RANGE[0]
    py = coords[..., 1] * VOXEL_SIZE[1] + VOXEL_SIZE[1] / 2 + PC_RANGE[1]
    voxels = np.zeros((B, V, P, D), np.float32)
    voxels[..., 0] = px[..., None] + rs.randn(B, V, P) * 0.05
    voxels[..., 1] = py[..., None] + rs.randn(B, V, P) * 0.05
    voxels[..., 2] = rs.uniform(-3, 1, (B, V, P))
    voxels[..., 3:] = rs.rand(B, V, P, D - 3)
    voxels *= (np.arange(P)[None, None, :] < num_points[..., None])[..., None]
    pfn = JaxPFN(num_filters=(64,), voxel_size=VOXEL_SIZE, pc_range=PC_RANGE,
                 with_distance=with_distance)
    variables = jax.tree_util.tree_map(np.array, pfn.init(
        jax.random.PRNGKey(seed), jnp.asarray(voxels), jnp.asarray(num_points),
        jnp.asarray(coords), train=False))
    stats = variables["batch_stats"]["PFNLayer_0"]["BatchNorm_0"]
    stats["mean"] = rs.randn(64).astype(np.float32)
    stats["var"] = rs.uniform(0.5, 2.0, 64).astype(np.float32)
    return voxels, num_points, coords, variables


def _clear_of_ties(voxels, num_points, coords, variables, with_distance,
                   train, margin=1e-5):
    """``[B, V, O]`` 1 where a pillar's channel is clear of a near-tie, 0
    where its two largest activations (its real points', and its padded
    slots' once) lie within ``margin`` of the larger or of 1, computed in
    float64 on the grid (the classic PFN's form)."""
    (kernel, scale, bias), (r_mean, r_var) = _args(variables)
    v = voxels.astype(np.float64)
    P = v.shape[2]
    mean = (v[..., :3].sum(2, keepdims=True)
            / np.maximum(num_points, 1)[..., None, None])
    px = coords[..., 2] * VOXEL_SIZE[0] + VOXEL_SIZE[0] / 2 + PC_RANGE[0]
    py = coords[..., 1] * VOXEL_SIZE[1] + VOXEL_SIZE[1] / 2 + PC_RANGE[1]
    feats = [v, v[..., :3] - mean,
             np.stack([v[..., 0] - px[..., None], v[..., 1] - py[..., None]],
                      -1)]
    if with_distance:
        feats.append(np.linalg.norm(v[..., :3], axis=-1, keepdims=True))
    slot = np.arange(P)[None, None, :]
    f = np.concatenate(feats, -1) * (slot < num_points[..., None])[..., None]
    h = f @ kernel.astype(np.float64)
    mu, var = (h.mean((0, 1, 2)), h.var((0, 1, 2))) if train else (
        r_mean, r_var)
    a = np.maximum((h - mu) / np.sqrt(var + 1e-3) * scale + bias, 0)
    once = (slot <= num_points[..., None])[..., None]  # one padded slot
    top = np.sort(np.where(once, a, -np.inf), axis=2)
    top1, top2 = top[:, :, -1], top[:, :, -2]
    return (top1 - top2 > margin * np.maximum(top1, 1)).astype(np.float32)


def _args(variables):
    p = variables["params"]["PFNLayer_0"]
    s = variables["batch_stats"]["PFNLayer_0"]["BatchNorm_0"]
    return (p["Dense_0"]["kernel"], p["BatchNorm_0"]["scale"],
            p["BatchNorm_0"]["bias"]), (s["mean"], s["var"])


def _jax_flat(variables, points, owner, num_points, coords, P, cot, **kw):
    """JAX's flat PFN: ``(out, new_running, grads of (kernel, scale,
    bias, points))`` for the loss ``sum(out · cot)``."""
    (kernel, scale, bias), running = _args(variables)

    def loss(k, s, b, pts):
        out, nr = jpfn.pfn_forward_flat(
            k, s, b, tuple(map(jnp.asarray, running)), pts,
            jnp.asarray(owner), jnp.asarray(num_points), jnp.asarray(coords),
            P, voxel_size=VOXEL_SIZE, pc_range=PC_RANGE, **kw)
        return jnp.sum(out * cot), (out, nr)

    (_, (out, nr)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(
            *map(jnp.asarray, (kernel, scale, bias, points)))
    return (np.asarray(out), [np.asarray(r) for r in nr],
            [np.asarray(g) for g in grads])


def _port_flat(variables, points, owner, num_points, coords, P, cot, **kw):
    (kernel, scale, bias), running = _args(variables)
    leaves = [T(np.array(a)).requires_grad_(True)
              for a in (kernel, scale, bias, points)]
    out, nr = pfn_fast.pfn_forward_flat(
        *leaves[:3], tuple(T(np.array(r)) for r in running), leaves[3],
        T(owner), T(num_points), T(coords), P, voxel_size=VOXEL_SIZE,
        pc_range=PC_RANGE, **kw)
    (out * T(cot)).sum().backward()
    return (out.detach().numpy(), [r.numpy() for r in nr],
            [t.grad.numpy() for t in leaves])


def _compare(got, want, train, owner):
    """Outputs, running statistics and gradients; the points' gradient
    at the real points (a padded row's distance feature is the norm of a
    zero vector, whose gradient JAX gives as 0/0)."""
    out, nr, grads = got
    w_out, w_nr, w_grads = want
    real = owner >= 0
    grads = grads[:3] + [grads[3][real]]
    w_grads = w_grads[:3] + [w_grads[3][real]]
    np.testing.assert_allclose(out, w_out, **OUT_TOL)
    np.testing.assert_allclose(nr[0], w_nr[0], **MEAN_TOL)
    np.testing.assert_allclose(nr[1], w_nr[1], **VAR_TOL)
    for name, g, w in zip(("kernel", "scale", "bias", "points"), grads,
                          w_grads):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)
    if not train:
        assert all(np.array_equal(a, b) for a, b in zip(nr, w_nr))


@pytest.mark.parametrize("with_distance", [False, True])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_pfn_forward_flat_equals_jax(train, with_distance):
    P = 16
    voxels, num_points, coords, variables = _grid(3, P=P,
                                                  with_distance=with_distance)
    points, owner = jpfn.flatten_pillars(voxels, num_points, coords)
    cot = np.random.RandomState(5).randn(2, 256, 64).astype(np.float32)
    cot *= _clear_of_ties(voxels, num_points, coords, variables,
                          with_distance, train)
    kw = dict(with_distance=with_distance, train=train)
    got = _port_flat(variables, points, owner, num_points, coords, P, cot,
                     **kw)
    _compare(got, _jax_flat(variables, points, owner, num_points, coords, P,
                            cot, **kw), train, owner)
    assert np.abs(got[2][3][owner >= 0]).max() > 0  # the points' gradient


def _planted(seed=7, P=8):
    """A grid with every tie of the flat PFN (see the module docstring):
    slot 0 repeated into slots 1-3 of ten pillars; BatchNorm shifts of
    -1000 on channels 0-7, so every activation there is negative and a
    padded pillar's max is ``maximum(0, a0 = 0)``; channel 8 a zero
    kernel column with a zero shift and running mean, so ``h`` is exactly
    0 at every point in training and in eval."""
    voxels, num_points, coords, variables = _grid(seed, V=64, P=P)
    num_points[0, 10:20] = np.maximum(num_points[0, 10:20], 4)
    voxels[0, 10:20, 1:4] = voxels[0, 10:20, :1]
    voxels *= (np.arange(P)[None, None, :] < num_points[..., None])[..., None]
    params = variables["params"]["PFNLayer_0"]
    params["BatchNorm_0"]["bias"][:8] = -1000.0
    params["Dense_0"]["kernel"][:, 8] = 0.0
    params["BatchNorm_0"]["bias"][8] = 0.0
    variables["batch_stats"]["PFNLayer_0"]["BatchNorm_0"]["mean"][8] = 0.0
    return voxels, num_points, coords, variables


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_planted_ties_equal_jax(train):
    P = 8
    voxels, num_points, coords, variables = _planted(P=P)
    points, owner = jpfn.flatten_pillars(voxels, num_points, coords)
    cot = np.random.RandomState(8).randn(2, 64, 64).astype(np.float32)
    got = _port_flat(variables, points, owner, num_points, coords, P, cot,
                     train=train)
    _compare(got, _jax_flat(variables, points, owner, num_points, coords, P,
                            cot, train=train), train, owner)
    out = got[0]
    # the ties are there: every padded pillar's shifted channels and the
    # zero channel sit at exactly 0, where maximum splits the gradient
    padded = num_points < P
    assert padded.any() and (~padded).any() and (num_points == 0).any()
    assert (out[padded][:, :9] == 0).all()
    # a repeated point's gradient is shared with its copies
    g_pts = got[2][3]
    rows = owner[0] >= 0
    first = np.flatnonzero(rows & (owner[0] == 10))[:4]
    assert np.abs(g_pts[0, first]).sum() > 0


def test_maximum_relu_gradient_at_zero_is_a_half():
    """``nnrelu`` is ``maximum(x, 0)``: its gradient at 0 is JAX's 0.5
    (``torch.relu`` gives 0)."""
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    pfn_fast.nnrelu(x).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jpfn.nnrelu(v)))(
        jnp.asarray([-1.0, 0.0, 2.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad.tolist() == [0.0, 0.5, 1.0]


def _port_pfns(variables, P, with_distance=False):
    kw = dict(num_input_features=4, num_filters=(64,), voxel_size=VOXEL_SIZE,
              pc_range=PC_RANGE, with_distance=with_distance,
              max_points_per_pillar=P)
    classic, flat = PillarFeatureNet(**kw), PillarFeatureNet(**kw)
    for m in (classic, flat):
        convert.load_flax_weights(m, variables)
    return classic, flat


@pytest.mark.parametrize("with_distance", [False, True])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_flat_equals_the_port_classic_pfn(train, with_distance):
    """The PFN on flat points against the same PFN on the grid they were
    flattened from: the output, the running statistics after, and the
    gradients of the kernel, scale and bias."""
    P = 16
    voxels, num_points, coords, variables = _grid(4, P=P,
                                                  with_distance=with_distance)
    points, owner = jpfn.flatten_pillars(voxels, num_points, coords)
    cot = T(np.random.RandomState(6).randn(2, 256, 64).astype(np.float32)
            * _clear_of_ties(voxels, num_points, coords, variables,
                             with_distance, train))
    classic, flat = _port_pfns(variables, P, with_distance)
    res = []
    for m, args in ((classic, (T(voxels), T(num_points), T(coords))),
                    (flat, (None, T(num_points), T(coords), T(points),
                            T(owner)))):
        m.train(train)
        out = m(*args)
        (out * cot).sum().backward()
        layer = m.PFNLayer_0
        res.append((out.detach().numpy(), layer.BatchNorm_0.running_mean,
                    layer.BatchNorm_0.running_var,
                    [p.grad.numpy() for p in (layer.Dense_0.weight,
                                              layer.BatchNorm_0.weight,
                                              layer.BatchNorm_0.bias)]))
    (out, mean, var, grads), (w_out, w_mean, w_var, w_grads) = res[1], res[0]
    np.testing.assert_allclose(out, w_out, **OUT_TOL)
    np.testing.assert_allclose(mean, w_mean, **MEAN_TOL)
    np.testing.assert_allclose(var, w_var, **VAR_TOL)
    for g, w in zip(grads, w_grads):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_pointpillars_flat_and_classic_share_one_state_dict():
    """``PointPillars`` on flat points against the same network on the
    grid, and against JAX's flat network, in training mode (the running
    statistics after it too), from one flax tree converted once; without
    flat points the network runs the grid."""
    P, B, V, D, ny, nx = 8, 2, 128, 4, 16, 24
    rs = np.random.RandomState(7)
    coords = np.full((B, V, 3), -1, np.int32)
    for b in range(B):
        n = rs.randint(V // 2, V)
        lin = rs.choice(ny * nx, size=n, replace=False)
        coords[b, :n] = np.stack([np.zeros(n), lin // nx, lin % nx], -1)
    num_points = rs.randint(0, P + 1, (B, V)).astype(np.int32)
    num_points[coords[..., 0] < 0] = 0
    voxels = rs.randn(B, V, P, D).astype(np.float32)
    voxels *= (np.arange(P)[None, None, :] < num_points[..., None])[..., None]
    points, owner = jpfn.flatten_pillars(voxels, num_points, coords)

    kw = dict(ny=ny, nx=nx, num_class=1)
    jflat = JaxPointPillars(pfn_flat=True, max_points_per_pillar=P, **kw)
    variables = jflat.init(jax.random.PRNGKey(0), jnp.asarray(voxels),
                           jnp.asarray(num_points), jnp.asarray(coords),
                           train=False)
    want, mut = jflat.apply(variables, None, jnp.asarray(num_points),
                            jnp.asarray(coords), train=True,
                            points=jnp.asarray(points),
                            point_pillar=jnp.asarray(owner),
                            mutable=["batch_stats"])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    flat = PointPillars(max_points_per_pillar=P, **kw)
    classic = PointPillars(max_points_per_pillar=P, **kw)
    for m in (flat, classic):
        convert.load_flax_weights(m, variables)
    assert flat.state_dict().keys() == classic.state_dict().keys()
    assert set(convert.state_dict_to_flax(flat.state_dict())) == set(
        convert.flatten(variables))
    got = flat(None, T(num_points), T(coords), T(points), T(owner))
    ref = classic(T(voxels), T(num_points), T(coords))
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(w),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   ref[k].detach().numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    stats = convert.flatten(jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"]))
    mine = convert.state_dict_to_flax(flat.state_dict())
    for k, w in stats.items():
        np.testing.assert_allclose(mine["batch_stats/" + k], w, rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    grid = flat(T(voxels), T(num_points), T(coords))  # no flat points
    ref = classic(T(voxels), T(num_points), T(coords))
    for k in ref:
        np.testing.assert_allclose(grid[k].detach().numpy(),
                                   ref[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_flat_pfn_refuses_more_than_one_layer():
    m = PillarFeatureNet(4, (32, 64), VOXEL_SIZE, PC_RANGE)
    with pytest.raises(NotImplementedError, match="PFN_FLAT"):
        m(None, torch.zeros(1, 2, dtype=torch.int32),
          torch.zeros(1, 2, 3, dtype=torch.int32), torch.zeros(1, 4, 4),
          torch.zeros(1, 4, dtype=torch.int32))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_flat_rows_in_any_order(train):
    """Each frame's rows shuffled (pillars out of order, padding among the
    points) give the output, running statistics and gradients of the
    streamer's grouped order: the segment sums sort the rows, and take
    the pillars' counts as their lengths."""
    P = 16
    voxels, num_points, coords, variables = _grid(9, P=P)
    points, owner = jpfn.flatten_pillars(voxels, num_points, coords)
    assert (owner[1] < 0).any()  # the second frame ends in padding
    rs = np.random.RandomState(10)
    perm = np.stack([rs.permutation(owner.shape[1]) for _ in range(2)])
    take = np.arange(2)[:, None], perm
    cot = np.random.RandomState(11).randn(2, 256, 64).astype(np.float32)
    cot *= _clear_of_ties(voxels, num_points, coords, variables, False, train)
    want = _port_flat(variables, points, owner, num_points, coords, P, cot,
                      train=train)
    out, nr, grads = _port_flat(variables, points[take], owner[take],
                                num_points, coords, P, cot, train=train)
    back = np.empty_like(grads[3])
    back[take] = grads[3]
    _compare((out, nr, grads[:3] + [back]), want, train, owner)
