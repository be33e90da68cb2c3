"""The port's PointPillars serving slice against the JAX package, on the CPU.

Both packages run in one process on the same numpy inputs; weights cross
through ``papc_tpu_torch.convert``. Tolerances (f32): the voxelizer, the
BEV scatter, the anchors and every NMS keep mask exactly; the PFN within
1e-5 and the RPN and whole network within 1e-4 (sums in another order,
and XLA's fused CPU code rounds differently); decode within 1e-5
relative; IoUs within 1e-6 absolute. The rotated NMS keep masks are
exact because no pair of these inputs has an IoU within ulps of the
threshold.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.data.synthetic_kitti import make_scene as jax_make_scene
from papc_tpu.detect import builders as jbuilders
from papc_tpu.detect import detector as jdetector
from papc_tpu.detect.box_coder import GroundBox3dCoder as JaxCoder
from papc_tpu.detect.config import DEFAULT_CONFIG_PATH, cfg_from_yaml_file
from papc_tpu.detect.config import cfg_from_list as jax_cfg_from_list
from papc_tpu.detect.model import PillarFeatureNet as JaxPFN
from papc_tpu.detect.model import PointPillars as JaxPointPillars
from papc_tpu.detect.train import make_pillarizer as jax_make_pillarizer
from papc_tpu.detect.train import make_predict_step as jax_make_predict_step
from papc_tpu.ops.pallas.nms import greedy_suppress_pallas, rotate_nms_pallas
from papc_tpu.train.trainer import TrainState

from papc_tpu_torch import convert
from papc_tpu_torch.data.synthetic_kitti import (SyntheticFrames,
                                                 collate_batch, make_scene)
from papc_tpu_torch.detect import builders, detector
from papc_tpu_torch.detect.box_coder import GroundBox3dCoder
from papc_tpu_torch.detect.config import car_config, cfg_from_list
from papc_tpu_torch.detect.model import PillarFeatureNet, PointPillars
from papc_tpu_torch.detect.train import (make_detection_train_step,
                                         make_pillarizer, make_predict_step,
                                         predict_frames)
from papc_tpu_torch.ops import iou, nms, voxelize
from papc_tpu_torch.ops.kernels import nms as knms

# papc_tpu.ops re-exports functions under these modules' names
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

jiou = importlib.import_module("papc_tpu.ops.iou")
jnms = importlib.import_module("papc_tpu.ops.nms")
jvox = importlib.import_module("papc_tpu.ops.voxelize")
T = torch.from_numpy


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------- config

def _leaves(d, prefix=""):
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, key)
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            for i, item in enumerate(v):
                yield from _leaves(item, f"{key}[{i}]")
        else:
            yield key, v


def _lookup(cfg, key):
    for part in key.split("."):
        if part.endswith("]"):
            name, i = part[:-1].split("[")
            cfg = cfg[name][int(i)]
        else:
            cfg = cfg[part]
    return cfg


def test_config_equals_the_yaml_on_every_key_it_carries():
    mine, yaml_cfg = car_config(), cfg_from_yaml_file(DEFAULT_CONFIG_PATH)
    keys = list(_leaves(mine))
    assert len(keys) == 97
    for key, value in keys:
        assert _lookup(yaml_cfg, key) == value, key
    overrides = ["EVAL_INPUT_READER.MAX_NUMBER_OF_VOXELS", "64",
                 "MODEL.POST_PROCESSING.nms_iou_threshold", "0.3",
                 "MODEL.BACKBONE.num_filters", "[8, 16, 32]"]
    cfg_from_list(mine, overrides)
    jax_cfg_from_list(yaml_cfg, overrides)
    for key, value in _leaves(mine):
        assert _lookup(yaml_cfg, key) == value, key
    assert mine.EVAL_INPUT_READER.MAX_NUMBER_OF_VOXELS == 64
    with pytest.raises(KeyError, match="NOT_A_KEY"):
        cfg_from_list(mine, ["MODEL.NOT_A_KEY", "1"])
    with pytest.raises(TypeError, match="type mismatch"):
        cfg_from_list(mine, ["MODEL.NUM_CLASS", "'car'"])


def test_anchors_equal_the_jax_generator_at_the_car_feature_map():
    cfg, jcfg = car_config(), cfg_from_yaml_file(DEFAULT_CONFIG_PATH)
    gen = builders.build_anchor_generator(cfg.TARGET_ASSIGNER
                                          .ANCHOR_GENERATORS[0])
    jgen = jbuilders.build_anchor_generator(jcfg.TARGET_ASSIGNER
                                            .ANCHOR_GENERATORS[0])
    got, want = gen.generate([1, 248, 216]), jgen.generate([1, 248, 216])
    assert got.shape == (1, 248, 216, 1, 2, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    assert vg.grid_size.tolist() == [432, 496, 1]
    anchors = builders.build_anchors(cfg, vg)
    assert anchors.shape == (107136, 7)
    ta = jbuilders.build_target_assigner(
        jcfg.TARGET_ASSIGNER, jbuilders.build_box_coder(jcfg.BOX_CODER))
    np.testing.assert_array_equal(
        anchors, ta.generate_anchors([1, 248, 216])["anchors"].reshape(-1, 7))
    assert gen.num_anchors_per_localization == 2


# ----------------------------------------------------------- voxelize

VOX = dict(voxel_size=(0.5, 0.5, 4.0), point_cloud_range=(0, -4, -3, 8, 4, 1))


def _voxel_cloud(rng, B, N, dense_cell=0):
    """Points in and out of range, a masked tail, and ``dense_cell``
    extra points in one cell (a max_points overflow)."""
    pts = np.stack([rng.uniform(-1, 9, (B, N)), rng.uniform(-5, 5, (B, N)),
                    rng.uniform(-3.5, 1.5, (B, N)), rng.uniform(0, 1, (B, N))],
                   -1).astype(np.float32)
    if dense_cell:
        pts[:, :dense_cell, :3] = [2.1, 0.3, -1.0]
        pts[:, :dense_cell, :2] += rng.uniform(0, 0.3, (B, dense_cell, 2))
    mask = np.ones((B, N), bool)
    mask[:, -N // 5:] = False
    mask[0, 3] = False
    return pts, mask


@pytest.mark.parametrize("N,max_points,max_voxels,dense", [
    (300, 8, 256, 20),   # max_points overflow in the dense cell
    (600, 5, 40, 0),     # max_voxels overflow
    (64, 32, 128, 0),    # every point kept
])
def test_voxelize_equals_jax(rng, N, max_points, max_voxels, dense):
    pts, mask = _voxel_cloud(rng, 2, N, dense)
    grid = (16, 16, 1)
    want = jax.jit(jax.vmap(lambda p, m: jvox.voxelize(
        p, m, VOX["voxel_size"], VOX["point_cloud_range"], grid, max_points,
        max_voxels)))(jnp.asarray(pts), jnp.asarray(mask))
    got = voxelize.voxelize(T(pts), T(mask), VOX["voxel_size"],
                            VOX["point_cloud_range"], grid, max_points,
                            max_voxels)
    for name in got._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if dense:
        assert got.num_points.max() == max_points
    if max_voxels == 40:
        assert (got.num_voxels == max_voxels).all()


def test_bev_scatter_is_exact_with_invalid_rows(rng):
    B, V, C, ny, nx = 2, 40, 5, 6, 10
    feats = rng.randn(B, V, C).astype(np.float32)
    coords = np.full((B, V, 3), -1, np.int32)
    for b in range(B):  # unique cells, drawn without replacement
        cells = rng.choice(ny * nx, V - 7, replace=False)
        coords[b, :V - 7] = np.stack([np.zeros_like(cells), cells // nx,
                                      cells % nx], -1)
    want = np.asarray(jvox.scatter_to_bev_batched(
        jnp.asarray(feats), jnp.asarray(coords), ny, nx))
    got = voxelize.scatter_to_bev_batched(T(feats), T(coords), ny, nx)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != 0).any(-1).sum() == B * (V - 7)


# ---------------------------------------------------------------- model

def _pillars(rng, B=2, V=24, P=6):
    """Pillar tensors with 1-point and full (P-point) pillars and
    invalid rows, coordinates unique per frame."""
    vox = rng.randn(B, V, P, 4).astype(np.float32)
    num = rng.randint(1, P + 1, (B, V)).astype(np.int32)
    num[:, 0], num[:, 1] = 1, P
    num[:, -3:] = 0
    slot = np.arange(P)[None, None, :]
    vox = vox * (slot < num[..., None])[..., None]
    coords = np.full((B, V, 3), -1, np.int32)
    for b in range(B):
        cells = rng.choice(16 * 16, V - 3, replace=False)
        coords[b, :V - 3] = np.stack([np.zeros_like(cells), cells // 16,
                                      cells % 16], -1)
    return vox, num, coords


def test_pillar_feature_net_matches_flax(rng):
    vox, num, coords = _pillars(rng)
    kw = dict(num_filters=(64,), voxel_size=(0.16, 0.16, 4.0),
              pc_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0))
    jm = JaxPFN(**kw)
    args = (jnp.asarray(vox), jnp.asarray(num), jnp.asarray(coords))
    variables = _perturb_stats(jm.init(jax.random.PRNGKey(0), *args,
                                       train=False))
    want = np.asarray(jm.apply(variables, *args, train=False))
    m = PillarFeatureNet(4, **kw)
    convert.load_flax_weights(m, _np(variables))
    with torch.inference_mode():
        got = m.eval()(T(vox), T(num), T(coords)).numpy()
    assert got.shape == (2, 24, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


NET = dict(ny=16, nx=16, pfn_num_filters=(32,),
           voxel_size=(0.5, 0.5, 4.0), pc_range=(0, -4, -3, 8, 4, 1),
           rpn_layer_nums=(1, 2, 1), rpn_num_filters=(16, 24, 32),
           rpn_num_upsample_filters=(8, 16, 8))
FLAGS = dict(scatter_s2d=True, pfn_flat=True, rpn_deferred_upsample=True,
             rpn_batch_fold=True)


@pytest.fixture(scope="module")
def net_pair():
    """A reduced PointPillars in flax (with build_network's default
    rewrites on), its variables with perturbed statistics, and the
    port's model with the same weights."""
    vox, num, coords = _pillars(np.random.RandomState(3))
    jm = JaxPointPillars(**NET, **FLAGS)
    args = (jnp.asarray(vox), jnp.asarray(num), jnp.asarray(coords))
    variables = _perturb_stats(jax.jit(lambda *a: jm.init(
        jax.random.PRNGKey(0), *a, train=False))(*args), seed=2)
    model = PointPillars(**NET)
    convert.load_flax_weights(model, _np(variables))
    return variables, model.eval()


@pytest.mark.parametrize("flags", ["defaults", "off"])
def test_pointpillars_forward_matches_flax(net_pair, flags):
    """The reference-form port against the JAX model built with the four
    TPU rewrites on (build_network's default) and off; up-strides 1, 2
    and 4 exercise the ConvTranspose mapping. In training mode (a copy of
    the model) the outputs on batch statistics and the updated running
    statistics (flax's ``mutable=["batch_stats"]``, momentum 0.01) too,
    within 1e-4 of the largest of each."""
    variables, model = net_pair
    vox, num, coords = _pillars(np.random.RandomState(4))
    jm = JaxPointPillars(**NET, **({} if flags == "off" else FLAGS))
    args = (jnp.asarray(vox), jnp.asarray(num), jnp.asarray(coords))
    want = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        variables, *args)
    with torch.inference_mode():
        got = model(T(vox), T(num), T(coords))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (2, 8, 8, want[k].shape[-1])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)

    want, mutated = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"]))(variables, *args)
    trained = copy.deepcopy(model).train()
    with torch.no_grad():
        got = trained(T(vox), T(num), T(coords))
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    stats = convert.flatten({"batch_stats": _np(mutated["batch_stats"])})
    old = convert.flatten({"batch_stats": _np(variables["batch_stats"])})
    mine = convert.state_dict_to_flax(trained.state_dict())
    assert set(stats) <= set(mine) and len(stats) == 2 * 11
    for k, w in stats.items():
        assert not np.allclose(w, old[k]), k  # the statistics moved
        np.testing.assert_allclose(mine[k], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_rpn_matches_flax_on_a_bev_canvas(net_pair):
    variables, model = net_pair
    canvas = np.random.RandomState(5).randn(2, 16, 16, 32).astype(np.float32)
    from papc_tpu.detect.model import RPN as JaxRPN

    rpn_kw = dict(layer_nums=NET["rpn_layer_nums"],
                  num_filters=NET["rpn_num_filters"],
                  num_upsample_filters=NET["rpn_num_upsample_filters"])
    jrpn = JaxRPN(**rpn_kw, deferred_upsample=True, batch_fold=True)
    want = jax.jit(lambda v, x: jrpn.apply(v, x, train=False))(
        {"params": variables["params"]["rpn"],
         "batch_stats": variables["batch_stats"]["rpn"]}, jnp.asarray(canvas))
    with torch.inference_mode():
        got = model.rpn(T(canvas))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("linear_dim,vec_encode", [(False, False),
                                                   (True, False),
                                                   (False, True)])
def test_decode_matches_decode_jnp(rng, linear_dim, vec_encode):
    anchors = np.concatenate([rng.uniform(0, 50, (3, 40, 3)),
                              rng.uniform(1, 4, (3, 40, 3)),
                              rng.uniform(-3, 3, (3, 40, 1))],
                             -1).astype(np.float32)
    size = 8 if vec_encode else 7
    enc = (0.3 * rng.randn(3, 40, size)).astype(np.float32)
    want = np.asarray(JaxCoder(linear_dim, vec_encode).decode_jnp(
        jnp.asarray(enc), jnp.asarray(anchors)))
    coder = GroundBox3dCoder(linear_dim, vec_encode)
    assert coder.code_size == size
    got = coder.decode(T(enc), T(anchors)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ IoU, NMS

def _random_rboxes(rng, K):
    """Clustered rotated boxes so real suppression happens (as the JAX
    package's Pallas NMS tests draw them)."""
    centers = rng.uniform(0, 40, size=(max(K // 4, 1), 2))
    pick = centers[rng.randint(0, len(centers), K)]
    return np.stack([pick[:, 0] + rng.randn(K) * 0.8,
                     pick[:, 1] + rng.randn(K) * 0.8,
                     rng.uniform(1.5, 2.0, K), rng.uniform(3.5, 4.5, K),
                     rng.uniform(-np.pi, np.pi, K)], axis=1).astype(np.float32)


def test_iou_matches_jax(rng):
    r, q = _random_rboxes(rng, 60), _random_rboxes(rng, 45)
    np.testing.assert_allclose(
        iou.box5_to_corners(T(r)).numpy(),
        np.asarray(jiou.box5_to_corners(jnp.asarray(r))), rtol=0, atol=1e-5)
    for crit in (-1, 0, 1, 2):
        # op by op: under jit XLA fuses the clip and rounds differently,
        # and a sliver's shoelace cancels at coordinates of 40 m (1.2e-4)
        want = np.asarray(jiou.rotate_iou(jnp.asarray(r), jnp.asarray(q),
                                          crit))
        got = iou.rotate_iou(T(r), T(q), crit).numpy()
        atol = 1e-6 if crit in (-1, 0, 1) else 1e-5  # 2: raw areas ~ 6 m²
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert (want > 0).mean() > 0.01
    a = np.concatenate([r[:, :2] - 1, r[:, :2] + rng.uniform(0.1, 2, (60, 2))],
                       -1)
    np.testing.assert_allclose(
        iou.iou_2d(T(a), T(a[:20])).numpy(),
        np.asarray(jiou.iou_2d(jnp.asarray(a), jnp.asarray(a[:20]))),
        rtol=0, atol=1e-6)
    batched = iou.rotate_iou(T(np.stack([r[:30], r[30:]])),
                             T(np.stack([q[:20], q[20:40]])))
    np.testing.assert_allclose(batched[1].numpy(),
                               iou.rotate_iou(T(r[30:]), T(q[20:40])).numpy(),
                               rtol=0, atol=0)


def _random_iou(rng, K):
    m = rng.rand(K, K).astype(np.float32)
    m = np.maximum(m, m.T)
    np.fill_diagonal(m, 1.0)
    return m


@pytest.mark.parametrize("K", [7, 128, 300])
def test_greedy_suppress_equals_jax_and_pallas(rng, K):
    mats = np.stack([_random_iou(rng, K) for _ in range(2)])
    valid = np.ones((2, K), bool)
    valid[1] = rng.rand(K) > 0.3
    for thr in (0.3, 0.5, 0.9):
        got = knms.greedy_suppress(T(mats), T(valid), thr).numpy()
        for b in range(2):
            want = np.asarray(jnms.greedy_suppress(
                jnp.asarray(mats[b]), jnp.asarray(valid[b]), thr))
            pallas = np.asarray(greedy_suppress_pallas(
                jnp.asarray(mats[b]), jnp.asarray(valid[b]), thr,
                interpret=True))
            np.testing.assert_array_equal(got[b], want)
            np.testing.assert_array_equal(got[b], pallas)
        assert not got[~valid].any()


def test_suppressed_box_cannot_suppress():
    m = np.array([[1.0, 0.9, 0.0], [0.9, 1.0, 0.9], [0.0, 0.9, 1.0]],
                 np.float32)
    got = nms.greedy_suppress(T(m[None]), torch.ones(1, 3, dtype=torch.bool),
                              0.5)
    np.testing.assert_array_equal(got.numpy(), [[True, False, True]])


@pytest.mark.parametrize("K,pallas_thr", [(5, 0.5), (64, 0.1), (200, 0.5)])
def test_rotate_nms_equals_pallas_and_the_matrix_path(rng, K, pallas_thr):
    """Both thresholds against the JAX matrix path, one (a compile of
    the interpret-mode kernel each) against the fused Pallas sweep."""
    boxes = np.stack([_random_rboxes(rng, K) for _ in range(2)])
    valid = np.ones((2, K), bool)
    valid[1] = rng.rand(K) > 0.3
    matrix_path = jax.jit(lambda b, v, thr: jnms.greedy_suppress(
        jiou.rotate_iou(b, b), v, thr))
    for thr in (0.1, 0.5):
        got = nms.rotate_nms(T(boxes), T(valid), thr).numpy()
        for b in range(2):
            jb, jv = jnp.asarray(boxes[b]), jnp.asarray(valid[b])
            np.testing.assert_array_equal(got[b],
                                          np.asarray(matrix_path(jb, jv, thr)))
            if thr == pallas_thr:
                np.testing.assert_array_equal(got[b], np.asarray(
                    rotate_nms_pallas(jb, jv, thr, interpret=True)))
        if K >= 64:  # both outcomes happen
            assert 0 < got[0].sum() < K
        assert not got[~valid].any()


def test_nms_dispatch_and_limits(rng):
    boxes = np.sort(rng.uniform(0, 10, (1, 20, 4)).astype(np.float32), -1)
    boxes = boxes[..., [0, 1, 2, 3]]
    boxes[..., 2:] = boxes[..., :2] + 1.5
    want = np.asarray(jnms.nms(jnp.asarray(boxes[0]), None, 0.3))
    np.testing.assert_array_equal(nms.nms(T(boxes), None, 0.3).numpy()[0],
                                  want)
    r = T(_random_rboxes(rng, 9)[None])
    before = [k.launches for k in knms.KERNELS]
    torch.testing.assert_close(nms.rotate_nms(r, impl="plain"),
                               nms.rotate_nms(r))
    assert [k.launches for k in knms.KERNELS] == before  # CPU: plain
    with pytest.raises(ValueError, match="impl"):
        nms.rotate_nms(r, impl="pallas")
    with pytest.raises(ValueError, match=f"limit of {knms.ROTATE_MAX_K}"):
        knms.rotate_nms_cuda(torch.zeros(1, knms.ROTATE_MAX_K + 1, 5),
                             torch.ones(1, knms.ROTATE_MAX_K + 1,
                                        dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match=f"limit of {knms.GREEDY_MAX_K}"):
        knms.greedy_suppress_cuda(
            torch.zeros(1, knms.GREEDY_MAX_K + 1, 1).expand(
                1, knms.GREEDY_MAX_K + 1, knms.GREEDY_MAX_K + 1),
            torch.ones(1, knms.GREEDY_MAX_K + 1, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        knms.rotate_nms_cuda(r, torch.ones(1, 9, dtype=torch.bool), 0.5)


# -------------------------------------------------------------- predict

def _head_maps(rng, B, H, W, ties):
    box = (0.2 * rng.randn(B, H, W, 14)).astype(np.float32)
    if ties:  # a handful of distinct logits: most scores tie exactly
        cls = rng.choice([-3.0, 0.5, 1.0, 2.0], (B, H, W, 2)).astype(np.float32)
    else:
        cls = rng.randn(B, H, W, 2).astype(np.float32)
    d = rng.randn(B, H, W, 4).astype(np.float32)
    d[0, :2, :, ::2] = d[0, :2, :, 1::2]  # exact direction ties
    return {"box_preds": box, "cls_preds": cls, "dir_cls_preds": d}


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_predict_matches_jax(rng, rotate, ties):
    B, H, W = 2, 12, 10
    from papc_tpu.detect.box_np import create_anchors_3d_stride

    anchors = create_anchors_3d_stride([1, H, W], anchor_strides=(0.8, 0.8, 0),
                                       anchor_offsets=(0.4, -4, -1.78))
    anchors = np.tile(anchors.reshape(1, -1, 7), (B, 1, 1))
    preds = _head_maps(rng, B, H, W, ties)
    mask = rng.rand(B, H * W * 2) > 0.1
    cfg = dict(use_rotate_nms=rotate, nms_pre_max_size=96,
               nms_post_max_size=40, nms_iou_threshold=0.3)
    want = jax.jit(lambda p, a, m: jdetector.predict(
        p, a, JaxCoder().decode_jnp, jdetector.PredictConfig(**cfg),
        anchors_mask=m))({k: jnp.asarray(v) for k, v in preds.items()},
                         jnp.asarray(anchors), jnp.asarray(mask))
    got = detector.predict({k: T(v) for k, v in preds.items()}, T(anchors),
                           GroundBox3dCoder().decode,
                           detector.PredictConfig(**cfg),
                           anchors_mask=T(mask))
    for k in ("valid", "label_preds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    n = got["valid"].sum(-1)
    assert (n > 0).all() and (n <= 40).all()


def test_direction_flip_is_strict():
    boxes = torch.zeros(1, 3, 7)
    boxes[0, :, 6] = torch.tensor([0.0, 0.5, -0.5])
    out = detector.apply_direction_flip(boxes, torch.tensor([[1, 1, 1]]))
    np.testing.assert_allclose(out[0, :, 6].numpy(),
                               [np.pi, 0.5, -0.5 + np.pi], rtol=1e-6)


# ------------------------------------------------------- the whole slice

SLICE_OVERRIDES = [
    "VOXEL_GENERATOR.VOXEL_SIZE", "[2.16, 2.48, 4]",
    "VOXEL_GENERATOR.MAX_NUMBER_OF_POINTS_PER_VOXEL", "16",
    "EVAL_INPUT_READER.MAX_NUMBER_OF_VOXELS", "256",
    "EVAL_INPUT_READER.MAX_POINTS_PER_FRAME", "3000",
    "MODEL.BACKBONE.layer_nums", "[1, 2, 2]",
    "MODEL.BACKBONE.num_filters", "[16, 32, 64]",
    "MODEL.BACKBONE.num_upsample_filters", "[32, 32, 32]",
    "MODEL.POST_PROCESSING.nms_pre_max_size", "64",
    "MODEL.POST_PROCESSING.nms_post_max_size", "64",
    "MODEL.POST_PROCESSING.nms_iou_threshold", "0.1",
]


def _shrink_anchors(cfg):
    gen = cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS[0].anchor_generator_stride
    gen.strides = [4.32, 4.96, 0.0]
    gen.offsets = [2.16, -37.2, -1.78]


@pytest.mark.parametrize("rotate", [True, False])
def test_serving_slice_matches_jax_predict_step(rotate):
    """Raw points → detections: the port's ``make_predict_step`` with
    ``make_pillarizer`` against JAX's, on a reduced car config (32 × 32
    grid, 256 pillars of 16 points, K = 64), JAX with build_network's
    default rewrites, weights carried by ``convert``."""
    over = SLICE_OVERRIDES + ["MODEL.POST_PROCESSING.use_rotate_nms",
                              str(rotate)]
    jcfg, cfg = cfg_from_yaml_file(DEFAULT_CONFIG_PATH), car_config()
    jax_cfg_from_list(jcfg, over + ["VOXEL_GENERATOR.MAX_VOXELS", "256"])
    cfg_from_list(cfg, over)
    _shrink_anchors(jcfg)
    _shrink_anchors(cfg)

    jvg = jbuilders.build_voxel_generator(jcfg.VOXEL_GENERATOR)
    jcoder = jbuilders.build_box_coder(jcfg.BOX_CODER)
    ta = jbuilders.build_target_assigner(jcfg.TARGET_ASSIGNER, jcoder)
    jmodel = jbuilders.build_network(jcfg, jvg, ta)
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    model = builders.build_network(
        cfg, vg, builders.build_target_assigner(cfg.TARGET_ASSIGNER, coder))
    anchors = builders.build_anchors(cfg, vg)
    assert vg.grid_size.tolist() == [32, 32, 1] and anchors.shape == (512, 7)

    frames = SyntheticFrames(3, anchors, max_points=3000, seed=7, num_cars=4,
                             n_background=2400)
    batch = collate_batch([frames[0], frames[1]])
    jpillarize = jax_make_pillarizer(jvg, 256)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda b: jmodel.init(
        jax.random.PRNGKey(0), *jpillarize(b), train=False))(jbatch)
    variables = _perturb_stats(variables, seed=3)
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=jbuilders.build_optimizer(
                                  jcfg.TRAIN_CONFIG.OPTIMIZER))
    jstep = jax_make_predict_step(jmodel, jbuilders.build_predict_config(
        jcfg, ta), jcoder, pillarize=jpillarize)
    want = jstep(state, jbatch)

    convert.load_flax_weights(model, _np(variables))
    step = make_predict_step(model, builders.build_predict_config(cfg, coder),
                             coder, make_pillarizer(vg, 256), device="cpu")
    got = step(batch)
    for k in ("valid", "label_preds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    n = got["valid"].sum(-1)
    assert (n > 1).all() and (n < 64).all()  # NMS suppressed some of 64

    # predict_frames: 3 frames in batches of 2, the last padded and dropped
    dets = predict_frames(step, frames, cfg, log=lambda line: None)
    assert len(dets) == 3
    for key in got:
        np.testing.assert_array_equal(dets[1][key], got[key][1].numpy())
    assert dets[2]["box3d_lidar"].shape == (64, 7)


def test_synthetic_frames_follow_make_scene():
    a = make_scene(np.random.RandomState(1), num_cars=4, n_background=300)
    b = jax_make_scene(np.random.RandomState(1), num_cars=4, n_background=300)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    frames = SyntheticFrames(2, np.zeros((6, 7), np.float32), max_points=400,
                             num_cars=2, n_background=500)
    ex = frames[1]
    assert ex["points"].shape == (400, 4) and ex["points_mask"].all()
    small = SyntheticFrames(1, np.zeros((6, 7), np.float32), max_points=400,
                            num_cars=0, n_background=100)[0]
    assert small["points_mask"].sum() == 100
    assert not small["points"][100:].any()


def test_serving_options_not_ported_raise():
    """Every serving option of the config is ported: bf16 serving and
    training build their steps (``tests/test_torch_detect_bf16.py`` holds
    them against JAX), an unknown precision raises."""
    cfg = car_config()
    coder = builders.build_box_coder(cfg.BOX_CODER)
    pcfg = builders.build_predict_config(cfg, coder)
    model = torch.nn.Linear(1, 1)
    assert callable(make_predict_step(model, pcfg, coder, None, "cpu",
                                      precision="bf16"))
    assert all(callable(f) for f in make_detection_train_step(
        model, builders.build_loss_config(cfg, coder), None, None, None,
        "cpu", precision="bf16"))
    with pytest.raises(ValueError, match="precision"):
        make_predict_step(model, pcfg, coder, None, "cpu", precision="fp16")
    # per-class NMS is ported: a multiclass_nms config builds its step
    cfg_from_list(cfg, ["MODEL.POST_PROCESSING.multiclass_nms", "True"])
    assert callable(make_predict_step(
        model, builders.build_predict_config(cfg, coder), coder, None, "cpu"))
