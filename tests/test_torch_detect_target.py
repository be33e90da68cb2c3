"""The port's host-side detection targets against the JAX package, on the CPU.

Box math, the box coders' ``encode``, the three similarity calculators
and ``TargetAssigner`` run in numpy in both packages on the same inputs.
The JAX assigner takes its C++ overlap pass (``cc.iou2d_assign``) when
its library loads and it is given the anchors' standup boxes, the C++ IoU
matrix (``cc.iou2d``) without them, and numpy with the library switched
off; the port has only numpy. Labels, box targets and weights must equal
JAX's bit for bit on every path, ties, forced low-IoU matches, an empty
ground truth and the positive-fraction draws included. The numpy box
math equals JAX's numpy forms bit for bit; against JAX's C++ forms (float64
inside, rounded once) the IoUs are within 1e-6.

The tiny detection config (``tiny_configs``) is the grid of
``tests/test_detect_e2e.py``: 64 × 64 cells, 800 pillars of 40 points,
a 32 × 32 feature map and 2 048 anchors; ``tests/test_torch_detect_train.py``
shares it.
"""

import numpy as np
import pytest

from papc_tpu import cc
from papc_tpu.detect import box_np as jbox
from papc_tpu.detect import builders as jbuilders
from papc_tpu.detect import target as jtarget
from papc_tpu.detect.box_coder import BevBoxCoder as JaxBevCoder
from papc_tpu.detect.box_coder import GroundBox3dCoder as JaxCoder
from papc_tpu.detect.config import DEFAULT_CONFIG_PATH, cfg_from_yaml_file
from papc_tpu.detect.config import cfg_from_list as jax_cfg_from_list

from papc_tpu_torch.data.synthetic_kitti import SyntheticFrames, make_scene
from papc_tpu_torch.detect import box_np, builders, similarity, target
from papc_tpu_torch.detect.box_coder import BevBoxCoder, GroundBox3dCoder
from papc_tpu_torch.detect.config import car_config, cfg_from_list

TINY = ["VOXEL_GENERATOR.VOXEL_SIZE", "[1.08, 1.24, 4]",
        "VOXEL_GENERATOR.MAX_NUMBER_OF_POINTS_PER_VOXEL", "40",
        "MODEL.BACKBONE.num_filters", "[16, 32, 64]",
        "MODEL.BACKBONE.num_upsample_filters", "[32, 32, 32]"]
TINY_VOXELS = 800


def _shrink_anchors(cfg):
    gen = cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS[0].anchor_generator_stride
    gen.strides = [2.16, 2.48, 0.0]
    gen.offsets = [1.08, -38.44, -1.78]


def tiny_configs():
    """``(jax_cfg, port_cfg)``: the car config on the 64 × 64 grid with
    800 pillars of 40 points, RPN widths 16-32-64 (upsampled to 32 each)
    and 2 048 anchors on the 32 × 32 feature map."""
    jcfg, cfg = cfg_from_yaml_file(DEFAULT_CONFIG_PATH), car_config()
    jax_cfg_from_list(jcfg, TINY + ["VOXEL_GENERATOR.MAX_VOXELS",
                                    str(TINY_VOXELS)])
    cfg_from_list(cfg, TINY)
    _shrink_anchors(jcfg)
    _shrink_anchors(cfg)
    return jcfg, cfg


def tiny_anchors(cfg):
    """The port's target assigner of ``cfg`` and its ``generate_anchors``
    output, anchors flattened to ``[A, 7]``."""
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    ta = builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, builders.build_box_coder(cfg.BOX_CODER))
    out = ta.generate_anchors([1, int(vg.grid_size[1]) // 2,
                               int(vg.grid_size[0]) // 2])
    out["anchors"] = out["anchors"].reshape(-1, 7)
    return ta, out


# ------------------------------------------------------------ box math

def _rboxes(rng, n):
    return np.concatenate([rng.uniform(-20, 20, (n, 2)),
                           rng.uniform(0.5, 4.5, (n, 2)),
                           rng.uniform(-4, 4, (n, 1))], 1).astype(np.float32)


def _boxes7(rng, n):
    return np.concatenate([rng.uniform(0, 60, (n, 1)),
                           rng.uniform(-30, 30, (n, 1)),
                           rng.uniform(-2, 0, (n, 1)),
                           rng.uniform(1.2, 2.0, (n, 1)),
                           rng.uniform(3.0, 4.5, (n, 1)),
                           rng.uniform(1.3, 1.8, (n, 1)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def _box_math_cases(rng):
    r5, q5 = _rboxes(rng, 40), _rboxes(rng, 30)
    r5[5] = q5[3]  # one pair coincides
    dims2 = rng.uniform(0.5, 3, (12, 2)).astype(np.float32)
    dims3 = rng.uniform(0.5, 3, (12, 3)).astype(np.float32)
    angles = rng.uniform(-4, 4, 12).astype(np.float32)
    centers = rng.uniform(-5, 5, (12, 2)).astype(np.float32)
    pts = rng.randn(12, 4, 2).astype(np.float32)
    std_a = np.concatenate([r5[:, :2] - 1, r5[:, :2] + rng.uniform(
        0.1, 2, (40, 2))], -1).astype(np.float32)
    std_b = np.concatenate([q5[:, :2] - 1, q5[:, :2] + rng.uniform(
        0.1, 2, (30, 2))], -1).astype(np.float32)
    c1 = jbox.center_to_corner_box2d(r5[:, :2], r5[:, 2:4], r5[:, 4])
    c2 = jbox.center_to_corner_box2d(q5[:30, :2], q5[:30, 2:4], q5[:30, 4])
    return {
        "corners_nd": lambda m: m.corners_nd(dims2),
        "corners_nd_3d": lambda m: m.corners_nd(dims3, (0.5, 0.5, 0.0)),
        "rotation_2d": lambda m: m.rotation_2d(pts, angles),
        "center_to_corner_box2d": lambda m: m.center_to_corner_box2d(
            centers, dims2, angles),
        "corner_to_standup_nd": lambda m: m.corner_to_standup_nd(pts),
        "center_to_minmax_2d": lambda m: m.center_to_minmax_2d(centers,
                                                               dims2),
        "center_to_minmax_2d_origin": lambda m: m.center_to_minmax_2d(
            centers, dims2, origin=0.0),
        "limit_period": lambda m: m.limit_period(angles * 3),
        "rbbox2d_to_near_bbox": lambda m: m.rbbox2d_to_near_bbox(r5),
        "iou_2d": lambda m: (m._iou_2d_np if m is jbox else m.iou_2d)(
            std_a, std_b),
        "batched_intersection_area": lambda m: m.batched_intersection_area(
            c1[:30], c2),
        "rotate_iou_cpu": lambda m: np.stack([
            (m._rotate_iou_cpu_np if m is jbox else m.rotate_iou_cpu)(
                r5, q5, criterion=c) for c in (-1, 0, 1, 2)]),
    }


@pytest.mark.parametrize("name", list(_box_math_cases(
    np.random.RandomState(0))))
def test_box_math_equals_jax_numpy(name):
    """Each host function against JAX's numpy form, bit for bit."""
    case = _box_math_cases(np.random.RandomState(0))[name]
    got, want = case(box_np), case(jbox)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ious_against_jax_cc():
    """The numpy IoUs against JAX's C++ paths (float64 inside, rounded
    once to f32): within 1e-6, and the same pairs overlap."""
    assert cc.available()
    rng = np.random.RandomState(1)
    r5, q5 = _rboxes(rng, 60), _rboxes(rng, 50)
    got = box_np.rotate_iou_cpu(r5, q5)
    want = jbox.rotate_iou_cpu(r5, q5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ((got > 0) == (want > 0)).all() and (want > 0).sum() > 20
    a, b = box_np.rbbox2d_to_near_bbox(r5), box_np.rbbox2d_to_near_bbox(q5)
    np.testing.assert_allclose(box_np.iou_2d(a, b), jbox.iou_2d(a, b),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("linear_dim,vec_encode", [(False, False),
                                                   (True, False),
                                                   (False, True)])
def test_encode_equals_jax(linear_dim, vec_encode):
    """Both coders' ``encode`` bit for bit."""
    rng = np.random.RandomState(2)
    boxes, anchors = _boxes7(rng, 50), _boxes7(rng, 50)
    for port, jax_ in ((GroundBox3dCoder(linear_dim, vec_encode),
                        JaxCoder(linear_dim, vec_encode)),
                       (BevBoxCoder(linear_dim, vec_encode),
                        JaxBevCoder(linear_dim, vec_encode))):
        got = port.encode(boxes, anchors)
        np.testing.assert_array_equal(got, jax_.encode(boxes, anchors))
        assert got.shape == (50, port.code_size)


@pytest.mark.parametrize("kind", ["rotate_iou_similarity",
                                  "nearest_iou_similarity",
                                  "distance_similarity"])
def test_similarity_calculators_equal_jax(kind):
    """Each calculator over clustered BEV boxes, against JAX's with its
    C++ library switched off (its numpy forms): bit for bit; the nearest
    IoU also with the standup boxes given."""
    rng = np.random.RandomState(3)
    a5 = _rboxes(rng, 50)
    g5 = a5[rng.choice(50, 12)] + rng.uniform(-0.5, 0.5, (12, 5)).astype(
        np.float32)
    port = builders.build_similarity_calculator(kind)
    want_fn = jbuilders.build_similarity_calculator(kind)
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(cc, "available", lambda: False)
        want = want_fn.compare(a5, g5)
    got = port.compare(a5, g5)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() >= 12
    if kind == "nearest_iou_similarity":
        bv = box_np.rbbox2d_to_near_bbox(a5)
        np.testing.assert_array_equal(port.compare(a5, g5, boxes1_bv=bv),
                                      got)
    with pytest.raises(ValueError):
        builders.build_similarity_calculator("no_such_similarity")
    assert isinstance(builders.build_similarity_calculator(
        "distance_similarity"), similarity.DistanceSimilarity)


# ------------------------------------------------------------ assigner

def _gt_cases(anchors):
    """(name, gt_boxes [G, 7]) on the tiny grid: a scene of cars, one
    tiny box (its best IoU far below the unmatched threshold: a forced
    match), two identical boxes (ties between ground truths), a box of
    an anchor's exact size on its centre, one beyond every anchor (best
    overlap 0: matches nothing), and no box."""
    rng = np.random.RandomState(5)
    _, cars = make_scene(rng, num_cars=5, n_background=10)
    tiny = np.array([[20.3, 3.1, -1.7, 0.2, 0.3, 1.5, 0.4]], np.float32)
    twins = np.concatenate([cars[:1], cars[:1], cars[1:3]])
    on_anchor = anchors[[700]].copy()
    far = np.array([[200.0, 0.0, -1.7, 1.6, 3.9, 1.5, 0.0]], np.float32)
    return [("scene", cars), ("forced low IoU", np.concatenate([tiny,
                                                                cars[:2]])),
            ("tied ground truths", twins),
            ("on an anchor", np.concatenate([on_anchor, cars[2:4]])),
            ("beyond every anchor", np.concatenate([far, cars[:1]])),
            ("empty", np.zeros((0, 7), np.float32))]


TARGET_KEYS = ("labels", "bbox_targets", "bbox_outside_weights",
               "positive_gt_id", "assigned_anchors_inds")


def _assign_both(jcfg, cfg, gt, anchors, thresholds, bv, path, mask=None,
                 positive_fraction=None, seed=0):
    ta = builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, builders.build_box_coder(cfg.BOX_CODER))
    jta = jbuilders.build_target_assigner(
        jcfg.TARGET_ASSIGNER, jbuilders.build_box_coder(jcfg.BOX_CODER))
    if positive_fraction is not None:
        for t in (ta, jta):
            t._positive_fraction, t._sample_size = positive_fraction, 24
    kw = dict(anchors_mask=mask, matched_thresholds=thresholds[0],
              unmatched_thresholds=thresholds[1])
    got = ta.assign(anchors, gt, rng=np.random.RandomState(seed),
                    anchors_bv=bv, **kw)
    with pytest.MonkeyPatch().context() as m:
        if path == "numpy":
            m.setattr(cc, "available", lambda: False)
        want = jta.assign(anchors, gt, rng=np.random.RandomState(seed),
                          anchors_bv=None if path == "cc iou2d" else bv,
                          **kw)
    return got, want


@pytest.mark.parametrize("path", ["cc iou2d_assign", "cc iou2d", "numpy"])
def test_assigner_equals_jax_on_every_path(path):
    """Labels, targets and weights bit for bit against each of JAX's
    overlap paths, for every ground-truth case, with and without an
    anchors mask; the forced match is positive though its IoU is below
    the unmatched threshold, a box beyond every anchor matches nothing,
    and no box gives all background."""
    assert cc.available()
    jcfg, cfg = tiny_configs()
    _, gen = tiny_anchors(cfg)
    anchors = gen["anchors"]
    assert anchors.shape == (2048, 7)
    bv = box_np.rbbox2d_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]])
    thr = (gen["matched_thresholds"], gen["unmatched_thresholds"])
    mask = np.random.RandomState(6).rand(2048) > 0.2
    for name, gt in _gt_cases(anchors):
        for m in (None, mask):
            got, want = _assign_both(jcfg, cfg, gt, anchors, thr, bv, path,
                                     mask=m)
            for key in TARGET_KEYS:
                assert got[key].dtype == want[key].dtype, (name, key)
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{name}: {key}")
            labels = got["labels"]
            if name == "empty":
                assert (labels == (0 if m is None else
                                   np.where(m, 0, -1))).all()
            if name == "forced low IoU" and m is None:
                overlap = box_np.iou_2d(
                    bv, box_np.rbbox2d_to_near_bbox(gt[:1, [0, 1, 3, 4, 6]]))
                best = overlap[:, 0].argmax()
                assert overlap[best, 0] < 0.45 and labels[best] == 1
                assert 0 in got["positive_gt_id"]
            if name == "beyond every anchor":
                assert 0 not in got["positive_gt_id"]
            if name == "tied ground truths":
                assert 1 not in got["positive_gt_id"]  # argmax: the first
            if name == "on an anchor" and m is None:
                assert labels[700] == 1
                assert not got["bbox_targets"][700].any()


@pytest.mark.parametrize("path", ["cc iou2d_assign", "numpy"])
def test_assigner_positive_fraction_draws_equal_jax(path):
    """``positive_fraction`` 0.125 of 24 samples (3 of the scene's 5
    positives kept): the same positives
    disabled and background enabled from one seeded ``RandomState`` on
    both sides, over three seeds."""
    jcfg, cfg = tiny_configs()
    _, gen = tiny_anchors(cfg)
    anchors = gen["anchors"]
    bv = box_np.rbbox2d_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]])
    thr = (gen["matched_thresholds"], gen["unmatched_thresholds"])
    gt = _gt_cases(anchors)[0][1]
    for seed in range(3):
        got, want = _assign_both(jcfg, cfg, gt, anchors, thr, bv, path,
                                 positive_fraction=0.125, seed=seed)
        for key in TARGET_KEYS:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert (got["labels"] > 0).sum() == 3
        assert 0 < (got["labels"] == 0).sum() <= 21


def test_generate_anchors_and_unmap_equal_jax():
    jcfg, cfg = tiny_configs()
    ta, got = tiny_anchors(cfg)
    jta = jbuilders.build_target_assigner(
        jcfg.TARGET_ASSIGNER, jbuilders.build_box_coder(jcfg.BOX_CODER))
    want = jta.generate_anchors([1, 32, 32])
    np.testing.assert_array_equal(got["anchors"],
                                  want["anchors"].reshape(-1, 7))
    for key in ("matched_thresholds", "unmatched_thresholds"):
        np.testing.assert_array_equal(got[key], want[key])
    assert ta.num_anchors_per_location == jta.num_anchors_per_location == 2
    data = np.arange(12, dtype=np.float32).reshape(4, 3)
    inds = np.array([1, 4, 5, 8])
    for fill in (0, -1):
        np.testing.assert_array_equal(target.unmap(data, 10, inds, fill),
                                      jtarget.unmap(data, 10, inds, fill))


def test_synthetic_frames_carry_jax_targets():
    """``SyntheticFrames`` with the port's assigner: each frame's labels,
    targets and weights equal JAX's assigner on the frame's cars."""
    jcfg, cfg = tiny_configs()
    ta, gen = tiny_anchors(cfg)
    frames = SyntheticFrames(3, gen["anchors"], max_points=3000, seed=7,
                             num_cars=4, n_background=2400,
                             target_assigner=ta,
                             matched_thresholds=gen["matched_thresholds"],
                             unmatched_thresholds=gen["unmatched_thresholds"])
    jta = jbuilders.build_target_assigner(
        jcfg.TARGET_ASSIGNER, jbuilders.build_box_coder(jcfg.BOX_CODER))
    assert len(frames.target_seconds) == 3
    for i in range(3):
        ex = frames[i]
        want = jta.assign(gen["anchors"], frames.gt_boxes[i],
                          matched_thresholds=gen["matched_thresholds"],
                          unmatched_thresholds=gen["unmatched_thresholds"],
                          rng=np.random.RandomState(0))
        np.testing.assert_array_equal(ex["labels"], want["labels"])
        np.testing.assert_array_equal(ex["reg_targets"],
                                      want["bbox_targets"])
        np.testing.assert_array_equal(ex["reg_weights"],
                                      want["bbox_outside_weights"])
        assert (ex["labels"] > 0).sum() >= 4
        assert ex["points"].shape == (3000, 4)
