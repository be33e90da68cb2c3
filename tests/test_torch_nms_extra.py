"""The port's host soft-NMS and per-class NMS (``detect/nms_extra.py``)
and its batched ``predict_multiclass`` against the JAX package, on the
CPU, on ``tests/test_nms_extra.py``'s cases and seeded random ones.

``soft_nms`` and ``multiclass_nms`` are the same numpy code in both
packages: their outputs must be equal exactly. ``standard_nms_func``
runs the port's NMS (f32 IoU) where JAX's runs its C++ library (float64
IoU): on boxes whose compared IoUs all lie clear of the threshold the
kept indices must be equal.
"""

import numpy as np
import pytest
import torch

from papc_tpu import cc
from papc_tpu.detect import box_np as jbox
from papc_tpu.detect import builders as jbuilders
from papc_tpu.detect.config import DEFAULT_CONFIG_PATH, cfg_from_yaml_file
from papc_tpu.detect.detector import PredictConfig as JaxPredictConfig
from papc_tpu.detect.detector import predict_multiclass as jax_multiclass
from papc_tpu.detect import nms_extra as jnms

from papc_tpu_torch.detect import builders, detector, nms_extra
from papc_tpu_torch.detect.config import car_config, kitti_3class_config
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")
T = torch.from_numpy
F32 = np.float32

THREE = np.array([[0, 0, 10, 10, 0.9], [1, 1, 11, 11, 0.8],
                  [50, 50, 60, 60, 0.7]], F32)


def _soft_boxes(seed, n=60):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 40, (n, 2))
    wh = rs.uniform(4, 12, (n, 2))
    return np.concatenate([xy, xy + wh, rs.uniform(0.01, 1, (n, 1))],
                          1).astype(F32)


SOFT = {
    "hard, three boxes": (THREE, dict(Nt=0.3, method=0)),
    "gaussian, three boxes": (THREE, dict(sigma=0.5, method=2,
                                          threshold=0.01)),
    "hard, random": (_soft_boxes(0), dict(Nt=0.3, method=0)),
    "linear, random": (_soft_boxes(1), dict(Nt=0.3, method=1,
                                            threshold=0.05)),
    "gaussian, random": (_soft_boxes(2), dict(sigma=0.5, method=2,
                                              threshold=0.05)),
}


@pytest.mark.parametrize("case", list(SOFT))
def test_soft_nms_equals_jax(case):
    """Hard, linear and gaussian decay: the kept boxes and their decayed
    scores equal JAX's exactly, and the caller's array is untouched."""
    boxes, kw = SOFT[case]
    before = boxes.copy()
    got, n = nms_extra.soft_nms(boxes, **kw)
    want, wn = jnms.soft_nms(boxes, **kw)
    assert n == wn and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(boxes, before)
    if case == "hard, three boxes":  # tests/test_nms_extra.py's case
        assert n == 2
        np.testing.assert_allclose(got[:, 4], [0.9, 0.7])
    if case == "gaussian, three boxes":
        assert n == 3 and got[2, 4] < 0.8  # decayed, not removed


def _rboxes(seed, n=80):
    """Rotated BEV boxes (x, y, w, l, yaw) in a 20 m square, with
    distinct scores for two classes."""
    rs = np.random.RandomState(seed)
    boxes = np.concatenate([rs.uniform(0, 20, (n, 2)),
                            rs.uniform(1, 4, (n, 2)),
                            rs.uniform(-np.pi, np.pi, (n, 1))], 1).astype(F32)
    scores = np.stack([(rs.permutation(n) + 0.5) / n for _ in range(2)],
                      1).astype(F32)
    return boxes, scores


def _seven(bev):
    """(x, y, w, l, yaw) rows as (x, y, z, w, l, h, yaw)."""
    z = np.zeros((len(bev), 1), F32)
    return np.concatenate([bev[:, :2], z - 1, bev[:, 2:4], z + 1.5,
                           bev[:, 4:]], 1)


def test_multiclass_nms_on_the_reference_cases():
    """``tests/test_nms_extra.py``'s two cases through the port: two
    classes over shared rotated boxes, and a class with no candidate."""
    boxes = np.array([[[0.0, 0, 4, 4, 0.0]], [[0.2, 0, 4, 4, 0.0]],
                      [[20.0, 20, 4, 4, 0.0]]], F32)
    scores = np.array([[0.9, 0.1], [0.8, 0.85], [0.2, 0.7]], F32)
    sel = nms_extra.multiclass_nms(nms_extra.standard_nms_func(rotated=True),
                                   boxes, scores, score_thresh=0.3,
                                   iou_threshold=0.5)
    assert len(sel) == 2
    np.testing.assert_array_equal(np.sort(sel[0]), [0])
    np.testing.assert_array_equal(np.sort(sel[1]), [1, 2])
    sel = nms_extra.multiclass_nms(
        nms_extra.standard_nms_func(rotated=True), np.zeros((3, 1, 5), F32),
        np.array([[0.9, 0.0], [0.8, 0.0], [0.1, 0.0]], F32), score_thresh=0.5)
    assert sel[1] is None


@pytest.mark.parametrize("thresh", [0.0, 0.4])
@pytest.mark.parametrize("rotated", [True, False])
def test_multiclass_nms_equals_jax(rotated, thresh):
    """Two classes over 80 shared boxes (7 columns: JAX's standup sweep
    builds hulls only from 7-column rows), with and without a score
    threshold, ``pre_max_size`` 50 and ``post_max_size`` 20: the selected
    indices of each class equal JAX's."""
    bev, scores = _rboxes(int(rotated) + int(10 * thresh))
    boxes = _seven(bev)[:, None, :]
    kw = dict(pre_max_size=50, post_max_size=20, score_thresh=thresh,
              iou_threshold=0.3)
    got = nms_extra.multiclass_nms(nms_extra.standard_nms_func(rotated),
                                   boxes, scores, **kw)
    want = jnms.multiclass_nms(jnms.standard_nms_func(rotated), boxes,
                               scores, **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert 0 < len(g) <= 20
    # every pair of the boxes (candidates or not) clear of the threshold
    # by JAX's IoU (float64 inside; rounded to f32 for the rotated one)
    if rotated:
        iou = cc.rbbox_iou(bev, bev).astype(np.float64)
    else:
        corners = jbox.center_to_corner_box2d(bev[:, :2], bev[:, 2:4],
                                              bev[:, 4])
        hull = jbox.corner_to_standup_nd(corners).astype(np.float64)
        iou = jbox._iou_2d_np(hull, hull)
    off = ~np.eye(len(bev), dtype=bool)
    assert np.abs(iou[off] - 0.3).min() > 1e-5


def test_port_predict_multiclass_on_the_reference_case():
    """``tests/test_nms_extra.py``'s two-class end-to-end case through
    the port's batched ``predict_multiclass``, and equal to JAX's: the
    selections in class order, the labels, the direction flip and the
    zero padding."""
    kw = dict(num_class=2, multiclass_nms=True, use_rotate_nms=True,
              use_direction_classifier=True, nms_post_max_size=4,
              nms_score_threshold=0.3, nms_iou_threshold=0.5)
    boxes = np.array([[[0.0, 0.0, -1, 4, 4, 2, 0.5],
                       [0.2, 0.0, -1, 4, 4, 2, -0.5],
                       [20.0, 20.0, -1, 4, 4, 2, 0.5]]], F32)
    scores = np.array([[[0.9, 0.1], [0.8, 0.85], [0.2, 0.7]]], F32)
    dirs = np.array([[0, 1, 1]], np.int64)
    out = detector.predict_multiclass(T(boxes), T(scores), T(dirs),
                                      detector.PredictConfig(**kw))
    want = jax_multiclass(boxes, scores, dirs, JaxPredictConfig(**kw))
    v = out["valid"][0].numpy()
    assert v.sum() == 3 and not v[3:].any()
    np.testing.assert_array_equal(out["label_preds"][0].numpy()[v], [0, 1, 1])
    np.testing.assert_allclose(out["scores"][0].numpy()[v], [0.9, 0.85, 0.7],
                               rtol=1e-6)
    np.testing.assert_allclose(out["box3d_lidar"][0].numpy()[v][:, -1],
                               [0.5 + np.pi, -0.5 + np.pi, 0.5], rtol=1e-6)
    for k in ("valid", "label_preds"):
        np.testing.assert_array_equal(out[k].numpy(), want[k])
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(out[k].numpy(), want[k], rtol=1e-6)
    assert not out["box3d_lidar"][0, 3:].any()


def test_multiclass_nms_config_keys():
    """``build_predict_config`` reads ``multiclass_nms`` and its other
    spelling ``use_multi_class_nms``, as JAX's does; the car config has
    it off, the 3-class config on."""
    cfg = car_config()
    coder = builders.build_box_coder(cfg.BOX_CODER)
    jcfg = cfg_from_yaml_file(DEFAULT_CONFIG_PATH)
    jta = jbuilders.build_target_assigner(
        jcfg.TARGET_ASSIGNER, jbuilders.build_box_coder(jcfg.BOX_CODER))
    assert not builders.build_predict_config(cfg, coder).multiclass_nms
    assert builders.build_predict_config(
        kitti_3class_config(), coder).multiclass_nms
    for c in (cfg, jcfg):
        c.MODEL.POST_PROCESSING.multiclass_nms = True
    assert builders.build_predict_config(cfg, coder).multiclass_nms
    assert jbuilders.build_predict_config(jcfg, jta).multiclass_nms
    for c in (cfg, jcfg):
        del c.MODEL.POST_PROCESSING["multiclass_nms"]
        c.MODEL.POST_PROCESSING.use_multi_class_nms = True
    assert builders.build_predict_config(cfg, coder).multiclass_nms
    assert jbuilders.build_predict_config(jcfg, jta).multiclass_nms
