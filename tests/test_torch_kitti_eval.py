"""The port's official KITTI evaluation and anno conversion against the
JAX package, on the CPU.

Seeded ground truth and detections (several classes, every difficulty,
DontCare regions, misses and false positives) go through JAX's
``get_official_eval_result`` and ``get_coco_eval_result`` as they run
(the C++ statistics, ``cc.kitti_eval_*`` and ``cc.d3_box_overlap``) and
with ``papc_tpu.cc.available`` switched off (numpy), and through the
port's (numpy). The result strings must be equal and ``return_data``'s
APs within 1e-9. ``predictions_to_kitti_annos`` must equal JAX's exactly.
"""

import numpy as np
import pytest

from papc_tpu import cc
from papc_tpu.data.synthetic_kitti import default_calib
from papc_tpu.detect import train as jtrain
from papc_tpu.eval import kitti_eval as jeval

from papc_tpu_torch.detect import train as ptrain
from papc_tpu_torch.detect.kitti.common import empty_result_anno
from papc_tpu_torch.eval import kitti_eval
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

PATHS = ("cc", "numpy")
NAMES = np.array(["Car", "Car", "Car", "Van", "Pedestrian", "Cyclist"])


@pytest.fixture
def jax_path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(cc, "available", lambda: False)
    else:
        assert cc.available()
    return request.param


def _objects(rng, n, names):
    """Camera-frame objects: bottom-centre locations, l-h-w dims, yaw,
    and image boxes whose heights span the three difficulties."""
    loc = np.stack([rng.uniform(-12, 12, n), rng.uniform(1.4, 1.8, n),
                    rng.uniform(6, 50, n)], axis=1)
    dims = np.stack([rng.uniform(3.5, 4.3, n), rng.uniform(1.4, 1.7, n),
                     rng.uniform(1.5, 1.8, n)], axis=1)
    top = rng.uniform(120, 200, n)
    left = rng.uniform(0, 1100, n)
    height = rng.choice([20.0, 30.0, 60.0], n) + rng.uniform(0, 5, n)
    bbox = np.stack([left, top, left + 1.5 * height, top + height], axis=1)
    return {
        "name": np.asarray(names),
        "truncated": rng.choice([0.0, 0.2, 0.4], n),
        "occluded": rng.choice([0, 1, 2], n).astype(np.int64),
        "alpha": rng.uniform(-np.pi, np.pi, n),
        "bbox": bbox,
        "dimensions": dims,
        "location": loc,
        "rotation_y": rng.uniform(-np.pi, np.pi, n),
    }


def _annos(seed=0, n_frames=12):
    """``(gt_annos, dt_annos)``: each frame's objects with a trailing
    DontCare, and detections that find most objects (jittered), miss
    some and add false positives, with scores."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for f in range(n_frames):
        n = int(rng.randint(2, 7))
        gt = _objects(rng, n, rng.choice(NAMES, n))
        dc = _objects(rng, 1, ["DontCare"])
        gt = {k: np.concatenate([gt[k], dc[k]]) for k in gt}
        gt["score"] = np.zeros(n + 1)
        gts.append(gt)
        found = rng.rand(n) < 0.8
        dt = {k: v[:n][found].copy() for k, v in gt.items()}
        m = int(found.sum())
        dt["location"] += rng.normal(0, 0.25, (m, 3))
        dt["dimensions"] += rng.normal(0, 0.08, (m, 3))
        dt["rotation_y"] += rng.normal(0, 0.1, m)
        dt["alpha"] += rng.normal(0, 0.1, m)
        dt["bbox"] += rng.normal(0, 4, (m, 4))
        k = int(rng.randint(0, 3))
        fp = _objects(rng, k, rng.choice(NAMES[:4], k))
        dt = {key: np.concatenate([dt[key], fp[key]]) for key in fp}
        dt["score"] = rng.uniform(0.05, 1.0, m + k)
        dt["truncated"][:] = 0.0
        dt["occluded"][:] = 0
        dts.append(dt)
    return gts, dts


def _check_result(got, want):
    (s1, d1), (s2, d2) = got, want
    assert s1 == s2
    assert list(d1) == list(d2)
    for key in d2:
        for metric in d2[key]:
            np.testing.assert_allclose(d1[key][metric], d2[key][metric],
                                       rtol=0, atol=1e-9)


CLASSES = (["Car"], ["Car", "Pedestrian", "Cyclist", "Van"])


@pytest.mark.parametrize("classes", CLASSES, ids=["car", "four classes"])
@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_official_result_equals_jax(jax_path, classes):
    gts, dts = _annos()
    got = kitti_eval.get_official_eval_result(gts, dts, classes, True)
    want = jeval.get_official_eval_result(gts, dts, classes, True)
    _check_result(got, want)
    assert "Car AP@0.70, 0.70, 0.70:" in got[0] and "aos  AP:" in got[0]
    car = got[1][(0, "0.5")]
    assert 0 < car["bev"][1] < 100 and 0 < car["3d"][1] < 100


@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_official_result_without_orientation_equals_jax(jax_path):
    """Detections with alpha -10 skip AOS."""
    gts, dts = _annos(seed=1, n_frames=6)
    for dt in dts:
        dt["alpha"][:] = -10
    got = kitti_eval.get_official_eval_result(gts, dts, "Car", True)
    _check_result(got, jeval.get_official_eval_result(gts, dts, "Car", True))
    assert "aos" not in got[0]


@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_coco_result_equals_jax(jax_path):
    gts, dts = _annos(seed=2, n_frames=6)
    got = kitti_eval.get_coco_eval_result(gts, dts, ["Car", "Pedestrian"])
    assert got == jeval.get_coco_eval_result(gts, dts, ["Car", "Pedestrian"])
    assert "Car coco AP@0.50:0.05:0.95:" in got


@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_perfect_detections_give_100_and_none_give_0(jax_path):
    """``tests/test_detect_e2e.py``'s two limits, through both packages."""
    rng = np.random.RandomState(3)
    gts = []
    for _ in range(12):  # 48-72 cars: more than the 41 recall samples
        n = int(rng.randint(4, 7))
        gt = _objects(rng, n, ["Car"] * n)
        gt["bbox"][:, 3] = gt["bbox"][:, 1] + 60
        gt["truncated"][:] = 0.0
        gt["occluded"][:] = 0
        gt["score"] = np.zeros(n)
        gts.append(gt)
    perfect = []
    for gt in gts:
        dt = {k: np.copy(v) for k, v in gt.items()}
        dt["score"] = np.ones(len(gt["name"]))
        perfect.append(dt)
    got = kitti_eval.get_official_eval_result(gts, perfect, "Car", True)
    _check_result(got, jeval.get_official_eval_result(gts, perfect, "Car",
                                                      True))
    for metric in ("bbox", "bev", "3d"):
        assert got[1][(0, "0.7")][metric][1] > 95.0
    empty = [empty_result_anno() for _ in gts]
    got = kitti_eval.get_official_eval_result(gts, empty, "Car", True)
    _check_result(got, jeval.get_official_eval_result(gts, empty, "Car",
                                                      True))
    assert got[1][(0, "0.7")]["3d"][1] == 0.0


@pytest.mark.parametrize("metric", [0, 1, 2], ids=["bbox", "bev", "3d"])
@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_overlaps_and_class_statistics_equal_jax(jax_path, metric):
    gts, dts = _annos(seed=4, n_frames=5)
    got = kitti_eval._frame_overlaps(gts, dts, metric)
    want = jeval._frame_overlaps(gts, dts, metric)
    for g, w in zip(got, want):
        if jax_path == "numpy" or metric == 0:
            np.testing.assert_array_equal(g, w)
        else:  # JAX's C++ overlaps take float32 boxes
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    for difficulty in range(3):
        g = kitti_eval.eval_class(gts, dts, 0, difficulty, metric, 0.5,
                                  compute_aos=metric == 0)
        w = jeval.eval_class(gts, dts, 0, difficulty, metric, 0.5,
                             compute_aos=metric == 0)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12)


def test_d3_overlap_equals_jax_numpy_and_cc(monkeypatch):
    rng = np.random.RandomState(5)
    a = _objects(rng, 8, ["Car"] * 8)
    boxes = np.concatenate([a["location"], a["dimensions"],
                            a["rotation_y"][:, None]], axis=1)
    q = boxes + rng.normal(0, 0.3, boxes.shape)
    fused = {c: cc.d3_box_overlap(boxes, q, c) for c in (-1, 0, 1, 2)}
    monkeypatch.setattr(cc, "available", lambda: False)
    for criterion in (-1, 0, 1, 2):
        got = kitti_eval.d3_box_overlap(boxes, q, criterion)
        np.testing.assert_array_equal(got, jeval.d3_box_overlap(
            boxes, q, criterion))
        # JAX's fused C++ pass takes float32 boxes
        np.testing.assert_allclose(got, fused[criterion], rtol=1e-5,
                                   atol=1e-5)
    assert (kitti_eval.d3_box_overlap(boxes, q).diagonal() > 0.1).all()


def test_thresholds_and_map_equal_jax():
    rng = np.random.RandomState(6)
    scores = rng.uniform(0, 1, 57)
    assert kitti_eval.get_thresholds(scores, 50) == jeval.get_thresholds(
        scores, 50)
    prec = rng.uniform(0, 1, (3, 41))
    np.testing.assert_array_equal(kitti_eval.get_mAP(prec),
                                  jeval.get_mAP(prec))


def _detections(rng, B=3, post=16):
    """A batch of fixed-size detections (lidar frame) and its examples."""
    n = B * post
    boxes = np.stack([rng.uniform(2, 60, n), rng.uniform(-30, 30, n),
                      rng.uniform(-2, -1, n), rng.uniform(1.5, 1.8, n),
                      rng.uniform(3.5, 4.3, n), rng.uniform(1.4, 1.7, n),
                      rng.uniform(-np.pi, np.pi, n)], axis=1)
    valid = rng.rand(B, post) < 0.6
    valid[-1] = False  # a frame without detections
    dets = {"box3d_lidar": boxes.reshape(B, post, 7).astype(np.float32),
            "scores": rng.uniform(0, 1, (B, post)).astype(np.float32),
            "label_preds": rng.randint(0, 2, (B, post)).astype(np.int64),
            "valid": valid}
    P2, rect, Tr = default_calib()
    examples = {"rect": np.stack([rect.astype(np.float32)] * B),
                "Trv2c": np.stack([Tr.astype(np.float32)] * B),
                "P2": np.stack([P2.astype(np.float32)] * B),
                "image_shape": np.array([[375, 1242]] * B, np.int32),
                "image_idx": np.array([4, 9, 17], np.int64)}
    return dets, examples


@pytest.mark.parametrize("limit", [None, [0, -20, -5, 50, 20, 5]],
                         ids=["no limit", "centre limit"])
def test_predictions_to_kitti_annos_equal_jax(limit):
    dets, examples = _detections(np.random.RandomState(7))
    names = ["Car", "Van"]
    got = ptrain.predictions_to_kitti_annos(dets, examples, names, limit)
    want = jtrain.predictions_to_kitti_annos(dets, examples, names, limit)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert len(got[0]["name"]) > 0 and len(got[2]["name"]) == 0


def test_result_files_equal_jax(tmp_path):
    dets, examples = _detections(np.random.RandomState(8))
    annos = ptrain.predictions_to_kitti_annos(dets, examples, ["Car", "Van"])
    for pkg, out in ((ptrain, "port"), (jtrain, "jax")):
        (tmp_path / out).mkdir()
        pkg._write_result_files(annos, tmp_path / out)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == ["000000.txt", "000004.txt", "000009.txt"]
    for name in files:
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text())
