"""The port's KITTI pipeline against the JAX package, on the CPU.

One miniature KITTI tree a package (``write_kitti``, then the three
``create_data`` steps), both from the same seed. The trees' files must be
equal byte for byte but the PNGs (the port writes its own, which PIL must
read), the info and database ``.pkl`` files array by array, and each
package must read the other's. The port's box math, augmentation, the
database sampler and ``KittiDataset`` examples must equal JAX's bit for
bit, twice: against JAX as it runs (its C++ passes ``cc.box_collision_test``,
``cc.noise_select``, ``cc.points_in_polygon3d``, ``cc.anchors_area`` and
``cc.iou2d_assign``) and with ``papc_tpu.cc.available`` switched off in
the test (its numpy paths), which is what the port carries. The grid is
``tests/test_detect_e2e.py``'s (64 × 64 cells, 2 048 anchors).
"""

import inspect
import os
import pathlib
import pickle

import numpy as np
import pytest

from papc_tpu import cc
from papc_tpu.data.synthetic_kitti import write_kitti as jwrite_kitti
from papc_tpu.detect import box_np as jbox
from papc_tpu.detect import builders as jbuilders
from papc_tpu.detect.config import DEFAULT_CONFIG_PATH, cfg_from_yaml_file
from papc_tpu.detect.config import cfg_from_list as jcfg_from_list
from papc_tpu.detect.kitti import augment as jaug
from papc_tpu.detect.kitti import create_data as jcreate
from papc_tpu.detect.kitti import preprocess as jprep
from papc_tpu.detect.kitti import sampling as jsampling

import tests.test_kitti_common as golden
from papc_tpu_torch.data.synthetic_kitti import write_kitti
from papc_tpu_torch.detect import box_np, builders
from papc_tpu_torch.detect.config import car_config, cfg_from_list
from papc_tpu_torch.detect.kitti import augment, common, create_data
from papc_tpu_torch.detect.kitti import preprocess, sampling
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

PATHS = ("cc", "numpy")  # JAX as it runs, JAX with its C++ switched off
TREE = dict(n_train=4, n_val=2, num_cars=3)
GRID = ["VOXEL_GENERATOR.VOXEL_SIZE", "[1.08, 1.24, 4]",
        "VOXEL_GENERATOR.MAX_VOXELS", "800",
        "VOXEL_GENERATOR.MAX_NUMBER_OF_POINTS_PER_VOXEL", "40",
        "TRAIN_INPUT_READER.MAX_NUMBER_OF_VOXELS", "800",
        "EVAL_INPUT_READER.MAX_NUMBER_OF_VOXELS", "800"]


def shrink_anchors(cfg):
    """The anchor strides and offsets of the 64 × 64 grid."""
    gen = cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS[0].anchor_generator_stride
    gen.strides = [2.16, 2.48, 0.0]
    gen.offsets = [1.08, -38.44, -1.78]


@pytest.fixture
def jax_path(request, monkeypatch):
    """Run JAX on its C++ passes, or with ``cc.available`` off."""
    if request.param == "numpy":
        monkeypatch.setattr(cc, "available", lambda: False)
    else:
        assert cc.available()
    return request.param


def _prepare(create, root):
    """The three data steps, and a second database of the val frames'
    objects (``kitti_dbinfos_val.pkl``), which no training frame holds."""
    create.create_kitti_info_file(root, imageset_dir=f"{root}/ImageSets")
    create.create_reduced_point_cloud(root)
    create.create_groundtruth_database(root)
    create.create_groundtruth_database(
        root, info_path=f"{root}/kitti_infos_val.pkl",
        database_save_path=f"{root}/gt_database_val",
        db_info_save_path=f"{root}/kitti_dbinfos_val.pkl")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """``{"jax", "jax_numpy", "port"}`` → a tree's root: JAX's writer and
    data prep (on its C++ passes, and on its numpy paths), the port's."""
    base = tmp_path_factory.mktemp("kitti_trees")
    roots = {k: str(base / k) for k in ("jax", "jax_numpy", "port")}
    jwrite_kitti(roots["jax"], **TREE)
    _prepare(jcreate, roots["jax"])
    jwrite_kitti(roots["jax_numpy"], **TREE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cc, "available", lambda: False)
        _prepare(jcreate, roots["jax_numpy"])
    write_kitti(roots["port"], **TREE)
    _prepare(create_data, roots["port"])
    return roots


def _files(root):
    root = pathlib.Path(root)
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _equal(a, b):
    """Structural equality of what the ``.pkl`` files hold."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    return type(a) is type(b) and a == b


class _NumpyOnly(pickle.Unpickler):
    """Refuses anything but builtins and numpy in a pickle."""

    def find_class(self, module, name):
        if module.split(".")[0] not in ("builtins", "numpy", "copyreg"):
            raise pickle.UnpicklingError(f"{module}.{name}")
        return super().find_class(module, name)


def _load(path):
    with open(path, "rb") as f:
        return _NumpyOnly(f).load()


# ------------------------------------------------------------- the tree

@pytest.mark.parametrize("jax_tree", ["jax", "jax_numpy"])
def test_tree_equals_jax_byte_for_byte_but_the_pngs(trees, jax_tree):
    want, got = trees[jax_tree], trees["port"]
    files = _files(want)
    assert files == _files(got)
    assert len([f for f in files if f.endswith(".bin")]) == 6 + 6 + 12 + 6
    for rel in files:
        a = pathlib.Path(want, rel).read_bytes()
        b = pathlib.Path(got, rel).read_bytes()
        if rel.endswith(".pkl"):
            assert _equal(_load(pathlib.Path(want, rel)),
                          _load(pathlib.Path(got, rel))), rel
        elif not rel.endswith(".png"):
            assert a == b, rel


def test_pngs_read_as_the_kitti_image_in_pil_and_in_the_port(trees):
    from PIL import Image

    for root in (trees["jax"], trees["port"]):
        for png in sorted(pathlib.Path(root).rglob("*.png")):
            with Image.open(png) as im:
                im.load()
                assert common.png_size(png) == im.size == (1242, 375)
                assert im.mode == "RGB"
                if root == trees["port"]:
                    assert not np.asarray(im).any()


def test_png_reader_refuses_another_file(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError, match="not a PNG"):
        common.png_size(p)


@pytest.mark.parametrize("reader", ["port reads jax", "jax reads port"])
def test_info_files_read_in_the_other_package(trees, reader):
    from papc_tpu.detect.kitti import common as jcommon

    root = trees["jax"] if reader == "port reads jax" else trees["port"]
    infos = _load(pathlib.Path(root, "kitti_infos_train.pkl"))
    assert len(infos) == 4 and {"annos", "calib/P2", "img_shape"} <= set(
        infos[0])
    mod = common if reader == "port reads jax" else jcommon
    for info in infos:
        rb = mod.anno_to_rbboxes(info["annos"])
        assert rb.shape == (3, 7)
    dbinfos = _load(pathlib.Path(root, "kitti_dbinfos_train.pkl"))
    assert len(dbinfos["Car"]) == 12
    for d in dbinfos["Car"]:
        pts = np.fromfile(pathlib.Path(root, d["path"]), np.float32)
        assert pts.size == 4 * d["num_points_in_gt"]


def test_create_data_cli(tmp_path):
    root = str(tmp_path / "cli")
    write_kitti(root, n_train=2, n_val=1, num_cars=2)
    create_data.main(["create_kitti_info_file", "--data_path", root,
                      "--imageset_dir", f"{root}/ImageSets"])
    create_data.main(["create_reduced_point_cloud", "--data_path", root])
    create_data.main(["create_groundtruth_database", "--data_path", root])
    assert {"kitti_infos_train.pkl", "kitti_infos_val.pkl",
            "kitti_infos_trainval.pkl", "kitti_infos_test.pkl",
            "kitti_dbinfos_train.pkl"} <= set(os.listdir(root))
    assert len(os.listdir(f"{root}/gt_database")) == 2 * 2
    assert len(os.listdir(f"{root}/training/velodyne_reduced")) == 3


GOLDEN = sorted(n for n in dir(golden) if n.startswith("test_"))


@pytest.mark.parametrize("case", GOLDEN)
def test_common_passes_the_jax_golden_cases(case, tmp_path, monkeypatch):
    """``tests/test_kitti_common.py``'s cases, run on the port's module."""
    monkeypatch.setattr(golden, "common", common)
    fn = getattr(golden, case)
    kwargs = {}
    params = inspect.signature(fn).parameters
    if "tmp_path" in params:
        kwargs["tmp_path"] = tmp_path
    if "label_path" in params:
        path = tmp_path / "000007.txt"
        path.write_text(golden.LABEL)
        kwargs["label_path"] = str(path)
    fn(**kwargs)


# ------------------------------------------------------------ box math

def _scene_boxes(rng, n=24):
    """Lidar boxes ``[n, 7]`` (float64), many of them overlapping."""
    xy = rng.uniform(0, 20, (n, 2))
    z = rng.uniform(-2, -1, (n, 1))
    wlh = rng.uniform([1.4, 3.0, 1.3], [2.0, 5.0, 1.8], (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([xy, z, wlh, yaw], axis=1)


def test_box_math_equals_jax():
    rng = np.random.RandomState(0)
    boxes = _scene_boxes(rng)
    pts = rng.uniform([-2, -2, -3], [22, 22, 1], (3000, 3)).astype(np.float32)
    for origin, axis in (((0.5, 0.5, 0.0), 2), ((0.5, 1.0, 0.5), 1)):
        np.testing.assert_array_equal(
            box_np.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6],
                                          boxes[:, 6], origin, axis),
            jbox.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6],
                                        boxes[:, 6], origin, axis))
    for lidar in (True, False):
        got = box_np.points_in_rbbox(pts, boxes, lidar)
        np.testing.assert_array_equal(got, jbox.points_in_rbbox(
            pts, boxes, lidar))
        assert got.any()
    rect = np.eye(4)
    rect[:3, :3] = [[1, 0.01, 0], [-0.01, 1, 0], [0, 0, 1]]
    from papc_tpu.data.synthetic_kitti import default_calib

    P2, _, Tr = default_calib()
    cam = box_np.box_lidar_to_camera(boxes, rect, Tr)
    np.testing.assert_array_equal(cam, jbox.box_lidar_to_camera(boxes, rect,
                                                               Tr))
    np.testing.assert_array_equal(box_np.box_camera_to_lidar(cam, rect, Tr),
                                  jbox.box_camera_to_lidar(cam, rect, Tr))
    np.testing.assert_array_equal(box_np.box3d_to_bbox(cam, rect, Tr, P2),
                                  jbox.box3d_to_bbox(cam, rect, Tr, P2))
    cloud = np.concatenate([pts * [3, 1, 1], pts[:, :1]], axis=1)
    got = box_np.remove_outside_points(cloud, rect, Tr, P2, (375, 1242))
    np.testing.assert_array_equal(got, jbox.remove_outside_points(
        cloud, rect, Tr, P2, (375, 1242)))
    assert 0 < len(got) < len(cloud)
    C, R, T = box_np.projection_matrix_to_CRT_kitti(P2)
    for a, b in zip((C, R, T), jbox.projection_matrix_to_CRT_kitti(P2)):
        np.testing.assert_array_equal(a, b)
    bb = np.array([[10.0, 20, 300, 200], [0, 0, 1242, 375]])
    np.testing.assert_array_equal(box_np.get_frustum_batch(bb, C),
                                  jbox.get_frustum_batch(bb, C))
    np.testing.assert_array_equal(box_np.get_frustum(bb[0], C),
                                  jbox.get_frustum(bb[0], C))


def test_anchors_mask_equals_jax_cc_and_numpy():
    rng = np.random.RandomState(1)
    grid = np.array([64, 64, 1])
    vsize = np.array([1.08, 1.24, 4.0], np.float32)
    offset = np.array([0, -39.68, -3], np.float32)
    anchors = box_np.create_anchors_3d_stride(
        [1, 32, 32], anchor_strides=(2.16, 2.48, 0), anchor_offsets=(
            1.08, -38.44, -1.78)).reshape(-1, 7)
    bv = box_np.rbbox2d_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]])
    coords = np.unique(rng.randint(0, 64, (500, 3)) * [0, 1, 1],
                       axis=0).astype(np.int32)
    idx = box_np.precompute_anchor_area_indices(bv, vsize, offset, grid)
    np.testing.assert_array_equal(idx, jbox.precompute_anchor_area_indices(
        bv, vsize, offset, grid))
    dense = box_np.sparse_sum_for_anchors_mask(coords, (64, 64))
    np.testing.assert_array_equal(dense, jbox.sparse_sum_for_anchors_mask(
        coords, (64, 64)))
    dense = dense.cumsum(0).cumsum(1)
    got = box_np.fused_get_anchors_area(dense, bv, vsize, offset, grid,
                                        indices=idx)
    np.testing.assert_array_equal(got, jbox.fused_get_anchors_area(
        dense, bv, vsize, offset, grid))
    np.testing.assert_array_equal(got, cc.anchors_area(coords, 64, 64, idx))
    assert (got > 1).any() and (got <= 1).any()


# -------------------------------------------------------- augmentation

def _corners(boxes):
    return box_np.center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5],
                                         boxes[:, 6])


@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_collision_test_equals_jax(jax_path):
    rng = np.random.RandomState(2)
    a, b = _corners(_scene_boxes(rng, 30)), _corners(_scene_boxes(rng, 20))
    got = augment.box_collision_test(a, b)
    np.testing.assert_array_equal(got, jaug.box_collision_test(a, b))
    assert got.any() and not got.all()
    assert augment.box_collision_test(a[:0], b).shape == (0, 20)


def test_coincident_boxes_collide_as_in_jax_numpy_not_its_cc():
    """Two copies of a box about 1e-6 apart (a database object drawn back
    into the frame it came from): they collide in the port and in JAX's
    numpy path (float64). JAX's C++ pass takes float32 corners, where no
    edge properly crosses and neither box strictly contains the other,
    and reports no collision, so it pastes the copy. The port keeps the
    numpy answer."""
    # a training frame's car and its database copy, as the sampler met them
    a = np.array([[[35.75618781, 7.693547], [39.63491129, 7.28672409],
                   [39.46800958, 5.69545293], [35.5892861, 6.10227585]]])
    b = np.array([[[35.75618916, 7.69354701], [39.63491254, 7.28672412],
                   [39.46801084, 5.69545299], [35.58928746, 6.10227588]]])
    assert augment.box_collision_test(a, b)[0, 0]
    assert jaug._box_collision_test_np(a, b)[0, 0]
    assert not cc.box_collision_test(a.astype(np.float32),
                                     b.astype(np.float32))[0, 0]


NOISE_MODES = {
    "plain": {},
    "mask": {"valid": [1, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1]},
    "groups": {"group_ids": [0, 0, 1, 2, 2, 2, 3, 4, 5, 6, 7, 7]},
    "circle": {"global_random_rot_range": [-0.8, 0.8]},
    "circle groups": {"global_random_rot_range": [-0.8, 0.8],
                      "group_ids": [0, 0, 1, 2, 2, 2, 3, 4, 5, 6, 7, 7]},
}


@pytest.mark.parametrize("mode", NOISE_MODES)
@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_noise_per_object_equals_jax(jax_path, mode):
    opts = dict(NOISE_MODES[mode])
    rng = np.random.RandomState(3)
    boxes = _scene_boxes(rng, 12)
    boxes[:, :2] *= 1.5  # some room to move
    points = np.concatenate([rng.uniform([0, 0, -3], [30, 30, 1], (4000, 3)),
                             rng.uniform(0, 1, (4000, 1))], 1)
    kw = {"rotation_perturb": [-0.3, 0.3], "center_noise_std": [1.0, 1.0, 0.1],
          "global_random_rot_range": opts.get("global_random_rot_range", 0.0),
          "num_try": 100}
    if "valid" in opts:
        kw["valid_mask"] = np.array(opts["valid"], bool)
    if "group_ids" in opts:
        kw["group_ids"] = np.array(opts["group_ids"])
    out = []
    for fn in (augment.noise_per_object_, jaug.noise_per_object_):
        b, p, r = boxes.copy(), points.copy(), np.random.RandomState(7)
        fn(b, p, rng=r, **kw)
        out.append((b, p, r.randint(1 << 30)))
    for got, want in zip(out[0], out[1]):
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(out[0][0], boxes)


@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_global_augmentations_equal_jax(jax_path):
    rng = np.random.RandomState(4)
    boxes = _scene_boxes(rng, 10).astype(np.float32)
    points = rng.uniform(-5, 5, (500, 4)).astype(np.float32)
    ops = [
        ("random_flip", lambda m, b, p, r: m.random_flip(b, p, 0.5, rng=r)),
        ("global_rotation", lambda m, b, p, r: m.global_rotation(
            b, p, [-0.78, 0.78], rng=r)),
        ("global_scaling", lambda m, b, p, r: m.global_scaling(
            b, p, 0.95, 1.05, rng=r)),
        ("global_translate", lambda m, b, p, r: m.global_translate(
            b, p, [0.2, 0.2, 0.2], rng=r)),
    ]
    for name, op in ops:
        for seed in range(3):
            res = []
            for m in (augment, jaug):
                r = np.random.RandomState(seed)
                res.append(op(m, boxes.copy(), points.copy(), r)
                           + (r.randint(1 << 30),))
            for got, want in zip(*res):
                np.testing.assert_array_equal(got, want, err_msg=name)
    limit = [0, -10, 12, 10]
    np.testing.assert_array_equal(
        augment.filter_gt_box_outside_range(boxes, limit),
        jaug.filter_gt_box_outside_range(boxes, limit))


@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_crop_frustum_and_corner_masks_equal_jax(jax_path):
    from papc_tpu.data.synthetic_kitti import default_calib

    P2, rect, Tr = default_calib()
    bboxes = np.array([[100.0, 120, 300, 250], [600, 150, 700, 240]])
    fr = []
    for m in (augment, jaug):
        r = np.random.RandomState(5)
        fr.append(m.random_crop_frustum(bboxes, rect, Tr, P2, rng=r))
    np.testing.assert_array_equal(*fr)
    pts = np.random.RandomState(6).uniform([0, -20, -3, 0], [60, 20, 2, 1],
                                           (5000, 4))
    got = augment.mask_points_in_corners(pts, fr[0])
    np.testing.assert_array_equal(got, jaug.mask_points_in_corners(pts,
                                                                   fr[0]))
    assert got.any()


def test_batch_sampler_and_db_filters_equal_jax():
    items = [{"difficulty": d, "num_points_in_gt": n, "name": "Car"}
             for d, n in zip([0, 1, -1, 2, 0, -1, 1], [3, 9, 12, 5, 1, 30, 7])]
    draws = []
    for m in (augment, jaug):
        s = m.BatchSampler(list(range(7)), "Car",
                           rng=np.random.RandomState(8))
        draws.append([s.sample(k) for k in (3, 3, 2, 5, 1, 4)])
    assert draws[0] == draws[1]
    for m in (augment, jaug):
        prep = m.DataBasePreprocessor([m.DBFilterByMinNumPoint({"Car": 5}),
                                       m.DBFilterByDifficulty([-1])])
        draws.append(prep({"Car": list(items)}))
    assert draws[2] == draws[3]
    assert [i["num_points_in_gt"] for i in draws[2]["Car"]] == [9, 5, 7]


SAMPLERS = {
    "class": {"groups": [{"Car": 8}]},
    "circle": {"groups": [{"Car": 8}], "global_rot_range": [-0.5, 0.5]},
    "groups": {"groups": [{"Car": 6, "Van": 2}]},
    "crop": {"groups": [{"Car": 8}], "random_crop": True},
}


@pytest.mark.parametrize("mode", SAMPLERS)
@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_db_sampler_equals_jax(trees, jax_path, mode):
    opts = SAMPLERS[mode]
    root = trees["jax"]
    db_infos = _load(pathlib.Path(root, "kitti_dbinfos_train.pkl"))
    infos = _load(pathlib.Path(root, "kitti_infos_train.pkl"))
    info = infos[0]
    rect, Tr, P2 = (info[k] for k in ("calib/R0_rect", "calib/Tr_velo_to_cam",
                                      "calib/P2"))
    gt = box_np.box_camera_to_lidar(common.anno_to_rbboxes(info["annos"]),
                                    rect, Tr)
    names = info["annos"]["name"]
    res = []
    for m in (sampling, jsampling):
        s = m.DataBaseSamplerV2(
            {k: list(v) for k, v in db_infos.items()}, opts["groups"],
            global_rot_range=opts.get("global_rot_range"),
            rng=np.random.RandomState(9), log=lambda *a: None)
        out = []
        for call in range(3):
            if call == 2:
                s.reseed(1234)
            d = s.sample_all(root, gt, names, 4,
                             random_crop=opts.get("random_crop", False),
                             gt_group_ids=np.arange(len(gt)),
                             rect=rect, Trv2c=Tr, P2=P2)
            out.append(d)
        res.append(out)
    for got, want in zip(*res):
        assert (got is None) == (want is None)
        if got is not None:
            assert list(got) == list(want)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any(d is not None for d in res[0])


# -------------------------------------------------------------- dataset

def _configs(root):
    """JAX's YAML config and the port's, on the 64 × 64 grid over
    ``root``; the training reader's database sampler keeps its quota."""
    jcfg, cfg = cfg_from_yaml_file(DEFAULT_CONFIG_PATH), car_config()
    over = GRID + ["TRAIN_INPUT_READER.KITTI_ROOT_PATH", root,
                   "EVAL_INPUT_READER.KITTI_ROOT_PATH", root]
    jcfg_from_list(jcfg, over)
    cfg_from_list(cfg, over)
    shrink_anchors(jcfg)
    shrink_anchors(cfg)
    return jcfg, cfg


def _datasets(jcfg, cfg, training, seed=11):
    out = []
    for b, c in ((builders, cfg), (jbuilders, jcfg)):
        vg = b.build_voxel_generator(c.VOXEL_GENERATOR)
        ta = b.build_target_assigner(c.TARGET_ASSIGNER,
                                     b.build_box_coder(c.BOX_CODER))
        reader = c.TRAIN_INPUT_READER if training else c.EVAL_INPUT_READER
        out.append(b.build_dataset(c, reader, vg, ta, training=training,
                                   rng=np.random.RandomState(seed),
                                   log=lambda *a: None))
    return out


def _assert_examples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("per_item", [False, True],
                         ids=["stateful sampler", "per-item sampler"])
@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_kitti_dataset_examples_equal_jax_at_two_epochs(trees, jax_path,
                                                        per_item):
    """The port reads JAX's tree, JAX the port's; every key of every
    training example, in the loop's order, at epochs 0 and 1. Against
    JAX's numpy paths the database holds the training frames' own cars,
    which the sampler draws back into their frames; against its C++
    passes it holds the val frames' (see the coincident-box test above:
    there JAX's two paths part)."""
    db = "kitti_dbinfos_train.pkl" if jax_path == "numpy" else \
        "kitti_dbinfos_val.pkl"
    over = ["TRAIN_INPUT_READER.DATABASE_SAMPLER.database_info_path", db]
    jcfg, cfg = _configs(trees["jax"])
    cfg_from_list(cfg, over)
    port_ds, _ = _datasets(jcfg, cfg, True)
    jcfg, cfg = _configs(trees["port"])
    jcfg_from_list(jcfg, over)
    _, jax_ds = _datasets(jcfg, cfg, True)
    for ds in (port_ds, jax_ds):
        ds.enable_per_item_sampler_seeding(per_item)
    positives = 0
    for epoch in (0, 1):
        for ds in (port_ds, jax_ds):
            ds.set_epoch(epoch)
        for i in (2, 0, 3, 1):
            got, want = port_ds[i], jax_ds[i]
            _assert_examples_equal(got, want)
            positives += int((got["labels"] > 0).sum())
    assert positives > 0
    assert port_ds[0]["points_mask"].sum() > 0


@pytest.mark.parametrize("jax_path", PATHS, indirect=True)
def test_eval_examples_and_collate_equal_jax(trees, jax_path):
    jcfg, cfg = _configs(trees["jax"])
    port_ds, jax_ds = _datasets(jcfg, cfg, False)
    assert len(port_ds) == 2
    got = preprocess.collate_batch([port_ds[0], port_ds[1]])
    want = jprep.collate_batch([jax_ds[0], jax_ds[1]])
    _assert_examples_equal(got, want)
    assert "labels" not in got and got["anchors"].shape == (2, 2048, 7)


def test_host_pillarize_refuses(trees):
    """Host pillarize no longer refuses: with ``MODEL.DEVICE_PILLARIZE``
    false both packages pillarize on the host, into the flat points of
    the flat PFN, and the eval examples are equal bit for bit
    (``tests/test_torch_detect_host.py`` holds the rest of that path)."""
    jcfg, cfg = _configs(trees["port"])
    for c, set_list in ((cfg, cfg_from_list), (jcfg, jcfg_from_list)):
        set_list(c, ["MODEL.DEVICE_PILLARIZE", "False"])
    ds, jax_ds = _datasets(jcfg, cfg, False)
    got = ds[0]
    _assert_examples_equal(got, jax_ds[0])
    assert "points_flat" in got and "points" not in got
