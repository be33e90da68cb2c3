"""The port's PointPillars 3-class KITTI config against the JAX package,
on the CPU.

Both packages run in one process on the same seeded numpy inputs;
weights cross through ``papc_tpu_torch.convert``. The grid is
``tests/test_detect_e2e.py``'s (64 × 64 cells, 32 × 32 feature map), each
of the three generators shrunk to it: 6 144 anchors. Tolerances:

- the config key for key, the anchors and per-anchor thresholds, the
  range anchors, the dataset's examples and the running metrics' counts
  exactly;
- the BEV coder's decode within 1e-6 (relative, 1e-6 absolute) of JAX's
  ``decode_jnp`` and its numpy decode, and ``encode`` then ``decode``
  within 1e-5 of the boxes;
- the GroupNorm RPN's heads within 1e-5 of flax's (relative to each
  head's largest): flax normalises with epsilon 1e-3 over ``min(32, C)``
  groups, and takes the variance as E[x²] − E[x]²;
- the 3-class network's heads within 1e-5 of each head's largest;
- one training step: the port's float64 step against JAX's step run op
  by op in float64, the metrics within 1e-7 relative, each gradient
  within 1e-6 relative L2 of JAX's float64 gradient, the parameters and
  BatchNorm statistics after the step within 1e-6 of each tensor's
  largest; the f32 step's loss within 1e-5 of JAX's jitted f32 step's;
- detections (``predict_multiclass``, single ``predict``): the keep
  masks, labels and count exactly, boxes and scores within 1e-5. The
  inputs' candidate scores are distinct within each frame and class
  (asserted: JAX sorts with ``np.argsort``, which is not stable), and no
  compared pair's IoU lies within 1e-5 of the threshold by JAX's float64
  IoU (asserted, the margin printed: JAX's C++ NMS takes the IoU in
  float64, the port in float32);
- the official result over Car, Pedestrian and Cyclist within 1e-9.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu import cc
from papc_tpu.detect import anchors as janchors
from papc_tpu.detect import box_np as jbox
from papc_tpu.detect import builders as jbuilders
from papc_tpu.detect import detector as jdetector
from papc_tpu.detect.box_coder import BevBoxCoder as JaxBevCoder
from papc_tpu.detect.config import cfg_from_list as jax_cfg_from_list
from papc_tpu.detect.config import cfg_from_yaml_file
from papc_tpu.detect.kitti import create_data as jcreate
from papc_tpu.detect.model import RPN as JaxRPN
from papc_tpu.detect.train import make_detection_train_step as jax_make_step
from papc_tpu.detect.train import make_pillarizer as jax_make_pillarizer
from papc_tpu.detect.train import make_predict_step as jax_make_predict_step
from papc_tpu.eval import kitti_eval as jeval
from papc_tpu.train import running_metrics as jrm
from papc_tpu.train.trainer import TrainState

from papc_tpu_torch import convert
from papc_tpu_torch.data.synthetic_kitti import (make_objects, make_scene,
                                                 pad_frame, write_kitti)
from papc_tpu_torch.detect import anchors, box_np, builders, detector
from papc_tpu_torch.detect.box_coder import BevBoxCoder
from papc_tpu_torch.detect.config import (CONFIGS, Config, cfg_from_file,
                                          cfg_from_list, kitti_3class_config)
from papc_tpu_torch.detect.kitti import create_data
from papc_tpu_torch.detect.kitti.preprocess import collate_batch
from papc_tpu_torch.detect.model import RPN
from papc_tpu_torch.detect.train import (make_detection_train_step,
                                         make_pillarizer, make_predict_step)
from papc_tpu_torch.eval import kitti_eval
from papc_tpu_torch.train import running_metrics as rm
from tests.torch_parity import few_threads, perturb_stats  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")
T = torch.from_numpy
F32 = np.float32

YAML = str(pathlib.Path(jbuilders.__file__).parent / "configs"
           / "pointpillars_kitti_3class.yaml")
NAMES = ["Car", "Pedestrian", "Cyclist"]
TINY = ["VOXEL_GENERATOR.VOXEL_SIZE", "[1.08, 1.24, 4]",
        "VOXEL_GENERATOR.MAX_NUMBER_OF_POINTS_PER_VOXEL", "40",
        "MODEL.BACKBONE.layer_nums", "[1, 2, 2]",
        "MODEL.BACKBONE.num_filters", "[16, 32, 64]",
        "MODEL.BACKBONE.num_upsample_filters", "[32, 32, 32]",
        "TRAIN_INPUT_READER.MAX_NUMBER_OF_VOXELS", "800",
        "EVAL_INPUT_READER.MAX_NUMBER_OF_VOXELS", "800",
        "TRAIN_INPUT_READER.MAX_POINTS_PER_FRAME", "3000",
        "EVAL_INPUT_READER.MAX_POINTS_PER_FRAME", "3000"]
TINY_VOXELS = 800
CLASSIC = ("SCATTER_S2D", "PFN_FLAT", "RPN_DEFERRED_UPS", "RPN_BATCH_FOLD")


def shrink_anchors(cfg):
    """Every generator's strides and offsets on the 64 × 64 grid (each
    keeps its own z offset)."""
    for g in cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS:
        gen = g.anchor_generator_stride
        gen.strides = [2.16, 2.48, 0.0]
        gen.offsets = [1.08, -38.44, gen.offsets[2]]


def tiny_configs(extra=()):
    """``(jax_cfg, port_cfg)``: the 3-class config on the 64 × 64 grid
    with 800 pillars of 40 points, RPN depths 1-2-2 and widths
    16-32-64."""
    jcfg, cfg = cfg_from_yaml_file(YAML), kitti_3class_config()
    over = TINY + list(extra)
    jax_cfg_from_list(jcfg, over + ["VOXEL_GENERATOR.MAX_VOXELS",
                                    str(TINY_VOXELS)])
    cfg_from_list(cfg, over)
    shrink_anchors(jcfg)
    shrink_anchors(cfg)
    return jcfg, cfg


def _parts(b, cfg):
    """``(voxel generator, box coder, target assigner)`` of a config in
    builders module ``b``."""
    vg = b.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = b.build_box_coder(cfg.BOX_CODER)
    return vg, coder, b.build_target_assigner(cfg.TARGET_ASSIGNER, coder)


def _fmap(vg):
    return [1, int(vg.grid_size[1]) // 2, int(vg.grid_size[0]) // 2]


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


def test_config_equals_the_3class_yaml_key_for_key():
    """Every leaf of ``cfg_from_yaml_file``'s 3-class config, value and
    type, and no other; reached by name through ``cfg_from_file``."""
    want = dict(_leaves(cfg_from_yaml_file(YAML)))
    for cfg in (kitti_3class_config(),
                cfg_from_file("pointpillars_kitti_3class")):
        got = dict(_leaves(cfg))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k] == v and type(got[k]) is type(v), k
    assert len(want) == 115
    assert set(CONFIGS) == {"pointpillars_kitti_car",
                            "pointpillars_kitti_3class"}
    assert cfg_from_file("pointpillars_kitti_car") == cfg_from_file(None)
    with pytest.raises(ValueError, match="pointpillars_kitti_3class"):
        cfg_from_file(YAML)


# ------------------------------------------------------------ anchors

def test_anchors_and_thresholds_equal_jax_with_its_threshold_order():
    """``generate_anchors`` over the three generators and ``build_anchors``
    equal JAX's exactly, at the tiny grid and at the config's full one
    (321 408 anchors). JAX concatenates the anchors location-major (the
    six of a location side by side: Car, Car, Pedestrian, Pedestrian,
    Cyclist, Cyclist) but the thresholds generator by generator, so
    anchor i takes the i-th entry of [Car's] + [Pedestrian's] +
    [Cyclist's]: the first third of the locations gets the Car thresholds
    for all six anchors, whatever their class. The port matches it."""
    for extra in ((), None):
        if extra is None:
            jcfg, cfg = cfg_from_yaml_file(YAML), kitti_3class_config()
        else:
            jcfg, cfg = tiny_configs(extra)
        vg, _, ta = _parts(builders, cfg)
        jvg, _, jta = _parts(jbuilders, jcfg)
        got, want = ta.generate_anchors(_fmap(vg)), jta.generate_anchors(
            _fmap(jvg))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        flat = builders.build_anchors(cfg, vg)
        np.testing.assert_array_equal(flat, want["anchors"].reshape(-1, 7))
        H, W = _fmap(vg)[1:]
        A = H * W * 6
        assert flat.shape == (A, 7) and ta.num_anchors_per_location == 6
        match, unmatch = got["matched_thresholds"], got["unmatched_thresholds"]
        np.testing.assert_array_equal(match[:6], np.full(6, 0.6, F32))
        np.testing.assert_array_equal(unmatch[:6], np.full(6, 0.45, F32))
        car = match == F32(0.6)
        np.testing.assert_array_equal(np.flatnonzero(car),
                                      np.arange(2 * H * W))
        sizes = flat[:, 3:6]
        for name, size in (("Car", [1.6, 3.9, 1.56]),
                           ("Pedestrian", [0.6, 0.8, 1.73])):
            cls = np.all(sizes == np.asarray(size, F32), axis=1)
            assert cls.sum() == 2 * H * W
            if extra is None:  # 248 x 216 locations: exactly a third
                assert 3 * int((car & cls).sum()) == int(cls.sum()), name
    assert A == 321408


def test_range_generator_and_builders_equal_jax():
    """``anchor_generator_range`` through ``build_anchor_generator`` and a
    target assigner mixing it with a stride generator, against JAX's
    builders: anchors and thresholds exactly."""
    rng_gen = {"anchor_generator_range": {
        "anchor_ranges": [0, -39.68, -1.78, 69.12, 39.68, -1.78],
        "sizes": [1.6, 3.9, 1.56], "rotations": [0, 1.57],
        "matched_threshold": 0.6, "unmatched_threshold": 0.45,
        "class_name": "Car"}}
    cfg = Config.wrap(rng_gen)
    got, want = (builders.build_anchor_generator(cfg),
                 jbuilders.build_anchor_generator(cfg))
    assert isinstance(got, anchors.AnchorGeneratorRange)
    assert isinstance(want, janchors.AnchorGeneratorRange)
    assert got.num_anchors_per_localization == 2 and got.class_id == "Car"
    for fmap in ([1, 248, 216], [1, 7, 5], [2, 3, 4]):
        g, w = got.generate(fmap), want.generate(fmap)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        box_np.create_anchors_3d_range([1, 6, 5], [0, -4, -1, 8, 4, 1],
                                       [[1.6, 3.9, 1.56], [0.6, 0.8, 1.7]]),
        jbox.create_anchors_3d_range([1, 6, 5], [0, -4, -1, 8, 4, 1],
                                     [[1.6, 3.9, 1.56], [0.6, 0.8, 1.7]]))
    jcfg, pcfg = tiny_configs()
    for c in (jcfg, pcfg):
        c.TARGET_ASSIGNER.ANCHOR_GENERATORS[1] = Config.wrap(rng_gen)
    vg, _, ta = _parts(builders, pcfg)
    jvg, _, jta = _parts(jbuilders, jcfg)
    g, w = ta.generate_anchors(_fmap(vg)), jta.generate_anchors(_fmap(jvg))
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    with pytest.raises(ValueError, match="unknown anchor generator"):
        builders.build_anchor_generator(Config.wrap({"nope": {}}))


# ------------------------------------------------------ the BEV coder

@pytest.mark.parametrize("linear_dim,vec_encode",
                         [(False, False), (True, False), (False, True)])
def test_bev_box_coder_round_trip_and_decode_equal_jax(linear_dim,
                                                       vec_encode):
    """``build_box_coder``'s ``bev_box_coder`` (Z_FIXED, H_FIXED read):
    ``encode`` equals JAX's, ``decode`` (torch) equals JAX's numpy decode
    and ``decode_jnp``, and decoding the encoding gives the boxes back in
    x, y, w, l and yaw, with the fixed z and h."""
    over = {"BOX_CODER_TYPE": "bev_box_coder", "LINEAR_DIM": linear_dim,
            "ENCODE_ANGLE_VECTOR": vec_encode, "Z_FIXED": -1.5,
            "H_FIXED": 1.7}
    coder = builders.build_box_coder(Config.wrap(over))
    jcoder = jbuilders.build_box_coder(Config.wrap(over))
    assert isinstance(coder, BevBoxCoder) and isinstance(jcoder, JaxBevCoder)
    assert coder.code_size == jcoder.code_size == (6 if vec_encode else 5)
    rs = np.random.RandomState(int(linear_dim) + 2 * int(vec_encode))
    n = 64

    def boxes():
        return np.concatenate([rs.uniform(0, 60, (n, 1)),
                               rs.uniform(-30, 30, (n, 1)),
                               rs.uniform(-2, 0, (n, 1)),
                               rs.uniform(0.5, 2.0, (n, 1)),
                               rs.uniform(0.8, 4.5, (n, 1)),
                               rs.uniform(1.3, 1.8, (n, 1)),
                               rs.uniform(-1.5, 1.5, (n, 1))], 1).astype(F32)

    gt, anc = boxes(), boxes()
    enc = coder.encode(gt, anc)
    np.testing.assert_array_equal(enc, jcoder.encode(gt, anc))
    dec = coder.decode(T(enc), T(anc)).numpy()
    for want in (jcoder.decode(enc, anc),
                 np.asarray(jcoder.decode_jnp(jnp.asarray(enc),
                                              jnp.asarray(anc)))):
        np.testing.assert_allclose(dec, want, rtol=1e-6, atol=1e-6)
    cols = [0, 1, 3, 4, 6]
    np.testing.assert_allclose(dec[:, cols], gt[:, cols], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(dec[:, 2], np.full(n, -1.5, F32))
    np.testing.assert_array_equal(dec[:, 5], np.full(n, 1.7, F32))
    np.testing.assert_array_equal(
        box_np.bev_box_decode(enc, anc[:, cols], vec_encode, linear_dim),
        jbox.bev_box_decode(enc, anc[:, cols], vec_encode, linear_dim))
    with pytest.raises(ValueError, match="unknown box coder"):
        builders.build_box_coder(Config.wrap({"BOX_CODER_TYPE": "nope"}))


# ------------------------------------------------ the GroupNorm RPN

RPN_KW = dict(num_class=3, layer_nums=(1, 2, 2), layer_strides=(2, 2, 2),
              num_filters=(16, 32, 64), upsample_strides=(1, 2, 4),
              num_upsample_filters=(32, 32, 32), num_anchor_per_loc=6)


def _close_to_max(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("num_groups", [32, 8])
def test_groupnorm_rpn_matches_flax(num_groups):
    """``use_groupnorm`` through ``build_network`` and on its own: flax's
    GroupNorm names (``GroupNorm_i`` in each conv block and after each
    upsample), its weights through ``convert`` and back, and the heads in
    training and eval mode (no running statistics either way) within
    1e-5 of flax's on a seeded BEV canvas; flax's epsilon 1e-3 and
    ``min(num_groups, C)`` groups, not torch's 1e-5 default."""
    jrpn = JaxRPN(use_groupnorm=True, num_groups=num_groups, **RPN_KW)
    x = np.random.RandomState(num_groups).randn(2, 24, 16, 64).astype(F32)
    variables = jrpn.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    assert "batch_stats" not in variables
    params = convert.flatten({"params": _np(variables["params"])})
    assert "params/_ConvBlock_1/GroupNorm_2/scale" in params
    assert "params/GroupNorm_2/bias" in params
    scaled = {k: v * (1 + 0.3 * np.random.RandomState(3).randn(*v.shape))
              if k.endswith(("scale", "bias")) else v
              for k, v in params.items()}
    port = RPN(64, use_groupnorm=True, num_groups=num_groups, **RPN_KW)
    convert.load_flax_weights(port, scaled)
    norms = [m for m in port.modules() if isinstance(m, torch.nn.GroupNorm)]
    assert len(norms) == 11 and all(m.eps == 1e-3 for m in norms)
    assert [m.num_groups for m in norms[:2]] == [min(num_groups, 16)] * 2
    back = convert.state_dict_to_flax(port.state_dict())
    assert sorted(back) == sorted(scaled)
    jvars = {"params": jax.tree_util.tree_map(
        jnp.asarray, _unflatten(scaled)["params"])}
    for train in (True, False):
        want = jrpn.apply(jvars, jnp.asarray(x), train=train)
        port.train(train)
        with torch.no_grad():
            got = port(T(x))
        assert sorted(got) == sorted(want)
        for k in want:
            _close_to_max(got[k].numpy(), want[k], 1e-5)


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


# ------------------------------------------- the 3-class network, step

def _frames(cfg, ta, n, seed):
    """``n`` seeded frames, each a car scene with a pedestrian and a
    cyclist added, padded to the reader's points, with the port's targets
    over the three classes (``gt_classes`` 1-3)."""
    rs = np.random.RandomState(seed)
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    gen = ta.generate_anchors(_fmap(vg))
    anchors_flat = gen["anchors"].reshape(-1, 7)
    bv = box_np.rbbox2d_to_near_bbox(anchors_flat[:, [0, 1, 3, 4, 6]])
    out = []
    for _ in range(n):
        points, boxes = make_scene(rs, num_cars=3, n_background=2000)
        classes = [1] * len(boxes)
        for c, name in enumerate(NAMES[1:], start=2):
            p, b = make_objects(rs, name, 2)
            points = np.concatenate([points, p])
            boxes = np.concatenate([boxes, b])
            classes += [c] * len(b)
        pts, mask = pad_frame(points, int(
            cfg.TRAIN_INPUT_READER.MAX_POINTS_PER_FRAME))
        t = ta.assign(anchors_flat, boxes,
                      gt_classes=np.asarray(classes, np.int32),
                      matched_thresholds=gen["matched_thresholds"],
                      unmatched_thresholds=gen["unmatched_thresholds"],
                      rng=rs, anchors_bv=bv)
        out.append({"points": pts, "points_mask": mask,
                    "anchors": anchors_flat, "labels": t["labels"],
                    "reg_targets": t["bbox_targets"]})
    return collate_batch(out)


def _jax_batch(b, dtype=np.float32):
    return {k: jnp.asarray(v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in b.items()}


@pytest.fixture(scope="module")
def net():
    """The tiny 3-class config in both packages, a batch of two frames
    with three-class targets, JAX's network in the reference form with
    seeded weights and perturbed running statistics, and the port's
    network carrying them."""
    jcfg, cfg = tiny_configs()
    for key in CLASSIC:
        jcfg.MODEL[key] = False
    vg, coder, ta = _parts(builders, cfg)
    jvg, jcoder, jta = _parts(jbuilders, jcfg)
    batch = _frames(cfg, ta, 2, seed=5)
    jmodel = jbuilders.build_network(jcfg, jvg, jta)
    jpil = jax_make_pillarizer(jvg, TINY_VOXELS)
    variables = jax.jit(lambda b: jmodel.init(
        jax.random.PRNGKey(0), *jpil(b), train=False))(_jax_batch(batch))
    variables = perturb_stats(variables, 7)
    return {"cfg": cfg, "jcfg": jcfg, "vg": vg, "coder": coder, "ta": ta,
            "jvg": jvg, "jcoder": jcoder, "jta": jta, "batch": batch,
            "jmodel": jmodel, "jpil": jpil, "variables": variables}


def _port_model(net, dtype=torch.float32):
    model = builders.build_network(net["cfg"], net["vg"], net["ta"])
    convert.load_flax_weights(model, _np(net["variables"]))
    return model.to(dtype)


def test_3class_forward_matches_flax(net):
    """The 3-class heads (18 / 42 / 12 channels at 6 anchors a location)
    in eval mode, within 1e-5 of each head's largest."""
    model = _port_model(net).eval()
    b = net["batch"]
    want = jax.jit(lambda v, bb: net["jmodel"].apply(
        v, *net["jpil"](bb), train=False))(net["variables"], _jax_batch(b))
    pil = make_pillarizer(net["vg"], TINY_VOXELS)
    with torch.no_grad():
        got = model(*pil({k: T(v) for k, v in b.items()}))
    widths = {k: got[k].shape[-1] for k in got}
    assert widths == {"box_preds": 42, "cls_preds": 18, "dir_cls_preds": 12}
    for k in want:
        _close_to_max(got[k].numpy(), want[k], 1e-5)


def _jax_grads64(net, b64):
    """JAX's float64 gradient of the loss, op by op, flax-keyed."""
    jloss = jbuilders.build_loss_config(net["jcfg"], net["jta"])
    v64 = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x), jnp.float64), net["variables"])

    def loss_fn(params):
        preds, _ = net["jmodel"].apply(
            {"params": params, "batch_stats": v64["batch_stats"]},
            *net["jpil"](b64), train=True, mutable=["batch_stats"])
        return jdetector.compute_loss(preds, b64["labels"],
                                      b64["reg_targets"], b64["anchors"],
                                      jloss)[0]

    return convert.flatten({"params": _np(jax.grad(loss_fn)(
        v64["params"]))})


def test_3class_train_step_matches_jax(net):
    """One step of ``make_detection_train_step`` at three classes. The
    port's float64 step against JAX's step run op by op in float64: every
    metric, each gradient (relative L2) and the parameters and BatchNorm
    statistics after the step; the port's f32 step's loss and metrics
    against JAX's jitted f32 step; the running metrics' counts equal
    JAX's; positives of all three classes in the batch."""
    cfg, b = net["cfg"], net["batch"]
    labels = b["labels"]
    assert all(int((labels == c).sum()) > 0 for c in (1, 2, 3))
    jloss = jbuilders.build_loss_config(net["jcfg"], net["jta"])
    jstep, jinit = jax_make_step(net["jmodel"], jloss, pillarize=net["jpil"])

    def fresh(v):
        return TrainState.create(
            apply_fn=net["jmodel"].apply, params=v["params"],
            batch_stats=v["batch_stats"],
            tx=jbuilders.build_optimizer(net["jcfg"].TRAIN_CONFIG.OPTIMIZER))

    w32 = jstep(fresh(jax.tree_util.tree_map(jnp.array, net["variables"])),
                _jax_batch(b), jinit())
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x), jnp.float64),
            net["variables"])
        b64 = _jax_batch(b, np.float64)
        step64, init64 = jax_make_step(net["jmodel"], jloss,
                                       pillarize=net["jpil"])
        state64, m64, r64 = step64.impl(fresh(v64), b64, init64())
        grads64 = _jax_grads64(net, b64)
    want_state = convert.flatten({"params": _np(state64.params),
                                  "batch_stats": _np(state64.batch_stats)})

    results = {}
    for dtype in (torch.float64, torch.float32):
        model = _port_model(net, dtype)
        opt, sched = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER,
                                              model.parameters())
        step, init_rm = make_detection_train_step(
            model, builders.build_loss_config(cfg, net["coder"]), opt,
            sched, make_pillarizer(net["vg"], TINY_VOXELS), device="cpu")
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        cast = {k: v.astype(np_dtype) if v.dtype.kind == "f" else v
                for k, v in b.items()}
        m, r = step(cast, init_rm())
        grads = convert.state_dict_to_flax(
            {n: p.grad for n, p in model.named_parameters()})
        results[dtype] = ({k: float(v) for k, v in m.items()}, r, grads,
                          convert.state_dict_to_flax(model.state_dict()))

    metrics, r, grads, state = results[torch.float64]
    assert set(metrics) == set(m64)
    for k, v in m64.items():
        assert metrics[k] == pytest.approx(float(v), rel=1e-7, abs=1e-12), k
    assert sorted(grads) == sorted(grads64)
    for k, g in grads64.items():
        err = np.linalg.norm(grads[k] - g) / max(np.linalg.norm(g), 1e-30)
        assert err < 1e-6, (k, err)
    assert sorted(state) == sorted(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(state[k], v, rtol=0,
                                   atol=1e-6 * np.abs(v).max(), err_msg=k)
    for f in ("tp", "fp", "fn", "tn"):
        np.testing.assert_array_equal(getattr(r["pr"], f).numpy(),
                                      np.asarray(getattr(r64["pr"], f)))
    np.testing.assert_array_equal(float(r["acc"].count),
                                  float(r64["acc"].count))
    metrics32 = results[torch.float32][0]
    for k, v in w32[1].items():
        rel = 1e-5 if k == "loss" else 1e-4
        assert metrics32[k] == pytest.approx(float(v), rel=rel, abs=1e-6), k


def test_running_metrics_at_three_classes_match_jax():
    """The running accuracy and precision / recall over three classes'
    logits, with and without weights: equal to JAX's."""
    rs = np.random.RandomState(8)
    acc, pr = rm.AccuracyState.create(), rm.PrecisionRecallState.create()
    jacc, jpr = jrm.AccuracyState.create(), jrm.PrecisionRecallState.create()
    for i in range(2):
        labels = rs.randint(-1, 4, (2, 600)).astype(np.int32)
        preds = (2 * rs.randn(2, 600, 3)).astype(F32)
        w = None if i == 0 else rs.uniform(0, 1, (2, 600)).astype(F32)
        acc = acc.update(T(labels), T(preds), None if w is None else T(w))
        pr = pr.update(T(labels), T(preds), None if w is None else T(w))
        jw = None if w is None else jnp.asarray(w)
        jacc = jacc.update(jnp.asarray(labels), jnp.asarray(preds), jw)
        jpr = jpr.update(jnp.asarray(labels), jnp.asarray(preds), jw)
    for got, want in ((acc.total, jacc.total), (acc.count, jacc.count)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for f in ("tp", "fp", "fn", "tn", "precision", "recall"):
        np.testing.assert_allclose(getattr(pr, f).numpy(),
                                   np.asarray(getattr(jpr, f)), rtol=1e-6,
                                   err_msg=f)
    assert 0 < float(pr.tp.sum()) and 0 < float(acc.total)


# ------------------------------------------------ per-class detections

def _mc_inputs(seed, B=2):
    """Decoded boxes of the tiny config's 6 144 anchors ``[B, A, 7]``,
    class scores ``[B, A, 3]`` distinct within each frame and class (a
    shuffled ramp: Car's over (0, 1), Pedestrian's over (0, 0.35),
    Cyclist's over (0, 0.302), so at a threshold of 0.3 the classes hold
    thousands, hundreds and tens of candidates), direction labels and an
    anchors mask."""
    _, cfg = tiny_configs()
    vg, coder, _ = _parts(builders, cfg)
    anchors_flat = builders.build_anchors(cfg, vg)
    A = len(anchors_flat)
    rs = np.random.RandomState(seed)
    codes = (0.3 * rs.randn(B, A, 7)).astype(F32)
    boxes = coder.decode(T(codes), T(np.broadcast_to(
        anchors_flat, (B, A, 7)).copy())).numpy()
    scores = np.empty((B, A, 3), F32)
    for b in range(B):
        for c, top in enumerate((1.0, 0.35, 0.302)):
            scores[b, :, c] = ((rs.permutation(A) + 0.5) / A * top).astype(F32)
    dirs = rs.randint(0, 2, (B, A)).astype(np.int64)
    mask = rs.rand(B, A) > 0.2
    return boxes, scores, dirs, mask


def _predict_cfgs(**kw):
    base = dict(num_class=3, multiclass_nms=True, nms_pre_max_size=200,
                nms_post_max_size=300, nms_score_threshold=0.3,
                nms_iou_threshold=0.1)
    base.update(kw)
    return jdetector.PredictConfig(**base), detector.PredictConfig(**base)


def _hulls(cand7):
    """JAX's standup boxes of 7-column boxes (``standard_nms_func``)."""
    corners = jbox.center_to_corner_box2d(cand7[:, :2], cand7[:, 3:5],
                                          cand7[:, 6])
    return jbox.corner_to_standup_nd(corners)


def _jax_order(scores_c, thr, pre):
    """JAX's candidates of one class, in its order: the indices passing
    the threshold, then ``np.argsort(-scores)`` cut to ``pre``."""
    keep_ids = np.flatnonzero(scores_c >= thr)
    return keep_ids[np.argsort(-scores_c[keep_ids])[:pre]]


def _decision_margins(boxes7, order, thr, rotate):
    """The greedy sweep over ``boxes7[order]`` with JAX's IoU (the C++
    float64 rotated IoU, rounded to f32 as its NMS reads it; the standup
    IoU of its f32 hulls in float64) → ``(keep, the least |IoU - thr|
    over the pairs the sweep compares)``."""
    cand = boxes7[order]
    if rotate:
        bev = cand[:, [0, 1, 3, 4, 6]]
        iou = cc.rbbox_iou(bev, bev).astype(np.float64)
    else:
        h = _hulls(cand).astype(np.float64)
        iou = jbox._iou_2d_np(h, h)
    alive = np.ones(len(cand), bool)
    margin = np.inf
    for i in range(len(cand)):
        if not alive[i]:
            continue
        js = np.flatnonzero(alive[i + 1:]) + i + 1
        if len(js):
            margin = min(margin, float(np.abs(iou[i, js] - thr).min()))
            alive[js[iou[i, js] > thr]] = False
    return alive, margin


def _widened_standup(monkeypatch):
    """JAX's ``predict_multiclass`` with ``use_rotate_nms`` false hands
    its NMS 5-column BEV rows, which ``standard_nms_func(rotated=False)``
    passes to ``cc.nms`` as 4-column ones (a reference-side fault, pinned
    in ``test_jax_standup_multiclass_reads_five_columns_as_four``). The
    reference here widens each row to the 7 columns its hull branch reads
    (z = 0, h = 1: the standup hull ignores both)."""
    from papc_tpu.detect import nms_extra as jnms_extra

    original = jnms_extra.standard_nms_func

    def standard(rotated=False):
        fn = original(rotated)
        if rotated:
            return fn

        def widened(boxes, scores, pre, post, thr):
            z = np.zeros((len(boxes), 1), boxes.dtype)
            seven = np.concatenate([boxes[:, :2], z, boxes[:, 2:4], z + 1,
                                    boxes[:, 4:]], axis=1)
            return fn(seven, scores, pre, post, thr)

        return widened

    monkeypatch.setattr(jnms_extra, "standard_nms_func", standard)


def _check_detections(got, want):
    for k in ("valid", "label_preds"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("post", [600, 40])
@pytest.mark.parametrize("rotate", [True, False])
def test_predict_multiclass_matches_jax(rotate, post, monkeypatch):
    """``predict_multiclass`` (the port's one batched NMS over every frame
    and class) against JAX's host ``predict_multiclass``: the keep masks,
    labels and count exactly, boxes and scores within 1e-5, with the
    candidates of every frame and class distinct in score and every pair
    the sweep compares clear of the threshold by more than 1e-5 of JAX's
    float64 IoU (both asserted, the least margin printed). At ``post`` 40
    the Car class fills every slot of a frame; at 600 all three classes
    show. The standup reference widens JAX's rows (``_widened_standup``)."""
    boxes, scores, dirs, mask = _mc_inputs(seed=3)
    jcfg, cfg = _predict_cfgs(use_rotate_nms=rotate, nms_post_max_size=post)
    if not rotate:
        _widened_standup(monkeypatch)
    want = jdetector.predict_multiclass(boxes, scores, dirs, jcfg,
                                        anchors_mask=mask)
    launches = []
    monkeypatch.setattr(detector, "nms_keep", _counting(detector.nms_keep,
                                                        launches))
    got = detector.predict_multiclass(T(boxes), T(scores), T(dirs), cfg,
                                      anchors_mask=T(mask))
    assert launches == [(2 * 3, 200)]  # one NMS call, [B·C, K] rows
    _check_detections({k: v.numpy() for k, v in got.items()}, want)

    margins, per_class = [], np.zeros((2, 3), int)
    for b in range(2):
        masked = np.where(mask[b][:, None], scores[b], 0.0)
        for c in range(3):
            order = _jax_order(masked[:, c], 0.3, 200)
            cand = masked[order, c]
            assert len(np.unique(cand)) == len(cand) > 0
            keep, margin = _decision_margins(boxes[b], order, 0.1, rotate)
            margins.append(margin)
            per_class[b, c] = int(keep.sum())
    print(f"least |IoU - threshold| over compared pairs: {min(margins):.3e};"
          f" kept per frame and class {per_class.tolist()}")
    assert min(margins) > 1e-5
    labels = got["label_preds"][got["valid"]].numpy()
    if post == 600:
        assert set(labels.tolist()) == {0, 1, 2}
    else:
        assert (per_class[:, 0] > 40).all() and set(labels.tolist()) == {0}


def _counting(fn, log):
    def counted(boxes, ok, cfg, *, impl=None):
        log.append(tuple(ok.shape))
        return fn(boxes, ok, cfg, impl=impl)
    return counted


def test_jax_standup_multiclass_reads_five_columns_as_four():
    """A reference-side fault the port does not reproduce: JAX's
    ``standard_nms_func(rotated=False)`` takes a 5-column BEV row (what
    its ``predict_multiclass`` passes) as the standup box (x1, y1, x2,
    y2) of ``cc.nms``, reading the flat array four floats a row, so it
    keeps other boxes than on the same boxes' 7-column rows, whose hulls
    it does build. The port's ``standard_nms_func`` takes the hulls of
    either."""
    from papc_tpu.detect.nms_extra import standard_nms_func as jstandard

    from papc_tpu_torch.detect.nms_extra import standard_nms_func

    boxes, scores, _, _ = _mc_inputs(seed=4, B=1)
    b7, s = boxes[0, :300], scores[0, :300, 0]
    b5 = np.ascontiguousarray(b7[:, [0, 1, 3, 4, 6]])
    j5 = jstandard(False)(b5, s, None, None, 0.3)
    j7 = jstandard(False)(b7, s, None, None, 0.3)
    assert sorted(j5) != sorted(j7)
    for rows in (b5, b7):
        np.testing.assert_array_equal(
            standard_nms_func(False)(rows, s, None, None, 0.3), j7)


def test_predict_multiclass_tie_rule():
    """Tied scores: the port's candidates of a class come from a stable
    sort, so tied ones keep the anchor order (lower index first), and its
    keep mask is the greedy sweep of that order; JAX's ``np.argsort(-s)``
    is not stable, and its keep mask is the greedy sweep of its own order.
    Each side is a property of its order, not a tolerance: where the two
    orders differ, the kept sets may too (reported)."""
    boxes, scores, dirs, mask = _mc_inputs(seed=5, B=1)
    scores[0, :, 0] = np.round(scores[0, :, 0] * 8) / 8  # 9 tied levels
    jcfg, cfg = _predict_cfgs(use_rotate_nms=True)
    b, s, _, ok = detector.multiclass_candidates(T(boxes), T(scores), T(dirs),
                                                 cfg, anchors_mask=T(mask))
    masked = np.where(mask[0][:, None], scores[0], 0.0)
    passing = np.flatnonzero(masked[:, 0] >= 0.3)
    port_order = passing[np.lexsort((passing, -masked[passing, 0]))][:200]
    np.testing.assert_array_equal(b[0, 0].numpy(), boxes[0][port_order])
    assert bool(ok[0, 0].all())
    got = detector.predict_multiclass(T(boxes), T(scores), T(dirs), cfg,
                                      anchors_mask=T(mask))
    keep_port, _ = _decision_margins(boxes[0], port_order, 0.1, True)
    n_car = int((got["label_preds"][0][got["valid"][0]] == 0).sum())
    assert n_car == int(keep_port.sum())
    np.testing.assert_allclose(
        got["box3d_lidar"][0, :n_car, :6].numpy(),
        boxes[0][port_order][keep_port][:, :6], rtol=1e-6)
    want = jdetector.predict_multiclass(boxes, scores, dirs, jcfg,
                                        anchors_mask=mask)
    jax_order = _jax_order(masked[:, 0], 0.3, 200)
    keep_jax, _ = _decision_margins(boxes[0], jax_order, 0.1, True)
    w_car = int((want["label_preds"][0][want["valid"][0]] == 0).sum())
    assert w_car == int(keep_jax.sum())
    np.testing.assert_allclose(want["box3d_lidar"][0, :w_car, :6],
                               boxes[0][jax_order][keep_jax][:, :6],
                               rtol=1e-6)
    print(f"tied candidates: the orders differ at "
          f"{int((port_order != jax_order).sum())} of 200 places; kept "
          f"{int(keep_port.sum())} (port) / {int(keep_jax.sum())} (JAX)")


@pytest.mark.parametrize("rotate", [True, False])
def test_planted_pair_at_the_threshold(rotate):
    """Two axis-aligned 2 m x 1 m boxes apart by ``d`` along x have the
    IoU (2 - d) / (2 + d), 0.5 at d = 2/3. At the f32 neighbours of 2/3
    each side decides by its own IoU: the port's NMS (f32) keeps the
    second box exactly where its f32 IoU is at most 0.5, JAX's C++ NMS
    (float64, and for the rotated sweep rounded to f32) where its IoU is.
    The outcomes are recorded; they may differ between the two."""
    from papc_tpu_torch.detect.nms_extra import standard_nms_func
    from papc_tpu_torch.ops.iou import iou_2d, rotate_iou

    d0 = np.float32(2 / 3)
    outcomes = []
    for d in (np.nextafter(d0, F32(0)), d0, np.nextafter(d0, F32(1))):
        bev = np.array([[0, 0, 2, 1, 0], [d, 0, 2, 1, 0]], F32)
        b7 = bev[:, [0, 1, 2, 2, 3, 2, 4]].copy()
        b7[:, 2], b7[:, 5] = -1, 1.5
        s = np.array([0.9, 0.8], F32)
        port = standard_nms_func(rotate)(b7, s, None, None, 0.5)
        if rotate:
            jkeep = cc.rotate_nms(bev, 0.5)
            p_iou = float(rotate_iou(T(bev), T(bev))[1, 0])
            j_iou = float(cc.rbbox_iou(bev, bev)[0, 1])
        else:
            h = _hulls(b7)
            jkeep = cc.nms(h, 0.5)
            p_iou = float(iou_2d(T(h), T(h))[0, 1])
            j_iou = float(jbox._iou_2d_np(h.astype(np.float64),
                                          h.astype(np.float64))[0, 1])
        assert (1 in port) == (p_iou <= np.float32(0.5))
        assert bool(jkeep[1]) == (j_iou <= 0.5)
        outcomes.append((float(d), p_iou, j_iou, 1 in port, bool(jkeep[1])))
    print("d, port IoU, JAX IoU, port keeps, JAX keeps:", outcomes)


def _serving_pair(net, over):
    """JAX's and the port's ``make_predict_step`` on the tiny 3-class
    network with the same weights and ``POST_PROCESSING`` overrides."""
    jcfg, cfg = tiny_configs(over)
    for key in CLASSIC:
        jcfg.MODEL[key] = False
    jpc = jbuilders.build_predict_config(jcfg, net["jta"])
    pc = builders.build_predict_config(cfg, net["coder"])
    state = TrainState.create(
        apply_fn=net["jmodel"].apply, params=net["variables"]["params"],
        batch_stats=net["variables"]["batch_stats"],
        tx=jbuilders.build_optimizer(jcfg.TRAIN_CONFIG.OPTIMIZER))
    jstep = jax_make_predict_step(net["jmodel"], jpc, net["jcoder"],
                                  pillarize=net["jpil"])
    step = make_predict_step(_port_model(net), pc, net["coder"],
                             make_pillarizer(net["vg"], TINY_VOXELS),
                             device="cpu")
    return (lambda b: jstep(state, _jax_batch(b))), step, pc


@pytest.mark.parametrize("multiclass", [True, False])
def test_serving_at_three_classes_matches_jax(net, multiclass):
    """Raw points → detections through ``make_predict_step`` at three
    classes against JAX's, from the same weights: with ``multiclass_nms``
    (the config's default; JAX's host NMS, the port's batched one) and
    with the single ``predict`` (the best class an anchor, one NMS a
    frame). Candidates distinct in score (asserted for the first K = 300
    of each frame and class and the first one cut), the keep masks,
    labels and count exactly, boxes and scores within 1e-5; every class
    detected."""
    over = ["MODEL.POST_PROCESSING.multiclass_nms", str(multiclass),
            "MODEL.POST_PROCESSING.nms_pre_max_size", "300",
            "MODEL.POST_PROCESSING.nms_post_max_size", "900",
            "MODEL.POST_PROCESSING.nms_iou_threshold", "0.1",
            "MODEL.POST_PROCESSING.nms_score_threshold", "0.3"]
    jstep, step, pc = _serving_pair(net, over)
    b = {k: v for k, v in net["batch"].items()
         if k in ("points", "points_mask", "anchors")}
    want = jstep(b)
    got = step(b)
    _check_detections({k: v.numpy() for k, v in got.items()}, want)
    labels = got["label_preds"][got["valid"]].numpy()
    assert set(labels.tolist()) == {0, 1, 2}
    # the candidates' scores, from the port's own heads
    model = _port_model(net).eval()
    pil = make_pillarizer(net["vg"], TINY_VOXELS)
    with torch.no_grad():
        preds = model(*pil({k: T(v) for k, v in b.items()}))
    _, scores, _ = detector.decode_raw(preds, T(b["anchors"]),
                                       net["coder"].decode, pc)
    scores = scores.numpy()
    if not multiclass:
        scores = scores.max(-1, keepdims=True)
    for s in scores.transpose(0, 2, 1).reshape(-1, scores.shape[1]):
        # the K = 300 candidates and the first one cut: no tie decides
        # which are in or their order
        cand = np.sort(s[s >= 0.3])[::-1][:301]
        assert len(np.unique(cand)) == len(cand) > 0


def test_the_cli_takes_the_3class_config_by_name(tmp_path):
    """``--cfg_file pointpillars_kitti_3class`` builds the 3-class config
    at its full width (321 408 anchors a frame) before it looks for a
    checkpoint."""
    from papc_tpu_torch.detect import train as dtrain

    root = write_kitti(str(tmp_path / "kitti"), n_train=1, n_val=1,
                       num_cars=1, classes=NAMES)
    create_data.create_kitti_info_file(root, imageset_dir=f"{root}/ImageSets")
    create_data.create_reduced_point_cloud(root)
    lines = []
    with pytest.raises(SystemExit, match="no checkpoint"):
        dtrain.evaluate_checkpoint(
            cfg_file="pointpillars_kitti_3class",
            model_dir=str(tmp_path / "none"), log=lines.append,
            cfg_overrides=["EVAL_INPUT_READER.KITTI_ROOT_PATH", root],
            device="cpu")


# ------------------------------------------- KITTI data and evaluation

TREE = dict(n_train=4, n_val=2, num_cars=2, classes=tuple(NAMES))


def _prepare(create, root):
    create.create_kitti_info_file(root, imageset_dir=f"{root}/ImageSets")
    create.create_reduced_point_cloud(root)
    create.create_groundtruth_database(root)
    create.create_groundtruth_database(
        root, info_path=f"{root}/kitti_infos_val.pkl",
        database_save_path=f"{root}/gt_database_val",
        db_info_save_path=f"{root}/kitti_dbinfos_val.pkl")


@pytest.fixture(scope="module")
def trees3(tmp_path_factory):
    """The port's writer's 3-class tree twice, one prepared by JAX's
    ``create_data`` (on its C++ passes), one by the port's."""
    base = tmp_path_factory.mktemp("kitti_3class")
    roots = {k: str(base / k) for k in ("jax", "port")}
    for k, create in (("jax", jcreate), ("port", create_data)):
        write_kitti(roots[k], **TREE)
        _prepare(create, roots[k])
    return roots


def test_write_kitti_three_classes(tmp_path):
    """``classes`` adds each class's objects, of its anchors' size, with
    their points, drawn after the car scene: the first frame's cloud and
    labels begin with the car tree's of the same seed."""
    from papc_tpu_torch.detect.kitti.common import get_label_anno

    cars = write_kitti(str(tmp_path / "car"), n_train=2, n_val=1, num_cars=2)
    three = write_kitti(str(tmp_path / "three"), n_train=2, n_val=1,
                        num_cars=2, classes=NAMES)
    for i in range(3):
        stem = f"training/label_2/{i:06d}.txt"
        car = get_label_anno(f"{cars}/{stem}")
        anno = get_label_anno(f"{three}/{stem}")
        assert anno["name"].tolist() == ["Car"] * 2 + ["Pedestrian"] * 2 + [
            "Cyclist"] * 2
        if i == 0:
            np.testing.assert_array_equal(anno["location"][:2],
                                          car["location"])
        # camera-frame dimensions are (l, h, w)
        np.testing.assert_allclose(anno["dimensions"][2:4],
                                   [[0.8, 1.73, 0.6]] * 2, atol=1e-2)
        np.testing.assert_allclose(anno["dimensions"][4:],
                                   [[1.76, 1.73, 0.6]] * 2, atol=1e-2)
        c = np.fromfile(f"{cars}/training/velodyne/{i:06d}.bin", F32)
        t = np.fromfile(f"{three}/training/velodyne/{i:06d}.bin", F32)
        if i == 0:
            np.testing.assert_array_equal(t[:len(c)], c)
            assert len(t) > len(c)
    with pytest.raises(ValueError, match="Truck"):
        write_kitti(str(tmp_path / "x"), classes=("Car", "Truck"))


def _equal(a, b):
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


def test_create_data_over_three_classes_equals_jax(trees3):
    """The info files and the ground-truth database of a 3-class tree,
    prepared by each package: the ``.pkl`` files hold the same arrays, and
    the database holds every object of the three classes with its
    points."""
    import pickle

    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_dbinfos_train.pkl", "kitti_dbinfos_val.pkl"):
        with open(pathlib.Path(trees3["port"], name), "rb") as f:
            got = pickle.load(f)
        with open(pathlib.Path(trees3["jax"], name), "rb") as f:
            want = pickle.load(f)
        assert _equal(got, want), name
    with open(pathlib.Path(trees3["port"], "kitti_dbinfos_train.pkl"),
              "rb") as f:
        db = pickle.load(f)
    for name in NAMES:
        assert len(db[name]) == 8, name  # 4 frames, 2 objects each
        # the reduced clouds keep the camera's view: most objects keep all
        # their points, which the database sampler's filter (5) passes
        assert sum(d["num_points_in_gt"] >= 80 for d in db[name]) >= 4
    for sub in ("gt_database", "gt_database_val"):
        files = sorted(p.name for p in pathlib.Path(trees3["port"],
                                                    sub).iterdir())
        assert files == sorted(p.name for p in pathlib.Path(
            trees3["jax"], sub).iterdir())
        for f in files:
            assert (pathlib.Path(trees3["port"], sub, f).read_bytes()
                    == pathlib.Path(trees3["jax"], sub, f).read_bytes())


def _kitti_configs(root, db="kitti_dbinfos_train.pkl", extra=()):
    over = ["TRAIN_INPUT_READER.KITTI_ROOT_PATH", root,
            "EVAL_INPUT_READER.KITTI_ROOT_PATH", root,
            "TRAIN_INPUT_READER.DATABASE_SAMPLER.database_info_path", db]
    return tiny_configs(over + list(extra))


def _datasets(jcfg, cfg, training, seed=11):
    out = []
    for b, c in ((builders, cfg), (jbuilders, jcfg)):
        vg, _, ta = _parts(b, c)
        reader = c.TRAIN_INPUT_READER if training else c.EVAL_INPUT_READER
        out.append(b.build_dataset(c, reader, vg, ta, training=training,
                                   rng=np.random.RandomState(seed),
                                   log=lambda *a: None))
    return out


def test_dataset_over_three_classes_equals_jax(trees3, monkeypatch):
    """``KittiDataset`` training examples of the 3-class config (three
    sample groups, the point-count filter per class, ``gt_classes`` 1-3)
    at epochs 0 and 1, every key, with a database of the val frames'
    objects (as ``tests/test_torch_kitti.py`` holds JAX's C++ path):
    equal bit for bit to JAX's numpy paths (the port's), and to JAX's C++
    passes but at the anchors where JAX's two paths part. There the fused
    C++ assignment (``cc.iou2d_assign``, each IoU in float64 rounded to
    f32) and the numpy one (f32) break a forced match's near-tie
    differently; the port labels those anchors as the numpy path does.
    Then the eval examples and their batch. Positives of every class."""
    jcfg, cfg = _kitti_configs(trees3["port"], "kitti_dbinfos_val.pkl")
    port_ds, jax_ds = _datasets(jcfg, cfg, True)
    _, jax_numpy = _datasets(jcfg, cfg, True)
    sampled = {1: 0, 2: 0, 3: 0}
    parted = 0
    for epoch in (0, 1):
        for ds in (port_ds, jax_ds, jax_numpy):
            ds.set_epoch(epoch)
        for i in (2, 0, 3, 1):
            got, with_cc = port_ds[i], jax_ds[i]
            with monkeypatch.context() as m:
                m.setattr(cc, "available", lambda: False)
                want = jax_numpy[i]
            assert sorted(got) == sorted(want) == sorted(with_cc)
            for k in want:
                assert np.asarray(got[k]).dtype == np.asarray(
                    want[k]).dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            apart = np.flatnonzero(with_cc["labels"] != want["labels"])
            parted += len(apart)
            same = np.setdiff1d(np.arange(len(want["labels"])), apart)
            for k in want:
                g, w = np.asarray(got[k]), np.asarray(with_cc[k])
                if k in ("labels", "reg_targets", "reg_weights"):
                    g, w = g[same], w[same]
                np.testing.assert_array_equal(g, w, err_msg=k)
            for c in sampled:
                sampled[c] += int((got["labels"] == c).sum())
    assert all(v > 0 for v in sampled.values()), sampled
    assert parted <= 4, parted
    port_ev, jax_ev = _datasets(jcfg, cfg, False)
    got = collate_batch([port_ev[0], port_ev[1]])
    want = collate_batch([jax_ev[0], jax_ev[1]])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["anchors"].shape == (2, 6144, 7)


def test_evaluation_and_map_over_three_classes_equal_jax(net, trees3):
    """The eval set of a 3-class tree served by each package's
    ``evaluate`` from the same weights (per-class NMS): the annos' names,
    counts and arrays (boxes within 1e-4 of the camera frame's scale,
    scores within 1e-5), and the official result over Car, Pedestrian and
    Cyclist of the port's code against JAX's on the same annos: the same
    string, APs within 1e-9, all three classes in it. 900 detections a
    frame (of 300 candidates a class) at an IoU threshold of 0.1, so the
    untrained network's Car candidates leave room for the other
    classes."""
    from papc_tpu.detect import train as jtrain

    from papc_tpu_torch.detect import train as dtrain

    over = ["MODEL.POST_PROCESSING.nms_pre_max_size", "300",
            "MODEL.POST_PROCESSING.nms_post_max_size", "900",
            "MODEL.POST_PROCESSING.nms_iou_threshold", "0.1"]
    jcfg, cfg = _kitti_configs(trees3["port"], extra=over)
    port_ev, jax_ev = _datasets(jcfg, cfg, False)
    _, step, _ = _serving_pair(net, over)
    got = dtrain.evaluate(step, port_ev, cfg, log=lambda *a: None)
    jpc = jbuilders.build_predict_config(jcfg, net["jta"])
    state = TrainState.create(
        apply_fn=net["jmodel"].apply, params=net["variables"]["params"],
        batch_stats=net["variables"]["batch_stats"],
        tx=jbuilders.build_optimizer(jcfg.TRAIN_CONFIG.OPTIMIZER))
    want = jtrain.evaluate(
        net["jmodel"], state,
        jax_make_predict_step(net["jmodel"], jpc, net["jcoder"],
                              pillarize=net["jpil"]),
        jax_ev, jcfg, jpc, log=lambda *a: None)
    assert len(got) == len(want) == 2
    names = set()
    for g, w in zip(got, want):
        assert list(g) == list(w)
        np.testing.assert_array_equal(g["name"], w["name"])
        names |= set(g["name"].tolist())
        for k in ("location", "dimensions", "rotation_y", "alpha", "bbox"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5,
                                   atol=1e-5)
    assert names == set(NAMES)
    gt = [info["annos"] for info in port_ev.kitti_infos]
    mine = kitti_eval.get_official_eval_result(gt, want, NAMES, True)
    theirs = jeval.get_official_eval_result(gt, want, NAMES, True)
    assert mine[0] == theirs[0]
    for key in theirs[1]:
        for metric in theirs[1][key]:
            np.testing.assert_allclose(mine[1][key][metric],
                                       theirs[1][key][metric], rtol=0,
                                       atol=1e-9)
    result = dtrain.official_map(port_ev, got, cfg)
    for name in NAMES:
        assert f"{name} AP@" in mine[0] and f"{name} AP@" in result
