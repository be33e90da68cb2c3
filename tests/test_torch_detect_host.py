"""Host pillarize and the flat PFN through the port's detection path, on
the CPU, against the JAX package.

A miniature KITTI tree (``write_kitti``: 4 train and 2 val frames, then
the three ``create_data`` steps and a database of the val frames'
objects) at ``tests/test_detect_e2e.py``'s grid
(64 × 64 cells, 800 pillars of 40 points, 2 048 anchors, the narrow RPN
and K = 128 before the NMS of ``tests/test_torch_detect_loop.py``), with
``MODEL.DEVICE_PILLARIZE`` false: the host pillarizes each frame into the
flat points of the flat PFN (``MODEL.PFN_FLAT``, JAX's default) or into
the padded grid of the classic PFN.

- ``prep_pointcloud``'s host branch against JAX's (on its C++ streamer,
  as it runs where its library loads) bit for bit: every key of the
  training and the eval examples, also where a frame passes the pillar
  cap (the anchors mask then comes from the kept pillars, not from every
  occupied cell as on the device branch) or the flat cap
  ``MAX_POINTS_PER_FRAME``. There JAX's two flat paths part (its numpy
  fallback derives the flat view from the grid and keeps counting the
  points past the cap); the port follows the C++ one
  (``test_jax_flat_paths_part_past_the_cap``).
- One training step on a host batch, flat and grid, in float64 against
  JAX's step function run op by op in float64 (``train_step.impl`` on a
  ``TrainState`` with ``optax.sgd(1)``, so the parameters' moves are the
  gradients), from weights carried by ``convert``: the loss and every
  metric within 1e-6 relative, every parameter's gradient within 1e-5 of
  its largest and the BatchNorm running statistics within 1e-6 of their
  largest. The flat PFN takes its statistics in f32 on both sides (JAX's
  ``dtype=jnp.float32`` sums), so the flat step agrees to those (measured
  2.8e-7 / 3.1e-6 / 2.8e-7); the grid step agrees within 1e-13 but the
  PFN's statistics (3.3e-8).
- ``make_predict_step`` on host batches against JAX's, flat and grid.
- ``train()`` through the CLI with ``--set MODEL.DEVICE_PILLARIZE
  false``, flat and grid, then ``evaluate``.
"""

import functools
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from papc_tpu import cc
from papc_tpu.detect import builders as jbuilders
from papc_tpu.detect.config import cfg_from_list as jcfg_from_list
from papc_tpu.detect.kitti.preprocess import collate_batch as jax_collate
from papc_tpu.detect.train import make_detection_train_step as jax_make_step
from papc_tpu.detect.train import make_predict_step as jax_make_predict
from papc_tpu.train.trainer import TrainState

from papc_tpu_torch import convert
from papc_tpu_torch.data.synthetic_kitti import write_kitti
from papc_tpu_torch.detect import builders
from papc_tpu_torch.detect import train as dtrain
from papc_tpu_torch.detect.config import cfg_from_list, save_config
from papc_tpu_torch.detect.kitti import create_data
from papc_tpu_torch.detect.kitti.preprocess import collate_batch
from papc_tpu_torch.nn.layers import init_params
from tests.test_torch_kitti import _assert_examples_equal, _configs
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CLASSIC = ("SCATTER_S2D", "RPN_DEFERRED_UPS", "RPN_BATCH_FOLD")
NARROW = ["MODEL.BACKBONE.num_filters", "[16, 32, 64]",
          "MODEL.BACKBONE.num_upsample_filters", "[32, 32, 32]",
          "MODEL.POST_PROCESSING.nms_pre_max_size", "128",
          "MODEL.POST_PROCESSING.nms_post_max_size", "16",
          "MODEL.POST_PROCESSING.nms_score_threshold", "0.05"]
PFNS = {"flat": True, "grid": False}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_host"))
    write_kitti(root, n_train=4, n_val=2, num_cars=3)
    create_data.create_kitti_info_file(root, imageset_dir=f"{root}/ImageSets")
    create_data.create_reduced_point_cloud(root)
    create_data.create_groundtruth_database(
        root, info_path=f"{root}/kitti_infos_val.pkl",
        database_save_path=f"{root}/gt_database_val",
        db_info_save_path=f"{root}/kitti_dbinfos_val.pkl")
    return root


def host_configs(root, flat=True, extra=()):
    """JAX's and the port's configs of the tiny grid over ``root`` with
    host pillarize, ``MODEL.PFN_FLAT`` = ``flat`` and the overrides
    ``extra``; JAX's network in the reference form (its other rewrites
    off, the form the port runs). The database sampler draws the val
    frames' objects: JAX's C++ collision test lets a training frame's own
    object back in, which its numpy path and the port refuse
    (``tests/test_torch_kitti.py``)."""
    jcfg, cfg = _configs(root)
    over = ["MODEL.DEVICE_PILLARIZE", "False",
            "TRAIN_INPUT_READER.DATABASE_SAMPLER.database_info_path",
            "kitti_dbinfos_val.pkl", *extra]
    jcfg_from_list(jcfg, over)
    cfg_from_list(cfg, over)
    for c in (jcfg, cfg):
        c.MODEL["PFN_FLAT"] = flat
    for key in CLASSIC:
        jcfg.MODEL[key] = False
    return jcfg, cfg


def datasets(jcfg, cfg, training, seed=11):
    """``(port, jax)`` KITTI datasets of a reader."""
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


def _reader_caps(pillars=None, points=None):
    over = []
    for reader in ("TRAIN_INPUT_READER", "EVAL_INPUT_READER"):
        if pillars:
            over += [f"{reader}.MAX_NUMBER_OF_VOXELS", str(pillars)]
        if points:
            over += [f"{reader}.MAX_POINTS_PER_FRAME", str(points)]
    return over


# ------------------------------------------------------------- the prep

CAPS = {"under the caps": {}, "pillar cap": {"pillars": 300},
        "point cap": {"points": 1000}}


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("pfn", list(PFNS))
def test_host_prep_equals_jax(root, pfn, training, cap):
    assert cc.available()
    jcfg, cfg = host_configs(root, PFNS[pfn], _reader_caps(**CAPS[cap]))
    port_ds, jax_ds = datasets(jcfg, cfg, training)
    for i in range(len(port_ds)):
        got, want = port_ds[i], jax_ds[i]
        _assert_examples_equal(got, want)
        assert "points" not in got
        assert ("points_flat" in got) == PFNS[pfn]
        assert ("voxels" in got) != PFNS[pfn]
    k = int((got["coordinates"][:, 0] >= 0).sum())
    if cap == "pillar cap":
        assert k == 300
    if cap == "point cap" and pfn == "flat":
        assert (got["point_pillar"] >= 0).sum() == 1000
    _assert_examples_equal(collate_batch([port_ds[0], port_ds[1]]),
                           jax_collate([jax_ds[0], jax_ds[1]]))



# (voxel height, without_reflectivity): the pillar grid, whose doubled
# height leaves no slice; cells of a quarter of the height, with and
# without the reflectivity map
BEVS = {"pillars": (4, False), "slices": (1, False),
        "slices, no reflectivity": (1, True)}


@pytest.mark.parametrize("bev", list(BEVS))
def test_host_prep_bev_map_equals_jax(root, bev):
    """``prep_pointcloud(generate_bev=True)``: the example with its BEV
    maps (``points_to_bev`` on cells of half the side and twice the
    height) equals JAX's bit for bit, training and eval frames. On a
    pillar grid (one cell spans the range's height) the doubled height
    gives ``round(0.5) = 0`` slices, so no point lies inside the BEV grid
    and JAX's maps are all zero; the port's are the same."""
    height, without_reflectivity = BEVS[bev]
    jcfg, cfg = host_configs(root, True, [
        "VOXEL_GENERATOR.VOXEL_SIZE", f"[1.08, 1.24, {height}]"])
    for training in (True, False):
        port_ds, jax_ds = datasets(jcfg, cfg, training)
        for ds in (port_ds, jax_ds):
            ds._prep_func = functools.partial(
                ds._prep_func, generate_bev=True,
                without_reflectivity=without_reflectivity)
        for i in range(len(port_ds)):
            got, want = port_ds[i], jax_ds[i]
            _assert_examples_equal(got, want)
            maps = got["bev_map"]
            slices = 0 if height == 4 else 2
            assert maps.shape[0] == slices + 1 + (not without_reflectivity)
            assert maps.any() == (height != 4)


def test_host_anchors_mask_comes_from_the_kept_pillars(root):
    """At a cap of 300 pillars a frame holds more occupied cells than kept
    pillars: the host example's anchors mask (JAX's ``coordinates[:K]``)
    covers fewer anchors than the device example's (every occupied
    cell)."""
    jcfg, cfg = host_configs(root, True, _reader_caps(pillars=300))
    host, jax_host = datasets(jcfg, cfg, False)
    cfg_from_list(cfg, ["MODEL.DEVICE_PILLARIZE", "True"])
    device, _ = datasets(jcfg, cfg, False)
    a, b = host[0]["anchors_mask"], device[0]["anchors_mask"]
    np.testing.assert_array_equal(a, jax_host[0]["anchors_mask"])
    assert a.sum() < b.sum() and not (a & ~b).any()


def test_jax_flat_paths_part_past_the_cap(root, monkeypatch):
    """JAX's two flat paths agree under ``MAX_POINTS_PER_FRAME`` and part
    past it: its numpy fallback (``papc_tpu.cc.available`` off) cuts the
    grid's (pillar, slot) order at the cap and keeps counting the points
    past it in ``num_points``; its C++ streamer keeps the first accepted
    points in input order, and its counts agree with the flat view. The
    port follows the C++ streamer."""
    examples = {}
    for cap in (None, 1000):
        jcfg, cfg = host_configs(root, True, _reader_caps(points=cap))
        port_ds, jax_ds = datasets(jcfg, cfg, False)
        with monkeypatch.context() as m:
            m.setattr(cc, "available", lambda: False)
            numpy_path = jax_ds[0]
        examples[cap] = (port_ds[0], jax_ds[0], numpy_path)
    port, c_path, numpy_path = examples[None]
    _assert_examples_equal(numpy_path, c_path)
    _assert_examples_equal(port, c_path)
    port, c_path, numpy_path = examples[1000]
    _assert_examples_equal(port, c_path)
    n = int((c_path["point_pillar"] >= 0).sum())
    assert n == int((numpy_path["point_pillar"] >= 0).sum()) == 1000
    assert c_path["num_points"].sum() == n  # the C++ counts: the flat view
    assert numpy_path["num_points"].sum() > n  # numpy's count past the cap
    assert not np.array_equal(c_path["points_flat"],
                              numpy_path["points_flat"])


# ------------------------------------------------------- the training step

def _nested(flat: dict) -> dict:
    out = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def seeded_model(cfg, seed=0):
    """The port's network of ``cfg``, seeded, its running statistics
    moved away from (0, 1); and its variables as a flax tree."""
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    model = builders.build_network(cfg, vg, builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, coder))
    init_params(model, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed + 1)
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.copy_(torch.from_numpy(0.1 * rs.randn(*b.shape)))
        elif name.endswith("running_var"):
            b.copy_(torch.from_numpy(rs.uniform(0.5, 2.0, b.shape)))
    return model, _nested({k: np.array(v) for k, v in  # copies, not views
                           convert.state_dict_to_flax(
                               model.state_dict()).items()})


def host_batch(root, flat, training=True, extra=()):
    """Two frames of the host prep, collated, as ``example_to_batch``
    selects them."""
    jcfg, cfg = host_configs(root, flat, [*NARROW, *extra])
    port_ds, _ = datasets(jcfg, cfg, training)
    example = collate_batch([port_ds[0], port_ds[1]])
    return jcfg, cfg, example, dtrain.example_to_batch(example)


def cast(batch, dtype):
    return {k: v.astype(dtype) if v.dtype.kind == "f" else v
            for k, v in batch.items()}


def jax_sgd_step(jcfg, variables, batch, precision="fp32", dtype=None):
    """JAX's step function run op by op (``train_step.impl``) with SGD at
    rate 1: ``(metrics, grads, batch_stats)`` as flat numpy dicts."""
    jvg = jbuilders.build_voxel_generator(jcfg.VOXEL_GENERATOR)
    jta = jbuilders.build_target_assigner(
        jcfg.TARGET_ASSIGNER, jbuilders.build_box_coder(jcfg.BOX_CODER))
    jmodel = jbuilders.build_network(jcfg, jvg, jta)
    step, init_rm = jax_make_step(jmodel, jbuilders.build_loss_config(
        jcfg, jta), precision=precision)
    if dtype is not None:
        variables = jax.tree_util.tree_map(
            lambda x: np.asarray(x, dtype), variables)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    state = TrainState.create(apply_fn=jmodel.apply, params=v["params"],
                              batch_stats=v["batch_stats"],
                              tx=optax.sgd(1.0))
    after, metrics, _ = step.impl(state, {k: jnp.asarray(x)
                                          for k, x in batch.items()},
                                  init_rm())
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   state.params, after.params)
    return ({k: float(x) for k, x in metrics.items()}, convert.flatten(grads),
            convert.flatten(jax.tree_util.tree_map(np.asarray,
                                                   after.batch_stats)))


def port_step(cfg, model, batch, dtype=torch.float32, precision="fp32"):
    """One port step of ``model`` (moved to ``dtype``) on ``batch``:
    ``(metrics, grads, batch_stats)`` as flat numpy dicts, and the
    optimizer."""
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    model = model.to(dtype)
    opt, sched = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER,
                                          model.parameters())
    step, init_rm = dtrain.make_detection_train_step(
        model, builders.build_loss_config(cfg, coder), opt, sched,
        dtrain.make_pillarizer(vg, 800), device="cpu", precision=precision)
    metrics, _ = step(batch, init_rm())
    grads = convert.state_dict_to_flax({n: p.grad for n, p in
                                        model.named_parameters()})
    stats = convert.state_dict_to_flax(model.state_dict())
    return ({k: float(v) for k, v in metrics.items()},
            {k[len("params/"):]: v for k, v in grads.items()},
            {k[len("batch_stats/"):]: v for k, v in stats.items()
             if k.startswith("batch_stats/")}, opt)


@pytest.fixture(scope="module")
def x64_steps(root):
    """Per PFN: the port's float64 step and JAX's op-by-op float64 step
    on the same host batch (4 096 points a frame) and weights."""
    out = {}
    for pfn, flat in PFNS.items():
        jcfg, cfg, _, batch = host_batch(
            root, flat, extra=_reader_caps(points=4096))
        model, variables = seeded_model(cfg)
        b64 = cast(batch, np.float64)
        with jax.enable_x64(True):
            want = jax_sgd_step(jcfg, variables, b64, dtype=np.float64)
        out[pfn] = (port_step(cfg, model, b64, torch.float64)[:3], want,
                    batch)
    return out


@pytest.mark.parametrize("pfn", list(PFNS))
def test_host_train_step_float64_equals_jax_op_by_op(x64_steps, pfn):
    (metrics, grads, stats), (w_metrics, w_grads, w_stats), batch = \
        x64_steps[pfn]
    assert ("points_flat" in batch) == PFNS[pfn]
    assert set(metrics) == set(w_metrics)
    for k, v in w_metrics.items():
        assert metrics[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k
    assert w_metrics["num_pos"] > 0
    assert set(grads) == set(w_grads)
    for k, g in w_grads.items():
        np.testing.assert_allclose(grads[k], g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)
        assert np.abs(g).max() > 0, k
    assert set(stats) == set(w_stats)
    for k, v in w_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=0,
                                   atol=1e-6 * np.abs(v).max(), err_msg=k)


# --------------------------------------------------------------- serving

@pytest.mark.parametrize("pfn", list(PFNS))
def test_host_predictions_equal_jax(root, pfn):
    """``make_predict_step`` on a host eval batch against JAX's jitted
    ``make_predict_step`` (no pillarizer: the batch carries the pillars),
    seeded weights with moved running statistics."""
    jcfg, cfg, example, batch = host_batch(root, PFNS[pfn], training=False)
    model, variables = seeded_model(cfg, seed=3)
    jvg = jbuilders.build_voxel_generator(jcfg.VOXEL_GENERATOR)
    jcoder = jbuilders.build_box_coder(jcfg.BOX_CODER)
    jta = jbuilders.build_target_assigner(jcfg.TARGET_ASSIGNER, jcoder)
    jmodel = jbuilders.build_network(jcfg, jvg, jta)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    state = TrainState.create(apply_fn=jmodel.apply, params=v["params"],
                              batch_stats=v["batch_stats"],
                              tx=optax.sgd(1.0))
    want = jax_make_predict(jmodel, jbuilders.build_predict_config(
        jcfg, jta), jcoder)(state, {k: jnp.asarray(x)
                                    for k, x in batch.items()})
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    got = dtrain.make_predict_step(
        model, builders.build_predict_config(cfg, coder), coder,
        dtrain.make_pillarizer(vg, 800), device="cpu")(batch)
    for k in ("valid", "label_preds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert (got["valid"].sum(-1) > 0).all()


# --------------------------------------------------------- train(), the CLI

@pytest.mark.parametrize("pfn", list(PFNS))
def test_train_cli_with_host_pillarize(root, tmp_path, pfn):
    """``python -m papc_tpu_torch.detect.train`` with ``--set
    MODEL.DEVICE_PILLARIZE False`` (the flat PFN, JAX's default; the
    classic one with ``PFN_FLAT`` false in the JSON config): three steps on
    the CPU with a finite loss, a checkpoint, then ``evaluate``."""
    _, cfg = host_configs(root, PFNS[pfn], NARROW)
    cfg_from_list(cfg, ["MODEL.DEVICE_PILLARIZE", "True"])  # the CLI sets it
    if pfn == "flat":
        del cfg.MODEL["PFN_FLAT"]  # JAX's default
    path = str(tmp_path / "cfg.json")
    save_config(cfg, path)
    model_dir = str(tmp_path / "model")
    args = ["--cfg_file", path, "--model_dir", model_dir, "--device", "cpu",
            "--set", "MODEL.DEVICE_PILLARIZE", "False"]
    assert dtrain.main(["train", *args, "--max_steps", "3",
                        "--display_step", "1"]) == 0
    lines = pathlib.Path(model_dir, "log.txt").read_text().splitlines()
    losses = [float(line.split("loss=")[1].split(",")[0]) for line in lines]
    assert len(losses) == 3 and np.isfinite(losses).all()
    index = json.loads(pathlib.Path(model_dir, "checkpoints.json")
                       .read_text())
    assert index["latest_ckpt"]["pointpillars"] == "pointpillars-3"
    saved = json.loads(pathlib.Path(model_dir, "pipeline.config")
                       .read_text())
    assert saved["MODEL"]["DEVICE_PILLARIZE"] is False
    res = str(tmp_path / "res")
    assert dtrain.main(["evaluate", *args, "--result_path", res]) == 0
    assert len(os.listdir(res)) == 2
