"""The port's detection loop on the CPU: the worker pool, the indexed
checkpoint manager (against JAX's on the same saves), ``train()`` with
its resume, periodic eval and crash save, ``evaluate_checkpoint``, the
CLI, and the refusals (a YAML config, ``SCAN_STEPS``, an unknown
precision).

The loop runs on a miniature KITTI tree (``write_kitti``, 6 train and 2
val frames) at ``tests/test_detect_e2e.py``'s grid: 64 × 64 cells, 800
pillars of 40 points, 2 048 anchors, a narrow RPN. JAX's ``train()`` is
not run here; the batches, annos and mAP it feeds are held against JAX
in ``tests/test_torch_kitti.py`` and ``tests/test_torch_kitti_eval.py``.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from papc_tpu.train import checkpoint as jckpt

from papc_tpu_torch.data.synthetic_kitti import write_kitti
from papc_tpu_torch.data.workers import SamplePool
from papc_tpu_torch.detect import builders
from papc_tpu_torch.detect import train as dtrain
from papc_tpu_torch.detect.config import (car_config, cfg_from_file,
                                          cfg_from_list, save_config)
from papc_tpu_torch.detect.kitti import create_data
from papc_tpu_torch.train import checkpoint as ckpt
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

TINY = ["VOXEL_GENERATOR.VOXEL_SIZE", "[1.08, 1.24, 4]",
        "VOXEL_GENERATOR.MAX_VOXELS", "800",
        "VOXEL_GENERATOR.MAX_NUMBER_OF_POINTS_PER_VOXEL", "40",
        "MODEL.BACKBONE.num_filters", "[16, 32, 64]",
        "MODEL.BACKBONE.num_upsample_filters", "[32, 32, 32]",
        "MODEL.POST_PROCESSING.nms_pre_max_size", "128",
        "MODEL.POST_PROCESSING.nms_post_max_size", "16",
        "MODEL.POST_PROCESSING.nms_score_threshold", "0.05",
        "TRAIN_INPUT_READER.MAX_NUMBER_OF_VOXELS", "800",
        "EVAL_INPUT_READER.MAX_NUMBER_OF_VOXELS", "800"]


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_loop"))
    write_kitti(root, n_train=6, n_val=2, num_cars=2)
    create_data.create_kitti_info_file(root, imageset_dir=f"{root}/ImageSets")
    create_data.create_reduced_point_cloud(root)
    create_data.create_groundtruth_database(root, used_classes=["Car"])
    return root


def tiny_config(root, *extra):
    cfg = car_config()
    cfg_from_list(cfg, TINY + ["TRAIN_INPUT_READER.KITTI_ROOT_PATH", root,
                               "EVAL_INPUT_READER.KITTI_ROOT_PATH", root,
                               *extra])
    gen = cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS[0].anchor_generator_stride
    gen.strides = [2.16, 2.48, 0.0]
    gen.offsets = [1.08, -38.44, -1.78]
    return cfg


@pytest.fixture(scope="module")
def cfg_file(kitti_root, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cfg") / "tiny.json")
    save_config(tiny_config(kitti_root), path)
    return path


# ----------------------------------------------------------- the pool

def _dataset(root):
    cfg = tiny_config(root)
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    ta = builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, builders.build_box_coder(cfg.BOX_CODER))
    ds = builders.build_dataset(cfg, cfg.TRAIN_INPUT_READER, vg, ta,
                                training=True,
                                rng=np.random.RandomState(0),
                                log=lambda *a: None)
    ds.enable_per_item_sampler_seeding(True)
    return ds


def _batches(ds, pool, epoch):
    return list(dtrain._iter_batches(ds, 2, True, np.random.RandomState(5),
                                     pool=pool, epoch=epoch, max_batches=2))


def test_sample_pool_batches_do_not_depend_on_the_worker_count(kitti_root,
                                                              monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    ds = _dataset(kitti_root)
    want = {e: _batches(ds, None, e) for e in (1, 2)}
    assert len(want[1]) == 2
    assert not all(np.array_equal(a["points"], b["points"])
                   for a, b in zip(want[1], want[2]))
    for workers in (1, 2):
        with SamplePool(ds, workers) as pool:
            assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
            shipped = pool._path  # the dataset's one pickle for the workers
            assert os.path.exists(shipped)
            for epoch in (1, 2):
                for got, w in zip(_batches(ds, pool, epoch), want[epoch]):
                    assert sorted(got) == sorted(w)
                    for k in w:
                        np.testing.assert_array_equal(got[k], w[k],
                                                      err_msg=k)
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "3"
        assert not os.path.exists(shipped)


# ------------------------------------------------------- checkpoints

@pytest.mark.parametrize("keep_latest", [True, False],
                         ids=["keep latest", "keep largest steps"])
def test_checkpoint_index_and_gc_equal_jax(tmp_path, keep_latest):
    steps = [5, 2, 9, 7, 3, 11]
    for pkg, out in ((ckpt, "port"), (jckpt, "jax")):
        d = str(tmp_path / out)
        for s in steps:
            pkg.save(d, "pointpillars", {"w": np.full(3, s, np.float32)}, s,
                     max_to_keep=3, keep_latest=keep_latest)
            pkg.save(d, "other", {"w": np.zeros(1, np.float32)}, s,
                     max_to_keep=2)
    index = [json.loads((tmp_path / o / "checkpoints.json").read_text())
             for o in ("port", "jax")]
    assert index[0] == index[1]
    kept = index[0]["all_ckpts"]["pointpillars"]
    assert kept == (["pointpillars-7", "pointpillars-3", "pointpillars-11"]
                    if keep_latest else
                    ["pointpillars-9", "pointpillars-7", "pointpillars-11"])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    d = str(tmp_path / "port")
    assert ckpt.latest_checkpoint(d, "pointpillars").endswith(
        "pointpillars-11")
    np.testing.assert_array_equal(
        ckpt.try_restore_latest(d, "pointpillars")["w"], [11, 11, 11])
    assert ckpt.try_restore_latest(d, "missing") is None
    assert not [p for p in os.listdir(d) if ".tmp-" in p or ".old-" in p]


def test_training_state_round_trip(kitti_root):
    cfg = tiny_config(kitti_root)
    _, coder, _, model, _ = dtrain._build(cfg, 3, torch.device("cpu"))
    opt, sched = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER,
                                          model.parameters())
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    sched.step()
    for name, b in model.named_buffers():
        if b.is_floating_point():
            b.add_(0.5)
    arrays = ckpt.training_arrays(model, opt, sched, 1)
    _, _, _, fresh, _ = dtrain._build(cfg, 4, torch.device("cpu"))
    opt2, sched2 = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER,
                                            fresh.parameters())
    assert ckpt.restore_training(arrays, fresh, opt2, sched2) == 1
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert sched2.last_epoch == 1
    for p, q in zip(model.parameters(), fresh.parameters()):
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][name], opt2.state[q][name])


# ------------------------------------------------------------- train()

def test_train_logs_saves_and_evaluates(kitti_root, tmp_path, monkeypatch):
    model_dir = str(tmp_path / "model")
    cfg = tiny_config(kitti_root, "TRAIN_CONFIG.STEPS_PER_EVAL", "3")
    path = str(tmp_path / "cfg.json")
    save_config(cfg, path)
    # every evaluation serves the model in eval mode: BatchNorm reads
    # its running statistics and leaves them, and its buffers too
    served, evaluated = [], []
    make_predict_step, evaluate = dtrain.make_predict_step, dtrain.evaluate

    def spy_make_predict_step(model, *args, **kwargs):
        served.append(model)
        return make_predict_step(model, *args, **kwargs)

    def spy_evaluate(*args, **kwargs):
        before = {k: v.clone() for k, v in served[0].state_dict().items()}
        out = evaluate(*args, **kwargs)
        for k, v in served[0].state_dict().items():
            assert torch.equal(v, before[k]), k
        assert not served[0].training
        evaluated.append(len(out))
        return out

    monkeypatch.setattr(dtrain, "make_predict_step", spy_make_predict_step)
    monkeypatch.setattr(dtrain, "evaluate", spy_evaluate)
    logs = []
    state, annos = dtrain.train(cfg_file=path, model_dir=model_dir,
                                max_steps=6, display_step=2,
                                result_path=str(tmp_path / "res"),
                                log=logs.append, device="cpu")
    assert state.step == 6 and state.scheduler.last_epoch == 6
    assert cfg_from_file(os.path.join(model_dir, "pipeline.config")) == cfg
    index = json.loads(pathlib.Path(model_dir, "checkpoints.json")
                       .read_text())
    assert index["latest_ckpt"]["pointpillars"] == "pointpillars-6"
    assert index["all_ckpts"]["pointpillars"] == [
        "pointpillars-3", "pointpillars-6", "pointpillars-6"]
    lines = [line for line in logs if "loss=" in line]
    assert [int(line.split("step=")[1].split(",")[0]) for line in lines] == [
        2, 4, 6]
    assert all("rpn_prec@0.5=" in line and "steptime=" in line
               for line in lines)
    assert pathlib.Path(model_dir, "log.txt").read_text().splitlines() == \
        lines
    assert sum("Car AP@0.70, 0.70, 0.70:" in line for line in logs) == 2
    assert len(annos) == 2 and all("score" in a for a in annos)
    assert len(os.listdir(tmp_path / "res")) == 2
    assert evaluated == [2, 2, 2]  # at steps 3 and 6 and on finishing
    # the annos of the eval on finish are those of the final checkpoint
    # served by a model that never trained
    again, _ = dtrain.evaluate_checkpoint(cfg_file=path, model_dir=model_dir,
                                          with_map=False,
                                          log=lambda line: None,
                                          device="cpu")
    assert len(again) == len(annos)
    for a, b in zip(annos, again):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_resumes_from_four_steps_to_eight(kitti_root, cfg_file,
                                                tmp_path):
    model_dir = str(tmp_path / "model")
    state, annos = dtrain.train(cfg_file=cfg_file, model_dir=model_dir,
                                max_steps=4, display_step=2,
                                eval_on_finish=False, log=lambda line: None,
                                device="cpu")
    assert state.step == 4 and annos is None
    saved = ckpt.try_restore_latest(model_dir, "pointpillars")
    # resumed at its own step, train() takes no step: the weights,
    # statistics and optimizer state come back exactly
    ckpt.save(str(tmp_path / "c"), "pointpillars", saved, 4)
    logs = []
    state, _ = dtrain.train(cfg_file=cfg_file, model_dir=str(tmp_path / "c"),
                            max_steps=4, eval_on_finish=False,
                            log=logs.append, device="cpu")
    assert "resumed from step 4" in logs and state.step == 4
    again = ckpt.training_arrays(state.model, state.optimizer,
                                 state.scheduler, state.step)
    assert sorted(again) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(again[k], saved[k], err_msg=k)
    logs = []
    state, _ = dtrain.train(cfg_file=cfg_file, model_dir=model_dir,
                            max_steps=8, display_step=2,
                            eval_on_finish=False, log=logs.append,
                            device="cpu")
    assert "resumed from step 4" in logs
    assert [line.split("step=")[1].split(",")[0] for line in logs
            if "loss=" in line] == ["6", "8"]
    assert state.step == 8 and state.scheduler.last_epoch == 8
    arrays = ckpt.try_restore_latest(model_dir, "pointpillars")
    assert int(arrays["step"]) == 8 and int(arrays["opt_state/count"]) == 8
    moved = [k for k in saved if k.startswith("params/")
             and not np.array_equal(saved[k], arrays[k])]
    assert moved  # the resumed run went on from the step-4 weights
    assert json.loads(pathlib.Path(model_dir, "checkpoints.json")
                      .read_text())["all_ckpts"]["pointpillars"] == [
        "pointpillars-4", "pointpillars-8"]


def test_train_saves_on_a_crash(kitti_root, cfg_file, tmp_path):
    model_dir = str(tmp_path / "model")

    def log(line):
        if "step=4," in line:
            raise RuntimeError("the log failed")

    with pytest.raises(RuntimeError, match="the log failed"):
        dtrain.train(cfg_file=cfg_file, model_dir=model_dir, max_steps=6,
                     display_step=2, log=log, device="cpu")
    index = json.loads(pathlib.Path(model_dir, "checkpoints.json")
                       .read_text())
    assert index["all_ckpts"]["pointpillars"] == ["pointpillars-4"]


def test_evaluate_checkpoint_and_the_cli(kitti_root, cfg_file, tmp_path,
                                         capsys):
    model_dir = str(tmp_path / "model")
    with pytest.raises(SystemExit, match="no checkpoint"):
        dtrain.evaluate_checkpoint(cfg_file=cfg_file, model_dir=model_dir,
                                   log=lambda line: None, device="cpu")
    assert dtrain.main(["train", "--cfg_file", cfg_file, "--model_dir",
                        model_dir, "--max_steps", "2", "--display_step", "1",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step=1," in out and "step=2," in out
    res = tmp_path / "res"
    assert dtrain.main(["evaluate", "--cfg_file", cfg_file, "--model_dir",
                        model_dir, "--result_path", str(res),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "evaluating checkpoint at step 2" in out and "Car AP@0.70" in out
    assert sorted(os.listdir(res)) == ["000006.txt", "000007.txt"]
    logs = []
    annos, result = dtrain.evaluate_checkpoint(
        cfg_file=cfg_file, model_dir=model_dir, log=logs.append,
        device="cpu", cfg_overrides=["EVAL_INPUT_READER.BATCH_SIZE", "3"])
    assert len(annos) == 2 and "3d   AP:" in result and result in logs


def test_predict_frames_gives_a_detection_dict_a_frame(kitti_root, cfg_file):
    cfg = cfg_from_file(cfg_file)
    _, coder, ta, model, pillarize = dtrain._build(cfg, 0,
                                                   torch.device("cpu"))
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    ds = builders.build_dataset(cfg, cfg.EVAL_INPUT_READER, vg, ta,
                                training=False, log=lambda *a: None)
    step = dtrain.make_predict_step(
        model, builders.build_predict_config(cfg, coder), coder, pillarize,
        device="cpu")
    dets = dtrain.predict_frames(step, ds, cfg, log=lambda line: None)
    assert len(dets) == 2 and dets[0]["box3d_lidar"].shape == (16, 7)
    annos = dtrain.evaluate(step, ds, cfg, log=lambda line: None)
    # annos keep the valid detections inside post_center_limit_range
    lim = np.asarray(cfg.MODEL.POST_PROCESSING.post_center_limit_range)
    for a, d in zip(annos, dets):
        xyz = d["box3d_lidar"][d["valid"], :3]
        inside = ((xyz >= lim[:3]) & (xyz <= lim[3:])).all(1)
        assert len(a["name"]) == int(inside.sum()) > 0


def test_refusals(kitti_root, cfg_file, tmp_path):
    yaml_file = tmp_path / "car.yaml"
    yaml_file.write_text("MODEL: {}\n")
    with pytest.raises(ValueError, match="JSON, not YAML"):
        dtrain.train(cfg_file=str(yaml_file), model_dir=str(tmp_path / "a"),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        dtrain.train(cfg_file=cfg_file, model_dir=str(tmp_path / "b"),
                     cfg_overrides=["TRAIN_CONFIG.SCAN_STEPS", "2"],
                     device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        dtrain.train(cfg_file=cfg_file, model_dir=str(tmp_path / "d"),
                     cfg_overrides=["TRAIN_CONFIG.PRECISION", "'fp16'"],
                     max_steps=1, device="cpu")
    assert not os.path.exists(tmp_path / "a")
