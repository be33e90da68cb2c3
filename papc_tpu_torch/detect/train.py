"""Detection training and serving, the loop and the CLI (counterpart of
``papc_tpu/detect/train.py``).

Training: a batch of frames with their targets → pillars (voxelized on
the device from the raw clouds, or the host's: the padded grid, or the
flat points of the flat PFN) → PillarFeatureNet → BEV scatter → RPN in
training mode → ``compute_loss`` → backward → one optimizer step at the
scheduled rate → running accuracy and precision / recall
(``make_detection_train_step``). Serving: frames → pillars → the network
in eval mode → decode → top K → NMS kernel → fixed-size detections
(``make_predict_step``); with ``multiclass_nms`` (the 3-class config)
the top K of each class and one NMS launch over every frame and class of
the batch. Both steps take ``precision="bf16"`` (``TRAIN_CONFIG.
PRECISION``): the network on bf16 copies of the f32 parameters and
inputs, the loss, decode and NMS in f32. No kernel of the port runs in
either step but the NMS.

:func:`train` is the KITTI loop over ``builders.build_dataset``: it
writes ``pipeline.config`` (JSON), resumes from the model directory's
latest checkpoint (``train/checkpoint.py``), prepares batches inline or
in a worker pool (``TRAIN_INPUT_READER.NUM_WORKERS``,
``data/workers.py``), logs a line of metrics every ``display_step`` steps
into ``log.txt``, saves by time, evaluates with the official mAP every
``STEPS_PER_EVAL`` steps, saves on a crash and evaluates on finishing.
:func:`evaluate` turns the detections into KITTI annos,
:func:`evaluate_checkpoint` serves the latest checkpoint with the mAP,
:func:`predict_frames` returns the raw detections. The CLI::

    python -m papc_tpu_torch.detect.train train --model_dir D \
        --set TRAIN_INPUT_READER.KITTI_ROOT_PATH ROOT \
        EVAL_INPUT_READER.KITTI_ROOT_PATH ROOT
    python -m papc_tpu_torch.detect.train evaluate --model_dir D --set ...

(``--cfg_file`` takes a shipped config's name, ``pointpillars_kitti_car``
or ``pointpillars_kitti_3class``, or a JSON config such as a run's
``pipeline.config``; ``--device cpu`` runs on the host; ``--set
MODEL.DEVICE_PILLARIZE False`` pillarizes on the host, ``--set
TRAIN_CONFIG.PRECISION bf16`` trains in bf16.) Not ported:
``SCAN_STEPS > 1`` (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import time
from collections.abc import Callable, Mapping

import numpy as np
import torch

from papc_tpu_torch.detect import box_np, builders
from papc_tpu_torch.detect.config import (cfg_from_file, cfg_from_list,
                                          save_config)
from papc_tpu_torch.detect.detector import (compute_loss, decode_raw,
                                            predict, predict_multiclass)
from papc_tpu_torch.detect.kitti import common as kitti
from papc_tpu_torch.detect.kitti.preprocess import collate_batch
from papc_tpu_torch.nn.layers import init_params
from papc_tpu_torch.ops.voxelize import voxelize
from papc_tpu_torch.train import checkpoint as ckpt_lib
from papc_tpu_torch.train.precision import (bf16_call, cast_floating,
                                             is_bf16)
from papc_tpu_torch.train.running_metrics import (AccuracyState,
                                                  PrecisionRecallState)
from papc_tpu_torch.utils.profiling import StepTimer

MODEL_NAME = "pointpillars"  # the checkpoints' name in checkpoints.json


def flat_nested_json_dict(json_dict, sep=".") -> dict:
    """Nested dicts flattened to dotted keys, for the metrics line."""
    out = {}

    def _flat(d, prefix=""):
        for k, v in d.items():
            key = f"{prefix}{sep}{k}" if prefix else str(k)
            if isinstance(v, dict):
                _flat(v, key)
            else:
                out[key] = v

    _flat(json_dict)
    return out


def example_to_batch(example: Mapping) -> dict:
    """The arrays of a collated example that the steps read: the raw
    points and their mask (device pillarize), or the host's pillars
    (``num_points``, ``coordinates`` and either ``points_flat`` with
    ``point_pillar`` or ``voxels``); the anchors, the targets where
    present and the anchors mask where present."""
    if "points" in example:
        batch = {"points": np.asarray(example["points"], np.float32),
                 "points_mask": np.asarray(example["points_mask"], bool)}
    else:
        batch = {"num_points": np.asarray(example["num_points"], np.int32),
                 "coordinates": np.asarray(example["coordinates"], np.int32)}
        if "points_flat" in example:
            batch["points_flat"] = np.asarray(example["points_flat"],
                                              np.float32)
            batch["point_pillar"] = np.asarray(example["point_pillar"],
                                               np.int32)
        else:
            batch["voxels"] = np.asarray(example["voxels"], np.float32)
    batch["anchors"] = np.asarray(example["anchors"], np.float32)
    if "labels" in example:
        batch["labels"] = np.asarray(example["labels"], np.int32)
        batch["reg_targets"] = np.asarray(example["reg_targets"], np.float32)
    if "anchors_mask" in example:
        batch["anchors_mask"] = np.asarray(example["anchors_mask"], bool)
    return batch


def make_pillarizer(voxel_generator, max_voxels: int) -> Callable:
    """``pillarize(batch)`` → ``(voxels [B, V, P, D] or None, num_points
    [B, V], coords [B, V, 3])``: pillarized on the device from a batch's
    ``points [B, N, D]`` and ``points_mask [B, N]``, or the host's
    pillars of a batch without raw points (``voxels``, None with flat
    points, ``num_points``, ``coordinates``)."""
    vsize = tuple(float(v) for v in voxel_generator.voxel_size)
    prange = tuple(float(v) for v in voxel_generator.point_cloud_range)
    grid = tuple(int(g) for g in voxel_generator.grid_size)
    max_points = int(voxel_generator.max_num_points)

    def pillarize(batch):
        if "points" not in batch:
            return (batch.get("voxels"), batch["num_points"],
                    batch["coordinates"])
        out = voxelize(batch["points"], batch["points_mask"], vsize, prange,
                       grid, max_points, max_voxels)
        return out.voxels, out.num_points, out.coords

    return pillarize


def batch_to_device(batch: Mapping, device: torch.device) -> dict:
    """Numpy arrays or tensors → tensors on ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def head_maps(model: torch.nn.Module, batch: Mapping, pillarize: Callable,
              bf16: bool) -> dict:
    """The head maps of ``batch``: the network on the pillars from
    ``pillarize``, and on the flat points where the batch carries them;
    with ``bf16`` by :func:`~papc_tpu_torch.train.precision.bf16_call`
    (bf16 copies of the parameters and of the float inputs), the maps
    returned in f32, as JAX's ``loss_fn`` and ``_apply`` do."""
    inputs = tuple(pillarize(batch))
    if "points_flat" in batch:
        inputs += (batch["points_flat"], batch["point_pillar"])
    if not bf16:
        return model(*inputs)
    return cast_floating(bf16_call(model, *inputs), torch.float32)


def make_detection_train_step(model: torch.nn.Module, loss_cfg,
                              optimizer: torch.optim.Optimizer, scheduler,
                              pillarize: Callable,
                              device: str | torch.device = "cuda",
                              precision: str = "fp32"):
    """``(train_step, init_running_metrics)``. ``train_step(batch, rm)``
    trains ``model`` in place for one step and returns ``(metrics, rm)``:
    ``compute_loss``'s metrics and ``rpn_acc`` as tensors on ``device``,
    and the running metrics ``rm`` (``{"acc", "pr"}``, from
    ``init_running_metrics()``) updated by this step's class logits.

    ``batch`` holds numpy arrays or tensors (``example_to_batch``'s): the
    input of ``pillarize`` (``make_pillarizer``: raw ``points`` and
    ``points_mask``, or the host's pillars, flat or padded), ``anchors
    [B, A, 7]``, ``labels [B, A]`` and ``reg_targets [B, A, code]``.
    ``optimizer`` and ``scheduler`` are ``builders.build_optimizer``'s:
    the step's rate is the schedule at the steps taken before it, as in
    optax. The network trains in f32, its convolutions with TF32 off
    forward and backward (``nn.layers.conv``). ``precision="bf16"`` is
    JAX's bf16 step: the forward and backward on bf16 copies of the f32
    parameters and inputs, the loss on the f32-cast head maps; the
    parameters take their gradients in f32, and they, the optimizer's
    state and the BatchNorm running statistics stay f32."""
    bf16 = is_bf16(precision)
    device = torch.device(device)
    model = model.to(device).train()
    ncls = (loss_cfg.num_class if loss_cfg.encode_background_as_zeros
            else loss_cfg.num_class + 1)

    def train_step(batch: Mapping, rm: dict):
        batch = batch_to_device(batch, device)
        model.train()
        preds = head_maps(model, batch, pillarize, bf16)
        labels = batch["labels"]
        loss, metrics = compute_loss(preds, labels, batch["reg_targets"],
                                     batch["anchors"], loss_cfg)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        scheduler.step()
        cls_preds = preds["cls_preds"].detach().reshape(labels.shape[0], -1,
                                                        ncls)
        rm = {"acc": rm["acc"].update(labels, cls_preds),
              "pr": rm["pr"].update(labels, cls_preds)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["rpn_acc"] = rm["acc"].value
        return metrics, rm

    def init_running_metrics() -> dict:
        return {"acc": AccuracyState.create(device),
                "pr": PrecisionRecallState.create(device=device)}

    return train_step, init_running_metrics


def make_predict_step(model: torch.nn.Module, predict_cfg, box_coder,
                      pillarize: Callable,
                      device: str | torch.device = "cuda",
                      precision: str = "fp32",
                      impl: str | None = None) -> Callable:
    """``predict_step(batch)`` → ``{"box3d_lidar" [B, post, 7], "scores",
    "label_preds", "valid" [B, post]}`` on ``device``.

    ``batch`` holds numpy arrays or tensors: the input of ``pillarize``
    (raw points or the host's pillars, flat or padded), ``anchors [B, A,
    7]`` and optionally ``anchors_mask``. With ``predict_cfg.multiclass_nms`` the detections
    come from ``detector.predict_multiclass`` (per class, one NMS launch a
    batch), else from ``detector.predict``. ``precision="bf16"`` runs the
    network on bf16 copies of the parameters and inputs; the decode and
    the NMS take its head maps cast to f32. Each call puts the model
    in eval mode (a train step between calls puts it back in train
    mode), so BatchNorm reads its running statistics and leaves them
    as they are. It runs under :func:`torch.inference_mode`, its convolutions in
    full float32: inside ``torch.backends.cudnn.flags(enabled=True,
    allow_tf32=False)``, a context local to the call (PyTorch's own
    default lets cuDNN use TF32). ``impl`` goes to the NMS op: ``None``
    launches the kernel on a CUDA device."""
    bf16 = is_bf16(precision)
    device = torch.device(device)
    model = model.to(device).eval()

    def predict_step(batch: Mapping) -> dict:
        batch = batch_to_device(batch, device)
        model.eval()
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            preds = head_maps(model, batch, pillarize, bf16)
            if predict_cfg.multiclass_nms:
                return predict_multiclass(
                    *decode_raw(preds, batch["anchors"], box_coder.decode,
                                predict_cfg), predict_cfg,
                    anchors_mask=batch.get("anchors_mask"), impl=impl)
            return predict(preds, batch["anchors"], box_coder.decode,
                           predict_cfg, anchors_mask=batch.get("anchors_mask"),
                           impl=impl)

    return predict_step


def _predicted_batches(predict_step: Callable, eval_ds, batch_size: int):
    """``(example, detections, n)`` for each batch of ``eval_ds``: the
    collated examples, the detections as numpy and the real frames in
    it (the last batch is padded by repeating its last frame)."""
    n = len(eval_ds)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        real = len(idx)
        idx = idx + [idx[-1]] * (batch_size - real)
        example = collate_batch([eval_ds[i] for i in idx])
        dets = predict_step(example_to_batch(example))
        yield example, {k: v.cpu().numpy() for k, v in dets.items()}, real


def predict_frames(predict_step: Callable, eval_ds, cfg,
                   log: Callable[[str], None] = print) -> list[dict]:
    """Prediction over ``eval_ds`` (``len`` and ``eval_ds[i]`` → example
    dict) in batches of ``EVAL_INPUT_READER.BATCH_SIZE`` → one detection
    dict of numpy arrays per frame."""
    dets_out = []
    for _, dets, real in _predicted_batches(
            predict_step, eval_ds, int(cfg.EVAL_INPUT_READER.BATCH_SIZE)):
        for row in range(real):
            dets_out.append({k: v[row] for k, v in dets.items()})
    log(f"predicted {len(dets_out)} frames")
    return dets_out


def predictions_to_kitti_annos(dets: dict, examples: dict, class_names,
                               center_limit_range=None) -> list[dict]:
    """Fixed-size detections of a batch (numpy) → one KITTI anno dict a
    frame, in the camera frame with the image boxes clipped to the
    image (the reference's ``predict_kitti_to_anno``)."""
    annos = []
    B = dets["box3d_lidar"].shape[0]
    for i in range(B):
        valid = np.asarray(dets["valid"][i])
        boxes_lidar = np.asarray(dets["box3d_lidar"][i])[valid]
        scores = np.asarray(dets["scores"][i])[valid]
        labels = np.asarray(dets["label_preds"][i])[valid]
        rect = np.asarray(examples["rect"][i])
        Trv2c = np.asarray(examples["Trv2c"][i])
        P2 = np.asarray(examples["P2"][i])
        img_shape = np.asarray(examples["image_shape"][i])
        image_idx = int(np.asarray(examples["image_idx"][i]))

        if center_limit_range is not None and len(boxes_lidar):
            lim = np.asarray(center_limit_range)
            keep = ~(np.any(boxes_lidar[:, :3] < lim[:3], axis=1)
                     | np.any(boxes_lidar[:, :3] > lim[3:], axis=1))
            boxes_lidar = boxes_lidar[keep]
            scores = scores[keep]
            labels = labels[keep]

        if len(boxes_lidar) == 0:
            anno = kitti.empty_result_anno()
            anno["image_idx"] = np.array([], dtype=np.int64)
            annos.append(anno)
            continue

        box_cam = box_np.box_lidar_to_camera(boxes_lidar, rect, Trv2c)
        bbox = box_np.box3d_to_bbox(box_cam, rect, Trv2c, P2)
        bbox[:, [0, 2]] = np.clip(bbox[:, [0, 2]], 0, img_shape[1])
        bbox[:, [1, 3]] = np.clip(bbox[:, [1, 3]], 0, img_shape[0])

        anno = kitti.get_start_result_anno()
        for j in range(len(boxes_lidar)):
            anno["name"].append(class_names[int(labels[j])])
            anno["truncated"].append(0.0)
            anno["occluded"].append(0)
            anno["alpha"].append(-np.arctan2(-boxes_lidar[j, 1],
                                             boxes_lidar[j, 0])
                                 + box_cam[j, 6])
            anno["bbox"].append(bbox[j])
            anno["dimensions"].append(box_cam[j, 3:6])
            anno["location"].append(box_cam[j, :3])
            anno["rotation_y"].append(box_cam[j, 6])
            anno["score"].append(scores[j])
        anno = {k: np.stack(v) for k, v in anno.items()}
        anno["image_idx"] = np.full(len(boxes_lidar), image_idx,
                                    dtype=np.int64)
        annos.append(anno)
    return annos


def evaluate(predict_step: Callable, eval_ds, cfg,
             log: Callable[[str], None] = print) -> list[dict]:
    """Prediction over the KITTI ``eval_ds`` in batches of
    ``EVAL_INPUT_READER.BATCH_SIZE`` → one KITTI anno a frame (the
    centres limited to ``post_center_limit_range`` where the config
    sets it)."""
    class_names = list(cfg.EVAL_INPUT_READER.CLASS_NAMES)
    limit = cfg.MODEL.POST_PROCESSING.get("post_center_limit_range")
    annos = []
    for example, dets, real in _predicted_batches(
            predict_step, eval_ds, int(cfg.EVAL_INPUT_READER.BATCH_SIZE)):
        annos.extend(predictions_to_kitti_annos(dets, example, class_names,
                                                limit)[:real])
    log(f"evaluated {len(annos)} frames")
    return annos


def official_map(eval_ds, annos: list[dict], cfg):
    """The official KITTI result string of ``annos`` against the ground
    truth of ``eval_ds``'s infos, or None where not every frame has
    it."""
    from papc_tpu_torch.eval.kitti_eval import get_official_eval_result

    gt_annos = [info["annos"] for info in eval_ds.kitti_infos
                if "annos" in info]
    if len(gt_annos) != len(annos):
        return None
    return get_official_eval_result(gt_annos, annos,
                                    list(cfg.EVAL_INPUT_READER.CLASS_NAMES))


def _iter_batches(dataset, batch_size, shuffle, rng, pool=None, epoch=0,
                  max_batches=None):
    """Collated batches of one epoch, in an order shuffled by ``rng``;
    with a :class:`~papc_tpu_torch.data.workers.SamplePool` the samples
    are prepared in its workers. ``max_batches`` bounds the epoch, so the
    pool's work ends where the loop stops taking batches."""
    n = len(dataset)
    dataset.set_epoch(epoch)  # one epoch channel for both modes
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    n_batches = (n - n % batch_size) // batch_size
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    order = order[:n_batches * batch_size]
    if pool is not None and len(order):
        buf = []
        for ex in pool.imap(epoch, order):
            buf.append(ex)
            if len(buf) == batch_size:
                yield collate_batch(buf)
                buf = []
        return
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        yield collate_batch([dataset[int(i)] for i in idx])


@dataclasses.dataclass
class DetectionState:
    """What :func:`train` trains: the model (on its device), the
    optimizer, its rate schedule and the steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: object
    step: int


def _build(cfg, seed: int, device: torch.device):
    """The components of a config, the network seeded from ``seed`` on
    ``device``."""
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    box_coder = builders.build_box_coder(cfg.BOX_CODER)
    target_assigner = builders.build_target_assigner(cfg.TARGET_ASSIGNER,
                                                     box_coder)
    model = builders.build_network(cfg, vg, target_assigner)
    init_params(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    pillarize = make_pillarizer(vg, int(cfg.VOXEL_GENERATOR.MAX_VOXELS))
    return vg, box_coder, target_assigner, model, pillarize


def _load_cfg(cfg_file, cfg_overrides):
    cfg = cfg_from_file(cfg_file)
    if cfg_overrides:
        cfg_from_list(cfg, cfg_overrides)
    return cfg


def _save(state: DetectionState, model_dir: str) -> str:
    return ckpt_lib.save(model_dir, MODEL_NAME, ckpt_lib.training_arrays(
        state.model, state.optimizer, state.scheduler, state.step),
        state.step)


def train(cfg_file: str | None = None, model_dir: str = "./ppmodel",
          result_path: str | None = None, cfg_overrides: list | None = None,
          max_steps: int | None = None, display_step: int = 50,
          eval_on_finish: bool = True, seed: int = 0,
          log: Callable[[str], None] = print,
          device: str | torch.device = "cuda"):
    """Train PointPillars on KITTI from a config (``cfg_file``: a shipped
    config's name, a JSON file, or None for the car config) with dotted ``cfg_overrides``; returns ``(state,
    annos)``: the :class:`DetectionState` and, with ``eval_on_finish``,
    the eval set's KITTI annos (else None).

    The network starts from ``seed`` and augmentation draws from
    ``RandomState(seed)`` (the batch order and, with no workers, the
    database sampler; each frame's own draws from its ``(base_seed,
    epoch, idx)``). A display step syncs and logs the metrics, the
    running precision and recall at 0.5 and the step time (CUDA events
    over the steps since the last display, their data included) to
    ``log`` and ``model_dir/log.txt``."""
    device = torch.device(device)
    cfg = _load_cfg(cfg_file, cfg_overrides)
    scan_steps = int(cfg.TRAIN_CONFIG.get("SCAN_STEPS", 0) or 0)
    if scan_steps > 1:
        raise NotImplementedError(
            "TRAIN_CONFIG.SCAN_STEPS > 1 is not ported (ROADMAP.md, Queue 1 "
            "item 4: a CUDA-graph counterpart is an open question)")
    os.makedirs(model_dir, exist_ok=True)
    save_config(cfg, os.path.join(model_dir, "pipeline.config"))
    rng_np = np.random.RandomState(seed)

    vg, box_coder, target_assigner, model, pillarize = _build(cfg, seed,
                                                              device)
    loss_cfg = builders.build_loss_config(cfg, box_coder)
    predict_cfg = builders.build_predict_config(cfg, box_coder)
    train_ds = builders.build_dataset(cfg, cfg.TRAIN_INPUT_READER, vg,
                                      target_assigner, training=True,
                                      rng=rng_np, log=log)
    eval_ds = builders.build_dataset(cfg, cfg.EVAL_INPUT_READER, vg,
                                     target_assigner, training=False,
                                     log=log)

    batch_size = int(cfg.TRAIN_INPUT_READER.BATCH_SIZE)
    total_steps = int(max_steps or cfg.TRAIN_CONFIG.STEPS)
    save_secs = int(cfg.TRAIN_CONFIG.get("SAVE_CHECKPOINTS_SECS", 1800))
    steps_per_eval = int(cfg.TRAIN_CONFIG.get("STEPS_PER_EVAL", 0))

    opt, sched = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER,
                                          model.parameters())
    state = DetectionState(model, opt, sched, 0)
    restored = ckpt_lib.try_restore_latest(model_dir, MODEL_NAME)
    if restored is not None:
        state.step = ckpt_lib.restore_training(restored, model, opt, sched)
        log(f"resumed from step {state.step}")

    precision = str(cfg.TRAIN_CONFIG.get("PRECISION", "fp32"))
    train_step, init_rm = make_detection_train_step(
        model, loss_cfg, opt, sched, pillarize, device=device,
        precision=precision)
    running = init_rm()
    predict_step = make_predict_step(model, predict_cfg, box_coder,
                                     pillarize, device=device)

    last_save = time.time()
    timer = StepTimer(device=device)
    num_workers = int(cfg.TRAIN_INPUT_READER.get("NUM_WORKERS", 0))
    pool = None
    if num_workers > 0:
        from papc_tpu_torch.data.workers import SamplePool

        # per-item sampler seeding: the paste augmentation does not
        # depend on the worker count
        train_ds.enable_per_item_sampler_seeding(True)
        pool = SamplePool(train_ds, num_workers)
    epoch = 0
    try:
        while state.step < total_steps:
            epoch += 1
            batches = _iter_batches(train_ds, batch_size, True, rng_np,
                                    pool=pool, epoch=epoch,
                                    max_batches=total_steps - state.step)
            took = 0
            while True:
                timer.start()  # the window takes the batch's making too
                example = next(batches, None)
                if example is None:
                    break
                took += 1
                metrics, running = train_step(example_to_batch(example),
                                              running)
                state.step += 1
                display = state.step % display_step == 0
                steptime = timer.stop(sync=display)
                if display:
                    m = {k: round(float(v), 5) for k, v in metrics.items()}
                    m["rpn_prec@0.5"] = round(
                        float(running["pr"].precision[2]), 4)
                    m["rpn_rec@0.5"] = round(
                        float(running["pr"].recall[2]), 4)
                    m["step"] = state.step
                    m["steptime"] = round(steptime, 4)
                    line = ", ".join(f"{k}={v}" for k, v in
                                     flat_nested_json_dict(m).items())
                    log(line)
                    with open(os.path.join(model_dir, "log.txt"), "a") as f:
                        f.write(line + "\n")
                if time.time() - last_save > save_secs:
                    _save(state, model_dir)
                    last_save = time.time()
                    timer.discard()
                if steps_per_eval and state.step % steps_per_eval == 0:
                    _save(state, model_dir)
                    annos = evaluate(predict_step, eval_ds, cfg, log=log)
                    result = official_map(eval_ds, annos, cfg)
                    if result is not None:
                        log(result)
                    timer.discard()
                if state.step >= total_steps:
                    break
            if took == 0:
                raise ValueError(
                    f"the training set ({len(train_ds)} frames) holds no "
                    f"batch of {batch_size}")
    except Exception:
        try:  # save on a crash
            _save(state, model_dir)
        except Exception as save_err:  # noqa: BLE001
            log(f"crash-save failed: {save_err!r}; the latest periodic "
                "checkpoint stands")
        raise
    finally:
        if pool is not None:
            pool.close()
    _save(state, model_dir)

    if eval_on_finish:
        annos = evaluate(predict_step, eval_ds, cfg, log=log)
        if result_path:
            os.makedirs(result_path, exist_ok=True)
            _write_result_files(annos, result_path)
        return state, annos
    return state, None


def _write_result_files(annos, result_path):
    """One KITTI result file ``<image_idx>.txt`` a frame."""
    for anno in annos:
        idx = int(anno["image_idx"][0]) if len(anno["image_idx"]) else 0
        lines = []
        for j in range(len(anno["name"])):
            lines.append(kitti.kitti_result_line({
                "name": anno["name"][j],
                "alpha": anno["alpha"][j],
                "bbox": anno["bbox"][j],
                # result files hold h, w, l
                "dimensions": anno["dimensions"][j][[1, 2, 0]],
                "location": anno["location"][j],
                "rotation_y": anno["rotation_y"][j],
                "score": anno["score"][j],
            }))
        path = pathlib.Path(result_path) / (
            kitti.get_image_index_str(idx) + ".txt")
        path.write_text("\n".join(lines) + ("\n" if lines else ""))


def evaluate_checkpoint(cfg_file: str | None = None,
                        model_dir: str = "./ppmodel",
                        result_path: str | None = None,
                        cfg_overrides: list | None = None,
                        with_map: bool = True,
                        log: Callable[[str], None] = print,
                        device: str | torch.device = "cuda"):
    """Serve the latest checkpoint of ``model_dir`` over the eval set →
    ``(annos, result)``: the KITTI annos and the official mAP string
    (None without ``with_map`` or without ground truth for every
    frame). ``result_path`` takes one result file a frame."""
    device = torch.device(device)
    cfg = _load_cfg(cfg_file, cfg_overrides)
    vg, box_coder, target_assigner, model, pillarize = _build(cfg, 0, device)
    predict_cfg = builders.build_predict_config(cfg, box_coder)
    eval_ds = builders.build_dataset(cfg, cfg.EVAL_INPUT_READER, vg,
                                     target_assigner, training=False,
                                     log=log)
    restored = ckpt_lib.try_restore_latest(model_dir, MODEL_NAME)
    if restored is None:
        raise SystemExit(f"no checkpoint found in {model_dir}")
    step = ckpt_lib.restore_training(restored, model)
    log(f"evaluating checkpoint at step {step}")
    predict_step = make_predict_step(model, predict_cfg, box_coder,
                                     pillarize, device=device)
    annos = evaluate(predict_step, eval_ds, cfg, log=log)
    if result_path:
        os.makedirs(result_path, exist_ok=True)
        _write_result_files(annos, result_path)
    result = official_map(eval_ds, annos, cfg) if with_map else None
    if result is not None:
        log(result)
    return annos, result


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="PointPillars training")
    parser.add_argument("command", choices=["train", "evaluate"], nargs="?",
                        default="train")
    parser.add_argument("--cfg_file", default=None,
                        help="a shipped config's name (pointpillars_kitti_car"
                        ", pointpillars_kitti_3class) or a JSON config (e.g. "
                        "a run's pipeline.config); default: the KITTI car "
                        "config")
    parser.add_argument("--model_dir", default="./ppmodel")
    parser.add_argument("--result_path", default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--display_step", type=int, default=50)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument(
        "--set", dest="set_cfgs", nargs="*", default=None,
        help="dotted config overrides: KEY VALUE [KEY VALUE ...]")
    args = parser.parse_args(argv)
    if args.command == "evaluate":
        evaluate_checkpoint(cfg_file=args.cfg_file, model_dir=args.model_dir,
                            result_path=args.result_path,
                            cfg_overrides=args.set_cfgs, device=args.device)
    else:
        train(cfg_file=args.cfg_file, model_dir=args.model_dir,
              result_path=args.result_path, cfg_overrides=args.set_cfgs,
              max_steps=args.max_steps, display_step=args.display_step,
              device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
