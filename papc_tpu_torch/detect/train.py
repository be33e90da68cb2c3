"""Detection training and serving (counterpart of ``make_pillarizer``,
``make_detection_train_step``, ``make_predict_step`` and ``evaluate`` in
``papc_tpu/detect/train.py``).

Training: a batch of raw lidar frames with their targets → voxelize on
the device → PillarFeatureNet → BEV scatter → RPN in training mode →
``compute_loss`` → backward → one optimizer step at the scheduled rate →
running accuracy and precision / recall. Serving: raw frames → voxelize
→ the network in eval mode → decode → top K → NMS kernel → fixed-size
detections. Neither step runs a kernel of the port but the NMS.

The KITTI pipeline (its prep, augmentation and sampler, the annos and
mAP), JAX's ``train()`` loop over it with its checkpoint manager and
sample pool, ``make_scan_detection_train_step`` and the CLI are not
ported yet (ROADMAP.md, Queue 1 item 6.5).
"""

from __future__ import annotations

from collections.abc import Callable, Mapping

import numpy as np
import torch

from papc_tpu_torch.data.synthetic_kitti import collate_batch
from papc_tpu_torch.detect.detector import compute_loss, predict
from papc_tpu_torch.ops.voxelize import voxelize
from papc_tpu_torch.train.running_metrics import (AccuracyState,
                                                  PrecisionRecallState)


def make_pillarizer(voxel_generator, max_voxels: int) -> Callable:
    """Pillarization on the device: ``pillarize(batch)`` → ``(voxels
    [B, V, P, D], num_points [B, V], coords [B, V, 3])`` from a batch
    holding ``points [B, N, D]`` and ``points_mask [B, N]`` tensors."""
    vsize = tuple(float(v) for v in voxel_generator.voxel_size)
    prange = tuple(float(v) for v in voxel_generator.point_cloud_range)
    grid = tuple(int(g) for g in voxel_generator.grid_size)
    max_points = int(voxel_generator.max_num_points)

    def pillarize(batch):
        out = voxelize(batch["points"], batch["points_mask"], vsize, prange,
                       grid, max_points, max_voxels)
        return out.voxels, out.num_points, out.coords

    return pillarize


def batch_to_device(batch: Mapping, device: torch.device) -> dict:
    """Numpy arrays or tensors → tensors on ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


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

    ``batch`` holds numpy arrays or tensors: ``points`` and
    ``points_mask`` for ``pillarize`` (``make_pillarizer``; the
    host-pillarize input is ROADMAP.md's Queue 1 item 6.2), ``anchors [B,
    A, 7]``, ``labels [B, A]`` and ``reg_targets [B, A, code]``.
    ``optimizer`` and ``scheduler`` are ``builders.build_optimizer``'s:
    the step's rate is the schedule at the steps taken before it, as in
    optax. The network trains in f32, its convolutions with TF32 off
    forward and backward (``nn.layers.conv``). ``precision="bf16"`` raises."""
    if precision == "bf16":
        raise NotImplementedError(
            "bf16 detection training is not ported yet (ROADMAP.md, Queue 1 "
            "item 6.4: bf16 serving and training)")
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    device = torch.device(device)
    model = model.to(device).train()
    ncls = (loss_cfg.num_class if loss_cfg.encode_background_as_zeros
            else loss_cfg.num_class + 1)

    def train_step(batch: Mapping, rm: dict):
        batch = batch_to_device(batch, device)
        model.train()
        preds = model(*pillarize(batch))
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

    ``batch`` holds numpy arrays or tensors: ``points``, ``points_mask``
    (for ``pillarize``), ``anchors [B, A, 7]`` and optionally
    ``anchors_mask``. The host-pillarize and flat-PFN inputs are not
    ported yet (ROADMAP.md, Queue 1 item 6.2). The model runs in
    eval mode under :func:`torch.inference_mode`, its convolutions in
    full float32: inside ``torch.backends.cudnn.flags(enabled=True,
    allow_tf32=False)``, a context local to the call (PyTorch's own
    default lets cuDNN use TF32). ``impl`` goes to the NMS op: ``None``
    launches the kernel on a CUDA device."""
    if precision != "fp32":
        raise NotImplementedError(
            f"precision {precision!r}: bf16 serving is not ported yet "
            "(ROADMAP.md, Queue 1 item 6.4)")
    if predict_cfg.multiclass_nms:
        raise NotImplementedError(
            "multiclass_nms (predict_multiclass and its host C++ NMS) is "
            "not ported yet (ROADMAP.md, Queue 1 item 6.3)")
    device = torch.device(device)
    model = model.to(device).eval()

    def predict_step(batch: Mapping) -> dict:
        batch = batch_to_device(batch, device)
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            preds = model(*pillarize(batch))
            return predict(preds, batch["anchors"], box_coder.decode,
                           predict_cfg, anchors_mask=batch.get("anchors_mask"),
                           impl=impl)

    return predict_step


def evaluate(predict_step: Callable, eval_ds, cfg,
             log: Callable[[str], None] = print) -> list[dict]:
    """Prediction over ``eval_ds`` (``len`` and ``eval_ds[i]`` → example
    dict) in batches of ``EVAL_INPUT_READER.BATCH_SIZE``, the last padded
    by repeating its last frame → one detection dict of numpy arrays per
    frame. Stops where the JAX loop converts to KITTI annos."""
    batch_size = int(cfg.EVAL_INPUT_READER.BATCH_SIZE)
    dets_out = []
    n = len(eval_ds)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        pad = batch_size - len(idx)
        idx = idx + [idx[-1]] * pad
        dets = predict_step(collate_batch([eval_ds[i] for i in idx]))
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        for row in range(batch_size - pad):
            dets_out.append({k: v[row] for k, v in dets.items()})
    log(f"evaluated {len(dets_out)} frames")
    return dets_out
