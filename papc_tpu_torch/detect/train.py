"""The detection serving path (counterpart of ``make_pillarizer``,
``make_predict_step`` and ``evaluate`` in ``papc_tpu/detect/train.py``):
raw lidar frames → voxelize → PillarFeatureNet → BEV scatter → RPN →
decode → top K → NMS kernel → fixed-size detections.

Detection training, the KITTI pipeline (annos, mAP) and the CLI are not
ported yet (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

from collections.abc import Callable, Mapping

import numpy as np
import torch

from papc_tpu_torch.data.synthetic_kitti import collate_batch
from papc_tpu_torch.detect.detector import predict
from papc_tpu_torch.ops.voxelize import voxelize


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
    ported yet (ROADMAP.md, Queue 1 item 6). The model runs in
    eval mode under :func:`torch.inference_mode`, its convolutions in
    full float32: inside ``torch.backends.cudnn.flags(enabled=True,
    allow_tf32=False)``, a context local to the call (PyTorch's own
    default lets cuDNN use TF32). ``impl`` goes to the NMS op: ``None``
    launches the kernel on a CUDA device."""
    if precision != "fp32":
        raise NotImplementedError(
            f"precision {precision!r}: bf16 serving is not ported yet "
            "(ROADMAP.md, Queue 1 item 6)")
    if predict_cfg.multiclass_nms:
        raise NotImplementedError(
            "multiclass_nms (predict_multiclass and its host C++ NMS) is "
            "not ported yet (ROADMAP.md, Queue 1 item 6)")
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
