"""Soft-NMS and per-class NMS on the host, in numpy (counterpart of
``papc_tpu/detect/nms_extra.py``).

``multiclass_nms`` runs an ``nms_func`` class by class over a shared box
set; ``standard_nms_func`` builds one on the port's NMS
(``papc_tpu_torch/ops/nms.py``, its plain version for host arrays), where
JAX's calls its C++ library. The two compute the IoU in float32 here and
in float64 there, so a pair whose IoU lies within rounding of the
threshold can be decided the other way. The serving path does not come
through here: ``detect/detector.py::predict_multiclass`` runs the same
per-class NMS on the device, batched over frames and classes.
``soft_nms`` has no caller in either package but its tests.
"""

from __future__ import annotations

import numpy as np
import torch

from papc_tpu_torch.ops.iou import box5_to_corners
from papc_tpu_torch.ops.nms import nms, rotate_nms


def soft_nms(boxes: np.ndarray, sigma: float = 0.5, Nt: float = 0.3,
             threshold: float = 0.001, method: int = 0):
    """Soft-NMS over ``[N, 5]`` (x1, y1, x2, y2, score) boxes with the
    +1 pixel-area convention; ``method`` 0 is hard NMS, 1 linear decay, 2
    gaussian decay. Returns ``(kept [K, 5], K)``: the in-place max
    selection and compaction of the reference, on a copy."""
    boxes = np.array(boxes, dtype=np.float32, copy=True)
    N = len(boxes)
    i = 0
    while i < N:
        # move the best remaining box to position i
        maxpos = i + int(np.argmax(boxes[i:N, 4]))
        boxes[[i, maxpos]] = boxes[[maxpos, i]]
        tx1, ty1, tx2, ty2 = boxes[i, :4]
        t_area = (tx2 - tx1 + 1) * (ty2 - ty1 + 1)

        pos = i + 1
        while pos < N:
            x1, y1, x2, y2, _ = boxes[pos]
            iw = min(tx2, x2) - max(tx1, x1) + 1
            if iw > 0:
                ih = min(ty2, y2) - max(ty1, y1) + 1
                if ih > 0:
                    area = (x2 - x1 + 1) * (y2 - y1 + 1)
                    ov = iw * ih / float(t_area + area - iw * ih)
                    if method == 1:
                        weight = 1 - ov if ov > Nt else 1.0
                    elif method == 2:
                        weight = np.exp(-(ov * ov) / sigma)
                    else:
                        weight = 0.0 if ov > Nt else 1.0
                    boxes[pos, 4] *= weight
                    if boxes[pos, 4] < threshold:
                        boxes[pos] = boxes[N - 1]
                        N -= 1
                        pos -= 1
            pos += 1
        i += 1
    return boxes[:N], N


def multiclass_nms(nms_func, boxes: np.ndarray, scores: np.ndarray,
                   pre_max_size: int | None = None,
                   post_max_size: int | None = None,
                   score_thresh: float = 0.0, iou_threshold: float = 0.5):
    """Per-class NMS over ``boxes [N, num_cls or 1, box_dim]`` and
    ``scores [N, num_cls]`` → a list of ``num_cls`` index arrays into N,
    None for a class that keeps nothing. ``nms_func(boxes, scores,
    pre_max_size, post_max_size, iou_threshold)`` → the kept indices
    (:func:`standard_nms_func`)."""
    assert boxes.ndim == 3, "bbox must have shape [N, num_cls, box_dim]"
    assert scores.ndim == 2, "score must have shape [N, num_cls]"
    num_classes = scores.shape[1]
    boxes_ids = (range(num_classes) if boxes.shape[1] > 1
                 else [0] * num_classes)
    selected_per_class = []
    for class_idx, boxes_idx in zip(range(num_classes), boxes_ids):
        class_scores = scores[:, class_idx]
        class_boxes = boxes[:, boxes_idx]
        if score_thresh > 0.0:
            keep_ids = np.flatnonzero(class_scores >= score_thresh)
            if len(keep_ids) == 0:
                selected_per_class.append(None)
                continue
            class_scores = class_scores[keep_ids]
            class_boxes = class_boxes[keep_ids]
        if len(class_scores) == 0:
            selected_per_class.append(None)
            continue
        keep = nms_func(class_boxes, class_scores, pre_max_size,
                        post_max_size, iou_threshold)
        if keep is None or len(keep) == 0:
            selected_per_class.append(None)
        elif score_thresh > 0.0:
            selected_per_class.append(keep_ids[keep])
        else:
            selected_per_class.append(np.asarray(keep))
    return selected_per_class


def standard_nms_func(rotated: bool = False):
    """An ``nms_func`` for :func:`multiclass_nms` on the port's NMS: the
    candidates score-sorted (``np.argsort(-scores)``, as JAX's) and cut to
    ``pre_max_size``, the greedy sweep, the kept indices cut to
    ``post_max_size``. Boxes of 7 columns are (x, y, z, w, l, h, yaw), of
    5 (x, y, w, l, yaw), of 4 (standup only) (x1, y1, x2, y2). The standup
    sweep runs over the rotated boxes' axis-aligned hulls; JAX's reads a
    5-column row as a 4-column one there, which the port does not
    reproduce."""

    def fn(boxes, scores, pre_max_size, post_max_size, iou_threshold):
        order = np.argsort(-scores)
        if pre_max_size is not None:
            order = order[:pre_max_size]
        cand = np.asarray(boxes, np.float32)[order]
        if cand.shape[1] == 7:
            cand = cand[:, [0, 1, 3, 4, 6]]
        t = torch.from_numpy(np.ascontiguousarray(cand))[None]
        if rotated:
            keep_mask = rotate_nms(t, iou_threshold=iou_threshold)
        else:
            if t.shape[-1] == 5:
                corners = box5_to_corners(t)
                t = torch.cat([corners.amin(-2), corners.amax(-2)], dim=-1)
            keep_mask = nms(t, iou_threshold=iou_threshold)
        kept = order[keep_mask[0].numpy()]
        if post_max_size is not None:
            kept = kept[:post_max_size]
        return kept

    return fn
