"""Region similarity calculators (counterpart of
``papc_tpu/detect/similarity.py``) over BEV 5-dof boxes ``[x, y, w, l,
yaw]``, in numpy on the host."""

from __future__ import annotations

import numpy as np

from papc_tpu_torch.detect import box_np


class RotateIouSimilarity:
    """Exact rotated IoU."""

    def compare(self, boxes1, boxes2):
        return box_np.rotate_iou_cpu(boxes1, boxes2)


class NearestIouSimilarity:
    """Axis-aligned IoU of the nearest standup boxes. ``boxes1_bv`` takes
    the first set's standup boxes precomputed (the anchors', fixed for a
    config)."""

    def compare(self, boxes1, boxes2, boxes1_bv=None):
        if boxes1_bv is None:
            boxes1_bv = box_np.rbbox2d_to_near_bbox(boxes1)
        return box_np.iou_2d(boxes1_bv, box_np.rbbox2d_to_near_bbox(boxes2))


class DistanceSimilarity:
    """One minus the normalised centre distance (optionally less a share
    of ``|sin|`` of the yaw difference), 0 beyond ``distance_norm`` on x
    or y."""

    def __init__(self, distance_norm, with_rotation=False,
                 rotation_alpha=0.5):
        self._distance_norm = distance_norm
        self._with_rotation = with_rotation
        self._rotation_alpha = rotation_alpha

    def compare(self, boxes1, boxes2):
        N, K = len(boxes1), len(boxes2)
        if N == 0 or K == 0:
            return np.zeros((N, K), np.float32)
        d = self._distance_norm
        dx = np.abs(boxes1[:, None, 0] - boxes2[None, :, 0])
        dy = np.abs(boxes1[:, None, 1] - boxes2[None, :, 1])
        near = (dx <= d) & (dy <= d)
        dist_normed = np.minimum((dx**2 + dy**2) / d, d)
        if self._with_rotation:
            dist_rot = np.abs(np.sin(boxes1[:, None, -1] - boxes2[None, :, -1]))
            a = self._rotation_alpha
            val = 1 - (1 - a) * dist_normed - a * dist_rot
        else:
            val = 1 - dist_normed
        return np.where(near, val, 0.0).astype(boxes1.dtype)
