"""Greedy non-maximum suppression (counterpart of ``papc_tpu/ops/nms.py``),
batched over a leading axis. Inputs are score-sorted, best first.

Each function dispatches as every op of the port does: a CUDA tensor
launches the kernel (``ops/kernels/nms.py``) or raises, a K above the
kernel's shared-memory limit included; a CPU tensor, or ``impl="plain"``,
takes the plain version.
"""

from __future__ import annotations

import torch

from papc_tpu_torch.ops.iou import iou_2d
from papc_tpu_torch.ops.kernels import nms as kernels
# the sweep over a precomputed IoU matrix [B, K, K]: box i, while kept,
# suppresses every j > i with iou[i, j] > iou_threshold
from papc_tpu_torch.ops.kernels.nms import greedy_suppress

__all__ = ["greedy_suppress", "nms", "rotate_nms"]


def nms(boxes: torch.Tensor, valid: torch.Tensor | None = None,
        iou_threshold: float = 0.5, *,
        impl: str | None = None) -> torch.Tensor:
    """Standup NMS over score-sorted ``[B, K, 4]`` (x1, y1, x2, y2) boxes
    → keep ``[B, K]`` bool."""
    if valid is None:
        valid = torch.ones(boxes.shape[:-1], dtype=torch.bool,
                           device=boxes.device)
    return greedy_suppress(iou_2d(boxes, boxes), valid, iou_threshold,
                           impl=impl)


def rotate_nms(rbboxes: torch.Tensor, valid: torch.Tensor | None = None,
               iou_threshold: float = 0.5, *,
               impl: str | None = None) -> torch.Tensor:
    """Rotated NMS over score-sorted ``[B, K, 5]`` (x, y, w, l, yaw)
    boxes → keep ``[B, K]`` bool. On the card the fused sweep builds no
    K×K matrix; the plain version sweeps the transposed rotated IoU
    matrix (``ops/kernels/nms.py``)."""
    if valid is None:
        valid = torch.ones(rbboxes.shape[:-1], dtype=torch.bool,
                           device=rbboxes.device)
    return kernels.rotate_nms(rbboxes, valid, iou_threshold, impl=impl)
