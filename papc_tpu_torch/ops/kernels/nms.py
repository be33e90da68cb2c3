"""Greedy NMS sweeps: the CUDA kernels (``csrc/nms_greedy.cu``,
``csrc/nms_rotate.cu``) and their plain PyTorch versions.

Counterpart of ``papc_tpu/ops/pallas/nms.py``: ``greedy_suppress_pallas``
(the sweep over a precomputed IoU matrix) and ``rotate_nms_pallas`` (the
fused rotated sweep, no K×K matrix). Rows are score-sorted, best first,
with a leading batch axis ``B``: for i = 0…K−1, a box i that is still
kept suppresses every j > i with ``IoU(i, j) > threshold``.

The fused sweep's row i clips every box j by box i, which is
``rotate_iou(b, b)[j, i]``; its plain version therefore sweeps the
transposed matrix. Kernel and plain version compute the same clip in the
same f32 operations; the shoelace sums run in another order, so their
keep masks can differ only for a pair whose IoU lies within a few ulps
of the threshold.
"""

from __future__ import annotations

import ctypes

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.iou import box5_to_corners, rotate_iou
from papc_tpu_torch.ops.kernels import check, use_kernel

GREEDY = Kernel(
    "papc_nms_greedy",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p],
)
ROTATE = Kernel(
    "papc_nms_rotate",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p],
)
KERNELS = (GREEDY, ROTATE)
SMEM_BYTES = 232448  # the 227 KB of shared memory a block may opt into
# keep flags in shared memory, one byte a box
GREEDY_MAX_K = SMEM_BYTES
# corners (32 B), area (4 B) and keep flag (1 B) a box in shared memory
ROTATE_MAX_K = SMEM_BYTES // 37


def greedy_suppress_plain(iou: torch.Tensor, valid: torch.Tensor,
                          iou_threshold: float) -> torch.Tensor:
    """The sweep as a loop of K masked vector ops: ``iou [B, K, K]``,
    ``valid [B, K]`` → keep ``[B, K]`` bool."""
    K = iou.shape[-1]
    idx = torch.arange(K, device=iou.device)
    overlap = iou > iou_threshold
    keep = valid.to(torch.bool).clone()
    for i in range(K):
        suppress = overlap[:, i] & (idx > i) & keep[:, i:i + 1]
        keep &= ~suppress
    return keep


def rotate_nms_plain(rbboxes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """``rbboxes [B, K, 5]`` (x, y, w, l, yaw) → keep ``[B, K]``: the
    sweep over the transposed rotated IoU matrix (see the module doc)."""
    iou = rotate_iou(rbboxes, rbboxes).transpose(-1, -2)
    return greedy_suppress_plain(iou, valid, iou_threshold)


def _check_k(k: int, limit: int, what: str) -> None:
    if k > limit:
        raise ValueError(
            f"{what}: K={k} is above the kernel's limit of {limit} boxes "
            f"({SMEM_BYTES} bytes of shared memory a block)")


def greedy_suppress_cuda(iou: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    B, K, _ = iou.shape
    _check_k(K, GREEDY_MAX_K, "greedy_suppress")
    check(iou, "iou", torch.float32, (B, K, K))
    check(valid, "valid", torch.bool, (B, K))
    keep = torch.empty((B, K), dtype=torch.bool, device=iou.device)
    if B * K:
        GREEDY(ptr(iou), ptr(valid), B, K, float(iou_threshold), ptr(keep),
               stream_of(iou))
    return keep


def rotate_nms_cuda(rbboxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    B, K, _ = rbboxes.shape
    _check_k(K, ROTATE_MAX_K, "rotate_nms")
    check(rbboxes, "rbboxes", torch.float32, (B, K, 5))
    check(valid, "valid", torch.bool, (B, K))
    # the plain version's corners and areas, so sin and cos agree
    corners = box5_to_corners(rbboxes).contiguous()  # [B, K, 4, 2]
    areas = (rbboxes[..., 2] * rbboxes[..., 3]).contiguous()
    keep = torch.empty((B, K), dtype=torch.bool, device=rbboxes.device)
    if B * K:
        ROTATE(ptr(corners), ptr(areas), ptr(valid), B, K,
               float(iou_threshold), ptr(keep), stream_of(rbboxes))
    return keep


def greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float, *,
                    impl: str | None = None) -> torch.Tensor:
    """Greedy keep mask from a precomputed IoU matrix ``[B, K, K]`` and
    ``valid [B, K]`` → ``[B, K]`` bool: box i, while kept, suppresses
    every j > i with ``iou[i, j] > iou_threshold``."""
    if use_kernel(iou, impl):
        return greedy_suppress_cuda(iou.float().contiguous(),
                                    valid.bool().contiguous(), iou_threshold)
    return greedy_suppress_plain(iou, valid, iou_threshold)


def rotate_nms(rbboxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, *,
               impl: str | None = None) -> torch.Tensor:
    """Fused rotated NMS: ``rbboxes [B, K, 5]`` (x, y, w, l, yaw),
    score-sorted, ``valid [B, K]`` → keep ``[B, K]`` bool."""
    if use_kernel(rbboxes, impl):
        return rotate_nms_cuda(rbboxes.float().contiguous(),
                               valid.bool().contiguous(), iou_threshold)
    return rotate_nms_plain(rbboxes, valid, iou_threshold)
