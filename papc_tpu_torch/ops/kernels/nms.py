"""Greedy NMS: the CUDA kernels (``csrc/nms_greedy.cu``,
``csrc/nms_rotate.cu`` on ``csrc/nms_mask.cuh``) and their plain PyTorch
versions.

Counterpart of ``papc_tpu/ops/pallas/nms.py``: ``greedy_suppress_pallas``
(the sweep over a precomputed IoU matrix) and ``rotate_nms_pallas`` (the
fused rotated sweep, no K×K matrix). Rows are score-sorted, best first,
with a leading batch axis ``B``: for i = 0…K−1, a box i that is still
kept suppresses every j > i with ``IoU(i, j) > threshold``.

Each kernel runs in two stages, and each stage has a plain twin here, its
oracle on the card:

- the mask: bit j of row i (word ``j // 64``, bit ``j % 64`` of ``W =
  ceil(K / 64)`` 64-bit words a row) is set when i < j, both boxes are
  valid and their overlap exceeds the threshold (``greedy_mask_plain``,
  ``rotate_mask_plain``);
- the sweep: ``removed = ~valid``; row i is kept iff its bit of
  ``removed`` is clear, and a kept row ORs its words into ``removed``
  (``sweep_mask_plain``). The mask decides each pair without the sweep,
  so this is the loop's keep mask.

The fused sweep's row i clips every box j by box i, which is
``rotate_iou(b, b)[j, i]``; its plain versions therefore use the
transposed matrix. Kernel and plain version compute the same clip in the
same f32 operations; the shoelace sums run in another order, so their
masks can differ only for a pair whose IoU lies within a few ulps of the
threshold.

The wrapper allocates the kernels' scratch (``scratch_bytes``): the mask,
each frame's rows padded to ``64 W`` (``ROWS`` a row block of the sweep),
and for the rotated kernel one count a block of the pairs whose clip
overflowed its register ring.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.iou import box5_to_corners, rotate_iou
from papc_tpu_torch.ops.kernels import check, use_kernel

GREEDY = Kernel(
    "papc_nms_greedy",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
)
ROTATE = Kernel(
    "papc_nms_rotate",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p],
)
KERNELS = (GREEDY, ROTATE)
SMEM_BYTES = 232448  # the 227 KB of shared memory a block may opt into
ROWS = 64  # rows a block of the sweep: one 64-bit word
SWEEP_STAGES = 3  # row blocks in the sweep's cp.async ring
MASK_WARPS = 8  # rows a block of the rotated mask kernel
# the sweep's removed words (8 bytes a ROWS boxes) and its kept word in
# shared memory
MAX_K = ROWS * ((SMEM_BYTES - 8) // 8)
GREEDY_MAX_K = ROTATE_MAX_K = MAX_K


def mask_words(k: int) -> int:
    """64-bit words of a mask row: ``ceil(k / 64)``."""
    return -(-k // ROWS)


class SweepPlan(NamedTuple):
    threads: int  # one block a frame: four warps a 32 words, up to 1024
    staged: bool  # row blocks staged in shared memory (else read from L2)
    smem_bytes: int


def sweep_plan(k: int) -> SweepPlan:
    """The sweep's launch, as ``csrc/nms_mask.cuh::sweep_plan`` computes
    it: the removed words and the kept word, and, where they fit beside
    them, ``SWEEP_STAGES`` row blocks of ``64 x W`` words."""
    w = mask_words(k)
    threads = min(1024, 128 * -(-w // 32))
    fixed = 8 * w + 8
    ring = SWEEP_STAGES * ROWS * w * 8
    staged = fixed + ring <= SMEM_BYTES
    return SweepPlan(threads, staged, fixed + (ring if staged else 0))


def scratch_bytes(b: int, k: int, rotate: bool) -> int:
    """The kernels' scratch: ``b`` frames of ``64 W`` mask rows of ``W``
    words, then, for the rotated kernel, one int a block of its mask
    kernel (``b x 2W x ceil(k / MASK_WARPS)``)."""
    w = mask_words(k)
    over = b * 2 * w * -(-k // MASK_WARPS) if rotate else 0
    return 8 * b * ROWS * w * w + 4 * over


def scratch_views(scratch: torch.Tensor, b: int, k: int, rotate: bool):
    """``(mask [b, k, W] int64, overflow [b, 2W, ceil(k / MASK_WARPS)]
    int32 or None)`` of a scratch of ``scratch_bytes(b, k, rotate)``
    bytes: the written rows of the mask (bit 63 is the sign bit) and the
    rotated mask kernel's overflow counts."""
    w = mask_words(k)
    n_mask = 8 * b * ROWS * w * w
    mask = scratch[:n_mask].view(torch.int64).view(b, ROWS * w, w)[:, :k]
    if not rotate:
        return mask, None
    return mask, scratch[n_mask:].view(torch.int32).view(
        b, 2 * w, -(-k // MASK_WARPS))


def _check_k(k: int, limit: int, what: str) -> None:
    if k > limit:
        raise ValueError(
            f"{what}: K={k} is above the kernel's limit of {limit} boxes "
            f"(its sweep keeps a bit a box in {SMEM_BYTES} bytes of shared "
            f"memory a block)")


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``[..., K]`` bool → ``[..., W]`` int64 words, bit c of word w for
    column ``64 w + c`` (bit 63 is the sign bit)."""
    k = bits.shape[-1]
    w = mask_words(k)
    padded = torch.nn.functional.pad(bits.long(), (0, ROWS * w - k))
    shifts = torch.arange(ROWS, device=bits.device)
    # distinct bits, so the sum is their OR (int64 wraps at bit 63)
    return (padded.view(*bits.shape[:-1], w, ROWS) << shifts).sum(-1)


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``[..., W]`` int64 → ``[..., k]``
    bool."""
    shifts = torch.arange(ROWS, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :k].bool()


def pair_mask_plain(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The mask stage from ``over [B, K, K]`` (row i suppresses column
    j): ``[B, K, W]`` words of ``over`` on the valid pairs i < j."""
    k = over.shape[-1]
    idx = torch.arange(k, device=over.device)
    valid = valid.to(torch.bool)
    return pack_bits(over & (idx[:, None] < idx[None, :])
                     & valid[:, :, None] & valid[:, None, :])


def greedy_mask_plain(iou: torch.Tensor, valid: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    """The matrix kernel's mask stage: ``iou [B, K, K]`` → ``[B, K, W]``
    words of ``iou > iou_threshold`` on the valid pairs i < j."""
    return pair_mask_plain(iou > iou_threshold, valid)


def rotate_mask_plain(rbboxes: torch.Tensor, valid: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    """The rotated kernel's mask stage: bit j of row i when box j clipped
    by box i (``rotate_iou(b, b)[j, i]``) exceeds the threshold, on the
    valid pairs i < j → ``[B, K, W]`` words."""
    iou = rotate_iou(rbboxes, rbboxes).transpose(-1, -2)
    return pair_mask_plain(iou > iou_threshold, valid)


def sweep_mask_plain(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The sweep stage: ``mask [B, K, W]`` words, ``valid [B, K]`` → keep
    ``[B, K]`` bool, row by row as the kernel decides them."""
    B, K, _ = mask.shape
    removed = pack_bits(~valid.to(torch.bool))
    keep = torch.zeros(B, K, dtype=torch.bool, device=mask.device)
    for i in range(K):
        w, bit = divmod(i, ROWS)
        kept = ((removed[:, w] >> bit) & 1) == 0
        keep[:, i] = kept
        removed |= torch.where(kept[:, None], mask[:, i],
                               torch.zeros_like(mask[:, i]))
    return keep


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


def _greedy_launch(iou, valid, iou_threshold):
    B, K, _ = iou.shape
    _check_k(K, GREEDY_MAX_K, "greedy_suppress")
    check(iou, "iou", torch.float32, (B, K, K))
    check(valid, "valid", torch.bool, (B, K))
    keep = torch.empty((B, K), dtype=torch.bool, device=iou.device)
    scratch = torch.empty(scratch_bytes(B, K, False), dtype=torch.uint8,
                          device=iou.device)
    if B * K:
        GREEDY(ptr(iou), ptr(valid), B, K, float(iou_threshold),
               ptr(scratch), ptr(keep), stream_of(iou))
    return keep, scratch


def _rotate_launch(rbboxes, valid, iou_threshold):
    B, K, _ = rbboxes.shape
    _check_k(K, ROTATE_MAX_K, "rotate_nms")
    check(rbboxes, "rbboxes", torch.float32, (B, K, 5))
    check(valid, "valid", torch.bool, (B, K))
    # the plain version's corners and areas, so sin and cos agree
    corners = box5_to_corners(rbboxes).contiguous()  # [B, K, 4, 2]
    areas = (rbboxes[..., 2] * rbboxes[..., 3]).contiguous()
    keep = torch.empty((B, K), dtype=torch.bool, device=rbboxes.device)
    scratch = torch.empty(scratch_bytes(B, K, True), dtype=torch.uint8,
                          device=rbboxes.device)
    if B * K:
        ROTATE(ptr(corners), ptr(areas), ptr(valid), B, K,
               float(iou_threshold), ptr(scratch), ptr(keep),
               stream_of(rbboxes))
    return keep, scratch


def greedy_suppress_cuda(iou: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    return _greedy_launch(iou, valid, iou_threshold)[0]


def rotate_nms_cuda(rbboxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    return _rotate_launch(rbboxes, valid, iou_threshold)[0]


def greedy_suppress_stages(iou: torch.Tensor, valid: torch.Tensor,
                           iou_threshold: float):
    """One kernel call (tests and the smoke) → ``(keep, mask [B, K, W]
    int64)``: the sweep's output and the mask stage's."""
    B, K, _ = iou.shape
    keep, scratch = _greedy_launch(iou, valid, iou_threshold)
    return keep, scratch_views(scratch, B, K, False)[0]


def rotate_nms_stages(rbboxes: torch.Tensor, valid: torch.Tensor,
                      iou_threshold: float):
    """One kernel call (tests and the smoke) → ``(keep, mask [B, K, W]
    int64, ring-overflow pairs)``: the sweep's output, the mask stage's,
    and how many pairs the mask kernel clipped again in its 64-slot
    ring."""
    B, K, _ = rbboxes.shape
    keep, scratch = _rotate_launch(rbboxes, valid, iou_threshold)
    mask, overflow = scratch_views(scratch, B, K, True)
    return keep, mask, int(overflow.sum()) if B * K else 0


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
