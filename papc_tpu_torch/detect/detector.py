"""Detection post-processing (counterpart of ``PredictConfig``,
``decode_raw``, ``apply_direction_flip`` and ``predict`` in
``papc_tpu/detect/detector.py``), batched over the frames where JAX
``vmap``s.

Ties: with untrained weights, empty BEV cells give exactly equal scores
over large regions. ``jax.lax.top_k`` returns tied entries lower index
first, and ``torch.topk`` promises no order for ties on the card, so the
top K come from a stable descending sort. ``torch.argmax`` returns the
first maximum, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from papc_tpu_torch.ops.iou import box5_to_corners, iou_2d
from papc_tpu_torch.ops.nms import greedy_suppress, rotate_nms


@dataclasses.dataclass(frozen=True)
class PredictConfig:
    num_class: int = 1
    encode_background_as_zeros: bool = True
    use_direction_classifier: bool = True
    use_rotate_nms: bool = True
    multiclass_nms: bool = False
    nms_pre_max_size: int = 1000
    nms_post_max_size: int = 300
    nms_score_threshold: float = 0.15
    nms_iou_threshold: float = 0.5
    box_code_size: int = 7


def decode_raw(preds: dict, anchors: torch.Tensor, decode_fn: Callable,
               cfg: PredictConfig):
    """Decoded boxes ``[B, A, 7]``, per-class sigmoid scores ``[B, A,
    num_class]`` and direction labels ``[B, A]``."""
    B, A = anchors.shape[:2]
    box_preds = preds["box_preds"].reshape(B, A, cfg.box_code_size)
    ncls = (cfg.num_class if cfg.encode_background_as_zeros
            else cfg.num_class + 1)
    cls_preds = preds["cls_preds"].reshape(B, A, ncls)
    boxes = decode_fn(box_preds, anchors)
    total_scores = torch.sigmoid(cls_preds)
    if not cfg.encode_background_as_zeros:
        total_scores = total_scores[..., 1:]
    if cfg.use_direction_classifier:
        dir_labels = torch.argmax(preds["dir_cls_preds"].reshape(B, A, 2),
                                  dim=-1)
    else:
        dir_labels = torch.zeros((B, A), dtype=torch.int64,
                                 device=anchors.device)
    return boxes, total_scores, dir_labels


def apply_direction_flip(boxes7: torch.Tensor,
                         dir_labels: torch.Tensor) -> torch.Tensor:
    """Add pi to the yaw exactly where ``(yaw > 0) XOR dir_label`` (strict
    ``> 0``: a yaw of exactly 0 is on the non-positive side)."""
    opp = (boxes7[..., -1] > 0) ^ dir_labels.to(torch.bool)
    yaw = boxes7[..., -1] + torch.where(opp, math.pi, 0.0)
    return torch.cat([boxes7[..., :-1], yaw[..., None]], dim=-1)


def _compact(values: torch.Tensor, slot: torch.Tensor, P: int):
    """Rows of ``values [B, K, ...]`` to ``slot [B, K]`` of a zero
    ``[B, P + 1, ...]``; slot P is the dump, sliced off."""
    B, K = slot.shape
    out = torch.zeros((B, P + 1, *values.shape[2:]), dtype=values.dtype,
                      device=values.device)
    rows = (torch.arange(B, device=slot.device)[:, None] * (P + 1)
            + slot).reshape(-1)
    out.view(B * (P + 1), *values.shape[2:]).index_put_(
        (rows,), values.reshape(B * K, *values.shape[2:]))
    return out[:, :P]


def top_candidates(preds: dict, anchors: torch.Tensor, decode_fn: Callable,
                   cfg: PredictConfig,
                   anchors_mask: torch.Tensor | None = None):
    """The NMS input: the ``K = min(nms_pre_max_size, A)`` best anchors
    per frame, score-sorted → ``(boxes [B, K, 7], scores [B, K], labels
    [B, K], dir_labels [B, K], ok [B, K])``; ``ok`` marks candidates that
    passed the score threshold (and the anchors mask)."""
    B, A = anchors.shape[:2]
    boxes, total_scores, dir_labels = decode_raw(preds, anchors, decode_fn,
                                                 cfg)
    top_scores = torch.amax(total_scores, dim=-1)
    top_labels = torch.argmax(total_scores, dim=-1)
    valid = top_scores >= cfg.nms_score_threshold
    if anchors_mask is not None:
        valid = valid & anchors_mask
    K = min(cfg.nms_pre_max_size, A)
    scores_masked = torch.where(valid, top_scores, -1.0)
    top_s, top_idx = torch.sort(scores_masked, dim=-1, descending=True,
                                stable=True)
    top_s, top_idx = top_s[:, :K], top_idx[:, :K]
    b = torch.gather(boxes, 1, top_idx[..., None].expand(B, K,
                                                         boxes.shape[-1]))
    return (b, top_s, torch.gather(top_labels, 1, top_idx),
            torch.gather(dir_labels, 1, top_idx), top_s > 0)


def nms_keep(boxes: torch.Tensor, ok: torch.Tensor, cfg: PredictConfig, *,
             impl: str | None = None) -> torch.Tensor:
    """The NMS of ``predict``: rotated over the BEV boxes, or standup
    over their axis-aligned hulls → keep ``[B, K]``."""
    bev = boxes[..., [0, 1, 3, 4, 6]]
    if cfg.use_rotate_nms:
        return rotate_nms(bev, ok, cfg.nms_iou_threshold, impl=impl)
    corners = box5_to_corners(bev)
    standup = torch.cat([corners.amin(-2), corners.amax(-2)], dim=-1)
    return greedy_suppress(iou_2d(standup, standup), ok,
                           cfg.nms_iou_threshold, impl=impl)


def predict(preds: dict, anchors: torch.Tensor, decode_fn: Callable,
            cfg: PredictConfig, anchors_mask: torch.Tensor | None = None, *,
            impl: str | None = None) -> dict:
    """Batched post-processing → fixed-size detections: ``box3d_lidar
    [B, post, 7]``, ``scores [B, post]``, ``label_preds [B, post]``,
    ``valid [B, post]``. ``impl`` goes to the NMS op."""
    b, top_s, lab, d, ok = top_candidates(preds, anchors, decode_fn, cfg,
                                          anchors_mask)
    keep = nms_keep(b, ok, cfg, impl=impl)
    # compact the kept detections to the front, at most post_max_size
    rank = torch.cumsum(keep, dim=-1) - 1
    P = cfg.nms_post_max_size
    slot = torch.where(keep & (rank < P), rank, P)
    out_boxes = _compact(b, slot, P)
    out = {
        "box3d_lidar": out_boxes,
        "scores": _compact(top_s, slot, P),
        "label_preds": _compact(lab, slot, P),
        "valid": _compact(keep, slot, P),
    }
    if cfg.use_direction_classifier:
        out["box3d_lidar"] = apply_direction_flip(out_boxes,
                                                  _compact(d, slot, P))
    return out
