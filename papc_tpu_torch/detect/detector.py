"""Detection loss assembly and post-processing (counterpart of
``papc_tpu/detect/detector.py``).

The loss half (``prepare_loss_weights``, ``add_sin_difference``,
``get_direction_target``, ``get_pos_neg_loss``, ``LossConfig``,
``compute_loss``) runs in the reference layout ``[B, A, C]``, as JAX's
``compute_loss_bac`` writes it; JAX's production ``compute_loss`` is the
same arithmetic in a ``[B, C, A]`` layout for TPU tiling, which the port
does not carry. The post-processing (``PredictConfig``, ``decode_raw``,
``apply_direction_flip``, ``predict``) is batched over the frames where
JAX ``vmap``s. ``predict_multiclass`` is the per-class NMS of the
3-class config: JAX runs it on the host in C++ frame by frame and class
by class; the port runs it on the device, one NMS launch over every
frame and class of a batch.

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

import torch.nn.functional as F

from papc_tpu_torch.detect import losses as L
from papc_tpu_torch.ops.iou import box5_to_corners, iou_2d
from papc_tpu_torch.ops.nms import greedy_suppress, rotate_nms


# ------------------------------------------------------------------ loss

def prepare_loss_weights(labels: torch.Tensor, pos_cls_weight: float = 1.0,
                         neg_cls_weight: float = 1.0,
                         loss_norm_type: str = "NormByNumPositives"):
    """``labels [B, A]`` (-1 ignore, 0 background, > 0 class) →
    ``(cls_weights [B, A], reg_weights [B, A], cared [B, A] bool)``."""
    cared = labels >= 0
    positives = (labels > 0).float()
    negatives = (labels == 0).float()
    cls_weights = neg_cls_weight + pos_cls_weight * positives
    reg_weights = positives
    if loss_norm_type == "NormByNumExamples":
        num_examples = torch.clamp_min(
            cared.float().sum(1, keepdim=True), 1.0)
        cls_weights = cls_weights / num_examples
        bbox_norm = torch.clamp_min(positives.sum(1, keepdim=True), 1.0)
        reg_weights = reg_weights / bbox_norm
    elif loss_norm_type == "NormByNumPositives":
        pos_norm = torch.clamp_min(positives.sum(1, keepdim=True), 1.0)
        reg_weights = reg_weights / pos_norm
        cls_weights = cls_weights / pos_norm
    elif loss_norm_type == "NormByNumPosNeg":
        pos_neg = torch.stack([positives, negatives], -1)
        normalizer = pos_neg.sum(1, keepdim=True)  # [B, 1, 2]
        cls_normalizer = torch.clamp_min((pos_neg * normalizer).sum(-1), 1.0)
        normalizer = torch.clamp_min(normalizer, 1.0)
        reg_weights = reg_weights / normalizer[:, 0:1, 0]
        cls_weights = cls_weights / cls_normalizer
    else:
        raise ValueError(f"unknown loss norm type {loss_norm_type}")
    return cls_weights, reg_weights, cared


def add_sin_difference(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """The angle dims replaced by ``sin(a)·cos(b)`` and ``cos(a)·sin(b)``,
    so that the loss of their difference sees ``sin(a - b)``."""
    rad_pred = torch.sin(boxes1[..., -1:]) * torch.cos(boxes2[..., -1:])
    rad_tg = torch.cos(boxes1[..., -1:]) * torch.sin(boxes2[..., -1:])
    return (torch.cat([boxes1[..., :-1], rad_pred], dim=-1),
            torch.cat([boxes2[..., :-1], rad_tg], dim=-1))


def get_direction_target(anchors: torch.Tensor, reg_targets: torch.Tensor,
                         one_hot: bool = True) -> torch.Tensor:
    """The direction classifier's target: 1 where the ground truth's yaw
    (target plus anchor) is positive; ``anchors [B, A, 7]``,
    ``reg_targets [B, A, C]``."""
    t = (reg_targets[..., -1] + anchors[..., -1] > 0).long()
    if one_hot:
        return F.one_hot(t, 2).to(reg_targets.dtype)
    return t


def get_pos_neg_loss(cls_loss: torch.Tensor, labels: torch.Tensor):
    """The weighted classification loss split into its positive and
    negative sums over the batch, each over ``B``."""
    B = cls_loss.shape[0]
    if cls_loss.dim() == 2 or cls_loss.shape[-1] == 1:
        flat = cls_loss.reshape(B, -1)
        pos = ((labels > 0) * flat).sum() / B
        neg = ((labels == 0) * flat).sum() / B
    else:
        pos = cls_loss[..., 1:].sum() / B
        neg = cls_loss[..., 0].sum() / B
    return pos, neg


@dataclasses.dataclass(frozen=True)
class LossConfig:
    num_class: int = 1
    encode_background_as_zeros: bool = True
    encode_rad_error_by_sin: bool = True
    box_code_size: int = 7
    pos_cls_weight: float = 1.0
    neg_cls_weight: float = 1.0
    loss_norm_type: str = "NormByNumPositives"
    cls_loss_weight: float = 1.0
    loc_loss_weight: float = 2.0
    direction_loss_weight: float = 2.0
    use_direction_classifier: bool = True
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_sigma: float = 3.0
    code_weights: tuple = (1.0,) * 7


def compute_loss(preds: dict, labels: torch.Tensor,
                 reg_targets: torch.Tensor, anchors: torch.Tensor,
                 cfg: LossConfig):
    """The total detection loss from the RPN's head maps (``[B, H, W,
    na·c]``, anchors in (h, w, a) order), ``labels [B, A]``,
    ``reg_targets [B, A, code]`` and ``anchors [B, A, 7]`` → ``(loss,
    metrics)``: smooth-L1 on the box codes (the angle by its sine), sigmoid
    focal on the classes, softmax on the direction, with JAX's metrics
    (``loc_loss``, ``cls_loss``, ``cls_pos_loss``, ``cls_neg_loss``,
    ``num_pos``, ``num_neg``, ``dir_loss``, ``loss``)."""
    B = labels.shape[0]
    box_preds = preds["box_preds"].reshape(B, -1, cfg.box_code_size)
    ncls = (cfg.num_class if cfg.encode_background_as_zeros
            else cfg.num_class + 1)
    cls_preds = preds["cls_preds"].reshape(B, -1, ncls)

    cls_weights, reg_weights, cared = prepare_loss_weights(
        labels, cfg.pos_cls_weight, cfg.neg_cls_weight, cfg.loss_norm_type)
    cls_targets = (labels * cared).long()
    one_hot = F.one_hot(cls_targets, cfg.num_class + 1).to(box_preds.dtype)
    if cfg.encode_background_as_zeros:
        one_hot = one_hot[..., 1:]

    bp, rt = box_preds, reg_targets
    if cfg.encode_rad_error_by_sin:
        bp, rt = add_sin_difference(bp, rt)
    loc_loss = L.weighted_smooth_l1_localization_loss(
        bp, rt, weights=reg_weights, sigma=cfg.smooth_l1_sigma,
        code_weights=list(cfg.code_weights))
    cls_loss = L.sigmoid_focal_classification_loss(
        cls_preds, one_hot, weights=cls_weights, gamma=cfg.focal_gamma,
        alpha=cfg.focal_alpha)
    loc_loss_reduced = loc_loss.sum() / B * cfg.loc_loss_weight
    cls_loss_reduced = cls_loss.sum() / B * cfg.cls_loss_weight
    loss = loc_loss_reduced + cls_loss_reduced

    cls_pos, cls_neg = get_pos_neg_loss(cls_loss, labels)
    metrics = {
        "loc_loss": loc_loss_reduced,
        "cls_loss": cls_loss_reduced,
        "cls_pos_loss": cls_pos / cfg.pos_cls_weight,
        "cls_neg_loss": cls_neg / cfg.neg_cls_weight,
        "num_pos": (labels > 0).sum(),
        "num_neg": (labels == 0).sum(),
    }
    if cfg.use_direction_classifier and "dir_cls_preds" in preds:
        dir_targets = get_direction_target(anchors, reg_targets)
        dir_logits = preds["dir_cls_preds"].reshape(B, -1, 2)
        weights = (labels > 0).to(dir_logits.dtype)
        weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True),
                                            1.0)
        dir_loss = L.weighted_softmax_classification_loss(
            dir_logits, dir_targets, weights).sum() / B
        loss = loss + dir_loss * cfg.direction_loss_weight
        metrics["dir_loss"] = dir_loss
    metrics["loss"] = loss
    return loss, metrics


# -------------------------------------------------------- post-processing


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


def multiclass_candidates(boxes: torch.Tensor, total_scores: torch.Tensor,
                          dir_labels: torch.Tensor, cfg: PredictConfig,
                          anchors_mask: torch.Tensor | None = None):
    """The per-class NMS input of ``predict_multiclass``: for each frame
    and class, the anchors whose class score (0 outside ``anchors_mask``)
    is at least ``nms_score_threshold`` (all of them at a threshold of 0
    or below), score-sorted, the first ``K = min(nms_pre_max_size, A)``
    → ``(boxes [B, C, K, 7], scores [B, C, K], dir_labels [B, C, K], ok
    [B, C, K])``; ``ok`` marks the candidates, the rest pad."""
    B, A, C = total_scores.shape
    scores = total_scores
    if anchors_mask is not None:
        scores = torch.where(anchors_mask[..., None], scores, 0.0)
    scores = scores.transpose(1, 2)  # [B, C, A]
    thr = cfg.nms_score_threshold
    passed = (scores >= thr if thr > 0.0
              else torch.ones_like(scores, dtype=torch.bool))
    K = min(cfg.nms_pre_max_size, A)
    keyed = torch.where(passed, scores, -math.inf)
    top_s, top_idx = torch.sort(keyed, dim=-1, descending=True, stable=True)
    top_s, top_idx = top_s[..., :K], top_idx[..., :K]
    ok = top_s > -math.inf
    flat = top_idx.reshape(B, C * K)
    b = torch.gather(boxes, 1, flat[..., None].expand(B, C * K,
                                                      boxes.shape[-1]))
    d = torch.gather(dir_labels, 1, flat)
    return (b.reshape(B, C, K, -1), torch.where(ok, top_s, 0.0),
            d.reshape(B, C, K), ok)


def predict_multiclass(boxes: torch.Tensor, total_scores: torch.Tensor,
                       dir_labels: torch.Tensor, cfg: PredictConfig,
                       anchors_mask: torch.Tensor | None = None, *,
                       impl: str | None = None) -> dict:
    """Per-class NMS over the shared decoded boxes (``decode_raw``'s
    ``boxes [B, A, 7]``, ``total_scores [B, A, C]``, ``dir_labels [B,
    A]``) → the fixed-size detections of :func:`predict`.

    The candidates of each frame and class (``multiclass_candidates``)
    go through one ``nms_keep`` over ``[B·C, K]`` rows: one launch of the
    rotated NMS (or, with ``use_rotate_nms`` false, of the standup sweep
    over the boxes' axis-aligned hulls) for the whole batch. A class keeps
    its first ``nms_post_max_size`` survivors; each frame's classes are
    concatenated in class order and cut to ``nms_post_max_size`` (a class
    may fill every slot), the direction flip applied, as JAX's
    ``predict_multiclass``. ``label_preds`` is the class index."""
    B, A, C = total_scores.shape
    b, s, d, ok = multiclass_candidates(boxes, total_scores, dir_labels, cfg,
                                        anchors_mask)
    K = b.shape[2]
    keep = nms_keep(b.reshape(B * C, K, -1), ok.reshape(B * C, K), cfg,
                    impl=impl).reshape(B, C, K)
    P = cfg.nms_post_max_size
    rank = torch.cumsum(keep, dim=-1) - 1
    chosen = keep & (rank < P)
    n = chosen.sum(-1)  # [B, C]
    slot = (torch.cumsum(n, dim=-1) - n)[..., None] + rank
    slot = torch.where(chosen & (slot < P), slot, P).reshape(B, C * K)
    labels = torch.arange(C, device=boxes.device)[None, :, None].expand(
        B, C, K)
    out_boxes = _compact(b.reshape(B, C * K, -1), slot, P)
    out = {
        "box3d_lidar": out_boxes,
        "scores": _compact(s.reshape(B, C * K), slot, P),
        "label_preds": _compact(labels.reshape(B, C * K), slot, P),
        "valid": _compact(chosen.reshape(B, C * K), slot, P),
    }
    if cfg.use_direction_classifier:
        out["box3d_lidar"] = apply_direction_flip(
            out_boxes, _compact(d.reshape(B, C * K), slot, P))
    return out
