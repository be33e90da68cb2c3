"""Mask-aware classification and segmentation metrics
(counterpart of ``papc_tpu/train/metrics.py``)."""

from __future__ import annotations

import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Top-1 accuracy. logits ``[B, C]``, labels ``[B]``, mask ``[B]``."""
    correct = (torch.argmax(logits, dim=-1) == labels).float()
    if mask is None:
        return correct.mean()
    m = mask.float()
    return (correct * m).sum() / m.sum().clamp_min(1.0)


def mean_iou(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean IoU over the classes whose union is non-zero. ``logits [B, N,
    C]`` (or argmaxed predictions ``[B, N]``), ``labels [B, N]``, ``mask
    [B]`` batch-row validity, repeated over each row's points."""
    preds = logits.argmax(-1) if logits.ndim == labels.ndim + 1 else logits
    preds, labels = preds.reshape(-1), labels.reshape(-1)
    if mask is None:
        valid = torch.ones_like(labels, dtype=torch.bool)
    else:
        valid = mask.bool().repeat_interleave(labels.numel() // mask.numel())
    cls = torch.arange(num_classes, device=labels.device)[:, None]
    pred_hit = (preds[None, :] == cls) & valid[None, :]
    label_hit = (labels[None, :] == cls) & valid[None, :]
    intersection = (pred_hit & label_hit).sum(1).float()
    union = (pred_hit | label_hit).sum(1).float()
    present = union > 0
    iou = torch.where(present, intersection / union.clamp_min(1.0), 0.0)
    return iou.sum() / present.sum().float().clamp_min(1.0)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels; ``mask [B]`` zeroes
    padded rows (for per-point logits ``[B, N, C]`` and labels ``[B, N]``
    it covers each row's points, and the mean runs over the valid
    points)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    m = mask.float()
    while m.ndim < nll.ndim:
        m = m[..., None]
    m = m.expand_as(nll)
    return (nll * m).sum() / m.sum().clamp_min(1.0)
