"""Mask-aware classification metrics
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


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels; ``mask [B]`` zeroes
    padded rows (for per-point logits ``[B, N, C]`` it covers each row's
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
