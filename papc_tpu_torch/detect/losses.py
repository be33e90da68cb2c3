"""Detection losses (counterpart of ``papc_tpu/detect/losses.py``).

The anchorwise weighted losses of the reference's ``core/losses.py`` as
pure functions over ``[B, A, C]`` tensors, op for op as the JAX package
writes them: weighted L2 and smooth-L1 localization; weighted sigmoid,
sigmoid-focal, softmax-focal, weighted-softmax and bootstrapped-sigmoid
classification.
"""

from __future__ import annotations

import torch


def _as(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def sigmoid_cross_entropy_with_logits(logits, labels):
    """Numerically stable per-element sigmoid cross-entropy."""
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def softmax_cross_entropy_with_logits(logits, labels):
    """Per-row softmax cross-entropy against one-hot (or soft) labels."""
    return -torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1)


def weighted_l2_localization_loss(pred, target, weights, code_weights=None):
    """``[B, A, C]`` → ``[B, A]``."""
    diff = pred - target
    if code_weights is not None:
        diff = _as(code_weights, diff)[None, None, :] * diff
    weighted = diff * weights[..., None]
    return torch.sum(0.5 * weighted * weighted, dim=2)


def weighted_smooth_l1_localization_loss(pred, target, weights=None,
                                         sigma=3.0, code_weights=None,
                                         codewise=True):
    """``[B, A, C]`` → ``[B, A, C]`` (``codewise``) or ``[B, A]``."""
    diff = pred - target
    if code_weights is not None:
        diff = _as(code_weights, diff)[None, None, :] * diff
    abs_diff = torch.abs(diff)
    cut = 1.0 / (sigma**2)
    lt = (abs_diff <= cut).to(diff.dtype)
    loss = (lt * 0.5 * torch.square(abs_diff * sigma)
            + (abs_diff - 0.5 * cut) * (1.0 - lt))
    if codewise:
        if weights is not None:
            loss = loss * weights[..., None]
        return loss
    loss = torch.sum(loss, dim=2)
    if weights is not None:
        loss = loss * weights
    return loss


def weighted_sigmoid_classification_loss(pred, target, weights):
    """``[B, A, C]`` → ``[B, A, C]``."""
    return sigmoid_cross_entropy_with_logits(pred, target) * weights[..., None]


def sigmoid_focal_classification_loss(pred, target, weights, gamma=2.0,
                                      alpha=0.25):
    """Sigmoid focal loss, ``[B, A, C]`` → ``[B, A, C]``."""
    ce = sigmoid_cross_entropy_with_logits(pred, target)
    prob = torch.sigmoid(pred)
    p_t = target * prob + (1 - target) * (1 - prob)
    modulating = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    if alpha is not None:
        alpha_w = target * alpha + (1 - target) * (1 - alpha)
    else:
        alpha_w = 1.0
    return modulating * alpha_w * ce * weights[..., None]


def softmax_focal_classification_loss(pred, target, weights, gamma=2.0,
                                      alpha=0.25):
    """Softmax focal loss; ``target`` one-hot with class 0 the background
    (alpha swaps for background rows)."""
    ce = softmax_cross_entropy_with_logits(pred, target)[..., None] * target
    prob = torch.softmax(pred, dim=-1)
    p_t = target * prob + (1 - target) * (1 - prob)
    modulating = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    if alpha is not None:
        alpha_w = torch.where(target[..., 0] == 1, 1 - alpha,
                              alpha)[..., None].to(pred.dtype)
    else:
        alpha_w = 1.0
    return modulating * alpha_w * ce * weights[..., None]


def weighted_softmax_classification_loss(pred, target, weights,
                                         logit_scale=1.0):
    """``[B, A, C]`` → ``[B, A]`` (the direction classifier's loss)."""
    ce = softmax_cross_entropy_with_logits(pred / logit_scale, target)
    return ce * weights


def bootstrapped_sigmoid_classification_loss(pred, target, weights, alpha,
                                             bootstrap_type="soft"):
    """Bootstrapped sigmoid cross-entropy: the target mixed with the
    prediction (``"soft"``) or its 0.5-thresholded value (``"hard"``)."""
    if bootstrap_type == "soft":
        boot = alpha * target + (1.0 - alpha) * torch.sigmoid(pred)
    else:
        boot = alpha * target + (1.0 - alpha) * (
            torch.sigmoid(pred) > 0.5).to(pred.dtype)
    return sigmoid_cross_entropy_with_logits(pred, boot) * weights[..., None]
