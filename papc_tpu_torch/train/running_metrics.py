"""Running metrics of detection training (counterpart of
``papc_tpu/train/running_metrics.py``).

Immutable states of tensors on the step's device, as JAX's pytree
states: ``update`` returns a new state, so a step hands them on without
a host sync. ``AccuracyState`` and ``PrecisionRecallState`` read class
logits ``preds [B, A, C]`` (``channel_axis`` names another class axis)
against ``labels [B, A]`` (-1 ignore, 0 background, > 0 class).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _zeros(device, shape=()) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


class ScalarState(NamedTuple):
    total: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, device="cpu"):
        return cls(_zeros(device), _zeros(device))

    def update(self, value):
        return ScalarState(self.total + value, self.count + 1.0)

    @property
    def value(self):
        return self.total / torch.clamp_min(self.count, 1.0)


def _scores_and_labels(preds, use_sigmoid_score=True,
                       encode_background_as_zeros=True, channel_axis=-1):
    """Class logits → ``(score, pred_label)``, the best foreground class's
    score and its label (background 0, so foreground from 1)."""
    ax = channel_axis
    if encode_background_as_zeros:
        scores = (torch.sigmoid(preds) if use_sigmoid_score
                  else torch.softmax(preds, ax))
        score = torch.amax(scores, dim=ax)
        pred_label = torch.argmax(preds, dim=ax) + 1
    else:
        fg = preds.narrow(ax, 1, preds.shape[ax] - 1)
        scores = (torch.sigmoid(fg) if use_sigmoid_score
                  else torch.softmax(preds, ax).narrow(
                      ax, 1, preds.shape[ax] - 1))
        score = torch.amax(scores, dim=ax)
        pred_label = torch.argmax(fg, dim=ax) + 1
    return score, pred_label


def _weights(labels, weights):
    if weights is None:
        return (labels >= 0).float()
    return weights.float()


class AccuracyState(NamedTuple):
    total: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, device="cpu"):
        return cls(_zeros(device), _zeros(device))

    def update(self, labels, preds, weights=None, threshold=0.5,
               use_sigmoid_score=True, encode_background_as_zeros=True,
               channel_axis=-1):
        """A prediction is its best class where that score passes
        ``threshold``, else background; counts the cared anchors."""
        score, pred_label = _scores_and_labels(
            preds, use_sigmoid_score, encode_background_as_zeros,
            channel_axis)
        pred_label = torch.where(score > threshold, pred_label, 0)
        correct = (pred_label == labels).float()
        w = _weights(labels, weights)
        return AccuracyState(self.total + torch.sum(correct * w),
                             self.count + torch.sum(w))

    @property
    def value(self):
        return self.total / torch.clamp_min(self.count, 1.0)


class PrecisionRecallState(NamedTuple):
    """Running true and false positives and negatives ``[T]`` at each of
    the ``thresholds`` on the best foreground score."""

    tp: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor
    tn: torch.Tensor
    thresholds: torch.Tensor

    @classmethod
    def create(cls, thresholds=(0.1, 0.3, 0.5, 0.7, 0.8, 0.9, 0.95),
               device="cpu"):
        t = torch.as_tensor(thresholds, dtype=torch.float32, device=device)
        z = torch.zeros_like(t)
        return cls(z, z, z, z, t)

    def update(self, labels, preds, weights=None, use_sigmoid_score=True,
               encode_background_as_zeros=True, channel_axis=-1):
        score, _ = _scores_and_labels(preds, use_sigmoid_score,
                                      encode_background_as_zeros,
                                      channel_axis)
        w = _weights(labels, weights)
        pos = ((labels > 0).float() * w).flatten()
        neg = ((labels == 0).float() * w).flatten()
        # [T, N]: each threshold against every anchor
        pred_pos = ((score.flatten()[None, :] > self.thresholds[:, None])
                    .float() * w.flatten())
        tp = torch.sum(pred_pos * pos, dim=1)
        fp = torch.sum(pred_pos * neg, dim=1)
        fn = torch.sum((1 - pred_pos) * pos, dim=1)
        tn = torch.sum((1 - pred_pos) * neg, dim=1)
        return PrecisionRecallState(self.tp + tp, self.fp + fp,
                                    self.fn + fn, self.tn + tn,
                                    self.thresholds)

    @property
    def precision(self):
        return self.tp / torch.clamp_min(self.tp + self.fp, 1.0)

    @property
    def recall(self):
        return self.tp / torch.clamp_min(self.tp + self.fn, 1.0)
