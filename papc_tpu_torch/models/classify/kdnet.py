"""KD-Net classifier: axis-conditioned convolutions over a balanced
kd-tree (counterpart of ``papc_tpu/models/classify/kdnet.py``).

Each level (``KDConv``): a Dense to three feature banks of F channels
(one per split axis; channel ``c = bank·F + f``), BN (KD-UNet's levels
only), ReLU, then each position selects the bank of its split axis and
sibling pairs are max-pooled, halving the points. KDNet runs log2(N)
levels, 1024→1 at N = 1024 with the reference's widths; a shallower tree
takes the truncated progression ending at the 128-wide Dense input.

The select keeps JAX's documented deviation from the reference: position
``j`` takes bank ``split[j]`` (the reference's flattened index scrambles
bank and position).
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

from papc_tpu_torch.nn import BatchNorm
from papc_tpu_torch.nn.layers import dense, init_params

KDNET_WIDTHS = (32, 64, 64, 128, 128, 256, 256, 512, 512, 128)


def kdnet_widths(n_points: int) -> tuple:
    """The level widths for clouds of ``n_points`` (a power of two)."""
    levels = int(math.log2(n_points))
    if levels == len(KDNET_WIDTHS):
        return KDNET_WIDTHS
    return KDNET_WIDTHS[:levels - 1] + (128,)


def kd_select_pool(h: torch.Tensor, split: torch.Tensor) -> torch.Tensor:
    """``h [B, dim, 3, F]`` per-axis banks, ``split [B, dim]`` int split
    axis a position (siblings share it) → ``[B, dim // 2, F]``: the
    3-way select on ``split``, then the max over sibling pairs."""
    B, dim, _, F = h.shape
    sel = split.reshape(B, dim, 1)
    x = torch.where(sel == 0, h[:, :, 0], torch.where(sel == 1, h[:, :, 1],
                                                      h[:, :, 2]))
    return torch.amax(x.reshape(B, dim // 2, 2, F), dim=2)


class KDConv(nn.Module):
    """One level: Dense(3F) (→ BN) → ReLU → select → pair max."""

    def __init__(self, in_features: int, featdim: int, use_bn: bool = False):
        super().__init__()
        self.featdim = featdim
        self.Dense_0 = nn.Linear(in_features, 3 * featdim)
        if use_bn:
            self.BatchNorm_0 = BatchNorm(3 * featdim)
        self.use_bn = use_bn

    def forward(self, x: torch.Tensor, split: torch.Tensor) -> torch.Tensor:
        B, dim, _ = x.shape
        h = dense(self.Dense_0, x)
        if self.use_bn:
            h = self.BatchNorm_0(h)
        h = torch.relu(h).reshape(B, dim, 3, self.featdim)
        return kd_select_pool(h, split)


class KDNet(nn.Module):
    mode = "clas"
    input_kind = "kd"

    def __init__(self, num_classes: int = 16, max_point: int = 1024,
                 generator: torch.Generator | None = None):
        """``max_point``: the clouds' size N, a power of two, which sets
        the depth (JAX's model reads it from the input's shape)."""
        super().__init__()
        self.num_classes = num_classes
        self.widths = kdnet_widths(max_point)
        cins = (3,) + self.widths[:-1]
        for level, (cin, width) in enumerate(zip(cins, self.widths)):
            self.add_module(f"KDConv_{level}", KDConv(cin, width))
        self.Dense_0 = nn.Linear(self.widths[-1], num_classes)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, split_dims: Sequence[torch.Tensor],
                impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """``points [B, N, 3]`` leaf-ordered, ``split_dims``: log2(N)
        tensors, level l ``[B, N >> l]`` → logits ``[B, num_classes]``.
        ``impl`` and the dropout arguments are taken for the entry
        points' sake: the model has neither a kernel nor dropout."""
        x = points
        for level in range(len(self.widths)):
            x = getattr(self, f"KDConv_{level}")(x, split_dims[level])
        return dense(self.Dense_0, x.reshape(x.shape[0], self.widths[-1]))
