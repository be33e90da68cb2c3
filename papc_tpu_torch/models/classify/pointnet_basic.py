"""PointNet-Basic classifier (counterpart of
``papc_tpu/models/classify/pointnet_basic.py``).

PointMLP 3→64→64, PointMLP 64→128→``max_points``, the global max over
the points, then the head 512→256→Dropout(0.7)→classes.
"""

from __future__ import annotations

import torch
from torch import nn

from papc_tpu_torch.nn import MLPHead, PointMLP, global_max_pool
from papc_tpu_torch.nn.layers import init_params


class PointNetBasicClas(nn.Module):
    mode = "clas"
    input_kind = "points"

    def __init__(self, num_classes: int = 16, max_points: int = 1024,
                 generator: torch.Generator | None = None):
        """``generator`` seeds flax's initial values
        (``nn.layers.init_params``); without one, torch's own defaults."""
        super().__init__()
        self.num_classes = num_classes
        self.PointMLP_0 = PointMLP(3, (64, 64))
        self.PointMLP_1 = PointMLP(64, (64, 128, max_points))
        self.MLPHead_0 = MLPHead(max_points, (512, 256), num_classes,
                                 dropout_rate=0.7)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """``points [B, N, 3]`` → logits ``[B, num_classes]``. ``impl`` is
        taken for the entry points' sake: no op of this model has a
        kernel. In training the head's one dropout site takes a ``[B,
        256]`` keep mask from ``dropout_masks`` or ``generator``."""
        x = self.PointMLP_1(self.PointMLP_0(points))
        return self.MLPHead_0(global_max_pool(x), generator=generator,
                              masks=dropout_masks)
