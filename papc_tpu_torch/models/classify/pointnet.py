"""PointNet classifiers with the input and feature T-Nets (counterpart of
``papc_tpu/models/classify/pointnet.py``).

Input T-Net (3x3), PointMLP 3→64→64, feature T-Net (64x64), PointMLP
64→128→1024, the global max, then the head 512→256→Dropout(0.7)→classes.
Each transform is the batched product ``bnk,bkj->bnj``. The Conv2D
variant is the same network with a log-softmax after the head.
"""

from __future__ import annotations

import torch
from torch import nn

from papc_tpu_torch.nn import MLPHead, PointMLP, TNet, global_max_pool
from papc_tpu_torch.nn.layers import init_params


class PointNetClas(nn.Module):
    mode = "clas"
    input_kind = "points"

    def __init__(self, num_classes: int = 16, max_point: int = 2048,
                 generator: torch.Generator | None = None):
        """``max_point`` is taken for the registry's sake and unused: the
        pooling is global."""
        super().__init__()
        self.num_classes = num_classes
        self.input_tnet = TNet(3)
        self.PointMLP_0 = PointMLP(3, (64, 64))
        self.feature_tnet = TNet(64)
        self.PointMLP_1 = PointMLP(64, (64, 128, 1024))
        self.MLPHead_0 = MLPHead(1024, (512, 256), num_classes,
                                 dropout_rate=0.7)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """``points [B, N, 3]`` → logits ``[B, num_classes]``; ``impl``
        and the dropout arguments as for ``PointNetBasicClas``."""
        x = torch.bmm(points, self.input_tnet(points))
        x = self.PointMLP_0(x)
        x = torch.bmm(x, self.feature_tnet(x))
        x = global_max_pool(self.PointMLP_1(x))
        return self.MLPHead_0(x, generator=generator, masks=dropout_masks)


class PointNetConv2DClas(PointNetClas):
    """The reference's Conv2D-flavoured PointNet: the same network and
    tree, returning log-probabilities."""

    def forward(self, points: torch.Tensor, impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        logits = super().forward(points, impl, generator=generator,
                                 dropout_masks=dropout_masks)
        return torch.log_softmax(logits, dim=-1)
