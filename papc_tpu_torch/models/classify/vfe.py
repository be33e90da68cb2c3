"""VFE (VoxelNet-style feature encoder) classifier (counterpart of
``papc_tpu/models/classify/vfe.py``).

Stage 1: PointMLP 3→64→64 and 64→128→F (F = 256); the global max tiled
back and concatenated onto every point (2F). Stage 2: PointMLP 2F→64→64
and 64→128→``max_points``. The classifier takes the global max of stage
2 into the head 512→256→Dropout(0.7)→classes.
"""

from __future__ import annotations

import torch
from torch import nn

from papc_tpu_torch.nn import MLPHead, PointMLP, global_max_pool
from papc_tpu_torch.nn.layers import init_params


def tile_global_max(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``[x | max over the points of g]`` on every point: ``[B, N, C_x +
    C_g]``."""
    pooled = torch.amax(g, dim=1, keepdim=True).expand(
        x.shape[0], x.shape[1], g.shape[-1])
    return torch.cat([x, pooled], dim=-1)


class VFEBlock(nn.Module):
    """The two stages; returns ``(x1 [B, N, 2F], x2 [B, N,
    max_points])``, which the segmentation model reuses."""

    def __init__(self, feature_channels: int = 256, max_points: int = 1024):
        super().__init__()
        f = feature_channels
        self.PointMLP_0 = PointMLP(3, (64, 64))
        self.PointMLP_1 = PointMLP(64, (64, 128, f))
        self.PointMLP_2 = PointMLP(2 * f, (64, 64))
        self.PointMLP_3 = PointMLP(64, (64, 128, max_points))

    def forward(self, points: torch.Tensor):
        x1 = self.PointMLP_1(self.PointMLP_0(points))
        x1 = tile_global_max(x1, x1)
        x2 = self.PointMLP_3(self.PointMLP_2(x1))
        return x1, x2


class VFEClas(nn.Module):
    mode = "clas"
    input_kind = "points"

    def __init__(self, num_classes: int = 16, max_points: int = 1024,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.VFEBlock_0 = VFEBlock(max_points=max_points)
        self.MLPHead_0 = MLPHead(max_points, (512, 256), num_classes,
                                 dropout_rate=0.7)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """``points [B, N, 3]`` → logits ``[B, num_classes]``; ``impl``
        and the dropout arguments as for ``PointNetBasicClas``."""
        _, x2 = self.VFEBlock_0(points)
        return self.MLPHead_0(global_max_pool(x2), generator=generator,
                              masks=dropout_masks)
