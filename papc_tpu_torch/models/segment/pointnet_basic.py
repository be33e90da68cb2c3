"""PointNet-Basic part segmentation (counterpart of
``papc_tpu/models/segment/pointnet_basic.py``).

PointMLP 3→64→64 (the low features), PointMLP 64→128→``max_points``;
the global max of the high features tiled back onto every point and
concatenated after the low ones, then ``SegHead`` 512→256→128→128→parts.
"""

from __future__ import annotations

import torch
from torch import nn

from papc_tpu_torch.models.classify.vfe import tile_global_max
from papc_tpu_torch.nn import PointMLP, SegHead
from papc_tpu_torch.nn.layers import init_params

SEG_HIDDEN = (512, 256, 128, 128)


class PointNetBasicSeg(nn.Module):
    mode = "seg"
    input_kind = "points"

    def __init__(self, num_classes: int = 50, max_points: int = 1024,
                 generator: torch.Generator | None = None):
        """``num_classes``: the number of parts, as in JAX."""
        super().__init__()
        self.num_parts = num_classes
        self.PointMLP_0 = PointMLP(3, (64, 64))
        self.PointMLP_1 = PointMLP(64, (64, 128, max_points))
        self.SegHead_0 = SegHead(64 + max_points, SEG_HIDDEN, num_classes)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, cls_label=None,
                impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """``points [B, N, 3]`` → per-point logits ``[B, N, parts]``.
        ``cls_label`` is taken and ignored, as in JAX; ``impl`` and the
        dropout arguments for the entry points' sake (no kernel, no
        dropout)."""
        x1 = self.PointMLP_0(points)
        x2 = self.PointMLP_1(x1)
        return self.SegHead_0(tile_global_max(x1, x2))
