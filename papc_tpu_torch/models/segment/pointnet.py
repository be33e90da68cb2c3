"""PointNet part segmentation with the T-Nets (counterpart of
``papc_tpu/models/segment/pointnet.py``).

Input T-Net, PointMLP 3→64→64, feature T-Net (the 64-wide point
features), PointMLP 64→128→1024, the global max tiled back and
concatenated as ``[point features 64 | global 1024]`` (1088), then
``SegHead`` 512→256→128→128→parts.
"""

from __future__ import annotations

import torch
from torch import nn

from papc_tpu_torch.models.classify.vfe import tile_global_max
from papc_tpu_torch.models.segment.pointnet_basic import SEG_HIDDEN
from papc_tpu_torch.nn import PointMLP, SegHead, TNet
from papc_tpu_torch.nn.layers import init_params


class PointNetSeg(nn.Module):
    mode = "seg"
    input_kind = "points"

    def __init__(self, num_classes: int = 50, max_point: int = 2048,
                 generator: torch.Generator | None = None):
        """``num_classes``: the number of parts; ``max_point`` unused
        (the pooling is global), as in JAX."""
        super().__init__()
        self.num_parts = num_classes
        self.input_tnet = TNet(3)
        self.PointMLP_0 = PointMLP(3, (64, 64))
        self.feature_tnet = TNet(64)
        self.PointMLP_1 = PointMLP(64, (64, 128, 1024))
        self.SegHead_0 = SegHead(64 + 1024, SEG_HIDDEN, num_classes)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, cls_label=None,
                impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """As ``PointNetBasicSeg.forward``."""
        x = torch.bmm(points, self.input_tnet(points))
        x = self.PointMLP_0(x)
        point_feat = torch.bmm(x, self.feature_tnet(x))
        g = self.PointMLP_1(point_feat)
        return self.SegHead_0(tile_global_max(point_feat, g))
