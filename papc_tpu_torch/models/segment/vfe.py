"""VFE part segmentation (counterpart of ``papc_tpu/models/segment/vfe.py``).

The VFE block's per-point features ``x1`` (2F) with the global max of its
stage-2 features ``x2`` (``max_points``) tiled back and concatenated, then
``SegHead`` 512→256→128→128→parts.
"""

from __future__ import annotations

import torch
from torch import nn

from papc_tpu_torch.models.classify.vfe import VFEBlock, tile_global_max
from papc_tpu_torch.models.segment.pointnet_basic import SEG_HIDDEN
from papc_tpu_torch.nn import SegHead
from papc_tpu_torch.nn.layers import init_params


class VFESeg(nn.Module):
    mode = "seg"
    input_kind = "points"

    def __init__(self, num_classes: int = 50, feature_channels: int = 256,
                 max_points: int = 1024,
                 generator: torch.Generator | None = None):
        """``num_classes``: the number of parts, as in JAX."""
        super().__init__()
        self.num_parts = num_classes
        self.VFEBlock_0 = VFEBlock(feature_channels, max_points)
        self.SegHead_0 = SegHead(2 * feature_channels + max_points,
                                 SEG_HIDDEN, num_classes)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, cls_label=None,
                impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """As ``PointNetBasicSeg.forward``."""
        x1, x2 = self.VFEBlock_0(points)
        return self.SegHead_0(tile_global_max(x1, x2))
