"""VoxNet: a 3-D CNN over a 32³ occupancy grid (counterpart of
``papc_tpu/models/classify/voxnet.py``).

Conv3d(1→32, k5, s2, VALID) → BN → LeakyReLU(0.01) → Conv3d(32→32, k3,
VALID) → MaxPool3d(2) → flatten 6·6·6·32 → Dense(128) → LeakyReLU →
Dropout(0.2) → Dense(classes). The batch holds the grids channel-last,
``[B, 32, 32, 32, 1]``, as JAX's; the convolutions run channels-first,
and the pooled features are flattened channel-last (D, H, W, C), in
JAX's order, so ``Dense_0``'s kernel rows line up. The convolutions run
in float32 on cuDNN, forward and backward (``nn.layers.conv``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from papc_tpu_torch.nn import BatchNorm
from papc_tpu_torch.nn.layers import conv, dense, dropout, init_params


class VoxNet(nn.Module):
    mode = "clas"
    input_kind = "voxel"
    DROPOUT_RATE = 0.2

    def __init__(self, num_classes: int = 10,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.Conv_0 = nn.Conv3d(1, 32, 5, stride=2)
        self.BatchNorm_0 = BatchNorm(32)
        self.Conv_1 = nn.Conv3d(32, 32, 3)
        self.Dense_0 = nn.Linear(6 * 6 * 6 * 32, 128)
        self.Dense_1 = nn.Linear(128, num_classes)
        if generator is not None:
            init_params(self, generator)

    def forward(self, voxels: torch.Tensor, impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """``voxels [B, 32, 32, 32, 1]`` → logits ``[B, num_classes]``.
        ``impl`` is taken for the entry points' sake (no kernel here). In
        training the one dropout site takes a ``[B, 128]`` keep mask from
        ``dropout_masks`` or ``generator``."""
        x = voxels.permute(0, 4, 1, 2, 3)
        x = conv(self.Conv_0, x, lambda x, w: F.conv3d(x, w, stride=2))
        x = x.permute(0, 2, 3, 4, 1)  # BN and the activation channel-last
        x = F.leaky_relu(self.BatchNorm_0(x), 0.01).permute(0, 4, 1, 2, 3)
        x = conv(self.Conv_1, x, F.conv3d)
        x = F.max_pool3d(x, 2, 2).permute(0, 2, 3, 4, 1)
        x = F.leaky_relu(dense(self.Dense_0, x.reshape(x.shape[0], -1)),
                         0.01)
        if self.training:
            masks = list(dropout_masks) if dropout_masks is not None else None
            if masks is not None and len(masks) != 1:
                raise ValueError(f"{len(masks)} dropout masks for 1 site")
            x = dropout(x, self.DROPOUT_RATE,
                        None if masks is None else masks[0], generator)
        return dense(self.Dense_1, x)
