"""PointNet++ set abstraction (counterpart of ``papc_tpu/nn/pointnet2.py``).

Positions ``[B, N, 3]`` and features ``[B, N, D]``, channel-last. The
grouped neighbourhoods are ``[B, S, K, 3 + D]`` row layout; the TPU's
channel-major grouping (``_use_transposed``) is not carried over.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from papc_tpu_torch.nn.layers import PointMLP, _eval_only
from papc_tpu_torch.ops.grouping import sample_and_group, sample_and_group_all


class SetAbstraction(nn.Module):
    """FPS → ball query → grouped shared MLP → max over the neighbourhood.

    ``forward(xyz [B, N, 3], points [B, N, in_features] | None)`` →
    ``(new_xyz [B, S, 3], new_points [B, S, mlp[-1]])``; ``group_all``
    makes one group of every point (S = 1).
    """

    def __init__(self, npoint: int | None, radius: float | None,
                 nsample: int | None, in_features: int, mlp: Sequence[int],
                 group_all: bool = False):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.group_all = group_all
        self.PointMLP_0 = PointMLP(3 + in_features, mlp, pool_max=True)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None,
                impl: str | None = None):
        _eval_only(self)
        if self.group_all:
            new_xyz, grouped = sample_and_group_all(xyz, points)
        else:
            new_xyz, grouped = sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points,
                impl=impl,
            )
        return new_xyz, self.PointMLP_0(grouped, impl=impl)
