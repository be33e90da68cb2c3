"""PointNet++ set abstraction and feature propagation (counterpart of
``papc_tpu/nn/pointnet2.py``).

Positions ``[B, N, 3]`` and features ``[B, N, D]``, channel-last. The
grouped neighbourhoods are ``[B, S, K, C]`` row layout; the TPU's
channel-major grouping (``_use_transposed``) is not carried over.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from papc_tpu_torch.nn.layers import PointMLP
from papc_tpu_torch.ops.geometry import index_points
from papc_tpu_torch.ops.grouping import (query_ball_point, sample_and_group,
                                         sample_and_group_all)
from papc_tpu_torch.ops.interpolate import three_nn_interpolate
from papc_tpu_torch.ops.sampling import farthest_point_sample


class SetAbstraction(nn.Module):
    """FPS → ball query → grouped shared MLP → max over the neighbourhood.

    ``forward(xyz [B, N, 3], points [B, N, in_features] | None)`` →
    ``(new_xyz [B, S, 3], new_points [B, S, mlp[-1]])``; ``group_all``
    makes one group of every point (S = 1). The same code serves both
    modes: the grouping is differentiable in ``points`` (the gather's
    backward is the scatter-add kernel) and ``PointMLP`` follows
    ``train()`` / ``eval()``. FPS starts at point 0, as JAX's does with
    ``key=None``.
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
        if self.group_all:
            new_xyz, grouped = sample_and_group_all(xyz, points)
        else:
            new_xyz, grouped = sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points,
                impl=impl,
            )
        return new_xyz, self.PointMLP_0(grouped, impl=impl)


class SetAbstractionMsg(nn.Module):
    """Multi-scale grouping: one FPS, then per branch a ball query, a
    grouped shared MLP and the max over K; the branches concatenated
    along channels → ``(new_xyz [B, npoint, 3], [B, npoint, Σ mlp[-1]])``.

    Each branch gathers ``concat(points, xyz)``, features FIRST and xyz
    last (the reverse of ``SetAbstraction``'s order), with one
    ``index_points`` and centres the last three channels. That gather's
    backward is the row scatter-add kernel. Branch ``i``'s MLP is
    ``PointMLP_i``, as flax names it.
    """

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], in_features: int,
                 mlp_list: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint = npoint
        self.radius_list = tuple(radius_list)
        self.nsample_list = tuple(nsample_list)
        for i, mlp in enumerate(mlp_list):
            self.add_module(f"PointMLP_{i}",
                            PointMLP(in_features + 3, mlp, pool_max=True))

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None,
                impl: str | None = None):
        fps_idx = farthest_point_sample(xyz, self.npoint, impl=impl)
        new_xyz = index_points(xyz, fps_idx, impl=impl)
        centre = new_xyz[:, :, None, :]
        combined = None if points is None else torch.cat([points, xyz], -1)
        outs = []
        for i, (radius, k) in enumerate(zip(self.radius_list,
                                            self.nsample_list)):
            idx = query_ball_point(radius, k, xyz, new_xyz, impl=impl)
            if combined is None:
                grouped = index_points(xyz, idx, impl=impl) - centre
            else:
                grouped = index_points(combined, idx, impl=impl)
                grouped[..., -3:] -= centre
            outs.append(getattr(self, f"PointMLP_{i}")(grouped, impl=impl))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance interpolation of ``points2`` from ``xyz2``
    onto ``xyz1`` (a broadcast when ``xyz2`` holds one point), the skip
    features ``points1`` first, then a shared Dense→BN→ReLU stack over
    all B·N rows (plain ops, as JAX runs it through XLA):
    ``forward(xyz1 [B, N, 3], xyz2 [B, S, 3], points1 [B, N, D1] | None,
    points2 [B, S, D2])`` → ``[B, N, mlp[-1]]``."""

    def __init__(self, in_features: int, mlp: Sequence[int]):
        super().__init__()
        self.PointMLP_0 = PointMLP(in_features, mlp)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: torch.Tensor | None, points2: torch.Tensor,
                impl: str | None = None) -> torch.Tensor:
        B, N, _ = xyz1.shape
        if xyz2.shape[1] == 1:
            interpolated = points2.expand(B, N, points2.shape[-1])
        else:
            interpolated = three_nn_interpolate(xyz1, xyz2, points2,
                                                impl=impl)
        if points1 is not None:
            interpolated = torch.cat([points1, interpolated], dim=-1)
        return self.PointMLP_0(interpolated)
