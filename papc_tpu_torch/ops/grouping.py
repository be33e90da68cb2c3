"""Neighbourhood grouping: ball query and sample-and-group.

Counterpart of ``papc_tpu/ops/grouping.py`` (``query_ball_point``,
``sample_and_group``, ``sample_and_group_all``). The port groups in row
layout ``[B, S, K, C]``; the TPU's channel-major ``sample_and_group_t``
exists to dodge lane padding and is not carried over.
"""

from __future__ import annotations

import torch

from papc_tpu_torch.ops.geometry import index_points
from papc_tpu_torch.ops.kernels import ball_query, gather
from papc_tpu_torch.ops.sampling import farthest_point_sample


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, *,
                     impl: str | None = None) -> torch.Tensor:
    """For each query in ``new_xyz [B, S, 3]``, the first ``nsample``
    indices of ``xyz [B, N, 3]`` within ``radius``, ascending; empty
    slots repeat the first hit → int32 ``[B, S, nsample]``."""
    return ball_query.query_ball_point(radius, nsample, xyz, new_xyz,
                                       impl=impl)


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: torch.Tensor | None, *,
                     generator: torch.Generator | None = None,
                     impl: str | None = None):
    """FPS + ball query + gather + centring.

    ``xyz [B, N, 3]``, ``points [B, N, D]`` or None →
    ``(new_xyz [B, npoint, 3], new_points [B, npoint, nsample, 3 + D])``,
    relative xyz first, then the features.
    """
    fps_idx = farthest_point_sample(xyz, npoint, generator=generator,
                                    impl=impl)
    new_xyz = index_points(xyz, fps_idx)
    idx = query_ball_point(radius, nsample, xyz, new_xyz, impl=impl)
    new_points = gather.group_gather(xyz, points, idx, new_xyz, impl=impl)
    return new_xyz, new_points


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None):
    """One group holding every point: ``new_xyz`` is the origin and the
    grouped xyz is not centred (reference semantics)."""
    B, N, C = xyz.shape
    new_xyz = torch.zeros((B, 1, C), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None, :, :]
    if points is not None:
        grouped = torch.cat([grouped, points[:, None, :, :]], dim=-1)
    return new_xyz, grouped
