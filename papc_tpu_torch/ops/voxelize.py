"""Voxelization and the BEV scatter on the device (counterpart of
``papc_tpu/ops/voxelize.py::voxelize`` and ``scatter_to_bev_batched``).

Both are plain PyTorch: in the JAX package they are XLA sort, scan and
scatter ops, not Pallas kernels. Shapes are static: ``max_voxels`` and
``max_points`` bound the output and validity is carried in masks.

Semantics, as in JAX: a stable sort over the linear cell id, points keep
their input order inside a pillar and are truncated first-come at
``max_points``; pillars come out in cell-id order (not in order of first
occurrence) and are truncated at ``max_voxels``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VoxelizedPoints(NamedTuple):
    voxels: torch.Tensor  # [B, V, P, D] point features, zero padded
    coords: torch.Tensor  # [B, V, 3] int32 (z, y, x); -1 rows are invalid
    num_points: torch.Tensor  # [B, V] int32
    num_voxels: torch.Tensor  # [B] int32
    point_mask: torch.Tensor  # [B, V, P] bool, the valid point slots


def voxelize(points: torch.Tensor, points_mask: torch.Tensor | None,
             voxel_size, point_cloud_range, grid_size, max_points: int,
             max_voxels: int) -> VoxelizedPoints:
    """Batched voxelizer: ``points [B, N, D]`` (xyz first), ``points_mask
    [B, N]`` marks real points (padding rows False). ``grid_size`` is
    ``(nx, ny, nz)``."""
    nx, ny, nz = (int(g) for g in grid_size)
    B, N, D = points.shape
    dev = points.device
    vsz = torch.tensor([float(v) for v in voxel_size], dtype=points.dtype,
                       device=dev)
    lo = torch.tensor([float(v) for v in point_cloud_range[:3]],
                      dtype=points.dtype, device=dev)
    grid = torch.tensor([nx, ny, nz], dtype=points.dtype, device=dev)

    cellf = torch.floor((points[..., :3] - lo) / vsz)
    # range test on the float cells: an int cast of a far-out point is
    # not defined in torch (XLA saturates it)
    ok = ((cellf >= 0) & (cellf < grid)).all(dim=-1)
    if points_mask is not None:
        ok = ok & points_mask.to(torch.bool)
    cell = torch.where(ok[..., None], cellf, 0.0).to(torch.int64)
    n_cells = nx * ny * nz
    linear = torch.where(
        ok, cell[..., 2] * (ny * nx) + cell[..., 1] * nx + cell[..., 0],
        n_cells)  # sentinel: sorts after every real cell

    lin_sorted, order = torch.sort(linear, dim=-1, stable=True)
    valid_sorted = lin_sorted < n_cells
    first = torch.ones((B, 1), dtype=torch.bool, device=dev)
    new_seg = torch.cat([first, lin_sorted[:, 1:] != lin_sorted[:, :-1]],
                        dim=1) & valid_sorted
    voxel_rank = torch.cumsum(new_seg, dim=1) - 1  # [B, N] pillar per point
    pos = torch.arange(N, device=dev).expand(B, N)
    seg_start = torch.cummax(torch.where(new_seg, pos, 0), dim=1).values
    within = pos - seg_start  # rank inside the pillar

    keep = valid_sorted & (voxel_rank < max_voxels) & (within < max_points)
    vr = torch.where(keep, voxel_rank, max_voxels)  # dump slot
    wr = torch.where(keep, within, 0)
    batch = torch.arange(B, device=dev)[:, None]
    slot = ((batch * (max_voxels + 1) + vr) * max_points + wr).reshape(-1)

    pts_sorted = torch.gather(points, 1, order[..., None].expand(B, N, D))
    # every write to a kept slot is unique; the dump slot takes any of
    # its writes and is sliced off
    voxels = torch.zeros((B * (max_voxels + 1) * max_points, D),
                         dtype=points.dtype, device=dev)
    voxels.index_put_((slot,), pts_sorted.reshape(-1, D))
    point_mask = torch.zeros(B * (max_voxels + 1) * max_points,
                             dtype=torch.bool, device=dev)
    point_mask.index_put_((slot,), keep.reshape(-1))
    voxels = voxels.view(B, max_voxels + 1, max_points, D)
    point_mask = point_mask.view(B, max_voxels + 1, max_points)

    cell_zyx = torch.gather(cell, 1, order[..., None].expand(B, N, 3)).flip(-1)
    head = new_seg & keep
    rows = (batch * (max_voxels + 1)
            + torch.where(head, vr, max_voxels)).reshape(-1)
    coords = torch.full((B * (max_voxels + 1), 3), -1, dtype=torch.int32,
                        device=dev)
    coords.index_put_((rows,), cell_zyx.reshape(-1, 3).to(torch.int32))
    coords = coords.view(B, max_voxels + 1, 3)

    num_points = point_mask[:, :max_voxels].sum(-1, dtype=torch.int32)
    num_voxels = torch.clamp_max(new_seg.sum(1), max_voxels).to(torch.int32)
    return VoxelizedPoints(
        voxels=voxels[:, :max_voxels],
        coords=coords[:, :max_voxels],
        num_points=num_points,
        num_voxels=num_voxels,
        point_mask=point_mask[:, :max_voxels],
    )


def scatter_to_bev_batched(features: torch.Tensor, coords: torch.Tensor,
                           ny: int, nx: int) -> torch.Tensor:
    """Per-pillar ``features [B, V, C]`` at ``coords [B, V, 3]`` (z, y, x;
    invalid rows have a negative z) onto a dense canvas → ``[B, ny, nx,
    C]``.

    One flat row scatter over batch-folded rows ``b·ny·nx + y·nx + x``
    with a dump row, as in JAX. Rows of one frame are unique when they
    come from :func:`voxelize` (one pillar per cell); the scatter adds
    into a zero canvas, so its result is defined for any input and never
    rests on that promise (a duplicate would sum, not pick one write).
    """
    B, V, C = features.shape
    valid = coords[..., 0] >= 0
    cells = ny * nx
    base = torch.arange(B, device=features.device)[:, None] * cells
    rows = torch.where(valid, base + coords[..., 1].long() * nx
                       + coords[..., 2].long(), B * cells).reshape(-1)
    canvas = torch.zeros((B * cells + 1, C), dtype=features.dtype,
                         device=features.device)
    canvas.index_add_(0, rows, torch.where(valid[..., None], features, 0.0)
                      .reshape(B * V, C))
    return canvas[:B * cells].view(B, ny, nx, C)
