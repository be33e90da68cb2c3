"""Host pillarization in numpy (counterpart of
``papc_tpu/detect/voxelize_np.py`` and of ``papc_tpu/cc``'s
``points_to_voxel_flat``).

First-come semantics, as the reference's single-threaded voxelizer:

  * voxels appear in the order of their first point;
  * a voxel keeps its first ``max_points`` points, in input order;
  * voxels past ``max_voxels`` are dropped whole, while earlier voxels
    still collect their later points.

The cell of a point is ``floor((xyz - range_min) / voxel_size)`` in the
points' dtype (float32 for KITTI clouds), the same arithmetic as JAX's
numpy pass and its C++ one. :func:`points_to_voxel` fills the padded
``[V, P, D]`` grid of the classic PFN; :func:`points_to_voxel_flat`
streams the accepted points into the flat ``[n_cap, D]`` view the flat
PFN reads (``detect/pfn_fast.py``), as JAX's C++ streamer does.
"""

from __future__ import annotations

import numpy as np


def compute_grid_size(voxel_size, point_cloud_range) -> np.ndarray:
    """[nx, ny, nz] = round((range_max - range_min) / voxel_size)."""
    voxel_size = np.asarray(voxel_size, np.float64)
    pc_range = np.asarray(point_cloud_range, np.float64)
    return np.round((pc_range[3:] - pc_range[:3]) / voxel_size).astype(np.int64)


def _first_come(points, voxel_size, point_cloud_range, max_points,
                max_voxels):
    """The first-come assignment of ``points [N, D]``: ``(grid, kept,
    point_voxel, within, uniq_first_come)``: the grid ``[nx, ny, nz]``,
    the indices of the in-bounds points in input order, each one's voxel
    rank (by first occurrence; ranks from ``max_voxels`` on are dropped
    voxels) and its rank inside its voxel, and the linear cell ids of the
    kept voxels in first-come order."""
    voxel_size = np.asarray(voxel_size, points.dtype)
    pc_range = np.asarray(point_cloud_range, points.dtype)
    grid = compute_grid_size(voxel_size, pc_range)
    cell = np.floor((points[:, :3] - pc_range[:3]) / voxel_size).astype(
        np.int64)
    in_bounds = ((cell >= 0) & (cell < grid[None, :])).all(axis=1)
    kept = np.flatnonzero(in_bounds)
    cell = cell[kept]
    linear = cell[:, 2] * grid[1] * grid[0] + cell[:, 1] * grid[0] + cell[:, 0]
    uniq, first_pos, inv = np.unique(linear, return_index=True,
                                     return_inverse=True)
    occ_order = np.argsort(first_pos, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[occ_order] = np.arange(len(uniq))
    point_voxel = rank[inv.reshape(-1)]
    order = np.argsort(point_voxel, kind="stable")
    sorted_voxel = point_voxel[order]
    seg_start = np.r_[0, np.flatnonzero(np.diff(sorted_voxel)) + 1]
    starts = np.repeat(seg_start, np.diff(np.r_[seg_start, len(order)]))
    within = np.empty(len(order), np.int64)
    within[order] = np.arange(len(order)) - starts
    k = min(len(uniq), max_voxels)
    return grid, kept, point_voxel, within, uniq[occ_order[:k]]


def _coords_of(linear, grid) -> np.ndarray:
    """Linear cell ids → ``[K, 3]`` int32 cells (z, y, x)."""
    plane = grid[1] * grid[0]
    cz, rem = linear // plane, linear % plane
    cy, cx = rem // grid[0], rem % grid[0]
    return np.stack([cz, cy, cx], axis=1).astype(np.int32).reshape(-1, 3)


def points_to_voxel(points: np.ndarray, voxel_size, point_cloud_range,
                    max_points: int = 35, max_voxels: int = 20000,
                    pad_output: bool = False):
    """Points ``[N, D]`` (xyz first) → ``(voxels [K, max_points, D],
    coords [K, 3] int32 (z, y, x), num_points [K] int32)``, first come
    first served. With
    ``pad_output`` the arrays have ``max_voxels`` rows, zero past K."""
    points = np.asarray(points)
    grid, kept, point_voxel, within, linear = _first_come(
        points, voxel_size, point_cloud_range, max_points, max_voxels)
    take = (point_voxel < max_voxels) & (within < max_points)
    k = len(linear)
    out_n = max_voxels if pad_output else k
    voxels = np.zeros((out_n, max_points, points.shape[1]), points.dtype)
    voxels[point_voxel[take], within[take]] = points[kept[take]]
    coords = np.zeros((out_n, 3), np.int32)
    coords[:k] = _coords_of(linear, grid)
    num_points = np.bincount(point_voxel[take], minlength=out_n).astype(
        np.int32)
    return voxels, coords, num_points


def points_to_voxel_flat(points: np.ndarray, voxel_size, point_cloud_range,
                         max_points: int = 35, max_voxels: int = 20000,
                         n_cap: int = 25600):
    """The flat view of :func:`points_to_voxel` for the flat PFN, as
    JAX's C++ streamer (``papc_tpu/cc/__init__.py::points_to_voxel_flat``)
    makes it → ``(flat [n_cap, D] f32, owner [n_cap] int32, coords
    [max_voxels, 3] int32 (z, y, x), num_points [max_voxels] int32, K)``.

    The accepted points (a kept voxel's first ``max_points``) are the
    first ``n_cap`` of them in input order; the rest are dropped and not
    counted, so ``num_points`` agrees with the flat view. A voxel first
    seen past the cap still takes its rank, with no point. The flat rows
    come grouped by voxel in ascending rank, input order inside a voxel
    (the grid's slot order); ``owner`` is -1 past the accepted points."""
    points = np.asarray(points, np.float32)
    grid, kept, point_voxel, within, linear = _first_come(
        points, voxel_size, point_cloud_range, max_points, max_voxels)
    take = np.flatnonzero((point_voxel < max_voxels)
                          & (within < max_points))[:n_cap]
    order = take[np.argsort(point_voxel[take], kind="stable")]
    n = len(order)
    flat = np.zeros((n_cap, points.shape[1]), np.float32)
    owner = np.full((n_cap,), -1, np.int32)
    flat[:n] = points[kept[order]]
    owner[:n] = point_voxel[order]
    k = len(linear)
    coords = np.zeros((max_voxels, 3), np.int32)
    coords[:k] = _coords_of(linear, grid)
    num_points = np.bincount(owner[:n], minlength=max_voxels).astype(np.int32)
    return flat, owner, coords, num_points, k


class VoxelGenerator:
    """The voxel grid of a config: its cell size, range, points a pillar
    and ``grid_size``. The pillar cap is each reader's
    ``MAX_NUMBER_OF_VOXELS``, which the host pillarizer
    (``kitti/preprocess.py::host_pillars``) and the device one
    (:func:`papc_tpu_torch.ops.voxelize.voxelize`) take as an argument."""

    def __init__(self, voxel_size, point_cloud_range, max_num_points: int):
        self.voxel_size = np.asarray(voxel_size, np.float32)
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.max_num_points = max_num_points
        self.grid_size = compute_grid_size(voxel_size, point_cloud_range)


def points_to_bev(points: np.ndarray, voxel_size, point_cloud_range,
                  with_reflectivity: bool = False) -> np.ndarray:
    """Bird's-eye-view maps ``[nz + 1 (+ 1), ny, nx]`` f32: the highest z
    of each height slice's cell, the density ``min(1, ln(count + 1) /
    ln 64)`` of each cell and, with ``with_reflectivity``, its highest
    reflectivity."""
    voxel_size = np.asarray(voxel_size, np.float64)
    pc_range = np.asarray(point_cloud_range, np.float64)
    grid = compute_grid_size(voxel_size, pc_range)
    nx, ny, nz = int(grid[0]), int(grid[1]), int(grid[2])
    n_channels = nz + 1 + (1 if with_reflectivity else 0)
    bev = np.zeros((n_channels, ny, nx), dtype=np.float32)
    coords = np.floor((points[:, :3] - pc_range[:3]) / voxel_size).astype(
        np.int64)
    ok = ((coords >= 0) & (coords < grid[None, :])).all(axis=1)
    pts = points[ok]
    cx, cy, cz = coords[ok, 0], coords[ok, 1], coords[ok, 2]
    np.maximum.at(bev, (cz, cy, cx), pts[:, 2].astype(np.float32))
    count = np.zeros((ny, nx), dtype=np.float32)
    np.add.at(count, (cy, cx), 1.0)
    bev[nz] = np.minimum(1.0, np.log(count + 1) / np.log(64))
    if with_reflectivity and points.shape[1] > 3:
        np.maximum.at(bev, (np.full_like(cz, nz + 1), cy, cx),
                      pts[:, 3].astype(np.float32))
    return bev
