"""Host-side (numpy) box math the serving slice needs: the anchor grid
and the point rotation of the synthetic scenes (a subset of
``papc_tpu/detect/box_np.py``, copied so that the port imports nothing
of the JAX package).

Box convention (lidar): ``[x, y, z, w, l, h, yaw]`` with z at the box
bottom, yaw about +z.
"""

from __future__ import annotations

import numpy as np


def rotation_points_single_angle(points: np.ndarray, angle) -> np.ndarray:
    """Rotate [N, 3] points by one scalar angle about z (the row-vector
    convention of the reference's ``rotation_3d_in_axis``)."""
    angles = np.asarray([angle], points.dtype)
    c, s = np.cos(angles), np.sin(angles)
    one, zero = np.ones_like(c), np.zeros_like(c)
    rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    rot = np.stack([np.stack(r, -1) for r in rows], -2)  # [1, 3, 3]
    return np.einsum("npi,nij->npj", points[None], rot)[0]


def _anchor_grid(x_centers, y_centers, z_centers, sizes, rotations, dtype):
    sizes = np.reshape(np.asarray(sizes, dtype), [-1, 3])
    rotations = np.asarray(rotations, dtype)
    nx, ny, nz = len(x_centers), len(y_centers), len(z_centers)
    ns, nr = len(sizes), len(rotations)
    # layout [z, y, x, size, rot, 7], the reference's transpose
    out = np.empty((nz, ny, nx, ns, nr, 7), dtype=dtype)
    out[..., 0] = x_centers[None, None, :, None, None]
    out[..., 1] = y_centers[None, :, None, None, None]
    out[..., 2] = z_centers[:, None, None, None, None]
    out[..., 3:6] = sizes[None, None, None, :, None, :]
    out[..., 6] = rotations[None, None, None, None, :]
    return out


def create_anchors_3d_stride(
    feature_size,
    sizes=(1.6, 3.9, 1.56),
    anchor_strides=(0.4, 0.4, 0.0),
    anchor_offsets=(0.2, -39.8, -1.78),
    rotations=(0, np.pi / 2),
    dtype=np.float32,
):
    """Anchor grid by stride/offset; ``feature_size`` is [D, H, W] (zyx).
    Returns ``[D, H, W, num_sizes, num_rots, 7]``."""
    zs = np.arange(feature_size[0], dtype=dtype) * anchor_strides[2] + anchor_offsets[2]
    ys = np.arange(feature_size[1], dtype=dtype) * anchor_strides[1] + anchor_offsets[1]
    xs = np.arange(feature_size[2], dtype=dtype) * anchor_strides[0] + anchor_offsets[0]
    return _anchor_grid(xs, ys, zs, sizes, rotations, dtype)
