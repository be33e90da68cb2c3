"""Host-side (numpy) box math (counterpart of
``papc_tpu/detect/box_np.py``, copied so that the port imports nothing of
the JAX package): the anchor grids (by stride and by range) and their anchors mask, point rotation,
what target assignment needs (corners, standup boxes, the box encodings
and the BEV decoding,
the axis-aligned and rotated BEV IoU), point-in-box tests, and the
camera / lidar / image frames of the KITTI pipeline, all in numpy. The
JAX package takes C++ fast paths (``papc_tpu.cc``) for some of these
when its library loads; the port carries the numpy paths they fall back
to, which give the same results (pinned in ``tests/test_torch_kitti.py``).

Box convention (lidar): ``[x, y, z, w, l, h, yaw]`` with z at the box
bottom, yaw about +z.
"""

from __future__ import annotations

import numpy as np


def rotation_3d_in_axis(points: np.ndarray, angles: np.ndarray,
                        axis: int = 2) -> np.ndarray:
    """Rotate ``[N, P, 3]`` point sets about ``axis`` by per-set
    ``angles`` (the row-vector convention of the reference)."""
    c, s = np.cos(angles), np.sin(angles)
    one, zero = np.ones_like(c), np.zeros_like(c)
    if axis == 2 or axis == -1:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    elif axis == 1:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    elif axis == 0:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    else:
        raise ValueError("axis out of range")
    rot = np.stack([np.stack(r, -1) for r in rows], -2)  # [N, 3, 3]
    return np.einsum("npi,nij->npj", points, rot)


def rotation_points_single_angle(points: np.ndarray, angle,
                                 axis: int = 2) -> np.ndarray:
    """Rotate [N, 3] points by one scalar angle about ``axis``."""
    return rotation_3d_in_axis(points[None, :, :],
                               np.asarray([angle], points.dtype), axis)[0]


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


def create_anchors_3d_range(
    feature_size,
    anchor_range,
    sizes=(1.6, 3.9, 1.56),
    rotations=(0, np.pi / 2),
    dtype=np.float32,
):
    """Anchor grid by ``linspace`` over ``anchor_range`` [x0, y0, z0, x1,
    y1, z1], both ends included; ``feature_size`` is [D, H, W] (zyx).
    Returns ``[D, H, W, num_sizes, num_rots, 7]``."""
    anchor_range = np.asarray(anchor_range, dtype)
    zs = np.linspace(anchor_range[2], anchor_range[5], feature_size[0], dtype=dtype)
    ys = np.linspace(anchor_range[1], anchor_range[4], feature_size[1], dtype=dtype)
    xs = np.linspace(anchor_range[0], anchor_range[3], feature_size[2], dtype=dtype)
    return _anchor_grid(xs, ys, zs, sizes, rotations, dtype)


# ---------------------------------------------------------------- corners

def corners_nd(dims: np.ndarray, origin=0.5) -> np.ndarray:
    """Relative corners of N boxes of ``dims [N, ndim]`` about ``origin``;
    2-D clockwise from the minimum corner, 3-D in the reference's order."""
    ndim = dims.shape[1]
    unit = np.stack(np.unravel_index(np.arange(2**ndim), [2] * ndim),
                    axis=1).astype(dims.dtype)
    if ndim == 2:
        unit = unit[[0, 1, 3, 2]]
    elif ndim == 3:
        unit = unit[[0, 1, 3, 2, 4, 5, 7, 6]]
    unit = unit - np.asarray(origin, dtype=dims.dtype)
    return dims[:, None, :] * unit[None, :, :]


def rotation_2d(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotate ``[N, P, 2]`` point sets by per-box ``angles`` (row-vector
    convention ``p @ [[c, -s], [s, c]]``)."""
    c, s = np.cos(angles), np.sin(angles)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return np.einsum("npi,nij->npj", points, rot)


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    corners = corners_nd(dims, origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers[:, None, :]


def center_to_corner_box3d(centers, dims, angles=None,
                           origin=(0.5, 0.5, 0.0), axis=2):
    """Boxes → ``[N, 8, 3]`` corners (lidar frame by default; the camera
    frame takes ``origin=(0.5, 1.0, 0.5), axis=1``)."""
    corners = corners_nd(dims, origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis)
    return corners + centers[:, None, :]


def corner_to_standup_nd(corners: np.ndarray) -> np.ndarray:
    """``[N, P, d]`` corners → ``[N, 2d]`` axis-aligned (min..., max...)."""
    return np.concatenate([corners.min(1), corners.max(1)], axis=-1)


def center_to_minmax_2d(centers, dims, origin=0.5):
    if origin == 0.5:
        return np.concatenate([centers - dims / 2, centers + dims / 2],
                              axis=-1)
    corners = center_to_corner_box2d(centers, dims, origin=origin)
    return corners[:, [0, 2]].reshape(-1, 4)


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rbbox2d_to_near_bbox(rbboxes: np.ndarray) -> np.ndarray:
    """``[N, 5]`` (x, y, w, l, yaw) → the nearest axis-aligned ``[N, 4]``
    boxes (w and l swapped where the yaw is nearer ±pi/2)."""
    rots = np.abs(limit_period(rbboxes[..., -1], 0.5, np.pi))
    cond = (rots > np.pi / 4)[..., None]
    centered = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    return center_to_minmax_2d(centered[:, :2], centered[:, 2:])


# ------------------------------------------------------------- encoding

def second_box_encode(boxes, anchors, encode_angle_to_vector=False,
                      smooth_dim=False):
    """SECOND's 7-dof anchor-relative encoding: z at the box centre, x
    and y over the anchor's BEV diagonal, log (or linear) dims, the angle
    as a difference (or a cos / sin vector)."""
    xa, ya, za, wa, la, ha, ra = np.split(anchors, 7, axis=-1)
    xg, yg, zg, wg, lg, hg, rg = np.split(boxes, 7, axis=-1)
    zg = zg + hg / 2
    za = za + ha / 2
    diagonal = np.sqrt(la**2 + wa**2)
    xt = (xg - xa) / diagonal
    yt = (yg - ya) / diagonal
    zt = (zg - za) / ha
    if smooth_dim:
        lt, wt, ht = lg / la - 1, wg / wa - 1, hg / ha - 1
    else:
        lt, wt, ht = np.log(lg / la), np.log(wg / wa), np.log(hg / ha)
    if encode_angle_to_vector:
        rtx = np.cos(rg) - np.cos(ra)
        rty = np.sin(rg) - np.sin(ra)
        return np.concatenate([xt, yt, zt, wt, lt, ht, rtx, rty], axis=-1)
    return np.concatenate([xt, yt, zt, wt, lt, ht, rg - ra], axis=-1)


def bev_box_encode(boxes, anchors, encode_angle_to_vector=False,
                   smooth_dim=False):
    """The 5-dof BEV variant over (x, y, w, l, yaw)."""
    xa, ya, wa, la, ra = np.split(anchors, 5, axis=-1)
    xg, yg, wg, lg, rg = np.split(boxes, 5, axis=-1)
    diagonal = np.sqrt(la**2 + wa**2)
    xt = (xg - xa) / diagonal
    yt = (yg - ya) / diagonal
    if smooth_dim:
        lt, wt = lg / la - 1, wg / wa - 1
    else:
        lt, wt = np.log(lg / la), np.log(wg / wa)
    if encode_angle_to_vector:
        rtx = np.cos(rg) - np.cos(ra)
        rty = np.sin(rg) - np.sin(ra)
        return np.concatenate([xt, yt, wt, lt, rtx, rty], axis=-1)
    return np.concatenate([xt, yt, wt, lt, rg - ra], axis=-1)


def bev_box_decode(encodings, anchors, encode_angle_to_vector=False,
                   smooth_dim=False):
    """Inverse of :func:`bev_box_encode`: codes relative to ``anchors [...,
    5]`` → (x, y, w, l, yaw)."""
    xa, ya, wa, la, ra = np.split(anchors, 5, axis=-1)
    if encode_angle_to_vector:
        xt, yt, wt, lt, rtx, rty = np.split(encodings, 6, axis=-1)
    else:
        xt, yt, wt, lt, rt = np.split(encodings, 5, axis=-1)
    diagonal = np.sqrt(la**2 + wa**2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    if smooth_dim:
        lg, wg = (lt + 1) * la, (wt + 1) * wa
    else:
        lg, wg = np.exp(lt) * la, np.exp(wt) * wa
    if encode_angle_to_vector:
        rg = np.arctan2(rty + np.sin(ra), rtx + np.cos(ra))
    else:
        rg = rt + ra
    return np.concatenate([xg, yg, wg, lg, rg], axis=-1)


# ------------------------------------------------------------------ IoU

def iou_2d(boxes: np.ndarray, query_boxes: np.ndarray, eps=0.0) -> np.ndarray:
    """Axis-aligned ``[N, 4] x [K, 4]`` IoU matrix in ``boxes``' dtype."""
    N, K = len(boxes), len(query_boxes)
    if N == 0 or K == 0:
        return np.zeros((N, K), dtype=boxes.dtype if N else np.float32)
    b = boxes[:, None, :]
    q = query_boxes[None, :, :]
    iw = (np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0])
          + eps)
    ih = (np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1])
          + eps)
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_b = (b[..., 2] - b[..., 0] + eps) * (b[..., 3] - b[..., 1] + eps)
    area_q = (q[..., 2] - q[..., 0] + eps) * (q[..., 3] - q[..., 1] + eps)
    union = area_b + area_q - inter
    out = np.where((iw > 0) & (ih > 0), inter / union, 0.0)
    return out.astype(boxes.dtype)


def _fill_invalid_with_left(vx, vy, m, slots: int):
    """Invalid ring slots take the nearest valid slot to their left
    (cyclically), by a doubling scan of rolls and selects."""
    k = 1
    while k < slots:
        take = ~m
        vx = np.where(take, np.roll(vx, k, axis=-1), vx)
        vy = np.where(take, np.roll(vy, k, axis=-1), vy)
        m = m | np.roll(m, k, axis=-1)
        k *= 2
    return vx, vy, m


def batched_intersection_area(ca: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """Intersection areas of convex-quad pairs ``[M, 4, 2] x [M, 4, 2]`` →
    ``[M]``, float64: A clipped by B's four halfplanes (Sutherland-Hodgman)
    over a ring of slots that doubles each clip, then the shoelace."""
    ca = np.asarray(ca, np.float64)
    cb = np.asarray(cb, np.float64)
    bx, by = cb[..., 0], cb[..., 1]
    nbx = np.roll(bx, -1, axis=-1)
    nby = np.roll(by, -1, axis=-1)
    orient = np.sign(np.sum(bx * nby - nbx * by, axis=-1))[..., None]

    vx, vy = ca[..., 0], ca[..., 1]
    m = np.ones(vx.shape, bool)
    slots = 4
    for e in range(4):
        ax = cb[..., e, 0][..., None]
        ay = cb[..., e, 1][..., None]
        dx = cb[..., (e + 1) % 4, 0][..., None] - ax
        dy = cb[..., (e + 1) % 4, 1][..., None] - ay
        vx, vy, m = _fill_invalid_with_left(vx, vy, m, slots)
        any_valid = m[..., :1]
        # slot 2i keeps vertex i when inside, slot 2i+1 the boundary
        # intersection when edge (i, i+1) crosses
        cr = (dx * (vy - ay) - dy * (vx - ax)) * orient
        inside = cr >= 0
        nvx = np.roll(vx, -1, axis=-1)
        nvy = np.roll(vy, -1, axis=-1)
        ncr = np.roll(cr, -1, axis=-1)
        ninside = np.roll(inside, -1, axis=-1)
        denom = cr - ncr
        t = cr / np.where(denom == 0, 1.0, denom)
        ix = vx + t * (nvx - vx)
        iy = vy + t * (nvy - vy)
        crossing = (inside != ninside) & (denom != 0)
        vx = np.stack([vx, ix], axis=-1).reshape(*vx.shape[:-1], -1)
        vy = np.stack([vy, iy], axis=-1).reshape(*vy.shape[:-1], -1)
        m = np.stack([inside, crossing], axis=-1).reshape(
            *inside.shape[:-1], -1)
        m = m & any_valid
        slots *= 2

    vx, vy, m = _fill_invalid_with_left(vx, vy, m, slots)
    nvx = np.roll(vx, -1, axis=-1)
    nvy = np.roll(vy, -1, axis=-1)
    area2 = np.sum(vx * nvy - nvx * vy, axis=-1)
    return np.where(m[..., 0], 0.5 * np.abs(area2), 0.0)


def rotate_iou_cpu(rbboxes: np.ndarray, qrbboxes: np.ndarray,
                   standup_thresh: float = 0.0,
                   criterion: int = -1) -> np.ndarray:
    """Exact rotated BEV IoU ``[N, K]`` f32 of ``[*, 5]`` (x, y, w, l, yaw)
    boxes, over the pairs whose standup IoU passes ``standup_thresh``.
    ``criterion``: -1 IoU, 0 over the first area, 1 over the second,
    else the intersection area."""
    N, K = len(rbboxes), len(qrbboxes)
    out = np.zeros((N, K), dtype=np.float32)
    if N == 0 or K == 0:
        return out
    c1 = center_to_corner_box2d(rbboxes[:, :2], rbboxes[:, 2:4],
                                rbboxes[:, 4])
    c2 = center_to_corner_box2d(qrbboxes[:, :2], qrbboxes[:, 2:4],
                                qrbboxes[:, 4])
    standup = iou_2d(corner_to_standup_nd(c1).astype(np.float32),
                     corner_to_standup_nd(c2).astype(np.float32))
    area1 = rbboxes[:, 2] * rbboxes[:, 3]
    area2 = qrbboxes[:, 2] * qrbboxes[:, 3]
    sel_i, sel_j = np.nonzero(standup > standup_thresh)
    if len(sel_i) == 0:
        return out
    inter = batched_intersection_area(c1[sel_i], c2[sel_j])
    if criterion == -1:
        denom = area1[sel_i] + area2[sel_j] - inter
    elif criterion == 0:
        denom = area1[sel_i]
    elif criterion == 1:
        denom = area2[sel_j]
    else:
        denom = np.ones_like(inter)
    out[sel_i, sel_j] = np.where(denom > 0, inter / denom, 0.0)
    return out


# ------------------------------------------------- point-in-polygon tests

def surface_normals(surfaces: np.ndarray):
    """Plane normals and offsets of ``[N, S, 4, 3]`` polygon surfaces
    (inward by the corner winding)."""
    sv0 = surfaces[:, :, 0] - surfaces[:, :, 1]
    sv1 = surfaces[:, :, 1] - surfaces[:, :, 2]
    normals = np.cross(sv0, sv1)  # [N, S, 3]
    d = -np.einsum("nsd,nsd->ns", normals, surfaces[:, :, 0])
    return normals, d


def points_in_convex_polygon_3d(points: np.ndarray,
                                surfaces: np.ndarray) -> np.ndarray:
    """``[P, 3]`` points against ``[N, 6, 4, 3]`` box surfaces → ``[P, N]``
    bool; a point on a face counts as outside."""
    normals, d = surface_normals(surfaces)
    sign = np.einsum("pd,nsd->pns", points, normals) + d[None]  # [P, N, S]
    return (sign < 0).all(axis=-1)


def corner_to_surfaces_3d(corners: np.ndarray) -> np.ndarray:
    """``[N, 8, 3]`` corners → ``[N, 6, 4, 3]`` surfaces, inward normals."""
    idx = np.array([[0, 1, 2, 3], [7, 6, 5, 4], [0, 3, 7, 4],
                    [1, 5, 6, 2], [0, 4, 5, 1], [3, 2, 6, 7]])
    return corners[:, idx, :]


def points_in_rbbox(points, rbbox, lidar=True):
    """``[P, >=3]`` points against ``[N, 7]`` rotated 3-D boxes → ``[P, N]``
    bool."""
    if lidar:
        origin, axis = (0.5, 0.5, 0.0), 2
    else:
        origin, axis = (0.5, 1.0, 0.5), 1
    corners = center_to_corner_box3d(rbbox[:, :3], rbbox[:, 3:6],
                                     rbbox[:, 6], origin=origin, axis=axis)
    surfaces = corner_to_surfaces_3d(corners)
    return points_in_convex_polygon_3d(points[:, :3], surfaces)


# ------------------------------------------------- the anchors mask (SAT)

def sparse_sum_for_anchors_mask(coors: np.ndarray, shape) -> np.ndarray:
    """Pillars a BEV cell from ``[V, 3]`` (z, y, x) coordinates."""
    ret = np.zeros(shape, dtype=np.float32)
    np.add.at(ret, (coors[:, 1], coors[:, 2]), 1.0)
    return ret


def precompute_anchor_area_indices(anchors_bv: np.ndarray, stride, offset,
                                   grid_size) -> np.ndarray:
    """The flat summed-area-table corner indices ``[4, N]`` of
    :func:`fused_get_anchors_area` (the anchor grid is static: once)."""
    x0 = np.floor((anchors_bv[:, 0] - offset[0]) / stride[0]).astype(np.int64)
    y0 = np.floor((anchors_bv[:, 1] - offset[1]) / stride[1]).astype(np.int64)
    x1 = np.floor((anchors_bv[:, 2] - offset[0]) / stride[0]).astype(np.int64)
    y1 = np.floor((anchors_bv[:, 3] - offset[1]) / stride[1]).astype(np.int64)
    x0 = np.clip(x0, 0, grid_size[0] - 1)
    y0 = np.clip(y0, 0, grid_size[1] - 1)
    x1 = np.clip(x1, 0, grid_size[0] - 1)
    y1 = np.clip(y1, 0, grid_size[1] - 1)
    nx = int(grid_size[0])
    return np.stack([y1 * nx + x1, y1 * nx + x0, y0 * nx + x1, y0 * nx + x0])


def fused_get_anchors_area(dense_map: np.ndarray, anchors_bv: np.ndarray,
                           stride, offset, grid_size,
                           indices: np.ndarray | None = None) -> np.ndarray:
    """Pillars under each BEV anchor by summed-area-table lookup;
    ``dense_map`` is already cumulated along both axes."""
    if indices is None:
        indices = precompute_anchor_area_indices(anchors_bv, stride, offset,
                                                 grid_size)
    vals = dense_map.ravel()[indices]  # [4, N]
    return vals[0] - vals[1] - vals[2] + vals[3]


# --------------------------------------------- camera, lidar and image

def projection_matrix_to_CRT_kitti(proj: np.ndarray):
    CR = proj[0:3, 0:3]
    CT = proj[0:3, 3]
    RinvCinv = np.linalg.inv(CR)
    Rinv, Cinv = np.linalg.qr(RinvCinv)
    return np.linalg.inv(Cinv), np.linalg.inv(Rinv), Cinv @ CT


def camera_to_lidar(points, r_rect, velo2cam):
    if points.shape[-1] == 3:
        points = np.concatenate(
            [points, np.ones((*points.shape[:-1], 1))], axis=-1)
    lidar = points @ np.linalg.inv((r_rect @ velo2cam).T)
    return lidar[..., :3]


def lidar_to_camera(points, r_rect, velo2cam):
    if points.shape[-1] == 3:
        points = np.concatenate(
            [points, np.ones((*points.shape[:-1], 1))], axis=-1)
    cam = points @ (r_rect @ velo2cam).T
    return cam[..., :3]


def box_camera_to_lidar(data, r_rect, velo2cam):
    """Camera boxes ``[x, y, z, l, h, w, ry]`` → lidar ``[x, y, z, w, l, h,
    yaw]``."""
    xyz = camera_to_lidar(data[:, 0:3], r_rect, velo2cam)
    l, h, w, r = data[:, 3:4], data[:, 4:5], data[:, 5:6], data[:, 6:7]
    return np.concatenate([xyz, w, l, h, r], axis=1)


def box_lidar_to_camera(data, r_rect, velo2cam):
    xyz = lidar_to_camera(data[:, 0:3], r_rect, velo2cam)
    w, l, h, r = data[:, 3:4], data[:, 4:5], data[:, 5:6], data[:, 6:7]
    return np.concatenate([xyz, l, h, w, r], axis=1)


def project_to_image(points_3d, proj_mat):
    pts4 = np.concatenate(
        [points_3d, np.zeros((*points_3d.shape[:-1], 1))], axis=-1)
    p2d = pts4 @ proj_mat.T
    return p2d[..., :2] / p2d[..., 2:3]


def get_frustum(bbox_image, C, near_clip=0.001, far_clip=100.0):
    """The 8 camera-frame corners of an image box's view frustum."""
    fku = C[0, 0]
    fkv = -C[1, 1]
    u0v0 = C[0:2, 2]
    z_points = np.array([near_clip] * 4 + [far_clip] * 4,
                        dtype=C.dtype)[:, None]
    b = bbox_image
    box_corners = np.array(
        [[b[0], b[1]], [b[0], b[3]], [b[2], b[3]], [b[2], b[1]]],
        dtype=C.dtype)
    near = (box_corners - u0v0) / np.array(
        [fku / near_clip, -fkv / near_clip], dtype=C.dtype)
    far = (box_corners - u0v0) / np.array(
        [fku / far_clip, -fkv / far_clip], dtype=C.dtype)
    return np.concatenate(
        [np.concatenate([near, far], axis=0), z_points], axis=1)


def minmax_to_corner_2d(minmax_boxes: np.ndarray) -> np.ndarray:
    """``[N, 4]`` (x0, y0, x1, y1) → ``[N, 4, 2]`` corners in
    :func:`get_frustum`'s order."""
    b = minmax_boxes
    return np.stack([np.stack([b[:, 0], b[:, 1]], -1),
                     np.stack([b[:, 0], b[:, 3]], -1),
                     np.stack([b[:, 2], b[:, 3]], -1),
                     np.stack([b[:, 2], b[:, 1]], -1)], axis=1)


def get_frustum_batch(bboxes, C, near_clip=0.001, far_clip=100.0):
    """:func:`get_frustum` of ``[N, 4]`` image boxes → ``[N, 8, 3]``."""
    fku = C[0, 0]
    fkv = -C[1, 1]
    u0v0 = C[0:2, 2]
    num_box = bboxes.shape[0]
    z_points = np.tile(
        np.array([near_clip] * 4 + [far_clip] * 4,
                 dtype=C.dtype)[None, :, None], (num_box, 1, 1))
    box_corners = minmax_to_corner_2d(bboxes)
    near = (box_corners - u0v0) / np.array(
        [fku / near_clip, -fkv / near_clip], dtype=C.dtype)
    far = (box_corners - u0v0) / np.array(
        [fku / far_clip, -fkv / far_clip], dtype=C.dtype)
    return np.concatenate(
        [np.concatenate([near, far], axis=1), z_points], axis=-1)


def remove_outside_points(points, rect, Trv2c, P2, image_shape):
    """The points inside the camera image's frustum."""
    C, R, T = projection_matrix_to_CRT_kitti(P2)
    frustum = get_frustum([0, 0, image_shape[1], image_shape[0]], C)
    frustum -= T
    frustum = np.linalg.inv(R) @ frustum.T
    frustum = camera_to_lidar(frustum.T, rect, Trv2c)
    surfaces = corner_to_surfaces_3d(frustum[None, ...])
    keep = points_in_convex_polygon_3d(points[:, :3], surfaces)
    return points[keep.reshape(-1)]


def box3d_to_bbox(box3d, rect, Trv2c, P2):
    """Camera boxes → the image boxes ``[N, 4]`` their corners project to."""
    corners = center_to_corner_box3d(box3d[:, :3], box3d[:, 3:6],
                                     box3d[:, 6], origin=(0.5, 1.0, 0.5),
                                     axis=1)
    img = project_to_image(corners, P2)
    return np.concatenate([img.min(1), img.max(1)], axis=1)
