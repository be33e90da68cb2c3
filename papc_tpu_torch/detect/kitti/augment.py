"""Point-cloud augmentation for detection training (counterpart of
``papc_tpu/detect/kitti/augment.py``): per-object noise with
collision-rejected placement (all four of the reference's modes), the
global flip, rotation, scaling and translation, the BEV collision test
(edge intersection or containment, after a standup prefilter), the
range filter, the epoch-shuffled ``BatchSampler`` and the database
filters. Numpy throughout: where the JAX package takes its C++ passes
(``cc.box_collision_test``, and ``cc.noise_select`` for the whole accept
loop) this is the numpy path they fall back to, which draws the same
random numbers and gives the same boxes and points (pinned in
``tests/test_torch_kitti.py``).
"""

from __future__ import annotations

import numpy as np

from papc_tpu_torch.detect import box_np


# ------------------------------------------------------ collision testing

def _segments_intersect(A, B, C, D):
    """Proper segment intersection (reference inequality form).
    A/B/C/D: [..., 2] broadcastable."""
    def ccw(p, q, r):
        return (r[..., 1] - p[..., 1]) * (q[..., 0] - p[..., 0]) > (
            q[..., 1] - p[..., 1]
        ) * (r[..., 0] - p[..., 0])

    return (ccw(A, C, D) != ccw(B, C, D)) & (ccw(A, B, C) != ccw(A, B, D))


def _contains_all(corners, pts, clockwise=True):
    """True where quad [..., 4, 2] strictly contains ALL pts [..., P, 2]."""
    a = corners
    b = np.roll(corners, -1, axis=-2)
    vec = a - b
    if clockwise:
        vec = -vec
    rel0 = a[..., None, :, 0] - pts[..., :, None, 0]
    rel1 = a[..., None, :, 1] - pts[..., :, None, 1]
    cross = vec[..., None, :, 1] * rel0 - vec[..., None, :, 0] * rel1
    return (cross < 0).all(axis=(-1, -2))


def box_collision_test(
    boxes: np.ndarray, qboxes: np.ndarray, clockwise: bool = True
) -> np.ndarray:
    """BEV collision matrix [N, K] for corner boxes [N, 4, 2] x [K, 4, 2]
    (edge intersection OR full containment; standup prefilter)."""
    N, K = len(boxes), len(qboxes)
    if N == 0 or K == 0:
        return np.zeros((N, K), bool)
    bs = box_np.corner_to_standup_nd(boxes)
    qs = box_np.corner_to_standup_nd(qboxes)
    iw = np.minimum(bs[:, None, 2], qs[None, :, 2]) - np.maximum(
        bs[:, None, 0], qs[None, :, 0]
    )
    ih = np.minimum(bs[:, None, 3], qs[None, :, 3]) - np.maximum(
        bs[:, None, 1], qs[None, :, 1]
    )
    candidate = (iw > 0) & (ih > 0)

    # all 16 edge pairs: A,B from boxes edges; C,D from qboxes edges
    A = boxes[:, None, :, None, :]  # [N,1,4,1,2]
    B = np.roll(boxes, -1, axis=1)[:, None, :, None, :]
    C = qboxes[None, :, None, :, :]  # [1,K,1,4,2]
    D = np.roll(qboxes, -1, axis=1)[None, :, None, :, :]
    edge_hit = _segments_intersect(A, B, C, D).any(axis=(-1, -2))

    box_bc = np.broadcast_to(boxes[:, None], (N, K, 4, 2))
    q_bc = np.broadcast_to(qboxes[None, :], (N, K, 4, 2))
    box_contains_q = _contains_all(box_bc, q_bc, clockwise)
    q_contains_box = _contains_all(q_bc, box_bc, clockwise)
    return candidate & (edge_hit | box_contains_q | q_contains_box)


# --------------------------------------------------- per-object noise aug

def _rotate_corners_batch(corners, angles):
    """corners [..., 4, 2] rotated by angles [...] — SAME convention as
    ``box_np.rotation_2d`` (``p @ [[c,-s],[s,c]]``), so composing with a
    box's base corners equals corners at ``yaw + angle``. (A transposed
    matrix here once rotated every collision candidate by ``-angle``
    while the applied transform used ``+angle`` — label-corrupting.)"""
    c, s = np.cos(angles), np.sin(angles)
    rot = np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], -2
    )  # [..., 2, 2]
    return np.einsum("...ij,...jk->...ik", corners, rot)


def _set_group_noise_same_(loc_noises, rot_noises, group_ids, grot=None):
    """All members of a group draw the FIRST member's noise (reference
    ``set_group_noise_same_(_v2_)`` :549-567)."""
    first = {}
    for i, gid in enumerate(group_ids):
        first.setdefault(gid, i)
    src = np.array([first[g] for g in group_ids])
    loc_noises[:] = loc_noises[src]
    rot_noises[:] = rot_noises[src]
    if grot is not None:
        grot[:] = grot[src]


def _get_group_center(locs, group_ids):
    """Per-box centroid of its group + ordered group sizes (reference
    ``get_group_center`` :570-589; boxes must be sorted by group id)."""
    centers = np.zeros_like(locs)
    sizes = {}
    sums = {}
    for i, gid in enumerate(group_ids):
        sums.setdefault(gid, np.zeros(locs.shape[1]))
        sums[gid] = sums[gid] + locs[i]
        sizes[gid] = sizes.get(gid, 0) + 1
    for i, gid in enumerate(group_ids):
        centers[i] = sums[gid] / sizes[gid]
    group_nums = np.array(list(sizes.values()), np.int64)
    return centers, group_nums


def _group_transform_(loc_noises, rot_noises, locs, group_center,
                      valid_mask, grot_noises=None):
    """Add the rotate-around-group-center displacement to each member's
    loc noise so a shared rot noise swings the whole group rigidly
    (reference ``group_transform_(_v2_)`` :498-546)."""
    x = locs[:, 0] - group_center[:, 0]
    y = locs[:, 1] - group_center[:, 1]
    r = np.sqrt(x**2 + y**2)
    rot_center = np.arctan2(x, y)
    v = valid_mask
    rc = rot_center[v, None]
    if grot_noises is None:
        loc_noises[v, :, 0] += r[v, None] * (
            np.sin(rc + rot_noises[v]) - np.sin(rc)
        )
        loc_noises[v, :, 1] += r[v, None] * (
            np.cos(rc + rot_noises[v]) - np.cos(rc)
        )
    else:
        g = grot_noises[v]
        loc_noises[v, :, 0] += r[v, None] * (
            np.sin(rc + rot_noises[v] + g) - np.sin(rc + g)
        )
        loc_noises[v, :, 1] += r[v, None] * (
            np.cos(rc + rot_noises[v] + g) - np.cos(rc + g)
        )


def noise_per_object_(
    gt_boxes: np.ndarray,
    points: np.ndarray | None = None,
    valid_mask: np.ndarray | None = None,
    rotation_perturb=np.pi / 4,
    center_noise_std=1.0,
    global_random_rot_range=0.0,
    num_try: int = 100,
    group_ids: np.ndarray | None = None,
    rng: np.random.RandomState | None = None,
):
    """Independently perturb each GT box (location + yaw), rejecting
    trials that collide with any other current box; move the points inside
    each box along with it. In-place on ``gt_boxes``/``points``
    (reference ``noise_per_object_v3_`` :593-686, all four modes):

    - ``group_ids``: members of a group share one noise draw and swing
      rigidly around the group centroid; a group's trial is accepted only
      if NO member collides (reference ``noise_per_box_group(_v2_)``).
    - ``global_random_rot_range``: additionally slide each box along its
      circle around the origin by a random global angle before the local
      perturbation (reference ``noise_per_box_v2_``; used by the GT-DB
      sampler to "place samples to any place in a circle").
    """
    if rng is None:
        rng = np.random.RandomState()
    num_boxes = len(gt_boxes)
    if num_boxes == 0:
        return
    if not isinstance(rotation_perturb, (list, tuple, np.ndarray)):
        rotation_perturb = [-rotation_perturb, rotation_perturb]
    if not isinstance(global_random_rot_range, (list, tuple, np.ndarray)):
        global_random_rot_range = [
            -global_random_rot_range, global_random_rot_range
        ]
    enable_grot = (
        np.abs(global_random_rot_range[0] - global_random_rot_range[1])
        >= 1e-3
    )
    if not isinstance(center_noise_std, (list, tuple, np.ndarray)):
        center_noise_std = [center_noise_std] * 3
    if valid_mask is None:
        valid_mask = np.ones(num_boxes, bool)

    loc_noises = rng.normal(
        scale=np.asarray(center_noise_std, gt_boxes.dtype),
        size=[num_boxes, num_try, 3],
    )
    rot_noises = rng.uniform(
        rotation_perturb[0], rotation_perturb[1],
        size=[num_boxes, num_try],
    )
    grot_noises = None
    if enable_grot:
        # uniform absolute circle angle within the range, expressed as a
        # delta from each box's current angle (reference :630-636)
        gt_grots = np.arctan2(gt_boxes[:, 0], gt_boxes[:, 1])
        grot_noises = rng.uniform(
            (global_random_rot_range[0] - gt_grots)[:, None],
            (global_random_rot_range[1] - gt_grots)[:, None],
            size=[num_boxes, num_try],
        )

    group_nums = None
    if group_ids is not None:
        _set_group_noise_same_(
            loc_noises, rot_noises, group_ids, grot_noises
        )
        group_centers, group_nums = _get_group_center(
            gt_boxes[:, :3], group_ids
        )
        _group_transform_(
            loc_noises, rot_noises, gt_boxes[:, :3], group_centers,
            valid_mask, grot_noises,
        )

    bev = gt_boxes[:, [0, 1, 3, 4, 6]]
    box_corners = box_np.center_to_corner_box2d(
        bev[:, :2], bev[:, 2:4], bev[:, 4]
    )

    # candidate corners per (box, trial) depend only on each box's
    # ORIGINAL pose — computed lazily per trial CHUNK (the accepted trial
    # is almost always among the first few, so building all num_try
    # candidate corner sets up front wastes ~10x einsum work)
    if not enable_grot:
        base = box_corners - bev[:, None, :2]  # [N, 4, 2]
        dst_delta_pos = None
        dst_delta_rot = None

        def cand_chunk(sel, lo, hi):
            """Candidate corners [n_sel, hi-lo, 4, 2] for box rows ``sel``."""
            n = hi - lo
            b = base[sel]  # [n_sel, 4, 2]
            c = _rotate_corners_batch(
                np.broadcast_to(
                    b[:, None], (b.shape[0], n, 4, 2)
                ),
                rot_noises[sel, lo:hi],
            )
            return c + (
                bev[sel, None, :2] + loc_noises[sel, lo:hi, :2]
            )[:, :, None, :]
    else:
        radius = np.sqrt(bev[:, 0] ** 2 + bev[:, 1] ** 2)
        cur_grot = np.arctan2(bev[:, 0], bev[:, 1])
        dst_grot = cur_grot[:, None] + grot_noises  # [N, T]
        dst_pos = np.stack(
            [radius[:, None] * np.sin(dst_grot),
             radius[:, None] * np.cos(dst_grot)],
            axis=-1,
        )  # [N, T, 2]
        yaw_new = bev[:, None, 4] + (dst_grot - cur_grot[:, None])
        base = box_np.corners_nd(bev[:, 2:4])  # [N, 4, 2] centered
        dst_delta_pos = dst_pos - bev[:, None, :2]  # [N, T, 2]
        dst_delta_rot = dst_grot - cur_grot[:, None]  # [N, T]

        def cand_chunk(sel, lo, hi):
            n = hi - lo
            b = base[sel]
            c = _rotate_corners_batch(
                np.broadcast_to(
                    b[:, None], (b.shape[0], n, 4, 2)
                ),
                yaw_new[sel, lo:hi],
            )
            c = _rotate_corners_batch(c, rot_noises[sel, lo:hi])
            return c + (
                dst_pos[sel, lo:hi] + loc_noises[sel, lo:hi, :2]
            )[:, :, None, :]

    # trials are tested in escalating chunks with early exit: the
    # accepted trial is almost always among the first few (sparse
    # scenes), so testing all num_try up front wastes ~30x collision work
    chunks = [8, 24, num_try]

    selected = -np.ones(num_boxes, np.int64)
    if group_nums is None:
        for i in range(num_boxes):
            if not valid_mask[i]:
                continue
            lo = 0
            for hi in chunks:
                hi = min(hi, num_try)
                if lo >= hi:
                    continue
                cand = cand_chunk([i], lo, hi)[0]  # [chunk, 4, 2]
                coll = box_collision_test(cand, box_corners)
                coll[:, i] = False
                hit = np.flatnonzero(~coll.any(axis=1))
                if len(hit):
                    j = lo + int(hit[0])
                    selected[i] = j
                    box_corners[i] = cand[int(hit[0])]
                    break
                lo = hi
    else:
        # joint trial per group: every member must be collision-free
        idx = 0
        for num in group_nums:
            members = np.arange(idx, idx + num)
            if valid_mask[idx]:
                lo = 0
                for hi in chunks:
                    hi = min(hi, num_try)
                    if lo >= hi:
                        continue
                    cand = cand_chunk(members, lo, hi)  # [num, c, 4, 2]
                    coll = box_collision_test(
                        np.ascontiguousarray(cand).reshape(-1, 4, 2),
                        box_corners,
                    ).reshape(num, hi - lo, num_boxes)
                    coll[:, :, members] = False
                    hit = np.flatnonzero(~coll.any(axis=(0, 2)))
                    if len(hit):
                        j = lo + int(hit[0])
                        selected[members] = j
                        box_corners[members] = cand[:, int(hit[0])]
                        break
                    lo = hi
            idx += num

    loc_t = np.zeros((num_boxes, 3), gt_boxes.dtype)
    rot_t = np.zeros((num_boxes,), gt_boxes.dtype)
    chosen = selected >= 0
    loc_t[chosen] = loc_noises[chosen, selected[chosen]]
    rot_t[chosen] = rot_noises[chosen, selected[chosen]]
    if enable_grot:
        # fold the circle displacement into the applied transform
        # (reference :393-396)
        loc_t[chosen, :2] += dst_delta_pos[chosen, selected[chosen]]
        rot_t[chosen] += dst_delta_rot[chosen, selected[chosen]]

    if points is not None and num_boxes > 0:
        masks = box_np.points_in_rbbox(points, gt_boxes)  # [P, N]
        any_box = masks.any(axis=1)
        first_box = np.argmax(masks, axis=1)
        apply = any_box & valid_mask[first_box] & chosen[first_box]
        idx = first_box[apply]
        rel = points[apply, :3] - gt_boxes[idx, :3]
        # SAME convention as box_np.rotation_2d / the reference's
        # points_transform_ (p @ [[c,-s],[s,c]], preprocess.py:205-209):
        # points must rotate WITH the box yaw, not its transpose
        c, s = np.cos(rot_t[idx]), np.sin(rot_t[idx])
        x = rel[:, 0] * c + rel[:, 1] * s
        y = -rel[:, 0] * s + rel[:, 1] * c
        rel = np.stack([x, y, rel[:, 2]], axis=1)
        points[apply, :3] = (
            rel + gt_boxes[idx, :3] + loc_t[idx]
        )

    ok = valid_mask & chosen
    gt_boxes[ok, :3] += loc_t[ok]
    gt_boxes[ok, 6] += rot_t[ok]


# ----------------------------------------------------- frustum crop (aug)

def random_crop_frustum(
    bboxes: np.ndarray,
    rect: np.ndarray,
    Trv2c: np.ndarray,
    P2: np.ndarray,
    max_crop_height: float = 1.0,
    max_crop_width: float = 0.9,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Random sub-rectangle of each image bbox → lidar-frame frustum
    corner points [N, 8, 3] (reference ``random_crop_frustum``
    :104-129). Used by the GT-DB sampler to randomly truncate pasted
    objects the way image-crop truncation would."""
    rng = rng or np.random.RandomState()
    num_gt = bboxes.shape[0]
    crop_minxy = rng.uniform(
        [1 - max_crop_width, 1 - max_crop_height], [0.3, 0.3],
        size=[num_gt, 2],
    )
    crop_maxxy = np.ones([num_gt, 2], dtype=bboxes.dtype)
    crop_bboxes = np.concatenate([crop_minxy, crop_maxxy], axis=1)
    if rng.rand() < 0.5:  # crop from the left instead of the right
        crop_bboxes[:, [0, 2]] -= crop_bboxes[:, 0:1]
    # relative → absolute image coordinates
    crop_bboxes *= np.tile(bboxes[:, 2:] - bboxes[:, :2], [1, 2])
    crop_bboxes += np.tile(bboxes[:, :2], [1, 2])
    C, R, T = box_np.projection_matrix_to_CRT_kitti(P2)
    frustums = box_np.get_frustum_batch(crop_bboxes, C)
    frustums -= T
    frustums = np.einsum("ij,akj->aki", np.linalg.inv(R), frustums)
    return box_np.camera_to_lidar(frustums, rect, Trv2c)


def mask_points_in_corners(
    points: np.ndarray, box_corners: np.ndarray
) -> np.ndarray:
    """[P, N] mask of points inside 3D corner boxes (reference
    ``mask_points_in_corners`` :189-192)."""
    surfaces = box_np.corner_to_surfaces_3d(box_corners)
    return box_np.points_in_convex_polygon_3d(points[:, :3], surfaces)


# --------------------------------------------------------- global aug ops

def random_flip(gt_boxes, points, probability=0.5, rng=None):
    rng = rng or np.random.RandomState()
    if rng.rand() < probability:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6] + np.pi
        points[:, 1] = -points[:, 1]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rotation=np.pi / 4, rng=None):
    rng = rng or np.random.RandomState()
    if not isinstance(rotation, (list, tuple, np.ndarray)):
        rotation = [-rotation, rotation]
    angle = rng.uniform(rotation[0], rotation[1])
    points[:, :3] = box_np.rotation_points_single_angle(
        points[:, :3], angle, axis=2
    )
    gt_boxes[:, :3] = box_np.rotation_points_single_angle(
        gt_boxes[:, :3], angle, axis=2
    )
    gt_boxes[:, 6] += angle
    return gt_boxes, points


def global_scaling(gt_boxes, points, min_scale=0.95, max_scale=1.05,
                   rng=None):
    rng = rng or np.random.RandomState()
    s = rng.uniform(min_scale, max_scale)
    points[:, :3] *= s
    gt_boxes[:, :6] *= s
    return gt_boxes, points


def global_translate(gt_boxes, points, noise_translate_std, rng=None):
    rng = rng or np.random.RandomState()
    if not isinstance(noise_translate_std, (list, tuple, np.ndarray)):
        noise_translate_std = [noise_translate_std] * 3
    t = np.array(
        [rng.normal(0, s) for s in noise_translate_std], points.dtype
    )
    points[:, :3] += t
    gt_boxes[:, :3] += t
    return gt_boxes, points


def filter_gt_box_outside_range(gt_boxes, limit_range):
    """Keep GT boxes whose BEV center-corner box intersects the range
    (reference ``filter_gt_box_outside_range`` :699-713)."""
    bv = box_np.center_to_corner_box2d(
        gt_boxes[:, :2], gt_boxes[:, 3:5], gt_boxes[:, 6]
    )
    limit = np.asarray(limit_range)  # [xmin, ymin, xmax, ymax]
    mins = bv.min(axis=1)
    maxs = bv.max(axis=1)
    return ~(
        (maxs[:, 0] < limit[0])
        | (maxs[:, 1] < limit[1])
        | (mins[:, 0] > limit[2])
        | (mins[:, 1] > limit[3])
    )


# ------------------------------------------------- sampler infrastructure

class BatchSampler:
    """Epoch-shuffled index sampler over a pool (reference :17-49)."""

    def __init__(self, sampled_list, name=None, shuffle=True, rng=None):
        self._sampled_list = sampled_list
        self._rng = rng or np.random.RandomState()
        self._indices = np.arange(len(sampled_list))
        if shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0
        self._num = len(sampled_list)
        self._shuffle = shuffle
        self._name = name

    def _sample(self, num):
        if self._idx + num >= self._num:
            ret = self._indices[self._idx:].copy()
            self._reset()
        else:
            ret = self._indices[self._idx : self._idx + num]
            self._idx += num
        return ret

    def _reset(self):
        if self._shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0

    def sample(self, num):
        return [self._sampled_list[i] for i in self._sample(num)]


class DBFilterByDifficulty:
    def __init__(self, removed_difficulties):
        self._removed = removed_difficulties

    def __call__(self, db_infos):
        return {
            key: [
                info
                for info in dinfos
                if info["difficulty"] not in self._removed
            ]
            for key, dinfos in db_infos.items()
        }


class DBFilterByMinNumPoint:
    def __init__(self, min_gt_point_dict):
        self._min = min_gt_point_dict

    def __call__(self, db_infos):
        for name, min_num in self._min.items():
            if min_num > 0 and name in db_infos:
                db_infos[name] = [
                    info
                    for info in db_infos[name]
                    if info["num_points_in_gt"] >= min_num
                ]
        return db_infos


class DataBasePreprocessor:
    def __init__(self, preprocessors):
        self._preprocessors = preprocessors

    def __call__(self, db_infos):
        for p in self._preprocessors:
            db_infos = p(db_infos)
        return db_infos
