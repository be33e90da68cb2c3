"""Per-frame preparation, the KITTI dataset and batch collation
(counterpart of ``papc_tpu/detect/kitti/preprocess.py``).

``prep_pointcloud``: the ground truth into the lidar frame, the database
sampler's paste, per-object noise, the global flip, rotation, scaling and
translation, the range filter, then the pillars, the anchors, the
anchors mask (the numpy summed-area table; JAX's C++
``cc.anchors_area`` gives the same) and the targets. The pillars come
one of three ways: pillarized on the host into the flat view of the
flat PFN (``points_flat``, ``point_pillar``, ``num_points``,
``coordinates``: JAX's C++ streamer, ``detect/voxelize_np.py``), into
the padded grid of the classic PFN (``voxels`` and the same counts and
cells), or left to the step (``device_voxelize``: the raw cloud padded
to ``max_points_per_frame`` with its mask, pillarized on the device by
``ops/voxelize.py``). Every example has a static shape, so
``collate_batch`` stacks them.

``KittiDataset[idx]`` draws from ``RandomState`` seeded by ``(base_seed,
epoch, idx)``, so a frame's augmentation does not depend on the order or
the process that prepares it; with ``enable_per_item_sampler_seeding``
the database sampler is reseeded per item too (the worker pool's mode).
"""

from __future__ import annotations

import pathlib
import pickle

import numpy as np

from papc_tpu_torch.detect import box_np
from papc_tpu_torch.detect.kitti import augment as prep
from papc_tpu_torch.detect.voxelize_np import (points_to_bev,
                                               points_to_voxel,
                                               points_to_voxel_flat)


def drop_arrays_by_name(gt_names, used_classes):
    return np.array(
        [i for i, x in enumerate(gt_names) if x not in used_classes],
        dtype=np.int64,
    )


def keep_arrays_by_name(gt_names, used_classes):
    return np.array(
        [i for i, x in enumerate(gt_names) if x in used_classes],
        dtype=np.int64,
    )


def remove_points_in_boxes(points, boxes):
    masks = box_np.points_in_rbbox(points, boxes)
    return points[~masks.any(-1)]


def host_pillars(points, voxel_generator, max_voxels: int, n_cap=None):
    """The host's pillars of a cloud, first come first served →
    ``(arrays, K)``: with ``n_cap`` the flat view of the flat PFN
    (``points_flat [n_cap, D]``, ``point_pillar [n_cap]``; JAX's C++
    streamer on the float32 cloud), else the padded grid (``voxels
    [max_voxels, P, D]`` in the cloud's dtype); ``num_points``, and
    ``coordinates`` (z, y, x) that are -1 past the ``K`` kept pillars."""
    args = (voxel_generator.voxel_size, voxel_generator.point_cloud_range,
            voxel_generator.max_num_points, max_voxels)
    if n_cap is not None:
        flat, owner, coords, num_points, k = points_to_voxel_flat(
            points.astype(np.float32), *args, n_cap)
        arrays = {"points_flat": flat, "point_pillar": owner}
    else:
        voxels, coords, num_points = points_to_voxel(points, *args,
                                                     pad_output=True)
        k = int((num_points > 0).sum())
        arrays = {"voxels": voxels}
    coords[k:] = -1  # padding rows are invalid for the BEV scatter
    arrays.update(num_points=num_points, coordinates=coords)
    return arrays, k


def prep_pointcloud(
    input_dict,
    root_path,
    voxel_generator,
    target_assigner,
    db_sampler=None,
    max_voxels=12000,
    class_names=("Car",),
    remove_outside_points=False,
    training=True,
    create_targets=True,
    shuffle_points=False,
    remove_unknown=False,
    gt_rotation_noise=(-np.pi / 3, np.pi / 3),
    gt_loc_noise_std=(1.0, 1.0, 1.0),
    global_random_rot_range=(0.0, 0.0),
    random_crop=False,
    use_group_id=False,
    global_rotation_noise=(-np.pi / 4, np.pi / 4),
    global_scaling_noise=(0.95, 1.05),
    global_loc_noise_std=(0.2, 0.2, 0.2),
    generate_bev=False,
    without_reflectivity=False,
    num_point_features=4,
    anchor_area_threshold=1,
    remove_points_after_sample=True,
    anchor_cache=None,
    out_size_factor=2,
    rng: np.random.RandomState | None = None,
    device_voxelize: bool = False,
    max_points_per_frame: int = 25000,
    emit_flat_points: bool = False,
):
    """One sample: augment → pillars → anchors, their mask → targets.

    By default the host pillarizes first come first served
    (``detect/voxelize_np.py``) into at most ``max_voxels`` pillars: into
    the flat view with ``emit_flat_points`` (the flat PFN's input: the
    accepted points, at most ``max_points_per_frame``, grouped by pillar,
    with each one's pillar row), else into the padded ``[max_voxels, P,
    D]`` grid; cells past the kept pillars are -1. The anchors mask then
    comes from the kept pillars' cells. With ``device_voxelize`` the
    example carries the raw cloud padded to ``max_points_per_frame`` with
    its mask instead, and the step pillarizes it on the device
    (:func:`papc_tpu_torch.ops.voxelize.voxelize`); the anchors mask then
    comes from every occupied cell (the reference's voxel-count table,
    for pillar grids, where a BEV cell holds at most one voxel). With
    ``generate_bev`` the example also carries ``points_to_bev``'s maps
    on a grid of half the cell side and twice its height."""
    rng = rng or np.random.RandomState()
    class_names = list(class_names)
    points = input_dict["points"]
    rect = input_dict["rect"]
    Trv2c = input_dict["Trv2c"]
    P2 = input_dict["P2"]

    if remove_outside_points:
        points = box_np.remove_outside_points(
            points, rect, Trv2c, P2, input_dict["image_shape"]
        )

    if training:
        gt_boxes = input_dict["gt_boxes"]
        gt_names = input_dict["gt_names"]
        difficulty = input_dict["difficulty"]
        group_ids = None
        if use_group_id and "group_ids" in input_dict:
            group_ids = input_dict["group_ids"]

        selected = drop_arrays_by_name(gt_names, ["DontCare"])
        gt_boxes = gt_boxes[selected]
        gt_names = gt_names[selected]
        difficulty = difficulty[selected]
        if group_ids is not None:
            group_ids = group_ids[selected]
        gt_boxes = box_np.box_camera_to_lidar(gt_boxes, rect, Trv2c)
        if remove_unknown:
            keep = difficulty != -1
            gt_boxes, gt_names = gt_boxes[keep], gt_names[keep]
            difficulty = difficulty[keep]
            if group_ids is not None:
                group_ids = group_ids[keep]
        gt_boxes_mask = np.array(
            [n in class_names for n in gt_names], dtype=bool
        )
        if db_sampler is not None:
            sampled_dict = db_sampler.sample_all(
                root_path, gt_boxes, gt_names, num_point_features,
                random_crop=random_crop,
                gt_group_ids=group_ids,
                rect=rect, Trv2c=Trv2c, P2=P2,
            )
            if sampled_dict is not None:
                gt_names = np.concatenate(
                    [gt_names, sampled_dict["gt_names"]]
                )
                gt_boxes = np.concatenate(
                    [gt_boxes, sampled_dict["gt_boxes"]]
                )
                gt_boxes_mask = np.concatenate(
                    [gt_boxes_mask, sampled_dict["gt_masks"]]
                )
                if group_ids is not None:
                    group_ids = np.concatenate(
                        [group_ids, sampled_dict["group_ids"]]
                    )
                if remove_points_after_sample:
                    points = remove_points_in_boxes(
                        points, sampled_dict["gt_boxes"]
                    )
                points = np.concatenate(
                    [sampled_dict["points"], points], axis=0
                )
        if without_reflectivity:
            used = [
                i for i in range(num_point_features) if i != 3
            ]
            points = points[:, used]

        prep.noise_per_object_(
            gt_boxes,
            points,
            gt_boxes_mask,
            rotation_perturb=gt_rotation_noise,
            center_noise_std=gt_loc_noise_std,
            global_random_rot_range=list(global_random_rot_range),
            num_try=100,
            group_ids=group_ids,
            rng=rng,
        )
        gt_boxes = gt_boxes[gt_boxes_mask]
        gt_names = gt_names[gt_boxes_mask]
        gt_classes = np.array(
            [class_names.index(n) + 1 for n in gt_names], dtype=np.int32
        )
        gt_boxes, points = prep.random_flip(gt_boxes, points, rng=rng)
        gt_boxes, points = prep.global_rotation(
            gt_boxes, points, rotation=global_rotation_noise, rng=rng
        )
        gt_boxes, points = prep.global_scaling(
            gt_boxes, points, *global_scaling_noise, rng=rng
        )
        gt_boxes, points = prep.global_translate(
            gt_boxes, points, global_loc_noise_std, rng=rng
        )
        bv_range = voxel_generator.point_cloud_range[[0, 1, 3, 4]]
        mask = prep.filter_gt_box_outside_range(gt_boxes, bv_range)
        gt_boxes = gt_boxes[mask]
        gt_classes = gt_classes[mask]
        gt_boxes[:, 6] = box_np.limit_period(
            gt_boxes[:, 6], offset=0.5, period=2 * np.pi
        )

    if shuffle_points:
        points = points[rng.permutation(len(points))]

    voxel_size = voxel_generator.voxel_size
    pc_range = voxel_generator.point_cloud_range
    grid_size = voxel_generator.grid_size

    if device_voxelize:
        # the padded raw cloud; the step pillarizes it on the device
        # (papc_tpu_torch.ops.voxelize)
        n = min(len(points), max_points_per_frame)
        pts = np.zeros(
            (max_points_per_frame, points.shape[1]), np.float32
        )
        pts[:n] = points[:n]
        pmask = np.zeros(max_points_per_frame, bool)
        pmask[:n] = True
        # cell occupancy for the anchors mask (voxel-count equivalent)
        cell = np.floor(
            (points[:n, :3] - pc_range[:3]) / voxel_size
        ).astype(np.int64)
        ok = ((cell >= 0) & (cell < grid_size[None, :])).all(axis=1)
        cell = cell[ok]
        lin = (
            cell[:, 2] * grid_size[1] * grid_size[0]
            + cell[:, 1] * grid_size[0]
            + cell[:, 0]
        )
        uniq = np.unique(lin)
        cz = uniq // (grid_size[1] * grid_size[0])
        rem = uniq % (grid_size[1] * grid_size[0])
        occupied_coords = np.stack(
            [cz, rem // grid_size[0], rem % grid_size[0]], axis=1
        ).astype(np.int32)
        example = {
            "points": pts,
            "points_mask": pmask,
            "rect": rect,
            "Trv2c": Trv2c,
            "P2": P2,
        }
        coordinates = occupied_coords
        num_voxels = len(occupied_coords)
    else:
        pillars, num_voxels = host_pillars(
            points, voxel_generator, max_voxels,
            max_points_per_frame if emit_flat_points else None)
        coordinates = pillars["coordinates"]
        example = {**pillars,
                   "num_voxels": np.array([num_voxels], dtype=np.int64),
                   "rect": rect, "Trv2c": Trv2c, "P2": P2}
    example["image_idx"] = np.array(
        input_dict.get("image_idx", 0), dtype=np.int64
    )
    example["image_shape"] = np.asarray(
        input_dict.get("image_shape", (375, 1242)), dtype=np.int32
    )

    feature_map_size = grid_size[:2] // out_size_factor
    feature_map_size = [*feature_map_size, 1][::-1]
    if anchor_cache is not None:
        anchors = anchor_cache["anchors"]
        anchors_bv = anchor_cache["anchors_bv"]
        matched_thresholds = anchor_cache["matched_thresholds"]
        unmatched_thresholds = anchor_cache["unmatched_thresholds"]
    else:
        ret = target_assigner.generate_anchors(feature_map_size)
        anchors = ret["anchors"].reshape([-1, 7])
        matched_thresholds = ret["matched_thresholds"]
        unmatched_thresholds = ret["unmatched_thresholds"]
        anchors_bv = box_np.rbbox2d_to_near_bbox(
            anchors[:, [0, 1, 3, 4, 6]]
        )
    example["anchors"] = anchors

    anchors_mask = None
    if anchor_area_threshold >= 0:
        area_idx = None
        if anchor_cache is not None:
            # anchor grid is static: compute the SAT corner indices once
            area_idx = anchor_cache.get("area_indices")
            if area_idx is None:
                area_idx = box_np.precompute_anchor_area_indices(
                    anchors_bv, voxel_size, pc_range, grid_size
                )
                anchor_cache["area_indices"] = area_idx
        ny, nx = tuple(grid_size[::-1][1:])
        dense_map = box_np.sparse_sum_for_anchors_mask(
            coordinates[:num_voxels], (ny, nx)
        )
        dense_map = dense_map.cumsum(0).cumsum(1)
        anchors_area = box_np.fused_get_anchors_area(
            dense_map, anchors_bv, voxel_size, pc_range, grid_size,
            indices=area_idx,
        )
        anchors_mask = anchors_area > anchor_area_threshold
        example["anchors_mask"] = anchors_mask
    if generate_bev:
        bev_vxsize = voxel_size.copy()
        bev_vxsize[:2] /= 2
        bev_vxsize[2] *= 2
        example["bev_map"] = points_to_bev(
            points, bev_vxsize, pc_range, not without_reflectivity
        )
    if not training:
        return example
    if create_targets:
        targets = target_assigner.assign(
            anchors,
            gt_boxes,
            anchors_mask,
            gt_classes=gt_classes,
            matched_thresholds=matched_thresholds,
            unmatched_thresholds=unmatched_thresholds,
            rng=rng,
            anchors_bv=anchors_bv,
        )
        example.update(
            {
                "labels": targets["labels"],
                "reg_targets": targets["bbox_targets"],
                "reg_weights": targets["bbox_outside_weights"],
            }
        )
    return example


def read_and_prep(info, root_path, num_point_features, prep_func):
    """Read one frame's reduced velodyne + calib + annos and prep it
    (reference ``_read_and_prep_v9`` :306-363)."""
    v_path = pathlib.Path(root_path) / info["velodyne_path"]
    v_path = v_path.parent.parent / (
        v_path.parent.stem + "_reduced"
    ) / v_path.name
    points = np.fromfile(str(v_path), dtype=np.float32).reshape(
        [-1, num_point_features]
    )
    image_idx = info["image_idx"]
    rect = info["calib/R0_rect"].astype(np.float32)
    Trv2c = info["calib/Tr_velo_to_cam"].astype(np.float32)
    P2 = info["calib/P2"].astype(np.float32)

    input_dict = {
        "points": points,
        "rect": rect,
        "Trv2c": Trv2c,
        "P2": P2,
        "image_shape": np.array(info["img_shape"], dtype=np.int32),
        "image_idx": image_idx,
        "image_path": info["img_path"],
    }
    if "annos" in info:
        annos = info["annos"]
        annos = {
            k: v for k, v in annos.items()
        }
        # keep all classes here; prep filters via class_names
        loc = annos["location"]
        dims = annos["dimensions"]
        rots = annos["rotation_y"]
        gt_boxes = np.concatenate(
            [loc, dims, rots[..., None]], axis=1
        ).astype(np.float32)
        input_dict.update(
            {
                "gt_boxes": gt_boxes,
                "gt_names": annos["name"],
                "difficulty": annos["difficulty"],
            }
        )
    return prep_func(input_dict=input_dict)


class KittiDataset:
    """Info-pkl-backed dataset with a pre-generated anchor cache
    (reference ``data/dataset.py:52-91``)."""

    def __init__(
        self,
        info_path,
        root_path,
        num_point_features,
        target_assigner,
        feature_map_size,
        prep_func,
        base_seed: int = 0,
        db_sampler=None,
    ):
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        self._root_path = root_path
        self._kitti_infos = infos
        self._num_point_features = num_point_features
        ret = target_assigner.generate_anchors(feature_map_size)
        anchors = ret["anchors"].reshape([-1, 7])
        anchors_bv = box_np.rbbox2d_to_near_bbox(
            anchors[:, [0, 1, 3, 4, 6]]
        )
        self._anchor_cache = {
            "anchors": anchors,
            "anchors_bv": anchors_bv,
            "matched_thresholds": ret["matched_thresholds"],
            "unmatched_thresholds": ret["unmatched_thresholds"],
        }
        self._prep_func = prep_func
        self._base_seed = int(base_seed)
        self._epoch = 0
        self._db_sampler = db_sampler
        self._reseed_sampler = False

    def set_epoch(self, epoch: int):
        """Advance the augmentation RNG stream (deterministic per
        (base_seed, epoch, idx) — reproducible with any worker count)."""
        self._epoch = int(epoch)

    def enable_per_item_sampler_seeding(self, on: bool = True):
        """In multiprocess mode the GT-DB sampler is reseeded per item
        so paste augmentation is worker-count independent (single-process
        mode keeps the reference's stateful epoch-pool semantics)."""
        self._reseed_sampler = bool(on)

    def __len__(self):
        return len(self._kitti_infos)

    @property
    def kitti_infos(self):
        return self._kitti_infos

    @property
    def anchor_cache(self):
        return self._anchor_cache

    def __getitem__(self, idx):
        item_seed = (
            self._base_seed * 9176 + self._epoch * 131071 + idx
        ) % (2**31 - 1)
        rng = np.random.RandomState(item_seed)
        if self._reseed_sampler and self._db_sampler is not None:
            # decorrelated stream: a golden-ratio mix, NOT item_seed+1
            # (which would be bit-identical to item idx+1's aug stream)
            self._db_sampler.reseed(
                (item_seed * 0x9E3779B1 + 0x7F4A7C15) % (2**32)
            )
        return read_and_prep(
            info=self._kitti_infos[idx],
            root_path=self._root_path,
            num_point_features=self._num_point_features,
            prep_func=lambda input_dict: self._prep_func(
                input_dict=input_dict,
                anchor_cache=self._anchor_cache,
                rng=rng,
            ),
        )


def collate_batch(examples: list[dict]) -> dict:
    """Stack fixed-shape per-sample examples into [B, ...] arrays (the
    static-shape replacement for the reference's ``merge_second_batch``)."""
    out = {}
    for key in examples[0]:
        if key == "num_voxels":
            continue
        vals = [e[key] for e in examples]
        out[key] = np.stack(vals, axis=0)
    return out
