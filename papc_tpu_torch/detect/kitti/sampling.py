"""Ground-truth database sampling, the paste augmentation (counterpart of
``papc_tpu/detect/kitti/sampling.py::DataBaseSamplerV2``): per-class
sampling up to ``name_to_max_num`` with collision-tested placement,
multi-class group sampling with joint collision handling, placement
anywhere on the object's circle (``global_rot_range``) and the random
frustum-crop truncation of the pasted points. ``reseed`` makes the draws
a function of one seed, which the worker pool's per-item seeding uses.
"""

from __future__ import annotations

import pathlib

import numpy as np

from papc_tpu_torch.detect import box_np
from papc_tpu_torch.detect.kitti.augment import (
    BatchSampler,
    box_collision_test,
    mask_points_in_corners,
    noise_per_object_,
    random_crop_frustum,
)


def _copy_info(info: dict) -> dict:
    """Per-draw copy of a db info: only ``box3d_lidar`` (and the scalar
    fields we overwrite) are mutated downstream, so a shallow dict copy +
    one array copy replaces the reference's deepcopy (which dominated
    sampler time — ~1.2 ms/sample of pure copy.deepcopy overhead)."""
    out = dict(info)
    out["box3d_lidar"] = np.array(info["box3d_lidar"], copy=True)
    return out


class DataBaseSamplerV2:
    def __init__(
        self,
        db_infos: dict,
        groups: list,
        db_prepor=None,
        rate: float = 1.0,
        global_rot_range=None,
        rng: np.random.RandomState | None = None,
        log=print,
    ):
        for k, v in db_infos.items():
            log(f"load {len(v)} {k} database infos")
        if db_prepor is not None:
            db_infos = db_prepor(db_infos)
            log("After filter database:")
            for k, v in db_infos.items():
                log(f"load {len(v)} {k} database infos")

        self.db_infos = db_infos
        self._rate = rate
        self._rng = rng or np.random.RandomState()
        self._sample_classes = []
        self._sample_max_nums = []
        self._group_name_to_names = []
        # group sampling kicks in when any sample group names >1 class
        # (reference :36-37)
        self._use_group_sampling = any(len(g) > 1 for g in groups)
        if not self._use_group_sampling:
            self._group_db_infos = dict(db_infos)
            for group_info in groups:
                self._sample_classes += list(group_info.keys())
                self._sample_max_nums += list(group_info.values())
        else:
            # pool db entries by their recorded group_id so co-occurring
            # objects (e.g. a cyclist + its rider) are pasted together
            self._group_db_infos = {}
            for group_info in groups:
                group_names = list(group_info.keys())
                group_name = ", ".join(group_names)
                self._sample_classes += group_names
                self._sample_max_nums += list(group_info.values())
                self._group_name_to_names.append(
                    (group_name, group_names)
                )
                group_dict = {}
                for name in group_names:
                    for item in db_infos.get(name, []):
                        group_dict.setdefault(
                            item["group_id"], []
                        ).append(item)
                if group_name in self._group_db_infos:
                    raise ValueError("group must be unique")
                self._group_db_infos[group_name] = list(
                    group_dict.values()
                )
        self._sampler_dict = {
            k: BatchSampler(v, k, rng=self._rng)
            for k, v in self._group_db_infos.items()
        }
        # optional placement anywhere on the circle (reference :80-89)
        self._enable_global_rot = False
        if global_rot_range is not None:
            if not isinstance(
                global_rot_range, (list, tuple, np.ndarray)
            ):
                global_rot_range = [-global_rot_range, global_rot_range]
            if (
                np.abs(global_rot_range[0] - global_rot_range[1])
                >= 1e-3
            ):
                self._enable_global_rot = True
        self._global_rot_range = global_rot_range

    @property
    def use_group_sampling(self) -> bool:
        return self._use_group_sampling

    def reseed(self, seed: int):
        """Deterministically reseed the draw streams (used by the
        multiprocess loader so DB-paste augmentation is a pure function
        of (base_seed, epoch, idx) — any worker count reproduces it).
        Only the pools actually sampled are rebuilt."""
        self._rng = np.random.RandomState(seed)
        keys = (
            [g for g, _ in self._group_name_to_names]
            if self._use_group_sampling
            else self._sample_classes
        )
        for k in keys:
            if k in self._group_db_infos:
                self._sampler_dict[k] = BatchSampler(
                    self._group_db_infos[k], k, rng=self._rng
                )

    def sample_all(
        self,
        root_path: str,
        gt_boxes: np.ndarray,
        gt_names: np.ndarray,
        num_point_features: int,
        random_crop: bool = False,
        gt_group_ids: np.ndarray | None = None,
        rect: np.ndarray | None = None,
        Trv2c: np.ndarray | None = None,
        P2: np.ndarray | None = None,
    ):
        """Fill the scene up to per-class quotas. Returns None when no
        sample survives collision testing, else a dict with ``gt_names``,
        ``difficulty``, ``gt_boxes``, ``points``, ``gt_masks``,
        ``group_ids``."""
        sampled_num_dict = {}
        sample_num_per_class = []
        for class_name, max_num in zip(
            self._sample_classes, self._sample_max_nums
        ):
            n = int(max_num - np.sum(gt_names == class_name))
            n = int(np.round(self._rate * n))
            sampled_num_dict[class_name] = n
            sample_num_per_class.append(n)

        sampled_groups = self._sample_classes
        total_group_ids = None
        if self._use_group_sampling:
            assert gt_group_ids is not None
            sampled_groups = []
            sample_num_per_class = []
            for group_name, class_names in self._group_name_to_names:
                sampled_groups.append(group_name)
                sample_num_per_class.append(
                    int(max(sampled_num_dict[n] for n in class_names))
                )
            total_group_ids = gt_group_ids

        sampled, sampled_gt_boxes = [], []
        avoid = gt_boxes
        for name, n in zip(sampled_groups, sample_num_per_class):
            if n > 0:
                if self._use_group_sampling:
                    cls_sampled = self.sample_group(
                        name, n, avoid, total_group_ids
                    )
                else:
                    cls_sampled = self.sample_class(name, n, avoid)
                sampled += cls_sampled
                if cls_sampled:
                    boxes = np.stack(
                        [s["box3d_lidar"] for s in cls_sampled]
                    )
                    sampled_gt_boxes.append(boxes)
                    avoid = np.concatenate([avoid, boxes], axis=0)
                    if self._use_group_sampling:
                        total_group_ids = np.concatenate(
                            [
                                total_group_ids,
                                np.array(
                                    [s["group_id"] for s in cls_sampled]
                                ),
                            ],
                            axis=0,
                        )

        if not sampled:
            return None
        sampled_gt_boxes = np.concatenate(sampled_gt_boxes, axis=0)
        points_list = []
        for info in sampled:
            pts = np.fromfile(
                str(pathlib.Path(root_path) / info["path"]),
                dtype=np.float32,
            ).reshape(-1, num_point_features)
            if "rot_transform" in info:
                pts[:, :3] = box_np.rotation_points_single_angle(
                    pts[:, :3], info["rot_transform"], axis=2
                )
            pts[:, :3] += info["box3d_lidar"][:3]
            points_list.append(pts)
        if random_crop:
            # randomly truncate pasted objects the way image-crop
            # truncation would (reference :182-197)
            assert rect is not None and Trv2c is not None and P2 is not None
            gt_bboxes = box_np.box3d_to_bbox(
                sampled_gt_boxes, rect, Trv2c, P2
            )
            crop_frustums = random_crop_frustum(
                gt_bboxes, rect, Trv2c, P2, rng=self._rng
            )
            cropped = []
            for i, pts in enumerate(points_list):
                mask = mask_points_in_corners(
                    pts, crop_frustums[i : i + 1]
                ).reshape(-1)
                num_remove = int(mask.sum())
                if num_remove > 0 and len(pts) - num_remove > 15:
                    pts = pts[~mask]
                cropped.append(pts)
            points_list = cropped
        if self._use_group_sampling:
            group_ids = np.array([s["group_id"] for s in sampled])
        else:
            group_ids = np.arange(
                len(gt_boxes), len(gt_boxes) + len(sampled)
            )
        return {
            "gt_names": np.array([s["name"] for s in sampled]),
            "difficulty": np.array([s["difficulty"] for s in sampled]),
            "gt_boxes": sampled_gt_boxes,
            "points": np.concatenate(points_list, axis=0),
            "gt_masks": np.ones((len(sampled),), dtype=bool),
            "group_ids": group_ids,
        }

    def _place_on_circle(self, gt_boxes, sp_boxes, group_ids=None):
        """Optionally re-place candidate boxes anywhere on their circle
        around the origin (reference :249-258 / :311-321). Returns the
        combined box array after the global-rot perturbation."""
        valid_mask = np.concatenate(
            [
                np.zeros(len(gt_boxes), bool),
                np.ones(len(sp_boxes), bool),
            ]
        )
        boxes = np.concatenate([gt_boxes, sp_boxes], axis=0).copy()
        if self._enable_global_rot:
            noise_per_object_(
                boxes,
                None,
                valid_mask,
                0,
                0,
                self._global_rot_range,
                num_try=100,
                group_ids=group_ids,
                rng=self._rng,
            )
        return boxes

    def sample_class(self, name, num, gt_boxes):
        """Collision-tested candidate placement
        (reference ``sample_class_v2`` :234-281)."""
        sampled = [
            _copy_info(s) for s in self._sampler_dict[name].sample(num)
        ]
        if not sampled:
            return []
        num_gt = len(gt_boxes)
        gt_bv = box_np.center_to_corner_box2d(
            gt_boxes[:, 0:2], gt_boxes[:, 3:5], gt_boxes[:, 6]
        )
        sp_boxes = np.stack([s["box3d_lidar"] for s in sampled])
        boxes = self._place_on_circle(gt_boxes, sp_boxes)
        sp_new = boxes[num_gt:]
        sp_bv = box_np.center_to_corner_box2d(
            sp_new[:, 0:2], sp_new[:, 3:5], sp_new[:, 6]
        )
        total_bv = np.concatenate([gt_bv, sp_bv], axis=0)
        coll = box_collision_test(total_bv, total_bv)
        np.fill_diagonal(coll, False)
        valid = []
        for i in range(num_gt, num_gt + len(sampled)):
            if coll[i].any():
                coll[i] = False
                coll[:, i] = False
            else:
                s = sampled[i - num_gt]
                if self._enable_global_rot:
                    s["box3d_lidar"][:2] = boxes[i, :2]
                    s["box3d_lidar"][-1] = boxes[i, -1]
                    s["rot_transform"] = (
                        boxes[i, -1] - sp_boxes[i - num_gt, -1]
                    )
                valid.append(s)
        return valid

    def sample_group(self, name, num, gt_boxes, gt_group_ids):
        """Joint placement of whole co-occurrence groups: a group is kept
        only if NONE of its members collides (reference ``sample_group``
        :283-346)."""
        groups = [
            [_copy_info(item) for item in group]
            for group in self._sampler_dict[name].sample(num)
        ]
        if not groups:
            return []
        sampled = [item for group in groups for item in group]
        group_num = [len(group) for group in groups]
        # rewrite sampled group ids so they never clash with scene ids
        gid_map = {}
        next_gid = int(np.max(gt_group_ids)) + 1 if len(gt_group_ids) else 0
        for s in sampled:
            gid = s["group_id"]
            if gid not in gid_map:
                gid_map[gid] = next_gid
                next_gid += 1
            s["group_id"] = gid_map[gid]

        num_gt = len(gt_boxes)
        gt_bv = box_np.center_to_corner_box2d(
            gt_boxes[:, 0:2], gt_boxes[:, 3:5], gt_boxes[:, 6]
        )
        sp_boxes = np.stack([s["box3d_lidar"] for s in sampled])
        sp_gids = np.array([s["group_id"] for s in sampled])
        boxes = self._place_on_circle(
            gt_boxes, sp_boxes,
            group_ids=np.concatenate([gt_group_ids, sp_gids]),
        )
        sp_new = boxes[num_gt:]
        sp_bv = box_np.center_to_corner_box2d(
            sp_new[:, 0:2], sp_new[:, 3:5], sp_new[:, 6]
        )
        total_bv = np.concatenate([gt_bv, sp_bv], axis=0)
        coll = box_collision_test(total_bv, total_bv)
        np.fill_diagonal(coll, False)
        valid = []
        idx = num_gt
        for num_in_group in group_num:
            block = slice(idx, idx + num_in_group)
            if coll[block].any():
                coll[block] = False
                coll[:, block] = False
            else:
                for i in range(idx, idx + num_in_group):
                    s = sampled[i - num_gt]
                    if self._enable_global_rot:
                        s["box3d_lidar"][:2] = boxes[i, :2]
                        s["box3d_lidar"][-1] = boxes[i, -1]
                        s["rot_transform"] = (
                            boxes[i, -1] - sp_boxes[i - num_gt, -1]
                        )
                    valid.append(s)
            idx += num_in_group
        return valid
