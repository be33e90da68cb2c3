"""Synthetic lidar frames for the detection serving path (counterpart of
``papc_tpu/data/synthetic_kitti.py::make_scene``; the KITTI tree writer
waits for the KITTI pipeline).

A scene is a ground plane of uniform points and car-sized boxes filled
with points. :class:`SyntheticFrames` pads each cloud to the config's
``MAX_POINTS_PER_FRAME`` with a points mask and carries the anchors, as
the JAX prep's device-pillarize examples do, so a batch feeds
``detect.train.make_predict_step`` directly. Given a target assigner it
also carries each frame's training targets, as the target block of the
JAX prep (``papc_tpu/detect/kitti/preprocess.py``) makes them with no
anchors mask, so a batch feeds ``make_detection_train_step``.
"""

from __future__ import annotations

import time

import numpy as np

from papc_tpu_torch.detect import box_np


def make_scene(rng, num_cars=3, n_background=2000, x_range=(8.0, 50.0),
               y_range=(-15.0, 15.0), car_points=(80, 200)):
    """Random lidar-frame scene → ``(points [N, 4], gt_boxes [M, 7])``."""
    boxes = []
    for _ in range(num_cars):
        x = rng.uniform(*x_range)
        y = rng.uniform(*y_range)
        z = rng.uniform(-1.8, -1.4)  # bottom near ground
        w, l, h = 1.6, 3.9, 1.56
        yaw = rng.uniform(-np.pi, np.pi)
        boxes.append([x, y, z, w, l, h, yaw])
    gt_boxes = np.asarray(boxes, np.float32).reshape(-1, 7)

    pts = [np.stack([
        rng.uniform(0, 69.0, n_background),
        rng.uniform(-39.0, 39.0, n_background),
        rng.normal(-1.75, 0.03, n_background),
        rng.uniform(0, 1, n_background),
    ], axis=1)]
    # points uniform inside each box, rotated with the pipeline's yaw
    # convention (rotation_points_single_angle's row-vector form)
    for b in gt_boxes:
        n = int(rng.randint(*car_points))
        local = np.stack([
            rng.uniform(-b[3] / 2 + 0.03, b[3] / 2 - 0.03, n),
            rng.uniform(-b[4] / 2 + 0.03, b[4] / 2 - 0.03, n),
            rng.uniform(0.05, b[5] - 0.05, n),
        ], axis=1)
        xyz = box_np.rotation_points_single_angle(local, b[6]) + b[:3]
        refl = rng.uniform(0, 1, n)
        pts.append(np.concatenate([xyz, refl[:, None]], axis=1))
    return np.concatenate(pts).astype(np.float32), gt_boxes


def pad_frame(points: np.ndarray, max_points: int):
    """A cloud cut or zero-padded to ``max_points`` rows, and its mask."""
    n = min(len(points), max_points)
    pts = np.zeros((max_points, points.shape[1]), np.float32)
    pts[:n] = points[:n]
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    return pts, mask


class SyntheticFrames:
    """``n`` synthetic frames made in bulk from ``seed``; ``frames[i]`` is
    an example ``{"points" [P, 4], "points_mask" [P], "anchors" [A, 7]}``
    and ``gt_boxes[i]`` its cars ``[M, 7]``. The defaults (about 23 000
    ground points over the 432 × 496 grid and 10 cars) occupy more cells
    than the config's 12 000-pillar cap, as a KITTI frame nearly does,
    and stay under the 25 000-point frame.

    With ``target_assigner`` (and the anchors' ``matched_thresholds`` /
    ``unmatched_thresholds [A]``, from its ``generate_anchors``) each
    example also holds ``labels [A]``, ``reg_targets [A, code]`` and
    ``reg_weights [A]``; the assigner's random draws (with a positive
    fraction) come from ``RandomState(seed)``. ``target_seconds`` holds
    each frame's host seconds of assignment."""

    def __init__(self, n: int, anchors: np.ndarray, max_points: int = 25000,
                 seed: int = 0, num_cars: int = 10,
                 n_background: int = 23000, target_assigner=None,
                 matched_thresholds=None, unmatched_thresholds=None):
        rng = np.random.RandomState(seed)
        self.anchors = np.asarray(anchors, np.float32)
        self.frames, self.gt_boxes, self.target_seconds = [], [], []
        if target_assigner is not None:
            target_rng = np.random.RandomState(seed)
            anchors_bv = box_np.rbbox2d_to_near_bbox(
                self.anchors[:, [0, 1, 3, 4, 6]])
        for _ in range(n):
            points, gt_boxes = make_scene(rng, num_cars=num_cars,
                                          n_background=n_background)
            pts, mask = pad_frame(points, max_points)
            frame = {"points": pts, "points_mask": mask}
            if target_assigner is not None:
                t0 = time.perf_counter()
                targets = target_assigner.assign(
                    self.anchors, gt_boxes,
                    matched_thresholds=matched_thresholds,
                    unmatched_thresholds=unmatched_thresholds,
                    rng=target_rng, anchors_bv=anchors_bv)
                self.target_seconds.append(time.perf_counter() - t0)
                frame.update(labels=targets["labels"],
                             reg_targets=targets["bbox_targets"],
                             reg_weights=targets["bbox_outside_weights"])
            self.frames.append(frame)
            self.gt_boxes.append(gt_boxes)

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, i: int) -> dict:
        return {**self.frames[i], "anchors": self.anchors}


def collate_batch(examples: list) -> dict:
    """Stack ``examples`` along a new batch axis."""
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
