"""Synthetic lidar frames and miniature KITTI trees (counterpart of
``papc_tpu/data/synthetic_kitti.py``).

A scene is a ground plane of uniform points and car-sized boxes filled
with points (:func:`make_scene`); a tree may add pedestrian- and
cyclist-sized ones (``write_kitti``'s ``classes``). :func:`write_kitti` writes such scenes
as a KITTI tree (``training/velodyne/*.bin``, ``label_2/*.txt``,
``calib/*.txt``, ``image_2/*.png``, the ImageSets splits), the same files
byte for byte as the JAX package's writer but the PNGs, which it writes
with ``zlib`` and ``struct`` (the card's machine has no PIL): black
images of the KITTI shape, whose shape is all the pipeline reads.

:class:`SyntheticFrames` pads each cloud to the config's
``MAX_POINTS_PER_FRAME`` with a points mask and carries the anchors, as
the KITTI prep's device-pillarize examples do, so a batch feeds
``detect.train.make_predict_step`` directly. Given a target assigner it
also carries each frame's training targets, as the target block of the
prep (``detect/kitti/preprocess.py``) makes them with no anchors mask, so
a batch feeds ``make_detection_train_step``. :func:`host_pillarize`
turns such an example into the host prep's pillars (flat or padded).
"""

from __future__ import annotations

import pathlib
import struct
import time
import zlib

import numpy as np

from papc_tpu_torch.detect import box_np
from papc_tpu_torch.detect.kitti.common import kitti_result_line
from papc_tpu_torch.detect.kitti.preprocess import host_pillars

IMG_H, IMG_W = 375, 1242


def default_calib():
    """``(P, rect, Tr)``: a pinhole camera at the KITTI image's centre, no
    rectification, and the velodyne → camera axes with the sensor 1.7 m
    above the camera."""
    P = np.zeros((4, 4))
    P[0] = [700.0, 0.0, IMG_W / 2, 0.0]
    P[1] = [0.0, 700.0, IMG_H / 2, 0.0]
    P[2] = [0.0, 0.0, 1.0, 0.0]
    P[3, 3] = 1.0
    rect = np.eye(4)
    Tr = np.zeros((4, 4))
    # velodyne (x fwd, y left, z up) -> camera (x right, y down, z fwd)
    Tr[0, 1] = -1.0
    Tr[1, 2] = -1.0
    Tr[2, 0] = 1.0
    Tr[1, 3] = 1.7  # sensor height above camera
    Tr[3, 3] = 1.0
    return P, rect, Tr


def _calib_text(P, rect, Tr):
    def row(name, mat, n):
        vals = " ".join(f"{v:.12e}" for v in mat[:n].reshape(-1))
        return f"{name}: {vals}"

    lines = [
        row("P0", P, 3),
        row("P1", P, 3),
        row("P2", P, 3),
        row("P3", P, 3),
        row("R0_rect", rect[:3, :3], 3),
        row("Tr_velo_to_cam", Tr, 3),
        row("Tr_imu_to_velo", np.eye(4), 3),
    ]
    return "\n".join(lines) + "\n"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def black_png(width: int, height: int) -> bytes:
    """A black 8-bit RGB PNG (each row filter 0, one zlib stream)."""
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    rows = bytes(height * (1 + 3 * width))
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows, 9))
            + _png_chunk(b"IEND", b""))


# (w, l, h) of each class's objects: the 3-class config's anchor sizes
SIZES = {"Car": (1.6, 3.9, 1.56), "Pedestrian": (0.6, 0.8, 1.73),
         "Cyclist": (0.6, 1.76, 1.73)}


def _place(rng, n, size, x_range, y_range):
    """``n`` boxes ``[n, 7]`` of ``size`` (w, l, h) at uniform positions
    and yaws, their bottoms near the ground."""
    boxes = []
    for _ in range(n):
        x = rng.uniform(*x_range)
        y = rng.uniform(*y_range)
        z = rng.uniform(-1.8, -1.4)  # bottom near ground
        yaw = rng.uniform(-np.pi, np.pi)
        boxes.append([x, y, z, *size, yaw])
    return np.asarray(boxes, np.float32).reshape(-1, 7)


def _box_points(rng, b, n_points):
    """Points ``[n, 4]`` uniform inside box ``b``, rotated with the
    pipeline's yaw convention (rotation_points_single_angle's row-vector
    form), with a reflectance."""
    n = int(rng.randint(*n_points))
    local = np.stack([
        rng.uniform(-b[3] / 2 + 0.03, b[3] / 2 - 0.03, n),
        rng.uniform(-b[4] / 2 + 0.03, b[4] / 2 - 0.03, n),
        rng.uniform(0.05, b[5] - 0.05, n),
    ], axis=1)
    xyz = box_np.rotation_points_single_angle(local, b[6]) + b[:3]
    refl = rng.uniform(0, 1, n)
    return np.concatenate([xyz, refl[:, None]], axis=1)


def make_objects(rng, name: str, n: int, x_range=(8.0, 50.0),
                 y_range=(-15.0, 15.0), n_points=(80, 200)):
    """``n`` objects of class ``name`` (a key of ``SIZES``) with points
    inside them → ``(points [N, 4], boxes [n, 7])``."""
    boxes = _place(rng, n, SIZES[name], x_range, y_range)
    pts = [_box_points(rng, b, n_points) for b in boxes]
    points = (np.concatenate(pts) if pts
              else np.zeros((0, 4))).astype(np.float32)
    return points, boxes


def make_scene(rng, num_cars=3, n_background=2000, x_range=(8.0, 50.0),
               y_range=(-15.0, 15.0), car_points=(80, 200)):
    """Random lidar-frame scene → ``(points [N, 4], gt_boxes [M, 7])``."""
    gt_boxes = _place(rng, num_cars, SIZES["Car"], x_range, y_range)
    pts = [np.stack([
        rng.uniform(0, 69.0, n_background),
        rng.uniform(-39.0, 39.0, n_background),
        rng.normal(-1.75, 0.03, n_background),
        rng.uniform(0, 1, n_background),
    ], axis=1)]
    pts += [_box_points(rng, b, car_points) for b in gt_boxes]
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


def host_pillarize(example: dict, voxel_generator, max_voxels: int,
                   flat: bool = True) -> dict:
    """A raw-cloud example (``points``, ``points_mask``) with the host's
    pillars in place of its cloud, as the KITTI prep's host branch emits
    them (``detect.kitti.preprocess.host_pillars``): the flat view of at
    most ``len(points)`` points with ``flat``, else the padded grid."""
    out = {k: v for k, v in example.items()
           if k not in ("points", "points_mask")}
    points = example["points"]
    out.update(host_pillars(points[example["points_mask"]], voxel_generator,
                            max_voxels, len(points) if flat else None)[0])
    return out


def collate_batch(examples: list) -> dict:
    """Stack ``examples`` along a new batch axis."""
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


def write_kitti(path: str, n_train: int = 8, n_val: int = 4, seed: int = 0,
                num_cars: int = 3, x_range=(8.0, 50.0), y_range=(-15.0, 15.0),
                car_points=(80, 200), classes=("Car",)) -> str:
    """Write a miniature KITTI tree of ``n_train + n_val`` scenes from
    ``RandomState(seed)`` under ``path``; returns the root. Each scene
    holds ``num_cars`` objects of each of ``classes`` (names of
    ``SIZES``), with ``car_points`` points inside each; the objects of a
    class other than Car are drawn after the car scene, so the default
    ``("Car",)`` writes the car trees of the JAX package's writer."""
    unknown = sorted(set(classes) - set(SIZES))
    if unknown:
        raise ValueError(f"no object size for the classes {unknown}")
    rng = np.random.RandomState(seed)
    root = pathlib.Path(path)
    for sub in ("velodyne", "label_2", "calib", "image_2"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
        (root / "testing" / sub).mkdir(parents=True, exist_ok=True)
    P, rect, Tr = default_calib()
    calib_text = _calib_text(P, rect, Tr)
    png = black_png(IMG_W, IMG_H)

    ids = list(range(n_train + n_val))
    for idx in ids:
        stem = f"{idx:06d}"
        points, gt_lidar = make_scene(
            rng, num_cars=num_cars if "Car" in classes else 0,
            x_range=x_range, y_range=y_range, car_points=car_points)
        names = ["Car"] * len(gt_lidar)
        for name in classes:
            if name == "Car":
                continue
            pts, boxes = make_objects(rng, name, num_cars, x_range, y_range,
                                      car_points)
            points = np.concatenate([points, pts])
            gt_lidar = np.concatenate([gt_lidar, boxes])
            names += [name] * len(boxes)
        points.tofile(str(root / "training" / "velodyne" / f"{stem}.bin"))
        (root / "training" / "calib" / f"{stem}.txt").write_text(calib_text)
        (root / "training" / "image_2" / f"{stem}.png").write_bytes(png)
        # labels: the exact inverse of the pipeline's camera -> lidar path
        cam = box_np.box_lidar_to_camera(gt_lidar, rect, Tr)
        corners = box_np.center_to_corner_box3d(
            cam[:, :3], cam[:, 3:6], cam[:, 6], origin=(0.5, 1.0, 0.5),
            axis=1)
        img_pts = box_np.project_to_image(corners, P)
        bbox = np.concatenate([img_pts.min(1), img_pts.max(1)], axis=1)
        bbox[:, [0, 2]] = np.clip(bbox[:, [0, 2]], 0, IMG_W - 1)
        bbox[:, [1, 3]] = np.clip(bbox[:, [1, 3]], 50, IMG_H - 1)
        lines = []
        for i in range(len(cam)):
            l_, h_, w_ = cam[i, 3], cam[i, 4], cam[i, 5]
            lines.append(kitti_result_line({
                "name": names[i],
                "truncated": 0.0,
                "occluded": 0,
                "alpha": 0.0,
                "bbox": bbox[i],
                # label files hold h, w, l (the parser permutes to l, h, w)
                "dimensions": [h_, w_, l_],
                "location": cam[i, :3],
                "rotation_y": cam[i, 6],
            }))
        (root / "training" / "label_2" / f"{stem}.txt").write_text(
            "\n".join(lines) + "\n")

    sets = root / "ImageSets"
    sets.mkdir(exist_ok=True)
    (sets / "train.txt").write_text(
        "\n".join(f"{i:06d}" for i in ids[:n_train]) + "\n")
    (sets / "val.txt").write_text(
        "\n".join(f"{i:06d}" for i in ids[n_train:]) + "\n")
    (sets / "test.txt").write_text("")
    return str(root)
