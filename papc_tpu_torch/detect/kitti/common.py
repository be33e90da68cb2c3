"""KITTI I/O: paths, calib, label parsing and annotation utilities
(counterpart of ``papc_tpu/detect/kitti/common.py``).

The info-dict schema (``image_idx``, ``velodyne_path``, ``img_path``,
``img_shape``, ``calib/P0..P3``, ``calib/R0_rect``,
``calib/Tr_velo_to_cam``, ``annos``), the label format, the difficulty
rules and the result-line format are the JAX package's, so the files
either package writes read in the other. One declarative column table
(:data:`_LABEL_FIELDS`) drives the parser, the result-line formatter and
the empty annotations. The image shape is read from the PNG's IHDR chunk
with the standard library (the card's machine has no PIL).
"""

from __future__ import annotations

import concurrent.futures as futures
import pathlib
import re
import struct
from dataclasses import dataclass

import numpy as np


def get_image_index_str(img_idx: int) -> str:
    return f"{img_idx:06d}"


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_size(path) -> tuple[int, int]:
    """``(width, height)`` of a PNG file, from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG file: {path}")
    return struct.unpack(">II", head[16:24])


def _info_path(idx, prefix, info_type, suffix, training, relative_path,
               exist_check=True):
    img_idx_str = get_image_index_str(idx) + suffix
    prefix = pathlib.Path(prefix)
    split = "training" if training else "testing"
    file_path = pathlib.Path(split) / info_type / img_idx_str
    if exist_check and not (prefix / file_path).exists():
        raise ValueError(f"file not exist: {file_path}")
    return str(file_path) if relative_path else str(prefix / file_path)


def get_image_path(idx, prefix, training=True, relative_path=True,
                   exist_check=True):
    return _info_path(idx, prefix, "image_2", ".png", training,
                      relative_path, exist_check)


def get_label_path(idx, prefix, training=True, relative_path=True,
                   exist_check=True):
    return _info_path(idx, prefix, "label_2", ".txt", training,
                      relative_path, exist_check)


def get_velodyne_path(idx, prefix, training=True, relative_path=True,
                      exist_check=True):
    return _info_path(idx, prefix, "velodyne", ".bin", training,
                      relative_path, exist_check)


def get_calib_path(idx, prefix, training=True, relative_path=True,
                   exist_check=True):
    return _info_path(idx, prefix, "calib", ".txt", training,
                      relative_path, exist_check)


# ------------------------------------------------------------- calib I/O

# (key, line number, value count, matrix shape); every matrix optionally
# homogenized to 4x4 by `extend_matrix`
_CALIB_ROWS = (
    ("calib/P0", 0, (3, 4)),
    ("calib/P1", 1, (3, 4)),
    ("calib/P2", 2, (3, 4)),
    ("calib/P3", 3, (3, 4)),
    ("calib/R0_rect", 4, (3, 3)),
    ("calib/Tr_velo_to_cam", 5, (3, 4)),
    ("calib/Tr_imu_to_velo", 6, (3, 4)),
)


def _homogenize(mat: np.ndarray) -> np.ndarray:
    """Embed a 3x4 (bottom row) or 3x3 (4x4 eye corner) matrix."""
    if mat.shape == (3, 4):
        return np.concatenate(
            [mat, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0
        )
    out = np.zeros((4, 4), mat.dtype)
    out[3, 3] = 1.0
    out[:3, :3] = mat
    return out


def read_calib(calib_path, extend_matrix=True):
    """Parse a KITTI calib file into the info-dict calib entries."""
    with open(calib_path) as f:
        lines = f.readlines()
    out = {}
    for key, lineno, shape in _CALIB_ROWS:
        n = shape[0] * shape[1]
        mat = np.array(
            [float(v) for v in lines[lineno].split(" ")[1:n + 1]]
        ).reshape(shape)
        out[key] = _homogenize(mat) if extend_matrix else mat
    return out


# ---------------------------------------------------- object-label schema


@dataclass(frozen=True)
class _Field:
    """One column group of a KITTI object-label / result line."""

    key: str
    width: int  # whitespace-separated columns it occupies
    kind: str  # 'str' | 'int' | 'float'
    default: object  # result-line value when absent; None = required


_LABEL_FIELDS = (
    _Field("name", 1, "str", None),
    _Field("truncated", 1, "float", -1),
    _Field("occluded", 1, "int", -1),
    _Field("alpha", 1, "float", -10),
    _Field("bbox", 4, "float", None),
    _Field("dimensions", 3, "float", [-1, -1, -1]),
    _Field("location", 3, "float", [-1000, -1000, -1000]),
    _Field("rotation_y", 1, "float", -10),
    _Field("score", 1, "float", 0.0),
)
_N_LABEL_COLS = sum(f.width for f in _LABEL_FIELDS)  # 16 with score


def get_label_anno(label_path):
    """Parse one KITTI label file via the field table. ``dimensions``
    are converted hwl → lhw(camera); ``score`` defaults to zeros when
    the 16th column is absent (ground-truth files)."""
    with open(label_path) as f:
        rows = [line.strip().split(" ") for line in f.readlines()]
    n = len(rows)
    has_score = n != 0 and len(rows[0]) == _N_LABEL_COLS
    # one float matrix of every numeric column, sliced per field below
    ncols = _N_LABEL_COLS - 1 if has_score else _N_LABEL_COLS - 2
    vals = np.array(
        [[float(v) for v in r[1:1 + ncols]] for r in rows], np.float64
    ).reshape(n, ncols)
    anno = {}
    col = 0
    for fld in _LABEL_FIELDS:
        if fld.kind == "str":
            anno[fld.key] = np.array([r[0] for r in rows])
            continue
        if fld.key == "score" and not has_score:
            anno["score"] = np.zeros((n,))
            continue
        block = vals[:, col:col + fld.width]
        col += fld.width
        if fld.kind == "int":
            anno[fld.key] = block[:, 0].astype(np.int64)
        elif fld.width == 1:
            anno[fld.key] = block[:, 0]
        else:
            anno[fld.key] = block
    # camera-frame convention: stored h,w,l → l,h,w
    anno["dimensions"] = anno["dimensions"][:, [2, 0, 1]]
    # objects index within the frame; DontCare rows (always trailing in
    # KITTI files) get -1
    num_objects = int(np.sum(anno["name"] != "DontCare"))
    anno["index"] = np.concatenate([
        np.arange(num_objects, dtype=np.int32),
        np.full(n - num_objects, -1, np.int32),
    ])
    anno["group_ids"] = np.arange(n, dtype=np.int32)
    return anno


def get_label_annos(label_folder, image_ids=None):
    if image_ids is None:
        prog = re.compile(r"^\d{6}.txt$")
        paths = filter(
            lambda f: prog.match(f.name),
            pathlib.Path(label_folder).glob("*.txt"),
        )
        image_ids = sorted(int(p.stem) for p in paths)
    if not isinstance(image_ids, list):
        image_ids = list(range(image_ids))
    annos = []
    folder = pathlib.Path(label_folder)
    for idx in image_ids:
        anno = get_label_anno(folder / (get_image_index_str(idx) + ".txt"))
        n = anno["name"].shape[0]
        anno["image_idx"] = np.array([idx] * n, dtype=np.int64)
        annos.append(anno)
    return annos


def kitti_result_line(result_dict, precision=4):
    """Format one detection as a KITTI result-file line, driven by the
    same field table as the parser. Scalar float fields fall back to
    ``str(default)`` when absent (matching the official tooling);
    vector fields format their defaults at full precision."""
    known = {f.key for f in _LABEL_FIELDS}
    for key in result_dict:
        if key not in known:
            raise KeyError(key)
    parts = []
    for fld in _LABEL_FIELDS:
        val = result_dict.get(fld.key)
        if val is None and fld.default is None:
            raise ValueError(f"you must specify a value for {fld.key}")
        if fld.kind == "str":
            parts.append(val)
        elif fld.kind == "int":
            parts.append(f"{val}" if val is not None else str(fld.default))
        elif fld.width == 1:
            parts.append(
                f"{val:.{precision}f}" if val is not None
                else str(fld.default)
            )
        else:
            vec = val if val is not None else fld.default
            parts += [f"{v:.{precision}f}" for v in vec]
    return " ".join(parts)


def empty_result_anno():
    return {
        fld.key: np.zeros([0, fld.width]) if fld.width > 1
        else np.array([])
        for fld in _LABEL_FIELDS
    }


def get_start_result_anno():
    return {fld.key: [] for fld in _LABEL_FIELDS}


# ------------------------------------------------------------- info dicts


def get_kitti_image_info(
    path,
    training=True,
    label_info=True,
    velodyne=False,
    calib=False,
    image_ids=7481,
    extend_matrix=True,
    num_worker=8,
    relative_path=True,
    with_imageshape=True,
):
    """Build the per-frame info dicts (reference schema, :124-230)."""
    root_path = pathlib.Path(path)
    if not isinstance(image_ids, list):
        image_ids = list(range(image_ids))

    def map_func(idx):
        info = {"image_idx": idx, "pointcloud_num_features": 4}
        if velodyne:
            info["velodyne_path"] = get_velodyne_path(
                idx, path, training, relative_path
            )
        info["img_path"] = get_image_path(idx, path, training, relative_path)
        if with_imageshape:
            img_path = info["img_path"]
            if relative_path:
                img_path = str(root_path / img_path)
            w, h = png_size(img_path)
            info["img_shape"] = np.array([h, w], dtype=np.int32)
        if label_info:
            label_path = get_label_path(idx, path, training, relative_path)
            if relative_path:
                label_path = str(root_path / label_path)
            info["annos"] = get_label_anno(label_path)
            add_difficulty_to_annos(info)
        if calib:
            info.update(
                read_calib(
                    get_calib_path(idx, path, training, relative_path=False),
                    extend_matrix,
                )
            )
        return info

    with futures.ThreadPoolExecutor(num_worker) as executor:
        return list(executor.map(map_func, image_ids))


# official difficulty thresholds, indexed easy/moderate/hard
_MIN_HEIGHT = np.array([40.0, 25.0, 25.0])
_MAX_OCCLUSION = np.array([0, 1, 2])
_MAX_TRUNCATION = np.array([0.15, 0.3, 0.5])


def add_difficulty_to_annos(info):
    """Vectorized official difficulty assignment: a box passes tier t
    when height/occlusion/truncation are all within tier-t bounds; the
    label is the easiest passing tier, -1 when even 'hard' fails."""
    annos = info["annos"]
    bbox = annos["bbox"]
    height = (bbox[:, 3] - bbox[:, 1])[:, None]  # [n, 1]
    occ = np.asarray(annos["occluded"], np.float64)[:, None]
    trunc = np.asarray(annos["truncated"], np.float64)[:, None]
    passes = (  # [n, 3] per-tier pass mask
        (occ <= _MAX_OCCLUSION[None, :])
        & (height > _MIN_HEIGHT[None, :])
        & (trunc <= _MAX_TRUNCATION[None, :])
    )
    easy, moderate, hard = passes.T
    diff = np.full(len(height), -1, np.int32)
    diff[np.logical_xor(hard, moderate)] = 2
    diff[np.logical_xor(easy, moderate)] = 1
    diff[easy] = 0
    annos["difficulty"] = diff
    return diff


def filter_kitti_anno(
    image_anno, used_classes, used_difficulty=None, dontcare_iou=None
):
    if not isinstance(used_classes, (list, tuple)):
        used_classes = [used_classes]
    keep = [
        i for i, x in enumerate(image_anno["name"]) if x in used_classes
    ]
    img_filtered = {
        key: image_anno[key][keep] for key in image_anno.keys()
    }
    if used_difficulty is not None:
        keep = [
            i
            for i, x in enumerate(img_filtered["difficulty"])
            if x in used_difficulty
        ]
        img_filtered = {
            key: img_filtered[key][keep] for key in img_filtered.keys()
        }
    return img_filtered


def filter_annos_low_score(image_annos, thresh):
    new = []
    for anno in image_annos:
        keep = np.where(anno["score"] >= thresh)[0]
        new.append({key: anno[key][keep] for key in anno.keys()})
    return new


def anno_to_rbboxes(anno):
    return np.concatenate(
        [
            anno["location"],
            anno["dimensions"],
            anno["rotation_y"][..., None],
        ],
        axis=1,
    )
