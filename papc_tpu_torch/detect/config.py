"""The detection configs as Python data and JSON (counterpart of
``papc_tpu/detect/config.py`` and ``configs/pointpillars_kitti_car.yaml``,
``configs/pointpillars_kitti_3class.yaml``).

The machine with the card has no PyYAML, so the port carries both
shipped configs' every key with the YAML files' values
(:func:`car_config`, :func:`kitti_3class_config`), writes a run's config
(``pipeline.config``) as JSON (:func:`save_config`) and reads a config
by its name (``CONFIGS``: ``pointpillars_kitti_car``,
``pointpillars_kitti_3class``) or from a JSON file
(:func:`cfg_from_file`), refusing a ``.yaml`` path. The ``Config`` class and :func:`cfg_from_list` behave as
the JAX package's: attribute access, and dotted overrides checked
against the existing value's type.
"""

from __future__ import annotations

import ast
import copy
import json
from pathlib import Path

class Config(dict):
    """dict with attribute access (EasyDict-alike, recursion-free)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj


# pointpillars_kitti_car.yaml, every key
_CAR = {
    "CLASS_NAMES": ["Car"],
    "VOXEL_GENERATOR": {
        "POINT_CLOUD_RANGE": [0, -39.68, -3, 69.12, 39.68, 1],
        "VOXEL_SIZE": [0.16, 0.16, 4],
        "MAX_NUMBER_OF_POINTS_PER_VOXEL": 100,
        "MAX_VOXELS": 12000,
    },
    "BOX_CODER": {
        "BOX_CODER_TYPE": "ground_box3d_coder",
        "LINEAR_DIM": False,
        "ENCODE_ANGLE_VECTOR": False,
    },
    "TARGET_ASSIGNER": {
        "ANCHOR_GENERATORS": [{
            "anchor_generator_stride": {
                "sizes": [1.6, 3.9, 1.56],
                "strides": [0.32, 0.32, 0.0],
                "offsets": [0.16, -39.52, -1.78],
                "rotations": [0, 1.57],
                "matched_threshold": 0.6,
                "unmatched_threshold": 0.45,
                "class_name": "Car",
            },
        }],
        "SAMPLE_POSITIVE_FRACTION": -1,
        "SAMPLE_SIZE": 512,
        "REGION_SIMILARITY_CALCULATOR": "nearest_iou_similarity",
    },
    "MODEL": {
        "NAME": "PointPillars",
        "NUM_CLASS": 1,
        "NUM_POINT_FEATURES": 4,
        "ENCODE_RAD_ERROR_BY_SIN": True,
        "DEVICE_PILLARIZE": True,
        "PILLAR_FEATURE_EXTRACTOR": {
            "num_filters": [64],
            "with_distance": False,
            "use_norm": True,
        },
        "BACKBONE": {
            "layer_nums": [3, 5, 5],
            "layer_strides": [2, 2, 2],
            "num_filters": [64, 128, 256],
            "upsample_strides": [1, 2, 4],
            "num_upsample_filters": [128, 128, 128],
            "use_direction_classifier": True,
            "use_norm": True,
            "encode_background_as_zeros": True,
        },
        "POST_PROCESSING": {
            "use_rotate_nms": True,
            "multiclass_nms": False,
            "nms_pre_max_size": 1000,
            "nms_post_max_size": 300,
            "nms_score_threshold": 0.15,
            "nms_iou_threshold": 0.5,
            "post_center_limit_range": [0, -39.68, -5, 69.12, 39.68, 5],
        },
        "LOSS": {
            "pos_class_weight": 1.0,
            "neg_class_weight": 1.0,
            "direction_loss_weight": 2.0,
            "loss_norm_type": "NormByNumPositives",
            "classification_loss": {
                "weighted_sigmoid_focal": {"alpha": 0.25, "gamma": 2.0},
            },
            "localization_loss": {
                "weighted_smooth_l1": {
                    "sigma": 3.0,
                    "code_weight": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                },
            },
            "classification_weight": 1.0,
            "localization_weight": 2.0,
        },
    },
    "TRAIN_CONFIG": {
        "OPTIMIZER": {
            "name": "adam_optimizer",
            "learning_rate": {
                "name": "exponential_decay_learning_rate",
                "initial_learning_rate": 0.0002,
                "decay_steps": 27840,
                "decay_factor": 0.8,
                "staircase": True,
            },
            "weight_decay": 0.0001,
        },
        "STEPS": 296960,  # 1856 steps an epoch x 160 epochs
        "STEPS_PER_EVAL": 9280,
        "SAVE_CHECKPOINTS_SECS": 1800,
        "SCAN_STEPS": 0,  # > 1 raises (ROADMAP.md, Queue 1 item 4)
        "PRECISION": "fp32",
        "SAVE_SUMMARY_STEPS": 10,
    },
    "TRAIN_INPUT_READER": {
        "CLASS_NAMES": ["Car"],
        "BATCH_SIZE": 2,
        "MAX_NUMBER_OF_VOXELS": 12000,
        "MAX_POINTS_PER_FRAME": 25000,
        "NUM_WORKERS": 0,
        "SHUFFLE_POINTS": True,
        "GROUNDTRUTH_LOCALIZATION_NOISE_STD": [0.25, 0.25, 0.25],
        "GROUNDTRUTH_ROTATION_UNIFORM_NOISE": [-0.15707963267,
                                               0.15707963267],
        "GLOBAL_ROTATION_UNIFORM_NOISE": [-0.78539816, 0.78539816],
        "GLOBAL_SCALING_UNIFORM_NOISE": [0.95, 1.05],
        "GLOBAL_LOC_NOISE_STD": [0.2, 0.2, 0.2],
        "GLOBAL_RANDOM_ROTATION_RANGE_PER_OBJECT": [0, 0],
        "RANDOM_CROP": False,
        "USE_GROUP_ID": False,
        "ANCHOR_AREA_THRESHOLD": 1,
        "REMOVE_POINTS_AFTER_SAMPLE": False,
        "DATABASE_SAMPLER": {
            "database_info_path": "kitti_dbinfos_train.pkl",
            "sample_groups": [{"name_to_max_num": {"Car": 15}}],
            "database_prep_steps": {
                "filter_by_min_num_points": {
                    "min_num_point_pairs": {"Car": 5},
                },
                "filter_by_difficulty": {"removed_difficulties": [-1]},
            },
            "rate": 1.0,
            "global_random_rotation_range_per_object": [0, 0],
        },
        "KITTI_INFO_PATH": "kitti_infos_train.pkl",
        "KITTI_ROOT_PATH": ".",
    },
    "EVAL_INPUT_READER": {
        "CLASS_NAMES": ["Car"],
        "BATCH_SIZE": 2,
        "MAX_NUMBER_OF_VOXELS": 12000,
        "MAX_POINTS_PER_FRAME": 25000,
        "NUM_WORKERS": 0,
        "SHUFFLE_POINTS": False,
        "ANCHOR_AREA_THRESHOLD": 1,
        "KITTI_INFO_PATH": "kitti_infos_val.pkl",
        "KITTI_ROOT_PATH": ".",
    },
}



def _three_class() -> dict:
    """pointpillars_kitti_3class.yaml, every key: the car config with a
    Pedestrian and a Cyclist anchor generator after the car's, three
    classes in every reader, per-class NMS, and a sample group and a
    point-count filter for each new class."""
    cfg = copy.deepcopy(_CAR)
    names = ["Car", "Pedestrian", "Cyclist"]
    cfg["CLASS_NAMES"] = list(names)
    for name, length in (("Pedestrian", 0.8), ("Cyclist", 1.76)):
        cfg["TARGET_ASSIGNER"]["ANCHOR_GENERATORS"].append({
            "anchor_generator_stride": {
                "sizes": [0.6, length, 1.73],
                "strides": [0.32, 0.32, 0.0],
                "offsets": [0.16, -39.52, -1.465],
                "rotations": [0, 1.57],
                "matched_threshold": 0.5,
                "unmatched_threshold": 0.35,
                "class_name": name,
            },
        })
    cfg["MODEL"]["NUM_CLASS"] = 3
    cfg["MODEL"]["POST_PROCESSING"]["multiclass_nms"] = True
    for reader in ("TRAIN_INPUT_READER", "EVAL_INPUT_READER"):
        cfg[reader]["CLASS_NAMES"] = list(names)
    sampler = cfg["TRAIN_INPUT_READER"]["DATABASE_SAMPLER"]
    sampler["sample_groups"] += [{"name_to_max_num": {"Pedestrian": 8}},
                                 {"name_to_max_num": {"Cyclist": 8}}]
    sampler["database_prep_steps"]["filter_by_min_num_points"][
        "min_num_point_pairs"] = {"Car": 5, "Pedestrian": 5, "Cyclist": 5}
    return cfg


_THREE_CLASS = _three_class()


def car_config() -> Config:
    """A fresh copy of the PointPillars KITTI car config."""
    return Config.wrap(copy.deepcopy(_CAR))


def kitti_3class_config() -> Config:
    """A fresh copy of the PointPillars KITTI 3-class config (Car,
    Pedestrian, Cyclist)."""
    return Config.wrap(copy.deepcopy(_THREE_CLASS))


# the shipped configs by name, as ``cfg_from_file`` and the CLI take them
CONFIGS = {"pointpillars_kitti_car": car_config,
           "pointpillars_kitti_3class": kitti_3class_config}


def cfg_from_list(cfg: dict, cfg_list: list) -> None:
    """Apply ``["A.B.C", value, ...]`` dotted overrides in place with
    type coercion against the existing value."""
    if len(cfg_list) % 2:
        raise ValueError("override list must be key/value pairs")
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        d = cfg
        keys = full_key.split(".")
        for sub in keys[:-1]:
            if sub not in d:
                raise KeyError(f"unknown config key: {full_key}")
            d = d[sub]
        last = keys[-1]
        if last not in d:
            raise KeyError(f"unknown config key: {full_key}")
        try:
            value = ast.literal_eval(v) if isinstance(v, str) else v
        except (ValueError, SyntaxError):
            value = v
        old = d[last]
        if old is not None and value is not None and not (
            isinstance(value, type(old))
            or (isinstance(value, (int, float))
                and isinstance(old, (int, float)))
        ):
            raise TypeError(f"type mismatch for {full_key}: "
                            f"{type(value)} vs {type(old)}")
        d[last] = Config.wrap(value)


def save_config(cfg: dict, path: str) -> None:
    """Write ``cfg`` as JSON (the run's ``pipeline.config``)."""
    Path(path).write_text(json.dumps(cfg, indent=2) + "\n")


def cfg_from_file(cfg_file: str | None) -> Config:
    """A shipped config by its name (a key of ``CONFIGS``), the config of
    a JSON file (``save_config``'s format), or the car config when
    ``cfg_file`` is None. A YAML file raises: the port reads no YAML (the
    card's machine has no PyYAML); name a shipped config or write the
    config as JSON (``save_config``) instead."""
    if cfg_file is None:
        return car_config()
    if str(cfg_file) in CONFIGS:
        return CONFIGS[str(cfg_file)]()
    if str(cfg_file).lower().endswith((".yaml", ".yml")):
        raise ValueError(
            f"{cfg_file}: the port reads configs as JSON, not YAML (the "
            "card's machine has no PyYAML); name a shipped config "
            f"({', '.join(CONFIGS)}) or convert it, e.g. with "
            "save_config(cfg, path) from a loaded config")
    with open(cfg_file) as f:
        return Config.wrap(json.load(f))
