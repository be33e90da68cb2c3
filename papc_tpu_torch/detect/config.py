"""The detection config as Python data (counterpart of
``papc_tpu/detect/config.py`` and ``configs/pointpillars_kitti_car.yaml``).

The machine with the card has no PyYAML, so the port carries its own copy
of the keys its serving and training steps read, with the YAML file's
values. The
``Config`` class and :func:`cfg_from_list` behave as the JAX package's:
attribute access, and dotted overrides checked against the existing
value's type.
"""

from __future__ import annotations

import ast
import copy


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


# pointpillars_kitti_car.yaml, the keys the serving and training steps read
_CAR = {
    "VOXEL_GENERATOR": {
        "POINT_CLOUD_RANGE": [0, -39.68, -3, 69.12, 39.68, 1],
        "VOXEL_SIZE": [0.16, 0.16, 4],
        "MAX_NUMBER_OF_POINTS_PER_VOXEL": 100,
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
        "NUM_CLASS": 1,
        "NUM_POINT_FEATURES": 4,
        "ENCODE_RAD_ERROR_BY_SIN": True,
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
    },
    "TRAIN_INPUT_READER": {
        "BATCH_SIZE": 2,
        "MAX_NUMBER_OF_VOXELS": 12000,
        "MAX_POINTS_PER_FRAME": 25000,
    },
    "EVAL_INPUT_READER": {
        "BATCH_SIZE": 2,
        "MAX_NUMBER_OF_VOXELS": 12000,
        "MAX_POINTS_PER_FRAME": 25000,
    },
}


def car_config() -> Config:
    """A fresh copy of the PointPillars KITTI car config."""
    return Config.wrap(copy.deepcopy(_CAR))


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
