"""Config → components (counterpart of ``papc_tpu/detect/builders.py``):
the voxel grid, the box coder, the anchor generator and its anchors, the
similarity calculator and the target assigner, the network, the loss and
predict configs, the learning-rate schedules and the optimizer, the
ground-truth database sampler, the prep function and the KITTI
dataset."""

from __future__ import annotations

import functools
import math
import pathlib
import pickle
from collections.abc import Callable

import numpy as np
import torch

from papc_tpu_torch.detect.anchors import (AnchorGeneratorRange,
                                           AnchorGeneratorStride)
from papc_tpu_torch.detect.box_coder import BevBoxCoder, GroundBox3dCoder
from papc_tpu_torch.detect.detector import LossConfig, PredictConfig
from papc_tpu_torch.detect.kitti.augment import (DataBasePreprocessor,
                                                 DBFilterByDifficulty,
                                                 DBFilterByMinNumPoint)
from papc_tpu_torch.detect.kitti.preprocess import (KittiDataset,
                                                    prep_pointcloud)
from papc_tpu_torch.detect.kitti.sampling import DataBaseSamplerV2
from papc_tpu_torch.detect.model import PointPillars
from papc_tpu_torch.detect.similarity import (DistanceSimilarity,
                                              NearestIouSimilarity,
                                              RotateIouSimilarity)
from papc_tpu_torch.detect.target import TargetAssigner
from papc_tpu_torch.detect.voxelize_np import VoxelGenerator
from papc_tpu_torch.train.optim import RMSProp, ScheduledLR


def build_voxel_generator(cfg) -> VoxelGenerator:
    return VoxelGenerator(
        voxel_size=list(cfg.VOXEL_SIZE),
        point_cloud_range=list(cfg.POINT_CLOUD_RANGE),
        max_num_points=int(cfg.MAX_NUMBER_OF_POINTS_PER_VOXEL),
    )


def build_box_coder(cfg) -> GroundBox3dCoder | BevBoxCoder:
    kind = cfg.BOX_CODER_TYPE
    if kind == "ground_box3d_coder":
        return GroundBox3dCoder(
            linear_dim=bool(cfg.get("LINEAR_DIM", False)),
            vec_encode=bool(cfg.get("ENCODE_ANGLE_VECTOR", False)),
        )
    if kind == "bev_box_coder":
        return BevBoxCoder(
            linear_dim=bool(cfg.get("LINEAR_DIM", False)),
            vec_encode=bool(cfg.get("ENCODE_ANGLE_VECTOR", False)),
            z_fixed=float(cfg.get("Z_FIXED", -1.0)),
            h_fixed=float(cfg.get("H_FIXED", 2.0)),
        )
    raise ValueError(f"unknown box coder {kind}")


def build_similarity_calculator(kind: str):
    if kind == "rotate_iou_similarity":
        return RotateIouSimilarity()
    if kind == "nearest_iou_similarity":
        return NearestIouSimilarity()
    if kind == "distance_similarity":
        return DistanceSimilarity(distance_norm=1.0)
    raise ValueError(f"unknown similarity {kind}")


def build_anchor_generator(cfg) -> AnchorGeneratorStride | AnchorGeneratorRange:
    if "anchor_generator_stride" in cfg:
        c = cfg.anchor_generator_stride
        return AnchorGeneratorStride(
            sizes=list(c.sizes),
            anchor_strides=list(c.strides),
            anchor_offsets=list(c.offsets),
            rotations=list(c.rotations),
            match_threshold=float(c.matched_threshold),
            unmatch_threshold=float(c.unmatched_threshold),
            class_id=c.get("class_name"),
        )
    if "anchor_generator_range" in cfg:
        c = cfg.anchor_generator_range
        return AnchorGeneratorRange(
            anchor_ranges=list(c.anchor_ranges),
            sizes=list(c.sizes),
            rotations=list(c.rotations),
            match_threshold=float(c.matched_threshold),
            unmatch_threshold=float(c.unmatched_threshold),
            class_id=c.get("class_name"),
        )
    raise ValueError("unknown anchor generator config")


def build_target_assigner(cfg, box_coder) -> TargetAssigner:
    generators = [build_anchor_generator(g) for g in cfg.ANCHOR_GENERATORS]
    positive_fraction = float(cfg.SAMPLE_POSITIVE_FRACTION)
    if positive_fraction < 0:
        positive_fraction = None
    return TargetAssigner(
        box_coder=box_coder,
        anchor_generators=generators,
        region_similarity_calculator=build_similarity_calculator(
            cfg.REGION_SIMILARITY_CALCULATOR),
        positive_fraction=positive_fraction,
        sample_size=int(cfg.SAMPLE_SIZE),
    )


def build_anchors(cfg, voxel_generator: VoxelGenerator) -> np.ndarray:
    """The anchors of the RPN's output map ``[A, 7]`` f32: every generator
    over the grid halved (``out_size_factor`` 2), location-major with the
    generators' anchors side by side at each location, as the prep builds
    them (``TargetAssigner.generate_anchors``)."""
    target_assigner = build_target_assigner(
        cfg.TARGET_ASSIGNER, build_box_coder(cfg.BOX_CODER))
    grid = voxel_generator.grid_size
    feature_map_size = [1, int(grid[1]) // 2, int(grid[0]) // 2]
    anchors = target_assigner.generate_anchors(feature_map_size)["anchors"]
    return anchors.reshape(-1, 7)


def build_network(cfg, voxel_generator: VoxelGenerator,
                  target_assigner: TargetAssigner) -> PointPillars:
    """The network of ``cfg``: its heads predict the assigner's anchors a
    location (the sum over its generators) in its box coder's code."""
    grid = voxel_generator.grid_size  # [nx, ny, nz]
    model_cfg = cfg.MODEL
    pfe = model_cfg.PILLAR_FEATURE_EXTRACTOR
    bb = model_cfg.BACKBONE
    return PointPillars(
        ny=int(grid[1]),
        nx=int(grid[0]),
        num_class=int(model_cfg.NUM_CLASS),
        num_input_features=int(model_cfg.NUM_POINT_FEATURES),
        pfn_num_filters=tuple(pfe.num_filters),
        voxel_size=tuple(voxel_generator.voxel_size.tolist()),
        pc_range=tuple(voxel_generator.point_cloud_range.tolist()),
        with_distance=bool(pfe.get("with_distance", False)),
        rpn_layer_nums=tuple(bb.layer_nums),
        rpn_layer_strides=tuple(bb.layer_strides),
        rpn_num_filters=tuple(bb.num_filters),
        rpn_upsample_strides=tuple(bb.upsample_strides),
        rpn_num_upsample_filters=tuple(bb.num_upsample_filters),
        num_anchor_per_loc=target_assigner.num_anchors_per_location,
        encode_background_as_zeros=bool(
            bb.get("encode_background_as_zeros", True)),
        use_direction_classifier=bool(
            bb.get("use_direction_classifier", True)),
        use_norm=bool(bb.get("use_norm", True)),
        use_groupnorm=bool(bb.get("use_groupnorm", False)),
        num_groups=int(bb.get("num_groups", 32)),
        box_code_size=target_assigner.box_coder.code_size,
        max_points_per_pillar=int(voxel_generator.max_num_points),
    )


def build_loss_config(cfg, box_coder) -> LossConfig:
    loss_cfg = cfg.MODEL.LOSS
    cls = loss_cfg.classification_loss.weighted_sigmoid_focal
    loc = loss_cfg.localization_loss.weighted_smooth_l1
    return LossConfig(
        num_class=int(cfg.MODEL.NUM_CLASS),
        encode_background_as_zeros=bool(
            cfg.MODEL.BACKBONE.get("encode_background_as_zeros", True)),
        encode_rad_error_by_sin=bool(
            cfg.MODEL.get("ENCODE_RAD_ERROR_BY_SIN", True)),
        box_code_size=box_coder.code_size,
        pos_cls_weight=float(loss_cfg.pos_class_weight),
        neg_cls_weight=float(loss_cfg.neg_class_weight),
        loss_norm_type=str(loss_cfg.loss_norm_type),
        cls_loss_weight=float(loss_cfg.classification_weight),
        loc_loss_weight=float(loss_cfg.localization_weight),
        direction_loss_weight=float(loss_cfg.direction_loss_weight),
        use_direction_classifier=bool(
            cfg.MODEL.BACKBONE.get("use_direction_classifier", True)),
        focal_alpha=float(cls.alpha),
        focal_gamma=float(cls.gamma),
        smooth_l1_sigma=float(loc.sigma),
        code_weights=tuple(loc.code_weight),
    )


def build_predict_config(cfg, box_coder) -> PredictConfig:
    pp = cfg.MODEL.POST_PROCESSING
    return PredictConfig(
        num_class=int(cfg.MODEL.NUM_CLASS),
        encode_background_as_zeros=bool(
            cfg.MODEL.BACKBONE.get("encode_background_as_zeros", True)),
        use_direction_classifier=bool(
            cfg.MODEL.BACKBONE.get("use_direction_classifier", True)),
        use_rotate_nms=bool(pp.use_rotate_nms),
        multiclass_nms=bool(
            pp.get("multiclass_nms", pp.get("use_multi_class_nms", False))),
        nms_pre_max_size=int(pp.nms_pre_max_size),
        nms_post_max_size=int(pp.nms_post_max_size),
        nms_score_threshold=float(pp.nms_score_threshold),
        nms_iou_threshold=float(pp.nms_iou_threshold),
        box_code_size=box_coder.code_size,
    )


def build_lr_schedule(opt_cfg, base_lr: float) -> Callable[[int], float]:
    """``schedule(count)`` → the rate of the step after ``count`` steps,
    as optax's schedules of the same names compute it (in float64 here,
    in float32 there)."""
    lr_cfg = opt_cfg.learning_rate
    name = lr_cfg.name
    if name == "constant_learning_rate":
        return lambda count: base_lr
    if name == "exponential_decay_learning_rate":
        steps = int(lr_cfg.decay_steps)
        rate = float(lr_cfg.decay_factor)
        staircase = bool(lr_cfg.get("staircase", True))
        if steps <= 0 or rate == 0:
            return lambda count: base_lr

        def exponential(count):
            if count <= 0:
                return base_lr
            p = count // steps if staircase else count / steps
            return base_lr * rate**p

        return exponential
    if name == "exponential_decay_with_burnin":
        # the reference's intent (its own code cannot run): burnin_lr for
        # burnin_steps, then a staircase decay of base_lr
        steps = int(lr_cfg.decay_steps)
        rate = float(lr_cfg.decay_factor)
        burnin_lr = float(lr_cfg.get("burnin_learning_rate", 0.0)) or base_lr
        burnin_steps = int(lr_cfg.get("burnin_steps", 0))
        return lambda count: (burnin_lr if count < burnin_steps
                              else base_lr * rate ** (count // steps))
    if name == "manual_step_learning_rate":
        # optax.piecewise_constant_schedule over the ratios of
        # successive rates, applied from each boundary on
        boundaries = [int(s.step) for s in lr_cfg.schedule]
        values = [base_lr] + [float(s.learning_rate) for s in lr_cfg.schedule]
        scales = sorted((b, values[i + 1] / values[i])
                        for i, b in enumerate(boundaries))

        def manual(count):
            v = values[0]
            for boundary, scale in scales:
                if count >= boundary:
                    v = v * scale
            return v

        return manual
    if name == "cosine_decay_learning_rate":
        # optax.warmup_cosine_decay_schedule to an end value of 0
        init = float(lr_cfg.get("warmup_learning_rate", 0.0))
        warmup = int(lr_cfg.get("warmup_steps", 0))
        decay = int(lr_cfg.total_steps) - warmup
        if decay <= 0:
            raise ValueError(f"cosine decay needs total_steps > "
                             f"warmup_steps, got {decay + warmup}")

        def cosine(count):
            if count < warmup:
                return (init - base_lr) * (1 - count / warmup) + base_lr
            t = min(count - warmup, decay)
            return base_lr * 0.5 * (1 + math.cos(math.pi * t / decay))

        return cosine
    raise ValueError(f"unknown lr schedule {name}")


def build_optimizer(opt_cfg, params) -> tuple[torch.optim.Optimizer,
                                             ScheduledLR]:
    """``(optimizer, scheduler)`` for ``params`` as JAX's optax chain:
    Adam, SGD with momentum (``torch.optim`` computes both as optax does,
    the L2 term ``weight_decay·p`` added to the gradient first) or optax's
    RMSProp (:class:`~papc_tpu_torch.train.optim.RMSProp`); the scheduler
    sets each step's rate. Call ``scheduler.step()`` after each
    ``optimizer.step()``."""
    name = opt_cfg.name
    wd = float(opt_cfg.get("weight_decay", 0.0))
    base_lr = float(opt_cfg.learning_rate.initial_learning_rate)
    schedule = build_lr_schedule(opt_cfg, base_lr)
    if name == "adam_optimizer":
        opt = torch.optim.Adam(params, lr=base_lr, weight_decay=wd)
    elif name == "momentum_optimizer":
        opt = torch.optim.SGD(params, lr=base_lr,
                              momentum=float(opt_cfg.get("momentum", 0.9)),
                              weight_decay=wd)
    elif name == "rms_prop_optimizer":
        opt = RMSProp(params, lr=base_lr,
                      decay=float(opt_cfg.get("decay", 0.9)),
                      momentum=float(opt_cfg.get("momentum", 0.9)),
                      eps=float(opt_cfg.get("epsilon", 1e-10)),
                      weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer {name}")
    return opt, ScheduledLR(opt, schedule)


def build_dbsampler(cfg, root_path, rng=None, log=print) -> DataBaseSamplerV2:
    """The database sampler of a reader's ``DATABASE_SAMPLER`` block over
    ``root_path``'s ``database_info_path``."""
    info_path = pathlib.Path(root_path) / cfg.database_info_path
    with open(info_path, "rb") as f:
        db_infos = pickle.load(f)
    preps = []
    steps = cfg.get("database_prep_steps", {})
    if "filter_by_min_num_points" in steps:
        preps.append(DBFilterByMinNumPoint(
            dict(steps.filter_by_min_num_points.min_num_point_pairs)))
    if "filter_by_difficulty" in steps:
        preps.append(DBFilterByDifficulty(
            list(steps.filter_by_difficulty.removed_difficulties)))
    groups = [dict(g.name_to_max_num) for g in cfg.sample_groups]
    grot_range = cfg.get("global_random_rotation_range_per_object")
    if grot_range is not None:
        grot_range = list(grot_range)
    return DataBaseSamplerV2(
        db_infos, groups,
        db_prepor=DataBasePreprocessor(preps) if preps else None,
        rate=float(cfg.get("rate", 1.0)), global_rot_range=grot_range,
        rng=rng, log=log)


def build_prep_func(cfg, input_reader_cfg, voxel_generator, target_assigner,
                    training: bool, root_path: str, db_sampler=None,
                    rng=None) -> Callable:
    """``prep_pointcloud`` bound to a reader's config values: with
    ``MODEL.DEVICE_PILLARIZE`` false the host pillarizes, into the flat
    view where ``MODEL.PFN_FLAT`` (default true) asks for the flat PFN,
    else into the padded grid."""
    r = input_reader_cfg
    device = bool(cfg.MODEL.get("DEVICE_PILLARIZE", False))
    return functools.partial(
        prep_pointcloud,
        root_path=root_path,
        voxel_generator=voxel_generator,
        target_assigner=target_assigner,
        db_sampler=db_sampler if training else None,
        max_voxels=int(r.MAX_NUMBER_OF_VOXELS),
        class_names=list(r.CLASS_NAMES),
        training=training,
        shuffle_points=bool(r.get("SHUFFLE_POINTS", training)),
        gt_rotation_noise=tuple(
            r.get("GROUNDTRUTH_ROTATION_UNIFORM_NOISE", (-0.157, 0.157))),
        gt_loc_noise_std=tuple(
            r.get("GROUNDTRUTH_LOCALIZATION_NOISE_STD", (0.25,) * 3)),
        global_random_rot_range=tuple(
            r.get("GLOBAL_RANDOM_ROTATION_RANGE_PER_OBJECT", (0.0, 0.0))),
        random_crop=bool(r.get("RANDOM_CROP", False)),
        use_group_id=bool(r.get("USE_GROUP_ID", False)),
        global_rotation_noise=tuple(
            r.get("GLOBAL_ROTATION_UNIFORM_NOISE", (-0.785, 0.785))),
        global_scaling_noise=tuple(
            r.get("GLOBAL_SCALING_UNIFORM_NOISE", (0.95, 1.05))),
        global_loc_noise_std=tuple(
            r.get("GLOBAL_LOC_NOISE_STD", (0.2, 0.2, 0.2))),
        anchor_area_threshold=float(r.get("ANCHOR_AREA_THRESHOLD", 1)),
        remove_points_after_sample=bool(
            r.get("REMOVE_POINTS_AFTER_SAMPLE", True)),
        device_voxelize=device,
        max_points_per_frame=int(r.get("MAX_POINTS_PER_FRAME", 25000)),
        emit_flat_points=bool(cfg.MODEL.get("PFN_FLAT", True)) and not device,
        rng=rng,
    )


def build_dataset(cfg, input_reader_cfg, voxel_generator, target_assigner,
                  training: bool, rng=None, log=print) -> KittiDataset:
    """The KITTI dataset of a reader (``TRAIN_INPUT_READER`` or
    ``EVAL_INPUT_READER``), with the database sampler where a training
    reader names one."""
    root_path = str(input_reader_cfg.KITTI_ROOT_PATH)
    db_sampler = None
    if training and "DATABASE_SAMPLER" in input_reader_cfg:
        db_sampler = build_dbsampler(input_reader_cfg.DATABASE_SAMPLER,
                                     root_path, rng=rng, log=log)
    prep_func = build_prep_func(cfg, input_reader_cfg, voxel_generator,
                                target_assigner, training, root_path,
                                db_sampler, rng)
    grid = voxel_generator.grid_size
    fmap = [1, int(grid[1]) // 2, int(grid[0]) // 2]
    info_path = str(pathlib.Path(root_path) / input_reader_cfg.KITTI_INFO_PATH)
    return KittiDataset(info_path, root_path,
                        int(cfg.MODEL.NUM_POINT_FEATURES), target_assigner,
                        fmap, prep_func,
                        base_seed=int(input_reader_cfg.get("SEED", 0)),
                        db_sampler=db_sampler)
