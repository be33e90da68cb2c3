"""Config → the serving slice's components (a subset of
``papc_tpu/detect/builders.py``): the voxel grid, the box coder, the
anchor generator and its anchors, the network and the predict config."""

from __future__ import annotations

import numpy as np

from papc_tpu_torch.detect.anchors import AnchorGeneratorStride
from papc_tpu_torch.detect.box_coder import GroundBox3dCoder
from papc_tpu_torch.detect.detector import PredictConfig
from papc_tpu_torch.detect.model import PointPillars


def compute_grid_size(voxel_size, point_cloud_range) -> np.ndarray:
    """[nx, ny, nz] = round((range_max - range_min) / voxel_size)."""
    voxel_size = np.asarray(voxel_size, np.float64)
    pc_range = np.asarray(point_cloud_range, np.float64)
    return np.round((pc_range[3:] - pc_range[:3]) / voxel_size).astype(np.int64)


class VoxelGenerator:
    """The voxel grid of the config (counterpart of
    ``papc_tpu/detect/voxelize_np.py::VoxelGenerator`` without its host
    voxelizer: the port pillarizes on the device, up to the eval reader's
    ``MAX_NUMBER_OF_VOXELS``)."""

    def __init__(self, voxel_size, point_cloud_range, max_num_points: int):
        self.voxel_size = np.asarray(voxel_size, np.float32)
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.max_num_points = max_num_points
        self.grid_size = compute_grid_size(voxel_size, point_cloud_range)


def build_voxel_generator(cfg) -> VoxelGenerator:
    return VoxelGenerator(
        voxel_size=list(cfg.VOXEL_SIZE),
        point_cloud_range=list(cfg.POINT_CLOUD_RANGE),
        max_num_points=int(cfg.MAX_NUMBER_OF_POINTS_PER_VOXEL),
    )


def build_box_coder(cfg) -> GroundBox3dCoder:
    kind = cfg.BOX_CODER_TYPE
    if kind != "ground_box3d_coder":
        raise NotImplementedError(f"box coder {kind!r} is not ported yet")
    return GroundBox3dCoder(
        linear_dim=bool(cfg.get("LINEAR_DIM", False)),
        vec_encode=bool(cfg.get("ENCODE_ANGLE_VECTOR", False)),
    )


def build_anchor_generator(cfg) -> AnchorGeneratorStride:
    if "anchor_generator_stride" not in cfg:
        raise NotImplementedError("only anchor_generator_stride is ported")
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


def build_anchors(cfg, voxel_generator: VoxelGenerator) -> np.ndarray:
    """The anchors of the RPN's output map ``[A, 7]`` f32: the one stride
    generator over the grid halved (``out_size_factor`` 2), as the JAX
    prep builds them (``kitti/preprocess.py``)."""
    generators = cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS
    if len(generators) != 1:
        raise NotImplementedError("one anchor generator (the car config)")
    grid = voxel_generator.grid_size
    feature_map_size = [1, int(grid[1]) // 2, int(grid[0]) // 2]
    anchors = build_anchor_generator(generators[0]).generate(feature_map_size)
    return anchors.reshape(-1, 7)


def build_network(cfg, voxel_generator: VoxelGenerator,
                  anchor_generator: AnchorGeneratorStride,
                  box_coder: GroundBox3dCoder) -> PointPillars:
    grid = voxel_generator.grid_size  # [nx, ny, nz]
    model_cfg = cfg.MODEL
    pfe = model_cfg.PILLAR_FEATURE_EXTRACTOR
    bb = model_cfg.BACKBONE
    if bb.get("use_groupnorm", False):
        raise NotImplementedError("the GroupNorm RPN is not ported")
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
        num_anchor_per_loc=anchor_generator.num_anchors_per_localization,
        encode_background_as_zeros=bool(
            bb.get("encode_background_as_zeros", True)),
        use_direction_classifier=bool(
            bb.get("use_direction_classifier", True)),
        use_norm=bool(bb.get("use_norm", True)),
        box_code_size=box_coder.code_size,
    )


def build_predict_config(cfg, box_coder: GroundBox3dCoder) -> PredictConfig:
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
