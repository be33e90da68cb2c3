"""Anchor generators by stride and by range (counterpart of
``papc_tpu/detect/anchors.py``)."""

from __future__ import annotations

import numpy as np

from papc_tpu_torch.detect import box_np


class AnchorGeneratorStride:
    def __init__(
        self,
        sizes=(1.6, 3.9, 1.56),
        anchor_strides=(0.4, 0.4, 1.0),
        anchor_offsets=(0.2, -39.8, -1.78),
        rotations=(0, np.pi / 2),
        match_threshold: float = -1,
        unmatch_threshold: float = -1,
        class_id=None,
        dtype=np.float32,
    ):
        self._sizes = sizes
        self._anchor_strides = anchor_strides
        self._anchor_offsets = anchor_offsets
        self._rotations = rotations
        self._dtype = dtype
        self._class_id = class_id
        self.match_threshold = match_threshold
        self.unmatch_threshold = unmatch_threshold

    @property
    def class_id(self):
        return self._class_id

    @property
    def num_anchors_per_localization(self) -> int:
        num_rot = len(self._rotations)
        num_size = np.reshape(self._sizes, [-1, 3]).shape[0]
        return num_rot * num_size

    def generate(self, feature_map_size):
        return box_np.create_anchors_3d_stride(
            feature_map_size, self._sizes, self._anchor_strides,
            self._anchor_offsets, self._rotations, self._dtype)


class AnchorGeneratorRange:
    def __init__(
        self,
        anchor_ranges,
        sizes=(1.6, 3.9, 1.56),
        rotations=(0, np.pi / 2),
        match_threshold: float = -1,
        unmatch_threshold: float = -1,
        class_id=None,
        dtype=np.float32,
    ):
        self._sizes = sizes
        self._anchor_ranges = anchor_ranges
        self._rotations = rotations
        self._dtype = dtype
        self._class_id = class_id
        self.match_threshold = match_threshold
        self.unmatch_threshold = unmatch_threshold

    @property
    def class_id(self):
        return self._class_id

    @property
    def num_anchors_per_localization(self) -> int:
        num_rot = len(self._rotations)
        num_size = np.reshape(self._sizes, [-1, 3]).shape[0]
        return num_rot * num_size

    def generate(self, feature_map_size):
        return box_np.create_anchors_3d_range(
            feature_map_size, self._anchor_ranges, self._sizes,
            self._rotations, self._dtype)
