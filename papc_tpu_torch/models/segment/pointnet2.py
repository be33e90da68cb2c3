"""PointNet++ part segmentation, SSG and MSG (counterpart of
``papc_tpu/models/segment/pointnet2.py``).

An encoder of three set abstractions, three feature propagations back to
the input points, the object class's one-hot tiled over the points and
concatenated as ``[one_hot, xyz, points]`` at the last one, and the head
Dense(128)→BN→ReLU→Dropout(0.5)→Dense(num_parts) (``_SegHead2_0``).
"""

from __future__ import annotations

import torch
from torch import nn

from papc_tpu_torch.nn import (FeaturePropagation, MLPHead, SetAbstraction,
                               SetAbstractionMsg)
from papc_tpu_torch.nn.layers import init_params


class _PointNet2Seg(nn.Module):
    """The decoder and head both variants share. A subclass builds its
    encoder, ``encode(xyz, points, impl)`` → the three levels'
    ``(xyz, points)``, and calls :meth:`_build_decoder`."""

    mode = "seg"
    input_kind = "points"

    def __init__(self, num_classes: int, num_parts: int,
                 normal_channel: bool):
        super().__init__()
        self.num_classes = num_classes
        self.num_parts = num_parts
        self.normal_channel = normal_channel
        self.d0 = 6 if normal_channel else 3  # the input points are features

    def _build_decoder(self, widths, last_mlp, generator) -> None:
        """``widths`` = channels of the level-1, level-2 and level-3
        features."""
        c1, c2, c3 = widths
        self.FeaturePropagation_0 = FeaturePropagation(c2 + c3, (256, 256))
        self.FeaturePropagation_1 = FeaturePropagation(c1 + 256, (256, 128))
        self.FeaturePropagation_2 = FeaturePropagation(
            self.num_classes + 3 + self.d0 + 128, last_mlp)
        self._SegHead2_0 = MLPHead(last_mlp[-1], (128,), self.num_parts,
                                   bn=True, dropout_rate=0.5)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, cls_label: torch.Tensor,
                impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """``points [B, N, 3(+3)]``, ``cls_label [B]`` int → per-point
        logits ``[B, N, num_parts]``. ``impl`` as for the classifiers; in
        training the head's one dropout site takes a ``[B, N, 128]`` keep
        mask from ``dropout_masks`` or ``generator``."""
        B, N, _ = points.shape
        l0_xyz = points[..., :3] if self.normal_channel else points
        l0_points = points
        (l1_xyz, l1_points), (l2_xyz, l2_points), (l3_xyz, l3_points) = \
            self.encode(l0_xyz, l0_points, impl)
        l2_points = self.FeaturePropagation_0(l2_xyz, l3_xyz, l2_points,
                                              l3_points, impl)
        l1_points = self.FeaturePropagation_1(l1_xyz, l2_xyz, l1_points,
                                              l2_points, impl)
        one_hot = nn.functional.one_hot(cls_label.reshape(B).long(),
                                        self.num_classes).to(points.dtype)
        one_hot = one_hot[:, None, :].expand(B, N, self.num_classes)
        l0_in = torch.cat([one_hot, l0_xyz, l0_points], dim=-1)
        l0_points = self.FeaturePropagation_2(l0_xyz, l1_xyz, l0_in,
                                              l1_points, impl)
        return self._SegHead2_0(l0_points, generator=generator,
                                masks=dropout_masks)


class PointNet2SSGSeg(_PointNet2Seg):
    def __init__(self, num_classes: int = 16, num_parts: int = 50,
                 normal_channel: bool = False, npoints: tuple = (512, 128),
                 nsamples: tuple = (32, 64),
                 generator: torch.Generator | None = None):
        """``npoints`` / ``nsamples`` shrink the SA stages for small test
        shapes, as in JAX."""
        super().__init__(num_classes, num_parts, normal_channel)
        self.SetAbstraction_0 = SetAbstraction(
            npoints[0], 0.2, nsamples[0], self.d0, (64, 64, 128))
        self.SetAbstraction_1 = SetAbstraction(
            npoints[1], 0.4, nsamples[1], 128, (128, 128, 256))
        self.SetAbstraction_2 = SetAbstraction(
            None, None, None, 256, (256, 512, 1024), group_all=True)
        self._build_decoder((128, 256, 1024), (128, 128, 128), generator)

    def encode(self, xyz, points, impl):
        l1 = self.SetAbstraction_0(xyz, points, impl)
        l2 = self.SetAbstraction_1(*l1, impl)
        return l1, l2, self.SetAbstraction_2(*l2, impl)


class PointNet2MSGSeg(_PointNet2Seg):
    """At the reference's sizes (no override, as in JAX). SA2's second
    branch is 128-196-256: a width that is not a multiple of 16."""

    def __init__(self, num_classes: int = 16, num_parts: int = 50,
                 normal_channel: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(num_classes, num_parts, normal_channel)
        self.SetAbstractionMsg_0 = SetAbstractionMsg(
            512, (0.1, 0.2, 0.4), (32, 64, 128), self.d0,
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
        self.SetAbstractionMsg_1 = SetAbstractionMsg(
            128, (0.4, 0.8), (64, 128), 320,
            ((128, 128, 256), (128, 196, 256)))
        self.SetAbstraction_0 = SetAbstraction(
            None, None, None, 512, (256, 512, 1024), group_all=True)
        self._build_decoder((320, 512, 1024), (128, 128), generator)

    def encode(self, xyz, points, impl):
        l1 = self.SetAbstractionMsg_0(xyz, points, impl)
        l2 = self.SetAbstractionMsg_1(*l1, impl)
        return l1, l2, self.SetAbstraction_0(*l2, impl)
