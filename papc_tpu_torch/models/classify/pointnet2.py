"""PointNet++ SSG classifier (counterpart of
``papc_tpu/models/classify/pointnet2.py::PointNet2SSGClas``).

SA(512, 0.2, 32, [64, 64, 128]) → SA(128, 0.4, 64, [128, 128, 256]) →
SA(group_all, [256, 512, 1024]) → head 1024→512→256→classes with BN, and
in training dropout 0.4 after each hidden head layer.
"""

from __future__ import annotations

import torch
from torch import nn

from papc_tpu_torch.nn import MLPHead, SetAbstraction
from papc_tpu_torch.nn.layers import init_params


class PointNet2SSGClas(nn.Module):
    def __init__(self, num_classes: int = 16, normal_channel: bool = False,
                 npoints: tuple = (512, 128), nsamples: tuple = (32, 64),
                 generator: torch.Generator | None = None):
        """``npoints`` / ``nsamples`` shrink the SA stages for small test
        shapes, as in JAX. ``generator`` seeds flax's initial values
        (``nn.layers.init_params``); without one, torch's own defaults."""
        super().__init__()
        self.normal_channel = normal_channel
        self.num_classes = num_classes
        d0 = 3 if normal_channel else 0
        self.SetAbstraction_0 = SetAbstraction(
            npoints[0], 0.2, nsamples[0], d0, (64, 64, 128))
        self.SetAbstraction_1 = SetAbstraction(
            npoints[1], 0.4, nsamples[1], 128, (128, 128, 256))
        self.SetAbstraction_2 = SetAbstraction(
            None, None, None, 256, (256, 512, 1024), group_all=True)
        self.MLPHead_0 = MLPHead(1024, (512, 256), num_classes, bn=True,
                                dropout_rate=0.4, per_layer_dropout=True)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """``points [B, N, 3(+3)]`` → logits ``[B, num_classes]``.
        ``impl``: ``None`` (kernels on the card, plain on the CPU) or
        ``"plain"``, for every op of the forward and its backward. In
        training the head's dropout draws its masks from ``generator``,
        or takes ``dropout_masks`` (``[B, 512]`` and ``[B, 256]`` keep
        masks) when given."""
        if self.normal_channel:
            xyz, norm = points[..., :3], points[..., 3:]
        else:
            xyz, norm = points, None
        l1_xyz, l1_points = self.SetAbstraction_0(xyz, norm, impl)
        l2_xyz, l2_points = self.SetAbstraction_1(l1_xyz, l1_points, impl)
        _, l3_points = self.SetAbstraction_2(l2_xyz, l2_points, impl)
        return self.MLPHead_0(l3_points.reshape(points.shape[0], 1024),
                              generator=generator, masks=dropout_masks)
