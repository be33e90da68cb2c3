"""PointNet++ classifiers (counterpart of
``papc_tpu/models/classify/pointnet2.py``).

SSG: SA(512, 0.2, 32, [64, 64, 128]) → SA(128, 0.4, 64, [128, 128, 256])
→ SA(group_all, [256, 512, 1024]) → head 1024→512→256→classes with BN,
and in training dropout 0.4 after each hidden head layer.

MSG: two multi-scale SA stages, then SA(group_all), then an inline head
with dropout 0.4 after the first hidden layer and 0.5 after the second.
"""

from __future__ import annotations

import torch
from torch import nn

from papc_tpu_torch.nn import (BatchNorm, MLPHead, SetAbstraction,
                               SetAbstractionMsg)
from papc_tpu_torch.nn.layers import dropout, init_params


class PointNet2SSGClas(nn.Module):
    mode = "clas"

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


class PointNet2MSGClas(nn.Module):
    """The multi-scale classifier at the reference's sizes (no override,
    as in JAX). Its head is inline, so its leaves sit at the top of the
    tree: ``Dense_0``, ``BatchNorm_0``, ``Dense_1``, ``BatchNorm_1``,
    ``Dense_2``."""

    mode = "clas"
    DROPOUT_RATES = (0.4, 0.5)

    def __init__(self, num_classes: int = 16, normal_channel: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.normal_channel = normal_channel
        self.num_classes = num_classes
        d0 = 3 if normal_channel else 0
        self.SetAbstractionMsg_0 = SetAbstractionMsg(
            512, (0.1, 0.2, 0.4), (16, 32, 128), d0,
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
        self.SetAbstractionMsg_1 = SetAbstractionMsg(
            128, (0.2, 0.4, 0.8), (32, 64, 128), 320,
            ((64, 64, 128), (128, 128, 256), (128, 128, 256)))
        self.SetAbstraction_0 = SetAbstraction(
            None, None, None, 640, (256, 512, 1024), group_all=True)
        self.Dense_0 = nn.Linear(1024, 512)
        self.BatchNorm_0 = BatchNorm(512)
        self.Dense_1 = nn.Linear(512, 256)
        self.BatchNorm_1 = BatchNorm(256)
        self.Dense_2 = nn.Linear(256, num_classes)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """As :meth:`PointNet2SSGClas.forward`; in training the two
        dropout sites (rates 0.4 and 0.5) take ``[B, 512]`` and ``[B,
        256]`` keep masks from ``dropout_masks`` or ``generator``."""
        if self.normal_channel:
            xyz, norm = points[..., :3], points[..., 3:]
        else:
            xyz, norm = points, None
        l1_xyz, l1_points = self.SetAbstractionMsg_0(xyz, norm, impl)
        l2_xyz, l2_points = self.SetAbstractionMsg_1(l1_xyz, l1_points, impl)
        _, l3_points = self.SetAbstraction_0(l2_xyz, l2_points, impl)
        x = l3_points.reshape(points.shape[0], 1024)
        masks = list(dropout_masks) if dropout_masks is not None else None
        if self.training and masks is not None and len(masks) != 2:
            raise ValueError(f"{len(masks)} dropout masks for 2 sites")
        for i, rate in enumerate(self.DROPOUT_RATES):
            x = getattr(self, f"Dense_{i}")(x)
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(x))
            if self.training:
                x = dropout(x, rate, None if masks is None else masks[i],
                            generator)
        return self.Dense_2(x)
