"""PointPillars network (counterpart of ``papc_tpu/detect/model.py``).

The port runs the reference form of the network: the classic
``PillarFeatureNet`` over the padded pillar grid or, on a batch of flat
points (the host pillarizer's), the same module's flat path
(``detect/pfn_fast.py``; the same parameters, so one state dict serves
both), the flat-row BEV scatter, and the ``RPN``'s classic branch (stride-2 and
SAME 3×3 convs, then per stage a ConvTranspose, BatchNorm and ReLU, the
concat, and one 1×1 head). The JAX package's other TPU rewrites
(``scatter_s2d``, ``rpn_deferred_upsample``, ``rpn_batch_fold``) are
exact and keep the same parameter tree, so the same weights serve both.

Module names follow the flax tree (``pfn.PFNLayer_0.Dense_0``,
``rpn._ConvBlock_0.Conv_0``, ``rpn.ConvTranspose_0``, ``rpn.BatchNorm_0``
or, with ``use_groupnorm``, ``rpn.GroupNorm_0``, ``rpn.Conv_0`` ...), so :mod:`papc_tpu_torch.convert` maps each flax leaf
onto one tensor. The public layout is channel-last, as in JAX; the
convolutions run in PyTorch's NCHW. ``train()`` / ``eval()`` select the
mode, as flax's ``train`` argument does. Every BatchNorm has the
detector's epsilon 1e-3 and flax momentum 0.01 (``PFN_BN``): in training
it takes batch statistics, the PFN's over every ``[B, V, P]`` slot,
padded points and pillars included, as JAX's does, and updates the
running ones; in eval it uses the running ones. In training each
convolution runs in float32 forward and backward
(:func:`papc_tpu_torch.nn.layers.f32_cudnn`); in eval it runs under the
caller's cuDNN flags (``make_predict_step`` sets float32). Under bf16
parameters and inputs (the bf16 steps) every layer computes in bf16,
BatchNorm's statistics and running ones in f32 (flax's
``BatchNorm(dtype=x.dtype)``: JAX's ``BN_DTYPE_FOLLOWS_INPUT``).
``nn.layers.init_params`` gives the network seeded weights.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from papc_tpu_torch.detect.pfn_fast import pfn_forward_flat
from papc_tpu_torch.nn.layers import BatchNorm, conv
from papc_tpu_torch.ops.voxelize import scatter_to_bev_batched

# model.py PFN_BN: every BatchNorm of the detector, momentum in flax's
# sense (running = 0.01·running + 0.99·batch)
PFN_BN_EPS = 1e-3
PFN_BN_MOMENTUM = 0.01


def _norm(features: int) -> BatchNorm:
    return BatchNorm(features, eps=PFN_BN_EPS, momentum=PFN_BN_MOMENTUM)


class _RPNNorm:
    """The RPN's normalization after each convolution, as the JAX RPN's
    ``bn``: flax's GroupNorm with ``use_groupnorm`` (``min(num_groups,
    C)`` groups and flax's epsilon 1e-3, where ``nn.GroupNorm`` defaults
    to 1e-5), else BatchNorm with ``use_norm``, else none. Modules carry
    the flax names ``GroupNorm_i`` / ``BatchNorm_i``."""

    def __init__(self, use_norm: bool, use_groupnorm: bool, num_groups: int):
        self.kind = ("GroupNorm" if use_groupnorm
                     else "BatchNorm" if use_norm else None)
        self.num_groups = num_groups

    def add(self, owner: nn.Module, i: int, features: int) -> None:
        if self.kind == "GroupNorm":
            owner.add_module(f"GroupNorm_{i}", nn.GroupNorm(
                min(self.num_groups, features), features, eps=PFN_BN_EPS))
        elif self.kind == "BatchNorm":
            owner.add_module(f"BatchNorm_{i}", _norm(features))

    def __call__(self, owner: nn.Module, i: int,
                 x: torch.Tensor) -> torch.Tensor:
        """``owner``'s i-th norm of NCHW ``x``."""
        if self.kind == "GroupNorm":
            return getattr(owner, f"GroupNorm_{i}")(x)
        if self.kind == "BatchNorm":
            return getattr(owner, f"BatchNorm_{i}")(x, dim=1)
        return x


def _conv(module: nn.Module, x: torch.Tensor, op) -> torch.Tensor:
    """``module``'s convolution of NCHW ``x``: with a gradient to take,
    :func:`~papc_tpu_torch.nn.layers.conv` (float32 forward and backward);
    without, the module's own call under the caller's cuDNN flags."""
    if torch.is_grad_enabled() and (x.requires_grad
                                    or module.weight.requires_grad):
        return conv(module, x, op)
    return module(x)


class PFNLayer(nn.Module):
    """Linear (no bias with a norm) → BN → ReLU → max over the points;
    a non-final layer concatenates the max back to every point."""

    def __init__(self, in_features: int, units: int, last_layer: bool = False,
                 use_norm: bool = True):
        super().__init__()
        self.last_layer = last_layer
        self.use_norm = use_norm
        units = units if last_layer else units // 2
        self.Dense_0 = nn.Linear(in_features, units, bias=not use_norm)
        if use_norm:
            self.BatchNorm_0 = _norm(units)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x)  # [B, V, P, units]
        if self.use_norm:
            x = self.BatchNorm_0(x)
        x = torch.relu(x)
        # the max sends its gradient evenly to tied slots, as jnp.max does;
        # padded slots hold relu(beta - mean·scale/sigma) and stay in the max
        x_max = torch.amax(x, dim=2, keepdim=True)
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class PillarFeatureNet(nn.Module):
    """Decorate each point (offset from its pillar's mean and from the
    pillar centre), zero the padded slots, run the PFN stack → per-pillar
    features ``[B, V, C]``. Given the flat ``points [B, N, D]`` and their
    pillar rows ``point_pillar [B, N]`` (the host pillarizer's flat view;
    ``voxels`` may then be None), the one PFN layer runs on the real
    points instead (:func:`~papc_tpu_torch.detect.pfn_fast.pfn_forward_flat`)
    on the same parameters and running statistics, which it updates in
    training; ``max_points_per_pillar`` is the grid's ``P`` there."""

    def __init__(self, num_input_features: int = 4,
                 num_filters: Sequence[int] = (64,),
                 voxel_size: Sequence[float] = (0.2, 0.2, 4.0),
                 pc_range: Sequence[float] = (0.0, -40.0, -3.0, 70.4, 40.0,
                                              1.0),
                 with_distance: bool = False, use_norm: bool = True,
                 max_points_per_pillar: int = 100):
        super().__init__()
        self.max_points_per_pillar = int(max_points_per_pillar)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in pc_range)
        self.with_distance = with_distance
        cin = num_input_features + 5 + (1 if with_distance else 0)
        n = len(num_filters)
        for i, f in enumerate(num_filters):
            layer = PFNLayer(cin, f, last_layer=(i == n - 1),
                             use_norm=use_norm)
            self.add_module(f"PFNLayer_{i}", layer)
            cin = f
        self.n_layers = n

    def forward(self, voxels: torch.Tensor | None, num_points: torch.Tensor,
                coords: torch.Tensor, points: torch.Tensor | None = None,
                point_pillar: torch.Tensor | None = None) -> torch.Tensor:
        if points is not None:
            return self._forward_flat(num_points, coords, points,
                                      point_pillar)
        B, V, P, D = voxels.shape
        denom = torch.clamp_min(num_points, 1).to(voxels.dtype)
        # the sum runs over all P slots: padded slots are zero
        points_mean = (voxels[..., :3].sum(dim=2, keepdim=True)
                       / denom[..., None, None])
        f_cluster = voxels[..., :3] - points_mean
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x_offset = vx / 2 + self.pc_range[0]
        y_offset = vy / 2 + self.pc_range[1]
        px = coords[..., 2].to(voxels.dtype) * vx + x_offset
        py = coords[..., 1].to(voxels.dtype) * vy + y_offset
        f_center = torch.stack([voxels[..., 0] - px[..., None],
                                voxels[..., 1] - py[..., None]], dim=-1)
        feats = [voxels, f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(voxels[..., :3], dim=-1,
                                                  keepdim=True))
        features = torch.cat(feats, dim=-1)
        slot = torch.arange(P, device=voxels.device)[None, None, :]
        mask = (slot < num_points[..., None]).to(features.dtype)
        features = features * mask[..., None]
        for i in range(self.n_layers):
            features = getattr(self, f"PFNLayer_{i}")(features)
        return features[:, :, 0, :]

    def _forward_flat(self, num_points, coords, points, point_pillar):
        layer = self.PFNLayer_0
        if self.n_layers != 1 or not layer.use_norm:
            raise NotImplementedError(
                "the flat PFN covers one PFN layer with BatchNorm (the "
                "shipped configs); set MODEL.PFN_FLAT false otherwise")
        bn = layer.BatchNorm_0
        out, running = pfn_forward_flat(
            layer.Dense_0.weight.t(), bn.weight, bn.bias,
            (bn.running_mean, bn.running_var), points, point_pillar,
            num_points, coords, self.max_points_per_pillar,
            voxel_size=self.voxel_size, pc_range=self.pc_range,
            with_distance=self.with_distance, train=self.training,
            momentum=bn.momentum, eps=bn.eps)
        if self.training:
            with torch.no_grad():
                bn.running_mean.copy_(running[0])
                bn.running_var.copy_(running[1])
        return out


class PointPillarsScatter(nn.Module):
    """Pillar features onto the dense BEV canvas → ``[B, ny, nx, C]``."""

    def __init__(self, ny: int, nx: int):
        super().__init__()
        self.ny, self.nx = ny, nx

    def forward(self, voxel_features: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        return scatter_to_bev_batched(voxel_features, coords, self.ny,
                                      self.nx)


class _ConvBlock(nn.Module):
    """A stride-s 3×3 conv and ``n_layers`` SAME 3×3 convs, each
    Conv (no bias with ``use_norm``) → norm (``_RPNNorm``) → ReLU, on NCHW
    maps."""

    def __init__(self, in_channels: int, filters: int, n_layers: int,
                 stride: int, use_norm: bool = True,
                 use_groupnorm: bool = False, num_groups: int = 32):
        super().__init__()
        self.n_layers = n_layers
        self.norm = _RPNNorm(use_norm, use_groupnorm, num_groups)
        for i in range(n_layers + 1):
            cin = in_channels if i == 0 else filters
            self.add_module(f"Conv_{i}", nn.Conv2d(
                cin, filters, 3, stride=stride if i == 0 else 1, padding=1,
                bias=not use_norm))
            self.norm.add(self, i, filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers + 1):
            layer = getattr(self, f"Conv_{i}")
            x = _conv(layer, x, lambda h, w, c=layer: F.conv2d(
                h, w, None, c.stride, c.padding))
            x = torch.relu(self.norm(self, i, x))
        return x


class RPN(nn.Module):
    """SECOND-style three-block backbone, per-stage ConvTranspose → BN →
    ReLU, the concat, and the three 1×1 heads as one product. Input and
    outputs channel-last: ``x [B, H, W, C]`` → ``{"box_preds",
    "cls_preds", "dir_cls_preds"}``, each ``[B, H/2, W/2, ·]``."""

    def __init__(self, in_channels: int = 64, num_class: int = 1,
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 num_filters: Sequence[int] = (64, 128, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 num_upsample_filters: Sequence[int] = (128, 128, 128),
                 num_anchor_per_loc: int = 2,
                 encode_background_as_zeros: bool = True,
                 use_direction_classifier: bool = True,
                 use_norm: bool = True, use_groupnorm: bool = False,
                 num_groups: int = 32, box_code_size: int = 7):
        super().__init__()
        self.norm = _RPNNorm(use_norm, use_groupnorm, num_groups)
        self.use_direction_classifier = use_direction_classifier
        cin = in_channels
        for i in range(3):
            self.add_module(f"_ConvBlock_{i}", _ConvBlock(
                cin, num_filters[i], layer_nums[i], layer_strides[i],
                use_norm, use_groupnorm, num_groups))
            s, f_up = upsample_strides[i], num_upsample_filters[i]
            self.add_module(f"ConvTranspose_{i}", nn.ConvTranspose2d(
                num_filters[i], f_up, s, stride=s, bias=not use_norm))
            self.norm.add(self, i, f_up)
            cin = num_filters[i]
        num_cls = num_anchor_per_loc * (
            num_class if encode_background_as_zeros else num_class + 1)
        self.n_box = num_anchor_per_loc * box_code_size
        self.n_cls = num_cls
        c_cat = sum(num_upsample_filters)
        self.Conv_0 = nn.Conv2d(c_cat, self.n_box, 1)
        self.Conv_1 = nn.Conv2d(c_cat, num_cls, 1)
        if use_direction_classifier:
            self.Conv_2 = nn.Conv2d(c_cat, num_anchor_per_loc * 2, 1)

    def forward(self, x: torch.Tensor) -> dict:
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW view
        ups = []
        for i in range(3):
            x = getattr(self, f"_ConvBlock_{i}")(x)
            deconv = getattr(self, f"ConvTranspose_{i}")
            up = _conv(deconv, x, lambda h, w, c=deconv: F.conv_transpose2d(
                h, w, None, c.stride))
            ups.append(torch.relu(self.norm(self, i, up)))
        x = torch.cat(ups, dim=1).permute(0, 2, 3, 1)  # [B, H, W, 384]
        heads = [self.Conv_0, self.Conv_1]
        if self.use_direction_classifier:
            heads.append(self.Conv_2)
        w = torch.cat([h.weight[:, :, 0, 0] for h in heads], dim=0)
        b = torch.cat([h.bias for h in heads])
        h = torch.matmul(x, w.t()) + b
        out = {"box_preds": h[..., :self.n_box],
               "cls_preds": h[..., self.n_box:self.n_box + self.n_cls]}
        if self.use_direction_classifier:
            out["dir_cls_preds"] = h[..., self.n_box + self.n_cls:]
        return out


class PointPillars(nn.Module):
    """PFN → scatter → RPN. ``forward`` returns the raw head maps; the
    loss is :func:`papc_tpu_torch.detect.detector.compute_loss`, the
    post-processing :func:`papc_tpu_torch.detect.detector.predict`. The
    PFN runs on the flat ``points`` / ``point_pillar`` where the batch
    carries them (``voxels`` may then be None), else on the grid."""

    def __init__(self, ny: int, nx: int, num_class: int = 1,
                 num_input_features: int = 4,
                 pfn_num_filters: Sequence[int] = (64,),
                 voxel_size: Sequence[float] = (0.16, 0.16, 4.0),
                 pc_range: Sequence[float] = (0.0, -39.68, -3.0, 69.12,
                                              39.68, 1.0),
                 with_distance: bool = False,
                 rpn_layer_nums: Sequence[int] = (3, 5, 5),
                 rpn_layer_strides: Sequence[int] = (2, 2, 2),
                 rpn_num_filters: Sequence[int] = (64, 128, 256),
                 rpn_upsample_strides: Sequence[int] = (1, 2, 4),
                 rpn_num_upsample_filters: Sequence[int] = (128, 128, 128),
                 num_anchor_per_loc: int = 2,
                 encode_background_as_zeros: bool = True,
                 use_direction_classifier: bool = True,
                 use_norm: bool = True, use_groupnorm: bool = False,
                 num_groups: int = 32, box_code_size: int = 7,
                 max_points_per_pillar: int = 100):
        super().__init__()
        self.pfn = PillarFeatureNet(num_input_features, pfn_num_filters,
                                    voxel_size, pc_range, with_distance,
                                    use_norm, max_points_per_pillar)
        self.scatter = PointPillarsScatter(ny, nx)
        self.rpn = RPN(pfn_num_filters[-1], num_class, rpn_layer_nums,
                       rpn_layer_strides, rpn_num_filters,
                       rpn_upsample_strides, rpn_num_upsample_filters,
                       num_anchor_per_loc, encode_background_as_zeros,
                       use_direction_classifier, use_norm, use_groupnorm,
                       num_groups, box_code_size)

    def forward(self, voxels: torch.Tensor | None, num_points: torch.Tensor,
                coords: torch.Tensor, points: torch.Tensor | None = None,
                point_pillar: torch.Tensor | None = None) -> dict:
        features = self.pfn(voxels, num_points, coords, points, point_pillar)
        return self.rpn(self.scatter(features, coords))

