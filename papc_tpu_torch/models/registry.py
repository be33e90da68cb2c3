"""Model registry (counterpart of ``papc_tpu/models/registry.py``).

The same 14 (model_name, mode) combos as the JAX registry, in its order,
built with its factories' arguments. ``input_kind`` tells the data layer
which loader family feeds the model ('points' = ShapeNet clouds, 'kd' =
kd-tree leaves and split axes, 'voxel' = 32³ occupancy grids); each
model also carries it as an attribute, with its ``mode``. Unknown names
and modes raise JAX's ``SystemExit`` messages.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from papc_tpu_torch.models import classify, segment


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    model: nn.Module
    input_kind: str  # 'points' | 'kd' | 'voxel'
    mode: str  # 'clas' | 'seg'


# mode → name → (factory(num_classes, num_parts, max_point, generator),
# input_kind)
_TABLES = {
    "clas": {
        "voxnet": (lambda nc, np_, mp, gen: classify.VoxNet(
            num_classes=nc, generator=gen), "voxel"),
        "kdnet": (lambda nc, np_, mp, gen: classify.KDNet(
            num_classes=nc, max_point=mp, generator=gen), "kd"),
        "pointnet_basic": (lambda nc, np_, mp, gen: classify.PointNetBasicClas(
            num_classes=nc, max_points=mp, generator=gen), "points"),
        "pointnet": (lambda nc, np_, mp, gen: classify.PointNetClas(
            num_classes=nc, max_point=mp, generator=gen), "points"),
        "pointnet_conv2d": (lambda nc, np_, mp, gen:
                            classify.PointNetConv2DClas(
                                num_classes=nc, max_point=mp, generator=gen),
                            "points"),
        "vfe": (lambda nc, np_, mp, gen: classify.VFEClas(
            num_classes=nc, max_points=mp, generator=gen), "points"),
        "pointnet2_ssg": (lambda nc, np_, mp, gen: classify.PointNet2SSGClas(
            num_classes=nc, generator=gen), "points"),
        "pointnet2_msg": (lambda nc, np_, mp, gen: classify.PointNet2MSGClas(
            num_classes=nc, generator=gen), "points"),
    },
    "seg": {
        "kdunet": (lambda nc, np_, mp, gen: segment.KDUNet(
            num_classes=np_, generator=gen), "kd"),
        "pointnet_basic": (lambda nc, np_, mp, gen: segment.PointNetBasicSeg(
            num_classes=np_, max_points=mp, generator=gen), "points"),
        "pointnet": (lambda nc, np_, mp, gen: segment.PointNetSeg(
            num_classes=np_, max_point=mp, generator=gen), "points"),
        "vfe": (lambda nc, np_, mp, gen: segment.VFESeg(
            num_classes=np_, max_points=mp, generator=gen), "points"),
        "pointnet2_ssg": (lambda nc, np_, mp, gen: segment.PointNet2SSGSeg(
            num_classes=nc, num_parts=np_, generator=gen), "points"),
        "pointnet2_msg": (lambda nc, np_, mp, gen: segment.PointNet2MSGSeg(
            num_classes=nc, num_parts=np_, generator=gen), "points"),
    },
}


def registry_combos() -> tuple[tuple[str, str], ...]:
    """Every (model_name, mode) combo the registry can construct, in
    JAX's order."""
    return tuple((name, mode) for mode, table in _TABLES.items()
                 for name in table)


def _entry(model_name: str, mode: str):
    if mode == "detect":
        raise SystemExit(
            "Error: use papc_tpu.models.detect / the detection CLI for "
            "detection models")
    if mode not in _TABLES:
        raise SystemExit('Error: mode should be "clas", "detect" or "seg"')
    if model_name not in _TABLES[mode]:
        raise SystemExit("Error: model is incorrect")
    return _TABLES[mode][model_name]


def input_kind(model_name: str, mode: str) -> str:
    """The loader family of a combo, without building the model; raises
    as :func:`init_model` does."""
    return _entry(model_name, mode)[1]


def init_model(
    model_name: str = "pointnet_basic",
    mode: str = "clas",
    num_classes: int = 16,
    num_parts: int = 50,
    max_point: int = 1024,
    *,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> ModelSpec:
    """Build a model in eval mode on ``device`` (the card unless the
    caller asks for the CPU) with flax's initial values drawn from
    ``torch.Generator().manual_seed(seed)``."""
    factory, kind = _entry(model_name, mode)
    gen = torch.Generator().manual_seed(seed)
    model = factory(num_classes, num_parts, max_point, gen)
    return ModelSpec(model=model.eval().to(device), input_kind=kind,
                     mode=mode)
