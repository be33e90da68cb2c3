"""Model registry (counterpart of ``papc_tpu/models/registry.py``).

The port serves one combination so far, ``("pointnet2_ssg", "clas")``;
every other model of the JAX registry is still to port (``ROADMAP.md``,
Queue 1) and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from papc_tpu_torch.models.classify import PointNet2SSGClas


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    model: nn.Module
    input_kind: str  # 'points' | 'kd' | 'voxel'
    mode: str  # 'clas' | 'seg'


_TABLE = {
    ("pointnet2_ssg", "clas"): (
        lambda nc, np_, mp, gen: PointNet2SSGClas(num_classes=nc,
                                                  generator=gen),
        "points",
    ),
}


def registry_combos() -> tuple[tuple[str, str], ...]:
    """Every (model_name, mode) combo the port can construct."""
    return tuple(_TABLE)


def init_model(
    model_name: str = "pointnet2_ssg",
    mode: str = "clas",
    num_classes: int = 16,
    num_parts: int = 50,
    max_point: int = 1024,
    *,
    seed: int = 0,
    device: str | torch.device = "cpu",
) -> ModelSpec:
    """Build a model in eval mode on ``device`` with flax's initial
    values drawn from ``torch.Generator().manual_seed(seed)``."""
    if mode not in ("clas", "seg"):
        raise SystemExit('Error: mode should be "clas", "detect" or "seg"')
    if (model_name, mode) not in _TABLE:
        raise NotImplementedError(
            f"({model_name!r}, {mode!r}) is not ported to PyTorch yet; the "
            "port serves ('pointnet2_ssg', 'clas'). See ROADMAP.md, Queue 1."
        )
    factory, kind = _TABLE[(model_name, mode)]
    gen = torch.Generator().manual_seed(seed)
    model = factory(num_classes, num_parts, max_point, gen)
    return ModelSpec(model=model.eval().to(device), input_kind=kind,
                     mode=mode)
