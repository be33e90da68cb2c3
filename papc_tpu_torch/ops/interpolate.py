"""Inverse-distance feature interpolation of PointNet++ feature
propagation (counterpart of ``papc_tpu/ops/interpolate.py``)."""

from __future__ import annotations

import torch

from papc_tpu_torch.ops.geometry import index_points
from papc_tpu_torch.ops.grouping import knn


def three_nn_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         points2: torch.Tensor, *, eps: float = 1e-8,
                         k: int = 3, impl: str | None = None) -> torch.Tensor:
    """Features ``points2 [B, S, D]`` at ``xyz2 [B, S, 3]`` interpolated
    onto ``xyz1 [B, N, 3]`` → ``[B, N, D]``: the ``k`` nearest sources
    weighted by ``1 / (d² + eps)``, normalised, in JAX's order of
    operations and dtypes: the weights are f32 (a bf16 ``xyz`` through
    ``square_distance``'s bf16 squares), and bf16 neighbours times f32
    weights sum in f32, so the result is f32 for bf16 ``points2``, as in
    JAX. The neighbours are gathered with ``index_points``, so their
    gradient is the row scatter-add (the kernel on the card)."""
    dists, idx = knn(k, xyz2, xyz1)
    dist_recip = 1.0 / (dists + eps)
    norm = dist_recip.sum(dim=2, keepdim=True)
    weight = dist_recip / norm
    neighbors = index_points(points2, idx, impl=impl)
    return (neighbors * weight[..., None]).sum(dim=2)
