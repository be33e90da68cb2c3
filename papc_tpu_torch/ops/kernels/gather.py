"""Grouping gather of a set-abstraction stage: the CUDA kernel
(``csrc/group_gather.cu``) and its plain PyTorch version.

Counterpart of ``papc_tpu/ops/pallas/gather_t.py::gather_cols_pallas``
(the forward of ``gather_cols``) plus the centring that follows it in
``papc_tpu/ops/grouping.py``. The port groups in row layout
``[B, S, K, 3 + D]``, xyz channels first, as ``sample_and_group`` does.
Both versions are exact: a copy and one subtraction.
"""

from __future__ import annotations

import ctypes

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.geometry import index_points
from papc_tpu_torch.ops.kernels import check, use_kernel

KERNEL = Kernel(
    "papc_group_gather",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p],
)


def group_gather_plain(xyz: torch.Tensor, points: torch.Tensor | None,
                       idx: torch.Tensor,
                       new_xyz: torch.Tensor) -> torch.Tensor:
    """``concat(xyz, points)`` gathered by ``idx [B, S, K]`` (clamped to
    ``[0, N)``), centred on ``new_xyz [B, S, 3]`` in the xyz channels
    → ``[B, S, K, 3 + D]``."""
    combined = xyz if points is None else torch.cat([xyz, points], dim=-1)
    grouped = index_points(combined, idx)
    centred = grouped[..., :3] - new_xyz[:, :, None, :]
    return torch.cat([centred, grouped[..., 3:]], dim=-1)


def group_gather_cuda(xyz: torch.Tensor, points: torch.Tensor | None,
                      idx: torch.Tensor,
                      new_xyz: torch.Tensor) -> torch.Tensor:
    B, N, _ = xyz.shape
    _, S, K = idx.shape
    D = 0 if points is None else points.shape[-1]
    check(xyz, "xyz", torch.float32, (B, N, 3))
    if points is not None:
        check(points, "points", torch.float32, (B, N, D))
    check(idx, "idx", torch.int32, (B, S, K))
    check(new_xyz, "new_xyz", torch.float32, (B, S, 3))
    out = torch.empty((B, S, K, 3 + D), dtype=torch.float32,
                      device=xyz.device)
    KERNEL(ptr(xyz), ptr(points), ptr(idx), ptr(new_xyz), B, N, D, S, K,
           ptr(out), stream_of(xyz))
    return out


def group_gather(xyz: torch.Tensor, points: torch.Tensor | None,
                 idx: torch.Tensor, new_xyz: torch.Tensor, *,
                 impl: str | None = None) -> torch.Tensor:
    if use_kernel(xyz, impl):
        return group_gather_cuda(
            xyz.float().contiguous(),
            None if points is None else points.float().contiguous(),
            idx.int().contiguous(),
            new_xyz.float().contiguous(),
        )
    return group_gather_plain(xyz, points, idx, new_xyz)
