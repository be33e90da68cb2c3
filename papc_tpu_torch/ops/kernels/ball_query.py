"""Ball query: the CUDA kernel (``csrc/ball_query.cu``) and its plain
PyTorch version.

Counterpart of ``papc_tpu/ops/pallas/ball_query.py::query_ball_point_pallas``.
Semantics: the first ``nsample`` indices (ascending) with
``(q - p)² <= r²`` (inclusive, direct differences, no FMA contraction);
empty slots take the row's first hit; a row with no hit is all ``N - 1``.
``r²`` is rounded to f32 once, as JAX does with its weakly typed
``radius ** 2``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import check, use_kernel

KERNEL = Kernel(
    "papc_ball_query",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
     ctypes.c_void_p],
)


def radius_squared(radius: float) -> float:
    """``radius²`` as the f32 both versions compare against."""
    return float(np.float32(float(radius) ** 2))


def query_ball_point_plain(radius: float, nsample: int, xyz: torch.Tensor,
                           new_xyz: torch.Tensor) -> torch.Tensor:
    """``xyz [B, N, 3]``, ``new_xyz [B, S, 3]`` → int32 ``[B, S, nsample]``."""
    N = xyz.shape[1]
    if nsample > N:
        raise ValueError(f"nsample={nsample} exceeds the cloud's {N} points")
    xyz, new_xyz = xyz.float(), new_xyz.float()
    p = xyz[:, None, :, :]  # [B, 1, N, 3]
    q = new_xyz[:, :, None, :]  # [B, S, 1, 3]
    dx = q[..., 0] - p[..., 0]
    dy = q[..., 1] - p[..., 1]
    dz = q[..., 2] - p[..., 2]
    d = dx * dx + dy * dy + dz * dz  # [B, S, N]
    cand = torch.where(
        d <= radius_squared(radius),
        torch.arange(N, dtype=torch.int32, device=xyz.device),
        N,
    )
    group = torch.sort(cand, dim=-1).values[..., :nsample]
    group = torch.where(group == N, group[..., :1], group)
    return group.clamp_max(N - 1)


def query_ball_point_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                          new_xyz: torch.Tensor) -> torch.Tensor:
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    check(xyz, "xyz", torch.float32, (B, N, 3))
    check(new_xyz, "new_xyz", torch.float32, (B, S, 3))
    if nsample > N:
        raise ValueError(f"nsample={nsample} exceeds the cloud's {N} points")
    out =torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    KERNEL(ptr(xyz), ptr(new_xyz), B, N, S, nsample,
           radius_squared(radius), ptr(out), stream_of(xyz))
    return out


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, *,
                     impl: str | None = None) -> torch.Tensor:
    if use_kernel(xyz, impl):
        return query_ball_point_cuda(
            radius, nsample, xyz.float().contiguous(),
            new_xyz.float().contiguous(),
        )
    return query_ball_point_plain(radius, nsample, xyz, new_xyz)
