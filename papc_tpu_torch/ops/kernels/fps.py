"""Farthest point sampling: the CUDA kernel (``csrc/fps.cu``) and its
plain PyTorch version.

Counterpart of ``papc_tpu/ops/pallas/fps.py::farthest_point_sample_pallas``
and of the XLA loop in ``papc_tpu/ops/sampling.py``. Both versions here
compute the same recursion bit for bit: running min-distance over
``((dx*dx + dy*dy) + dz*dz)`` without FMA contraction, then the
first-occurrence argmax.
"""

from __future__ import annotations

import ctypes

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import check, use_kernel

KERNEL = Kernel(
    "papc_fps",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)
MAX_POINTS = 12288  # 16 B of shared memory a point, 227 KB a block


def farthest_point_sample_plain(xyz: torch.Tensor, npoint: int,
                                start: torch.Tensor) -> torch.Tensor:
    """``xyz [B, N, 3]``, ``start [B]`` → int32 ``[B, npoint]``."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(B, device=xyz.device)
    dist = torch.full((B, N), float("inf"), device=xyz.device)
    far = start.long()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = torch.argmax(dist, dim=-1)
    return out


def farthest_point_sample_cuda(xyz: torch.Tensor, npoint: int,
                               start: torch.Tensor) -> torch.Tensor:
    B, N, _ = xyz.shape
    check(xyz, "xyz", torch.float32, (B, N, 3))
    check(start, "start", torch.int32, (B,))
    if N > MAX_POINTS:
        raise ValueError(f"fps kernel holds at most {MAX_POINTS} points, got {N}")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    KERNEL(ptr(xyz), ptr(start), B, N, npoint, ptr(out), stream_of(xyz))
    return out


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: torch.Tensor, *,
                          impl: str | None = None) -> torch.Tensor:
    if use_kernel(xyz, impl):
        return farthest_point_sample_cuda(
            xyz.float().contiguous(), npoint, start.int().contiguous()
        )
    return farthest_point_sample_plain(xyz, npoint, start)
