"""Grouping gather of a set-abstraction stage and its backward: the CUDA
kernels (``csrc/group_gather.cu``, ``csrc/group_scatter_add.cu``) and
their plain PyTorch versions.

Counterpart of ``papc_tpu/ops/pallas/gather_t.py::gather_cols`` (forward
``gather_cols_pallas``, backward ``scatter_cols_add_pallas``) plus the
centring that follows it in ``papc_tpu/ops/grouping.py``. The port groups
in row layout ``[B, S, K, 3 + D]``, xyz channels first, as
``sample_and_group`` does. The forward is exact in both versions (a copy
and one subtraction); the backward scatter-adds the row-layout gradient
into ``[B, N, 3 + D]`` at the clamped indices, with atomics on the card,
so it matches the plain ``index_add_`` to f32 rounding of the sums.
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
SCATTER_KERNEL = Kernel(
    "papc_group_scatter_add",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p],
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


def scatter_add_plain(g: torch.Tensor, idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """``g [B, S, K, C]`` added into ``[B, n, C]`` f32 at the rows
    ``idx [B, S, K]`` (clamped to ``[0, n)``)."""
    B, S, K, C = g.shape
    rows = idx.reshape(B, -1).long().clamp(0, n - 1)
    rows = (rows + (torch.arange(B, device=g.device) * n)[:, None]).reshape(-1)
    out = torch.zeros((B * n, C), dtype=torch.float32, device=g.device)
    out.index_add_(0, rows, g.reshape(-1, C).float())
    return out.reshape(B, n, C)


def scatter_add_cuda(g: torch.Tensor, idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    B, S, K, C = g.shape
    check(g, "g", torch.float32, (B, S, K, C))
    check(idx, "idx", torch.int32, (B, S, K))
    out = torch.zeros((B, n, C), dtype=torch.float32, device=g.device)
    SCATTER_KERNEL(ptr(g), ptr(idx), B, n, S, K, C, ptr(out), stream_of(g))
    return out


def scatter_add(g: torch.Tensor, idx: torch.Tensor, n: int, *,
                impl: str | None = None) -> torch.Tensor:
    if use_kernel(g, impl):
        return scatter_add_cuda(g.float().contiguous(), idx.int().contiguous(),
                                n)
    return scatter_add_plain(g, idx, n)


class _GroupGather(torch.autograd.Function):
    """The gather as one differentiable op: forward the kernel (or the
    plain version), backward the scatter-add into ``concat(xyz,
    points)`` and, for ``new_xyz``, minus the K-sum of the xyz channels.
    Each input's gradient is computed only when it is wanted."""

    @staticmethod
    def forward(ctx, xyz, points, idx, new_xyz, impl):
        ctx.save_for_backward(idx)
        ctx.n, ctx.impl = xyz.shape[1], impl
        if use_kernel(xyz, impl):
            return group_gather_cuda(
                xyz.contiguous(),
                None if points is None else points.contiguous(),
                idx.int().contiguous(), new_xyz.contiguous())
        return group_gather_plain(xyz, points, idx, new_xyz)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        want_xyz, want_points, _, want_new, _ = ctx.needs_input_grad
        dxyz = dpoints = dnew = None
        if want_xyz or want_points:
            dcombined = scatter_add(g, idx, ctx.n, impl=ctx.impl)
            if want_xyz:
                dxyz = dcombined[..., :3]
            if want_points:
                dpoints = dcombined[..., 3:]
        if want_new:
            dnew = -g[..., :3].sum(dim=2)
        return dxyz, dpoints, None, dnew, None


def group_gather(xyz: torch.Tensor, points: torch.Tensor | None,
                 idx: torch.Tensor, new_xyz: torch.Tensor, *,
                 impl: str | None = None) -> torch.Tensor:
    """``concat(xyz, points)`` gathered by ``idx [B, S, K]``, centred on
    ``new_xyz`` in the xyz channels → ``[B, S, K, 3 + D]`` f32,
    differentiable in ``xyz``, ``points`` and ``new_xyz``."""
    return _GroupGather.apply(
        xyz.float(), None if points is None else points.float(), idx,
        new_xyz.float(), impl)
