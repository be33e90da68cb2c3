"""Grouping gather of a set-abstraction stage and its backward: the CUDA
kernels (``csrc/group_gather.cu``, ``csrc/group_scatter_add.cu``), their
plans and their plain PyTorch versions.

Counterpart of ``papc_tpu/ops/pallas/gather_t.py::gather_cols`` (forward
``gather_cols_pallas``, backward ``scatter_cols_add_pallas``) plus the
centring that follows it in ``papc_tpu/ops/grouping.py``. The port groups
in row layout ``[B, S, K, 3 + D]``, xyz channels first, as
``sample_and_group`` does.

- The forward is exact in both versions (a copy and one subtraction). On
  the card a block writes the contiguous span of :func:`gather_plan`'s
  ``tile`` groups, each gathered row's index read and clamped once.
- The backward adds the row-layout gradient into ``[B, N, 3 + D]`` at the
  clamped indices, on the owner-computes scatter-add of
  ``scatter_sorted`` (``csrc/scatter_sorted.cuh``): on the card it first
  sorts each cloud's entries by point, stably (:func:`inverse_index_plain`
  is that index's plain twin), then sums each point's rows in that order
  and writes every output row once (:func:`scatter_add_sorted_plain` sums
  in the same order; a long list is split over consecutive workers whose
  parts are added in order, :func:`sum_schedule`). No atomics on the
  output: two calls give the same bits. It matches the plain
  ``index_add_`` on the card (atomics) to f32 rounding of the sums.
  :func:`scatter_add_plan` sizes both launches and raises above
  ``SCATTER_N_LIMIT`` points.
- Both run in f32 or in bf16 (the bf16 training step), as the TPU kernels'
  bf16 branches do: a bf16 source is gathered into a bf16 output, the
  centring rounded once to bf16 from the exact difference; a bf16
  gradient is summed in f32 in the same order and each row rounded once
  to bf16, the source's dtype. Any other float dtype is taken as f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.geometry import index_points
from papc_tpu_torch.ops.kernels import check, use_kernel
# the inverse index's names stay importable from here, where the grouping
# gather's tests and callers have always found them
from papc_tpu_torch.ops.kernels.scatter_sorted import (  # noqa: F401
    INDEX_WARPS, MAX_CHANS, SCATTER_N_LIMIT, SMEM_LIMIT, THREADS, ScatterPlan,
    index_smem, inverse_index_plain, scatter_add_sorted_plain, sorted_plan,
    sum_rows, sum_schedule)

P, I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("papc_group_gather",
                [P, P, P, P, I, I, I, I, I, I, I, I, P, P])
SCATTER_KERNEL = Kernel("papc_group_scatter_add",
                        [P, I, P, I, I, I, I, I, I, I, I, P, P, P, P])
DTYPES = (torch.float32, torch.bfloat16)  # the kernels' element types
GATHER_SPAN = 4096  # elements a gather block writes, where its groups allow
GATHER_ROWS = 1024  # gathered rows a block's records hold (16 bytes each)
# a gather block has THREADS threads, as a sum block does


class GatherPlan(NamedTuple):
    tile: int  # groups a block
    vec: int  # elements a store: 16 bytes' worth (4 f32, 8 bf16) or 1
    blocks: int
    smem: int  # bytes: one 16-byte record a gathered row


def kernel_dtype(*tensors) -> torch.dtype:
    """The element type the gather and its backward run in for these
    tensors (``None`` entries ignored): bf16 where all are bf16, else
    f32."""
    return (torch.bfloat16 if all(t.dtype == torch.bfloat16
                                  for t in tensors if t is not None)
            else torch.float32)


@functools.lru_cache(maxsize=None)
def gather_plan(b: int, s: int, k: int, c: int,
                elem: int = 4) -> GatherPlan:
    """The gather's grid for ``b * s`` groups of ``k`` rows of ``c``
    channels of ``elem`` bytes (4: f32, 2: bf16): a block writes ``tile``
    whole groups, at least ``GATHER_SPAN`` elements where the groups allow
    and at most ``GATHER_ROWS`` rows (one group a block at SA2, 32 at
    SA1), in 16-byte stores where a group's ``k * c`` elements are a
    multiple of ``16 / elem``. Raises ``ValueError`` where one group's
    records exceed shared memory."""
    if min(b, s, k, c) < 1:
        raise ValueError(f"gather needs positive shapes, got b={b}, s={s}, "
                         f"k={k}, c={c}")
    if elem not in (2, 4):
        raise ValueError(f"the gather takes 2- or 4-byte elements, got {elem}")
    if 16 * k > SMEM_LIMIT:
        raise ValueError(f"the gather holds at most {SMEM_LIMIT // 16} rows a "
                         f"group, got k={k}")
    groups = b * s
    tile = max(1, min(groups, -(-GATHER_SPAN // (k * c)), GATHER_ROWS // k))
    wide = 16 // elem
    return GatherPlan(tile, wide if k * c % wide == 0 else 1,
                      -(-groups // tile), 16 * tile * k)


@functools.lru_cache(maxsize=None)
def scatter_add_plan(b: int, n: int, s: int, k: int, c: int) -> ScatterPlan:
    """The backward's two launches for ``b`` clouds of ``s * k`` entries
    into ``n`` points of ``c`` channels: :func:`sorted_plan` (32 index
    warps a cloud up to 1760 points, 4 at ``SCATTER_N_LIMIT``; a sum
    worker of ``lanes`` lanes a row, ``chans`` channels a lane). Raises
    ``ValueError`` above ``SCATTER_N_LIMIT`` points."""
    if min(b, n, s, k, c) < 1:
        raise ValueError(f"scatter_add needs positive shapes, got b={b}, "
                         f"n={n}, s={s}, k={k}, c={c}")
    return sorted_plan(b, n, s * k, c)


def group_gather_plain(xyz: torch.Tensor, points: torch.Tensor | None,
                       idx: torch.Tensor,
                       new_xyz: torch.Tensor) -> torch.Tensor:
    """``concat(xyz, points)`` gathered by ``idx [B, S, K]`` (clamped to
    ``[0, N)``), centred on ``new_xyz [B, S, 3]`` in the xyz channels
    → ``[B, S, K, 3 + D]`` in the inputs' dtype (a bf16 difference is the
    exact one rounded once)."""
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
    dtype = xyz.dtype
    if dtype not in DTYPES:
        raise ValueError(f"the gather takes float32 or bfloat16, got {dtype}")
    check(xyz, "xyz", dtype, (B, N, 3))
    if points is not None:
        check(points, "points", dtype, (B, N, D))
    check(idx, "idx", torch.int32, (B, S, K))
    check(new_xyz, "new_xyz", dtype, (B, S, 3))
    plan = gather_plan(B, S, K, 3 + D, xyz.element_size())
    out = torch.empty((B, S, K, 3 + D), dtype=dtype, device=xyz.device)
    KERNEL(ptr(xyz), ptr(points), ptr(idx), ptr(new_xyz),
           int(dtype == torch.bfloat16), B, N, D, S, K, plan.tile, plan.vec,
           ptr(out), stream_of(xyz))
    return out


def scatter_add_plain(g: torch.Tensor, idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """``g [B, S, K, C]`` added into ``[B, n, C]`` at the rows ``idx [B,
    S, K]`` (clamped to ``[0, n)``), summed in f32: bf16 for a bf16 ``g``
    (each sum rounded once), else f32."""
    B, S, K, C = g.shape
    rows = idx.reshape(B, -1).long().clamp(0, n - 1)
    rows = (rows + (torch.arange(B, device=g.device) * n)[:, None]).reshape(-1)
    out = torch.zeros((B * n, C), dtype=torch.float32, device=g.device)
    out.index_add_(0, rows, g.reshape(-1, C).float())
    return out.reshape(B, n, C).to(kernel_dtype(g))


def scatter_add_cuda(g: torch.Tensor, idx: torch.Tensor, n: int, *,
                     with_index: bool = False):
    """The two kernels behind one launch count. ``with_index`` (tests)
    returns the inverse index beside the sum: ``(out, offsets,
    order)``."""
    B, S, K, C = g.shape
    if g.dtype not in DTYPES:
        raise ValueError(f"g must be float32 or bfloat16, is {g.dtype}")
    check(g, "g", g.dtype, (B, S, K, C))
    check(idx, "idx", torch.int32, (B, S, K))
    plan = scatter_add_plan(B, n, S, K, C)
    offsets = torch.empty((B, n + 1), dtype=torch.int32, device=g.device)
    order = torch.empty((B, S * K), dtype=torch.int32, device=g.device)
    out = torch.empty((B, n, C), dtype=g.dtype, device=g.device)
    SCATTER_KERNEL(ptr(g), int(g.dtype == torch.bfloat16), ptr(idx), B, n, S,
                   K, C, plan.warps, plan.lanes, plan.chans, ptr(offsets),
                   ptr(order), ptr(out), stream_of(g))
    return (out, offsets, order) if with_index else out


def scatter_add(g: torch.Tensor, idx: torch.Tensor, n: int, *,
                impl: str | None = None) -> torch.Tensor:
    """The gather's backward: ``g`` summed into ``[B, n, C]`` at the
    clamped ``idx``, in ``kernel_dtype(g)``."""
    if use_kernel(g, impl):
        return scatter_add_cuda(g.to(kernel_dtype(g)).contiguous(),
                                idx.int().contiguous(), n)
    return scatter_add_plain(g, idx, n)


class _GroupGather(torch.autograd.Function):
    """The gather as one differentiable op: forward the kernel (or the
    plain version), backward the scatter-add into ``concat(xyz,
    points)`` and, for ``new_xyz``, minus the K-sum of the xyz channels.
    Each input's gradient is computed only when it is wanted, in the
    inputs' dtype (f32 or bf16, as the forward ran)."""

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
    ``new_xyz`` in the xyz channels → ``[B, S, K, 3 + D]``,
    differentiable in ``xyz``, ``points`` and ``new_xyz``. bf16 where the
    inputs are all bf16 (the bf16 training step), else f32."""
    dtype = kernel_dtype(xyz, points, new_xyz)
    return _GroupGather.apply(
        xyz.to(dtype), None if points is None else points.to(dtype), idx,
        new_xyz.to(dtype), impl)
