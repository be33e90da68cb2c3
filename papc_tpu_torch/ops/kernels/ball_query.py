"""Ball query: the CUDA kernel (``csrc/ball_query.cu``), its plan and its
plain PyTorch version.

Counterpart of ``papc_tpu/ops/pallas/ball_query.py::query_ball_point_pallas``.
Semantics: the first ``nsample`` indices (ascending) with
``(q - p)² <= r²`` (inclusive, direct differences, no FMA contraction);
empty slots take the row's first hit; a row with no hit is all ``N - 1``.
``r²`` is rounded to f32 once, as JAX does with its weakly typed
``radius ** 2``. On the card a block stages one cloud in shared memory
(whole, or in double-buffered tiles) for a tile of that cloud's queries,
each warp scanning for ``queries`` of them at once
(:func:`ball_query_plan`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import check, use_kernel

P, I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("papc_ball_query",
                [P, P, I, I, I, I, ctypes.c_float, I, I, I, P, P])
SMEM_LIMIT = 232448  # dynamic shared memory a block may opt into (H100)
QUERIES = (4, 2, 1)  # queries a warp scans for at once, by choice
BLOCK_WARPS = (32, 16, 8, 4, 2, 1)  # a block's warps, by choice
FILL_BLOCKS = 128  # blocks that fill the card: 97 % of its 132 SMs
STEP = 128  # points a warp tests a visit: the staged points' multiple
TILE_POINTS = 4096  # points of a staged tile where the cloud does not fit


class BallQueryPlan(NamedTuple):
    warps: int  # warps a block
    queries: int  # queries a warp scans for at once
    tile: int  # points staged at once: N (the whole cloud) or TILE_POINTS
    smem: int  # bytes of the staged points
    blocks: int  # blocks of warps * queries queries of one cloud


def pad_step(points: int) -> int:
    """Points staged for ``points``: up to a multiple of ``STEP`` (+inf)."""
    return -(-points // STEP) * STEP


@functools.lru_cache(maxsize=None)
def ball_query_plan(b: int, n: int, s: int, k: int) -> BallQueryPlan:
    """The kernel's grid for ``b`` clouds of ``n`` points and ``s``
    queries each, ``k`` hits a query. A block takes ``warps * queries``
    consecutive queries of one cloud: the most warps of ``BLOCK_WARPS``,
    and for them the most ``QUERIES`` a warp, that still give
    ``FILL_BLOCKS`` blocks (SSG SA1: 32 warps of 4 queries; SA2: 32 of
    1; B=4 x 16384 points: 32 of 2). The whole cloud
    is staged where it fits (12 bytes a point, up to some 19 000 points),
    a larger one in double-buffered tiles of ``TILE_POINTS``."""
    if min(b, n, s, k) < 1:
        raise ValueError(f"ball query needs positive shapes, got b={b}, "
                         f"n={n}, s={s}, k={k}")
    warps, queries = next(
        ((w, q) for w in BLOCK_WARPS for q in QUERIES
         if b * -(-s // (w * q)) >= FILL_BLOCKS), (1, QUERIES[-1]))
    if 12 * pad_step(n) <= SMEM_LIMIT:
        tile, smem = n, 12 * pad_step(n)
    else:
        tile, smem = TILE_POINTS, 24 * TILE_POINTS
    return BallQueryPlan(warps, queries, tile, smem,
                         b * -(-s // (warps * queries)))


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


def launch_plan(radius: float, nsample: int, xyz: torch.Tensor,
                new_xyz: torch.Tensor, plan: BallQueryPlan) -> torch.Tensor:
    """The kernel under ``plan``, on tensors as ``query_ball_point_cuda``
    checks them (the card's plan comparisons; the C entry refuses a plan
    whose shared memory exceeds a block's)."""
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    KERNEL(ptr(xyz), ptr(new_xyz), B, N, S, nsample, radius_squared(radius),
           plan.warps, plan.queries, plan.tile, ptr(out), stream_of(xyz))
    return out


def query_ball_point_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                          new_xyz: torch.Tensor) -> torch.Tensor:
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    check(xyz, "xyz", torch.float32, (B, N, 3))
    check(new_xyz, "new_xyz", torch.float32, (B, S, 3))
    if nsample > N:
        raise ValueError(f"nsample={nsample} exceeds the cloud's {N} points")
    plan = ball_query_plan(B, N, S, nsample)
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    KERNEL(ptr(xyz), ptr(new_xyz), B, N, S, nsample, radius_squared(radius),
           plan.warps, plan.queries, plan.tile, ptr(out), stream_of(xyz))
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
