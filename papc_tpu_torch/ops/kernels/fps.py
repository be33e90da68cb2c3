"""Farthest point sampling: the CUDA kernel (``csrc/fps.cu``), its plan
and its plain PyTorch version.

Counterpart of ``papc_tpu/ops/pallas/fps.py::farthest_point_sample_pallas``
and of the XLA loop in ``papc_tpu/ops/sampling.py``. Both versions here
compute the same recursion bit for bit: running min-distance over
``((dx*dx + dy*dy) + dz*dz)`` without FMA contraction, then the
first-occurrence argmax.

The kernel holds a cloud in registers: a cluster of ``cluster`` blocks of
``warps`` warps, each lane owning ``points_per_lane`` consecutive points
(their coordinates and running distance). :func:`fps_plan` chooses those
three numbers from the shapes; the C entry checks them and refuses a plan
that does not hold the cloud.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import check, use_kernel

KERNEL = Kernel(
    "papc_fps",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p],
)
# The kernel's template values and limits (csrc/fps.cu).
POINTS_PER_LANE = (1, 2, 4, 8, 16, 32)
# warps a block at each points-per-lane: the launch bound gives a lane
# 65536 / threads registers, and it needs REGISTERS_PER_POINT a point plus
# REGISTERS_BESIDE for the rest
MAX_WARPS = {1: 32, 2: 32, 4: 32, 8: 16, 16: 16, 32: 8}
REGISTERS_PER_POINT, REGISTERS_BESIDE = 4, 32
REGISTERS_PER_SM, MAX_REGISTERS_PER_LANE = 65536, 255
MAX_CLUSTER = 16  # the C side sets the non-portable attribute above 8
PORTABLE_CLUSTER = 8
BLOCK_WARPS = 8  # warps of a block outside a cluster
SMEM_PER_BLOCK = 232448
BLOCK_POINTS = max(32 * p * w for p, w in MAX_WARPS.items())  # 8192
POINT_LIMIT = MAX_CLUSTER * BLOCK_POINTS  # 131072
# The plan's choices, measured on the card (PERF.md, row 1).
WARPS = 4  # one warp on each of an SM's four schedulers
SMS = 132  # the H100's SMs: a large cloud spreads over a cluster while
SPREAD_POINTS = 2048  # the card has room and each block keeps this many


class FpsPlan(NamedTuple):
    warps: int
    points_per_lane: int
    cluster: int


def fps_plan(B: int, N: int) -> FpsPlan:
    """The kernel's launch shape for ``B`` clouds of ``N`` points.

    - ``cluster`` C: the blocks a cloud spreads over. A cloud that
      ``WARPS`` warps hold at 32 points a lane stays in one block: there
      a cluster's round costs more than the points it spreads save.
      Above that C doubles while a block would hold more than
      ``BLOCK_POINTS`` (the registers of one SM), and further while the
      card has SMs to spare (``B * 2C <= SMS``) and each block keeps
      more than ``SPREAD_POINTS``.
    - ``warps`` W and ``points_per_lane`` P: ``WARPS`` warps where a
      block's share fills them, fewer for a small cloud; P the smallest
      templated value whose ``32 * W * P`` points hold the share, W
      raised where P = 32 is not enough; then C cut to the blocks that
      the cloud reaches, since blocks fill in ownership order.

    Ownership ascends over (rank in the cluster, warp, lane, slot); see
    :func:`fps_ownership`. Raises ``ValueError`` above ``POINT_LIMIT``.
    """
    if B < 1 or N < 1:
        raise ValueError(f"fps needs B >= 1 and N >= 1, got B={B}, N={N}")
    if N > POINT_LIMIT:
        raise ValueError(f"the fps kernel holds at most {POINT_LIMIT} points "
                         f"a cloud, got {N}")
    cluster = 1
    while cluster < MAX_CLUSTER and (
            N > cluster * BLOCK_POINTS
            or (N > WARPS * 32 * 32 and B * cluster * 2 <= SMS
                and N > cluster * SPREAD_POINTS)):
        cluster *= 2
    share = math.ceil(N / cluster)
    warps = min(WARPS, math.ceil(share / 32))
    p = next((p for p in POINTS_PER_LANE if 32 * warps * p >= share), 32)
    warps = max(warps, math.ceil(share / (32 * p)))
    # blocks fill in ownership order: drop the ranks that would hold none
    return FpsPlan(warps, p, math.ceil(N / (32 * warps * p)))


def fps_ownership(N: int, plan: FpsPlan) -> torch.Tensor:
    """Point index held by each (rank, warp, lane, slot) of ``plan``, as
    the kernel assigns it; -1 for a padding slot past ``N``."""
    w, p, c = plan
    idx = torch.arange(c * w * 32 * p).reshape(c, w, 32, p)
    return torch.where(idx < N, idx, -1)


def fps_smem_bytes(plan: FpsPlan) -> int:
    """Shared memory of a block, as ``csrc/fps.cu`` lays it out: two
    parities of ``BLOCK_WARPS`` records and keys (static); in a cluster
    besides two parities of C*W 16-byte records and 16-byte keys (the
    words ``st.async`` writes) and two 8-byte mbarriers."""
    w, _, c = plan
    cluster = 0 if c == 1 else 2 * 2 * c * w * 16 + 2 * 8
    return 2 * BLOCK_WARPS * (16 + 4) + cluster


def fps_registers(points_per_lane: int) -> int:
    """Registers a lane needs at ``points_per_lane`` (an estimate; the
    build's ``-Xptxas -v`` prints the count)."""
    return REGISTERS_PER_POINT * points_per_lane + REGISTERS_BESIDE


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


def launch_plan(xyz: torch.Tensor, npoint: int, start: torch.Tensor,
                plan: FpsPlan) -> torch.Tensor:
    """The kernel under an explicit ``plan`` (the wrapper passes
    :func:`fps_plan`'s; a smoke run times others beside it)."""
    B, N, _ = xyz.shape
    check(xyz, "xyz", torch.float32, (B, N, 3))
    check(start, "start", torch.int32, (B,))
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    KERNEL(ptr(xyz), ptr(start), B, N, npoint, *plan, ptr(out),
           stream_of(xyz))
    return out


def farthest_point_sample_cuda(xyz: torch.Tensor, npoint: int,
                               start: torch.Tensor) -> torch.Tensor:
    B, N, _ = xyz.shape
    return launch_plan(xyz, npoint, start, fps_plan(B, N))


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: torch.Tensor, *,
                          impl: str | None = None) -> torch.Tensor:
    if use_kernel(xyz, impl):
        return farthest_point_sample_cuda(
            xyz.float().contiguous(), npoint, start.int().contiguous()
        )
    return farthest_point_sample_plain(xyz, npoint, start)
