"""The port's ops (papc_tpu_torch.ops) against the JAX package, on the CPU.

Inputs come from one numpy seed and go to both packages in the same
process. Where the JAX function reaches a Pallas kernel it runs as the
JAX suite runs it here: its XLA path and the kernel with
``interpret=True``. FPS, ball query and the grouping gather must agree
EXACTLY (indices and gathered values); the eval MLP+max within the
tolerances stated at each test.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.ops import fused_mlp as jfused
from papc_tpu.ops import geometry as jgeom
from papc_tpu.ops import grouping as jgroup
from papc_tpu.ops import sampling as jsamp
from papc_tpu.ops.pallas.ball_query import query_ball_point_pallas
from papc_tpu.ops.pallas.fps import farthest_point_sample_pallas
from papc_tpu.ops.pallas.gather_t import gather_cols_pallas
from papc_tpu.ops.pallas.samlp import eval_mlp_max as jeval_mlp_max

from papc_tpu_torch.models import registry
from papc_tpu_torch.ops import fused_mlp, geometry, grouping, sampling
from papc_tpu_torch.ops.kernels import (ball_query, fps, gather, samlp,
                                        samlp_train, scatter_rows,
                                        scatter_sorted, use_kernel)

from tests import torch_parity as P

T = torch.from_numpy


def _cloud(rng, B, N, scale=0.5):
    return (rng.randn(B, N, 3) * scale).astype(np.float32)


def _queries(rng, xyz, S):
    """Queries taken from the cloud (new_xyz ⊆ xyz), as the model does and
    as tests/test_pallas_ball_query.py does."""
    qi = rng.choice(xyz.shape[1], size=(xyz.shape[0], S))
    return np.stack([xyz[b, qi[b]] for b in range(xyz.shape[0])])


# ------------------------------------------------------------------ FPS

@pytest.mark.parametrize("B,N,npoint,start", [
    (2, 128, 32, 0), (3, 200, 64, 7), (1, 64, 64, 5), (4, 96, 1, 0),
    (1, 16384, 64, 3),  # above the 12288 points the kernel once held
])
def test_fps_matches_xla_and_pallas(rng, B, N, npoint, start):
    xyz = _cloud(rng, B, N)
    want_xla = np.asarray(jsamp.farthest_point_sample(
        jnp.asarray(xyz), npoint, start_idx=start, backend="xla"))
    want_pl = np.asarray(farthest_point_sample_pallas(
        jnp.asarray(xyz), npoint, start, interpret=True))
    got = sampling.farthest_point_sample(T(xyz), npoint, start_idx=start)
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    np.testing.assert_array_equal(got.numpy(), want_xla)
    np.testing.assert_array_equal(got.numpy(), want_pl)


@pytest.mark.parametrize("B,N", [
    (32, 1024), (32, 512),  # SSG and MSG SA1 / SA2
    (4, 16384), (1, 65536),  # the JAX kernel's recorded shapes
    (1, 131072), (2, 33), (3, 1000), (2, 4097),
])
def test_fps_plan_owns_every_point_once(B, N):
    """The kernel's plan: every point owned exactly once, in ascending
    order over (rank, warp, lane, slot), by a launch the card takes."""
    plan = fps.fps_plan(B, N)
    warps, p, cluster = plan
    own = fps.fps_ownership(N, plan)
    assert own.shape == (cluster, warps, 32, p)
    flat = own.flatten()
    held = flat[flat >= 0]
    assert torch.equal(held, torch.arange(N))  # once each, ascending
    # padding only at the tail, and no rank without a point
    assert bool((flat[:N] >= 0).all()) and bool((flat[N:] < 0).all())
    assert all(bool((own[r] >= 0).any()) for r in range(cluster))
    assert p in fps.POINTS_PER_LANE
    assert 1 <= warps <= min(32, fps.MAX_WARPS[p])
    assert cluster == 1 and warps <= fps.BLOCK_WARPS or cluster > 1
    assert 1 <= cluster <= fps.MAX_CLUSTER == 16
    csrc = Path(fps.__file__).resolve().parents[2] / "csrc"
    if cluster > fps.PORTABLE_CLUSTER:  # the C side asks for more than 8
        assert "csize > kPortableCluster" in (csrc / "fps.cu").read_text()
        assert ("cudaFuncAttributeNonPortableClusterSizeAllowed"
                in (csrc / "common.cuh").read_text())
    assert fps.fps_smem_bytes(plan) <= fps.SMEM_PER_BLOCK == 232448
    regs = fps.fps_registers(p)
    assert regs <= fps.MAX_REGISTERS_PER_LANE
    assert regs * 32 * warps <= fps.REGISTERS_PER_SM


def test_fps_plan_takes_every_n_up_to_its_limit():
    """Every N up to 131072, twice the JAX kernel's largest recorded
    cloud, has a plan; above the limit the plan raises, naming it."""
    assert fps.POINT_LIMIT >= 131072
    for n in (1, 31, 32, 4096, 4097, 8192, 8193, 12289, 16384, 65536,
              100000, fps.POINT_LIMIT):
        w, p, c = fps.fps_plan(2, n)
        assert 32 * w * p * c >= n
    with pytest.raises(ValueError, match=str(fps.POINT_LIMIT)):
        fps.fps_plan(1, fps.POINT_LIMIT + 1)
    with pytest.raises(ValueError):
        fps.fps_plan(0, 16)


def test_fps_ties_take_first_occurrence():
    """Duplicated points make exact distance ties every round: both sides
    must take the first maximal index."""
    base = np.random.RandomState(3).randn(1, 16, 3).astype(np.float32)
    xyz = np.concatenate([base, base, base], axis=1)  # [1, 48, 3]
    want = np.asarray(jsamp.farthest_point_sample(
        jnp.asarray(xyz), 20, start_idx=0, backend="xla"))
    got = sampling.farthest_point_sample(T(xyz), 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_per_row_start_and_generator(rng):
    xyz = _cloud(rng, 3, 50)
    starts = np.array([4, 0, 49], np.int32)
    want = np.asarray(jsamp.farthest_point_sample(
        jnp.asarray(xyz), 8, start_idx=jnp.asarray(starts), backend="xla"))
    got = sampling.farthest_point_sample(T(xyz), 8, start_idx=T(starts))
    np.testing.assert_array_equal(got.numpy(), want)
    # a generator draws the start rows; explicit start_idx wins over it
    g1 = sampling.farthest_point_sample(
        T(xyz), 8, generator=torch.Generator().manual_seed(1))
    g2 = sampling.farthest_point_sample(
        T(xyz), 8, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(g1.numpy(), g2.numpy())
    fixed = sampling.farthest_point_sample(
        T(xyz), 8, generator=torch.Generator().manual_seed(1), start_idx=0)
    np.testing.assert_array_equal(
        fixed.numpy(), sampling.farthest_point_sample(T(xyz), 8).numpy())
    with pytest.raises(ValueError):
        sampling.farthest_point_sample(T(xyz), 8, start_idx=50)


# ------------------------------------------------------------ ball query

@pytest.mark.parametrize("B,N,S,nsample,radius", [
    (2, 256, 64, 8, 0.3),   # mixed fill levels
    (1, 300, 70, 16, 0.2),  # N, S off any tile size
    (2, 128, 32, 4, 3.0),   # every ball overfull
    (2, 200, 40, 32, 0.4),  # more slots than most balls hold
])
def test_ball_query_matches_xla_and_pallas(rng, B, N, S, nsample, radius):
    xyz = _cloud(rng, B, N)
    q = _queries(rng, xyz, S)
    want_xla = np.asarray(jgroup.query_ball_point(
        radius, nsample, jnp.asarray(xyz), jnp.asarray(q), backend="xla"))
    want_pl = np.asarray(query_ball_point_pallas(
        radius, nsample, jnp.asarray(xyz), jnp.asarray(q), interpret=True))
    got = grouping.query_ball_point(radius, nsample, T(xyz), T(q))
    assert got.dtype == torch.int32 and got.shape == (B, S, nsample)
    np.testing.assert_array_equal(got.numpy(), want_xla)
    np.testing.assert_array_equal(got.numpy(), want_pl)


def test_ball_query_empty_ball_clamps(rng):
    xyz = _cloud(rng, 1, 128)
    far = np.full((1, 16, 3), 100.0, np.float32)
    want = np.asarray(query_ball_point_pallas(
        0.5, 8, jnp.asarray(xyz), jnp.asarray(far), interpret=True))
    got = grouping.query_ball_point(0.5, 8, T(xyz), T(far))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == 127).all()


def test_ball_query_radius_is_inclusive():
    """A point exactly at distance r (r² representable) is inside, as in
    the reference's ``> r²`` exclusion mask."""
    xyz = np.zeros((1, 4, 3), np.float32)
    xyz[0, 1, 0] = 0.5
    xyz[0, 2, 0] = 0.75
    xyz[0, 3, 0] = 0.25
    q = xyz[:, :1]
    got = grouping.query_ball_point(0.5, 4, T(xyz), T(q))
    np.testing.assert_array_equal(got.numpy(), [[[0, 1, 3, 0]]])


# Every ball-query shape of the registry's models (SSG SA1 and SA2, MSG
# clas's six branches), the bench's 16k row, the edges of the whole-cloud
# staging, FPS's 64k and 131072-point clouds, and small ones.
BALL_PLAN_SHAPES = [(32, 1024, 512, 32), (32, 512, 128, 64),
                    (32, 1024, 512, 16), (32, 1024, 512, 128),
                    (32, 512, 128, 32), (32, 512, 128, 128),
                    (4, 16384, 2048, 32), (1, 19328, 700, 32),
                    (1, 19329, 700, 32), (1, 65536, 4096, 32),
                    (1, 131072, 512, 32), (2, 1000, 77, 16), (1, 50, 9, 48),
                    (3, 1024, 4096, 16), (1, 3, 1, 3)]


@pytest.mark.parametrize("b,n,s,k", BALL_PLAN_SHAPES)
def test_ball_query_plan_covers_every_query_once(b, n, s, k):
    """Mirror of the kernel's indexing: block x of ``warps`` warps takes
    queries ``(x % per_cloud) * warps * Q + w * Q + i`` of cloud ``x //
    per_cloud``; every query once (past S none). The staged points: the
    whole cloud padded to ``STEP`` points, or double-buffered tiles of a
    multiple of ``STEP`` that take every point once, within a block's
    shared memory, as the C entry sizes it."""
    p = ball_query.ball_query_plan(b, n, s, k)
    span = p.warps * p.queries
    per_cloud = -(-s // span)
    assert p.blocks == b * per_cloud
    taken = np.zeros((b, s), np.int64)
    for x in range(p.blocks):
        q = (x % per_cloud) * span + np.arange(span)
        taken[x // per_cloud, q[q < s]] += 1
    assert (taken == 1).all()
    tiled = p.tile < n
    assert p.tile == (ball_query.TILE_POINTS if tiled else n)
    assert p.smem == 12 * (2 if tiled else 1) * ball_query.pad_step(p.tile)
    assert p.smem <= ball_query.SMEM_LIMIT
    if tiled:
        assert p.tile % ball_query.STEP == 0
        points = np.zeros(n, np.int64)
        for t in range(-(-n // p.tile)):
            points[t * p.tile:(t + 1) * p.tile] += 1
        assert (points == 1).all()


def test_ball_query_plan_stages_whole_clouds_and_fills_the_card():
    """The SSG cloud (12 KB) and the 16k row's (192 KB) are staged whole,
    a 64k one in tiles; SA1, SA2 and the 16k row fill the card with 32
    warps a block, taking 4, 1 and 2 queries a warp; every N up to FPS's
    131072 points gets a plan."""
    sa1 = ball_query.ball_query_plan(32, 1024, 512, 32)
    sa2 = ball_query.ball_query_plan(32, 512, 128, 64)
    row16k = ball_query.ball_query_plan(4, 16384, 2048, 32)
    assert sa1.tile == 1024 and row16k.tile == 16384
    assert row16k.smem == 12 * 16384
    assert ball_query.ball_query_plan(1, 65536, 4096, 32).tile \
        == ball_query.TILE_POINTS
    for plan, q in ((sa1, 4), (sa2, 1), (row16k, 2)):
        assert plan.blocks >= ball_query.FILL_BLOCKS
        assert (plan.warps, plan.queries) == (32, q)
    for n in (1, 127, 128, 129, 1000, 16384, 19328, 19329, 65536, 131072):
        p = ball_query.ball_query_plan(2, n, 64, min(n, 32))
        assert p.smem <= ball_query.SMEM_LIMIT


# ---------------------------------------------------------- gather

@pytest.mark.parametrize("D", [0, 5, 128])
def test_group_gather_matches_sample_and_group(rng, D):
    B, N, npoint, nsample, radius = 2, 160, 24, 16, 0.4
    xyz = _cloud(rng, B, N)
    pts = rng.randn(B, N, D).astype(np.float32) if D else None
    want_xyz, want = jgroup.sample_and_group(
        npoint, radius, nsample, jnp.asarray(xyz),
        None if pts is None else jnp.asarray(pts))
    got_xyz, got = grouping.sample_and_group(
        npoint, radius, nsample, T(xyz), None if pts is None else T(pts))
    assert got.shape == (B, npoint, nsample, 3 + D)
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("C,N,S,K", [(3, 64, 16, 8), (131, 96, 12, 16)])
def test_group_gather_matches_gather_cols_pallas(rng, C, N, S, K):
    """The TPU kernel gathers channel-major ``[B, C, S·K]``; the port's
    row layout is its transpose, centring on the three xyz channels."""
    B = 2
    src = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(-3, N + 3, size=(B, S, K)).astype(np.int32)  # clamps
    new_xyz = rng.randn(B, S, 3).astype(np.float32)
    gathered_t = np.asarray(gather_cols_pallas(
        jnp.asarray(src.transpose(0, 2, 1)),
        jnp.asarray(idx.reshape(B, S * K)), t=128, interpret=True))
    want = gathered_t.transpose(0, 2, 1).reshape(B, S, K, C).copy()
    want[..., :3] -= new_xyz[:, :, None, :]
    xyz, feats = src[..., :3], (src[..., 3:] if C > 3 else None)
    got = gather.group_gather(T(np.ascontiguousarray(xyz)),
                              None if feats is None
                              else T(np.ascontiguousarray(feats)),
                              T(idx), T(new_xyz))
    np.testing.assert_array_equal(got.numpy(), want)


# The grouping gathers of the registry's SSG models: [B, S, K, C] at SA1
# (clas, seg / normal_channel) and SA2, cut to B = 2 where the plan does
# not change with B; then the edges: K * C off 4 (4-byte stores), D = 5,
# a span below one block, and K * C = 655 at D = 128.
GATHER_SHAPES = [(32, 512, 32, 3), (32, 512, 32, 6), (2, 128, 64, 131),
                 (2, 13, 7, 3), (3, 7, 32, 8), (1, 1, 5, 6), (2, 3, 5, 131)]


@pytest.mark.parametrize("b,s,k,c", GATHER_SHAPES)
def test_gather_plan_covers_every_row_and_channel_once(b, s, k, c):
    """Mirror of ``group_gather_kernel``'s second phase: each block's
    threads start at chunk ``vec * t`` of the block's span with one
    division and step by ``vec * THREADS`` elements as (rows, channels);
    each chunk's elements, wrapping into the next row, must be the span's
    consecutive elements, and the blocks must write every (row, channel)
    of the output once. 16-byte stores start on 16 bytes."""
    p = gather.gather_plan(b, s, k, c)
    groups = b * s
    assert p.vec == (4 if k * c % 4 == 0 else 1)
    assert p.smem == 16 * p.tile * k <= gather.SMEM_LIMIT
    assert p.blocks == -(-groups // p.tile)
    taken = np.zeros((groups * k, c), np.int64)
    g0 = np.arange(p.blocks)[:, None] * p.tile
    n_elems = np.minimum(p.tile, groups - g0) * k * c
    if p.vec == 4:
        assert (g0 * k * c % 4 == 0).all()
    step = p.vec * gather.THREADS
    step_r, step_c = divmod(step, c)
    e = np.broadcast_to(p.vec * np.arange(gather.THREADS)[None, :],
                        (p.blocks, gather.THREADS)).copy()
    r, col = np.divmod(e, c)
    while (e < n_elems).any():
        live = e < n_elems
        rr, cc = r.copy(), col.copy()
        for i in range(p.vec):
            wrap = cc == c
            cc, rr = np.where(wrap, 0, cc), np.where(wrap, rr + 1, rr)
            assert (rr * c + cc == e + i)[live].all()
            np.add.at(taken, ((g0 * k + rr)[live], cc[live]), 1)
            cc = cc + 1
        e = e + step
        r, col = r + step_r, col + step_c
        r, col = np.where(col >= c, r + 1, r), np.where(col >= c, col - c, col)
    assert (taken == 1).all()


def test_gather_plan_refuses_a_group_beyond_shared_memory():
    limit = gather.SMEM_LIMIT // 16
    assert gather.gather_plan(1, 1, limit, 3).tile == 1
    with pytest.raises(ValueError, match=f"at most {limit} rows"):
        gather.gather_plan(1, 1, limit + 1, 3)


def _inverse_index_numpy(idx, n):
    """The stable sort by point, built directly: each point's entries in
    ascending flat order, the lists one after the other."""
    b = idx.shape[0]
    flat = np.clip(idx.reshape(b, -1), 0, n - 1)
    offsets = np.zeros((b, n + 1), np.int64)
    order = np.zeros(flat.shape, np.int64)
    for i in range(b):
        pos = 0
        for j in range(n):
            mine = [e for e in range(flat.shape[1]) if flat[i, e] == j]
            order[i, pos:pos + len(mine)] = mine
            pos += len(mine)
            offsets[i, j + 1] = pos
    return offsets, order


def _scatter_idx(rng, kind, b, s, k, n):
    if kind == "range":  # indices outside [0, n) clamp
        return rng.randint(-3, n + 3, size=(b, s, k)).astype(np.int32)
    if kind == "one point":  # one list of all s * k entries, the rest empty
        return np.full((b, s, k), n // 2, np.int32)
    return rng.randint(0, max(1, n // 3), size=(b, s, k)).astype(np.int32)


SCATTER_CASES = [(2, 9, 4, 20, "range"), (3, 5, 8, 7, "one point"),
                 (2, 6, 16, 40, "part")]


@pytest.mark.parametrize("b,s,k,n,kind", SCATTER_CASES)
def test_inverse_index_plain_matches_numpy(rng, b, s, k, n, kind):
    idx = _scatter_idx(rng, kind, b, s, k, n)
    offsets, order = gather.inverse_index_plain(T(idx), n)
    want_offsets, want_order = _inverse_index_numpy(idx, n)
    assert offsets.dtype == order.dtype == torch.int32
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    np.testing.assert_array_equal(order.numpy(), want_order)


@pytest.mark.parametrize("c", [3, 5, 131])
@pytest.mark.parametrize("b,s,k,n,kind", SCATTER_CASES)
def test_scatter_through_the_inverse_index_matches_plain(rng, b, s, k, n,
                                                         kind, c):
    """Both add a point's rows in ascending flat order into zeros: on the
    CPU, where index_add_ runs in index order, the same bits."""
    idx = _scatter_idx(rng, kind, b, s, k, n)
    g = T(rng.randn(b, s, k, c).astype(np.float32))
    offsets, order = gather.inverse_index_plain(T(idx), n)
    got = gather.scatter_add_sorted_plain(g, offsets, order, n)
    np.testing.assert_array_equal(
        got.numpy(), gather.scatter_add_plain(g, T(idx), n).numpy())


# The SSG step's scatter (SA2: 512 points, 128 x 64 entries, C = 131),
# with the C of each grouped width, and the N edges of the index's warps.
SCATTER_PLAN_SHAPES = [(32, 512, 128, 64, 131), (2, 512, 128, 64, 3),
                       (2, 1024, 512, 32, 6), (2, 50, 7, 8, 5),
                       (2, 33, 3, 5, 259), (1, 1, 1, 1, 17),
                       (2, 1760, 9, 7, 33), (2, 1761, 9, 7, 16),
                       (1, gather.SCATTER_N_LIMIT, 40, 64, 8)]


@pytest.mark.parametrize("b,n,s,k,c", SCATTER_PLAN_SHAPES)
def test_scatter_add_plan_takes_every_entry_and_row_once(b, n, s, k, c):
    """Mirror of the two kernels' indexing. The inverse index: warp w of
    a cloud's block takes the w-th contiguous chunk of entries, 32 at a
    time; every entry once. The sum: ``lanes`` threads a row, lane ``sub``
    channels ``sub + lanes * i`` (i < chans) a walk, the walks stepping
    by lanes x chans; every (row, channel) once. The index's shared
    memory stays within a block's."""
    _check_sorted_plan(gather.scatter_add_plan(b, n, s, k, c), b, n, s * k,
                       c)


def _check_sorted_plan(p, b, n, entries, c):
    assert p.smem == gather.index_smem(p.warps, n) <= gather.SMEM_LIMIT
    assert p.warps == max(w for w in gather.INDEX_WARPS
                          if gather.index_smem(w, n) <= gather.SMEM_LIMIT)
    taken = np.zeros(entries, np.int64)
    chunk = -(-entries // p.warps)
    for w in range(p.warps):
        lo = min(w * chunk, entries)
        hi = min(lo + chunk, entries)
        for base in range(lo, hi, 32):
            e = base + np.arange(32)
            taken[e[e < hi]] += 1
    assert (taken == 1).all()

    assert p.lanes in (4, 8, 16, 32) and 1 <= p.chans <= gather.MAX_CHANS
    assert p.lanes == 32 or (p.chans == 1 and c <= p.lanes)
    per_block = gather.sum_rows(p.lanes)
    assert p.blocks == b * -(-n // per_block)
    cells = np.zeros((b, n, c), np.int64)
    for cloud in range(b):
        for j0 in range(0, n, per_block):  # blockIdx.x; blockIdx.y = cloud
            rows = np.arange(j0, min(j0 + per_block, n))
            for sub in range(p.lanes):  # worker r merges block row r
                for c0 in range(0, c, p.lanes * p.chans):
                    ch = c0 + sub + p.lanes * np.arange(p.chans)
                    ch = ch[ch < c]
                    cells[cloud, rows[:, None], ch[None, :]] += 1
    assert (cells == 1).all()


@pytest.mark.parametrize("lanes", [4, 32])
@pytest.mark.parametrize("kind", ["range", "one point", "part", "ball"])
def test_sum_schedule_takes_every_entry_once_and_merges_in_order(
        rng, kind, lanes):
    """``scatter_sum_kernel``'s split of a block's entries over its
    workers, on lists as skewed as ball-query padding makes them: every
    entry in one worker's range; a row written once, whole by the worker
    that walked all of it (a sequential fold: the plain bits) or by the
    merge from the partials of consecutive workers in order; and that
    arithmetic, emulated in f32, within 1e-5 of plain's largest (a merged
    row adds in another order)."""
    b, s, k, n = 2, 16, 32, 96
    if kind == "ball":  # a few points take most entries, as padding does
        idx = np.where(rng.rand(b, s, k) < 0.7, rng.randint(0, 3, (b, s, k)),
                       rng.randint(0, n, (b, s, k))).astype(np.int32)
    else:
        idx = _scatter_idx(rng, kind, b, s, k, n)
    g = rng.randn(b, s * k).astype(np.float32)
    offsets, order = gather.inverse_index_plain(T(idx), n)
    offsets, order = offsets.numpy(), order.numpy()
    want = gather.scatter_add_plain(T(g.reshape(b, s, k, 1)), T(idx),
                                    n).numpy()[..., 0]
    workers = gather.THREADS // lanes
    scale = 1e-5 * np.abs(want).max()  # as the card's tolerance
    for cloud in range(b):
        taken = np.zeros(s * k, np.int64)
        rows = gather.sum_rows(lanes)
        for j0 in range(0, n, rows):
            offs = [int(o) for o in offsets[cloud, j0:min(j0 + rows, n) + 1]]
            ranges, writers = gather.sum_schedule(offs, workers)
            for lo, hi in ranges:
                taken[lo:hi] += 1
            for r, who in enumerate(writers):
                lo, hi = offs[r], offs[r + 1]
                assert all(ranges[w][0] < hi and lo < ranges[w][1]
                           for w in who)
                assert (hi == lo) == (len(who) == 0)
                total = np.float32(0)
                for w in who:  # each worker's part in order, then merged
                    part = np.float32(0)
                    for e in order[cloud, max(lo, ranges[w][0]):
                                   min(hi, ranges[w][1])]:
                        part = np.float32(part + g[cloud, e])
                    total = part if w == who[0] else np.float32(total + part)
                if len(who) <= 1:
                    assert total == want[cloud, j0 + r]
                np.testing.assert_allclose(total, want[cloud, j0 + r],
                                           rtol=0, atol=scale)
        assert (taken == 1).all()


# #5's index sets at every registry shape (B=32): MSG clas SA2's three
# branches and MSG seg SA2's two (K 32/64/128 rows of 128 centres into
# 512 points, C = 323), and the two 3-NN interpolations of both
# segmentation models (FP1: 512 x 3 rows into 128, C = 256; FP0: 1024 x 3
# into 512, C = 128).
ROW_PLAN_SHAPES = [(128 * 32, 323, 512), (128 * 64, 323, 512),
                   (128 * 128, 323, 512), (512 * 3, 256, 128),
                   (1024 * 3, 128, 512)]


@pytest.mark.parametrize("r,c,n", ROW_PLAN_SHAPES)
def test_scatter_rows_plan_takes_every_entry_and_row_once(r, c, n):
    """#5's plan at every registry shape, mirrored as #4's: the inverse
    index takes every one of a cloud's R entries once (R up to 16384, the
    MSG clas SA2 branch at K = 128), the sum every (row, channel) once
    (two clouds mirrored; a cloud's plan does not depend on B)."""
    p32 = scatter_sorted.sorted_plan(32, n, r, c)
    p = scatter_sorted.sorted_plan(2, n, r, c)
    assert p32[:4] == p[:4] and p32.blocks == 16 * p.blocks
    _check_sorted_plan(p, 2, n, r, c)


def test_scatter_rows_plan_raises_above_its_row_limit():
    limit = scatter_sorted.SCATTER_N_LIMIT
    assert scatter_sorted.sorted_plan(1, limit, 8, 3).warps == 4
    with pytest.raises(ValueError, match=f"at most {limit} points"):
        scatter_sorted.sorted_plan(1, limit + 1, 8, 3)


def _row_idx(rng, kind, b, r, n):
    if kind == "outside":  # a third of the indices outside [0, n)
        return rng.randint(-n // 2, n + n // 2, size=(b, r)).astype(np.int32)
    if kind == "none":  # no index in range: every list empty
        return np.where(rng.rand(b, r) < 0.5, -1 - rng.randint(0, 9, (b, r)),
                        n + rng.randint(0, 9, (b, r))).astype(np.int32)
    # ball-query padding: runs of a group's first index
    idx = rng.randint(0, n, size=(b, r // 8, 1)).repeat(8, axis=2)
    idx[..., 5:] = rng.randint(0, 3, idx[..., 5:].shape)
    return idx.reshape(b, r).astype(np.int32)


@pytest.mark.parametrize("kind", ["outside", "none", "padding"])
def test_row_inverse_index_drops_out_of_range(rng, kind):
    """The drop-policy index equals a numpy stable sort of each cloud's
    in-range entries: ``offsets[:, n]`` the in-range count, ``order`` up
    to it the in-range entries by index, ascending within an index."""
    b, r, n = 3, 96, 20
    idx = _row_idx(rng, kind, b, r, n)
    offsets, order = scatter_sorted.inverse_index_plain(T(idx), n, drop=True)
    assert offsets.dtype == order.dtype == torch.int32
    for i in range(b):
        keep = np.flatnonzero((idx[i] >= 0) & (idx[i] < n))
        want = keep[np.argsort(idx[i, keep], kind="stable")]
        counts = np.bincount(idx[i, keep], minlength=n)
        np.testing.assert_array_equal(offsets[i].numpy(),
                                      np.concatenate([[0], counts.cumsum()]))
        assert int(offsets[i, n]) == len(keep)
        np.testing.assert_array_equal(order[i, :len(keep)].numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["outside", "none", "padding"])
def test_row_scatter_through_the_inverse_index_matches_plain(rng, kind,
                                                             dtype):
    """#5's list-order sum through the drop-policy index equals
    ``scatter_rows_add_plain`` within 1e-5 of its largest, for an f32 and
    a bf16 g (both widened to f32 exactly, summed in f32)."""
    b, r, n, c = 3, 96, 20, 37
    idx = T(_row_idx(rng, kind, b, r, n))
    g = T(rng.randn(b, r, c).astype(np.float32)).to(dtype)
    offsets, order = scatter_sorted.inverse_index_plain(idx, n, drop=True)
    got = scatter_sorted.scatter_add_sorted_plain(g, offsets, order, n)
    want = scatter_rows.scatter_rows_add_plain(g, idx, n)
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    scale = max(float(want.abs().max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * scale)
    if kind == "none":
        assert not got.any()


def test_scatter_add_plan_raises_above_its_n_limit():
    """Every N up to the limit fits a block's shared memory, at least
    ``INDEX_WARPS[-1]`` warps; one more raises, naming the limit."""
    limit = gather.SCATTER_N_LIMIT
    for n in range(1, limit + 1):
        assert gather.index_smem(gather.INDEX_WARPS[-1], n) \
            <= gather.SMEM_LIMIT
    assert gather.scatter_add_plan(1, limit, 1, 1, 3).warps == 4
    with pytest.raises(ValueError, match=f"at most {limit} points"):
        gather.scatter_add_plan(1, limit + 1, 1, 1, 3)


def test_index_points_and_square_distance(rng):
    pts = rng.randn(3, 40, 7).astype(np.float32)
    idx = rng.randint(-2, 43, size=(3, 5, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        geometry.index_points(T(pts), T(idx)).numpy(),
        np.asarray(jgeom.index_points(jnp.asarray(pts), jnp.asarray(idx))))
    a, b = _cloud(rng, 2, 30), _cloud(rng, 2, 20)
    # same expansion, both in full f32; summation order differs at ulp level
    np.testing.assert_allclose(
        geometry.square_distance(T(a), T(b)).numpy(),
        np.asarray(jgeom.square_distance(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-6)


def test_sample_and_group_all(rng):
    xyz, pts = _cloud(rng, 2, 32), rng.randn(2, 32, 4).astype(np.float32)
    for p in (None, pts):
        want_xyz, want = jgroup.sample_and_group_all(
            jnp.asarray(xyz), None if p is None else jnp.asarray(p))
        got_xyz, got = grouping.sample_and_group_all(
            T(xyz), None if p is None else T(p))
        np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- eval MLP + max

def _mlp_case(rng, m_groups, k, c0, widths):
    """Grouped input and per-layer (W, b, gamma, beta, mean, var) with
    non-trivial running statistics, as converted weights carry."""
    x = rng.randn(m_groups * k, c0).astype(np.float32)
    layers = []
    cin = c0
    for c in widths:
        layers.append((
            (rng.randn(cin, c) / np.sqrt(cin)).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32),
            (1.0 + 0.2 * rng.randn(c)).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32),
            rng.uniform(0.5, 2.0, c).astype(np.float32),
        ))
        cin = c
    return x, layers


def _jax_vecs(layers, eps=1e-5):
    import jax

    vecs = []
    for _, _, g, be, mu, var in layers:
        inv = jax.lax.rsqrt(jnp.asarray(var) + eps)
        scale = jnp.asarray(g) * inv
        vecs.append(jnp.stack([scale, jnp.asarray(be) - jnp.asarray(mu) * scale]))
    return vecs


def _port(x, layers, k, operand_dtype, impl=None):
    params = [(T(w), T(b), T(g), T(be)) for w, b, g, be, _, _ in layers]
    running = [(T(mu), T(var)) for *_, mu, var in layers]
    b_, s_ = 1, x.shape[0] // k
    grouped = T(x).reshape(b_, s_, k, x.shape[1])
    return fused_mlp.fused_mlp_max(grouped, params, running, impl=impl,
                                   operand_dtype=operand_dtype)[0].numpy()


MLP_CASES = [
    (16, 8, 6, (16, 32)),          # tiny
    (24, 16, 3, (64, 64, 128)),    # SA1's widths, short K
    (8, 32, 131, (128, 128, 256)), # SA2's widths
]


@pytest.mark.parametrize("m_groups,k,c0,widths", MLP_CASES)
def test_eval_mlp_f32_matches_jnp_twin(rng, m_groups, k, c0, widths):
    """f32 operands on both sides: the same arithmetic up to f32
    summation order in the products -> rtol/atol 1e-5."""
    x, layers = _mlp_case(rng, m_groups, k, c0, widths)
    want = np.asarray(jfused._jnp_eval_mlp_max(
        jnp.asarray(x), _jax_vecs(layers), [jnp.asarray(l[0]) for l in layers],
        [jnp.asarray(l[1]) for l in layers], k=k))
    got = _port(x, layers, k, torch.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m_groups,k,c0,widths", MLP_CASES)
def test_eval_mlp_bf16_matches_fused_jnp_and_pallas(rng, m_groups, k, c0,
                                                    widths):
    """bf16 operands (the production contract) vs
    ``fused_mlp_max(train=False, impl='jnp')`` and the Pallas
    ``eval_mlp_max`` in interpret mode. Tolerance 1e-2 (abs and rel): the
    products are exact in f32 but summed in another order, and a sum that
    lands next to a bf16 rounding boundary rounds the other way for the
    next layer (one bf16 ulp is 2^-8 relative)."""
    x, layers = _mlp_case(rng, m_groups, k, c0, widths)
    params = tuple((jnp.asarray(w), jnp.asarray(b), jnp.asarray(g),
                    jnp.asarray(be)) for w, b, g, be, _, _ in layers)
    running = tuple((jnp.asarray(mu), jnp.asarray(var))
                    for *_, mu, var in layers)
    grouped = jnp.asarray(x).reshape(1, m_groups, k, x.shape[1])
    want_jnp, _ = jfused.fused_mlp_max(grouped, params, running,
                                       train=False, eps=1e-5, impl="jnp")
    want_pl = jeval_mlp_max(
        jnp.asarray(x).astype(jnp.bfloat16), _jax_vecs(layers),
        [p[0] for p in params], [p[1] for p in params], k=k, interpret=True)
    got = _port(x, layers, k, torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want_jnp)[0], rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(got, np.asarray(want_pl), rtol=1e-2,
                               atol=1e-2)


def test_eval_mlp_override_and_kernel_guard(rng):
    x, layers = _mlp_case(rng, 4, 8, 6, (16,))
    want = _port(x, layers, 8, torch.float32)
    with fused_mlp.override(impl="plain", operand_dtype=torch.float32):
        got = _port(x, layers, 8, None)
    np.testing.assert_array_equal(got, want)
    assert fused_mlp._OVERRIDE["operand_dtype"] == torch.bfloat16
    with pytest.raises(ValueError, match="at least one layer"):
        fused_mlp.fused_mlp_max(T(x).reshape(1, 4, 8, 6), [], [], train=True)


@pytest.mark.parametrize("layout", ["linear_t", "bf16", "f64"])
def test_eval_mlp_takes_weights_as_held(rng, layout):
    """W as a transposed view (the model passes ``Linear.weight.t()``), in
    bf16 or in f64 gives the same bits as contiguous f32 W: each is
    rounded once to the same bf16 operand, as the card test holds the
    kernel to."""
    x, layers = _mlp_case(rng, 6, 8, 20, (24, 40))
    x = T(x)
    ws = [T(l[0]) for l in layers]
    vecs = [[T(l[i]) for l in layers] for i in (1, 2, 3)]
    held = {"linear_t": [w.t().contiguous().t() for w in ws],
            "bf16": [w.bfloat16() for w in ws],
            "f64": [w.double() for w in ws]}[layout]
    want = samlp.eval_mlp_max(x, ws, *vecs, k=8)
    assert torch.equal(samlp.eval_mlp_max(x, held, *vecs, k=8), want)


def test_samlp_tile_and_shared_memory_plan():
    """The kernel's block plan: a row tile of 32, 64 or 128 rows, the
    largest that fits the 227 KB a block may opt into on the H100 and
    still gives one block per SM (SSG SA1 and SA2 at 128 rows, SA3 at 32
    rows, 128 blocks); whole K-groups per block or a group spread over
    k / tm blocks; shared memory as ``smem_layout`` counts it. A stack
    that fits no tile raises; a k that neither divides the tile nor is a
    multiple of it is planned with the straddling blocks' slots."""
    for k in (16, 32, 64, 128):
        for tm in samlp.TILE_ROWS:
            assert tm % k == 0 or k % tm == 0
    ssg = [(524288, 3, (64, 64, 128), 32, 128),
           (262144, 131, (128, 128, 256), 64, 128),
           (4096, 259, (256, 512, 1024), 128, 32)]
    for m, c0, widths, k, tm in ssg:
        p = samlp.plan(m, c0, widths, k)
        assert p["tm"] == tm and p["blocks"] == -(-m // tm)
        assert p["smem"] == samlp.smem_layout(c0, widths, k, tm)[2] <= 232448
        assert p["ld_x"] % 8 == 0 and p["ld_y"] % 8 == 0
    # fewer rows than a wave: the smallest tile; a tight limit: a smaller one
    assert samlp.plan(640, 259, (256, 512, 1024), 128)["tm"] == 32
    assert samlp.plan(524288, 131, (128, 128, 256), 64,
                      limit=100000)["tm"] == 64
    with pytest.raises(ValueError, match="shared memory"):
        samlp.plan(4096, 259, (256, 512, 1024), 128, limit=100000)
    assert samlp.pool_slots(128, 32) == 4 and samlp.pool_slots(32, 128) == 1
    assert samlp.pool_slots(32, 24) == 3  # a bound: 32 rows meet <= 3 groups
    ld_x, ld_y, _ = samlp.smem_layout(3, (16,), 8, 32)
    assert (ld_x, ld_y) == (24, 0)


# Each registry stack's (tm, blocks, shared-memory bytes) at B=32 x 1024,
# in stack order (``torch_parity.stack_shapes``).
EVAL_PLANS = {
    ("pointnet2_ssg", "clas"): [(128, 4096, 68096), (128, 2048, 108032),
                                (32, 128, 175616)],
    ("pointnet2_msg", "clas"): [(128, 2048, 50176), (128, 4096, 68096),
                                (128, 16384, 75136), (128, 1024, 137728),
                                (128, 2048, 157184), (128, 4096, 156160),
                                (32, 128, 184832)],
    ("pointnet2_ssg", "seg"): [(128, 4096, 68096), (128, 2048, 108032),
                               (32, 128, 175616)],
    ("pointnet2_msg", "seg"): [(128, 4096, 49152), (128, 8192, 67072),
                               (128, 16384, 75136), (128, 2048, 157184),
                               (128, 4096, 157120), (32, 128, 176640)],
}


@pytest.mark.parametrize("combo", sorted(EVAL_PLANS), ids="-".join)
def test_samlp_eval_plan_of_every_registry_stack(combo):
    """The eval kernel's plan at every fused SA stack of the registry's
    PointNet++ models (B=32 x 1024), pinned: within the 232 448 B a block
    may opt into, whole groups per block or a group over k / tm blocks,
    every group_all SA3 (4096 rows) spread over 128 blocks of 32 rows."""
    spec = registry.init_model(*combo, device="cpu")
    got = []
    for stage, m, k, c0, widths in P.stack_shapes(spec.model):
        p = samlp.plan(m, c0, widths, k)
        assert p["smem"] <= 232448
        assert p["tm"] % k == 0 or k % p["tm"] == 0
        if m == 4096:
            assert stage.startswith("SetAbstraction_") and p["blocks"] == 128
        got.append((p["tm"], p["blocks"], p["smem"]))
    assert got == EVAL_PLANS[combo]


# ------------------------------------------------------------ dispatch

def test_cpu_tensors_take_the_plain_version(rng):
    xyz = T(_cloud(rng, 1, 32))
    before = [m.KERNEL.launches for m in (fps, ball_query, gather, samlp)]
    sampling.farthest_point_sample(xyz, 4)
    assert not use_kernel(xyz, None) and not use_kernel(xyz, "plain")
    with pytest.raises(ValueError):
        use_kernel(xyz, "kernel")  # None already means the kernel on CUDA
    with pytest.raises(ValueError):
        use_kernel(xyz.to("meta"), None)  # neither CPU nor CUDA
    assert [m.KERNEL.launches
            for m in (fps, ball_query, gather, samlp)] == before


SSG_TRAIN_LAYERS = [  # (M, Cin, Cout) of every SSG layer at B=32
    (524288, 3, 64), (524288, 64, 64), (524288, 64, 128),
    (262144, 131, 128), (262144, 128, 128), (262144, 128, 256),
    (4096, 259, 256), (4096, 256, 512), (4096, 512, 1024)]
MSG_TRAIN_LAYERS = [  # MSG: K = 16, c0 = 323, width 196, c0 = 643
    (262144, 3, 32), (524288, 323, 128), (524288, 128, 196),
    (524288, 196, 256), (4096, 643, 256)]


def test_training_kernel_plans_at_the_ssg_shapes():
    """The training kernels' plans at every SSG layer (B=32) and the MSG
    layers of the card tests: linear_stats' shared memory within the 227 KB
    a block may opt into and equal to ``_ls_smem``, 2, 4 or 8 product warps
    on 32-row warp tiles, a block on every SM (two where they fit); the da + dh pass's row tiles
    cover ``m_pad`` once, its Cin splits cover the Cin tiles, its grid
    fills the SMs wherever the layer has enough rows and tiles, and its
    shared memory fits at every layer (Cin 512 / Cout 1024, the odd-Cin dg
    layers 131, 259, 323 and 643 included); the dW product's row splits
    cover every row once in whole chunks, its ring fits, its grid has a
    block for each of the 132 SMs, and its f32 partials move no more
    bytes than its operands (a_prev and da read once)."""
    for m, cin, cout in SSG_TRAIN_LAYERS + MSG_TRAIN_LAYERS:
        plan = samlp_train.linear_stats_plan(m, cin, cout)
        assert plan["smem"] <= 232448
        assert plan["smem"] == samlp_train._ls_smem(
            cin, plan["rw"], plan["cw"], plan["wp"], plan["stages"])
        assert plan["rw"] * plan["cw"] in (2, 4, 8)
        assert plan["wp"] in (1, 2, 4) and plan["stages"] in (2, 3)
        assert plan["tm"] == 32 * plan["rw"]
        assert plan["tn"] == 16 * plan["wp"] * plan["cw"]
        assert plan["cin_p"] % 16 == 0 and plan["cout_p"] % 16 == 0
        # every SM busy at every layer of the models (their M are large)
        assert plan["blocks"] == 132 * plan["resident"]
        assert plan["resident"] * (plan["smem"] + 1024) <= 233472
        assert plan["groups"] == -(-plan["blocks"] // plan["col_tiles"])
        with_dg = samlp_train.bwd_layer_plan(m, cin, cout, first=True)
        for first, need in ((False, True), (True, True), (True, False)):
            bw = samlp_train.bwd_layer_plan(m, cin, cout, need_dprev=need,
                                            first=first)
            if first:  # one row tiling with and without dg: db's sum order
                assert bw["dh_tm"] == with_dg["dh_tm"]
            assert bw["dh_smem"] <= 232448
            assert bw["dh_smem"] == samlp_train._da_dh_smem(
                bw["dh_rw"], cin, cout, gate=not first,
                tiles_per_split=bw["dh_tiles_per_split"])
            assert bw["dh_rw"] in (1, 2, 4, 8)
            assert bw["dh_tm"] == 32 * bw["dh_rw"]
            assert bw["dh_tn"] == 64 * 8 // bw["dh_rw"]
            assert bw["dh_tiles"] * bw["dh_tm"] == bw["m_pad"] >= m
            assert bw["dh_n_tiles"] == -(-bw["cin_p"] // bw["dh_tn"])
            per, splits = bw["dh_tiles_per_split"], bw["dh_splits"]
            if need:
                assert (splits - 1) * per < bw["dh_n_tiles"] <= splits * per
                # 128 blocks wherever the layer has as many (row tile,
                # Cin tile) pairs: SA3's 4096 rows split Cin
                assert bw["dh_tiles"] * splits >= min(
                    128, bw["dh_tiles"] * bw["dh_n_tiles"])
            else:
                assert splits == 1
        assert bw["dh_v"] == (8 if cout % 8 == 0 else 4)
        assert bw["splits"] * bw["rows_per_split"] >= m
        assert (bw["splits"] - 1) * bw["rows_per_split"] < m
        assert bw["rows_per_split"] % 32 == 0
        assert bw["rows_per_split"] % bw["dw_rows"] == 0
        assert bw["m_pad"] % bw["dw_rows"] == 0  # chunks stay inside m_pad
        assert bw["dw_rows"] % (16 * bw["dw_wk"]) == 0
        assert bw["dw_wm"] * bw["dw_wn"] * bw["dw_wk"] <= 16
        assert bw["dw_smem"] <= 232448
        assert bw["dw_tiles"] * bw["splits"] >= 132
        operand = 2 * m * cin + 2 * bw["m_pad"] * bw["cout_p"]
        assert 4 * bw["splits"] * bw["cin_p"] * bw["cout_p"] <= operand


def _last_layers():
    """``(m, C, k)`` of the last layer of every SSG and MSG stack of the
    registry (B=32 x 1024), each once."""
    out = []
    for combo in sorted(EVAL_PLANS):
        spec = registry.init_model(*combo, device="cpu")
        for _, m, k, _, widths in P.stack_shapes(spec.model):
            if (m, widths[-1], k) not in out:
                out.append((m, widths[-1], k))
    return out


# C = 4 (mod 8) and odd C, fewer groups than a block takes, and k from 8
# to 128 (k = 33: a split that must leave no slice empty)
PASS_PLAN_EDGES = [(999 * 8, 196, 8), (8 * 8, 37, 8), (3 * 16, 128, 16),
                   (2 * 32, 40, 32), (5 * 64, 24, 64), (7 * 128, 37, 128),
                   (5 * 128, 1024, 128), (4 * 33, 256, 33)]


def _finalize_cover(m, c, k):
    """Mirror of ``finalize_max_kernel``'s indexing: the (group, chunk,
    row) reads of every live thread, each thread's block, and the
    blocks."""
    p = samlp_train.finalize_plan(m, c, k)
    groups, lanes, slices, rows = m // k, p["lanes"], p["slices"], p["rows"]
    chunks = c // p["v"]
    b = np.arange(p["blocks"])[:, None]
    t = np.arange(256)[None, :]
    s, gi = (t // lanes) % slices, t // (lanes * slices)
    g = (b // p["ranges"]) * p["groups"] + gi
    j = (b % p["ranges"]) * lanes + t % lanes
    live = (g < groups) & (j < chunks)
    return (p, g, j, np.broadcast_to(s, g.shape), live,
            np.broadcast_to(b, g.shape))


@pytest.mark.parametrize("m,c,k", _last_layers() + PASS_PLAN_EDGES)
def test_finalize_and_seed_plans_cover_every_element_once(m, c, k):
    """The plans of the two per-column passes as their kernels walk them.

    finalize_max: 16-byte chunks where C % 8 == 0 (8 bytes where C = 4 mod
    8, a value where C is odd); every (group, chunk, slice) taken by one
    live thread, all slices of a (group, chunk) in one block (their merge
    is in shared memory), and the slices' row ranges cut k with none empty,
    so every row of every group is read once in each chunk. bwd_seed: the
    blocks' spans write every dy element once (the phase-2 walk stepped
    without division, as the kernel does, on a few blocks), each group's
    sums added by exactly one block (the one with its first row), a k that
    fits a key's 16 bits, shared memory without an opt-in. SA3 (and every
    4096-row stack) takes at least one block an SM in both."""
    groups = m // k
    p, g, j, s, live, blk = _finalize_cover(m, c, k)
    v = 8 if c % 8 == 0 else 4 if c % 4 == 0 else 1
    assert p["v"] == v and p["lanes"] * p["slices"] <= 256
    assert 256 % (p["lanes"] * p["slices"]) == 0
    chunks = c // v
    key = (g[live] * chunks + j[live]) * p["slices"] + s[live]
    assert np.array_equal(np.sort(key), np.arange(groups * chunks
                                                  * p["slices"]))
    home = np.full(groups * chunks, -1)
    home[g[live] * chunks + j[live]] = blk[live]
    assert (home[g[live] * chunks + j[live]] == blk[live]).all()
    starts = np.arange(p["slices"]) * p["rows"]
    assert starts[-1] < k <= starts[-1] + p["rows"]  # none empty, k covered
    if p["slices"] > 1:
        assert p["rows"] >= 4
    if m == 4096:
        assert p["blocks"] >= 132

    q = samlp_train.seed_plan(m, c, k)
    assert q["v"] == v and k < 0xFFFF and q["smem"] <= 48 * 1024
    tile, rows, splits = q["tile"], q["rows"], q["splits"]
    assert rows == k or tile == 1
    assert q["tiles"] == -(-groups // tile) and splits == -(-k // rows)
    assert q["blocks"] == q["tiles"] * splits
    written = np.zeros(m, dtype=np.int64)  # dy rows, by the spans
    sums = np.zeros(groups, dtype=np.int64)
    for b in range(q["blocks"]):
        g0 = (b // splits) * tile
        ng = min(tile, groups - g0)
        r0 = (b % splits) * rows
        r1 = min(k, r0 + rows)
        assert ng >= 1 and r1 > r0
        if r0 == 0:
            sums[g0:g0 + ng] += 1
        for gl in range(ng):
            written[(g0 + gl) * k + r0:(g0 + gl) * k + r1] += 1
    assert (written == 1).all() and (sums == 1).all()
    for b in {0, q["blocks"] // 2, q["blocks"] - 1}:
        g0 = (b // splits) * tile
        ng = min(tile, groups - g0)
        r0 = (b % splits) * rows
        nr = min(k, r0 + rows) - r0
        seen = []
        for t in range(256):  # the kernel's walk, stepped as it is
            drow, dj = 256 // chunks, 256 % chunks
            row, jj = t // chunks, t % chunks
            gl, r = row // nr, row % nr
            while row < ng * nr:
                assert (gl, r) == divmod(row, nr)
                seen.append(row * chunks + jj)
                row, r, jj = row + drow, r + drow, jj + dj
                if jj >= chunks:
                    jj, row, r = jj - chunks, row + 1, r + 1
                while r >= nr:
                    r, gl = r - nr, gl + 1
        assert sorted(seen) == list(range(ng * nr * chunks))
    if m == 4096:
        assert q["blocks"] >= 132


@pytest.mark.parametrize("m,cin,cout", SSG_TRAIN_LAYERS + MSG_TRAIN_LAYERS + [
    (4096, 515, 256), (131072, 323, 64), (2097152, 64, 96), (256, 7, 24),
    (1000, 3, 64), (2000, 643, 256), (999, 128, 196), (333, 64, 24)])
def test_linear_stats_plan_takes_every_product_once(m, cin, cout):
    """The linear_stats kernel's decomposition as ``linear_stats_kernel``
    walks it: block b on column tile ``b % col_tiles`` and group ``b //
    col_tiles`` of the blocks on it, which takes the row tiles ``g, g +
    groups, ...``; warps (wr, wc) on 32 x ``16 wp`` warp tiles that skip
    columns past ``cout_p``; Cin in k16 steps, two a slice. Every row
    tile is taken once on every column tile, every (row, column) of a tile
    by one warp, every Cin channel once; the column tiles cover ``cout_p``
    once; every row of the partials is written once (by its block, or
    zeroed by the column tile's first); W's slice is held whole in shared
    memory, within 232 448 B; SA3's 4096 rows take a block on every SM."""
    p = samlp_train.linear_stats_plan(m, cin, cout)
    tm, tn, wcols = p["tm"], p["tn"], 16 * p["wp"]
    rw, cw, tiles_n, blocks = p["rw"], p["cw"], p["col_tiles"], p["blocks"]
    cin_p, cout_p = p["cin_p"], p["cout_p"]
    row_tiles = -(-m // tm)
    assert (tiles_n - 1) * tn < cout_p <= tiles_n * tn
    assert tiles_n <= blocks <= tiles_n * row_tiles
    assert p["smem"] <= 232448
    assert p["smem"] == samlp_train._ls_smem(cin, rw, cw, p["wp"],
                                             p["stages"])
    assert p["smem"] >= 2 * cin_p * (tn + 8)  # W's slice, resident
    if m == 4096:
        assert blocks >= 132
    taken = np.zeros((tiles_n, row_tiles), np.int32)
    filled = np.zeros((p["groups"], tiles_n), np.int32)
    for b in range(blocks):
        ct, g = b % tiles_n, b // tiles_n
        groups = -(-(blocks - ct) // tiles_n)
        assert g < row_tiles
        taken[ct, g::groups] += 1
        filled[g, ct] += 1
        if g == 0:
            filled[groups:, ct] += 1
    assert (taken == 1).all() and (filled == 1).all()
    for ct in range(tiles_n):
        tn_here = min(tn, cout_p - ct * tn)
        cover = np.zeros((tm, tn_here), np.int32)
        for warp in range(rw * cw):
            wr, wc = warp // cw, warp % cw
            pairs = max(0, min(wcols, tn_here - wc * wcols)) // 16
            assert pairs <= 4
            cover[32 * wr:32 * wr + 32,
                  wc * wcols:wc * wcols + 16 * pairs] += 1
        assert (cover == 1).all()
    assert 16 * sum(min(2, (cin_p - k) // 16)
                    for k in range(0, cin_p, 32)) == cin_p


@pytest.mark.parametrize("m,cin,cout,first,need", [
    (256, 7, 24, False, True), (1000, 131, 24, True, True),
    (3000, 64, 40, False, True), (2000, 196, 38, False, True),
    (700, 9, 21, False, True), (4096, 259, 16, True, True),
    (4096, 643, 8, True, True), (4096, 512, 16, False, True),
    (5000, 3, 64, True, False), (4096, 256, 30, True, False)])
def test_da_dh_plan_takes_every_product_once(m, cin, cout, first, need):
    """The da + dh kernel's decomposition as ``da_dh_kernel`` walks it:
    blocks (row tile, Cin split), the split's Cin tiles, warps (wr, wc)
    on 32 x 64 warp tiles that skip columns past ``cin_p``, and the W
    ring's 32-column k-slices of Cout. Every (row, Cin column, Cout k)
    product of ``da·Wᵀ`` is taken exactly once, every row up to ``m_pad``
    has its da and db partial written by exactly one block, no block reads
    a row past ``m_pad``, and a ring stage holds the W rows it is given."""
    bw = samlp_train.bwd_layer_plan(m, cin, cout, need_dprev=need,
                                    first=first)
    tm, tn, rw = bw["dh_tm"], bw["dh_tn"], bw["dh_rw"]
    cin_p, cout_p, m_pad = bw["cin_p"], bw["cout_p"], bw["m_pad"]
    per, cw = bw["dh_tiles_per_split"], 8 // rw
    ring_rows = min(tn, cin_p)
    taken = np.zeros((m, cin, cout), np.uint8)
    written = np.zeros(m_pad, np.int32)
    for tile in range(bw["dh_tiles"]):
        row0 = tile * tm
        assert row0 + tm <= m_pad
        for split in range(bw["dh_splits"]):
            if split == 0:
                written[row0:row0 + tm] += 1
            if not need:
                continue
            for nt in range(split * per, min(bw["dh_n_tiles"],
                                             (split + 1) * per)):
                assert min(tn, cin_p - nt * tn) <= ring_rows
                for k0 in range(0, cout_p, 32):
                    kst = min(32, cout_p - k0) // 16
                    for warp in range(8):
                        wr, wc = warp // cw, warp % cw
                        n0 = nt * tn + wc * 64
                        pairs = max(0, min(64, cin_p - n0)) // 16
                        if pairs == 0:
                            continue
                        assert wc * 64 + 16 * pairs <= ring_rows
                        r0 = row0 + wr * 32
                        taken[r0:min(r0 + 32, m), n0:min(n0 + 16 * pairs, cin),
                              k0:min(k0 + 16 * kst, cout)] += 1
    assert (written == 1).all()
    assert (taken == (1 if need else 0)).all()


@pytest.mark.parametrize("m,cin,cout", [
    (256, 7, 24), (1000, 7, 24), (4000, 196, 72), (3000, 3, 64),
    (5000, 131, 128), (700, 64, 196), (520, 259, 40), (1200, 256, 512)])
def test_dw_plan_takes_every_product_once(m, cin, cout):
    """The dW kernel's decomposition as ``dw_kernel`` walks it: blocks
    (Cin x Cout tile, row split), chunks of ``dw_rows`` rows, warps
    (wk_i, wm_i, wn_i) each taking a contiguous 1/wk of a chunk's k16
    steps on its 32 x 64 warp tile, skipping columns past ``cout_p`` and
    tiles past Cin. Every (row, Cin channel, Cout channel) product is
    taken exactly once, and no chunk reads da past ``m_pad``."""
    bw = samlp_train.bwd_layer_plan(m, cin, cout)
    wm, wn, wk, rows = bw["dw_wm"], bw["dw_wn"], bw["dw_wk"], bw["dw_rows"]
    tm, tn, cout_p = 32 * wm, 64 * wn, bw["cout_p"]
    tiles_n = -(-cout_p // tn)
    assert -(-cin // tm) * tiles_n == bw["dw_tiles"]
    taken = np.zeros((m, cin, cout), np.int32)
    for tile in range(bw["dw_tiles"]):
        c0, n0 = tile // tiles_n * tm, tile % tiles_n * tn
        win, cols = min(tm, cin - c0), min(tn, cout_p - n0)
        for split in range(bw["splits"]):
            r_begin = split * bw["rows_per_split"]
            r_end = min(m, r_begin + bw["rows_per_split"])
            for r0 in range(r_begin, r_end, rows):
                assert r0 + rows <= bw["m_pad"]
                for warp in range(wm * wn * wk):
                    wn_i, wm_i = warp % wn, warp // wn % wm
                    wk_i = warp // (wn * wm)
                    pairs = max(0, min(64, cols - wn_i * 64)) // 16
                    if pairs == 0 or wm_i * 32 >= win:
                        continue
                    k = rows // wk
                    lo = r0 + wk_i * k
                    ci = c0 + wm_i * 32
                    co = n0 + wn_i * 64
                    taken[lo:min(lo + k, r_end), ci:min(ci + 32, cin),
                          co:min(co + 16 * pairs, cout)] += 1
    assert (taken == 1).all()


def test_cpu_training_launches_no_kernel(rng):
    """A training forward and backward on CPU tensors takes the plain
    versions and leaves every launch count where it was."""
    kernels = [gather.SCATTER_KERNEL, *samlp_train.KERNELS]
    before = [k.launches for k in kernels]
    x, layers = _mlp_case(rng, 8, 8, 6, (16, 8))
    params = [tuple(T(p).requires_grad_() for p in l[:4]) for l in layers]
    running = [(T(l[4]), T(l[5])) for l in layers]
    out, _ = fused_mlp.fused_mlp_max(T(x).reshape(1, 8, 8, 6), params,
                                     running, train=True)
    out.sum().backward()
    feats = T(rng.randn(1, 10, 2).astype(np.float32)).requires_grad_()
    idx = T(rng.randint(0, 10, (1, 3, 4)).astype(np.int32))
    gather.group_gather(T(_cloud(rng, 1, 10)), feats, idx,
                        T(_cloud(rng, 1, 3))).sum().backward()
    assert feats.grad is not None
    assert [k.launches for k in kernels] == before
