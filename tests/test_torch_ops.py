"""The port's ops (papc_tpu_torch.ops) against the JAX package, on the CPU.

Inputs come from one numpy seed and go to both packages in the same
process. Where the JAX function reaches a Pallas kernel it runs as the
JAX suite runs it here: its XLA path and the kernel with
``interpret=True``. FPS, ball query and the grouping gather must agree
EXACTLY (indices and gathered values); the eval MLP+max within the
tolerances stated at each test.
"""

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

from papc_tpu_torch.ops import fused_mlp, geometry, grouping, sampling
from papc_tpu_torch.ops.kernels import (ball_query, fps, gather, samlp,
                                        samlp_train, use_kernel)

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


def test_samlp_tile_and_shared_memory_plan():
    """The kernel's block plan at the SSG stages: whole K-groups per
    block, and SA3 (k=128, 259->256->512->1024) inside the 227 KB a
    block may opt into on the H100."""
    for k in (16, 32, 64, 128):
        tm = samlp.tile_rows(k)
        assert tm % 64 == 0 and tm % k == 0
    for c0, widths, k in [(3, (64, 64, 128), 32), (131, (128, 128, 256), 64),
                          (259, (256, 512, 1024), 128)]:
        _, _, nbytes = samlp.smem_layout(c0, widths, k, samlp.tile_rows(k))
        assert nbytes <= 232448, (c0, widths, nbytes)


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


def test_training_kernel_plans_at_the_ssg_shapes():
    """The training kernels' plans at every SSG layer (B=32): shared
    memory within the 227 KB a block may opt into, tiles of whole 64-row
    units, and row splits of the dW product that cover every row."""
    layers = [(524288, 3, 64), (524288, 64, 64), (524288, 64, 128),
              (262144, 131, 128), (262144, 128, 128), (262144, 128, 256),
              (4096, 259, 256), (4096, 256, 512), (4096, 512, 1024)]
    for m, cin, cout in layers:
        plan = samlp_train.linear_stats_plan(m, cin, cout)
        assert plan["smem"] <= 232448 and plan["tm"] % 64 == 0
        assert plan["cin_p"] % 16 == 0 and plan["ld_x"] % 8 == 0
        bw = samlp_train.bwd_layer_plan(m, cin, cout)
        assert bw["splits"] * bw["rows_per_split"] >= m
        assert (bw["splits"] - 1) * bw["rows_per_split"] < m
        assert bw["rows_per_split"] % 32 == 0 and bw["m_pad"] % bw["tm"] == 0
        assert bw["m_pad"] >= m and bw["blocks"] <= 1024
    assert samlp_train.slices(16384, 128) * 128 <= 131072


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
