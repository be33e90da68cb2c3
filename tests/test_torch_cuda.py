"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test skips (the ``device``
fixture decides, at run time). This file imports no JAX, so it also runs
on a machine that has only the port's dependencies, without the repo's
JAX conftest::

    python -m pytest tests/test_torch_cuda.py --noconftest -q

FPS, ball query and the gather must equal their plain versions exactly;
the eval MLP+max within 1e-2 (abs and rel), because both round every
activation to bf16 and sum the exact f32 products in another order, so a
sum next to a bf16 rounding boundary can round the other way; two of its
calls on the same inputs give the same bits.

The training kernels on identical inputs: ``finalize_max`` (max and
argmax) and ``bwd_seed``'s ``dy`` exactly; stored bf16 activations
(``linear_stats``' a, ``bwd_layer``'s dy') within one bf16 ulp plus 1e-4
of the largest (a product summed in another order moves a value that
cancels to near 0 by many of its own ulps), 1e-3 for dy', whose ``da``
may round to the other bf16 neighbour; f32 sums, dW, db and dg within
1e-3 of the largest magnitude (sums over up to 524288 rows in another
order); the scatter-add within 1e-5 (each point's list summed in order,
against the card's atomic ``index_add_``). A reduced training step's
loss within 5e-3 of the plain step's (bf16 rounding flips between the
two carry through three SA stages).

The NMS sweeps must equal their plain versions exactly (keep masks), and
a reduced detection slice's detections with the kernels must equal the
plain run's.

The row scatter-add (the backward of ``index_points``) within 1e-5 of its
largest (each row summed in its list's order, against the card's
atomics), out-of-range indices contributing nothing, its inverse index
equal to the plain twin's and the same bits over two calls; the
eval MLP at MSG classification's SA3 width (c0 = 643, a group split over
four 32-row blocks) and the training passes at MSG's widths (196, 643)
and K = 16 under the tolerances above; the MSG classifier and both
segmentation models' train steps with every kernel launched.

The recompute passes (#11-14) on every SA stack shape of the registry's
models (c0 3 to 643, width 196, K 16 to 128, ragged last tiles): forward
sums within 1e-3 of their largest, the max within that plus one bf16 ulp,
the argmax equal where the plain margin is clear of both; the backward
outputs (whose ReLU gates may open in one version and not the other where
a recomputed ``a·scale + shift`` is within an ulp of 0) no more than 1.5
times as far from the f32-operand plain pass as the bf16 one; the
recompute Function
and a reduced training step under ``override(mode="recompute")`` with
only #11-14 of the training passes launched.

The single-launch recompute passes (#15-18, ``mode="recompute1"``) on
every stack shape their gate admits (SSG SA1 and SA2, MSG SA1, ragged and
unaligned ones), under the tolerances of #11-14, against their plain
versions and against #11-14 on the same inputs; repeated calls the same
bits; one device kernel a call in the profiler; a reduced training step
under ``override(mode="recompute1")`` with #15-18 launched on the admitted
stacks, the stream passes on the demoted one and #11-14 never.
"""

import copy

import numpy as np
import pytest
import torch

from papc_tpu_torch.data.synthetic_kitti import SyntheticFrames, collate_batch
from papc_tpu_torch.detect import builders
from papc_tpu_torch.detect.config import car_config, cfg_from_list
from papc_tpu_torch.detect.train import make_pillarizer, make_predict_step
from papc_tpu_torch.models.classify import PointNet2MSGClas, PointNet2SSGClas
from papc_tpu_torch.models.segment import PointNet2MSGSeg, PointNet2SSGSeg
from papc_tpu_torch.nn.layers import init_params
from papc_tpu_torch.ops import fused_mlp, geometry, sampling
from papc_tpu_torch.ops.iou import box5_to_corners, iou_2d, rotate_iou
from papc_tpu_torch.ops.kernels import (ball_query, fps, gather, nms, samlp,
                                        samlp_train, scatter_rows,
                                        scatter_sorted)
from tests.nms_boxes import clustered_rboxes, near_degenerate_rboxes

pytestmark = pytest.mark.cuda
KERNEL_MODULES = (fps, ball_query, gather, samlp)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(seed, B, N, scale=0.5):
    rs = np.random.RandomState(seed)
    return torch.from_numpy((rs.randn(B, N, 3) * scale).astype(np.float32))


def _launches():
    return [m.KERNEL.launches for m in KERNEL_MODULES]


@pytest.mark.parametrize("B,N,npoint", [
    (3, 1000, 100), (2, 33, 33), (1, 4096, 256), (32, 1024, 512),
    (4, 16384, 2048), (1, 65536, 4096),  # clusters of 8 and 16 blocks
    (2, 4097, 300),  # N off every tile: a cluster of 3 blocks
    (3, 33, 33),  # npoint = N: the last rounds pick distance-0 points
    (1, 5000, 200),  # a cluster at a small N
])
def test_fps_kernel_equals_plain(device, B, N, npoint):
    if (B, N) == (1, 5000):
        assert fps.fps_plan(B, N).cluster > 1
    xyz = _cloud(B + N, B, N).to(device)
    start = torch.randint(0, N, (B,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(N)).to(device)
    before = fps.KERNEL.launches
    got = fps.farthest_point_sample(xyz, npoint, start)
    assert fps.KERNEL.launches == before + 1
    want = fps.farthest_point_sample(xyz, npoint, start, impl="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    again = fps.farthest_point_sample(xyz, npoint, start)
    assert fps.KERNEL.launches == before + 2
    assert torch.equal(again, got)


def test_fps_kernel_ties(device):
    base = _cloud(3, 1, 40)
    xyz = torch.cat([base, base, base], dim=1).to(device)
    got = sampling.farthest_point_sample(xyz, 60)
    want = sampling.farthest_point_sample(xyz, 60, impl="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # copies of one cloud over a cluster: every tie crosses blocks
    base = _cloud(5, 2, 1500)
    xyz = torch.cat([base] * 4, dim=1).to(device)
    assert fps.fps_plan(2, 6000).cluster > 1
    got = sampling.farthest_point_sample(xyz, 400)
    want = sampling.farthest_point_sample(xyz, 400, impl="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fps_kernel_refuses_clouds_above_its_limit(device):
    """Above the plan's limit the wrapper raises ``ValueError`` naming
    it; a plan the kernel cannot hold is refused by the C entry."""
    n = fps.POINT_LIMIT + 1
    xyz = torch.zeros(1, n, 3, device=device)
    start = torch.zeros(1, dtype=torch.int32, device=device)
    before = fps.KERNEL.launches
    with pytest.raises(ValueError, match=str(fps.POINT_LIMIT)):
        fps.farthest_point_sample(xyz, 4, start)
    small = torch.zeros(1, 4096, 3, device=device)
    with pytest.raises(RuntimeError, match="papc_fps"):
        fps.launch_plan(small, 4, start, fps.FpsPlan(4, 8, 1))  # 1024 < N
    with pytest.raises(RuntimeError, match="papc_fps"):
        fps.launch_plan(small, 4, start, fps.FpsPlan(16, 32, 1))  # registers
    assert fps.KERNEL.launches == before


@pytest.mark.parametrize("B,N,S,K,r", [(2, 1000, 77, 16, 0.3),
                                       (32, 1024, 512, 32, 0.2),
                                       (32, 512, 128, 64, 0.4),
                                       (1, 50, 9, 48, 5.0)])
def test_ball_query_kernel_equals_plain(device, B, N, S, K, r):
    xyz = _cloud(S, B, N).to(device)
    q = xyz[:, torch.randperm(N, generator=torch.Generator().manual_seed(S))
            [:S].to(device)].contiguous()
    got = ball_query.query_ball_point(r, K, xyz, q)
    want = ball_query.query_ball_point(r, K, xyz, q, impl="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_ball_query_kernel_empty_balls(device):
    xyz = _cloud(1, 2, 300).to(device)
    far = torch.full((2, 10, 3), 100.0, device=device)
    got = ball_query.query_ball_point(0.5, 8, xyz, far)
    assert bool((got == 299).all())


@pytest.mark.parametrize("B,N,S,K,r,kind", [
    (2, 1000, 300, 32, 0.3, "points"),  # N off every tile
    (1, 16385, 700, 32, 0.4, "points"),  # the whole cloud, off 16 bytes
    (4, 16384, 2048, 32, 0.4, "points"),  # the 16k row: one cloud a block
    (1, 65536, 1024, 32, 0.4, "points"),  # tiles of TILE_POINTS
    (1, 131072, 512, 32, 0.4, "points"),  # FPS's limit
    (2, 300, 40, 300, 0.5, "points"),  # nsample = N
    (2, 500, 64, 64, 50.0, "points"),  # every point inside the radius
    (2, 500, 64, 16, 0.5, "far"),  # every ball empty
    (3, 1024, 4096, 16, 0.2, "random"),  # a cloud's queries over 8 blocks
])
def test_ball_query_kernel_edges(device, B, N, S, K, r, kind):
    """Exact against plain where the staging, the tiles and the early
    exits have their edges; one launch a call."""
    xyz = _cloud(N + K, B, N).to(device)
    if kind == "far":
        q = torch.full((B, S, 3), 100.0, device=device)
    elif kind == "random":
        q = _cloud(S, B, S).to(device)
    else:
        q = xyz[:, torch.randperm(N, generator=torch.Generator().manual_seed(
            S))[:S].to(device)].contiguous()
    plan = ball_query.ball_query_plan(B, N, S, K)
    if kind == "random":
        assert plan.blocks // B >= 8
    before = ball_query.KERNEL.launches
    got = ball_query.query_ball_point(r, K, xyz, q)
    assert ball_query.KERNEL.launches == before + 1
    want = ball_query.query_ball_point(r, K, xyz, q, impl="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if kind == "far":
        assert bool((got == N - 1).all())


@pytest.mark.parametrize("queries", [1, 2, 4])
@pytest.mark.parametrize("tile,warps", [
    (1000, 4), (1000, 1), (1000, 32),  # the whole cloud
    (128, 4), (256, 8), (128, 1)])  # double-buffered tiles
def test_ball_query_kernel_takes_every_plan(device, queries, tile, warps):
    """Any warps, queries a warp (a block's last queries past S) and tile
    of points (the whole cloud, or double-buffered tiles down to 128
    points) give the plain bits, on balls that fill early and balls that
    never fill."""
    B, N, S, K = 2, 1000, 77, 24
    xyz = _cloud(7, B, N).to(device)
    q = xyz[:, :S].contiguous()
    q[:, ::5] += 0.5
    plan = ball_query.BallQueryPlan(warps, queries, tile, 0, 0)
    for r in (0.1, 0.4):
        got = ball_query.launch_plan(r, K, xyz, q, plan)
        want = ball_query.query_ball_point(r, K, xyz, q, impl="plain")
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("B,N,D,S,K", [
    (2, 100, 0, 13, 8), (3, 64, 5, 7, 32), (32, 512, 128, 128, 64),
    (32, 1024, 0, 512, 32), (32, 1024, 3, 512, 32),  # SSG SA1, clas and seg
    (2, 50, 0, 9, 7), (2, 40, 128, 3, 5),  # K * C off 4: 4-byte stores
    (1, 20, 3, 1, 5),  # one group of 30 floats, below one block's span
])
def test_gather_kernel_equals_plain(device, B, N, D, S, K):
    g = torch.Generator().manual_seed(B * N + D)
    xyz = torch.randn(B, N, 3, generator=g).to(device)
    feats = torch.randn(B, N, D, generator=g).to(device) if D else None
    idx = torch.randint(-2, N + 2, (B, S, K), generator=g,
                        dtype=torch.int32).to(device)
    new_xyz = torch.randn(B, S, 3, generator=g).to(device)
    got = gather.group_gather(xyz, feats, idx, new_xyz)
    want = gather.group_gather(xyz, feats, idx, new_xyz, impl="plain")
    assert got.shape == (B, S, K, 3 + D)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("B,N,D,S,K", [
    (2, 100, 0, 13, 8), (3, 64, 5, 7, 32),  # K * C = 24, 256: 16-byte stores
    (32, 1024, 0, 512, 32), (32, 512, 128, 128, 64),  # SSG SA1, SA2
    (2, 50, 0, 9, 7), (3, 64, 3, 7, 5), (2, 40, 128, 3, 5),  # K * C off 8
    (1, 20, 3, 1, 5),  # one group of 30 values, below one block's span
])
def test_gather_kernel_bf16_equals_plain(device, B, N, D, S, K):
    """#3 on a bf16 source (the bf16 training step): the bf16 output of
    the kernel equals the plain version's bit for bit at D = 0, 3 and
    128, with 16-byte stores where K * C % 8 == 0 and 2-byte ones
    elsewhere; the centring is the exact difference rounded once, so
    centres far from their points (exponents apart) are in the inputs.
    The f32 variant of the same inputs keeps its own bits."""
    g = torch.Generator().manual_seed(B * N + D + 1)
    xyz = torch.randn(B, N, 3, generator=g).to(device, torch.bfloat16)
    feats = (torch.randn(B, N, D, generator=g).to(device, torch.bfloat16)
             if D else None)
    idx = torch.randint(-2, N + 2, (B, S, K), generator=g,
                        dtype=torch.int32).to(device)
    new_xyz = torch.randn(B, S, 3, generator=g)
    new_xyz[:, ::2] *= 1e-4  # far smaller exponents than the points'
    new_xyz = new_xyz.to(device, torch.bfloat16)
    before = gather.KERNEL.launches
    got = gather.group_gather(xyz, feats, idx, new_xyz)
    assert gather.KERNEL.launches == before + 1
    want = gather.group_gather(xyz, feats, idx, new_xyz, impl="plain")
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, K, 3 + D)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    f32 = [None if t is None else t.float() for t in (xyz, feats, new_xyz)]
    torch.testing.assert_close(
        gather.group_gather(f32[0], f32[1], idx, f32[2]),
        gather.group_gather(f32[0], f32[1], idx, f32[2], impl="plain"),
        rtol=0, atol=0)


def _mlp(seed, c0, widths, device):
    g = torch.Generator().manual_seed(seed)
    ws, bs, scales, shifts = [], [], [], []
    cin = c0
    for c in widths:
        ws.append((torch.randn(cin, c, generator=g) / cin ** 0.5).to(device))
        bs.append((0.1 * torch.randn(c, generator=g)).to(device))
        scales.append((1 + 0.2 * torch.randn(c, generator=g)).to(device))
        shifts.append((0.1 * torch.randn(c, generator=g)).to(device))
        cin = c
    return ws, bs, scales, shifts


@pytest.mark.parametrize("groups,k,c0,widths", [
    (5, 32, 3, (64, 64, 128)),        # last block partly filled
    (64, 64, 131, (128, 128, 256)),
    (32, 128, 259, (256, 512, 1024)),  # SSG SA3
    (40, 16, 7, (40, 24)),            # widths off the 16-column tiles
    (9, 8, 20, (16, 16, 16, 32)),     # four layers
    (32, 128, 643, (256, 512, 1024)),  # MSG clas SA3: 32-row tiles, split
    (5, 128, 643, (256, 512, 1024)),   # split groups, few blocks
    (64, 128, 323, (128, 196, 256)),   # MSG seg SA2: width 196
    (96, 16, 3, (32, 32, 64)),         # MSG clas SA1: K = 16
    (48, 64, 259, (256, 512, 1024)),   # 32-row tiles, a group over 2 blocks
    (7, 24, 40, (64, 1024)),           # 1024 wide; ragged M, straddling k
    (40, 64, 131, (128, 196, 256)),    # width 196 at k = 64
    (13, 5, 9, (32, 48)),              # k = 5: one-row register runs
])
def test_samlp_kernel_matches_plain(device, groups, k, c0, widths):
    ws, bs, scales, shifts = _mlp(groups * k, c0, widths, device)
    x = torch.randn(groups * k, c0,
                    generator=torch.Generator().manual_seed(k)).to(device)
    p = samlp.plan(groups * k, c0, widths, k)
    if (groups, k, c0) == (32, 128, 259):  # SSG SA3: across the card
        assert (p["tm"], p["blocks"]) == (32, 128)
    before = samlp.KERNEL.launches
    got = samlp.eval_mlp_max(x, ws, bs, scales, shifts, k=k)
    assert samlp.KERNEL.launches == before + 1
    want = samlp.eval_mlp_max(x, ws, bs, scales, shifts, k=k, impl="plain")
    assert got.shape == (groups, widths[-1])
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("groups,k,c0,widths", [
    (16384, 32, 3, (64, 64, 128)),     # SSG SA1: 4096 blocks of 128 rows
    (32, 128, 259, (256, 512, 1024)),  # SSG SA3: groups merged over blocks
])
def test_samlp_kernel_is_repeatable(device, groups, k, c0, widths):
    """Two calls on the same inputs give the same bits: every sum has a
    fixed order in the registers, and the max (in shared memory and, for
    a group over several blocks, in device memory) is exact in any
    order."""
    ws, bs, scales, shifts = _mlp(groups + k, c0, widths, device)
    x = torch.randn(groups * k, c0,
                    generator=torch.Generator().manual_seed(c0)).to(device)
    first = samlp.eval_mlp_max(x, ws, bs, scales, shifts, k=k)
    again = samlp.eval_mlp_max(x, ws, bs, scales, shifts, k=k)
    assert torch.equal(first, again)
    assert bool((first >= 0).all()) and float(first.max()) > 0


@pytest.mark.parametrize("layout", ["linear_t", "bf16", "bf16_t", "f64"])
def test_samlp_kernel_takes_weights_as_held(device, layout):
    """The kernel packs f32 W at the caller's strides itself: a transposed
    view (the model passes ``Linear.weight.t()``) gives the same bits as
    contiguous W, and so do bf16 and f64 weights, which the wrapper turns
    into f32 exactly and the kernel rounds once to the same bf16."""
    groups, k, c0, widths = 24, 32, 131, (128, 196, 256)
    ws, bs, scales, shifts = _mlp(7, c0, widths, device)
    x = torch.randn(groups * k, c0,
                    generator=torch.Generator().manual_seed(3)).to(device)
    held = {"linear_t": [w.t().contiguous().t() for w in ws],
            "bf16": [w.bfloat16() for w in ws],
            "bf16_t": [w.bfloat16().t().contiguous().t() for w in ws],
            "f64": [w.double() for w in ws]}[layout]
    assert layout in ("bf16", "f64") or not held[0].is_contiguous()
    want = samlp.eval_mlp_max(x, ws, bs, scales, shifts, k=k)
    got = samlp.eval_mlp_max(x, held, bs, scales, shifts, k=k)
    assert torch.equal(got, want)


def test_no_silent_plain_path_on_the_card(device):
    x = torch.randn(64, 3, device=device)
    ws, bs, scales, shifts = _mlp(0, 3, (16,), device)
    with pytest.raises(ValueError, match="bf16"):
        samlp.eval_mlp_max(x, ws, bs, scales, shifts, k=8,
                           operand_dtype=torch.float32)
    with fused_mlp.override(operand_dtype=torch.float32):
        with pytest.raises(ValueError, match="bf16"):
            fused_mlp.fused_mlp_max(x.reshape(1, 8, 8, 3),
                                    [(ws[0], bs[0], scales[0], shifts[0])],
                                    [(torch.zeros(16, device=device),
                                      torch.ones(16, device=device))])
    with pytest.raises(ValueError, match="int32"):
        fps.farthest_point_sample_cuda(torch.randn(1, 8, 3, device=device), 2,
                                       torch.zeros(1, dtype=torch.int64,
                                                   device=device))
    before = _launches()
    fps.farthest_point_sample(torch.randn(1, 8, 3, device=device), 2,
                              torch.zeros(1, dtype=torch.int32, device=device),
                              impl="plain")
    assert _launches() == before


def test_reduced_model_runs_all_four_kernels(device):
    model = PointNet2SSGClas(num_classes=16, npoints=(128, 32),
                             nsamples=(32, 64)).eval()
    init_params(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    points = _cloud(9, 8, 512).to(device)
    before = _launches()
    with torch.inference_mode():
        got = model(points)
        assert all(a > b for a, b in zip(_launches(), before))
        want = model(points, impl="plain")
    assert got.shape == (8, 16) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------- training

def _bf16_ulp(t):
    t = t.float().abs()
    return torch.where(t == 0, torch.zeros_like(t),
                       torch.exp2(torch.floor(torch.log2(t)) - 7))


def _near(got, want, rel, ulp=False):
    got, want = got.float(), want.float()
    bound = rel * float(want.abs().max().clamp_min(1e-30))
    if ulp:
        bound = bound + _bf16_ulp(want)
    err = (got - want).abs()
    assert bool((err <= bound).all()), float(err.max())


def _bf16(shape, seed, device, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*shape, generator=g)).to(device, torch.bfloat16)


def _vec4(c, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.stack([1 + 0.3 * torch.randn(c, generator=g),
                        0.2 * torch.randn(c, generator=g),
                        0.1 * torch.randn(c, generator=g),
                        0.5 + torch.rand(c, generator=g) * 1.5]).to(device)


TRAIN_LAYERS = [  # (M, Cin, Cout, k): small, then every SSG layer at B=32
    (256, 7, 24, 8), (1024, 16, 40, 8),
    (524288, 3, 64, 32), (524288, 64, 64, 32), (524288, 64, 128, 32),
    (262144, 131, 128, 64), (262144, 128, 128, 64), (262144, 128, 256, 64),
    (4096, 259, 256, 128), (4096, 256, 512, 128), (4096, 512, 1024, 128),
    # MSG: K = 16 (clas SA1), width 196 (seg SA2), c0 = 643 (clas SA3)
    (262144, 3, 32, 16), (524288, 323, 128, 128), (524288, 128, 196, 128),
    (524288, 196, 256, 128), (4096, 643, 256, 128),
]


# linear_stats only: M a multiple of neither its row tile nor 32; odd Cin
# on a first and a gated layer (3, 131, 643: x copied as one span a tile
# and laid out, 643 with Cout split over column tiles); Cin = 4 (mod 8)
# (196); Cout = 4 (mod 8) (196: a stored 8 bytes at a time) and a Cout
# below one warp tile (24).
LINEAR_STATS_EDGES = [(1000, 3, 64, 8), (777, 131, 128, 8),
                      (2000, 643, 256, 8), (1500, 196, 256, 8),
                      (999, 128, 196, 8), (333, 64, 24, 8)]


def _linear_stats_inputs(m, cin, cout, device):
    g = torch.Generator().manual_seed(cout)
    w = (torch.randn(cin, cout, generator=g) / cin ** 0.5).to(device)
    b = (0.1 * torch.randn(cout, generator=g)).to(device)
    return w, b


@pytest.mark.parametrize("m,cin,cout,k", TRAIN_LAYERS + LINEAR_STATS_EDGES)
def test_linear_stats_kernel_matches_plain(device, m, cin, cout, k):
    x = _bf16((m, cin), m + cin, device)
    w, b = _linear_stats_inputs(m, cin, cout, device)
    for vec in (None, _vec4(cin, cin, device)):
        before = samlp_train.LINEAR_STATS.launches
        a, sums = samlp_train.linear_stats(x, vec, w, b)
        assert samlp_train.LINEAR_STATS.launches == before + 1
        want_a, want_sums = samlp_train.linear_stats(x, vec, w, b,
                                                     impl="plain")
        assert a.dtype == torch.bfloat16 and a.shape == (m, cout)
        _near(a, want_a, 1e-4, ulp=True)
        _near(sums, want_sums, 1e-3)
        again_a, again = samlp_train.linear_stats(x, vec, w, b)
        torch.testing.assert_close(again, sums, rtol=0, atol=0)  # fixed order
        torch.testing.assert_close(again_a, a, rtol=0, atol=0)


def test_linear_stats_takes_an_x_off_16_bytes(device):
    """A view of x that starts 2 bytes into a row: the wrapper hands the
    ring an aligned copy, and both outputs equal the aligned call's."""
    m, cin, cout = 500, 8, 24
    base = _bf16((m * cin + 1,), 3, device)
    off = base[1:].view(m, cin)
    assert off.data_ptr() % 16
    w, b = _linear_stats_inputs(m, cin, cout, device)
    for vec in (None, _vec4(cin, cin, device)):
        got = samlp_train.linear_stats(off, vec, w, b)
        want = samlp_train.linear_stats(off.clone(), vec, w, b)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


# finalize_max and bwd_seed only: C = 4 (mod 8) (196: 8-byte chunks) and
# odd C (a value a thread), fewer groups than a block takes, k from 8 to
# 128, k = 33 (row slices of unequal length), SA3's 1024 channels at a
# few groups (a group's rows split over slices and blocks)
FINALIZE_SEED_EDGES = [(999 * 8, None, 196, 8), (8 * 8, None, 37, 8),
                       (3 * 16, None, 128, 16), (2 * 32, None, 40, 32),
                       (5 * 64, None, 24, 64), (7 * 128, None, 37, 128),
                       (5 * 128, None, 1024, 128), (4 * 33, None, 256, 33)]


@pytest.mark.parametrize("m,cin,cout,k", TRAIN_LAYERS + FINALIZE_SEED_EDGES)
def test_finalize_and_seed_kernels_equal_plain(device, m, cin, cout, k):
    """Both passes against their plain versions: max, argmax and dy
    exactly, the sums within 1e-3 of plain's largest and equal over two
    calls. a has exact ties inside each group (the first row must win)
    and one group whose every value is at most 0 (every row ties at 0);
    one launch of finalize_max and at most two of bwd_seed a call; an
    argmax outside [0, k) routes nothing."""
    if m % k:
        m = m // k * k
    a = _bf16((m, cout), m, device)
    a[1::k] = a[0::k]  # exact ties inside each group
    vec = _vec4(cout, cout, device)
    vec[0, :] = vec[0].abs()
    # o < 0 at every row of group 1, after the bf16 rounding of a
    a[k:2 * k] = -a[k:2 * k].abs() - 2 * vec[1].abs() / vec[0] - 0.01
    launches = (samlp_train.FINALIZE_MAX.launches,
                samlp_train.BWD_SEED.launches)
    out, amax = samlp_train.finalize_max(a, vec, k=k)
    assert samlp_train.FINALIZE_MAX.launches == launches[0] + 1
    want, want_amax = samlp_train.finalize_max(a, vec, k=k, impl="plain")
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(amax, want_amax, rtol=0, atol=0)
    if m >= 2 * k:
        assert bool((out[1] == 0).all() and (amax[1] == 0).all())
    again = samlp_train.finalize_max(a, vec, k=k)
    assert torch.equal(again[0], out) and torch.equal(again[1], amax)
    dout = torch.randn(m // k, cout, generator=torch.Generator().manual_seed(k)
                       ).to(device)
    dy, s = samlp_train.bwd_seed(a, vec, dout, amax, k=k)
    assert samlp_train.BWD_SEED.launches == launches[1] + 1
    want_dy, want_s = samlp_train.bwd_seed(a, vec, dout, amax, k=k,
                                           impl="plain")
    torch.testing.assert_close(dy, want_dy, rtol=0, atol=0)
    _near(s, want_s, 1e-3)
    again = samlp_train.bwd_seed(a, vec, dout, amax, k=k)
    torch.testing.assert_close(again[1], s, rtol=0, atol=0)  # fixed order
    assert torch.equal(again[0], dy)
    # an amax outside [0, k) selects no row, as plain's kio == amax
    amax = amax.clone()
    amax[0, ::3] = -1
    amax[-1, 1::3] = k + 3
    dy, s = samlp_train.bwd_seed(a, vec, dout, amax, k=k)
    want_dy, want_s = samlp_train.bwd_seed(a, vec, dout, amax, k=k,
                                           impl="plain")
    torch.testing.assert_close(dy, want_dy, rtol=0, atol=0)
    _near(s, want_s, 1e-3)


def test_finalize_and_seed_take_an_a_off_16_bytes(device):
    """A view of a that starts 2 bytes into a row: finalize_max reads an
    aligned copy, bwd_seed reads a where it lies; every output equals the
    aligned call's."""
    m, c, k = 64 * 32, 128, 32
    base = _bf16((m * c + 1,), 5, device)
    off = base[1:].view(m, c)
    assert off.data_ptr() % 16
    vec = _vec4(c, 6, device)
    got = samlp_train.finalize_max(off, vec, k=k)
    want = samlp_train.finalize_max(off.clone(), vec, k=k)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    dout = torch.randn(m // k, c, device=device)
    got = samlp_train.bwd_seed(off, vec, dout, want[1], k=k)
    want = samlp_train.bwd_seed(off.clone(), vec, dout, want[1], k=k)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# bwd_layer only: the dW product's ragged cases. M a multiple of neither
# 32 nor its split (the last chunk of a_prev runs past M: zero-filled),
# and Cin = 4 (mod 8) (a_prev's rows 8-byte aligned).
DW_EDGES = [(1000, 7, 24, 8), (4000, 196, 72, 8)]
# The da + dh pass's: odd Cin on a first layer (dg stored a value at a
# time; the layer shapes of SSG SA2 and MSG SA2 cut in rows, the second
# split over Cin tiles), Cout = 6 (mod 8) and odd Cout (dy and a read a
# value at a time), the latter with an odd gated Cin (a_prev's tile
# copied a value at a time).
DA_DH_EDGES = [(1000, 131, 24, 8), (4000, 323, 72, 8), (2000, 40, 38, 8),
               (700, 9, 21, 8)]


@pytest.mark.parametrize("m,cin,cout,k", TRAIN_LAYERS + DW_EDGES + DA_DH_EDGES)
def test_bwd_layer_kernel_matches_plain(device, m, cin, cout, k):
    dy = _bf16((m, cout), 1, device, 0.01)
    a = _bf16((m, cout), 2, device)
    a_prev = _bf16((m, cin), 3, device)
    g = torch.Generator().manual_seed(cin)
    w = (torch.randn(cin, cout, generator=g) / cin ** 0.5).to(device)
    vec, vec_prev = _vec4(cout, 4, device), _vec4(cin, 5, device)
    s_in = torch.randn(2, cout, generator=g).to(device) * m ** 0.5 * 0.01
    for prev in (vec_prev, None):
        got = samlp_train.bwd_layer(dy, a, a_prev, w, vec, s_in, prev)
        want = samlp_train.bwd_layer(dy, a, a_prev, w, vec, s_in, prev,
                                     impl="plain")
        if prev is None:
            _near(got[0], want[0], 1e-3)  # dg, f32
            assert got[3] is None
        else:
            assert got[0].dtype == torch.bfloat16
            _near(got[0], want[0], 1e-3, ulp=True)
            _near(got[3], want[3], 1e-3)
        _near(got[1], want[1], 1e-3)
        _near(got[2], want[2], 1e-3)
        # fixed order: dy' or dg, dW, db and the sums repeat bit for bit
        again = samlp_train.bwd_layer(dy, a, a_prev, w, vec, s_in, prev)
        for x, y in zip(got, again):
            assert (x is None) == (y is None)
            if x is not None:
                torch.testing.assert_close(y, x, rtol=0, atol=0)
    skip = samlp_train.bwd_layer(dy, a, a_prev, w, vec, s_in, None,
                                 need_dprev=False)
    assert skip[0] is None
    torch.testing.assert_close(skip[1], got[1], rtol=0, atol=0)  # fixed order
    torch.testing.assert_close(skip[2], got[2], rtol=0, atol=0)


def test_bwd_layer_takes_an_a_prev_off_16_bytes(device):
    """A view of a_prev that starts 2 bytes into a row: the wrapper hands
    the dW ring an aligned copy, and every output equals the aligned
    call's."""
    m, cin, cout = 500, 7, 24
    dy, a = _bf16((m, cout), 1, device, 0.01), _bf16((m, cout), 2, device)
    base = _bf16((m * cin + 1,), 3, device)
    off = base[1:].view(m, cin)
    assert off.data_ptr() % 16
    g = torch.Generator().manual_seed(cin)
    w = (torch.randn(cin, cout, generator=g) / cin ** 0.5).to(device)
    vec, vec_prev = _vec4(cout, 4, device), _vec4(cin, 5, device)
    s_in = torch.randn(2, cout, generator=g).to(device) * m ** 0.5 * 0.01
    got = samlp_train.bwd_layer(dy, a, off, w, vec, s_in, vec_prev)
    want = samlp_train.bwd_layer(dy, a, off.clone(), w, vec, s_in, vec_prev)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("B,N,S,K,C", [(2, 50, 7, 8, 5), (32, 1024, 512, 32, 3),
                                       (32, 512, 128, 64, 131),
                                       (2, 40, 6, 16, 259)])
def test_scatter_add_kernel_matches_plain(device, B, N, S, K, C):
    gen = torch.Generator().manual_seed(B * N)
    g = torch.randn(B, S, K, C, generator=gen).to(device)
    idx = torch.randint(-1, N + 1, (B, S, K), generator=gen,
                        dtype=torch.int32).to(device)
    before = gather.SCATTER_KERNEL.launches
    got = gather.scatter_add(g, idx, N)
    assert gather.SCATTER_KERNEL.launches == before + 1
    _near(got, gather.scatter_add(g, idx, N, impl="plain"), 1e-5)


def _garbage_pool(device, numel):
    """Leave a block of NaNs in the caching allocator, so that the next
    ``torch.empty`` of this size holds garbage, not zeros."""
    junk = torch.full((numel,), float("nan"), device=device)
    del junk


def _scatter_case(kind, B, N, S, K, C, device):
    gen = torch.Generator().manual_seed(B * N + C)
    g = torch.randn(B, S, K, C, generator=gen)
    if kind == "range":
        idx = torch.randint(-2, N + 2, (B, S, K), generator=gen,
                            dtype=torch.int32)
    elif kind == "one point":  # every entry of a cloud on one point
        idx = torch.full((B, S, K), N // 3, dtype=torch.int32)
    elif kind == "half":  # the upper half of the points takes nothing
        idx = torch.randint(0, N // 2, (B, S, K), generator=gen,
                            dtype=torch.int32)
    else:  # ball-query indices: sparse balls pad with their first point
        xyz = _cloud(N, B, N, scale=1.0).to(device)
        new_xyz = geometry.index_points(
            xyz, torch.randint(0, N, (B, S), generator=gen).to(device))
        idx = ball_query.query_ball_point(0.25, K, xyz, new_xyz.contiguous())
    return g.to(device), idx.to(device)


@pytest.mark.parametrize("C", [3, 5, 131, 259])
@pytest.mark.parametrize("kind,B,N,S,K", [
    ("range", 3, 97, 11, 16), ("one point", 2, 64, 128, 64),
    ("half", 4, 512, 128, 64), ("ball", 2, 512, 128, 64)])
def test_scatter_add_kernel_repeats_its_bits(device, kind, B, N, S, K, C):
    """The owner-computes backward: one launch a call; the inverse index
    the kernel built equal to the plain twin's (offsets and order); the
    sum within 1e-5 of plain and the same bits over two calls; every
    point that no entry takes exactly 0, though the output is
    ``torch.empty`` over a pool of NaNs; a point that takes every entry
    of its cloud sums a list of S x K rows."""
    g, idx = _scatter_case(kind, B, N, S, K, C, device)
    before = gather.SCATTER_KERNEL.launches
    _garbage_pool(device, B * N * C)
    got, offsets, order = gather.scatter_add_cuda(g, idx, N, with_index=True)
    assert gather.SCATTER_KERNEL.launches == before + 1
    want_offsets, want_order = gather.inverse_index_plain(idx, N)
    assert torch.equal(offsets, want_offsets)
    assert torch.equal(order, want_order)
    want = gather.scatter_add(g, idx, N, impl="plain")
    _near(got, want, 1e-5)
    _garbage_pool(device, B * N * C)
    assert torch.equal(gather.scatter_add(g, idx, N), got)
    empty = (offsets[:, 1:] == offsets[:, :-1])
    assert bool((got[empty] == 0).all())
    if kind == "one point":
        assert bool((offsets[:, N // 3 + 1] - offsets[:, N // 3]
                     == S * K).all())
    if kind == "half":
        assert bool(empty[:, N // 2:].all())


@pytest.mark.parametrize("kind,B,N,S,K,C", [
    ("range", 3, 97, 11, 16, 5), ("ball", 2, 512, 128, 64, 131),
    ("ball", 32, 1024, 512, 32, 3), ("one point", 2, 64, 128, 64, 3),
    ("half", 4, 512, 128, 64, 259)])
def test_scatter_add_kernel_bf16_within_one_ulp(device, kind, B, N, S, K, C):
    """#4 on a bf16 g (the bf16 training step), with ball-query padding
    and indices out of range: one launch a call; the bf16 output within
    one bf16 ulp of the plain version's (each point's sum in f32, in
    another order where a list is split, then rounded once) plus 1e-5 of
    the largest (the f32 test's bound on the two sums); the same bits over
    two calls though the output is ``torch.empty`` over a pool of NaNs;
    every point no entry takes exactly 0."""
    g, idx = _scatter_case(kind, B, N, S, K, C, device)
    g = g.to(torch.bfloat16)
    before = gather.SCATTER_KERNEL.launches
    _garbage_pool(device, B * N * C)
    got, offsets, _ = gather.scatter_add_cuda(g, idx, N, with_index=True)
    assert gather.SCATTER_KERNEL.launches == before + 1
    want = gather.scatter_add(g, idx, N, impl="plain")
    assert got.dtype == want.dtype == torch.bfloat16
    _near(got, want, 1e-5, ulp=True)
    _garbage_pool(device, B * N * C)
    again = gather.scatter_add(g, idx, N)
    assert torch.equal(again.view(torch.int16), got.view(torch.int16))
    assert bool((got[offsets[:, 1:] == offsets[:, :-1]] == 0).all())


def test_group_gather_bf16_backward_runs_the_kernels(device):
    """The differentiable gather on bf16 inputs: the forward launches #3
    once and the backward #4 once, with no f32 copy in between: the
    gradient of ``points`` is bf16, within one bf16 ulp plus 1e-5 of the
    largest of the plain backward's."""
    gen = torch.Generator().manual_seed(11)
    xyz = torch.randn(4, 256, 3, generator=gen).to(device, torch.bfloat16)
    pts = torch.randn(4, 256, 13, generator=gen).to(device, torch.bfloat16)
    idx = torch.randint(0, 256, (4, 64, 16), generator=gen,
                        dtype=torch.int32).to(device)
    new_xyz = xyz[:, :64].contiguous()
    cot = torch.randn(4, 64, 16, 16, generator=gen).to(device,
                                                        torch.bfloat16)
    grads = []
    for impl in (None, "plain"):
        p = pts.clone().requires_grad_(True)
        before = (gather.KERNEL.launches, gather.SCATTER_KERNEL.launches)
        out = gather.group_gather(xyz, p, idx, new_xyz, impl=impl)
        assert out.dtype == torch.bfloat16
        out.backward(cot)
        after = (gather.KERNEL.launches, gather.SCATTER_KERNEL.launches)
        assert [a - b for a, b in zip(after, before)] == (
            [1, 1] if impl is None else [0, 0])
        assert p.grad.dtype == torch.bfloat16
        grads.append(p.grad)
    _near(grads[0], grads[1], 1e-5, ulp=True)


def test_prefetch_to_device_on_the_card(device):
    """``prefetch_to_device`` on the card, two items staged ahead: every
    item in order, each array a tensor on the card with its source's
    values as the consumer's stream reads them right after the handover
    (it waits on the copy's event), tags untouched."""
    from papc_tpu_torch.data import prefetch_to_device

    rs = np.random.RandomState(0)
    items = [{"x": rs.randn(32, 1024, 3).astype(np.float32),
              "i": np.int32(k), "tag": ("batch", k)} for k in range(6)]
    sums = []
    for k, b in enumerate(prefetch_to_device(iter(items), size=2,
                                             device=device)):
        assert b["x"].device.type == "cuda" and b["tag"] == ("batch", k)
        sums.append((b["x"].double().sum(), b["i"]))
    assert [int(i) for _, i in sums] == list(range(6))
    for (total, _), item in zip(sums, items):
        assert float(total) == pytest.approx(
            float(item["x"].astype(np.float64).sum()), rel=1e-12)


def test_scatter_add_kernel_refuses_clouds_above_its_limit(device):
    n = gather.SCATTER_N_LIMIT + 1
    g = torch.zeros(1, 2, 4, 3, device=device)
    idx = torch.zeros(1, 2, 4, dtype=torch.int32, device=device)
    before = gather.SCATTER_KERNEL.launches
    with pytest.raises(ValueError, match="at most"):
        gather.scatter_add(g, idx, n)
    assert gather.SCATTER_KERNEL.launches == before


@pytest.mark.parametrize("B,R,C,n,kind", [
    (2, 50, 5, 7, "range"), (32, 128 * 128, 323, 512, "padding"),
    (32, 1024 * 3, 128, 512, "range"), (4, 999, 131, 64, "outside"),
    (3, 77, 20, 9, "bf16"), (32, 128 * 64, 323, 512, "bf16 padding"),
    (3, 500, 7, 40, "none")])
def test_scatter_rows_add_kernel_matches_plain(device, B, R, C, n, kind):
    """#5 against its plain version: random rows, ball-query padding
    (runs of a group's first index; MSG clas SA2 at K = 128, C = 323),
    indices outside [0, n) that add nothing, a bf16 gradient, and a cloud
    whose every index is out of range (zeros). One launch a call; the
    index the kernel built equal to the drop-policy twin's (offsets, and
    order up to the count kept); the sum within 1e-5 of plain and the
    same bits over two calls, though the output is ``torch.empty`` over a
    pool of NaNs; every row no entry takes exactly 0."""
    gen = torch.Generator().manual_seed(R + C)
    g = torch.randn(B, R, C, generator=gen)
    if "padding" in kind:
        idx = torch.randint(0, n, (B, R // 128, 1), generator=gen)
        idx = idx.repeat(1, 1, 128)
        idx[..., :40] = torch.randint(0, n, (B, R // 128, 40), generator=gen)
        idx = idx.reshape(B, R)
    elif kind == "outside":
        idx = torch.randint(-n, 2 * n, (B, R), generator=gen)
    elif kind == "none":
        idx = torch.randint(n, 3 * n, (B, R), generator=gen)
        idx[:, ::2] = -1 - idx[:, ::2]
    else:
        idx = torch.randint(0, n, (B, R), generator=gen)
    if "bf16" in kind:
        g = g.to(torch.bfloat16)
    g, idx = g.to(device), idx.int().to(device)
    before = scatter_rows.KERNEL.launches
    _garbage_pool(device, B * n * C)
    got, offsets, order = scatter_rows.scatter_rows_add_cuda(
        g, idx, n, with_index=True)
    assert scatter_rows.KERNEL.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, n, C)
    want_offsets, want_order = scatter_sorted.inverse_index_plain(idx, n,
                                                                  drop=True)
    assert torch.equal(offsets, want_offsets)
    for b in range(B):
        kept = int(offsets[b, n])
        assert torch.equal(order[b, :kept], want_order[b, :kept])
    _near(got, scatter_rows.scatter_rows_add(g, idx, n, impl="plain"), 1e-5)
    _garbage_pool(device, B * n * C)
    assert torch.equal(scatter_rows.scatter_rows_add(g, idx, n), got)
    assert bool((got[offsets[:, 1:] == offsets[:, :-1]] == 0).all())
    if kind == "outside":
        keep = (idx >= 0) & (idx < n)
        assert float(got.sum()) == pytest.approx(
            float(g.float()[keep].sum()), rel=1e-4, abs=1e-2)
    if kind == "none":
        assert bool((offsets == 0).all()) and bool((got == 0).all())


def test_scatter_rows_add_kernel_refuses_rows_above_its_limit(device):
    """Above ``SCATTER_N_LIMIT`` output rows a cloud the plan raises
    ``ValueError`` naming the limit, and nothing launches."""
    n = scatter_sorted.SCATTER_N_LIMIT + 1
    g = torch.zeros(1, 8, 3, device=device)
    idx = torch.zeros(1, 8, dtype=torch.int32, device=device)
    before = scatter_rows.KERNEL.launches
    with pytest.raises(ValueError, match="at most"):
        scatter_rows.scatter_rows_add(g, idx, n)
    assert scatter_rows.KERNEL.launches == before


def test_index_points_backward_launches_the_scatter(device):
    """index_points' gradient on the card is #5's, within 1e-5 of the
    plain backward; a gather of data launches nothing."""
    gen = torch.Generator().manual_seed(3)
    pts = torch.randn(4, 300, 19, generator=gen).to(device)
    idx = torch.randint(-3, 303, (4, 64, 16), generator=gen).to(device)
    cot = torch.randn(4, 64, 16, 19, generator=gen).to(device)
    grads = []
    for impl in (None, "plain"):
        p = pts.clone().requires_grad_()
        before = scatter_rows.KERNEL.launches
        geometry.index_points(p, idx, impl=impl).backward(cot)
        assert scatter_rows.KERNEL.launches == before + (impl is None)
        grads.append(p.grad)
    _near(grads[0], grads[1], 1e-5)
    before = scatter_rows.KERNEL.launches
    geometry.index_points(pts, idx).sum()
    assert scatter_rows.KERNEL.launches == before


@pytest.mark.parametrize("name", ["msg_clas", "ssg_seg", "msg_seg"])
def test_new_models_train_on_the_card_through_every_kernel(device, name):
    """One train step of the MSG classifier and both segmentation models
    (full width, B=16 x 512 points, SSG seg reduced to 128 and 32
    centres): every kernel of the path launched, #5 among them; the loss
    within 2e-2 of the plain step's, every gradient finite. bf16 storage
    alone moves the MSG classifier's loss by 0.56 % from the same step
    with f32 operands at this size (0.9 % at B=4, plain versions on the
    CPU), and the kernels round in another order than the plain
    version, so the two bf16 losses differ by about as much."""
    from papc_tpu_torch.train import make_optimizer, train_step

    make = {"msg_clas": lambda: PointNet2MSGClas(num_classes=16),
            "ssg_seg": lambda: PointNet2SSGSeg(npoints=(128, 32),
                                               nsamples=(32, 64)),
            "msg_seg": lambda: PointNet2MSGSeg()}[name]
    B, N = 16, 512
    rs = np.random.RandomState(5)
    batch = {"points": _cloud(9, B, N).numpy(),
             "label": np.arange(B) % 16, "mask": np.ones(B, bool),
             "pid": rs.randint(0, 50, (B, N))}
    shapes = ([(B, 512), (B, 256)] if name == "msg_clas" else [(B, N, 128)])
    masks = [torch.rand(*s, generator=torch.Generator().manual_seed(i)) < 0.6
             for i, s in enumerate(shapes)]

    def step(impl):
        model = make()
        init_params(model, torch.Generator().manual_seed(0))
        model = model.to(device)
        opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
        loss, _ = train_step(model, opt, batch, device, impl=impl,
                             dropout_masks=masks)
        return float(loss), model

    kernels = [fps.KERNEL, ball_query.KERNEL, scatter_rows.KERNEL,
               *samlp_train.KERNELS]
    if name == "ssg_seg":
        kernels += [gather.KERNEL, gather.SCATTER_KERNEL]
    before = [k.launches for k in kernels]
    loss, model = step(None)
    assert all(k.launches > b for k, b in zip(kernels, before))
    plain_loss, _ = step("plain")
    assert loss == pytest.approx(plain_loss, rel=2e-2)
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())


def test_training_step_on_the_card_runs_every_kernel(device):
    """A reduced SSG train step: every training kernel launched, the
    loss within 5e-3 of the plain step's, every gradient finite."""
    from papc_tpu_torch.train import make_optimizer, train_step

    def step(impl):
        model = PointNet2SSGClas(num_classes=16, npoints=(128, 32),
                                 nsamples=(32, 64))
        init_params(model, torch.Generator().manual_seed(0))
        model = model.to(device)
        opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
        batch = {"points": _cloud(9, 8, 512).numpy(),
                 "label": np.arange(8) % 16, "mask": np.ones(8, bool)}
        masks = [torch.rand(8, 512, generator=torch.Generator().manual_seed(1))
                 < 0.6, torch.rand(8, 256, generator=torch.Generator()
                                   .manual_seed(2)) < 0.6]
        loss, _ = train_step(model, opt, batch, device, impl=impl,
                             dropout_masks=masks)
        return float(loss), model

    kernels = [gather.SCATTER_KERNEL, *samlp_train.KERNELS]
    before = [k.launches for k in kernels]
    loss, model = step(None)
    assert all(k.launches > b for k, b in zip(kernels, before))
    plain_loss, _ = step("plain")
    assert loss == pytest.approx(plain_loss, rel=5e-3)
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())


# ------------------------------------------------------ recompute mode

RC_STACKS = [  # (groups, k, c0, widths)
    (5, 32, 3, (64, 64, 128)),          # the last 128-row tile ragged
    (16384, 32, 3, (64, 64, 128)),      # SSG SA1 at B=32
    (4096, 64, 131, (128, 128, 256)),   # SSG SA2
    (32, 128, 259, (256, 512, 1024)),   # SSG SA3: 32-row tiles, dW by rows
    (32, 128, 643, (256, 512, 1024)),   # MSG clas SA3: a group over tiles
    (64, 128, 323, (128, 196, 256)),    # MSG seg SA2: width 196
    (96, 16, 3, (32, 32, 64)),          # MSG clas SA1: K = 16
    (9, 8, 20, (16, 16, 16, 32)),       # four layers, ragged
]


def _rc_stack(groups, k, c0, widths, device):
    """g2, W, b and BN vectors from the plain stats passes (so the chain
    is normalised as in training), a cotangent, the plain argmax and the
    gradient means from the plain bwd-stats passes."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc

    m = groups * k
    g2 = _bf16((m, c0), m + c0, device)
    ws, bs, _, _ = _mlp(c0 + k, c0, widths, device)
    g = torch.Generator().manual_seed(k)
    vecs = []
    for j, c in enumerate(widths, start=1):
        sums = rc.rc_stats(g2, vecs, ws, bs, upto=j, impl="plain")
        gamma = (1 + 0.2 * torch.randn(c, generator=g)).to(device)
        beta = (0.1 * torch.randn(c, generator=g)).to(device)
        vecs.append(samlp_train.bn_vectors(sums, gamma, beta, m, 1e-5)[0])
    _, amax = rc.rc_final(g2, vecs, ws, bs, k=k, impl="plain")
    dout = torch.randn(groups, widths[-1], generator=g).to(device)
    mus = [None] * len(widths)
    for level in range(len(widths), 0, -1):
        s = rc.rc_bwd_stats(g2, dout, amax, vecs, ws, bs, mus, level=level,
                            k=k, impl="plain")
        mus[level - 1] = s / m
    return g2, ws, bs, vecs, dout, amax, mus


def _clear_of_ties(h, groups, k, want):
    """The (group, column) pairs of the last ReLU output ``h`` whose top-2
    margin exceeds twice the max's bound (1e-3 of the largest of the max
    ``want`` plus one bf16 ulp of the top value): where the argmax of any
    version within that bound is the plain one's."""
    top2 = h.reshape(groups, k, -1).topk(2, dim=1).values
    bound = 1e-3 * float(want.abs().max()) + _bf16_ulp(top2[:, 0])
    return top2[:, 0] - top2[:, 1] > 2 * bound


def _no_farther(got, want, ref, limit=1.5):
    """``got`` at most ``limit`` times as far (L2) from ``ref`` as
    ``want`` is."""
    far = float((got.double() - ref.double()).norm())
    assert far <= limit * float((want.double() - ref.double()).norm()), far


@pytest.mark.parametrize("groups,k,c0,widths", RC_STACKS)
def test_recompute_kernels_match_plain(device, groups, k, c0, widths):
    """#11-14 against their plain versions on the same inputs. Forward:
    every layer's sums within 1e-3 of their largest (products summed in
    another order); the max within that plus one bf16 ulp of each value
    (an operand of the row's chain that rounds to the other bf16
    neighbour moves it by about that: measured up to 1.8e-3 of the
    largest, with kernel and plain equally far from an f32-operand
    chain); the argmax equal wherever the plain top-2 margin exceeds the
    max's bound twice. Backward: each version re-derives ``a`` in its own
    sum order, so where ``a·scale + shift`` is within an ulp of 0 a ReLU
    gate of the walk down opens in one and not the other (measured: 1-4
    rows of dg off in 10^5); the bwd sums, dg, dW and db are each at most
    1.5 times as far (L2) from the plain pass with f32 operands as the
    plain bf16 pass, as the card's step check holds gradients. Each call
    counts one launch of its entry; #11, #13 and #14 repeat bit for bit
    over two calls (and #14 without dg gives the same dW and db)."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc

    g2, ws, bs, vecs, dout, amax, mus = _rc_stack(groups, k, c0, widths,
                                                  device)
    n = len(widths)
    packed = [samlp_train.pack_weight(w) for w in ws]
    for upto in range(1, n + 1):
        before = rc.RC_STATS.launches
        got = rc.rc_stats(g2, vecs[:upto - 1], ws, bs, upto=upto,
                          w_packed=packed)
        assert rc.RC_STATS.launches == before + 1
        _near(got, rc.rc_stats(g2, vecs, ws, bs, upto=upto, impl="plain"),
              1e-3)
        torch.testing.assert_close(
            rc.rc_stats(g2, vecs, ws, bs, upto=upto, w_packed=packed), got,
            rtol=0, atol=0)
    before = rc.RC_FINAL.launches
    out, got_amax = rc.rc_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    assert rc.RC_FINAL.launches == before + 1
    want, want_amax = rc.rc_final(g2, vecs, ws, bs, k=k, impl="plain")
    _near(out, want, 1e-3, ulp=True)
    a_list, _ = rc.chain_plain(g2, vecs, ws, bs, n)
    h = torch.clamp_min(a_list[-1] * vecs[-1][0] + vecs[-1][1], 0.0)
    clear = _clear_of_ties(h, groups, k, want)
    assert bool((got_amax == want_amax)[clear].all())
    f32 = {"impl": "plain", "operand_dtype": torch.float32}
    args = (g2, dout, amax, vecs, ws, bs, mus)
    for level in range(n, 0, -1):
        before = rc.RC_BWD_STATS.launches
        got = rc.rc_bwd_stats(*args, level=level, k=k, w_packed=packed)
        assert rc.RC_BWD_STATS.launches == before + 1
        _no_farther(got, rc.rc_bwd_stats(*args, level=level, k=k,
                                         impl="plain"),
                    rc.rc_bwd_stats(*args, level=level, k=k, **f32))
        torch.testing.assert_close(
            rc.rc_bwd_stats(*args, level=level, k=k, w_packed=packed), got,
            rtol=0, atol=0)
    before = rc.RC_BWD_FINAL.launches
    got = rc.rc_bwd_final(*args, k=k, w_packed=packed)
    assert rc.RC_BWD_FINAL.launches == before + 1
    want = rc.rc_bwd_final(*args, k=k, impl="plain")
    ref = rc.rc_bwd_final(*args, k=k, **f32)
    _no_farther(got[0], want[0], ref[0])
    for j in range(n):
        _no_farther(got[1][j], want[1][j], ref[1][j])
        _no_farther(got[2][j], want[2][j], ref[2][j])
    again = rc.rc_bwd_final(*args, k=k, w_packed=packed)
    for a, b in zip([again[0], *again[1], *again[2]],
                    [got[0], *got[1], *got[2]]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    skip = rc.rc_bwd_final(*args, k=k, w_packed=packed, need_dg=False)
    assert skip[0] is None
    for a, b in zip(skip[1] + skip[2], got[1] + got[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)  # fixed order


@pytest.mark.parametrize("groups,k,c0,widths", RC_STACKS)
def test_recompute_final_repeats_its_bits(device, groups, k, c0, widths):
    """#12's max and argmax bit for bit over two calls: a key's max is
    the same in any merge order (in registers, shuffles, shared-memory
    atomics or the merge launch over a group's tiles)."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc

    g2, ws, bs, vecs, *_ = _rc_stack(groups, k, c0, widths, device)
    packed = [samlp_train.pack_weight(w) for w in ws]
    out, amax = rc.rc_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    again = rc.rc_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    assert torch.equal(again[0], out) and torch.equal(again[1], amax)


@pytest.mark.parametrize("groups,k,c0,widths", RC_STACKS)
def test_recompute_forward_device_launches(device, groups, k, c0, widths):
    """The device operations of one call (``torch.profiler``): #11 its
    kernel and one ordered reduce; #12 its kernel alone where the plan's
    tiles hold whole groups (no key buffer, no fill, no split), else its
    kernel and the merge of each group's keys over its tiles. The
    profiler now and then drops a record: a call is profiled again, up to
    three times, until it shows every operation it launched."""
    from torch.profiler import ProfilerActivity, profile

    from papc_tpu_torch.ops.kernels import samlp_recompute as rc

    g2, ws, bs, vecs, *_ = _rc_stack(groups, k, c0, widths, device)
    packed = [samlp_train.pack_weight(w) for w in ws]
    n = len(widths)
    pl = rc._fwd_plan_for("final", g2, k, widths)
    calls = {
        "stats": (lambda: rc.rc_stats(g2, vecs, ws, bs, upto=n,
                                      w_packed=packed),
                  ["rc_fwd_stats_kernel", "split_reduce_kernel"]),
        "final": (lambda: rc.rc_final(g2, vecs, ws, bs, k=k,
                                      w_packed=packed),
                  ["rc_fwd_final_kernel"]
                  + ([] if pl["whole"] else ["rc_key_merge_kernel"])),
    }
    assert pl["whole"] == (k <= 64)  # SA1 / SA2 stacks: one launch
    for name, (call, want) in calls.items():
        call()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            if len(kernels) >= len(want):
                break
        assert len(kernels) == len(want), (name, kernels)
        assert all(w in got for w, got in zip(want, kernels)), (name, kernels)


@pytest.mark.parametrize("groups,k,c0,widths", RC_STACKS)
def test_recompute_bwd_ring_depth_keeps_bits(device, monkeypatch, groups, k,
                                             c0, widths):
    """#13 and #14 with their weight ring at 3 and 2 stages, which the
    plan takes only where 4 do not fit (SA3's widths at 524 288 rows with
    a dW slot a block), give the bits of the plan's 4 stages at every
    case: the depth changes only how far ahead the slices are copied."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc

    g2, ws, bs, vecs, dout, amax, mus = _rc_stack(groups, k, c0, widths,
                                                  device)
    n = len(widths)
    packed = [samlp_train.pack_weight(w) for w in ws]
    args = (g2, dout, amax, vecs, ws, bs, mus)

    def run():
        sums = [rc.rc_bwd_stats(*args, level=lv, k=k, w_packed=packed)
                for lv in range(n, 0, -1)]
        dg, dws, dbs = rc.rc_bwd_final(*args, k=k, w_packed=packed)
        _, dws1, dbs1 = rc.rc_bwd_final(*args, k=k, w_packed=packed,
                                        need_dg=False)
        return [*sums, dg, *dws, *dbs, *dws1, *dbs1]

    plan_for = rc._bwd_plan_for
    assert plan_for("bwd_final", g2, k, widths)["stages"] == 4
    want = run()
    for stages in (3, 2):
        monkeypatch.setattr(rc, "_bwd_plan_for",
                            lambda *a, s=stages, **kw: {**plan_for(*a, **kw),
                                                        "stages": s})
        for a, b in zip(run(), want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["recompute", "recompute1"])
def test_fused_recompute_kernels_match_plain(device, mode):
    """``fused_mlp_max(mode=...)`` with the kernels against the plain
    passes on the card: outputs within 1e-3 of the largest plus one bf16
    ulp and statistics within 1e-3, every gradient within 1e-2 of its
    layer's largest (an operand rounded to the other bf16 neighbour moves
    the chain after it); the mode's four kernels launched L, 1, L and 1
    times. In both modes the cotangent is 0 at the (group, column) pairs
    whose plain top-2 margin is within twice the max's bound
    (``_clear_of_ties``, as ``test_recompute_kernels_match_plain`` holds
    the argmax): each version takes its BN vectors from its own stats
    sums, summed in its own order, so the argmax may flip there and move
    whole elements of dx and dW. ``"recompute1"``'s plain passes are
    ``"recompute"``'s, so the same pairs are cleared."""
    from papc_tpu_torch.ops.kernels import samlp_recompute, samlp_single

    rc = samlp_single if mode == "recompute1" else samlp_recompute

    gen = torch.Generator().manual_seed(11)
    shape, widths = (8, 64, 32, 3), (64, 64, 128)
    x = torch.randn(*shape, generator=gen).to(device)
    ws, bs, gammas, betas = _mlp(1, shape[-1], widths, device)
    running = [(torch.zeros(c, device=device), torch.ones(c, device=device))
               for c in widths]
    cot = torch.randn(*shape[:2], widths[-1], generator=gen).to(device)
    if mode in ("recompute", "recompute1"):
        groups, k = shape[0] * shape[1], shape[2]
        g2 = x.reshape(groups * k, shape[3]).to(torch.bfloat16)
        vecs = []
        for j, (gamma, beta) in enumerate(zip(gammas, betas), start=1):
            sums = samlp_recompute.rc_stats(g2, vecs, ws, bs, upto=j,
                                            impl="plain")
            vecs.append(samlp_train.bn_vectors(sums, gamma, beta,
                                               groups * k, 1e-5)[0])
        want, _ = samlp_recompute.rc_final(g2, vecs, ws, bs, k=k,
                                           impl="plain")
        a_list, _ = samlp_recompute.chain_plain(g2, vecs, ws, bs, len(ws))
        h = torch.clamp_min(a_list[-1] * vecs[-1][0] + vecs[-1][1], 0.0)
        cot = cot * _clear_of_ties(h, groups, k, want).reshape(cot.shape)
    results = []
    for impl in (None, "plain"):
        xg = x.clone().requires_grad_()
        params = [tuple(t.clone().requires_grad_() for t in layer)
                  for layer in zip(ws, bs, gammas, betas)]
        before = [k.launches for k in rc.KERNELS]
        out, new_running = fused_mlp.fused_mlp_max(
            xg, params, running, train=True, impl=impl, mode=mode)
        (out * cot).sum().backward()
        counts = [k.launches - b for k, b in zip(rc.KERNELS, before)]
        assert counts == ([3, 1, 3, 1] if impl is None else [0, 0, 0, 0])
        results.append((out, new_running, xg.grad,
                        [[t.grad for t in layer] for layer in params]))
    (out, run, dx, grads), (pout, prun, pdx, pgrads) = results
    _near(out, pout, 1e-3, ulp=True)
    for (m, v), (pm, pv) in zip(run, prun):
        _near(m, pm, 1e-3)
        _near(v, pv, 1e-3)
    _near(dx, pdx, 1e-2)
    for layer, players in zip(grads, pgrads):
        scale = max(float(g.abs().max()) for g in players)
        for g, pg in zip(layer, players):
            assert float((g - pg).abs().max()) <= 1e-2 * scale


def test_training_step_under_recompute_runs_its_kernels(device):
    """A reduced SSG train step under ``override(mode="recompute")``:
    #11-14 launched (9/3/9/3 a step: three stacks of three layers), no
    stream pass launched, the loss within 5e-3 of the plain recompute
    step's, every gradient finite."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.train import make_optimizer, train_step

    def step(impl):
        model = PointNet2SSGClas(num_classes=16, npoints=(128, 32),
                                 nsamples=(32, 64))
        init_params(model, torch.Generator().manual_seed(0))
        model = model.to(device)
        opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
        batch = {"points": _cloud(9, 8, 512).numpy(),
                 "label": np.arange(8) % 16, "mask": np.ones(8, bool)}
        masks = [torch.rand(8, 512, generator=torch.Generator().manual_seed(1))
                 < 0.6, torch.rand(8, 256, generator=torch.Generator()
                                   .manual_seed(2)) < 0.6]
        with fused_mlp.override(mode="recompute"):
            loss, _ = train_step(model, opt, batch, device, impl=impl,
                                 dropout_masks=masks)
        return float(loss), model

    kernels = [*rc.KERNELS, *samlp_train.KERNELS]
    before = [k.launches for k in kernels]
    loss, model = step(None)
    counts = [k.launches - b for k, b in zip(kernels, before)]
    assert counts == [9, 3, 9, 3, 0, 0, 0, 0]
    plain_loss, _ = step("plain")
    assert loss == pytest.approx(plain_loss, rel=5e-3)
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())


# ------------------------------------------- single-launch recompute

RC1_STACKS = [  # (groups, k, c0, widths): stacks samlp_single.fits admits
    (5, 32, 3, (64, 64, 128)),          # fewer groups than blocks
    (16384, 32, 3, (64, 64, 128)),      # SSG SA1 at B=32: dW on chip
    (4096, 64, 131, (128, 128, 256)),   # SSG SA2: dW in device memory
    (96, 16, 3, (32, 32, 64)),          # MSG clas SA1: K = 16
    (16384, 128, 6, (64, 96, 128)),     # MSG seg SA1 branch 2: 2 M rows
    (4096, 32, 323, (64, 64, 128)),     # MSG clas SA2 branch 0: c0 = 323
    (9, 8, 20, (16, 16, 16, 32)),       # four layers
    (7, 5, 7, (16, 24)),                # rows of 14 B: unaligned tiles
]


@pytest.mark.parametrize("groups,k,c0,widths", RC1_STACKS)
def test_single_launch_kernels_match_plain(device, groups, k, c0, widths):
    """#15-18 against their plain versions and against #11-14 on the same
    inputs, under #11-14's tolerances (``test_recompute_kernels_match_
    plain``): forward sums within 1e-3 of their largest, the max within
    that plus one bf16 ulp, the argmax equal where the plain margin is
    clear; the backward outputs no more than 1.5 times as far from the
    f32-operand plain pass as the plain bf16 pass (and as #13/#14). Each
    call launches its kernel once and repeated calls give the same bits."""
    from papc_tpu_torch.ops import fused_mlp as fm
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1

    m = groups * k
    assert fm.effective_mode("recompute1", m, k, c0, widths) == "recompute1"
    g2, ws, bs, vecs, dout, amax, mus = _rc_stack(groups, k, c0, widths,
                                                  device)
    n = len(widths)
    packed = [samlp_train.pack_weight(w) for w in ws]
    for upto in range(1, n + 1):
        before = s1.RC1_STATS.launches
        got = s1.rc1_stats(g2, vecs[:upto - 1], ws, bs, upto=upto,
                           w_packed=packed)
        assert s1.RC1_STATS.launches == before + 1
        _near(got, rc.rc_stats(g2, vecs, ws, bs, upto=upto, impl="plain"),
              1e-3)
        _near(got, rc.rc_stats(g2, vecs, ws, bs, upto=upto,
                               w_packed=packed), 1e-3)
        torch.testing.assert_close(
            s1.rc1_stats(g2, vecs, ws, bs, upto=upto, w_packed=packed), got,
            rtol=0, atol=0)
    out, got_amax = s1.rc1_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    want, want_amax = rc.rc_final(g2, vecs, ws, bs, k=k, impl="plain")
    _near(out, want, 1e-3, ulp=True)
    grid_out, grid_amax = rc.rc_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    _near(out, grid_out, 1e-3, ulp=True)
    a_list, _ = rc.chain_plain(g2, vecs, ws, bs, n)
    h = torch.clamp_min(a_list[-1] * vecs[-1][0] + vecs[-1][1], 0.0)
    clear = _clear_of_ties(h, groups, k, want)
    assert bool((got_amax == want_amax)[clear].all())
    assert bool((got_amax == grid_amax)[clear].all())
    again = s1.rc1_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    assert torch.equal(again[0], out) and torch.equal(again[1], got_amax)
    f32 = {"impl": "plain", "operand_dtype": torch.float32}
    args = (g2, dout, amax, vecs, ws, bs, mus)
    for level in range(n, 0, -1):
        got = s1.rc1_bwd_stats(*args, level=level, k=k, w_packed=packed)
        ref = rc.rc_bwd_stats(*args, level=level, k=k, **f32)
        _no_farther(got, rc.rc_bwd_stats(*args, level=level, k=k,
                                         impl="plain"), ref)
        _no_farther(got, rc.rc_bwd_stats(*args, level=level, k=k,
                                         w_packed=packed), ref)
        torch.testing.assert_close(
            s1.rc1_bwd_stats(*args, level=level, k=k, w_packed=packed), got,
            rtol=0, atol=0)
    before = s1.RC1_BWD_FINAL.launches
    got = s1.rc1_bwd_final(*args, k=k, w_packed=packed)
    assert s1.RC1_BWD_FINAL.launches == before + 1
    want = rc.rc_bwd_final(*args, k=k, impl="plain")
    grid = rc.rc_bwd_final(*args, k=k, w_packed=packed)
    ref = rc.rc_bwd_final(*args, k=k, **f32)
    for other in (want, grid):
        _no_farther(got[0], other[0], ref[0])
        for j in range(n):
            _no_farther(got[1][j], other[1][j], ref[1][j])
            _no_farther(got[2][j], other[2][j], ref[2][j])
    again = s1.rc1_bwd_final(*args, k=k, w_packed=packed)
    for a, b in zip([again[0], *again[1], *again[2]],
                    [got[0], *got[1], *got[2]]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    skip = s1.rc1_bwd_final(*args, k=k, w_packed=packed, need_dg=False)
    assert skip[0] is None
    for a, b in zip(skip[1] + skip[2], got[1] + got[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("groups,k,c0,widths", RC1_STACKS)
def test_single_launch_final_is_grid_final(device, groups, k, c0, widths):
    """#16's max and argmax equal #12's bit for bit at every case #16
    takes: both run one tile loop (``samlp_rc_fwd.cuh``), the same
    m16n8k16 products over ascending k16 steps from zero, the same ``_rn``
    bias, affine and bf16 rounding, and a max is order-free."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1

    g2, ws, bs, vecs, *_ = _rc_stack(groups, k, c0, widths, device)
    packed = [samlp_train.pack_weight(w) for w in ws]
    out, amax = s1.rc1_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    grid_out, grid_amax = rc.rc_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    assert torch.equal(out, grid_out) and torch.equal(amax, grid_amax)


def test_single_launch_is_one_device_kernel(device):
    """Each of #15-18 is ONE device kernel a call (``torch.profiler``): no
    reduce, key-splitting or fill kernel beside it, at SSG SA2's shape."""
    from torch.profiler import ProfilerActivity, profile

    from papc_tpu_torch.ops.kernels import samlp_single as s1

    groups, k, c0, widths = 4096, 64, 131, (128, 128, 256)
    g2, ws, bs, vecs, dout, amax, mus = _rc_stack(groups, k, c0, widths,
                                                  device)
    packed = [samlp_train.pack_weight(w) for w in ws]
    args = (g2, dout, amax, vecs, ws, bs, mus)
    calls = {
        "stats": lambda: s1.rc1_stats(g2, vecs, ws, bs, upto=3,
                                      w_packed=packed),
        "final": lambda: s1.rc1_final(g2, vecs, ws, bs, k=k,
                                      w_packed=packed),
        "bwd_stats": lambda: s1.rc1_bwd_stats(*args, level=1, k=k,
                                              w_packed=packed),
        "bwd_final": lambda: s1.rc1_bwd_final(*args, k=k, w_packed=packed),
    }
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "rc1_" in kernels[0], (name, kernels)


def _forced_fwd_plan(kind, g2, k, widths, *, upto=None, **force):
    """#15 / #16's plan for these inputs (``samlp_single.fwd_plan``) with
    some choices forced (``tm``, ``w_res``, ``stages``, ``blocks``): its
    product table re-derived for the tile."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1
    from papc_tpu_torch.ops.kernels.samlp_train import _pad

    props = torch.cuda.get_device_properties(g2.device)
    pl = s1.fwd_plan(kind, g2.shape[0], 1 if kind == "stats" else k,
                     g2.shape[1], tuple(widths), samlp_train._smem_limit(g2),
                     upto=upto, sms=props.multi_processor_count)
    pl = {**pl, **force}
    n = upto if kind == "stats" else len(widths)
    p = [_pad(c) for c in (g2.shape[1], *widths)][:n + 1]
    return {**pl, "prods": rc._bwd_schedule(p, pl["tm"], n + 1)}


@pytest.mark.parametrize("groups,k,c0,widths,tm,blocks", [
    (40, 128, 3, (64, 64, 128), 32, 7),     # a group over 4 tiles
    (40, 128, 3, (64, 64, 128), 64, 7),     # ... over 2 tiles
    (96, 48, 3, (32, 32, 64), 32, 5),       # k = 48: 8-row merges, carried
    (200, 5, 7, (16, 24), 32, 3),           # rows of 14 B, k = 5
    (7, 5, 7, (16, 24), 32, 1),             # the ragged RC1 stack
])
def test_single_final_carries_groups_across_tiles(device, monkeypatch,
                                                  groups, k, c0, widths, tm,
                                                  blocks):
    """#16 where a group runs on into the block's next tile (k does not
    divide the tile, or k > tm: forced by a monkeypatched plan, as no
    registry stack the gate admits plans it): the open group's keys are
    carried in shared memory, and out and amax equal #12's bit for bit
    (#12 merges the same keys through its key slots) and plain's within
    #12's tolerances. One launch a call."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1

    g2, ws, bs, vecs, *_ = _rc_stack(groups, k, c0, widths, device)
    packed = [samlp_train.pack_weight(w) for w in ws]
    pl = _forced_fwd_plan("final", g2, k, widths, tm=tm, blocks=blocks,
                          w_res=False, stages=4)
    assert tm % k != 0 and pl["unit"] % k == 0
    monkeypatch.setattr(s1, "_plan_for", lambda *a, **kw: pl)
    before = s1.RC1_FINAL.launches
    out, amax = s1.rc1_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    assert s1.RC1_FINAL.launches == before + 1
    grid_out, grid_amax = rc.rc_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    assert torch.equal(out, grid_out) and torch.equal(amax, grid_amax)
    want, want_amax = rc.rc_final(g2, vecs, ws, bs, k=k, impl="plain")
    _near(out, want, 1e-3, ulp=True)
    a_list, _ = rc.chain_plain(g2, vecs, ws, bs, len(widths))
    h = torch.clamp_min(a_list[-1] * vecs[-1][0] + vecs[-1][1], 0.0)
    clear = _clear_of_ties(h, groups, k, want)
    assert bool((amax == want_amax)[clear].all())


@pytest.mark.parametrize("groups,k,c0,widths,blocks", [
    (625, 8, 20, (16, 16, 16, 32), 7),      # ranges of 712-720 rows
    (150, 32, 3, (64, 64, 128), 7),         # 21-22 groups a block
    (1001, 16, 3, (32, 32, 64), 12),        # 83-84 groups a block
])
def test_single_forward_masks_rows_past_the_range(device, monkeypatch,
                                                  groups, k, c0, widths,
                                                  blocks):
    """#15 and #16 on block ranges that end inside a tile, with more
    groups than blocks and ranges of unequal length (the plan's blocks
    forced lower, its tile to 128 rows): each block sums only its own rows and writes only its
    own groups, so the sums stay within 1e-3 of plain's and of #11's, and
    out and amax equal #12's bit for bit. A block that summed rows past
    its range would count them twice; one that wrote a group past it
    would race its neighbour."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1

    g2, ws, bs, vecs, *_ = _rc_stack(groups, k, c0, widths, device)
    m = groups * k
    packed = [samlp_train.pack_weight(w) for w in ws]
    plans = {}

    def plan_for(kind, g2_, k_, widths_, **kw):
        pl = _forced_fwd_plan(kind, g2_, k_, widths_, blocks=blocks,
                              tm=128, **kw)
        plans[kind] = pl
        return pl

    monkeypatch.setattr(s1, "_plan_for", plan_for)
    for upto in range(1, len(widths) + 1):
        got = s1.rc1_stats(g2, vecs[:upto - 1], ws, bs, upto=upto,
                           w_packed=packed)
        ranges = s1.block_rows(m, plans["stats"]["unit"], blocks)
        assert any((hi - lo) % plans["stats"]["tm"] for lo, hi in ranges)
        _near(got, rc.rc_stats(g2, vecs, ws, bs, upto=upto, impl="plain"),
              1e-3)
        _near(got, rc.rc_stats(g2, vecs, ws, bs, upto=upto,
                               w_packed=packed), 1e-3)
    out, amax = s1.rc1_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    ranges = s1.block_rows(m, plans["final"]["unit"], blocks)
    assert len({hi - lo for lo, hi in ranges}) > 1
    assert any((hi - lo) % 128 for lo, hi in ranges)
    grid_out, grid_amax = rc.rc_final(g2, vecs, ws, bs, k=k, w_packed=packed)
    assert torch.equal(out, grid_out) and torch.equal(amax, grid_amax)


@pytest.mark.parametrize("groups,k,c0,widths", [
    (16384, 32, 3, (64, 64, 128)),      # SSG SA1: the plan keeps W resident
    (4096, 64, 131, (128, 128, 256)),   # SSG SA2: the ring at layers 2-3
    (9, 8, 20, (16, 16, 16, 32)),       # four layers
    (7, 5, 7, (16, 24)),                # rows of 14 B
])
def test_single_forward_weights_keep_bits(device, monkeypatch, groups, k,
                                          c0, widths):
    """#15 at every layer and #16 with the weights resident, and through
    a 4-, 3- and 2-stage ring, on the same grid (one block an SM, so
    every variant fits): the same bits (sums, out, amax). Residency and
    the ring's depth change only where and how far ahead a product reads
    W; the blocks' ranges, and so the order of every sum, stay."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1

    g2, ws, bs, vecs, *_ = _rc_stack(groups, k, c0, widths, device)
    packed = [samlp_train.pack_weight(w) for w in ws]
    n, m = len(widths), groups * k
    limit = samlp_train._smem_limit(g2)
    ran = 0
    for kind, upto in [("stats", lv) for lv in range(1, n + 1)] + [
            ("final", None)]:
        kk = 1 if kind == "stats" else k
        base = _forced_fwd_plan(kind, g2, k, widths, upto=upto)
        base["blocks"] = min(-(-m // base["unit"]), 132)
        results = []
        for w_res, stages in ((True, 0), (False, 4), (False, 3),
                              (False, 2)):
            if rc.fwd_smem_bytes(kind, base["tm"], kk, c0, widths,
                                 upto=upto, stages=stages,
                                 w_res=w_res) > limit:
                continue
            pl = {**base, "w_res": w_res, "stages": stages}
            monkeypatch.setattr(s1, "_plan_for", lambda *a, pl=pl, **kw: pl)
            if kind == "stats":
                results.append([s1.rc1_stats(g2, vecs[:upto - 1], ws, bs,
                                             upto=upto, w_packed=packed)])
            else:
                results.append(list(s1.rc1_final(g2, vecs, ws, bs, k=k,
                                                 w_packed=packed)))
        assert len(results) >= 3
        ran += len(results)
        for got in results[1:]:
            for a, b in zip(got, results[0]):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ran >= 3 * (n + 1)


@pytest.mark.parametrize("groups,k,c0,widths", RC1_STACKS)
def test_single_bwd_final_dg_is_grid_dg(device, groups, k, c0, widths):
    """#18's dg equals #14's bit for bit where their plans take the same
    row tile (every ``RC1_STACKS`` case): both run the one tile function
    (``bwd_tile``), every dg element the same products in the same order,
    whether W comes from #14's ring or #18's resident copy and wherever
    the block ranges cut the tiles."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1

    g2, ws, bs, vecs, dout, amax, mus = _rc_stack(groups, k, c0, widths,
                                                  device)
    packed = [samlp_train.pack_weight(w) for w in ws]
    assert (s1._bwd_plan_for("bwd_final", g2, k, widths)["tm"]
            == rc._bwd_plan_for("bwd_final", g2, k, widths)["tm"])
    args = (g2, dout, amax, vecs, ws, bs, mus)
    got = s1.rc1_bwd_final(*args, k=k, w_packed=packed)[0]
    want = rc.rc_bwd_final(*args, k=k, w_packed=packed)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("groups,k,c0,widths", [
    (16384, 32, 3, (64, 64, 128)),      # SSG SA1 at B=32
    (96, 16, 3, (32, 32, 64)),          # MSG clas SA1: K = 16
    (9, 8, 20, (16, 16, 16, 32)),       # four layers
])
def test_single_bwd_resident_weights_keep_bits(device, monkeypatch, groups,
                                               k, c0, widths):
    """#17 and #18 with the weights through #13 / #14's 4-stage ring at
    stacks whose plan keeps them resident give the resident run's bits
    (sums, dg, dW, db): residency changes only where a product reads W."""
    from papc_tpu_torch.ops.kernels import samlp_single as s1

    g2, ws, bs, vecs, dout, amax, mus = _rc_stack(groups, k, c0, widths,
                                                  device)
    n = len(widths)
    packed = [samlp_train.pack_weight(w) for w in ws]
    args = (g2, dout, amax, vecs, ws, bs, mus)

    def run():
        sums = [s1.rc1_bwd_stats(*args, level=lv, k=k, w_packed=packed)
                for lv in range(n, 0, -1)]
        dg, dws, dbs = s1.rc1_bwd_final(*args, k=k, w_packed=packed)
        return [*sums, dg, *dws, *dbs]

    plan_for = s1._bwd_plan_for
    assert all(plan_for("bwd_stats", g2, k, widths, level=lv)["w_res"]
               for lv in range(1, n + 1))
    assert plan_for("bwd_final", g2, k, widths)["w_res"]
    want = run()
    monkeypatch.setattr(s1, "_bwd_plan_for",
                        lambda *a, **kw: {**plan_for(*a, **kw),
                                          "w_res": False, "stages": 4})
    for a, b in zip(run(), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_training_step_under_recompute1_runs_its_kernels(device):
    """A reduced SSG train step under ``override(mode="recompute1")``:
    #15-18 launched 6/2/6/2 (SA1 and SA2, three layers each), the stream
    passes 3/1/1/3 on the demoted SA3, #11-14 never; the loss within 5e-3
    of the plain recompute1 step's, every gradient finite."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1
    from papc_tpu_torch.train import make_optimizer, train_step

    def step(impl):
        model = PointNet2SSGClas(num_classes=16, npoints=(128, 32),
                                 nsamples=(32, 64))
        init_params(model, torch.Generator().manual_seed(0))
        model = model.to(device)
        opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
        batch = {"points": _cloud(9, 8, 512).numpy(),
                 "label": np.arange(8) % 16, "mask": np.ones(8, bool)}
        masks = [torch.rand(8, 512, generator=torch.Generator().manual_seed(1))
                 < 0.6, torch.rand(8, 256, generator=torch.Generator()
                                   .manual_seed(2)) < 0.6]
        with fused_mlp.override(mode="recompute1"):
            loss, _ = train_step(model, opt, batch, device, impl=impl,
                                 dropout_masks=masks)
        return float(loss), model

    kernels = [*s1.KERNELS, *rc.KERNELS, *samlp_train.KERNELS]
    before = [k.launches for k in kernels]
    loss, model = step(None)
    counts = [k.launches - b for k, b in zip(kernels, before)]
    assert counts == [6, 2, 6, 2, 0, 0, 0, 0, 3, 1, 1, 3]
    plain_loss, _ = step("plain")
    assert loss == pytest.approx(plain_loss, rel=5e-3)
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())


# ------------------------------------------------------------ detection



def _standup_iou(boxes):
    c = box5_to_corners(boxes)
    s = torch.cat([c.amin(-2), c.amax(-2)], dim=-1)
    return iou_2d(s, s).contiguous()


NMS_SHAPES = [(2, 1000), (1, 1), (3, 31), (1, 1025), (3, 1000), (2, 63),
              (1, 64), (2, 65), (1, 2048)]


@pytest.mark.parametrize("B,K", NMS_SHAPES)
def test_rotate_nms_kernel_equals_plain(device, B, K):
    boxes = clustered_rboxes(K + B, B, K).to(device)
    valid = torch.rand(B, K, generator=torch.Generator().manual_seed(K)) > 0.1
    valid = valid.to(device)
    for thr in (0.1, 0.5):
        before = nms.ROTATE.launches
        got = nms.rotate_nms(boxes, valid, thr)
        assert nms.ROTATE.launches == before + 1
        want = nms.rotate_nms(boxes, valid, thr, impl="plain")
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(nms.rotate_nms(boxes, valid, thr), got,
                                   rtol=0, atol=0)
        if K >= 1000:
            assert 0 < int(got.sum()) < int(valid.sum())
    none = torch.zeros_like(valid)
    assert not bool(nms.rotate_nms(boxes, none, 0.5).any())


@pytest.mark.parametrize("B,K", NMS_SHAPES)
def test_greedy_nms_kernel_equals_plain(device, B, K):
    iou = _standup_iou(clustered_rboxes(K * B, B, K).to(device))
    valid = torch.rand(B, K, generator=torch.Generator().manual_seed(B)) > 0.1
    valid = valid.to(device)
    for thr in (0.1, 0.5):
        before = nms.GREEDY.launches
        got = nms.greedy_suppress(iou, valid, thr)
        assert nms.GREEDY.launches == before + 1
        want = nms.greedy_suppress(iou, valid, thr, impl="plain")
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(nms.greedy_suppress(iou, valid, thr), got,
                                   rtol=0, atol=0)
    none = torch.zeros_like(valid)
    assert not bool(nms.greedy_suppress(iou, none, 0.5).any())


# pairs whose plain IoU lies this close to the threshold may take the
# other bit: kernel and plain sum the intersection's shoelace in another
# order (a few ulps of areas of up to some 60 m^2)
NEAR_THRESHOLD = 1e-5


@pytest.mark.parametrize("name,B,K", [("clustered", 2, 1000),
                                      ("clustered", 2, 65),
                                      ("near-degenerate", 2, 2048)])
def test_rotate_nms_stages_equal_their_twins(device, name, B, K):
    """The mask kernel's bits against ``rotate_mask_plain``'s (a pair may
    differ only within ``NEAR_THRESHOLD`` of the threshold, and is
    named), the sweep's keep mask against ``sweep_mask_plain`` over the
    kernel's own bits (exactly), the same bits over two calls; the
    near-degenerate set clips some pairs again in the 64-slot ring."""
    make = clustered_rboxes if name == "clustered" else near_degenerate_rboxes
    boxes = make(K + B, B, K).to(device)
    valid = torch.rand(B, K, generator=torch.Generator().manual_seed(K)) > 0.1
    valid = valid.to(device)
    iou_t = rotate_iou(boxes, boxes).transpose(-1, -2)
    for thr in (0.1, 0.5):
        keep, mask, overflow = nms.rotate_nms_stages(boxes, valid, thr)
        want = nms.rotate_mask_plain(boxes, valid, thr)
        differ = (nms.unpack_bits(mask, K)
                  != nms.unpack_bits(want, K)).nonzero().tolist()
        for b, i, j in differ:
            gap = float(iou_t[b, i, j]) - thr
            print(f"{name} thr {thr}: pair ({i}, {j}) of frame {b} takes "
                  f"the other bit, plain IoU {thr} {gap:+.3e}")
            assert abs(gap) <= NEAR_THRESHOLD
        assert torch.equal(keep, nms.sweep_mask_plain(mask, valid))
        again = nms.rotate_nms_stages(boxes, valid, thr)
        assert torch.equal(again[0], keep) and torch.equal(again[1], mask)
        assert again[2] == overflow
        if name == "near-degenerate":
            assert overflow > 0


@pytest.mark.parametrize("B,K", [(2, 1000), (3, 65), (1, 10000)])
def test_greedy_nms_stages_equal_their_twins(device, B, K):
    """The mask kernel's bits equal ``greedy_mask_plain``'s (the same f32
    compare; NaN sets no bit), the sweep's keep mask equals
    ``sweep_mask_plain`` over them and the plain loop's; the same bits
    over two calls. At K = 10000 the sweep reads its row blocks from L2
    (no ring fits)."""
    iou = _standup_iou(clustered_rboxes(K * B, B, K).to(device))
    iou[:, :, ::7] = float("nan")
    valid = torch.rand(B, K, generator=torch.Generator().manual_seed(B)) > 0.1
    valid = valid.to(device)
    assert nms.sweep_plan(K).staged == (K < 10000)
    for thr in (0.1, 0.5):
        keep, mask = nms.greedy_suppress_stages(iou, valid, thr)
        assert torch.equal(mask, nms.greedy_mask_plain(iou, valid, thr))
        assert torch.equal(keep, nms.sweep_mask_plain(mask, valid))
        assert torch.equal(keep, nms.greedy_suppress(iou, valid, thr,
                                                     impl="plain"))
        again = nms.greedy_suppress_stages(iou, valid, thr)
        assert torch.equal(again[0], keep) and torch.equal(again[1], mask)


@pytest.mark.parametrize("step", [1, 2, 63])
def test_greedy_nms_kernel_long_chains(device, step):
    """Each box overlaps only the box ``step`` rows on: chains of
    suppressions as long as a 64-row block at step 1, so the sweep's
    fixpoint runs out of rounds and decides each row serially."""
    K = 1000
    idx = torch.arange(K, device=device)
    iou = ((idx[:, None] - idx[None, :]).abs() == step).float()[None]
    valid = torch.ones(1, K, dtype=torch.bool, device=device)
    valid[0, 500] = False
    got = nms.greedy_suppress(iou, valid, 0.5)
    want = nms.greedy_suppress(iou, valid, 0.5, impl="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert 0 < int(got.sum()) < K - 1


def test_nms_kernels_raise_above_their_limits(device):
    k = nms.ROTATE_MAX_K + 1
    with pytest.raises(ValueError, match=f"limit of {nms.ROTATE_MAX_K}"):
        nms.rotate_nms(torch.zeros(1, k, 5, device=device),
                       torch.ones(1, k, dtype=torch.bool, device=device), 0.5)
    k = nms.GREEDY_MAX_K + 1  # a K x K matrix that is never materialised
    with pytest.raises(ValueError, match=f"limit of {nms.GREEDY_MAX_K}"):
        nms.greedy_suppress_cuda(
            torch.zeros(1, 1, 1, device=device).expand(1, k, k),
            torch.ones(1, k, dtype=torch.bool, device=device), 0.5)


def test_reduced_detection_slice_on_the_card(device):
    """Raw points → detections on a reduced car config (64 × 64 grid):
    both NMS kernels launched, detections equal to the plain run (the
    serving step runs its convolutions in f32 itself)."""
    cfg = car_config()
    cfg_from_list(cfg, ["VOXEL_GENERATOR.VOXEL_SIZE", "[1.08, 1.24, 4]",
                        "VOXEL_GENERATOR.MAX_NUMBER_OF_POINTS_PER_VOXEL", "32",
                        "MODEL.POST_PROCESSING.nms_pre_max_size", "512"])
    gen = cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS[0].anchor_generator_stride
    gen.strides, gen.offsets = [2.16, 2.48, 0.0], [1.08, -38.44, -1.78]
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    model = builders.build_network(cfg, vg, builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, coder))
    init_params(model, torch.Generator().manual_seed(0))
    anchors = builders.build_anchors(cfg, vg)
    frames = SyntheticFrames(2, anchors, max_points=8000, seed=1,
                             n_background=6000)
    batch = collate_batch([frames[0], frames[1]])
    pillarize = make_pillarizer(vg, 2000)
    for rotate, kernel in [(True, nms.ROTATE), (False, nms.GREEDY)]:
        cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms",
                            str(rotate)])
        pcfg = builders.build_predict_config(cfg, coder)
        before = kernel.launches
        got = make_predict_step(model, pcfg, coder, pillarize, device)(batch)
        assert kernel.launches == before + 1
        want = make_predict_step(model, pcfg, coder, pillarize, device,
                                 impl="plain")(batch)
        for k in got:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        assert bool(got["valid"].any())


@pytest.mark.parametrize("rotate", [True, False])
def test_predict_multiclass_kernels_match_plain(device, rotate):
    """The 3-class config's per-class NMS, batched: B=2 frames x 3
    classes, each class's candidates (score at least 0.15, the first
    K = 1000) in one launch of #20 (rotated) or #19 (standup) for the
    whole batch; the detections equal the plain run's on the same card
    exactly (the kernels' masks part from plain only at a pair within
    ulps of the threshold). Every class has candidates, and one fills
    K."""
    from papc_tpu_torch.detect import detector

    rs = np.random.RandomState(4)
    B, A, C = 2, 20000, 3
    boxes = np.concatenate([
        rs.uniform(0, 20, (B, A, 1)), rs.uniform(-10, 10, (B, A, 1)),
        np.full((B, A, 1), -1.6), rs.uniform(0.5, 2.0, (B, A, 1)),
        rs.uniform(0.8, 4.5, (B, A, 1)), rs.uniform(1.4, 1.8, (B, A, 1)),
        rs.uniform(-np.pi, np.pi, (B, A, 1))], -1).astype(np.float32)
    scores = np.empty((B, A, C), np.float32)
    for b in range(B):
        for c, top in enumerate((1.0, 0.2, 0.152)):
            scores[b, :, c] = (rs.permutation(A) + 0.5) / A * top
    dirs = rs.randint(0, 2, (B, A))
    mask = rs.rand(B, A) > 0.1
    cfg = detector.PredictConfig(num_class=C, multiclass_nms=True,
                                 use_rotate_nms=rotate,
                                 nms_pre_max_size=1000,
                                 nms_post_max_size=3000,
                                 nms_score_threshold=0.15,
                                 nms_iou_threshold=0.5)
    args = [torch.from_numpy(a).to(device) for a in (boxes, scores, dirs,
                                                     mask)]
    *_, ok = detector.multiclass_candidates(*args[:3], cfg,
                                            anchors_mask=args[3])
    per_class = ok.sum(-1)
    assert bool((per_class > 0).all()) and int(per_class.max()) == 1000
    assert int(per_class.min()) < 1000
    kernel = nms.ROTATE if rotate else nms.GREEDY
    before = kernel.launches
    got = detector.predict_multiclass(*args[:3], cfg, anchors_mask=args[3])
    assert kernel.launches == before + 1
    want = detector.predict_multiclass(*args[:3], cfg, anchors_mask=args[3],
                                       impl="plain")
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    labels = got["label_preds"][got["valid"]]
    assert set(labels.tolist()) == {0, 1, 2}


def _pillar_grid(seed, B=2, V=2000, P=32, D=4):
    """Seeded pillars at the car config's range ``(voxels, num_points,
    coords)``: ten full pillars and an empty one a frame, with their flat
    view ``(points, owner)`` in (pillar, slot) order, padded with zeros /
    -1."""
    rs = np.random.RandomState(seed)
    vs, pr = (0.16, 0.16, 4.0), (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
    coords = np.stack([np.zeros((B, V)), rs.randint(0, 496, (B, V)),
                       rs.randint(0, 432, (B, V))], -1).astype(np.int32)
    num_points = rs.randint(1, P + 1, (B, V)).astype(np.int32)
    num_points[:, :10] = P
    num_points[:, 10] = 0
    voxels = np.zeros((B, V, P, D), np.float32)
    voxels[..., 0] = (coords[..., 2] * vs[0] + vs[0] / 2)[..., None] \
        + 0.05 * rs.randn(B, V, P)
    voxels[..., 1] = (coords[..., 1] * vs[1] + vs[1] / 2 + pr[1])[..., None] \
        + 0.05 * rs.randn(B, V, P)
    voxels[..., 2] = rs.uniform(-3, 1, (B, V, P))
    voxels[..., 3] = rs.rand(B, V, P)
    voxels *= (np.arange(P)[None, None, :] < num_points[..., None])[..., None]
    points = np.zeros((B, int(num_points.sum(1).max()), D), np.float32)
    owner = np.full(points.shape[:2], -1, np.int32)
    for b in range(B):
        v_idx, p_idx = np.nonzero(np.arange(P)[None, :]
                                  < num_points[b][:, None])
        points[b, :len(v_idx)] = voxels[b, v_idx, p_idx]
        owner[b, :len(v_idx)] = v_idx
    return voxels, num_points, coords, points, owner, vs, pr


def test_flat_pfn_on_the_card_matches_the_classic_pfn(device):
    """The PFN on flat points (``pfn_forward_flat``, plain torch ops)
    against the same PFN on the grid they were flattened from, both on the card in
    training mode from one state dict: the outputs (rtol 1e-4, atol 1e-5),
    the running mean (1e-4, 1e-6) and variance (1e-3, 1e-6), the
    gradients of the kernel, scale and bias within 2e-3 relative L2 (a
    near-tie of two points may take the max the other way); and the flat
    PFN's output on the card against its own on the CPU (1e-4, 1e-5)."""
    from papc_tpu_torch.detect.model import PillarFeatureNet

    P = 32
    voxels, num_points, coords, points, owner, vs, pr = _pillar_grid(0, P=P)
    classic = PillarFeatureNet(4, (64,), vs, pr, max_points_per_pillar=P)
    init_params(classic, torch.Generator().manual_seed(0))
    flat, cpu_flat = copy.deepcopy(classic), copy.deepcopy(classic)
    cot = torch.from_numpy(np.random.RandomState(1).randn(
        2, voxels.shape[1], 64).astype(np.float32))
    t = torch.from_numpy
    runs = []
    for m, args, dev in (
            (classic, (voxels, num_points, coords), device),
            (flat, (None, num_points, coords, points, owner), device),
            (cpu_flat, (None, num_points, coords, points, owner), "cpu")):
        m.to(dev).train()
        out = m(*(None if a is None else t(a).to(dev) for a in args))
        (out * cot.to(dev)).sum().backward()
        layer = m.PFNLayer_0
        runs.append((out.detach().cpu(),
                     layer.BatchNorm_0.running_mean.cpu(),
                     layer.BatchNorm_0.running_var.cpu(),
                     [p.grad.cpu() for p in (layer.Dense_0.weight,
                                             layer.BatchNorm_0.weight,
                                             layer.BatchNorm_0.bias)]))
    (w_out, w_mean, w_var, w_grads), (out, mean, var, grads), cpu = runs
    torch.testing.assert_close(out, w_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mean, w_mean, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(var, w_var, rtol=1e-3, atol=1e-6)
    for g, w in zip(grads, w_grads):
        assert float((g - w).norm() / w.norm()) <= 2e-3
    torch.testing.assert_close(out, cpu[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "grid"])
def test_bf16_detection_step_on_the_card(device, flat):
    """``precision="bf16"`` on a host-pillarized batch (the flat PFN, or
    the classic one on the host's grid) at a reduced car config: a train
    step with a finite loss, f32 gradients, parameters, Adam moments and
    running statistics after it; then bf16 serving with the rotated NMS
    kernel launched once, finite f32 detections equal to the plain
    run's."""
    from papc_tpu_torch.data.synthetic_kitti import host_pillarize
    from papc_tpu_torch.detect.train import (example_to_batch,
                                             make_detection_train_step)

    cfg = car_config()
    cfg_from_list(cfg, ["VOXEL_GENERATOR.VOXEL_SIZE", "[1.08, 1.24, 4]",
                        "VOXEL_GENERATOR.MAX_NUMBER_OF_POINTS_PER_VOXEL", "32",
                        "MODEL.POST_PROCESSING.nms_pre_max_size", "512"])
    cfg.MODEL["PFN_FLAT"] = flat
    gen = cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS[0].anchor_generator_stride
    gen.strides, gen.offsets = [2.16, 2.48, 0.0], [1.08, -38.44, -1.78]
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    ta = builders.build_target_assigner(cfg.TARGET_ASSIGNER, coder)
    model = builders.build_network(cfg, vg, ta)
    init_params(model, torch.Generator().manual_seed(0))
    out = ta.generate_anchors([1, int(vg.grid_size[1]) // 2,
                               int(vg.grid_size[0]) // 2])
    frames = SyntheticFrames(
        2, out["anchors"].reshape(-1, 7), max_points=8000, seed=1,
        n_background=6000, target_assigner=ta,
        matched_thresholds=out["matched_thresholds"],
        unmatched_thresholds=out["unmatched_thresholds"])
    batch = example_to_batch(collate_batch(
        [host_pillarize(frames[i], vg, 2000, flat) for i in range(2)]))
    assert ("points_flat" in batch) == flat
    opt, sched = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER,
                                          model.parameters())
    pillarize = make_pillarizer(vg, 2000)
    step, init_rm = make_detection_train_step(
        model, builders.build_loss_config(cfg, coder), opt, sched, pillarize,
        device, precision="bf16")
    var0 = model.pfn.PFNLayer_0.BatchNorm_0.running_var.clone()
    metrics, _ = step(batch, init_rm())
    assert bool(torch.isfinite(metrics["loss"])) and int(metrics["num_pos"]) > 0
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
    assert all(s[k].dtype == torch.float32 for s in opt.state.values()
               for k in ("exp_avg", "exp_avg_sq"))
    var = model.pfn.PFNLayer_0.BatchNorm_0.running_var
    assert var.dtype == torch.float32 and not torch.equal(var, var0)
    pcfg = builders.build_predict_config(cfg, coder)
    before = nms.ROTATE.launches
    dets = make_predict_step(model, pcfg, coder, pillarize, device,
                             precision="bf16")(batch)
    assert nms.ROTATE.launches == before + 1
    assert dets["box3d_lidar"].dtype == torch.float32
    assert bool(torch.isfinite(dets["box3d_lidar"]).all())
    # the forward repeats its bits (the flat PFN's pillar sums are a
    # sorted segment sum, not atomics), so plain serving equals it
    want = make_predict_step(model, pcfg, coder, pillarize, device,
                             precision="bf16", impl="plain")(batch)
    for k in dets:
        torch.testing.assert_close(dets[k], want[k], rtol=0, atol=0)
