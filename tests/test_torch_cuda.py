"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test skips (the ``device``
fixture decides, at run time). This file imports no JAX, so it also runs
on a machine that has only the port's dependencies, without the repo's
JAX conftest::

    python -m pytest tests/test_torch_cuda.py --noconftest -q

FPS, ball query and the gather must equal their plain versions exactly;
the eval MLP+max within 1e-2 (abs and rel), because both round every
activation to bf16 and sum the exact f32 products in another order, so a
sum next to a bf16 rounding boundary can round the other way.

The training kernels on identical inputs: ``finalize_max`` (max and
argmax) and ``bwd_seed``'s ``dy`` exactly; stored bf16 activations
(``linear_stats``' a, ``bwd_layer``'s dy') within one bf16 ulp plus 1e-4
of the largest (a product summed in another order moves a value that
cancels to near 0 by many of its own ulps), 1e-3 for dy', whose ``da``
may round to the other bf16 neighbour; f32 sums, dW, db and dg within
1e-3 of the largest magnitude (sums over up to 524288 rows in another
order); the scatter-add within 1e-5 (f32 atomics in run-dependent
order). A reduced training step's loss within 5e-3 of the plain step's
(bf16 rounding flips between the two carry through three SA stages).

The NMS sweeps must equal their plain versions exactly (keep masks), and
a reduced detection slice's detections with the kernels must equal the
plain run's.

The row scatter-add (the backward of ``index_points``) within 1e-5 of its
largest (f32 atomics), out-of-range indices contributing nothing; the
eval MLP at MSG classification's SA3 width (c0 = 643, a group split over
two 64-row blocks) and the training passes at MSG's widths (196, 643)
and K = 16 under the tolerances above; the MSG classifier and both
segmentation models' train steps with every kernel launched.
"""

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
from papc_tpu_torch.ops.iou import box5_to_corners, iou_2d
from papc_tpu_torch.ops.kernels import (ball_query, fps, gather, nms, samlp,
                                        samlp_train, scatter_rows)

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


@pytest.mark.parametrize("B,N,npoint", [(3, 1000, 100), (2, 33, 33),
                                        (1, 4096, 256), (32, 1024, 512)])
def test_fps_kernel_equals_plain(device, B, N, npoint):
    xyz = _cloud(B + N, B, N).to(device)
    start = torch.randint(0, N, (B,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(N)).to(device)
    before = fps.KERNEL.launches
    got = fps.farthest_point_sample(xyz, npoint, start)
    assert fps.KERNEL.launches == before + 1
    want = fps.farthest_point_sample(xyz, npoint, start, impl="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fps_kernel_ties(device):
    base = _cloud(3, 1, 40)
    xyz = torch.cat([base, base, base], dim=1).to(device)
    got = sampling.farthest_point_sample(xyz, 60)
    want = sampling.farthest_point_sample(xyz, 60, impl="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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


@pytest.mark.parametrize("B,N,D,S,K", [(2, 100, 0, 13, 8), (3, 64, 5, 7, 32),
                                       (32, 512, 128, 128, 64)])
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
    (32, 128, 643, (256, 512, 1024)),  # MSG clas SA3: 64-row tiles, split
    (5, 128, 643, (256, 512, 1024)),   # split groups, few blocks
    (64, 128, 323, (128, 196, 256)),   # MSG seg SA2: width 196
    (96, 16, 3, (32, 32, 64)),         # MSG clas SA1: K = 16
])
def test_samlp_kernel_matches_plain(device, groups, k, c0, widths):
    ws, bs, scales, shifts = _mlp(groups * k, c0, widths, device)
    x = torch.randn(groups * k, c0,
                    generator=torch.Generator().manual_seed(k)).to(device)
    got = samlp.eval_mlp_max(x, ws, bs, scales, shifts, k=k)
    want = samlp.eval_mlp_max(x, ws, bs, scales, shifts, k=k, impl="plain")
    assert got.shape == (groups, widths[-1])
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


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


@pytest.mark.parametrize("m,cin,cout,k", TRAIN_LAYERS)
def test_linear_stats_kernel_matches_plain(device, m, cin, cout, k):
    x = _bf16((m, cin), m + cin, device)
    g = torch.Generator().manual_seed(cout)
    w = (torch.randn(cin, cout, generator=g) / cin ** 0.5).to(device)
    b = (0.1 * torch.randn(cout, generator=g)).to(device)
    for vec in (None, _vec4(cin, cin, device)):
        before = samlp_train.LINEAR_STATS.launches
        a, sums = samlp_train.linear_stats(x, vec, w, b)
        assert samlp_train.LINEAR_STATS.launches == before + 1
        want_a, want_sums = samlp_train.linear_stats(x, vec, w, b,
                                                     impl="plain")
        assert a.dtype == torch.bfloat16 and a.shape == (m, cout)
        _near(a, want_a, 1e-4, ulp=True)
        _near(sums, want_sums, 1e-3)
        again = samlp_train.linear_stats(x, vec, w, b)[1]
        torch.testing.assert_close(again, sums, rtol=0, atol=0)  # fixed order


@pytest.mark.parametrize("m,cin,cout,k", TRAIN_LAYERS)
def test_finalize_and_seed_kernels_equal_plain(device, m, cin, cout, k):
    if m % k:
        m = m // k * k
    a = _bf16((m, cout), m, device)
    a[1::k] = a[0::k]  # exact ties inside each group
    vec = _vec4(cout, cout, device)
    out, amax = samlp_train.finalize_max(a, vec, k=k)
    want, want_amax = samlp_train.finalize_max(a, vec, k=k, impl="plain")
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(amax, want_amax, rtol=0, atol=0)
    dout = torch.randn(m // k, cout, generator=torch.Generator().manual_seed(k)
                       ).to(device)
    dy, s = samlp_train.bwd_seed(a, vec, dout, amax, k=k)
    want_dy, want_s = samlp_train.bwd_seed(a, vec, dout, amax, k=k,
                                           impl="plain")
    torch.testing.assert_close(dy, want_dy, rtol=0, atol=0)
    _near(s, want_s, 1e-3)
    again = samlp_train.bwd_seed(a, vec, dout, amax, k=k)[1]
    torch.testing.assert_close(again, s, rtol=0, atol=0)  # fixed order


@pytest.mark.parametrize("m,cin,cout,k", TRAIN_LAYERS)
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
    skip = samlp_train.bwd_layer(dy, a, a_prev, w, vec, s_in, None,
                                 need_dprev=False)
    assert skip[0] is None
    torch.testing.assert_close(skip[1], got[1], rtol=0, atol=0)  # fixed order
    torch.testing.assert_close(skip[2], got[2], rtol=0, atol=0)


@pytest.mark.parametrize("B,N,S,K,C", [(2, 50, 7, 8, 5), (32, 1024, 512, 32, 3),
                                       (32, 512, 128, 64, 131)])
def test_scatter_add_kernel_matches_plain(device, B, N, S, K, C):
    gen = torch.Generator().manual_seed(B * N)
    g = torch.randn(B, S, K, C, generator=gen).to(device)
    idx = torch.randint(-1, N + 1, (B, S, K), generator=gen,
                        dtype=torch.int32).to(device)
    before = gather.SCATTER_KERNEL.launches
    got = gather.scatter_add(g, idx, N)
    assert gather.SCATTER_KERNEL.launches == before + 1
    _near(got, gather.scatter_add(g, idx, N, impl="plain"), 1e-5)


@pytest.mark.parametrize("B,R,C,n,kind", [
    (2, 50, 5, 7, "range"), (32, 128 * 128, 323, 512, "padding"),
    (32, 1024 * 3, 128, 512, "range"), (4, 999, 131, 64, "outside"),
    (3, 77, 20, 9, "bf16")])
def test_scatter_rows_add_kernel_matches_plain(device, B, R, C, n, kind):
    """#5 against its plain version: random rows, ball-query padding
    (runs of a group's first index), indices outside [0, n) that add
    nothing, and a bf16 gradient."""
    gen = torch.Generator().manual_seed(R + C)
    g = torch.randn(B, R, C, generator=gen)
    if kind == "padding":
        idx = torch.randint(0, n, (B, R // 128, 1), generator=gen)
        idx = idx.repeat(1, 1, 128)
        idx[..., :40] = torch.randint(0, n, (B, R // 128, 40), generator=gen)
        idx = idx.reshape(B, R)
    elif kind == "outside":
        idx = torch.randint(-n, 2 * n, (B, R), generator=gen)
    else:
        idx = torch.randint(0, n, (B, R), generator=gen)
    if kind == "bf16":
        g = g.to(torch.bfloat16)
    g, idx = g.to(device), idx.int().to(device)
    before = scatter_rows.KERNEL.launches
    got = scatter_rows.scatter_rows_add(g, idx, n)
    assert scatter_rows.KERNEL.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, n, C)
    _near(got, scatter_rows.scatter_rows_add(g, idx, n, impl="plain"), 1e-5)
    if kind == "outside":
        keep = (idx >= 0) & (idx < n)
        assert float(got.sum()) == pytest.approx(
            float(g.float()[keep].sum()), rel=1e-4, abs=1e-2)


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


# ------------------------------------------------------------ detection

def _rboxes(seed, B, K):
    """Clustered rotated boxes [B, K, 5], so that suppression happens."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(B):
        centers = rs.uniform(0, 40, size=(max(K // 4, 1), 2))
        pick = centers[rs.randint(0, len(centers), K)]
        out.append(np.stack([pick[:, 0] + rs.randn(K) * 0.8,
                             pick[:, 1] + rs.randn(K) * 0.8,
                             rs.uniform(1.5, 2.0, K), rs.uniform(3.5, 4.5, K),
                             rs.uniform(-np.pi, np.pi, K)], axis=1))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def _standup_iou(boxes):
    c = box5_to_corners(boxes)
    s = torch.cat([c.amin(-2), c.amax(-2)], dim=-1)
    return iou_2d(s, s).contiguous()


NMS_SHAPES = [(2, 1000), (1, 1), (3, 31), (1, 1025), (3, 1000)]


@pytest.mark.parametrize("B,K", NMS_SHAPES)
def test_rotate_nms_kernel_equals_plain(device, B, K):
    boxes = _rboxes(K + B, B, K).to(device)
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
    iou = _standup_iou(_rboxes(K * B, B, K).to(device))
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
    both NMS kernels launched, detections equal to the plain run."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = car_config()
    cfg_from_list(cfg, ["VOXEL_GENERATOR.VOXEL_SIZE", "[1.08, 1.24, 4]",
                        "VOXEL_GENERATOR.MAX_NUMBER_OF_POINTS_PER_VOXEL", "32",
                        "MODEL.POST_PROCESSING.nms_pre_max_size", "512"])
    gen = cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS[0].anchor_generator_stride
    gen.strides, gen.offsets = [2.16, 2.48, 0.0], [1.08, -38.44, -1.78]
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    model = builders.build_network(cfg, vg, builders.build_anchor_generator(
        cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS[0]), coder)
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
