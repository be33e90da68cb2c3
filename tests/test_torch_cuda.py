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
"""

import numpy as np
import pytest
import torch

from papc_tpu_torch.models.classify import PointNet2SSGClas
from papc_tpu_torch.nn.layers import init_params
from papc_tpu_torch.ops import fused_mlp, sampling
from papc_tpu_torch.ops.kernels import ball_query, fps, gather, samlp, samlp_train

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
