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
"""

import numpy as np
import pytest
import torch

from papc_tpu_torch.models.classify import PointNet2SSGClas
from papc_tpu_torch.nn.layers import init_params
from papc_tpu_torch.ops import fused_mlp, sampling
from papc_tpu_torch.ops.kernels import ball_query, fps, gather, samlp

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
