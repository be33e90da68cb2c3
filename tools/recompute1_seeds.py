"""``test_fused_recompute_kernels_match_plain`` over other seeds, on the card,
with each version held against the plain pass with f32 operands.

    python3 tools/recompute1_seeds.py [--seeds 11-30] [--faults]

For each mode (``recompute1``, ``recompute``) and seed, the test's inputs
(``tests/test_torch_cuda.py``: the (8, 64, 32, 3) stack of widths 64-64-128,
the cotangent cleared at the plain argmax's near-ties by ``_clear_of_ties``)
go through ``fused_mlp_max`` three times: with the kernels, with the plain
passes (bf16 operands) and with the plain passes on f32 operands. A line a
seed names each output or gradient outside the test's bound (``out``
within 1e-3 of its largest plus one bf16 ulp, ``dx`` and each layer's
gradients within 1e-2 of the largest) with how far it lies, kernel and
plain, from the f32-operand pass: in L2, their ratio, and in the largest
element. ``--faults`` also plants faults in the kernel run at the first
seed and prints, for each of the candidate rules tried on the misses,
whether it would catch them.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from papc_tpu_torch.ops import fused_mlp  # noqa: E402
from papc_tpu_torch.ops.kernels import samlp_recompute as src  # noqa: E402
from papc_tpu_torch.ops.kernels import samlp_train  # noqa: E402
from tests import test_torch_cuda as tc  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
FAULTS = ("out x1.01", "out x1.002", "one out element +5e-3 of max",
          "dx x1.05", "dx x1.02", "one dx row zeroed", "dW0 row zeroed")


def _runs(mode, seed, device, fault=None):
    """The test's inputs at ``seed`` through the kernels, the plain passes
    and the f32-operand plain passes → three ``{name: tensor}``."""
    gen = torch.Generator().manual_seed(seed)
    shape, widths = (8, 64, 32, 3), (64, 64, 128)
    x = torch.randn(*shape, generator=gen).to(device)
    ws, bs, gammas, betas = tc._mlp(1, shape[-1], widths, device)
    running = [(torch.zeros(c, device=device), torch.ones(c, device=device))
               for c in widths]
    cot = torch.randn(*shape[:2], widths[-1], generator=gen).to(device)
    groups, k = shape[0] * shape[1], shape[2]
    g2 = x.reshape(groups * k, shape[3]).to(BF16)
    vecs = []
    for j, (gamma, beta) in enumerate(zip(gammas, betas), start=1):
        sums = src.rc_stats(g2, vecs, ws, bs, upto=j, impl="plain")
        vecs.append(samlp_train.bn_vectors(sums, gamma, beta, groups * k,
                                           1e-5)[0])
    want, _ = src.rc_final(g2, vecs, ws, bs, k=k, impl="plain")
    a_list, _ = src.chain_plain(g2, vecs, ws, bs, len(ws))
    h = torch.clamp_min(a_list[-1] * vecs[-1][0] + vecs[-1][1], 0.0)
    cot = cot * tc._clear_of_ties(h, groups, k, want).reshape(cot.shape)
    out = []
    for impl, odt in ((None, None), ("plain", None), ("plain", F32)):
        kernel = impl is None
        xg = x.clone().requires_grad_()
        params = [tuple(t.clone().requires_grad_() for t in layer)
                  for layer in zip(ws, bs, gammas, betas)]
        if kernel and fault and fault.startswith("dx x"):
            xg.register_hook(lambda g, f=float(fault[4:]): g * f)
        if kernel and fault == "one dx row zeroed":
            xg.register_hook(lambda g: g.index_fill(
                0, torch.tensor([0], device=g.device), 0.0))
        if kernel and fault == "dW0 row zeroed":
            params[0][0].register_hook(lambda g: g.index_fill(
                0, torch.tensor([0], device=g.device), 0.0))
        y, _ = fused_mlp.fused_mlp_max(xg, params, running, train=True,
                                       impl=impl, mode=mode,
                                       operand_dtype=odt)
        if kernel and fault and fault.startswith("out x"):
            y = y * float(fault[5:])
        if kernel and fault == "one out element +5e-3 of max":
            bump = torch.zeros_like(y)
            bump.view(-1)[7] = 5e-3 * float(y.detach().abs().max())
            y = y + bump
        (y * cot).sum().backward()
        res = {"out": y.detach(), "dx": xg.grad}
        for li, layer in enumerate(params):
            for n, t in zip(("W", "b", "gamma", "beta"), layer):
                res[f"L{li}{n}"] = t.grad
        out.append(res)
    return out


def _bounds(plain):
    """The test's bound of each tensor, against the plain pass."""
    b = {"out": 1e-3 * float(plain["out"].abs().max())
         + tc._bf16_ulp(plain["out"].float()).double(),
         "dx": 1e-2 * float(plain["dx"].abs().max())}
    for li in range(3):
        scale = max(float(plain[f"L{li}{n}"].abs().max())
                    for n in ("W", "b", "gamma", "beta"))
        for n in ("W", "b", "gamma", "beta"):
            b[f"L{li}{n}"] = 1e-2 * scale
    return b


def _d(a, b):
    return a.double() - b.double()


def seed_line(mode, seed, device) -> str:
    kern, plain, f32 = _runs(mode, seed, device)
    misses = []
    for name, bound in _bounds(plain).items():
        err = _d(kern[name], plain[name]).abs()
        if bool((err <= bound).all()):
            continue
        scale = float(plain[name].abs().max())
        dk, dp = _d(kern[name], f32[name]), _d(plain[name], f32[name])
        misses.append(
            f"{name}: kernel vs plain {float(err.max()) / scale:.3e} of the "
            f"largest; L2 from the f32-operand pass kernel "
            f"{float(dk.norm()):.4e}, plain {float(dp.norm()):.4e} (ratio "
            f"{float(dk.norm()) / max(float(dp.norm()), 1e-30):.3f}); "
            f"largest element kernel {float(dk.abs().max()) / scale:.3e}, "
            f"plain {float(dp.abs().max()) / scale:.3e}")
    return (f"{mode} seed {seed}: "
            + ("; ".join(misses) if misses else "within the test's bounds"))


def _rules(kern, plain, f32):
    """Which candidate rules pass: the test's bounds; each tensor within
    its bound or no farther (L2, 1.5x) from the f32-operand pass than
    plain; within its bound plus 1.5x plain's distance from that pass,
    element by element."""
    bounds = _bounds(plain)
    verdict = {"bounds": True, "bound or L2 1.5x": True,
               "bound + 1.5x elementwise": True}
    for name, bound in bounds.items():
        err = _d(kern[name], plain[name]).abs()
        dk, dp = _d(kern[name], f32[name]), _d(plain[name], f32[name])
        within = bool((err <= bound).all())
        verdict["bounds"] &= within
        verdict["bound or L2 1.5x"] &= within or (
            float(dk.norm()) <= 1.5 * float(dp.norm()))
        verdict["bound + 1.5x elementwise"] &= bool(
            (err <= bound + 1.5 * dp.abs()).all())
    return verdict


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", default="11-30")
    parser.add_argument("--faults", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    lo, hi = (int(v) for v in args.seeds.split("-"))
    for mode in ("recompute1", "recompute"):
        for seed in range(lo, hi + 1):
            print(seed_line(mode, seed, device), flush=True)
            if mode == "recompute1":
                runs = _runs(mode, seed, device)
                print(f"    rules passing: {_rules(*runs)}", flush=True)
    if args.faults:
        for fault in FAULTS:
            caught = {rule: not ok for rule, ok in
                      _rules(*_runs("recompute1", lo, device, fault)).items()}
            print(f"planted {fault} at seed {lo}: caught by {caught}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
