"""Pairwise distance and batched row gather.

Counterpart of ``papc_tpu/ops/geometry.py``. ``square_distance`` needs no
kernel. ``index_points``' forward is a plain flat row gather, as on the
TPU (``_flat_gather``); its backward is the row scatter-add kernel
(``ops/kernels/scatter_rows.py``, the TPU's ``scatter_rows_add_pallas``),
which runs wherever a gathered tensor carries a gradient: the
``concat(features, xyz)`` gather of the MSG set abstraction and the
neighbours of the feature-propagation interpolation.
"""

from __future__ import annotations

import torch

from papc_tpu_torch.ops.kernels import scatter_rows


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``src [B, N, C]``, ``dst [B, M, C]`` → squared distances ``[B, N, M]``.

    The same ``|s|² - 2 s·d + |d|²`` expansion as the JAX function, in
    full f32: the JAX code pins ``Precision.HIGHEST`` because a
    reduced-precision cross term flips ball membership near the radius.
    TF32 would do the same on the card, so the cross term is an
    elementwise product and sum, which never goes to TF32.

    bf16 inputs follow JAX's dtypes in its jitted step: the cross term
    is f32 (exact products), and ``|s|²`` and ``|d|²`` are bf16, each
    summed in f32 from f32 squares and rounded once (XLA fuses the
    square into the bf16 sum and keeps it in f32; JAX's eager op-by-op
    call also rounds each square). So the result is f32 with the norms'
    rounding in it: a query that sits on a source reads a distance of
    about ±2^-8 |s|² where the true one is 0.
    """
    bf16 = src.dtype == dst.dtype == torch.bfloat16
    src, dst = src.float(), dst.float()
    s2, d2 = (src * src).sum(-1), (dst * dst).sum(-1)
    if bf16:
        s2, d2 = s2.bfloat16().float(), d2.bfloat16().float()
    cross = (src[:, :, None, :] * dst[:, None, :, :]).sum(-1)
    return s2[:, :, None] - 2.0 * cross + d2[:, None, :]


class _GatherRows(torch.autograd.Function):
    """``points [B, N, C]`` by clamped ``flat [B, R]`` → ``[B, R, C]``;
    the counterpart of ``_make_gather_rows_tpu``'s custom VJP. Autograd
    calls the backward only when ``points`` wants a gradient."""

    @staticmethod
    def forward(ctx, points, flat, impl):
        B, N, C = points.shape
        ctx.save_for_backward(flat)
        ctx.n, ctx.impl = N, impl
        rows = flat + (torch.arange(B, device=points.device) * N)[:, None]
        # indexed by the 2-D rows: a new tensor, not a view, so callers
        # may centre channels of the result in place
        return points.reshape(B * N, C)[rows]

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        dpoints = scatter_rows.scatter_rows_add(g, flat, ctx.n, impl=ctx.impl)
        return dpoints.to(g.dtype), None, None


def index_points(points: torch.Tensor, idx: torch.Tensor, *,
                 impl: str | None = None) -> torch.Tensor:
    """``points [B, N, C]`` gathered by integer ``idx [B, ...]`` →
    ``[B, ..., C]``. Out-of-range indices clamp to ``[0, N)``, as in JAX.
    Differentiable in ``points``: the backward scatter-adds on the card
    (``impl=None`` and a CUDA tensor) or with the plain version."""
    B, N, C = points.shape
    flat = idx.reshape(B, -1).long().clamp(0, N - 1)
    return _GatherRows.apply(points, flat, impl).reshape(*idx.shape, C)
