"""Pairwise distance and batched row gather.

Counterpart of ``papc_tpu/ops/geometry.py``. Neither needs a kernel: on
the TPU ``index_points``' forward is a plain flat row gather too
(``_flat_gather``); only its backward has one (``scatter_rows_add_pallas``),
which first carries a gradient in MSG training (``ROADMAP.md``): the SSG
path gathers only positions, which get none.
"""

from __future__ import annotations

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``src [B, N, C]``, ``dst [B, M, C]`` → squared distances ``[B, N, M]``.

    The same ``|s|² - 2 s·d + |d|²`` expansion as the JAX function, in
    full f32: the JAX code pins ``Precision.HIGHEST`` because a
    reduced-precision cross term flips ball membership near the radius.
    TF32 would do the same on the card, so the cross term is an
    elementwise product and sum, which never goes to TF32.
    """
    src, dst = src.float(), dst.float()
    cross = (src[:, :, None, :] * dst[:, None, :, :]).sum(-1)
    s2 = (src * src).sum(-1)[:, :, None]
    d2 = (dst * dst).sum(-1)[:, None, :]
    return s2 - 2.0 * cross + d2


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points [B, N, C]`` gathered by integer ``idx [B, ...]`` →
    ``[B, ..., C]``. Out-of-range indices clamp to ``[0, N)``, as in JAX.
    """
    B, N, C = points.shape
    flat = idx.reshape(B, -1).long().clamp(0, N - 1)
    rows = flat + (torch.arange(B, device=points.device) * N)[:, None]
    gathered = points.reshape(B * N, C)[rows.reshape(-1)]
    return gathered.reshape(*idx.shape, C)
