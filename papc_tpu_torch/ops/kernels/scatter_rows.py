"""Row scatter-add, the backward of the flat row gather ``index_points``:
the CUDA kernel (``csrc/scatter_rows_add.cu``) and its plain PyTorch
version.

Counterpart of ``papc_tpu/ops/pallas/scatter.py::scatter_rows_add_pallas``:
``g [B, R, C]`` (f32 or bf16) added by ``idx [B, R]`` into ``[B, n_rows,
C]`` f32. An index outside ``[0, n_rows)`` contributes nothing, as the
TPU kernel's ``-1`` padding matches no row. (The grouping gather's
backward, ``gather.scatter_add``, clamps instead, as its forward does.)
The kernel adds with f32 atomics, so it matches the plain ``index_add_``
to f32 rounding of the sums, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import check, use_kernel

P, I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("papc_scatter_rows_add", [P, I, P, I, I, I, I, P, P])


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation; float64 stays float64 (the exact reference step)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def scatter_rows_add_plain(g: torch.Tensor, idx: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """``index_add_`` over the flattened rows, the rows whose index lies
    outside ``[0, n_rows)`` left out."""
    B, R, C = g.shape
    idx = idx.reshape(B, R).long()
    keep = (idx >= 0) & (idx < n_rows)
    rows = idx + (torch.arange(B, device=g.device) * n_rows)[:, None]
    acc = _acc_dtype(g.dtype)
    out = torch.zeros((B * n_rows, C), dtype=acc, device=g.device)
    out.index_add_(0, rows[keep], g.to(acc)[keep])
    return out.reshape(B, n_rows, C)


def scatter_rows_add_cuda(g: torch.Tensor, idx: torch.Tensor,
                          n_rows: int) -> torch.Tensor:
    B, R, C = g.shape
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g must be float32 or bfloat16, is {g.dtype}")
    check(g, "g", g.dtype, (B, R, C))
    check(idx, "idx", torch.int32, (B, R))
    out = torch.zeros((B, n_rows, C), dtype=torch.float32, device=g.device)
    KERNEL(ptr(g), int(g.dtype == torch.bfloat16), ptr(idx), B, R, C, n_rows,
           ptr(out), stream_of(g))
    return out


def scatter_rows_add(g: torch.Tensor, idx: torch.Tensor, n_rows: int, *,
                     impl: str | None = None) -> torch.Tensor:
    """``out[b, idx[b, r]] += g[b, r]`` into zeros ``[B, n_rows, C]`` f32
    (float64 for a float64 ``g`` on the plain version)."""
    if use_kernel(g, impl):
        return scatter_rows_add_cuda(g.contiguous(), idx.int().contiguous(),
                                     n_rows)
    return scatter_rows_add_plain(g, idx, n_rows)
