"""Eval-mode fused set-abstraction MLP + max: the CUDA kernel
(``csrc/samlp_eval.cu``) and its plain PyTorch version.

Counterpart of ``papc_tpu/ops/pallas/samlp.py::eval_mlp_max``. Per layer
``h = max((op(h) @ op(W) + b) * scale + shift, 0)`` where ``op`` rounds to
the operand dtype (bf16 on the kernel, as on the TPU; f32 allowed for the
plain version, as the JAX twins' ``sdtype``), products accumulate in f32,
and the result is the max over each group of ``k`` consecutive rows.
"""

from __future__ import annotations

import ctypes
import math

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import check, use_kernel

KERNEL = Kernel(
    "papc_samlp_eval",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p],
)
MAX_LAYERS = 4
_WARPS = 8
_SKEW = 8  # bf16 elements of padding per shared-memory row (bank spread)


def eval_mlp_max_plain(x, ws, bs, scales, shifts, *, k: int,
                       operand_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [M, C0]``, per layer ``W [Cin, Cout]`` and ``b``, ``scale``,
    ``shift [Cout]`` → f32 ``[M // k, C_last]``."""
    h = x.float()
    for w, b, scale, shift in zip(ws, bs, scales, shifts):
        a = h.to(operand_dtype).float() @ w.to(operand_dtype).float() + b
        h = torch.clamp_min(a * scale + shift, 0.0)
    return h.reshape(-1, k, h.shape[-1]).amax(dim=1)


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


def _padded(t: torch.Tensor, shape, dtype) -> torch.Tensor:
    out = torch.zeros(shape, dtype=dtype, device=t.device)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def tile_rows(k: int) -> int:
    """Rows per block: a multiple of 64 (four 16-row fragments a warp)
    and of ``k`` (groups never straddle blocks), at least 128."""
    base = math.lcm(k, 64)
    return base * max(1, 128 // base)


def smem_layout(c0: int, widths, k: int, tm: int) -> tuple[int, int, int]:
    """``(ld_x, ld_y, bytes)``: the two ping-pong activation buffers'
    row strides (bf16 elements) and the dynamic shared memory a block
    needs. Buffer X holds the inputs of layers 0, 2, ...; Y those of
    layers 1, 3, ...; the last layer's output is pooled, never stored."""
    ins = [_pad16(c0)] + [_pad16(w) for w in widths[:-1]]
    held_x = [c for i, c in enumerate(ins) if i % 2 == 0]
    held_y = [c for i, c in enumerate(ins) if i % 2 == 1]
    ld_x = max(held_x) + _SKEW
    ld_y = max(held_y) + _SKEW if held_y else 0
    nbytes = (tm * (ld_x + ld_y) * 2 + _WARPS * 256 * 4
              + max(tm // k, 1) * _pad16(widths[-1]) * 4)
    return ld_x, ld_y, nbytes


def plan(c0: int, widths, k: int, limit: int) -> tuple[int, int, int, int]:
    """``(tm, ld_x, ld_y, bytes)`` of a launch: ``tile_rows(k)`` rows a
    block, or 64 where that tile's buffers exceed ``limit`` bytes of
    shared memory and ``k`` is a multiple of 64 (a group then spans
    ``k / 64`` blocks, merged by the kernel). MSG classification's SA3
    (c0 = 643, k = 128) needs 249 856 B at 128 rows, 131 072 B at 64."""
    tm = tile_rows(k)
    layout = smem_layout(c0, widths, k, tm)
    if layout[2] > limit and k % 64 == 0:
        tm = 64
        layout = smem_layout(c0, widths, k, tm)
    if layout[2] > limit:
        raise ValueError(
            f"samlp_eval needs {layout[2]} B of shared memory a block for "
            f"c0={c0} widths={list(widths)} k={k}; the card allows {limit}")
    return (tm, *layout)


def eval_mlp_max_cuda(x, ws, bs, scales, shifts, *, k: int) -> torch.Tensor:
    m, c0 = x.shape
    n = len(ws)
    check(x, "x", torch.float32, (m, c0))
    if not 1 <= n <= MAX_LAYERS:
        raise ValueError(f"kernel takes 1..{MAX_LAYERS} layers, got {n}")
    if m % k:
        raise ValueError(f"{m} rows are not whole groups of k={k}")
    widths = [w.shape[1] for w in ws]
    cin = [c0] + widths[:-1]
    cin_p = [_pad16(c) for c in cin]
    cout_p = [_pad16(c) for c in widths]
    w_p, vecs = [], []
    for i, (w, b, scale, shift) in enumerate(zip(ws, bs, scales, shifts)):
        if tuple(w.shape) != (cin[i], widths[i]):
            raise ValueError(f"layer {i}: W {tuple(w.shape)} after {cin[i]} channels")
        w_p.append(_padded(w, (cin_p[i], cout_p[i]), torch.bfloat16))
        vecs.append([_padded(v.float(), (cout_p[i],), torch.float32)
                     for v in (b, scale, shift)])
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    tm, ld_x, ld_y, _ = plan(c0, widths, k, limit)
    # a group split over blocks is merged by atomicMax into +0.0 bits
    out = (torch.zeros if tm < k else torch.empty)(
        (m // k, widths[-1]), dtype=torch.float32, device=x.device)

    def ints(vals):
        return (ctypes.c_int * n)(*vals)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])

    KERNEL(ptr(x), m, c0, k, n, ints(cin_p), ints(cout_p), ptrs(w_p),
           ptrs([v[0] for v in vecs]), ptrs([v[1] for v in vecs]),
           ptrs([v[2] for v in vecs]), widths[-1], tm, ld_x, ld_y,
           ptr(out), stream_of(x))
    return out


def eval_mlp_max(x, ws, bs, scales, shifts, *, k: int,
                 impl: str | None = None,
                 operand_dtype=torch.bfloat16) -> torch.Tensor:
    if use_kernel(x, impl):
        if operand_dtype != torch.bfloat16:
            raise ValueError(
                "the samlp_eval kernel takes bf16 operands; pass "
                "impl='plain' for other operand dtypes"
            )
        return eval_mlp_max_cuda(
            x.float().contiguous(), [w.contiguous() for w in ws],
            bs, scales, shifts, k=k,
        )
    return eval_mlp_max_plain(x, ws, bs, scales, shifts, k=k,
                              operand_dtype=operand_dtype)
