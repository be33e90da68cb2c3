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

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import check, use_kernel

KERNEL = Kernel(
    "papc_samlp_eval",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p],
)
MAX_LAYERS = 4
TILE_ROWS = (128, 64, 32)  # rows a block may take, largest first
SMEM_LIMIT = 232448  # dynamic shared memory a block may opt into (H100)
SMS = 132  # streaming multiprocessors of the H100 SXM
_WARPS = 8
_SKEW = 8  # bf16 elements of padding per shared-memory row (bank spread)
_SLICE = 32  # weight rows a ring stage holds
_STAGES = 3  # depth of the weight ring


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


def ring_columns(tm: int) -> int:
    """Columns of a weight ring stage: 64 per column warp, the 8 warps
    laid out as ``tm / 32`` row warps of 32 rows."""
    return 64 * (_WARPS // (tm // 32))


def pool_slots(tm: int, k: int) -> int:
    """Groups a block of ``tm`` rows can touch: ``tm / k`` when ``k``
    divides ``tm``, 1 when ``tm`` divides ``k``, else ``(tm - 1) // k + 2``
    (the block straddles group bounds)."""
    if tm % k == 0:
        return tm // k
    return 1 if k % tm == 0 else (tm - 1) // k + 2


def smem_layout(c0: int, widths, k: int, tm: int) -> tuple[int, int, int]:
    """``(ld_x, ld_y, bytes)``: the two ping-pong activation buffers'
    row strides (bf16 elements) and the dynamic shared memory a block of
    ``tm`` rows needs: the buffers, the weight ring, every layer's bias,
    scale and shift, and the pooled maxima.
    Buffer X holds the inputs of layers 0, 2, ...; Y those of layers 1,
    3, ...; the last layer's output is pooled, never stored."""
    ins = [_pad16(c0)] + [_pad16(w) for w in widths[:-1]]
    ld_x = max(ins[0::2]) + _SKEW
    ld_y = max(ins[1::2]) + _SKEW if len(ins) > 1 else 0
    ring = _STAGES * _SLICE * (ring_columns(tm) + _SKEW) * 2
    vecs = 3 * sum(_pad16(w) for w in widths) * 4
    nbytes = (tm * (ld_x + ld_y) * 2 + ring + vecs
              + pool_slots(tm, k) * _pad16(widths[-1]) * 4)
    return ld_x, ld_y, nbytes


def plan(m: int, c0: int, widths, k: int, limit: int = SMEM_LIMIT,
         sms: int = SMS) -> dict:
    """The launch of one stack: the largest row tile of ``TILE_ROWS``
    whose shared memory fits ``limit`` and that gives at least one block
    per SM, else (M too small for a wave) the smallest that fits. SSG SA3
    (4096 rows) takes 32-row tiles: 128 blocks, a group of 128 rows spread
    over 4 of them. ``{"tm", "blocks", "ld_x", "ld_y", "smem"}``."""
    fits = [tm for tm in TILE_ROWS
            if smem_layout(c0, widths, k, tm)[2] <= limit]
    if not fits:
        need = smem_layout(c0, widths, k, TILE_ROWS[-1])[2]
        raise ValueError(
            f"samlp_eval needs {need} B of shared memory a block for "
            f"c0={c0} widths={list(widths)} k={k}; the card allows {limit}")
    tm = next((t for t in fits if -(-m // t) >= sms), fits[-1])
    ld_x, ld_y, nbytes = smem_layout(c0, widths, k, tm)
    return {"tm": tm, "blocks": -(-m // tm), "ld_x": ld_x, "ld_y": ld_y,
            "smem": nbytes}


def eval_mlp_max_cuda(x, ws, bs, scales, shifts, *, k: int) -> torch.Tensor:
    m, c0 = x.shape
    n = len(ws)
    check(x, "x", torch.float32, (m, c0))
    if not 1 <= n <= MAX_LAYERS:
        raise ValueError(f"kernel takes 1..{MAX_LAYERS} layers, got {n}")
    if m % k:
        raise ValueError(f"{m} rows are not whole groups of k={k}")
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads the input tile as float4
    widths = [w.shape[1] for w in ws]
    cin = [c0] + widths[:-1]
    # W goes to the kernel in f32 at the caller's strides; the C side
    # packs it into wbuf as bf16, zero-padded to 16s
    ws = [w.float() for w in ws]
    vecs = []
    for i, (w, b, scale, shift) in enumerate(zip(ws, bs, scales, shifts)):
        if tuple(w.shape) != (cin[i], widths[i]):
            raise ValueError(f"layer {i}: W {tuple(w.shape)} after {cin[i]} channels")
        if w.device != x.device:
            raise ValueError(f"layer {i}: W on {w.device}, x on {x.device}")
        vecs.append([v.float().contiguous() for v in (b, scale, shift)])
        for v in vecs[-1]:
            check(v, f"layer {i} vector", torch.float32, (widths[i],))
    wbuf = torch.empty(sum(_pad16(a) * _pad16(b) for a, b in zip(cin, widths)),
                       dtype=torch.bfloat16, device=x.device)
    props = torch.cuda.get_device_properties(x.device)
    p = plan(m, c0, widths, k, props.shared_memory_per_block_optin,
             props.multi_processor_count)
    out = torch.empty((m // k, widths[-1]), dtype=torch.float32,
                      device=x.device)

    def ints(vals):
        return (ctypes.c_int * n)(*vals)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])

    strides = (ctypes.c_longlong * (2 * n))(
        *[s for w in ws for s in w.stride()])
    KERNEL(ptr(x), m, c0, k, n, ints(widths), ptrs(ws), strides,
           ptrs([v[0] for v in vecs]), ptrs([v[1] for v in vecs]),
           ptrs([v[2] for v in vecs]), p["tm"], p["ld_x"], p["ld_y"],
           ptr(wbuf), ptr(out), stream_of(x))
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
        return eval_mlp_max_cuda(x.float().contiguous(), ws, bs, scales,
                                 shifts, k=k)
    return eval_mlp_max_plain(x, ws, bs, scales, shifts, k=k,
                              operand_dtype=operand_dtype)
