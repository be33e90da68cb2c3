"""Training-mode set-abstraction passes: the CUDA kernels and their plain
PyTorch versions.

Counterpart of the stream-mode passes of ``papc_tpu/ops/pallas/samlp.py``
(``linear_stats``, ``finalize_max``, ``bwd_seed``, ``bwd_layer``) and of
their jnp twins in ``papc_tpu/ops/fused_mlp.py`` (``_jnp_linear_stats``,
``_jnp_finalize_max``, ``_jnp_bwd_seed``, ``_jnp_bwd_layer``), which the
plain versions here mirror op for op. ``ops/fused_mlp.py`` chains them
into the training forward and backward of one Dense→BN→ReLU stack + max.

Numeric contract, kept from the TPU kernels: products take operands in
``operand_dtype`` (bf16 on the card; f32 allowed for the plain versions,
as the twins' ``sdtype``) and accumulate in f32; pre-activations and
backward activations between passes are stored in ``operand_dtype``;
affines, statistics and reductions are f32, and the statistics are taken
from the f32 value before it is rounded for storage.

Kernels (``csrc/``): ``samlp_linear_stats.cu``, ``samlp_finalize_seed.cu``
(``finalize_max`` and ``bwd_seed``) and ``samlp_bwd_layer.cu``. Each
column sum is reduced in a fixed order (per block, then across blocks),
so repeated runs on the card give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import check, use_kernel

P, I = ctypes.c_void_p, ctypes.c_int
LINEAR_STATS = Kernel(
    "papc_samlp_linear_stats",
    [P, I, I, P, P, P, I, I, I, I, I, I, P, P, P, P],
)
FINALIZE_MAX = Kernel("papc_samlp_finalize_max", [P, I, I, I, P, P, P, P])
BWD_SEED = Kernel("papc_samlp_bwd_seed", [P, I, I, I, P, P, P, I, P, P, P, P])
BWD_LAYER = Kernel(
    "papc_samlp_bwd_layer",
    [P, P, P, I, I, I, I, P, I, I, P, P, P, I, I, I, I, I,
     P, P, P, P, P, P, P, P, P, P],
)
KERNELS = (LINEAR_STATS, FINALIZE_MAX, BWD_SEED, BWD_LAYER)

_TM = 128  # rows per tile of the row-tiled products (two 64-row units)
_SKEW = 8  # bf16 elements of padding per shared-memory row (bank spread)
_WARPS = 8
_MAX_BLOCKS = 1024  # grid of the row-tiled products; fixes the sum order
_THREADS = 131072  # target thread count of the per-column passes


# ------------------------------------------------------- plain versions

def _f32(t):
    """The f32 compute value of ``t``; float64 stays float64, so the
    plain versions can run under ``torch.autograd.gradcheck``."""
    return t if t.dtype == torch.float64 else t.float()


def bn_vectors(sums, gamma, beta, m: int, eps: float):
    """Per-layer BN affine from ``sums [2, C] = (Σa, Σa²)`` over ``m``
    rows: ``(vec [4, C] = (scale, shift, mean, inv_std), (mean, var))``
    with flax's biased fast variance, clipped at 0 (``_bn_vectors``)."""
    mean = sums[0] / m
    var = torch.clamp_min(sums[1] / m - mean * mean, 0.0)
    inv_std = torch.rsqrt(var + eps)
    scale = _f32(gamma) * inv_std
    shift = _f32(beta) - mean * scale
    return torch.stack([scale, shift, mean, inv_std]), (mean, var)


def _op(t, dtype):
    """A product operand: rounded to ``dtype``, computed in f32."""
    return _f32(t.to(dtype))


def linear_stats_plain(x, vec, w, b, *, operand_dtype=torch.bfloat16):
    """``x [M, Cin]`` (raw block input when ``vec`` is None, else the
    previous pre-activation, through ``relu(x·scale + shift)``),
    ``W [Cin, Cout]``, ``b`` → ``(a [M, Cout] in operand_dtype,
    sums [2, Cout] f32 = (Σa, Σa²) of the f32 a)``."""
    xf = _f32(x)
    if vec is not None:
        xf = torch.clamp_min(xf * vec[0] + vec[1], 0.0)
    a = _op(xf, operand_dtype) @ _op(w, operand_dtype) + _f32(b)
    sums = torch.stack([a.sum(0), (a * a).sum(0)])
    return a.to(operand_dtype), sums


def finalize_max_plain(a, vec, *, k: int):
    """Last BN+ReLU, max over each group of ``k`` rows and the first row
    that attains it: ``a [M, C]`` → ``(out [M/k, C] f32, amax i32)``."""
    m, c = a.shape
    h = torch.clamp_min(_f32(a) * vec[0] + vec[1], 0.0).reshape(m // k, k, c)
    mx = h.amax(dim=1)
    kio = torch.arange(k, dtype=torch.int32, device=a.device)[None, :, None]
    amax = torch.where(h == mx[:, None, :], kio, k).amin(dim=1)
    return mx, amax.int()


def bwd_seed_plain(a, vec, dout, amax, *, k: int,
                   operand_dtype=torch.bfloat16):
    """``dout [M/k, C]`` routed to the saved first argmax only, through
    the last ReLU gate ``o > 0``: ``(dy [M, C] in operand_dtype,
    s [2, C] f32 = (Σdy, Σdy·x̂))``. ``vec [4, C]``."""
    m, c = a.shape
    af = _f32(a)
    o = af * vec[0] + vec[1]
    kio = torch.arange(k, dtype=torch.int32, device=a.device)[None, :, None]
    dh = torch.where(kio == amax[:, None, :], _f32(dout)[:, None, :],
                     0.0).reshape(m, c)
    dy = torch.where(o > 0, dh, 0.0)
    xhat = (af - vec[2]) * vec[3]
    s = torch.stack([dy.sum(0), (dy * xhat).sum(0)])
    return dy.to(operand_dtype), s


def bwd_layer_plain(dy, a, a_prev, w, vec, s_in, vec_prev, *,
                    operand_dtype=torch.bfloat16, need_dprev: bool = True):
    """One backward layer: the analytic BN backward ``da``, ``dW = h_prevᵀ·da``,
    ``db = Σda``, and the gradient one layer down: through the previous
    ReLU gate, stored in ``operand_dtype``, with the previous BN's sums
    ``(Σdy, Σdy·x̂)``; or, on the first layer (``vec_prev`` None), ``dg``
    in f32 with no gate. ``need_dprev=False`` skips that product.

    Returns ``(dy_prev | dg | None, dW [Cin, Cout], db [Cout],
    s_prev [2, Cin] | None)``, all f32 but ``dy_prev``.
    """
    m = dy.shape[0]
    dyf = _f32(dy)
    af = _f32(a)
    xhat = (af - vec[2]) * vec[3]
    da = vec[0] * (dyf - s_in[0] / m - xhat * s_in[1] / m)
    apf = _f32(a_prev)
    if vec_prev is None:
        h_prev = apf
    else:
        h_prev = torch.clamp_min(apf * vec_prev[0] + vec_prev[1], 0.0)
    dab = _op(da, operand_dtype)
    dw = _op(h_prev, operand_dtype).t() @ dab
    db = da.sum(0)
    if not need_dprev:
        return None, dw, db, None
    dhp = dab @ _op(w, operand_dtype).t()
    if vec_prev is None:
        return dhp, dw, db, None
    op = apf * vec_prev[0] + vec_prev[1]
    dyp = torch.where(op > 0, dhp, 0.0)
    xhatp = (apf - vec_prev[2]) * vec_prev[3]
    s = torch.stack([dyp.sum(0), (dyp * xhatp).sum(0)])
    return dyp.to(operand_dtype), dw, db, s


# ------------------------------------------------------------ the plans

def _pad(c: int, to: int = 16) -> int:
    return -(-c // to) * to


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """``W [Cin, Cout]`` → bf16 ``[pad16(Cin), pad16(Cout)]``, zero-filled:
    the kernels' weight operand. Packed once per training step and used
    by the forward and the backward passes."""
    cin, cout = w.shape
    out = torch.zeros((_pad(cin), _pad(cout)), dtype=torch.bfloat16,
                      device=w.device)
    out[:cin, :cout] = w.detach()
    return out


def linear_stats_plan(m: int, cin: int, cout: int) -> dict:
    """Grid and shared memory of the linear_stats kernel: tiles of
    ``_TM`` rows, each block walking the tiles ``b, b + blocks, ...``.
    Shared memory holds the bf16 input tile, one 16x16 f32 scratch a
    warp and the block's column sums for both 64-row units."""
    cin_p, cout_p = _pad(cin), _pad(cout)
    ld_x = cin_p + _SKEW
    tiles = -(-m // _TM)
    smem = (_TM * ld_x * 2 + _WARPS * 256 * 4
            + (_TM // 64) * 2 * cout_p * 4)
    return {"tm": _TM, "ld_x": ld_x, "blocks": min(tiles, _MAX_BLOCKS),
            "smem": smem, "cin_p": cin_p, "cout_p": cout_p}


def slices(rows: int, c: int) -> int:
    """Row slices of a per-column pass: ``slices x c`` threads, each
    summing its rows ``p, p + slices, ...`` in order."""
    return max(1, min(rows, _THREADS // c))


def bwd_layer_plan(m: int, cin: int, cout: int) -> dict:
    """Grids and scratch of the bwd_layer kernels: the ``da`` pass
    (``slices`` x ``cout_p`` threads), the ``dW`` product (64x64 tiles of
    ``[Cin, Cout]`` times ``splits`` row ranges of ``rows_per_split``, a
    multiple of 32) and the ``dh_prev`` product (as linear_stats)."""
    cin_p, cout_p = _pad(cin), _pad(cout)
    cin_pp, cout_pp = _pad(cin, 64), _pad(cout, 64)
    tiles = (cin_pp // 64) * (cout_pp // 64)
    want = max(1, min(-(-_MAX_BLOCKS // tiles), -(-m // 32)))
    rows_per_split = _pad(-(-m // want), 32)
    tiles_m = -(-m // _TM)
    return {"cin_p": cin_p, "cout_p": cout_p, "cin_pp": cin_pp,
            "cout_pp": cout_pp, "m_pad": tiles_m * _TM,
            "slices": slices(m, cout_p), "rows_per_split": rows_per_split,
            "splits": -(-m // rows_per_split), "tm": _TM,
            "blocks": min(tiles_m, _MAX_BLOCKS)}


# ------------------------------------------------------ kernel wrappers

def _smem_limit(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).shared_memory_per_block_optin


def linear_stats_cuda(x, vec, w_packed, b, cout: int):
    m, cin = x.shape
    plan = linear_stats_plan(m, cin, cout)
    check(x, "x", torch.bfloat16, (m, cin))
    check(w_packed, "w_packed", torch.bfloat16, (plan["cin_p"], plan["cout_p"]))
    check(b, "b", torch.float32, (cout,))
    if vec is not None:
        check(vec, "vec", torch.float32, (None, cin))
    if plan["smem"] > _smem_limit(x):
        raise ValueError(f"linear_stats needs {plan['smem']} B of shared "
                         f"memory for cin={cin}; the card allows "
                         f"{_smem_limit(x)}")
    a = torch.empty((m, cout), dtype=torch.bfloat16, device=x.device)
    partials = torch.empty((plan["blocks"], 2, plan["cout_p"]),
                           dtype=torch.float32, device=x.device)
    sums = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    LINEAR_STATS(ptr(x), m, cin, ptr(vec), ptr(w_packed), ptr(b), cout,
                 plan["cin_p"], plan["cout_p"], plan["tm"], plan["ld_x"],
                 plan["blocks"], ptr(a), ptr(partials), ptr(sums),
                 stream_of(x))
    return a, sums


def finalize_max_cuda(a, vec, *, k: int):
    m, c = a.shape
    check(a, "a", torch.bfloat16, (m, c))
    check(vec, "vec", torch.float32, (None, c))
    if m % k:
        raise ValueError(f"{m} rows are not whole groups of k={k}")
    out = torch.empty((m // k, c), dtype=torch.float32, device=a.device)
    amax = torch.empty((m // k, c), dtype=torch.int32, device=a.device)
    FINALIZE_MAX(ptr(a), m, c, k, ptr(vec), ptr(out), ptr(amax), stream_of(a))
    return out, amax


def bwd_seed_cuda(a, vec, dout, amax, *, k: int):
    m, c = a.shape
    check(a, "a", torch.bfloat16, (m, c))
    check(vec, "vec", torch.float32, (4, c))
    check(dout, "dout", torch.float32, (m // k, c))
    check(amax, "amax", torch.int32, (m // k, c))
    n = slices(m // k, c)
    dy = torch.empty((m, c), dtype=torch.bfloat16, device=a.device)
    partials = torch.empty((n, 2, c), dtype=torch.float32, device=a.device)
    s = torch.empty((2, c), dtype=torch.float32, device=a.device)
    BWD_SEED(ptr(a), m, c, k, ptr(vec), ptr(dout), ptr(amax), n, ptr(dy),
             ptr(partials), ptr(s), stream_of(a))
    return dy, s


def bwd_layer_cuda(dy, a, a_prev, w_packed, vec, s_in, vec_prev, *,
                   need_dprev: bool = True):
    m, cout = dy.shape
    cin = a_prev.shape[1]
    plan = bwd_layer_plan(m, cin, cout)
    check(dy, "dy", torch.bfloat16, (m, cout))
    check(a, "a", torch.bfloat16, (m, cout))
    check(a_prev, "a_prev", torch.bfloat16, (m, cin))
    check(w_packed, "w_packed", torch.bfloat16, (plan["cin_p"], plan["cout_p"]))
    check(vec, "vec", torch.float32, (4, cout))
    check(s_in, "s_in", torch.float32, (2, cout))
    if vec_prev is not None:
        check(vec_prev, "vec_prev", torch.float32, (4, cin))
    dev = dy.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    da = torch.empty((plan["m_pad"], plan["cout_p"]), dtype=torch.bfloat16,
                     device=dev)
    db_part = f32(plan["slices"], plan["cout_p"])
    dw_part = f32(plan["splits"], plan["cin_pp"], plan["cout_pp"])
    s_part = f32(plan["blocks"], 2, plan["cin_p"])
    dw, db = f32(cin, cout), f32(cout)
    dy_prev = dg = s_prev = None
    if need_dprev and vec_prev is not None:
        dy_prev = torch.empty((m, cin), dtype=torch.bfloat16, device=dev)
        s_prev = f32(2, cin)
    elif need_dprev:
        dg = f32(m, cin)
    BWD_LAYER(ptr(dy), ptr(a), ptr(a_prev), m, plan["m_pad"], cin, cout,
              ptr(w_packed), plan["cin_p"], plan["cout_p"], ptr(vec),
              ptr(s_in), ptr(vec_prev), plan["slices"], plan["splits"],
              plan["rows_per_split"], plan["tm"], plan["blocks"], ptr(da),
              ptr(db_part), ptr(dw_part), ptr(s_part), ptr(dw), ptr(db),
              ptr(dy_prev), ptr(dg), ptr(s_prev), stream_of(dy))
    return (dy_prev if vec_prev is not None else dg), dw, db, s_prev


# ----------------------------------------------------------- dispatch

def _kernel_dtype(operand_dtype) -> None:
    if operand_dtype != torch.bfloat16:
        raise ValueError(
            "the training kernels take bf16 operands; pass impl='plain' "
            "for other operand dtypes")


def linear_stats(x, vec, w, b, *, impl=None, operand_dtype=torch.bfloat16,
                 w_packed=None):
    if use_kernel(x, impl):
        _kernel_dtype(operand_dtype)
        if w_packed is None:
            w_packed = pack_weight(w)
        return linear_stats_cuda(
            x.to(torch.bfloat16).contiguous(),
            None if vec is None else vec.float().contiguous(), w_packed,
            b.detach().float().contiguous(), w.shape[1])
    return linear_stats_plain(x, vec, w, b, operand_dtype=operand_dtype)


def finalize_max(a, vec, *, k: int, impl=None):
    if use_kernel(a, impl):
        return finalize_max_cuda(a.to(torch.bfloat16).contiguous(),
                                 vec.float().contiguous(), k=k)
    return finalize_max_plain(a, vec, k=k)


def bwd_seed(a, vec, dout, amax, *, k: int, impl=None,
             operand_dtype=torch.bfloat16):
    if use_kernel(a, impl):
        _kernel_dtype(operand_dtype)
        return bwd_seed_cuda(a.to(torch.bfloat16).contiguous(),
                             vec.float().contiguous(),
                             dout.float().contiguous(),
                             amax.int().contiguous(), k=k)
    return bwd_seed_plain(a, vec, dout, amax, k=k,
                          operand_dtype=operand_dtype)


def bwd_layer(dy, a, a_prev, w, vec, s_in, vec_prev, *, impl=None,
              operand_dtype=torch.bfloat16, need_dprev: bool = True,
              w_packed=None):
    if use_kernel(dy, impl):
        _kernel_dtype(operand_dtype)
        if w_packed is None:
            w_packed = pack_weight(w)
        return bwd_layer_cuda(
            dy.to(torch.bfloat16).contiguous(), a.contiguous(),
            a_prev.to(torch.bfloat16).contiguous(), w_packed,
            vec.float().contiguous(), s_in.float().contiguous(),
            None if vec_prev is None else vec_prev.float().contiguous(),
            need_dprev=need_dprev)
    return bwd_layer_plain(dy, a, a_prev, w, vec, s_in, vec_prev,
                           operand_dtype=operand_dtype,
                           need_dprev=need_dprev)
