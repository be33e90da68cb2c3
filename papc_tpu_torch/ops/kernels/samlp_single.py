"""Single-launch recompute passes (``fused_mlp``'s ``"recompute1"`` mode):
the CUDA kernels, their plan and the gate that decides which stacks run
them.

Counterpart of ``papc_tpu/ops/pallas/samlp_single.py`` (``recompute_stats``,
``recompute_final_max``, ``recompute_bwd_stats``, ``recompute_bwd_final``,
``fits``). They compute exactly the function of the grid recompute passes
(``samlp_recompute.py``), so their plain versions ARE
``samlp_recompute.rc_*_plain``, as the JAX package uses the same jnp twins
for both modes.

What differs is the launch: each pass is ONE cooperative launch of one
persistent block per SM slot (``csrc/samlp_single.cuh``). A block stages
the weights, biases, BN vectors and gradient means in shared memory once,
walks a contiguous range of rows with the next tile's input in flight,
keeps its sums (and, where :func:`plan` says so, its f32 dW) on chip, and
the launch adds the blocks' partials after a grid barrier, in block order.

The gate, :func:`fits`, is a pure function of the shapes (the plain path
on the CPU and the kernels on the card decide alike): whether every pass
of the stack has a plan within the H100's 232 448 B of shared memory a
block at the smallest tile, counting the resident weights and vectors and
both input buffers. A stack that fails it trains in stream mode
(``fused_mlp.effective_mode``). It does not carry the TPU's rules (whole
``8·k``-row chunks, 128-lane padding of ``g2``): the kernels take any row
count and copy ``g2`` as it is.

Kernels (``csrc/``): ``samlp_single_fwd.cu`` (#15 stats, #16 final max)
and ``samlp_single_bwd.cu`` (#17 bwd stats, #18 bwd final).
"""

from __future__ import annotations

import ctypes

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import samlp_recompute as rc
from papc_tpu_torch.ops.kernels import use_kernel
from papc_tpu_torch.ops.kernels.samlp_train import (_kernel_dtype, _pad,
                                                    _smem_limit)

P, I = ctypes.c_void_p, ctypes.c_int
RC1_STATS = Kernel("papc_samlp_rc1_stats",
                   [P, I, I, I, I, P, P, P, P, I, I, P, P, P])
RC1_FINAL = Kernel("papc_samlp_rc1_final",
                   [P, I, I, I, I, P, P, P, P, I, I, P, P, P])
RC1_BWD_STATS = Kernel("papc_samlp_rc1_bwd_stats",
                       [P, I, I, I, I, I, P, P, P, P, P, P, P, I, I, P, P,
                        P])
RC1_BWD_FINAL = Kernel("papc_samlp_rc1_bwd_final",
                       [P, I, I, I, I, P, P, P, P, P, P, P, I, I, I, P, P, P,
                        P, P, P])
KERNELS = (RC1_STATS, RC1_FINAL, RC1_BWD_STATS, RC1_BWD_FINAL)

SMEM_LIMIT = 232448  # shared memory a block may opt into on the H100
_TILES = (128, 64, 32, 16)  # rows per tile, largest that fits first
_SM_SMEM = 233472  # shared memory of one H100 SM, for blocks per SM
_MAX_PER_SM = 4


# ------------------------------------------------------------ the plans

def smem_bytes(kind: str, tm: int, k: int, c0: int, widths, *,
               upto: int | None = None, level: int | None = None,
               dw_on_chip: bool = False) -> int:
    """Dynamic shared memory of one block of a pass at ``tm`` rows a tile
    (``samlp_single.cuh::make_single``, byte for byte): the tile chain's
    regions (``samlp_recompute.smem_bytes``), then the staged weights,
    biases, vectors and (backward) gradient means, two ``g2`` buffers,
    (backward) two ``dout`` and two ``amax`` buffers and, for bwd final
    with ``dw_on_chip``, every layer's f32 dW."""
    r128 = rc._r128
    cs = [c0, *widths]
    p = [_pad(c) for c in cs]
    n = upto if kind == "stats" else len(widths)
    bwd = kind in ("bwd_stats", "bwd_final")
    nv = n - 1 if kind == "stats" else n
    total = r128(rc.smem_bytes(kind, tm, k, c0, widths, upto=upto,
                               level=level))
    total += sum(r128(p[j - 1] * p[j] * 2) for j in range(1, n + 1))
    total += sum(r128(cs[j] * 4) for j in range(1, n + 1))
    total += sum(r128((4 if bwd else 2) * cs[j] * 4)
                 for j in range(1, nv + 1))
    total += 2 * r128(tm * c0 * 2)
    if bwd:
        total += sum(r128(2 * cs[j] * 4) for j in range(1, n + 1))
        gpt = -(-tm // k) + 1
        total += 4 * r128(gpt * cs[n] * 4)
    if kind == "bwd_final" and dw_on_chip:
        total += sum(p[j - 1] * p[j] * 4 for j in range(1, n + 1))
    return total


def plan(kind: str, m: int, k: int, c0: int, widths, limit: int, *,
         upto: int | None = None, level: int | None = None,
         sms: int = 132) -> dict:
    """Rows a tile (the largest of 128, 64, 32, 16 that fits ``limit``;
    bwd final first tries to keep dW on chip, then in a device-memory slot
    a block), the most blocks the launch may take (as many as shared
    memory lets an SM hold, up to ``_MAX_PER_SM``; the launch takes fewer
    where registers allow fewer) and the scratch sizes. Raises
    ``ValueError`` when no tile fits."""
    if kind not in rc.PASSES:
        raise ValueError(f"pass must be one of {rc.PASSES}, got {kind!r}")
    if not 1 <= len(widths) <= rc.MAX_LAYERS:
        raise ValueError(f"the kernels take 1..{rc.MAX_LAYERS} layers, "
                         f"got {len(widths)}")
    p = [_pad(c) for c in (c0, *widths)]
    for on_chip in (True, False) if kind == "bwd_final" else (False,):
        for tm in _TILES:
            smem = smem_bytes(kind, tm, k, c0, widths, upto=upto,
                              level=level, dw_on_chip=on_chip)
            if smem <= limit:
                unit = 8 if kind == "stats" else k
                per_sm = max(1, min(_MAX_PER_SM, _SM_SMEM // (smem + 1024)))
                blocks = min(-(-m // unit), sms * per_sm)
                return {"tm": tm, "smem": smem, "blocks": blocks,
                        "dw_on_chip": on_chip,
                        "db_part": blocks * sum(p[1:]),
                        "dw_part": blocks * sum(a * b
                                                for a, b in zip(p, p[1:]))}
    raise ValueError(
        f"single-launch recompute {kind} needs {smem} B of shared memory "
        f"at 16 rows for c0={c0} widths={list(widths)}; the card allows "
        f"{limit}")


def fits(m: int, k: int, c0: int, widths) -> bool:
    """The ``recompute1`` gate: whether every pass of the stack (stats at
    each layer, final, bwd stats at each level, bwd final) has a plan
    within :data:`SMEM_LIMIT`."""
    n = len(widths)
    if not 1 <= n <= rc.MAX_LAYERS:
        return False
    passes = ([("stats", 1, {"upto": u}) for u in range(1, n + 1)]
              + [("final", k, {})]
              + [("bwd_stats", k, {"level": v}) for v in range(1, n + 1)]
              + [("bwd_final", k, {})])
    try:
        for kind, kk, kw in passes:
            plan(kind, m, kk, c0, widths, SMEM_LIMIT, **kw)
    except ValueError:
        return False
    return True


# ------------------------------------------------------ kernel wrappers

def _plan_for(kind, g2, k, widths, **kw) -> dict:
    props = torch.cuda.get_device_properties(g2.device)
    return plan(kind, g2.shape[0], k, g2.shape[1], widths, _smem_limit(g2),
                sms=props.multi_processor_count, **kw)


def _check_aligned(g2, w_packed):
    """The kernels copy ``g2`` and the packed weights in 16-byte pieces."""
    for name, t in [("g2", g2), *((f"w_packed[{j}]", w)
                                  for j, w in enumerate(w_packed))]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def rc1_stats_cuda(g2, vecs, w_packed, bs, *, upto: int):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    vecs = list(vecs[:upto - 1]) + [None] * (len(bs) - upto + 1)
    rc._check_stack(g2, w_packed, bs, vecs, None, upto)
    _check_aligned(g2, w_packed[:upto])
    pl = _plan_for("stats", g2, 1, widths, upto=upto)
    c = widths[upto - 1]
    partials = torch.empty((pl["blocks"], 2, _pad(c)), dtype=torch.float32,
                           device=g2.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=g2.device)
    RC1_STATS(ptr(g2), m, c0, len(bs), upto, rc._ints(widths),
              rc._ptrs(w_packed), rc._ptrs(bs), rc._ptrs(vecs), pl["tm"],
              pl["blocks"], ptr(partials), ptr(sums), stream_of(g2))
    return sums


def rc1_final_cuda(g2, vecs, w_packed, bs, *, k: int):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    rc._check_stack(g2, w_packed, bs, vecs, None, len(bs))
    _check_aligned(g2, w_packed)
    if m % k:
        raise ValueError(f"{m} rows are not whole groups of k={k}")
    pl = _plan_for("final", g2, k, widths)
    shape = (m // k, widths[-1])
    out = torch.empty(shape, dtype=torch.float32, device=g2.device)
    amax = torch.empty(shape, dtype=torch.int32, device=g2.device)
    RC1_FINAL(ptr(g2), m, c0, k, len(bs), rc._ints(widths),
              rc._ptrs(w_packed), rc._ptrs(bs), rc._ptrs(vecs), pl["tm"],
              pl["blocks"], ptr(out), ptr(amax), stream_of(g2))
    return out, amax


def rc1_bwd_stats_cuda(g2, dout, amax, vecs, w_packed, bs, mus, *,
                       level: int, k: int):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    rc._check_stack(g2, w_packed, bs, vecs, 4, len(bs))
    rc._check_cotangent(g2, dout, amax, k, widths[-1], vecs, mus, level)
    _check_aligned(g2, w_packed)
    pl = _plan_for("bwd_stats", g2, k, widths, level=level)
    c = widths[level - 1]
    partials = torch.empty((pl["blocks"], 2, _pad(c)), dtype=torch.float32,
                           device=g2.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=g2.device)
    RC1_BWD_STATS(ptr(g2), m, c0, k, len(bs), level, rc._ints(widths),
                  rc._ptrs(w_packed), rc._ptrs(bs), rc._ptrs(vecs),
                  rc._ptrs(mus), ptr(dout), ptr(amax), pl["tm"],
                  pl["blocks"], ptr(partials), ptr(sums), stream_of(g2))
    return sums


def rc1_bwd_final_cuda(g2, dout, amax, vecs, w_packed, bs, mus, *, k: int,
                       need_dg: bool = True):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    rc._check_stack(g2, w_packed, bs, vecs, 4, len(bs))
    rc._check_cotangent(g2, dout, amax, k, widths[-1], vecs, mus, 0)
    _check_aligned(g2, w_packed)
    pl = _plan_for("bwd_final", g2, k, widths)
    dev = g2.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    cins = [c0] + widths[:-1]
    dws = [f32(ci, co) for ci, co in zip(cins, widths)]
    dbs = [f32(c) for c in widths]
    dg = f32(m, c0) if need_dg else None
    db_part, dw_part = f32(pl["db_part"]), f32(pl["dw_part"])
    RC1_BWD_FINAL(ptr(g2), m, c0, k, len(bs), rc._ints(widths),
                  rc._ptrs(w_packed), rc._ptrs(bs), rc._ptrs(vecs),
                  rc._ptrs(mus), ptr(dout), ptr(amax), pl["tm"],
                  pl["blocks"], int(pl["dw_on_chip"]), ptr(db_part),
                  ptr(dw_part), rc._ptrs(dbs), rc._ptrs(dws), ptr(dg),
                  stream_of(g2))
    return dg, dws, dbs


# ----------------------------------------------------------- dispatch
# The same arguments as samlp_recompute's dispatchers, so fused_mlp's
# recompute Function runs either set.

def rc1_stats(g2, vecs, ws, bs, *, upto: int, impl=None,
              operand_dtype=torch.bfloat16, w_packed=None):
    if use_kernel(g2, impl):
        _kernel_dtype(operand_dtype)
        g, v, wp, b = rc._kernel_args(g2, vecs, ws, bs, w_packed)
        return rc1_stats_cuda(g, v, wp, b, upto=upto)
    return rc.rc_stats_plain(g2, vecs, ws, bs, upto=upto,
                             operand_dtype=operand_dtype)


def rc1_final(g2, vecs, ws, bs, *, k: int, impl=None,
              operand_dtype=torch.bfloat16, w_packed=None):
    if use_kernel(g2, impl):
        _kernel_dtype(operand_dtype)
        return rc1_final_cuda(*rc._kernel_args(g2, vecs, ws, bs, w_packed),
                              k=k)
    return rc.rc_final_plain(g2, vecs, ws, bs, k=k,
                             operand_dtype=operand_dtype)


def rc1_bwd_stats(g2, dout, amax, vecs, ws, bs, mus, *, level: int, k: int,
                  impl=None, operand_dtype=torch.bfloat16, w_packed=None):
    if use_kernel(g2, impl):
        _kernel_dtype(operand_dtype)
        g, v, wp, b = rc._kernel_args(g2, vecs, ws, bs, w_packed)
        return rc1_bwd_stats_cuda(g, dout.float().contiguous(),
                                  amax.int().contiguous(), v, wp, b,
                                  rc._f32_list(mus), level=level, k=k)
    return rc.rc_bwd_stats_plain(g2, dout, amax, vecs, ws, bs, mus,
                                 level=level, k=k,
                                 operand_dtype=operand_dtype)


def rc1_bwd_final(g2, dout, amax, vecs, ws, bs, mus, *, k: int, impl=None,
                  operand_dtype=torch.bfloat16, w_packed=None,
                  need_dg: bool = True):
    if use_kernel(g2, impl):
        _kernel_dtype(operand_dtype)
        g, v, wp, b = rc._kernel_args(g2, vecs, ws, bs, w_packed)
        return rc1_bwd_final_cuda(g, dout.float().contiguous(),
                                  amax.int().contiguous(), v, wp, b,
                                  rc._f32_list(mus), k=k, need_dg=need_dg)
    return rc.rc_bwd_final_plain(g2, dout, amax, vecs, ws, bs, mus, k=k,
                                 operand_dtype=operand_dtype,
                                 need_dg=need_dg)
