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
persistent block per SM slot (``csrc/samlp_single.cuh``), each block
walking one contiguous range of whole groups, and the launch adds the
blocks' partials after a grid barrier, in block order. The forward passes
(#15, #16: :func:`plan`) stage the weights, biases and BN vectors in
shared memory once and run the wmma tile chain of #11 / #12 with the
next tile's input in flight. The backward passes (#17, #18:
:func:`bwd_plan`) run #13 / #14's ``mma.sync`` tile body
(``csrc/samlp_rc_bwd.cuh``) at #13 / #14's tile, with the weights
resident in shared memory where they fit beside it (else through #13 /
#14's ring) and bwd final's dW on chip or in a slot a block.

The gate, :func:`fits`, is a pure function of the shapes (the plain path
on the CPU and the kernels on the card decide alike): whether every pass
of the stack has a plan within the H100's 232 448 B of shared memory a
block. A stack that fails it trains in stream mode
(``fused_mlp.effective_mode``). It does not carry the TPU's rules (whole
``8·k``-row chunks, 128-lane padding of ``g2``): the kernels take any row
count and copy ``g2`` as it is.

Kernels (``csrc/``): ``samlp_single_fwd.cu`` (#15 stats, #16 final max)
and ``samlp_single_bwd.cu`` (#17 bwd stats, #18 bwd final).
"""

from __future__ import annotations

import ctypes
import functools

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
                       [P, I, I, I, I, I, P, P, P, P, P, P, P, I, I, I, I, I,
                        I, P, I, P, P, P, P])
RC1_BWD_FINAL = Kernel("papc_samlp_rc1_bwd_final",
                       [P, I, I, I, I, P, P, P, P, P, P, P, I, I, I, I, I, I,
                        I, P, I, P, P, P, P, P, P, P])
KERNELS = (RC1_STATS, RC1_FINAL, RC1_BWD_STATS, RC1_BWD_FINAL)

SMEM_LIMIT = 232448  # shared memory a block may opt into on the H100
_TILES = (128, 64, 32, 16)  # rows per tile, largest that fits first
_SM_SMEM = 233472  # shared memory of one H100 SM, for blocks per SM
_MAX_PER_SM = 4


# ------------------------------------------------------------ the plans

def smem_bytes(kind: str, tm: int, k: int, c0: int, widths, *,
               upto: int | None = None) -> int:
    """Dynamic shared memory of one block of a forward pass at ``tm`` rows
    a tile (``samlp_single.cuh::make_single``, byte for byte): the tile
    chain's regions (``samlp_recompute.smem_bytes``), then the staged
    weights, biases, vectors (scale, shift) and two ``g2`` buffers."""
    r128 = rc._r128
    cs = [c0, *widths]
    p = [_pad(c) for c in cs]
    n = upto if kind == "stats" else len(widths)
    nv = n - 1 if kind == "stats" else n
    total = r128(rc.smem_bytes(kind, tm, k, c0, widths, upto=upto))
    total += sum(r128(p[j - 1] * p[j] * 2) for j in range(1, n + 1))
    total += sum(r128(cs[j] * 4) for j in range(1, n + 1))
    total += sum(r128(2 * cs[j] * 4) for j in range(1, nv + 1))
    return total + 2 * r128(tm * c0 * 2)


def plan(kind: str, m: int, k: int, c0: int, widths, limit: int, *,
         upto: int | None = None, sms: int = 132) -> dict:
    """#15 / #16's plan: rows a tile (the largest of 128, 64, 32, 16 that
    fits ``limit``), the most blocks the launch may take (as many as
    shared memory lets an SM hold, up to ``_MAX_PER_SM``; the launch takes
    fewer where registers allow fewer). The backward passes plan with
    :func:`bwd_plan`. Raises ``ValueError`` when no tile fits."""
    if kind not in ("stats", "final"):
        raise ValueError(f"plan takes the forward passes, got {kind!r}")
    if not 1 <= len(widths) <= rc.MAX_LAYERS:
        raise ValueError(f"the kernels take 1..{rc.MAX_LAYERS} layers, "
                         f"got {len(widths)}")
    for tm in _TILES:
        smem = smem_bytes(kind, tm, k, c0, widths, upto=upto)
        if smem <= limit:
            unit = 8 if kind == "stats" else k
            per_sm = max(1, min(_MAX_PER_SM, _SM_SMEM // (smem + 1024)))
            return {"tm": tm, "smem": smem,
                    "blocks": min(-(-m // unit), sms * per_sm)}
    raise ValueError(
        f"single-launch recompute {kind} needs {smem} B of shared memory "
        f"at 16 rows for c0={c0} widths={list(widths)}; the card allows "
        f"{limit}")


@functools.lru_cache(maxsize=None)
def bwd_plan(kind: str, m: int, k: int, c0: int, widths: tuple, limit: int,
             *, level: int | None = None, need_dg: bool = True,
             sms: int = 132) -> dict:
    """#17 / #18's plan on #13 / #14's candidates and bytes
    (``samlp_recompute.bwd_plan``: 4 ring stages before 3 and 2; bwd
    final's dW on chip before a slot a block, never from the rows; larger
    tiles first, each giving every SM a tile; the f32 a in shared memory
    before device scratch). At each candidate the weights resident in the
    ring's place (``w_res``, no ring: ``stages`` 0) come first, then the
    ring; the first that fits ``limit`` is taken, so residency never costs
    tile rows. ``unit``: the rows the blocks' ranges are cut at
    (:func:`range_unit`); ``blocks``: the most blocks the launch may take,
    one an SM and at least a unit each. Raises ``ValueError`` when nothing
    fits."""
    if kind not in ("bwd_stats", "bwd_final"):
        raise ValueError(f"bwd_plan takes the backward passes, got {kind!r}")
    n = len(widths)
    if not 1 <= n <= rc.MAX_LAYERS:
        raise ValueError(f"the kernels take 1..{rc.MAX_LAYERS} layers, "
                         f"got {n}")
    p = [_pad(c) for c in (c0, *widths)]
    dw_floats = sum(a * b for a, b in zip(p, p[1:]))
    stop = level + 1 if kind == "bwd_stats" else 1 if need_dg else 2
    min_tiles = min(sms, -(-m // 32))
    unit = range_unit(k, c0)
    blocks = min(-(-m // unit), sms)
    smem = None
    for dw, a_smem, tm, stages in rc._bwd_candidates(kind, ("smem", "slot")):
        if -(-m // tm) < min_tiles:
            continue
        for w_res in (True, False):
            smem = rc.bwd_smem_bytes(kind, tm, k, c0, widths, level=level,
                                     keep_h=dw is not None, a_smem=a_smem,
                                     dw_smem=dw == "smem",
                                     stages=stages, w_res=w_res)
            if smem > limit:
                continue
            return {"tm": tm, "smem": smem, "blocks": blocks, "unit": unit,
                    "stages": 0 if w_res else stages, "w_res": w_res,
                    "a_smem": a_smem, "dw": dw,
                    "prods": rc._bwd_schedule(p, tm, stop),
                    "a_scratch": 0 if a_smem else blocks * tm * sum(p[1:n]),
                    "db_part": blocks * sum(p[1:]) if dw else 0,
                    "dw_part": blocks * dw_floats if dw else 0}
    raise ValueError(
        f"single-launch recompute {kind} has no plan within {limit} B of "
        f"shared memory for c0={c0} widths={list(widths)} (last tried: "
        f"{smem} B)")


def range_unit(k: int, c0: int) -> int:
    """Rows a single-launch backward block's range is cut at: whole groups
    of ``k`` rows, as few as start on 16 bytes of ``g2`` (``unit·c0`` a
    multiple of 8; ``k`` itself at every registry stack), since the tile
    body reads its input rows in 16-byte pieces."""
    unit = k
    while unit * c0 % 8:
        unit += k
    return unit


def block_rows(m: int, unit: int, blocks: int) -> list:
    """The rows ``[begin, end)`` of each block of a single-launch pass
    (``csrc/samlp_single.cuh::block_rows``, block for block): whole units
    of ``unit`` rows split evenly over the blocks."""
    units = -(-m // unit)
    return [(min(m, units * b // blocks * unit),
             min(m, units * (b + 1) // blocks * unit)) for b in range(blocks)]


def fits(m: int, k: int, c0: int, widths) -> bool:
    """The ``recompute1`` gate: whether every pass of the stack (stats at
    each layer, final, bwd stats at each level, bwd final) has a plan
    within :data:`SMEM_LIMIT`."""
    n = len(widths)
    if not 1 <= n <= rc.MAX_LAYERS:
        return False
    try:
        for upto in range(1, n + 1):
            plan("stats", m, 1, c0, widths, SMEM_LIMIT, upto=upto)
        plan("final", m, k, c0, widths, SMEM_LIMIT)
        for level in range(1, n + 1):
            bwd_plan("bwd_stats", m, k, c0, tuple(widths), SMEM_LIMIT,
                     level=level)
        bwd_plan("bwd_final", m, k, c0, tuple(widths), SMEM_LIMIT)
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


def _bwd_plan_for(kind, g2, k, widths, **kw) -> dict:
    props = torch.cuda.get_device_properties(g2.device)
    return bwd_plan(kind, g2.shape[0], k, g2.shape[1], tuple(widths),
                    _smem_limit(g2), sms=props.multi_processor_count, **kw)


def rc1_bwd_stats_cuda(g2, dout, amax, vecs, w_packed, bs, mus, *,
                       level: int, k: int):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    rc._check_stack(g2, w_packed, bs, vecs, 4, len(bs))
    rc._check_cotangent(g2, dout, amax, k, widths[-1], vecs, mus, level)
    _check_aligned(g2, w_packed)
    pl = _bwd_plan_for("bwd_stats", g2, k, widths, level=level)
    prods = pl["prods"]
    c = widths[level - 1]
    dev = g2.device
    partials = torch.empty((pl["blocks"], 2, _pad(c)), dtype=torch.float32,
                           device=dev)
    a_scr = rc._empty(pl["a_scratch"], torch.float32, dev)
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    RC1_BWD_STATS(ptr(g2), m, c0, k, len(bs), level, rc._ints(widths),
                  rc._ptrs(w_packed), rc._ptrs(bs), rc._ptrs(vecs),
                  rc._ptrs(mus), ptr(dout), ptr(amax), pl["tm"],
                  pl["stages"], int(pl["a_smem"]), int(pl["w_res"]),
                  pl["blocks"], pl["unit"], rc._ints(sum(prods, ())),
                  len(prods), ptr(a_scr), ptr(partials), ptr(sums),
                  stream_of(g2))
    return sums


def rc1_bwd_final_cuda(g2, dout, amax, vecs, w_packed, bs, mus, *, k: int,
                       need_dg: bool = True):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    rc._check_stack(g2, w_packed, bs, vecs, 4, len(bs))
    rc._check_cotangent(g2, dout, amax, k, widths[-1], vecs, mus, 0)
    _check_aligned(g2, w_packed)
    pl = _bwd_plan_for("bwd_final", g2, k, widths, need_dg=need_dg)
    prods = pl["prods"]
    dev = g2.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    cins = [c0] + widths[:-1]
    dws = [f32(ci, co) for ci, co in zip(cins, widths)]
    dbs = [f32(c) for c in widths]
    dg = f32(m, c0) if need_dg else None
    a_scr = rc._empty(pl["a_scratch"], torch.float32, dev)
    db_part, dw_part = f32(pl["db_part"]), f32(pl["dw_part"])
    RC1_BWD_FINAL(ptr(g2), m, c0, k, len(bs), rc._ints(widths),
                  rc._ptrs(w_packed), rc._ptrs(bs), rc._ptrs(vecs),
                  rc._ptrs(mus), ptr(dout), ptr(amax), pl["tm"],
                  pl["stages"], int(pl["a_smem"]), int(pl["w_res"]),
                  rc.DW_MODES.index(pl["dw"]) + 1, pl["blocks"], pl["unit"],
                  rc._ints(sum(prods, ())), len(prods), ptr(a_scr),
                  ptr(db_part), ptr(dw_part), rc._ptrs(dbs), rc._ptrs(dws),
                  ptr(dg), stream_of(g2))
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
