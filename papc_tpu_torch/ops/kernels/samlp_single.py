"""Single-launch recompute passes (``fused_mlp``'s ``"recompute1"`` mode):
the CUDA kernels, their plan and the gate that decides which stacks run
them.

Counterpart of ``papc_tpu/ops/pallas/samlp_single.py`` (``recompute_stats``,
``recompute_final_max``, ``recompute_bwd_stats``, ``recompute_bwd_final``,
``fits``). They compute exactly the function of the grid recompute passes
(``samlp_recompute.py``), so their plain versions ARE
``samlp_recompute.rc_*_plain``, as the JAX package uses the same jnp twins
for both modes.

What differs is the launch: each pass is ONE cooperative launch of
persistent blocks, as many as the card holds at once (``csrc/
samlp_single.cuh``), each block walking one contiguous range of rows (of
whole groups) from its start, and the launch adds the blocks' partials
after a grid barrier, in block order. Each pass runs its grid twin's tile
loop on the ``mma.sync`` core: the forward passes (#15, #16:
:func:`fwd_plan`) #11 / #12's (``csrc/samlp_rc_fwd.cuh``), the backward
passes (#17, #18: :func:`bwd_plan`) #13 / #14's (``csrc/
samlp_rc_bwd.cuh``), each with the weights resident in shared memory
where that pays and fits (else through the twin's ``cp.async`` ring),
#16 with each group's max pooled on chip and written from its tile, #18
with dW on chip or in a slot a block.

The gate, :func:`fits`, is a pure function of the shapes (the plain path
on the CPU and the kernels on the card decide alike): the admission rule
the mode has had since its first port (:func:`_admitted`), and a plan for
every pass. A stack that fails it trains in stream mode
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
                   [P, I, I, I, I, P, P, P, P, I, I, I, I, I, P, I, P, P, P])
RC1_FINAL = Kernel("papc_samlp_rc1_final",
                   [P, I, I, I, I, P, P, P, P, I, I, I, I, I, P, I, P, P, P])
RC1_BWD_STATS = Kernel("papc_samlp_rc1_bwd_stats",
                       [P, I, I, I, I, I, P, P, P, P, P, P, P, I, I, I, I, I,
                        I, P, I, P, P, P, P])
RC1_BWD_FINAL = Kernel("papc_samlp_rc1_bwd_final",
                       [P, I, I, I, I, P, P, P, P, P, P, P, I, I, I, I, I, I,
                        I, P, I, P, P, P, P, P, P, P])
KERNELS = (RC1_STATS, RC1_FINAL, RC1_BWD_STATS, RC1_BWD_FINAL)

SMEM_LIMIT = 232448  # shared memory a block may opt into on the H100


# ------------------------------------------------------------ the plans

@functools.lru_cache(maxsize=None)
def fwd_plan(kind: str, m: int, k: int, c0: int, widths: tuple, limit: int,
             *, upto: int | None = None, sms: int = 132) -> dict:
    """#15 / #16's plan on #11 / #12's layout and candidates
    (``samlp_recompute.fwd_plan``, ``fwd_smem_bytes``): rows a tile (128,
    64, 32: the largest that gives every SM a tile, as #11 / #12's), at
    each the first that fits ``limit`` of: ``_FWD_PER_SM`` (2) blocks an
    SM where there are more units than SMs, then one; at each the weights
    resident where the block's longest range holds ``_FWD_RES_TILES``
    tiles, before a ring of 4, 3 or 2 stages. ``unit``: the rows the
    blocks' ranges are cut at (8 for stats, so every tile's ``g2`` rows
    start on 16 bytes; :func:`range_unit` for final); ``blocks``: the most
    blocks the launch may take, ``min(units, sms * per_sm)``; ``tiles``:
    the tiles of the longest range; ``prods``: the tile's products a_1 ..
    a_n. Raises ``ValueError`` when nothing fits."""
    if kind not in ("stats", "final"):
        raise ValueError(f"fwd_plan takes the forward passes, got {kind!r}")
    if not 1 <= len(widths) <= rc.MAX_LAYERS:
        raise ValueError(f"the kernels take 1..{rc.MAX_LAYERS} layers, "
                         f"got {len(widths)}")
    n = upto if kind == "stats" else len(widths)
    p = [_pad(c) for c in (c0, *widths)]
    unit = 8 if kind == "stats" else range_unit(k, c0)
    units = -(-m // unit)
    min_tiles = min(sms, -(-m // 32))
    smem = None
    for tm in rc._BWD_TILES:
        if -(-m // tm) < min_tiles:
            continue
        for per_sm in (rc._FWD_PER_SM, 1) if units > sms else (1,):
            blocks = min(units, sms * per_sm)
            tiles = -(-min(m, -(-units // blocks) * unit) // tm)
            # resident weights only where a block walks several tiles:
            # staged once, they cost a ring's bytes without its overlap
            resident = ((True, 0),) if tiles >= rc._FWD_RES_TILES else ()
            for w_res, stages in resident + ((False, 4), (False, 3),
                                             (False, 2)):
                smem = rc.fwd_smem_bytes(kind, tm, k, c0, widths, upto=upto,
                                         stages=stages, w_res=w_res)
                if smem > limit or per_sm * (smem + 1024) > rc._SM_SMEM:
                    continue
                return {"tm": tm, "smem": smem, "blocks": blocks,
                        "per_sm": per_sm, "unit": unit, "tiles": tiles,
                        "stages": stages, "w_res": w_res,
                        "prods": rc._bwd_schedule(p[:n + 1], tm, n + 1)}
    raise ValueError(
        f"single-launch recompute {kind} has no plan within {limit} B of "
        f"shared memory for c0={c0} widths={list(widths)} (last tried: "
        f"{smem} B)")


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


def _admitted(k: int, c0: int, widths) -> bool:
    """The admission rule ``recompute1`` has had since its first port,
    kept as it is so that the mode's decisions do not move with a
    kernel's layout: the shared memory a block of the first forward design
    took (a wmma tile chain with its f32 scratch and sums or pooled keys,
    then the staged bf16 weights, biases, the known BN vectors and two
    ``g2`` buffers) fits :data:`SMEM_LIMIT` at 128, 64, 32 or 16 rows, for
    stats at each layer and for final. No kernel runs that layout now;
    admitting more stacks (MSG SA2 at c0 = 323, k = 64, which JAX admits)
    is a decision of its own."""
    cs = [c0, *widths]
    p = [_pad(c) for c in cs]
    r128 = rc._r128

    def block_bytes(kind, tm, n):
        ld = [max([p[i] + 8 for i in range(r, n, 2)], default=0)
              for r in (0, 1)]
        total = r128(tm * ld[0] * 2) + r128(tm * ld[1] * 2) + 8 * 256 * 4
        total += (max(1, tm // 64) * 2 * p[n] * 4 if kind == "stats"
                  else (-(-tm // k) + 1) * p[n] * 8)
        nv = n - 1 if kind == "stats" else n
        total = r128(total)
        total += sum(r128(p[j - 1] * p[j] * 2) for j in range(1, n + 1))
        total += sum(r128(cs[j] * 4) for j in range(1, n + 1))
        total += sum(r128(2 * cs[j] * 4) for j in range(1, nv + 1))
        return total + 2 * r128(tm * c0 * 2)

    passes = [("stats", n) for n in range(1, len(widths) + 1)]
    return all(any(block_bytes(kind, tm, n) <= SMEM_LIMIT
                   for tm in (128, 64, 32, 16))
               for kind, n in passes + [("final", len(widths))])


def fits(m: int, k: int, c0: int, widths) -> bool:
    """The ``recompute1`` gate: the admission rule (:func:`_admitted`),
    and a plan within :data:`SMEM_LIMIT` for every pass of the stack
    (stats at each layer, final, bwd stats at each level, bwd final)."""
    n = len(widths)
    if not 1 <= n <= rc.MAX_LAYERS or not _admitted(k, c0, widths):
        return False
    w = tuple(widths)
    try:
        for upto in range(1, n + 1):
            fwd_plan("stats", m, 1, c0, w, SMEM_LIMIT, upto=upto)
        fwd_plan("final", m, k, c0, w, SMEM_LIMIT)
        for level in range(1, n + 1):
            bwd_plan("bwd_stats", m, k, c0, w, SMEM_LIMIT, level=level)
        bwd_plan("bwd_final", m, k, c0, w, SMEM_LIMIT)
    except ValueError:
        return False
    return True


# ------------------------------------------------------ kernel wrappers

def _plan_for(kind, g2, k, widths, **kw) -> dict:
    props = torch.cuda.get_device_properties(g2.device)
    return fwd_plan(kind, g2.shape[0], k, g2.shape[1], tuple(widths),
                    _smem_limit(g2), sms=props.multi_processor_count, **kw)


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
    prods = pl["prods"]
    c = widths[upto - 1]
    partials = torch.empty((pl["blocks"], 2, _pad(c)), dtype=torch.float32,
                           device=g2.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=g2.device)
    RC1_STATS(ptr(g2), m, c0, len(bs), upto, rc._ints(widths),
              rc._ptrs(w_packed), rc._ptrs(bs), rc._ptrs(vecs), pl["tm"],
              pl["stages"], int(pl["w_res"]), pl["blocks"], pl["unit"],
              rc._ints(sum(prods, ())), len(prods), ptr(partials), ptr(sums),
              stream_of(g2))
    return sums


def rc1_final_cuda(g2, vecs, w_packed, bs, *, k: int):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    rc._check_stack(g2, w_packed, bs, vecs, None, len(bs))
    _check_aligned(g2, w_packed)
    if m % k:
        raise ValueError(f"{m} rows are not whole groups of k={k}")
    pl = _plan_for("final", g2, k, widths)
    prods = pl["prods"]
    shape = (m // k, widths[-1])
    out = torch.empty(shape, dtype=torch.float32, device=g2.device)
    amax = torch.empty(shape, dtype=torch.int32, device=g2.device)
    RC1_FINAL(ptr(g2), m, c0, k, len(bs), rc._ints(widths),
              rc._ptrs(w_packed), rc._ptrs(bs), rc._ptrs(vecs), pl["tm"],
              pl["stages"], int(pl["w_res"]), pl["blocks"], pl["unit"],
              rc._ints(sum(prods, ())), len(prods), ptr(out), ptr(amax),
              stream_of(g2))
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
