"""Recompute-mode set-abstraction training passes: the CUDA kernels and
their plain PyTorch versions.

Counterpart of the recompute passes of ``papc_tpu/ops/pallas/samlp.py``
(``recompute_stats``, ``recompute_final_max``, ``recompute_bwd_stats``,
``recompute_bwd_final``) and of their jnp twins in
``papc_tpu/ops/fused_mlp.py`` (``_jnp_chain``, ``_jnp_rc_stats``,
``_jnp_rc_final``, ``_jnp_chain_bwd``, ``_jnp_rc_bwd_stats``,
``_jnp_rc_bwd_final``), which the plain versions here mirror op for op.
``ops/fused_mlp.py`` chains them into the training forward and backward of
one Dense→BN→ReLU stack + max when the mode is ``"recompute"``.

Numeric contract, kept from the TPU kernels and unlike stream mode: every
pass re-derives the layer chain from ``g2`` (the block input in the operand
dtype) and keeps it in f32; only the operands of a product are rounded to
``operand_dtype`` (bf16 on the card; f32 or float64 allowed for the plain
versions, as the twins' ``sdtype``). No pre-activation is ever stored, so
the backward saves only ``g2``, the ``[4, C]`` BN vectors and the argmax.

Kernels (``csrc/``), all on the ``mma.sync`` core of ``samlp_mma.cuh``
(row tiles of 128, 64 or 32 rows, the weights through a ``cp.async`` ring
or resident, epilogues from registers): ``samlp_rc_fwd.cu`` (#11 stats,
#12 final max; :func:`fwd_plan`: #12 pools its max on chip and writes it
from the tile where tiles hold whole groups) and ``samlp_rc_bwd.cu`` (#13
bwd stats, #14 bwd final; :func:`bwd_plan`: #14's dW on chip, in a slot a
block, or from the rows). Each sum is reduced in a fixed order, so
repeated runs give the same bits. The single-launch passes #15-18
(``samlp_single.py``) run the same tile loops on these layouts.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import check, use_kernel
from papc_tpu_torch.ops.kernels.samlp_train import (_aligned16, _f32,
                                                    _kernel_dtype, _op, _pad,
                                                    _smem_limit, pack_weight)

P, I = ctypes.c_void_p, ctypes.c_int
RC_STATS = Kernel("papc_samlp_rc_stats",
                  [P, I, I, I, I, P, P, P, P, I, I, I, I, P, I, P, P, P])
RC_FINAL = Kernel("papc_samlp_rc_final",
                  [P, I, I, I, I, P, P, P, P, I, I, I, I, P, I, P, P, P, P])
RC_BWD_STATS = Kernel("papc_samlp_rc_bwd_stats",
                      [P, I, I, I, I, I, P, P, P, P, P, P, P, I, I, I, I, P,
                       I, P, P, P, P])
RC_BWD_FINAL = Kernel("papc_samlp_rc_bwd_final",
                      [P, I, I, I, I, P, P, P, P, P, P, P, I, I, I, I, I, I,
                       P, I, P, P, P, P, P, P, P, P])
KERNELS = (RC_STATS, RC_FINAL, RC_BWD_STATS, RC_BWD_FINAL)

MAX_LAYERS = 4
_SKEW = 8  # bf16 elements of padding per shared-memory row
_WARPS = 8
_SM_SMEM = 233472  # shared memory of one H100 SM, for blocks per SM
_BWD_TILES = (128, 64, 32)  # #11-14: rows a tile, largest first
# #11 / #12: two blocks an SM (their kernels are compiled for at most 128
# registers a thread) wherever there are more tiles than SMs and shared
# memory holds two; the weights resident where blocks walk this many tiles
_FWD_PER_SM = 2
_FWD_RES_TILES = 4
DW_MODES = ("smem", "slot", "rows")  # #14's dW: the C entry's modes 1-3
_DW_TM, _DW_TN, _DW_CHUNK = 64, 256, 32  # rc_dw_rows_kernel's tile


# ------------------------------------------------------- plain versions

def chain_plain(g2, vecs, ws, bs, upto, *, operand_dtype=torch.bfloat16):
    """``a_1 .. a_upto`` and ``h_1 .. h_{upto-1}`` re-derived from ``g2``
    with the known BN affines ``vecs[i]`` (rows scale, shift)."""
    h = _f32(g2)
    a_list, h_list = [], []
    for i in range(upto):
        a = _op(h, operand_dtype) @ _op(ws[i], operand_dtype) + _f32(bs[i])
        a_list.append(a)
        if i < upto - 1:
            h = torch.clamp_min(a * vecs[i][0] + vecs[i][1], 0.0)
            h_list.append(h)
    return a_list, h_list


def rc_stats_plain(g2, vecs, ws, bs, *, upto: int,
                   operand_dtype=torch.bfloat16):
    """Layer ``upto``'s ``(Σa, Σa²)`` ``[2, C]`` of the f32 ``a``."""
    a = chain_plain(g2, vecs, ws, bs, upto, operand_dtype=operand_dtype)[0][-1]
    return torch.stack([a.sum(0), (a * a).sum(0)])


def rc_final_plain(g2, vecs, ws, bs, *, k: int, operand_dtype=torch.bfloat16):
    """The whole chain, the last BN+ReLU, the max over each group of ``k``
    rows and the first row attaining it: ``(out [M/k, C] f32, amax i32)``."""
    a_list, _ = chain_plain(g2, vecs, ws, bs, len(ws),
                            operand_dtype=operand_dtype)
    h = torch.clamp_min(a_list[-1] * vecs[-1][0] + vecs[-1][1], 0.0)
    m, c = h.shape
    h3 = h.reshape(m // k, k, c)
    mx = h3.amax(dim=1)
    kio = torch.arange(k, dtype=torch.int32, device=h.device)[None, :, None]
    amax = torch.where(h3 == mx[:, None, :], kio, k).amin(dim=1)
    return mx, amax.int()


def chain_bwd_plain(a_list, dout, amax, vecs, ws, mus, *, k: int, level: int,
                    operand_dtype=torch.bfloat16, need_dg: bool = True):
    """Walk the max's cotangent down from layer L to ``level``: ``dout``
    at the first argmax through the last ReLU gate, then per layer
    ``da = scale·((dy − mu[0]) − x̂·mu[1])``, ``dhp = op(da)·op(W)ᵀ`` and
    the previous gate. Returns ``(dy at level, {j: da_j})``; at level 0
    ``dy`` is the block input's gradient (``None`` without ``need_dg``)."""
    n = len(ws)
    a_top = a_list[n - 1]
    m, c = a_top.shape
    o = a_top * vecs[n - 1][0] + vecs[n - 1][1]
    kio = torch.arange(k, dtype=torch.int32, device=a_top.device)[None, :,
                                                                    None]
    dh = torch.where(kio == amax[:, None, :], _f32(dout)[:, None, :],
                     0.0).reshape(m, c)
    dy = torch.where(o > 0, dh, 0.0)
    da_map = {}
    for j in range(n, level, -1):
        vj = vecs[j - 1]
        xhat = (a_list[j - 1] - vj[2]) * vj[3]
        da = vj[0] * (dy - mus[j - 1][0] - xhat * mus[j - 1][1])
        da_map[j] = da
        if j == 1 and not need_dg:
            return None, da_map
        dhp = _op(da, operand_dtype) @ _op(ws[j - 1], operand_dtype).t()
        if j > 1:
            vp = vecs[j - 2]
            dy = torch.where(a_list[j - 2] * vp[0] + vp[1] > 0, dhp, 0.0)
        else:
            dy = dhp
    return dy, da_map


def rc_bwd_stats_plain(g2, dout, amax, vecs, ws, bs, mus, *, level: int,
                       k: int, operand_dtype=torch.bfloat16):
    """Layer ``level``'s ``(Σdy, Σdy·x̂)`` ``[2, C]``; ``vecs`` ``[4, C]``,
    ``mus[j]`` ``[2, C]`` for the layers above ``level``."""
    a_list, _ = chain_plain(g2, vecs, ws, bs, len(ws),
                            operand_dtype=operand_dtype)
    dy, _ = chain_bwd_plain(a_list, dout, amax, vecs, ws, mus, k=k,
                            level=level, operand_dtype=operand_dtype)
    vl = vecs[level - 1]
    xhat = (a_list[level - 1] - vl[2]) * vl[3]
    return torch.stack([dy.sum(0), (dy * xhat).sum(0)])


def rc_bwd_final_plain(g2, dout, amax, vecs, ws, bs, mus, *, k: int,
                       operand_dtype=torch.bfloat16, need_dg: bool = True):
    """``(dg [M, C0] | None, [dW_j [Cin, Cout]], [db_j [Cout]])``, all f32:
    ``dW_j = op(h_{j-1})ᵀ·op(da_j)``, ``db_j = Σda_j``."""
    a_list, h_list = chain_plain(g2, vecs, ws, bs, len(ws),
                                 operand_dtype=operand_dtype)
    dg, da_map = chain_bwd_plain(a_list, dout, amax, vecs, ws, mus, k=k,
                                 level=0, operand_dtype=operand_dtype,
                                 need_dg=need_dg)
    h_prev = [_f32(g2)] + h_list
    dws = [_op(h_prev[j - 1], operand_dtype).t() @ _op(da_map[j],
                                                        operand_dtype)
           for j in range(1, len(ws) + 1)]
    dbs = [da_map[j].sum(0) for j in range(1, len(ws) + 1)]
    return dg, dws, dbs


# ------------------------------------------------------------ the plans

def _r128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def _group_slots(tm: int, k: int) -> int:
    """#12's pooled key slots a tile of ``tm`` rows (the groups it can
    touch): ``tm / k`` where k divides tm (whole groups), 1 where tm
    divides k, else ``ceil(tm / k) + 1``."""
    if tm % k == 0:
        return tm // k
    return 1 if k % tm == 0 else -(-tm // k) + 1


def fwd_smem_bytes(kind: str, tm: int, k: int, c0: int, widths, *,
                   upto: int | None = None, stages: int = 4,
                   w_res: bool = False) -> int:
    """Dynamic shared memory of one block of #11 (``"stats"``, layers 1 ..
    ``upto``) or #12 (``"final"``) at ``tm`` rows a tile
    (``csrc/samlp_rc_fwd.cu::make_fwd_layout``, byte for byte): h_0 ..
    h_{n-1} in two ping-pong bf16 regions, the weight ring of ``stages``
    slices or, ``w_res``, every W_j resident in rows of ``p_j + 8``, then
    the per-row-warp sums (stats) or the pooled keys (final)."""
    p = [_pad(c) for c in (c0, *widths)]
    n = upto if kind == "stats" else len(widths)
    rw, chunk, ks = _bwd_shape(tm)
    total = sum(_r128(tm * (max(p[r:n:2]) + _SKEW) * 2)
                for r in (0, 1) if p[r:n:2])
    if w_res:
        total += sum(_r128(a * (b + _SKEW) * 2)
                     for a, b in zip(p[:n], p[1:n + 1]))
    else:
        total += _r128(stages * ks * (chunk + _SKEW) * 2)
    if kind == "stats":
        return total + _r128(rw * 2 * p[n] * 4)
    return total + _r128(_group_slots(tm, k) * p[n] * 8)


@functools.lru_cache(maxsize=None)
def fwd_plan(kind: str, m: int, k: int, c0: int, widths: tuple, limit: int,
             *, upto: int | None = None, sms: int = 132) -> dict:
    """#11 / #12's plan: rows a tile (128, 64, 32: the largest that gives
    every SM a tile, at least ``min(sms, ceil(m / 32))`` tiles), at each
    the first that fits ``limit`` of: ``_FWD_PER_SM`` (2) blocks an SM
    where there are more tiles than SMs, then one; at each the weights
    resident (where there are ``_FWD_RES_TILES`` tiles an SM) before a
    ring of 4, 3 or 2 stages. ``blocks = min(tiles, sms * per_sm)``.
    ``prods``: the tile's products a_1 .. a_n (``_bwd_schedule``'s
    forward part). #12 (``"final"``): ``whole`` where k divides tm (each
    tile writes its groups' out and amax: one launch), else ``keys``, the
    u64 scratch of every tile's ``gpt`` key slots for the merge launch.
    Raises ``ValueError`` when nothing fits."""
    if kind not in ("stats", "final"):
        raise ValueError(f"fwd_plan takes the forward passes, got {kind!r}")
    if not 1 <= len(widths) <= MAX_LAYERS:
        raise ValueError(f"the kernels take 1..{MAX_LAYERS} layers, "
                         f"got {len(widths)}")
    n = upto if kind == "stats" else len(widths)
    p = [_pad(c) for c in (c0, *widths)]
    min_tiles = min(sms, -(-m // 32))
    smem = None
    for tm in _BWD_TILES:
        tiles = -(-m // tm)
        if tiles < min_tiles:
            continue
        # resident weights only where a block walks several tiles: staged
        # once, they cost a ring's bytes without its overlap
        resident = ((True, 0),) if tiles >= _FWD_RES_TILES * sms else ()
        for per_sm, w_res, stages in [
                (ps, w, st) for ps in ((_FWD_PER_SM, 1) if tiles > sms
                                       else (1,))
                for w, st in resident + ((False, 4), (False, 3), (False, 2))]:
            smem = fwd_smem_bytes(kind, tm, k, c0, widths, upto=upto,
                                  stages=stages, w_res=w_res)
            if smem > limit or per_sm * (smem + 1024) > _SM_SMEM:
                continue
            whole = kind == "stats" or tm % k == 0
            gpt = _group_slots(tm, k) if kind == "final" else 0
            return {"tm": tm, "smem": smem, "tiles": tiles,
                    "blocks": min(tiles, sms * per_sm), "stages": stages,
                    "w_res": w_res, "per_sm": per_sm,
                    "prods": _bwd_schedule(p[:n + 1], tm, n + 1),
                    "whole": whole, "gpt": gpt,
                    "keys": 0 if whole else tiles * gpt * widths[-1]}
    raise ValueError(
        f"recompute {kind} has no plan within {limit} B of shared memory "
        f"for c0={c0} widths={list(widths)} (last tried: {smem} B)")


def _bwd_shape(tm: int) -> tuple:
    """#13 / #14's block at ``tm`` rows: (row warps, chunk columns, k
    rows a ring slice)."""
    rw = tm // 32
    return rw, 64 * (_WARPS // rw), 16 if tm == 32 else 32


def bwd_smem_bytes(kind: str, tm: int, k: int, c0: int, widths, *,
                   level: int | None = None, keep_h: bool = False,
                   a_smem: bool = True, dw_smem: bool = False,
                   stages: int = 3, w_res: bool = False) -> int:
    """Dynamic shared memory of one block of #13 / #17 (``"bwd_stats"``)
    or #14 / #18 (``"bwd_final"``) at ``tm`` rows a tile
    (``csrc/samlp_rc_bwd.cuh::make_layout``, byte for byte): the bf16 h /
    da buffers (``keep_h``: h_0 .. h_{n-1} and da_n; else two ping-pong
    regions), the f32 a_1 .. a_{n-1} when ``a_smem``, the weight ring of
    ``stages`` stages or, ``w_res``, every W_j resident in rows of
    ``p_j + 8``, the sums, with ``dw_smem`` every layer's f32 dW, and the
    amax and dout rows of the groups a tile can touch."""
    p = [_pad(c) for c in (c0, *widths)]
    n = len(widths)
    if keep_h:
        total = sum(_r128(tm * (p[i] + _SKEW) * 2) for i in range(n + 1))
    else:
        total = sum(_r128(tm * (max(p[r:n + 1:2]) + _SKEW) * 2)
                    for r in (0, 1))
    if a_smem:
        total += sum(_r128(tm * (p[j] + _SKEW) * 4) for j in range(1, n))
    rw, chunk, ks = _bwd_shape(tm)
    if w_res:
        total += sum(_r128(a * (b + _SKEW) * 2) for a, b in zip(p, p[1:]))
    else:
        stage = max(ks * (chunk + _SKEW), chunk * (ks + _SKEW))
        total += _r128(stages * stage * 2)
    cols = 2 * p[level] if kind == "bwd_stats" else sum(p[1:])
    total += _r128(rw * cols * 4)
    if dw_smem:
        total += _r128(sum(a * b for a, b in zip(p, p[1:])) * 4)
    return total + 2 * _r128(((-(-tm // k) + 1) * widths[-1] + 16) * 4)


def _dw_splits(p, m_pad: int, sms: int) -> tuple:
    """rc_dw_rows_kernel's (splits, rows a split): about two blocks an SM
    over the layers' 64 x 256 dW tiles, every split non-empty."""
    tiles = sum(-(-a // _DW_TM) * -(-b // _DW_TN) for a, b in zip(p, p[1:]))
    chunks = m_pad // _DW_CHUNK
    want = max(1, min(chunks, -(-2 * sms // tiles)))
    splits = -(-chunks // -(-chunks // want))
    return splits, -(-chunks // splits) * _DW_CHUNK


def _bwd_candidates(kind: str, dw_modes=("smem", "rows", "slot")):
    """``(dw, a_smem, tm, stages)`` in the order the backward plans try
    them: 4 ring stages before 3 and 2, then the dW modes in order (none
    in bwd stats), larger tiles first, the f32 a in shared memory before
    device scratch."""
    for stages in (4, 3, 2):
        for dw in (None,) if kind == "bwd_stats" else dw_modes:
            for tm in _BWD_TILES:
                for a_smem in (True, False):
                    yield dw, a_smem, tm, stages


def _bwd_schedule(p, tm: int, stop: int) -> tuple:
    """A tile's products in order, ``(layer, walk, span)`` each: the chain
    forward a_1 .. a_n, then the walk down from layer n to ``stop``. Each
    product's output columns go in chunks of ``chunk``; column warp ``wc``
    takes columns ``[wc * 64, wc * 64 + 64)`` of a chunk and ``[wc * span,
    wc * span + span)`` of the last one (each cut at the chunk's width):
    the last chunk split evenly in n16 pairs. The kernel runs this table
    as it is."""
    n = len(p) - 1
    rw, chunk, _ = _bwd_shape(tm)
    cw = _WARPS // rw
    out = []
    for j, walk in ([(j, 0) for j in range(1, n + 1)]
                    + [(j, 1) for j in range(n, stop - 1, -1)]):
        ndim = p[j - 1] if walk else p[j]
        width = ndim - (ndim - 1) // chunk * chunk
        out.append((j, walk, -(-(-(-width // cw)) // 16) * 16))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def bwd_plan(kind: str, m: int, k: int, c0: int, widths: tuple, limit: int,
             *, level: int | None = None, need_dg: bool = True,
             sms: int = 132) -> dict:
    """#13 / #14's plan: the first candidate that fits ``limit`` and
    gives every SM a tile (at least ``min(sms, ceil(m / 32))`` tiles).
    Candidates, 4 ring stages before 3 and 2, larger tiles first (128, 64,
    32 rows), at each the f32 a in shared memory, then in device scratch:
    bwd stats; bwd final with dW on chip, then dW from the rows where
    their bf16 h and da and their split partials take fewer bytes than a
    dW slot a block would, then a dW slot a block. One block an SM
    (``blocks = min(tiles, sms)``). ``prods``: the tile's products
    (:func:`_bwd_schedule`), walking down to ``level + 1`` (bwd stats) or
    to layer 1 with dg (``need_dg``), else 2. Raises ``ValueError`` when
    nothing fits."""
    if kind not in ("bwd_stats", "bwd_final"):
        raise ValueError(f"bwd_plan takes the backward passes, got {kind!r}")
    n = len(widths)
    if not 1 <= n <= MAX_LAYERS:
        raise ValueError(f"the kernels take 1..{MAX_LAYERS} layers, got {n}")
    p = [_pad(c) for c in (c0, *widths)]
    dw_floats = sum(a * b for a, b in zip(p, p[1:]))
    min_tiles = min(sms, -(-m // 32))
    smem = None
    for dw, a_smem, tm, stages in _bwd_candidates(kind):
        tiles = -(-m // tm)
        if tiles < min_tiles:
            continue
        m_pad = tiles * tm
        blocks = min(tiles, sms)
        rows = m_pad * (sum(p[:n]) + sum(p[1:])) if dw == "rows" else 0
        splits, rows_per_split = (_dw_splits(p, m_pad, sms) if dw == "rows"
                                  else (0, 0))
        if dw == "rows" and 2 * rows + 4 * splits * dw_floats >= (
                4 * blocks * dw_floats):
            continue
        smem = bwd_smem_bytes(kind, tm, k, c0, widths, level=level,
                              keep_h=dw in ("smem", "slot"), a_smem=a_smem,
                              dw_smem=dw == "smem", stages=stages)
        if smem > limit:
            continue
        parts = splits if dw == "rows" else blocks
        stop = level + 1 if kind == "bwd_stats" else 1 if need_dg else 2
        return {"tm": tm, "smem": smem, "tiles": tiles, "blocks": blocks,
                "stages": stages, "a_smem": a_smem, "dw": dw,
                "dw_splits": splits, "rows_per_split": rows_per_split,
                "m_pad": m_pad, "prods": _bwd_schedule(p, tm, stop),
                "a_scratch": 0 if a_smem else blocks * tm * sum(p[1:n]),
                "rows": rows,
                "partials": blocks * 2 * p[level] if level else 0,
                "db_part": blocks * sum(p[1:]) if dw else 0,
                "dw_part": parts * dw_floats if dw else 0}
    raise ValueError(
        f"recompute {kind} has no plan within {limit} B of shared memory "
        f"for c0={c0} widths={list(widths)} (last tried: {smem} B)")


# ------------------------------------------------------ kernel wrappers

def _ints(vals):
    return (ctypes.c_int * len(vals))(*vals)


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(
        *[None if t is None else t.data_ptr() for t in ts])


def _fwd_plan_for(kind, g2, k, widths, **kw) -> dict:
    props = torch.cuda.get_device_properties(g2.device)
    return fwd_plan(kind, g2.shape[0], k, g2.shape[1], tuple(widths),
                    _smem_limit(g2), sms=props.multi_processor_count, **kw)


def _check_stack(g2, w_packed, bs, vecs, rows: int, layers: int):
    """g2 bf16; the first ``layers`` packed weights, biases and vectors
    (``rows`` of them, or ``None``: any)."""
    m, c0 = g2.shape
    check(g2, "g2", torch.bfloat16, (m, c0))
    cin = c0
    for j in range(layers):
        c = bs[j].shape[0]
        check(w_packed[j], f"w_packed[{j}]", torch.bfloat16,
              (_pad(cin), _pad(c)))
        check(bs[j], f"b[{j}]", torch.float32, (c,))
        if vecs[j] is not None:
            check(vecs[j], f"vec[{j}]", torch.float32, (rows, c))
        cin = c


def rc_stats_cuda(g2, vecs, w_packed, bs, *, upto: int):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    vecs = list(vecs[:upto - 1]) + [None] * (len(bs) - upto + 1)
    _check_stack(g2, w_packed, bs, vecs, None, upto)
    g2 = _aligned16(g2)
    pl = _fwd_plan_for("stats", g2, 1, widths, upto=upto)
    prods = pl["prods"]
    c = widths[upto - 1]
    partials = torch.empty((pl["blocks"], 2, _pad(c)), dtype=torch.float32,
                           device=g2.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=g2.device)
    RC_STATS(ptr(g2), m, c0, len(bs), upto, _ints(widths), _ptrs(w_packed),
             _ptrs(bs), _ptrs(vecs), pl["tm"], pl["stages"],
             int(pl["w_res"]), pl["blocks"], _ints(sum(prods, ())),
             len(prods), ptr(partials), ptr(sums),
             stream_of(g2))
    return sums


def rc_final_cuda(g2, vecs, w_packed, bs, *, k: int):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    _check_stack(g2, w_packed, bs, vecs, None, len(bs))
    if m % k:
        raise ValueError(f"{m} rows are not whole groups of k={k}")
    g2 = _aligned16(g2)
    pl = _fwd_plan_for("final", g2, k, widths)
    prods = pl["prods"]
    shape = (m // k, widths[-1])
    keys = _empty(pl["keys"], torch.int64, g2.device)  # held until queued
    out = torch.empty(shape, dtype=torch.float32, device=g2.device)
    amax = torch.empty(shape, dtype=torch.int32, device=g2.device)
    RC_FINAL(ptr(g2), m, c0, k, len(bs), _ints(widths), _ptrs(w_packed),
             _ptrs(bs), _ptrs(vecs), pl["tm"], pl["stages"],
             int(pl["w_res"]), pl["blocks"], _ints(sum(prods, ())),
             len(prods), ptr(keys), ptr(out), ptr(amax), stream_of(g2))
    return out, amax


def _check_cotangent(g2, dout, amax, k, c_last, vecs, mus, above: int):
    m = g2.shape[0]
    if m % k:
        raise ValueError(f"{m} rows are not whole groups of k={k}")
    check(dout, "dout", torch.float32, (m // k, c_last))
    check(amax, "amax", torch.int32, (m // k, c_last))
    for j, (vec, mu) in enumerate(zip(vecs, mus)):
        if j >= above:
            if mu is None:
                raise ValueError(f"mu[{j}] is needed above level {above}")
            check(mu, f"mu[{j}]", torch.float32, (2, vec.shape[1]))


def _bwd_plan_for(kind, g2, k, widths, **kw) -> dict:
    props = torch.cuda.get_device_properties(g2.device)
    return bwd_plan(kind, g2.shape[0], k, g2.shape[1], tuple(widths),
                    _smem_limit(g2), sms=props.multi_processor_count, **kw)


def _empty(n: int, dtype, device):
    return torch.empty(n, dtype=dtype, device=device) if n else None


def rc_bwd_stats_cuda(g2, dout, amax, vecs, w_packed, bs, mus, *,
                      level: int, k: int):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    _check_stack(g2, w_packed, bs, vecs, 4, len(bs))
    _check_cotangent(g2, dout, amax, k, widths[-1], vecs, mus, level)
    g2 = _aligned16(g2)
    pl = _bwd_plan_for("bwd_stats", g2, k, widths, level=level)
    prods = pl["prods"]
    c = widths[level - 1]
    dev = g2.device
    partials = torch.empty((pl["blocks"], 2, _pad(c)), dtype=torch.float32,
                           device=dev)
    a_scr = _empty(pl["a_scratch"], torch.float32, dev)
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    RC_BWD_STATS(ptr(g2), m, c0, k, len(bs), level, _ints(widths),
                 _ptrs(w_packed), _ptrs(bs), _ptrs(vecs), _ptrs(mus),
                 ptr(dout), ptr(amax), pl["tm"], pl["stages"],
                 int(pl["a_smem"]), pl["blocks"], _ints(sum(prods, ())),
                 len(prods), ptr(a_scr), ptr(partials), ptr(sums),
                 stream_of(g2))
    return sums


def rc_bwd_final_cuda(g2, dout, amax, vecs, w_packed, bs, mus, *, k: int,
                      need_dg: bool = True):
    m, c0 = g2.shape
    widths = [b.shape[0] for b in bs]
    _check_stack(g2, w_packed, bs, vecs, 4, len(bs))
    _check_cotangent(g2, dout, amax, k, widths[-1], vecs, mus, 0)
    g2 = _aligned16(g2)
    pl = _bwd_plan_for("bwd_final", g2, k, widths, need_dg=need_dg)
    prods = pl["prods"]
    dev = g2.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    cins = [c0] + widths[:-1]
    dws = [f32(ci, co) for ci, co in zip(cins, widths)]
    dbs = [f32(c) for c in widths]
    dg = f32(m, c0) if need_dg else None
    # scratch, held until the launch is queued
    a_scr = _empty(pl["a_scratch"], torch.float32, dev)
    rows = _empty(pl["rows"], torch.bfloat16, dev)
    db_part, dw_part = f32(pl["db_part"]), f32(pl["dw_part"])
    RC_BWD_FINAL(ptr(g2), m, c0, k, len(bs), _ints(widths), _ptrs(w_packed),
                 _ptrs(bs), _ptrs(vecs), _ptrs(mus), ptr(dout), ptr(amax),
                 pl["tm"], pl["stages"], int(pl["a_smem"]),
                 DW_MODES.index(pl["dw"]) + 1, pl["blocks"], pl["dw_splits"],
                 _ints(sum(prods, ())), len(prods), ptr(a_scr), ptr(rows),
                 ptr(db_part), ptr(dw_part),
                 _ptrs(dbs), _ptrs(dws), ptr(dg), stream_of(g2))
    return dg, dws, dbs


# ----------------------------------------------------------- dispatch

def _kernel_args(g2, vecs, ws, bs, w_packed):
    """The kernels' operands: bf16 ``g2``, f32 vectors and biases, the
    weights packed (once per step by the caller, or here)."""
    if w_packed is None:
        w_packed = [pack_weight(w) for w in ws]
    return (g2.to(torch.bfloat16).contiguous(),
            [None if v is None else v.float().contiguous() for v in vecs],
            w_packed, [b.detach().float().contiguous() for b in bs])


def _f32_list(ts):
    return [None if t is None else t.float().contiguous() for t in ts]


def rc_stats(g2, vecs, ws, bs, *, upto: int, impl=None,
             operand_dtype=torch.bfloat16, w_packed=None):
    if use_kernel(g2, impl):
        _kernel_dtype(operand_dtype)
        g, v, wp, b = _kernel_args(g2, vecs, ws, bs, w_packed)
        return rc_stats_cuda(g, v, wp, b, upto=upto)
    return rc_stats_plain(g2, vecs, ws, bs, upto=upto,
                          operand_dtype=operand_dtype)


def rc_final(g2, vecs, ws, bs, *, k: int, impl=None,
             operand_dtype=torch.bfloat16, w_packed=None):
    if use_kernel(g2, impl):
        _kernel_dtype(operand_dtype)
        return rc_final_cuda(*_kernel_args(g2, vecs, ws, bs, w_packed), k=k)
    return rc_final_plain(g2, vecs, ws, bs, k=k, operand_dtype=operand_dtype)


def rc_bwd_stats(g2, dout, amax, vecs, ws, bs, mus, *, level: int, k: int,
                 impl=None, operand_dtype=torch.bfloat16, w_packed=None):
    if use_kernel(g2, impl):
        _kernel_dtype(operand_dtype)
        g, v, wp, b = _kernel_args(g2, vecs, ws, bs, w_packed)
        return rc_bwd_stats_cuda(g, dout.float().contiguous(),
                                 amax.int().contiguous(), v, wp, b,
                                 _f32_list(mus), level=level, k=k)
    return rc_bwd_stats_plain(g2, dout, amax, vecs, ws, bs, mus, level=level,
                              k=k, operand_dtype=operand_dtype)


def rc_bwd_final(g2, dout, amax, vecs, ws, bs, mus, *, k: int, impl=None,
                 operand_dtype=torch.bfloat16, w_packed=None,
                 need_dg: bool = True):
    if use_kernel(g2, impl):
        _kernel_dtype(operand_dtype)
        g, v, wp, b = _kernel_args(g2, vecs, ws, bs, w_packed)
        return rc_bwd_final_cuda(g, dout.float().contiguous(),
                                 amax.int().contiguous(), v, wp, b,
                                 _f32_list(mus), k=k, need_dg=need_dg)
    return rc_bwd_final_plain(g2, dout, amax, vecs, ws, bs, mus, k=k,
                              operand_dtype=operand_dtype, need_dg=need_dg)
