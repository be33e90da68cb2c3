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
so repeated runs on the card give the same bits. ``linear_stats`` and
both parts of ``bwd_layer`` run on the ``mma.sync`` core
(``csrc/samlp_mma.cuh``); their plans here pick the tiles: for
``linear_stats`` persistent blocks that hold their column tile of W in
shared memory and walk row tiles of x through a ``cp.async`` ring
(``linear_stats_plan``). ``finalize_max`` and ``bwd_seed`` are streaming
passes of 16-byte loads and stores (``finalize_plan``, ``seed_plan``);
``bwd_seed`` reads ``a`` only at each column's argmax row.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from papc_tpu_torch._build import Kernel, ptr, stream_of
from papc_tpu_torch.ops.kernels import check, use_kernel

P, I = ctypes.c_void_p, ctypes.c_int
LINEAR_STATS = Kernel(
    "papc_samlp_linear_stats",
    [P, I, I, P, P, P, I, I, I, I, I, I, I, I, P, P, P, P],
)
FINALIZE_MAX = Kernel("papc_samlp_finalize_max",
                      [P, I, I, I, P, I, I, I, I, I, P, P, P])
BWD_SEED = Kernel("papc_samlp_bwd_seed",
                  [P, I, I, I, P, P, P, I, I, I, I, P, P, P, P])
BWD_LAYER = Kernel(
    "papc_samlp_bwd_layer",
    [P, P, P, I, I, I, I, P, I, I, P, P, P, I, I, I, I, I, I, I, I,
     P, P, P, P, P, P, P, P, P, P],
)
KERNELS = (LINEAR_STATS, FINALIZE_MAX, BWD_SEED, BWD_LAYER)

_SKEW = 8  # bf16 elements of padding per shared-memory row (bank spread)
_WARPS = 8
_SMS = 132  # the H100's SMs
_SMEM_OPTIN = 232448  # shared memory a block may opt into
_SMEM_SM = 233472  # shared memory of an SM (1 KB of it reserved a block)
# linear_stats blocks an SM's registers hold, by product warps
_LS_RESIDENT = {8: 1, 4: 2, 2: 3}
# The dW product of bwd_layer (csrc/samlp_bwd_layer.cu::dw_kernel)
_DW_GRID = 2 * _SMS  # blocks it aims for
_DW_STAGES = 3  # cp.async ring stages (the da + dh pass's W ring too)
_DW_MAX_WARPS = 16
_DW_STAGE_BYTES = 32 * 1024  # a ring stage at most, where rows allow
# The da + dh pass of bwd_layer (csrc/samlp_bwd_layer.cu::da_dh_kernel)
_DH_THREADS = _WARPS * 32
_DH_SLICE = 32  # W's Cout columns a ring stage holds
_ROWS_ALIGN = 256  # m_pad: a multiple of every row tile and dW chunk
# finalize_max and bwd_seed (csrc/samlp_finalize_seed.cu)
_PASS_THREADS = 256  # threads of a block
_FILL = 131072  # finalize_max threads a call aims for (half the SMs' room)
_SEED_SPAN = 32768  # dy elements a bwd_seed block writes at most (64 KB)
_SEED_CELLS = 4096  # (group, channel) cells of a bwd_seed block (48 KB)


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


def _ls_smem(cin: int, rw: int, cw: int, wp: int, stages: int) -> int:
    """Shared memory of the linear_stats block, as ``LsShape::smem``
    reckons it: W's slice ``[cin_p][TN + 8]``; ``stages`` ring stages,
    each the row tile ``[TM][cin_p + 8]`` where x's rows start on 16 bytes
    (Cin a multiple of 8), else one span of TM rows and 8 spare elements,
    and then h ``[TM][cin_p + 8]`` laid out from it; a's two buffers
    ``[TM][TN + 8]``; and f32 the bias ``[TN]`` and the scale and shift
    ``[cin_p]``."""
    cin_p = _pad(cin)
    tm, tn = 32 * rw, 16 * wp * cw
    aligned = cin % 8 == 0
    stage = tm * (cin_p + _SKEW) if aligned else _pad(tm * cin, 8) + 8
    h = 0 if aligned else tm * (cin_p + _SKEW)
    return (2 * (cin_p * (tn + _SKEW) + stages * stage + h
                 + 2 * tm * (tn + _SKEW))
            + 4 * (tn + 2 * cin_p))


@functools.lru_cache(maxsize=None)
def linear_stats_plan(m: int, cin: int, cout: int) -> dict:
    """The linear_stats block: ``rw x cw`` product warps (8, 4 or 2) and
    two store warps; warp tiles of 32 rows x ``16 wp`` columns, so row
    tiles of ``TM = 32 rw`` and column tiles of ``TN = 16 wp cw``. Each
    block holds its column tile's slice of W in shared memory and walks
    its row tiles through a ring of ``stages`` tiles. ``resident``: the
    blocks an SM holds, by shared memory and by registers (a thread of the
    widest warp tiles takes about 160: one block of 8 product warps, two
    of 4, three of 2). Of the layouts whose shared memory fits
    (``_ls_smem``) and that leave no column warp without a column, as the
    card measured: the most (column tile, row tile) units up to one a SM
    (SA3's 4096 rows split Cout), then the fewest column tiles (x read
    once), then the most product warps on an SM (up to 8), the widest
    warp tiles, the most blocks on an SM, the deeper ring, the most rows.
    ``blocks``: ``resident`` a SM where the units allow, spread over the
    column tiles in turn (block b takes column tile ``b % col_tiles``);
    the partials have one row per block of the most loaded column tile.
    Cached: a step asks for the same shapes every time (not to be
    changed by the caller)."""
    cin_p, cout_p = _pad(cin), _pad(cout)
    best = None
    for warps in (8, 4, 2):
        for cw in (1, 2, 4, 8):
            rw = warps // cw
            if rw < 1:
                continue
            for wp in (4, 2, 1):
                wcols = 16 * wp
                if wcols > cout_p or (cw - 1) * wcols >= cout_p:
                    continue  # a warp, or a column warp, past Cout
                tm, tn = 32 * rw, cw * wcols
                col_tiles = -(-cout_p // tn)
                units = col_tiles * -(-m // tm)
                for stages in (3, 2):
                    smem = _ls_smem(cin, rw, cw, wp, stages)
                    if smem > _SMEM_OPTIN:
                        continue
                    resident = min(_LS_RESIDENT[warps],
                                   _SMEM_SM // (smem + 1024))
                    key = (min(units, _SMS), -col_tiles,
                           min(warps * resident, 8), wp, resident, stages, tm)
                    if best is None or key > best[0]:
                        blocks = max(col_tiles, min(units, _SMS * resident))
                        best = (key, {
                            "rw": rw, "cw": cw, "wp": wp, "stages": stages,
                            "tm": tm, "tn": tn, "col_tiles": col_tiles,
                            "blocks": blocks, "resident": resident,
                            "groups": -(-blocks // col_tiles), "smem": smem})
    if best is None:
        raise ValueError(f"no linear_stats tile fits cin={cin}, cout={cout}")
    return {"cin_p": cin_p, "cout_p": cout_p, **best[1]}


def _dw_smem(cin: int, wm: int, wn: int, wk: int, rows: int) -> tuple:
    """Bytes of one ring stage and of the dW block's shared memory, as
    ``DwShape::smem`` reckons them: for a Cin whose rows start on 16
    bytes (a multiple of 8), stages of ``[rows][tm + 8]`` a_prev rows
    read where they land, else stages of a whole-row span and
    ``h [rows][tm + 8]`` copied from it; each stage with
    ``da [rows][tn + 8]``. The wk warps' sums reuse all of it."""
    tm, tn = 32 * wm, 64 * wn
    aligned = cin % 8 == 0
    a = _pad(rows * (tm + _SKEW), 8) if aligned else _pad(rows * cin, 8) + 8
    stage = 2 * (a + rows * (tn + _SKEW))
    main = (0 if aligned else 2 * rows * (tm + _SKEW)) + _DW_STAGES * stage
    return stage, max(main, 4 * (wk - 1) * wm * wn * 32 * 64)


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def finalize_plan(m: int, c: int, k: int) -> dict:
    """The finalize_max grid: a thread takes a chunk of ``v`` channels
    (``_vec_cols``: one 16-byte load a row where C % 8 == 0) of one group
    and walks ``rows`` rows of it; ``lanes`` threads (up to 16, a power of
    two) take neighbouring chunks of a row, ``slices`` threads the row
    ranges of one group, ``groups`` groups a block of 256 threads. The
    slices double while the call has fewer than ``_FILL`` threads (SA3's 32
    groups), as long as each slice keeps at least 4 rows (loads in
    flight) and none is empty. ``blocks``: the block groups times the
    ``ranges`` of ``lanes`` chunks that cover a row. Cached."""
    groups = m // k
    v = _vec_cols(c)
    chunks = c // v
    lanes = min(16, _pow2_ceil(chunks))
    ranges = -(-chunks // lanes)
    slices = 1
    while (groups * ranges * lanes * slices < _FILL
           and 2 * slices * lanes <= _PASS_THREADS and k >= 8 * slices
           and (2 * slices - 1) * -(-k // (2 * slices)) < k):
        slices *= 2
    per_block = _PASS_THREADS // (lanes * slices)
    return {"v": v, "lanes": lanes, "ranges": ranges, "slices": slices,
            "rows": -(-k // slices), "groups": per_block,
            "blocks": -(-groups // per_block) * ranges}


@functools.lru_cache(maxsize=None)
def seed_plan(m: int, c: int, k: int) -> dict:
    """The bwd_seed grid: a block writes one contiguous span of dy, the
    ``rows`` rows of each of ``tile`` groups (``rows`` < k only with one
    group a block), with stores of ``v`` channels (``_vec_cols``). The
    span holds at most ``_SEED_SPAN`` elements and the tile at most
    ``_SEED_CELLS`` (group, channel) cells; then tiles and rows are
    halved while the call has fewer than two blocks an SM (SA3's 32
    groups of 128 x 1024 split into 16 ranges of 8 rows), down to 8 rows.
    ``tiles``: the rows of the f32 partials, one a tile, written by its
    block that holds the groups' first rows; ``smem``: the block's key, v
    and v * xhat, 12 bytes a cell. Cached."""
    if k >= 0xFFFF:
        raise ValueError(f"bwd_seed takes k below 65535, got {k}")
    groups = m // k
    if k * c <= _SEED_SPAN:
        tile = min(groups, _SEED_SPAN // (k * c), max(1, _SEED_CELLS // c))
        rows = k
    else:
        tile, rows = 1, _SEED_SPAN // c if c <= _SEED_SPAN else 1

    def blocks(tile, rows):
        return -(-groups // tile) * -(-k // rows)

    while blocks(tile, rows) < 2 * _SMS:
        if tile > 1:
            tile = -(-tile // 2)
        elif rows > 8:
            rows = -(-rows // 2)
        else:
            break
    smem = 12 * tile * c
    if smem > _SMEM_OPTIN:
        raise ValueError(f"bwd_seed needs {smem} B of shared memory for "
                         f"c={c}; a block may take {_SMEM_OPTIN}")
    return {"v": _vec_cols(c), "tile": tile, "rows": rows,
            "tiles": -(-groups // tile), "splits": -(-k // rows),
            "blocks": blocks(tile, rows), "smem": smem}


def _split_evenly(n: int, most: int) -> int:
    """The least per-part count that cuts ``n`` into as few parts of at
    most ``most`` as possible."""
    return -(-n // -(-n // most))


def _dw_tile(m: int, cin: int, cout_p: int) -> dict:
    """The dW block: ``wm x wn`` warp tiles of 32 x 64, ``wk`` warps
    sharing each warp tile so that a block has 8 warps where its tile is
    small (each at least one k16 step of a chunk), and ``rows`` a chunk
    (the most of 128, 64, 32 whose ring stage holds at most 32 KB, or
    64 KB for a block of more than 8 warps, where one does).

    Where a_prev's rows start on 16 bytes (Cin a multiple of 8) a block
    copies only its own channels: it takes every Cin channel it can
    within 16 warp tiles (a_prev read once from device memory), then as
    much of Cout as fits. Else every block copies whole rows and lays out
    only its own channels: it takes every Cout column it can within 16
    warp tiles, then as many Cin channels as fit, cut evenly, so each
    row is laid out about once. A tile is halved along its longer side
    while the grid could not reach one block per SM."""
    wm_all, wn_all = -(-cin // 32), -(-cout_p // 64)
    operand = 2 * m * cin + 2 * _pad(m, _ROWS_ALIGN) * cout_p
    max_splits = max(1, operand // (4 * _pad(cin) * cout_p))
    if cin % 8 == 0:
        wm = min(wm_all, _DW_MAX_WARPS)
        wn = min(wn_all, _DW_MAX_WARPS // wm)
    else:
        wn = _split_evenly(wn_all, 4)
        wm = _split_evenly(wm_all, _DW_MAX_WARPS // wn)
    while True:
        fits = []
        # more than 8 warps (about 120 registers a thread) hold an SM alone:
        # such a block takes stages twice as large
        cap = _DW_STAGE_BYTES * (2 if wm * wn > 8 else 1)
        for rows in (128, 64, 32):
            wk = min(max(1, 8 // (wm * wn)), rows // 16)
            stage, smem = _dw_smem(cin, wm, wn, wk, rows)
            if smem <= _SMEM_OPTIN:
                fits.append((stage > cap, -rows, wk, smem))
        if not fits:
            raise ValueError(f"no dW tile fits cin={cin}, cout_p={cout_p}")
        _, rows, wk, smem = min(fits)
        rows = -rows
        tiles = -(-wm_all // wm) * -(-wn_all // wn)
        most = tiles * min(max_splits, -(-m // rows))
        if most >= _SMS or wm * wn == 1:
            break
        if wm >= wn:
            wm = -(-wm // 2)
        else:
            wn = -(-wn // 2)
    return {"dw_wm": wm, "dw_wn": wn, "dw_wk": wk, "dw_rows": rows,
            "dw_smem": smem, "dw_tiles": tiles,
            "dw_max_splits": max_splits}


def _vec_cols(cout: int) -> int:
    """Cout columns a thread of the da phase loads at once: 8 (16 bytes)
    where Cout's rows start on 16 bytes, 4 where on 8 (width 196), else 1
    (no layer of the models)."""
    return 8 if cout % 8 == 0 else 4 if cout % 4 == 0 else 1


def _da_dh_smem(rw: int, cin: int, cout: int, *, gate: bool,
                tiles_per_split: int) -> int:
    """Shared memory of the da + dh block with ``rw`` row warps, as
    ``DaDhShape::smem`` reckons it: the bf16 da tile ``[32 rw][cout_p +
    8]``; a ring of ``_DW_STAGES`` of W's 32-column k-slices ``[min(TN,
    cin_p)][32 + 8]`` (TN = 64 x 8 / rw Cin columns); f32 scratch: db's
    per-phase column sums (the threads that share a column group take
    every ``phases``-th row), later each warp's epilogue stage of 8 rows
    x 32 columns (stride 40), which ends holding its two column sums; and
    on a later layer (``gate``) a_prev's rows at the block's Cin columns,
    ``[32 rw][cols + 8]`` bf16."""
    cin_p, cout_p, v = _pad(cin), _pad(cout), _vec_cols(cout)
    tm, tn = 32 * rw, 64 * (_WARPS // rw)
    tiles = min(tiles_per_split, -(-cin_p // tn))
    groups = cout_p // v
    phases = 1 if groups >= _DH_THREADS else _DH_THREADS // groups
    red = max(phases * cout_p, _WARPS * 8 * 40)
    ld_ap = min(tiles * tn, cin_p) + _SKEW if gate else 0
    return 2 * (tm * (cout_p + _SKEW) + _DW_STAGES * min(tn, cin_p)
                * (_DH_SLICE + _SKEW) + tm * ld_ap) + 4 * red


def _da_dh_tile(m_pad: int, cin: int, cout: int, *, product: bool,
                gate: bool) -> dict:
    """The da + dh block: ``rw`` row warps (TM = 32 rw rows) by ``8 / rw``
    column warps (TN = 64 x 8 / rw Cin columns a Cin tile), and the Cin
    tiles a block takes. Where the row tiles alone leave SMs idle (SA3's
    4096 rows), the Cin tiles are split over blocks that each compute the
    tile's da again. Of the layouts whose shared memory fits, the one
    with the most blocks (up to one an SM), then at least 64 rows, then
    the most blocks resident on an SM (up to 2), then the fewest idle Cin
    columns, then the fewest Cin tiles a block, then the most rows: a
    block's fixed costs (its loads' round trips, W's slices in turn)
    outweigh the rest, as the card measured. A first layer (no gate)
    takes the same layout with or without the product (``product``
    False: Cin not split), so that da and db keep their sum order."""
    cin_p = _pad(cin)
    best = None
    for rw in (8, 4, 2, 1):
        tm, tn = 32 * rw, 64 * (_WARPS // rw)
        tiles, n_tiles = m_pad // tm, -(-cin_p // tn)
        splits = min(n_tiles, -(-_SMS // tiles))
        per = -(-n_tiles // splits)
        splits = -(-n_tiles // per)
        smem = _da_dh_smem(rw, cin, cout, gate=gate, tiles_per_split=per)
        if smem > _SMEM_OPTIN:
            continue
        resident = min(2, _SMEM_SM // (smem + 1024))
        key = (min(tiles * splits, _SMS), tm >= 64, resident,
               cin_p / (n_tiles * tn), -per, tm)
        if best is None or key > best[0]:
            best = (key, {"dh_rw": rw, "dh_tm": tm, "dh_tn": tn,
                          "dh_tiles": tiles, "dh_n_tiles": n_tiles,
                          "dh_tiles_per_split": per,
                          "dh_splits": splits if product else 1,
                          "dh_smem": smem, "dh_v": _vec_cols(cout)})
    if best is None:
        raise ValueError(f"no da + dh tile fits cin={cin}, cout={cout}")
    return best[1]


def bwd_layer_plan(m: int, cin: int, cout: int, *, need_dprev: bool = True,
                   first: bool = False) -> dict:
    """Grids and scratch of the bwd_layer kernels for a later layer (dy'
    through the gate) or, ``first``, the first layer of a stack (dg, or
    nothing with ``need_dprev`` False): the da + dh pass
    (``_da_dh_tile``: row tiles of ``dh_tm`` rows times ``dh_splits``
    runs of Cin tiles, ``dh_splits`` 1 without the ``da·Wᵀ`` product, f32
    partials ``[dh_tiles, cout_p]`` of db and ``[dh_tiles, 2, cin_p]`` of
    the sums) and the ``dW`` product (``_dw_tile``'s block tiles times
    ``splits`` row ranges of ``rows_per_split``, a multiple of the chunk
    rows, about ``_DW_GRID`` blocks in all and f32 partials ``[splits,
    cin_p, cout_p]`` of at most the operands' bytes)."""
    cin_p, cout_p = _pad(cin), _pad(cout)
    m_pad = _pad(m, _ROWS_ALIGN)
    dw = _dw_tile(m, cin, cout_p)
    want = min(dw["dw_max_splits"], -(-_DW_GRID // dw["dw_tiles"]),
               -(-m // dw["dw_rows"]))
    rows_per_split = _pad(-(-m // want), dw["dw_rows"])
    dh = _da_dh_tile(m_pad, cin, cout, product=need_dprev or not first,
                     gate=not first)
    return {"cin_p": cin_p, "cout_p": cout_p, "m_pad": m_pad, **dh, **dw,
            "rows_per_split": rows_per_split,
            "splits": -(-m // rows_per_split)}


# ------------------------------------------------------ kernel wrappers

def _smem_limit(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).shared_memory_per_block_optin


def linear_stats_cuda(x, vec, w_packed, b, cout: int):
    m, cin = x.shape
    plan = linear_stats_plan(m, cin, cout)
    check(x, "x", torch.bfloat16, (m, cin))
    x = _aligned16(x)
    check(w_packed, "w_packed", torch.bfloat16, (plan["cin_p"], plan["cout_p"]))
    check(b, "b", torch.float32, (cout,))
    if vec is not None:
        check(vec, "vec", torch.float32, (None, cin))
    if plan["smem"] > _smem_limit(x):
        raise ValueError(f"linear_stats needs {plan['smem']} B of shared "
                         f"memory for cin={cin}; the card allows "
                         f"{_smem_limit(x)}")
    a = torch.empty((m, cout), dtype=torch.bfloat16, device=x.device)
    partials = torch.empty((plan["groups"], 2, plan["cout_p"]),
                           dtype=torch.float32, device=x.device)
    sums = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    LINEAR_STATS(ptr(x), m, cin, ptr(vec), ptr(w_packed), ptr(b), cout,
                 plan["cin_p"], plan["cout_p"], plan["rw"], plan["cw"],
                 plan["wp"], plan["stages"], plan["blocks"], ptr(a),
                 ptr(partials), ptr(sums), stream_of(x))
    return a, sums


def _whole_groups(m: int, k: int) -> None:
    if m % k:
        raise ValueError(f"{m} rows are not whole groups of k={k}")


def finalize_max_cuda(a, vec, *, k: int):
    m, c = a.shape
    check(a, "a", torch.bfloat16, (m, c))
    check(vec, "vec", torch.float32, (None, c))
    _whole_groups(m, k)
    plan = finalize_plan(m, c, k)
    a = _aligned16(a)
    out = torch.empty((m // k, c), dtype=torch.float32, device=a.device)
    amax = torch.empty((m // k, c), dtype=torch.int32, device=a.device)
    FINALIZE_MAX(ptr(a), m, c, k, ptr(vec), plan["v"], plan["lanes"],
                 plan["slices"], plan["rows"], plan["blocks"], ptr(out),
                 ptr(amax), stream_of(a))
    return out, amax


def bwd_seed_cuda(a, vec, dout, amax, *, k: int):
    m, c = a.shape
    check(a, "a", torch.bfloat16, (m, c))
    check(vec, "vec", torch.float32, (4, c))
    _whole_groups(m, k)
    check(dout, "dout", torch.float32, (m // k, c))
    check(amax, "amax", torch.int32, (m // k, c))
    plan = seed_plan(m, c, k)
    dout, amax = _aligned16(dout), _aligned16(amax)
    dy = torch.empty((m, c), dtype=torch.bfloat16, device=a.device)
    partials = torch.empty((plan["tiles"], 2, c), dtype=torch.float32,
                           device=a.device)
    s = torch.empty((2, c), dtype=torch.float32, device=a.device)
    BWD_SEED(ptr(a), m, c, k, ptr(vec), ptr(dout), ptr(amax), plan["v"],
             plan["tile"], plan["rows"], plan["blocks"], ptr(dy),
             ptr(partials), ptr(s), stream_of(a))
    return dy, s


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data does not start on 16 bytes (the
    kernels read its rows 16 bytes at a time)."""
    return t.clone() if t.data_ptr() % 16 else t


def bwd_layer_cuda(dy, a, a_prev, w_packed, vec, s_in, vec_prev, *,
                   need_dprev: bool = True):
    m, cout = dy.shape
    cin = a_prev.shape[1]
    plan = bwd_layer_plan(m, cin, cout, need_dprev=need_dprev,
                          first=vec_prev is None)
    check(dy, "dy", torch.bfloat16, (m, cout))
    check(a, "a", torch.bfloat16, (m, cout))
    check(a_prev, "a_prev", torch.bfloat16, (m, cin))
    dy, a, a_prev = _aligned16(dy), _aligned16(a), _aligned16(a_prev)
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
    db_part = f32(plan["dh_tiles"], plan["cout_p"])
    dw_part = f32(plan["splits"], plan["cin_p"], plan["cout_p"])
    dw, db = f32(cin, cout), f32(cout)
    dy_prev = dg = s_prev = s_part = None
    if need_dprev and vec_prev is not None:
        dy_prev = torch.empty((m, cin), dtype=torch.bfloat16, device=dev)
        s_prev = f32(2, cin)
        s_part = f32(plan["dh_tiles"], 2, plan["cin_p"])
    elif need_dprev:
        dg = f32(m, cin)
    BWD_LAYER(ptr(dy), ptr(a), ptr(a_prev), m, plan["m_pad"], cin, cout,
              ptr(w_packed), plan["cin_p"], plan["cout_p"], ptr(vec),
              ptr(s_in), ptr(vec_prev), plan["dh_rw"],
              plan["dh_tiles_per_split"], plan["dw_wm"], plan["dw_wn"],
              plan["dw_wk"], plan["dw_rows"], plan["splits"],
              plan["rows_per_split"], ptr(da), ptr(db_part), ptr(dw_part),
              ptr(s_part), ptr(dw), ptr(db), ptr(dy_prev), ptr(dg),
              ptr(s_prev), stream_of(dy))
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
