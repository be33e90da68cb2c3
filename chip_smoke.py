#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the serving and training paths of ``papc_tpu_torch``'s PointNet++
models at the width the JAX package's bench and CLI use (B=32 clouds x
1024 points, 16 classes, 50 parts, seeded weights): SSG classification,
MSG classification, and MSG and SSG part segmentation; and the
PointPillars detection serving path (the KITTI car config at full
width: B=2 frames of up to 25000 points, 12000 pillars, a 496 x 432 BEV
grid, 107136 anchors, K=1000 before NMS) on the card, in twelve phases;
any failure raises and exits non-zero. TF32 is off for cuDNN
convolutions and matmuls throughout (float32 references).

1. Device: needs CUDA (there is no CPU mode), prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles the kernels from ``papc_tpu_torch/csrc`` with nvcc,
   one process per source.
3. Serving kernels at the SSG shapes: each kernel against its plain
   PyTorch version on the same inputs (FPS, ball query and gather
   exactly, the eval SA-MLP within 1e-2 abs and rel: both round every
   activation to bf16 and sum exact f32 products in another order), and
   both times from CUDA events, median of 20 after warm-up.
4. Training kernels at the SSG shapes, pass by pass on identical inputs
   (each pass fed the plain chain's previous outputs): ``finalize_max``
   (max and argmax) and ``bwd_seed``'s dy exactly; stored bf16
   activations within one bf16 ulp plus 1e-4 of the largest (a sum in
   another order moves a value that cancels to near 0 by many of its own
   ulps; ``bwd_layer``'s dy' plus 1e-3, for a ``da`` that rounds to the
   other bf16 neighbour); f32
   sums, dW, db and dg within 1e-3 of their largest (sums over up to
   524288 rows in another order); the scatter-add within 1e-5 of its
   largest (f32 atomics). Times as in phase 3.
5. Serving slice: ``papc_tpu_torch.train.evaluate`` over synthetic
   batches with the kernels, its launch counts, and its logits against
   the same run with every op on its plain version (within
   ``LOGIT_RTOL``/``LOGIT_ATOL``, the argmax equal wherever the plain
   top-2 margin exceeds twice that); forward ms per batch for both.
6. Training slice: ``papc_tpu_torch.train.train`` for 10 steps on one
   repeated synthetic batch and a val pass, from seed-0 weights, with
   every launch count of the nine kernels read around it; the loss must
   be finite and fall. Then one step with the kernels against one step
   on the plain versions from the same weights and dropout masks, both
   held against a plain step with f32 operands (loss within
   ``LOSS_RTOL``; each gradient as ``GRAD_RATIO`` says), step ms (CUDA
   events, median) for both, the device's busy share over 5 kernel
   steps (``torch.profiler``) and peak device memory.
7. Detection kernels at the detection shapes (B=2, K=1000): the rotated
   and the matrix NMS sweep against their plain versions, on the
   score-sorted top 1000 boxes of the slice's first batch and on
   clustered random boxes, at IoU thresholds 0.1 and 0.5; keep masks
   must be equal (on a difference the deciding pair's plain IoU and its
   distance from the threshold are printed). The matrix sweep gets the
   standup IoU matrix of the same boxes. Times as in phase 3.
8. Detection slice: ``papc_tpu_torch.detect.train.evaluate`` over 8
   synthetic frames in 4 batches of 2, seed-0 weights written as a
   flax-keyed ``.npz`` and loaded through ``convert``; first with the
   kernels, then with every op on its plain version, for the default
   (rotated NMS) config and for ``use_rotate_nms=False``, each with the
   NMS launch counts zeroed before it and read after it. ``valid`` and
   ``label_preds`` must be equal, boxes and scores within ``DET_TOL``
   (abs + rel). Prints pillars and detections per frame, serving ms per
   batch with kernels and plain, the stage split, the device busy share
   and peak device memory.
9. New shapes: the row scatter-add (#5, the backward of
   ``index_points``) within 1e-5 of its largest against its plain
   version on MSG segmentation's four index sets a step (SA2's two
   ball-query branches with their padding runs, FP1's and FP0's 3-NN
   rows), on MSG classification's SA2 branches and on a set with indices
   outside the rows; the eval pass at MSG classification's SA3 (c0 =
   643, 64-row tiles) as in phase 3; the stream passes at K = 16, at
   K = 128 with width 196 and at c0 = 643 as in phase 4; with kernel,
   plain and ``index_add_`` ms.
10. MSG classification: phases 5 and 6 for ``pointnet2_msg`` clas, #5
   launched 3 times a step.
11. Part segmentation: phases 5 and 6 for ``pointnet2_msg`` seg (#5 4
   times a step) and ``pointnet2_ssg`` seg (#5 twice a step), per-point
   logits, the mean IoU logged.
12. The per-kernel JSON line (each kernel's launches on its path, error
   against plain, ms, plain ms, the bound from this run's inputs and,
   where one PyTorch call computes the same function, its ms), then the
   result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B, N, NUM_CLASSES = 32, 1024, 16
SA1 = dict(npoint=512, radius=0.2, nsample=32)
SA2 = dict(npoint=128, radius=0.4, nsample=64)
MLP_TOL = 1e-2  # eval SA-MLP, abs and rel (see the module docstring)
LOGIT_RTOL, LOGIT_ATOL = 1e-2, 1e-3  # as the CPU slice test against JAX
TRAIN_TOL = 1e-3  # training passes' f32 outputs, of the largest magnitude
ACT_TOL = 1e-4  # stored bf16 activations: one ulp plus this of the largest
# db = Σ da feeds a BN, so its true value is 0 and both versions hold the
# rounding of M terms: held against Σ|da| instead of its own largest.
DB_TOL = 1e-5
SCATTER_TOL = 1e-5
TRAIN_STEPS = 10
# Kernel step vs plain step (both bf16 operands and storage), per gradient
# tensor. bf16 storage ties values, and which tied row takes a max's
# gradient depends on sums taken in another order, so two correct bf16
# steps differ (the CPU test against JAX: 10-27 % relative L2, each
# 22-65 % from float64). The sharp check is against the plain step with
# f32 operands: the kernel step may be at most GRAD_RATIO times as far
# from it as the plain bf16 step is. GRAD_RTOL bounds the kernel-plain
# distance itself. Dense biases before a BN have a true gradient of 0:
# held within NOISE_TOL of their module's largest gradient. The loss:
# the same flips carry through three SA stages (LOSS_RTOL, as the
# reduced-model step in tests/test_torch_cuda.py).
GRAD_RATIO, GRAD_RTOL, NOISE_TOL, LOSS_RTOL = 1.5, 1.0, 0.1, 5e-3
REPS = 20
# The least time of a kernel's work (NVIDIA's H100 SXM data sheet):
# bytes moved over the memory rate, operations over the peak rate of
# their type.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # dense bf16 tensor cores
# f32 operations of one quad-by-quad clip in nms_rotate.cu: four
# halfplanes over 4-8 vertices (cross product 6, intersection 8), the
# shoelace and the IoU
CLIP_OPS = 200
DET_FRAMES, DET_B, DET_K = 8, 2, 1000
NMS_THRESHOLDS = (0.1, 0.5)
DET_TOL = 1e-5  # detections, kernels vs plain run, abs and rel
WORK: dict = {}  # kernel row name -> [bytes, seconds of operations]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, one per rep)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    check(torch.cuda.is_available(),
          "no CUDA device: the port's kernels have no CPU mode")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    # a float32 reference means full float32 (no TF32 anywhere)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {name} | devices {torch.cuda.device_count()}")
    return name, smi


def phase_build() -> None:
    from papc_tpu_torch import _build

    lib, seconds = _build.build()
    _build.library()
    ptxas = [line.strip() for line in
             (lib.parent / "nvcc.log").read_text().splitlines()
             if "registers" in line or "Compiling entry" in line]
    print(f"[2 build] nvcc {seconds:.1f} s -> {lib.relative_to(ROOT)}")
    for line in ptxas:
        print(f"    {line}")


def _kernel_row(name, source, replaces):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
            "library_ms": None}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _finish_bounds(rows) -> None:
    """bound_ms of each row: the larger of its timed calls' bytes over
    the memory rate and their operations at peak."""
    for row in rows:
        nbytes, op_s = WORK.get(row["name"], (0, 0.0))
        byte_s = nbytes / HBM_BYTES_PER_S
        row["bound_ms"] = max(byte_s, op_s) * 1e3
        row["bound_by"] = "bytes" if byte_s >= op_s else "operations"


def _bf16_ulp(t):
    t = t.double().abs()
    return torch.where(t == 0, torch.zeros_like(t),
                       torch.exp2(torch.floor(torch.log2(t)) - 7))


def _compare(row, stage, got, want, *, exact=False, rel=None, ulp=False,
             scale=None, fn_kernel=None, fn_plain=None, work=None,
             fn_library=None, record=True):
    """Hold a kernel's output against its plain version's: ``exact``;
    or within ``rel`` of the largest magnitude of ``want`` (of ``scale``
    when given; plus one bf16 ulp of each element with ``ulp``); else the
    eval MLP's ``MLP_TOL``. Times both functions when given, adds
    ``work`` (bytes, seconds of operations at peak) to the row's bound,
    and times ``fn_library``, one PyTorch call of the same function.
    ``record=False`` prints the times without adding them to the row
    (a call off the main path)."""
    err = (got.double() - want.double()).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if exact:
        check(torch.equal(got, want),
              f"{row['name']} {stage}: kernel differs from plain "
              f"(max abs err {max_err})")
    elif rel is not None or ulp:
        if scale is None:
            scale = float(want.double().abs().max())
        bound = (rel or 0.0) * scale
        if ulp:
            bound = bound + _bf16_ulp(want)
        check(bool((err <= bound).all()),
              f"{row['name']} {stage}: kernel outside tolerance of plain "
              f"(max abs err {max_err})")
    else:
        bound = MLP_TOL + MLP_TOL * want.double().abs()
        check(bool((err <= bound).all()),
              f"{row['name']} {stage}: kernel outside {MLP_TOL} of plain "
              f"(max abs err {max_err})")
    row["max_abs_err"] = max(row["max_abs_err"], max_err)
    if fn_kernel is None:
        print(f"    {row['name']:<18} {stage:<34} max_abs_err {max_err:.3e}")
        return
    ms, plain_ms = cuda_ms(fn_kernel), cuda_ms(fn_plain)
    if record:
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        w = WORK.setdefault(row["name"], [0, 0.0])
        w[0] += work[0]
        w[1] += work[1]
    library = ""
    if fn_library is not None:
        lib_ms = cuda_ms(fn_library)
        if record:
            row["library_ms"] = (row["library_ms"] or 0.0) + lib_ms
        library = f"  library {lib_ms:.4f} ms"
    bound_ms = max(work[0] / HBM_BYTES_PER_S, work[1]) * 1e3
    print(f"    {row['name']:<18} {stage:<34} max_abs_err {max_err:.3e}  "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms{library}  "
          f"bound {bound_ms:.4f} ms")


def phase_kernels(model, clouds):
    """Each kernel at the shapes one forward of the full model gives it."""
    from papc_tpu_torch.ops.geometry import index_points
    from papc_tpu_torch.ops.kernels import ball_query, fps, gather

    rows = {
        "fps": _kernel_row("fps", "papc_tpu_torch/csrc/fps.cu",
                           "papc_tpu/ops/pallas/fps.py:98"),
        "ball_query": _kernel_row("ball_query",
                                  "papc_tpu_torch/csrc/ball_query.cu",
                                  "papc_tpu/ops/pallas/ball_query.py:130"),
        "group_gather": _kernel_row("group_gather",
                                    "papc_tpu_torch/csrc/group_gather.cu",
                                    "papc_tpu/ops/pallas/gather_t.py:126"),
        "samlp_eval": _kernel_row("samlp_eval",
                                  "papc_tpu_torch/csrc/samlp_eval.cu",
                                  "papc_tpu/ops/pallas/samlp.py:289"),
    }
    print("[3 kernels] kernel vs plain at the SSG shapes (B=32, N=1024)")
    xyz, feats = clouds, None
    groups = []  # (stage, grouped, idx, source points, PointMLP, input is
    # data) for phase 4
    stages = [(model.SetAbstraction_0, SA1), (model.SetAbstraction_1, SA2)]
    for i, (sa, cfg) in enumerate(stages, start=1):
        npoint, radius, k = cfg["npoint"], cfg["radius"], cfg["nsample"]
        start = torch.zeros(B, dtype=torch.int32, device=xyz.device)
        tag = f"SA{i} {xyz.shape[1]}->{npoint}"
        picks = fps.farthest_point_sample(xyz, npoint, start)
        _compare(rows["fps"], tag, picks,
                 fps.farthest_point_sample(xyz, npoint, start, impl="plain"),
                 exact=True,
                 fn_kernel=lambda: fps.farthest_point_sample(
                     xyz, npoint, start),
                 fn_plain=lambda: fps.farthest_point_sample(
                     xyz, npoint, start, impl="plain"),
                 work=(_nbytes(xyz, start, picks),
                       B * npoint * xyz.shape[1] * 10 / F32_OPS_PER_S))
        new_xyz = index_points(xyz, picks).contiguous()
        tag = f"SA{i} S={npoint} K={k} r={radius}"
        idx = ball_query.query_ball_point(radius, k, xyz, new_xyz)
        _compare(rows["ball_query"], tag, idx,
                 ball_query.query_ball_point(radius, k, xyz, new_xyz,
                                             impl="plain"),
                 exact=True,
                 fn_kernel=lambda: ball_query.query_ball_point(
                     radius, k, xyz, new_xyz),
                 fn_plain=lambda: ball_query.query_ball_point(
                     radius, k, xyz, new_xyz, impl="plain"),
                 work=(_nbytes(xyz, new_xyz, idx),
                       _ball_scan(idx, xyz.shape[1]) * 9 / F32_OPS_PER_S))
        c = 3 + (0 if feats is None else feats.shape[-1])
        tag = f"SA{i} [{B},{npoint},{k},{c}]"
        grouped = gather.group_gather(xyz, feats, idx, new_xyz)
        _compare(rows["group_gather"], tag, grouped,
                 gather.group_gather(xyz, feats, idx, new_xyz, impl="plain"),
                 exact=True,
                 fn_kernel=lambda: gather.group_gather(
                     xyz, feats, idx, new_xyz),
                 fn_plain=lambda: gather.group_gather(
                     xyz, feats, idx, new_xyz, impl="plain"),
                 work=(_nbytes(xyz, feats, idx, new_xyz, grouped),
                       B * npoint * k * 3 / F32_OPS_PER_S))
        groups.append((f"SA{i}", grouped, idx, xyz.shape[1], sa.PointMLP_0,
                       i == 1))
        feats = _check_mlp(rows["samlp_eval"], f"SA{i}", sa.PointMLP_0,
                           grouped)
        xyz = new_xyz
    grouped = torch.cat([xyz, feats], dim=-1)[:, None]  # SA3: group_all
    _check_mlp(rows["samlp_eval"], "SA3", model.SetAbstraction_2.PointMLP_0,
               grouped)
    groups.append(("SA3", grouped, None, None,
                   model.SetAbstraction_2.PointMLP_0, False))
    return rows, groups


TRAIN_ROWS = [  # name, source, TPU kernel it replaces
    ("group_scatter_add", "group_scatter_add.cu", "gather_t.py:172"),
    ("samlp_linear_stats", "samlp_linear_stats.cu", "samlp.py:158"),
    ("samlp_finalize_max", "samlp_finalize_seed.cu", "samlp.py:236"),
    ("samlp_bwd_seed", "samlp_finalize_seed.cu", "samlp.py:366"),
    ("samlp_bwd_layer", "samlp_bwd_layer.cu", "samlp.py:492"),
]


def train_rows() -> dict:
    return {name: _kernel_row(name, f"papc_tpu_torch/csrc/{src}",
                              f"papc_tpu/ops/pallas/{tpu}")
            for name, src, tpu in TRAIN_ROWS}


def phase_train_kernels(groups, rows, record=True):
    """The training passes of every SA stage on its grouped tensor, each
    pass fed the plain chain's outputs so that kernel and plain see
    identical inputs; the grouping gather's scatter-add where the
    stage's input carries a gradient (SSG SA2; SA1's input is data).
    ``record=False``: times printed, not added to the rows."""
    from papc_tpu_torch.nn.layers import BN_EPS
    from papc_tpu_torch.ops.kernels import gather
    from papc_tpu_torch.ops.kernels import samlp_train as st

    gen = torch.Generator(device="cuda").manual_seed(0)
    for stage, grouped, idx, n_src, mlp, data_input in groups:
        b, s, k, c0 = grouped.shape
        m = b * s * k
        if idx is not None and not data_input:
            g = torch.randn(grouped.shape, generator=gen, device="cuda")
            got = gather.scatter_add(g, idx, n_src)
            flat = (idx.reshape(b, -1).long() + n_src * torch.arange(
                b, device="cuda")[:, None]).reshape(-1)
            g2d = g.reshape(-1, c0)
            _compare(rows["group_scatter_add"], f"{stage} {list(g.shape)}",
                     got, gather.scatter_add(g, idx, n_src, impl="plain"),
                     rel=SCATTER_TOL,
                     fn_kernel=lambda: gather.scatter_add(g, idx, n_src),
                     fn_plain=lambda: gather.scatter_add(g, idx, n_src,
                                                         impl="plain"),
                     work=(_nbytes(g, idx, got), g.numel() / F32_OPS_PER_S),
                     fn_library=lambda: torch.zeros(
                         b * n_src, c0, device="cuda").index_add_(0, flat,
                                                                   g2d),
                     record=record)
        g2 = grouped.reshape(m, c0).to(torch.bfloat16)
        layers = [(d.weight.t().contiguous(), d.bias.float(), bn.weight,
                   bn.bias) for d, bn in mlp.layers()]
        packed = [st.pack_weight(w) for w, *_ in layers]
        h, vec, a_list, vecs = g2, None, [], []
        for i, ((w, bias, gamma, beta), wp) in enumerate(zip(layers, packed)):
            tag = f"{stage} L{i} {m}x{w.shape[0]}->{w.shape[1]}"
            a, sums = st.linear_stats(h, vec, w, bias, w_packed=wp)
            pa, psums = st.linear_stats(h, vec, w, bias, impl="plain")
            row = rows["samlp_linear_stats"]
            _compare(row, tag + " a", a, pa, rel=ACT_TOL, ulp=True)
            cin, cout = w.shape
            _compare(row, tag + " sums", sums, psums, rel=TRAIN_TOL,
                     fn_kernel=lambda: st.linear_stats(h, vec, w, bias,
                                                       w_packed=wp),
                     fn_plain=lambda: st.linear_stats(h, vec, w, bias,
                                                      impl="plain"),
                     work=(_nbytes(h, vec, w, bias, a, sums),
                           2 * m * cin * cout / BF16_OPS_PER_S
                           + 3 * m * cout / F32_OPS_PER_S), record=record)
            vec4, _ = st.bn_vectors(psums, gamma, beta, m, BN_EPS)
            a_list.append(pa)
            vecs.append(vec4)
            h, vec = pa, vec4
        row, tag = rows["samlp_finalize_max"], f"{stage} {m}x{h.shape[1]} k={k}"
        out, amax = st.finalize_max(h, vec, k=k)
        pout, pamax = st.finalize_max(h, vec, k=k, impl="plain")
        _compare(row, tag + " amax", amax, pamax, exact=True)
        _compare(row, tag + " max", out, pout, exact=True,
                 fn_kernel=lambda: st.finalize_max(h, vec, k=k),
                 fn_plain=lambda: st.finalize_max(h, vec, k=k, impl="plain"),
                 work=(_nbytes(h, vec, out, amax),
                       4 * h.numel() / F32_OPS_PER_S), record=record)
        dout = torch.randn(pout.shape, generator=gen, device="cuda")
        row = rows["samlp_bwd_seed"]
        dy, sd = st.bwd_seed(h, vec, dout, pamax, k=k)
        pdy, psd = st.bwd_seed(h, vec, dout, pamax, k=k, impl="plain")
        _compare(row, tag + " dy", dy, pdy, exact=True)
        _compare(row, tag + " sums", sd, psd, rel=TRAIN_TOL,
                 fn_kernel=lambda: st.bwd_seed(h, vec, dout, pamax, k=k),
                 fn_plain=lambda: st.bwd_seed(h, vec, dout, pamax, k=k,
                                              impl="plain"),
                 work=(_nbytes(h, vec, dout, pamax, dy, sd),
                       8 * h.numel() / F32_OPS_PER_S), record=record)
        dy, sd = pdy, psd
        row = rows["samlp_bwd_layer"]
        for i in range(len(layers) - 1, -1, -1):
            w = layers[i][0]
            a_prev = a_list[i - 1] if i else g2
            vprev = vecs[i - 1] if i else None
            need = bool(i) or not data_input

            def run(impl, i=i, w=w, a_prev=a_prev, vprev=vprev, need=need,
                    dy=dy, sd=sd):
                return st.bwd_layer(dy, a_list[i], a_prev, w, vecs[i], sd,
                                    vprev, impl=impl, need_dprev=need,
                                    w_packed=None if impl else packed[i])

            got, want = run(None), run("plain")
            tag = f"{stage} L{i} {m}x{w.shape[0]}<-{w.shape[1]}"
            if need:
                _compare(row, tag + (" dy'" if i else " dg"), got[0], want[0],
                         rel=TRAIN_TOL, ulp=bool(i))
            if i:
                _compare(row, tag + " sums", got[3], want[3], rel=TRAIN_TOL)
            v = vecs[i]
            da = v[0] * (dy.float() - sd[0] / m
                         - (a_list[i].float() - v[2]) * v[3] * sd[1] / m)
            _compare(row, tag + " db", got[2], want[2], rel=DB_TOL,
                     scale=float(da.abs().sum(0).max()))
            del da
            cin, cout = w.shape
            products = (2 if need else 1) * 2 * m * cin * cout
            _compare(row, tag + " dW", got[1], want[1], rel=TRAIN_TOL,
                     fn_kernel=lambda: run(None), fn_plain=lambda: run("plain"),
                     work=(_nbytes(dy, a_list[i], a_prev, w, vecs[i], sd,
                                   vprev, *got),
                           products / BF16_OPS_PER_S
                           + 10 * m * cout / F32_OPS_PER_S), record=record)
            dy, sd = want[0], want[3]


def _ball_scan(idx, n) -> int:
    """Points the ball query scans in this run: up to its K-th neighbour
    where the ball is full (the last slot differs from the first), the
    whole cloud where it is not."""
    full = idx[..., -1] != idx[..., 0]
    return int(torch.where(full, idx[..., -1].long() + 1, n).sum())


def _check_mlp(row, stage, mlp, grouped, record=True):
    """One SA stage's MLP+max (``PointMLP`` with ``pool_max``: BN folded,
    then the samlp_eval wrapper) on its grouped input."""
    b, s, k, c0 = grouped.shape
    got = mlp(grouped)
    widths = "->".join(str(f) for f in mlp.features)
    m = b * s * k
    cins = (c0,) + tuple(mlp.features[:-1])
    ops = (sum(2 * m * ci * co for ci, co in zip(cins, mlp.features))
           / BF16_OPS_PER_S
           + sum(3 * m * co for co in mlp.features) / F32_OPS_PER_S)
    _compare(row, f"{stage} M={m} k={k} {c0}->{widths}", got,
             mlp(grouped, impl="plain"), exact=False,
             fn_kernel=lambda: mlp(grouped),
             fn_plain=lambda: mlp(grouped, impl="plain"),
             work=(_nbytes(grouped, got, *mlp.parameters()), ops),
             record=record)
    return got


def _counters(names) -> dict:
    """The launch counters of the named kernels."""
    from papc_tpu_torch.ops.kernels import (ball_query, fps, gather, samlp,
                                            samlp_train, scatter_rows)

    every = {"fps": fps.KERNEL, "ball_query": ball_query.KERNEL,
             "group_gather": gather.KERNEL, "samlp_eval": samlp.KERNEL,
             "group_scatter_add": gather.SCATTER_KERNEL,
             "scatter_rows_add": scatter_rows.KERNEL,
             "samlp_linear_stats": samlp_train.LINEAR_STATS,
             "samlp_finalize_max": samlp_train.FINALIZE_MAX,
             "samlp_bwd_seed": samlp_train.BWD_SEED,
             "samlp_bwd_layer": samlp_train.BWD_LAYER}
    return {n: every[n] for n in names}


SERVE_KERNELS = {  # (model, mode) -> kernels of its eval forward
    ("pointnet2_ssg", "clas"): ("fps", "ball_query", "group_gather",
                                "samlp_eval"),
    ("pointnet2_msg", "clas"): ("fps", "ball_query", "samlp_eval"),
    ("pointnet2_msg", "seg"): ("fps", "ball_query", "samlp_eval"),
    ("pointnet2_ssg", "seg"): ("fps", "ball_query", "group_gather",
                               "samlp_eval"),
}
STREAM = ("samlp_linear_stats", "samlp_finalize_max", "samlp_bwd_seed",
          "samlp_bwd_layer")
TRAIN_KERNELS = {  # (model, mode) -> kernels of train(): steps + val pass
    key: serve + (("group_scatter_add",) if "group_gather" in serve else ())
    + (("scatter_rows_add",) if key != ("pointnet2_ssg", "clas") else ())
    + STREAM
    for key, serve in SERVE_KERNELS.items()
}
# #5's launches a training step: MSG clas SA2's three branches; MSG seg
# SA2's two branches and the two 3-NN interpolations; SSG seg the two
# 3-NN interpolations
ROW_SCATTERS = {("pointnet2_ssg", "clas"): 0, ("pointnet2_msg", "clas"): 3,
                ("pointnet2_msg", "seg"): 4, ("pointnet2_ssg", "seg"): 2}


def _loader(n, mode, seed):
    from papc_tpu_torch.data import SyntheticLoader

    return SyntheticLoader(n, n_points=N, num_classes=NUM_CLASSES,
                           batchsize=B, seed=seed, with_pid=mode == "seg")


def _inputs(mode, points, labels):
    return (points, labels) if mode == "seg" else (points,)


def _seed_weights(name, mode) -> Path:
    """The seed-0 model written as flax variables (``.npz``), which
    ``evaluate`` loads through ``convert``."""
    from papc_tpu_torch.convert import state_dict_to_flax
    from papc_tpu_torch.models import init_model

    spec = init_model(name, mode, NUM_CLASSES, seed=0, device="cpu")
    weights = ROOT / "build" / "chip_smoke" / f"{name}_{mode}_seed0.npz"
    weights.parent.mkdir(parents=True, exist_ok=True)
    np.savez(weights, **state_dict_to_flax(spec.model.state_dict()))
    return weights


def phase_serving(tag, name, mode, smi, rows=None, n_clouds=100):
    """``evaluate`` over synthetic batches with the kernels, every
    kernel's launch count read around it, then the same run on the plain
    versions: logits within ``LOGIT_RTOL``/``LOGIT_ATOL``, the argmax
    equal wherever the plain top-2 margin exceeds twice that tolerance;
    forward ms per batch, kernels and plain. ``rows``: the kernel rows
    this path's counts go to."""
    from papc_tpu_torch.convert import load_flax_weights
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.train import evaluate

    weights = _seed_weights(name, mode)
    counters = _counters(SERVE_KERNELS[(name, mode)])
    loader = _loader(n_clouds, mode, seed=1)
    print(f"{tag} evaluate: {name} {mode}, {loader.num_samples} clouds in "
          f"{len(loader)} batches of {B} x {N}")

    def run(impl):
        return evaluate(name, mode, N, NUM_CLASSES, batchsize=B,
                        weights=weights, make_loader=lambda split: loader,
                        device="cuda", impl=impl,
                        log=lambda line: print(f"    {impl or 'kernels'}: "
                                               f"{line}"))

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    got = run(None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    print("    launches: " + ", ".join(f"{n} {v}" for n, v in launches.items())
          + f" ({seconds:.2f} s with the first call's set-up)")
    for n, count in launches.items():
        check(count > 0, f"{name} {mode} serving never launched the {n} "
              "kernel")
        if rows is not None and n in rows:
            rows[n]["launches"] = count
    want = run("plain")
    logits, ref = got["logits"], want["logits"]
    shape = (loader.num_samples,) + ((N, 50) if mode == "seg"
                                     else (NUM_CLASSES,))
    check(tuple(logits.shape) == shape,
          f"logits have shape {tuple(logits.shape)}, want {shape}")
    check(bool(torch.isfinite(logits).all()), "logits are not finite")
    err = float((logits - ref).abs().max())
    check(torch.allclose(logits, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
          f"kernel logits differ from plain by {err}")
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]
             > 2 * (LOGIT_ATOL + LOGIT_RTOL * top2[..., 0].abs()))
    same = logits.argmax(-1) == ref.argmax(-1)
    check(bool(same[clear].all()),
          "argmax differs from plain where the margin exceeds the tolerance")
    print(f"    logits {list(logits.shape)} finite, max abs err vs plain "
          f"{err:.3e} (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}), argmax "
          f"agreement {float(same.float().mean()):.4f} ({int(clear.sum())} "
          f"of {clear.numel()} with a clear margin, all equal), |logits| "
          f"max {float(ref.abs().max()):.3f}")

    model = load_flax_weights(init_model(name, mode, NUM_CLASSES,
                                         device="cuda").model, weights)
    batch = next(iter(loader()))
    args = _inputs(mode, torch.from_numpy(batch.points).cuda(),
                   torch.from_numpy(batch.label).cuda())
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(*args), reps=10)
        plain_ms = cuda_ms(lambda: model(*args, impl="plain"), reps=10)
    print(f"    forward per batch of {B} x {N}: kernels {fwd_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms ({smi})")


def _noise_grad(name: str, names) -> bool:
    """A Dense bias that feeds a BatchNorm: its true gradient is 0."""
    *path, leaf = name.split(".")
    if leaf != "bias" or not path[-1].startswith("Dense_"):
        return False
    bn = ".".join(path[:-1] + ["BatchNorm_" + path[-1].split("_")[1],
                               "weight"])
    return bn in names


def _dropout_masks(mode):
    """Keep masks of the head's dropout sites (clas: [B, 512], [B, 256];
    seg: [B, N, 128]), drawn once from a seeded generator."""
    gen = torch.Generator().manual_seed(4)
    shapes = [(B, N, 128)] if mode == "seg" else [(B, 512), (B, 256)]
    return [torch.rand(*shape, generator=gen) < 0.6 for shape in shapes]


def phase_training(tag, name, mode, smi, rows=None):
    """The training path through its entry point (``train``, 10 steps
    on one batch and a val pass, every launch count read around it,
    #5's equal to its launches a step times the steps), then one kernel
    step against one plain step and an f32-operand step, then step ms,
    the device's busy share and peak memory."""
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.ops import fused_mlp
    from papc_tpu_torch.train import make_optimizer, train, train_step

    counters = _counters(TRAIN_KERNELS[(name, mode)])
    batch = next(iter(_loader(B, mode, seed=2)()))
    val = _loader(2 * B, mode, seed=3)
    loaders = {"train": lambda: iter([batch] * TRAIN_STEPS), "val": val}
    print(f"{tag} train: {name} {mode} from seed-0 weights, {TRAIN_STEPS} "
          f"steps on one batch of {B} x {N}, then a val pass over "
          f"{val.num_samples} clouds")
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    _, history = train(name, mode, N, NUM_CLASSES, epoch_num=1,
                       batchsize=B, info_iter=3, save_iter=1,
                       model_dir=str(ROOT / "build" / "chip_smoke" / "model"),
                       seed=0, make_loader=loaders.__getitem__,
                       device="cuda", log=lambda line: print(f"    {line}"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    print("    launches: " + ", ".join(f"{n} {v}" for n, v in launches.items())
          + f" ({seconds:.2f} s with the first call's set-up)")
    for n, count in launches.items():
        check(count > 0, f"{name} {mode} training never launched the {n} "
              "kernel")
        if rows is not None and n in rows:
            rows[n]["launches"] = count
    if "scatter_rows_add" in launches:
        want = ROW_SCATTERS[(name, mode)] * TRAIN_STEPS
        check(launches["scatter_rows_add"] == want,
              f"scatter_rows_add launched {launches['scatter_rows_add']} "
              f"times in {TRAIN_STEPS} steps, want {want}")
    losses = history[0]["train_loss"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(losses[-1] < losses[0],
          f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    metric = "miou" if mode == "seg" else "accuracy"
    print(f"    loss step 1 {losses[0]:.6f} -> step {TRAIN_STEPS} "
          f"{losses[-1]:.6f}; val loss {history[0]['val_loss']:.6f}, "
          f"val {metric} {history[0]['val_metric']:.4f}")

    bdict = batch._asdict()
    dev = torch.device("cuda")

    def one_step(impl):
        model = init_model(name, mode, NUM_CLASSES, seed=0, device=dev).model
        masks = _dropout_masks(mode)
        opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
        loss, _ = train_step(model, opt, bdict, dev, impl=impl,
                             dropout_masks=masks)
        return float(loss), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}, model, \
            opt, masks

    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k, model, opt, masks = one_step(None)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss_p, grads_p, model_p, opt_p, _ = one_step("plain")
    with fused_mlp.override(operand_dtype=torch.float32):
        loss_f, grads_f, _, _, _ = one_step("plain")
    print(f"    one step from the same weights and masks: loss kernels "
          f"{loss_k:.6f}, plain {loss_p:.6f}, plain with f32 operands "
          f"{loss_f:.6f}")
    failures, rels, ratios, noise = [], {}, {}, {}
    for n, gk in grads_k.items():
        gp, gf = grads_p[n], grads_f[n]
        if not bool(torch.isfinite(gk).all()):
            failures.append(f"{n}: gradient not finite")
        if _noise_grad(n, grads_k):
            module = n.rsplit(".", 2)[0]
            scale = max(float(g.abs().max()) for m, g in grads_p.items()
                        if m.startswith(module + "."))
            noise[n] = float((gk - gp).abs().max()) / max(scale, 1e-30)
            continue
        rels[n] = float((gk - gp).norm() / gp.norm().clamp_min(1e-30))
        ratios[n] = float((gk - gf).norm()
                          / (gp - gf).norm().clamp_min(1e-30))
    for what, vals, limit in [("relative L2 kernels vs plain", rels,
                               GRAD_RTOL),
                              ("distance from the f32 step, kernels over "
                               "plain", ratios, GRAD_RATIO),
                              ("Dense biases before a BN, of their module's "
                               "largest gradient", noise, NOISE_TOL)]:
        worst = max(vals, key=vals.get)
        print(f"    {what}: median {statistics.median(vals.values()):.3e}, "
              f"worst {vals[worst]:.3e} ({worst}), limit {limit}")
        failures += [f"{n}: {what} {v:.3e} > {limit}"
                     for n, v in vals.items() if v > limit]
    if abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
        failures.append(f"kernel step loss {loss_k} vs plain {loss_p}")
    check(not failures, "; ".join(failures))

    def step_k():
        return train_step(model, opt, bdict, dev, dropout_masks=masks)

    step_ms = cuda_ms(step_k, reps=10)
    plain_ms = cuda_ms(lambda: train_step(model_p, opt_p, bdict, dev,
                                          impl="plain", dropout_masks=masks),
                       reps=3, warmup=1)
    busy_ms, wall_ms = _device_busy(step_k, top=12)
    busy = (f"{100 * busy_ms / wall_ms:.1f} % ({busy_ms:.3f} of "
            f"{wall_ms:.3f} ms)" if busy_ms > 0 else "not measured")
    print(f"    train step of {B} x {N}: kernels {step_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms (CUDA events, median); device busy over 5 "
          f"kernel steps (profiler) {busy}; peak device memory of the "
          f"first kernel step {peak_gb:.2f} GB ({smi})")


def _capture(model, store: dict):
    """Forward hooks that keep each SA, FP and PointMLP module's inputs
    and output in ``store`` under the module's name."""
    kinds = ("SetAbstraction", "SetAbstractionMsg", "FeaturePropagation",
             "PointMLP")
    return [mod.register_forward_hook(
        lambda m, args, out, name=name: store.__setitem__(name, (args, out)))
        for name, mod in model.named_modules()
        if type(mod).__name__ in kinds]


def phase_new_shapes(rows, t_rows):
    """The row scatter-add (#5) against its plain version on MSG
    segmentation's four index sets a step (SA2's two ball-query branches
    with their padding runs, the two 3-NN interpolations: the recorded
    row), MSG classification's SA2 branches and a set with indices
    outside the rows; the eval pass at MSG classification's SA3 (c0 =
    643, 64-row tiles); the stream passes at K = 16, at K = 128 with
    width 196 and at c0 = 643, pass by pass. Inputs are the seed-0
    models' own tensors, captured from one eval forward each."""
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.ops.grouping import knn, query_ball_point
    from papc_tpu_torch.ops.kernels import scatter_rows

    row = _kernel_row("scatter_rows_add",
                      "papc_tpu_torch/csrc/scatter_rows_add.cu",
                      "papc_tpu/ops/pallas/scatter.py:124")
    print("[9 new shapes] kernel vs plain at the MSG and segmentation "
          f"shapes (B={B}, N={N})")
    loader = _loader(B, "seg", seed=0)
    clouds = torch.from_numpy(loader.data).cuda()
    labels = torch.from_numpy(loader.label).cuda()
    got = {}
    models = {}
    for mode in ("clas", "seg"):
        model = init_model("pointnet2_msg", mode, NUM_CLASSES, seed=0,
                           device="cuda").model
        store = {}
        handles = _capture(model, store)
        with torch.inference_mode():
            model(*_inputs(mode, clouds, labels))
        for h in handles:
            h.remove()
        got[mode], models[mode] = store, model

    def ball_sets(mode, sa_name):
        (xyz, points, *_), (new_xyz, _) = got[mode][sa_name]
        sa = getattr(models[mode], sa_name)
        for j, (r, k) in enumerate(zip(sa.radius_list, sa.nsample_list)):
            idx = query_ball_point(r, k, xyz, new_xyz).reshape(B, -1)
            yield (f"MSG {mode} {sa_name[-5:]} branch {j} K={k}", idx,
                   xyz.shape[1], points.shape[-1] + 3)

    def knn_set(mode, fp_name):
        (xyz1, xyz2, _, points2, *_), _ = got[mode][fp_name]
        idx = knn(3, xyz2, xyz1)[1].reshape(B, -1)
        return (f"MSG {mode} {fp_name} 3-NN", idx, xyz2.shape[1],
                points2.shape[-1])

    fp0 = knn_set("seg", "FeaturePropagation_2")
    outside = fp0[1].clone()
    outside[:, ::8] = -1
    outside[:, 3::8] = fp0[2] + 5
    sets = ([(s, True) for s in ball_sets("seg", "SetAbstractionMsg_1")]
            + [(knn_set("seg", "FeaturePropagation_1"), True), (fp0, True)]
            + [(s, False) for s in ball_sets("clas", "SetAbstractionMsg_1")]
            + [(("out of range (FP0 rows, 1/4 outside)", outside, fp0[2],
                 fp0[3]), False)])
    gen = torch.Generator(device="cuda").manual_seed(5)
    for (tag, idx, n, c), record in sets:
        idx = idx.int().contiguous()
        g = torch.randn(B, idx.shape[1], c, generator=gen, device="cuda")
        out = scatter_rows.scatter_rows_add(g, idx, n)
        want = scatter_rows.scatter_rows_add(g, idx, n, impl="plain")
        library = None
        if bool(((idx >= 0) & (idx < n)).all()):
            flat = (idx.long() + n * torch.arange(B, device="cuda")[:, None]
                    ).reshape(-1)
            g2d = g.reshape(-1, c)

            def library():
                return torch.zeros(B * n, c, device="cuda").index_add_(
                    0, flat, g2d)
        _compare(row, f"{tag} [{B},{idx.shape[1]},{c}]->{n}", out, want,
                 rel=SCATTER_TOL,
                 fn_kernel=lambda: scatter_rows.scatter_rows_add(g, idx, n),
                 fn_plain=lambda: scatter_rows.scatter_rows_add(
                     g, idx, n, impl="plain"),
                 work=(_nbytes(g, idx, out), g.numel() / F32_OPS_PER_S),
                 fn_library=library, record=record)
    del g, out, want

    sa3 = got["clas"]["SetAbstraction_0.PointMLP_0"][0][0]
    check(sa3.shape[-1] == 643, f"MSG clas SA3 input {tuple(sa3.shape)}")
    with torch.inference_mode():
        _check_mlp(rows["samlp_eval"], "MSG clas SA3",
                   models["clas"].SetAbstraction_0.PointMLP_0, sa3,
                   record=False)

    def stage(tag, mode, name, data_input):
        mlp = models[mode].get_submodule(name)
        return tag, got[mode][name][0][0], None, None, mlp, data_input

    groups = [stage("MSG clas SA1 b0", "clas",
                    "SetAbstractionMsg_0.PointMLP_0", True),
              stage("MSG seg SA2 b1", "seg", "SetAbstractionMsg_1.PointMLP_1",
                    False),
              stage("MSG clas SA3", "clas", "SetAbstraction_0.PointMLP_0",
                    False)]
    check([g[1].shape[2] for g in groups] == [16, 128, 128]
          and groups[1][4].features == (128, 196, 256),
          "the new-shape stages are not K=16, K=128 width 196, c0=643")
    with torch.no_grad():
        phase_train_kernels(groups, t_rows, record=False)
    return row


def _detect_setup():
    """The car config at full width, its anchors, the seed-0 PointPillars
    written as a flax-keyed ``.npz`` and loaded back through ``convert``,
    and the synthetic frames."""
    from papc_tpu_torch.convert import load_flax_weights, state_dict_to_flax
    from papc_tpu_torch.data.synthetic_kitti import SyntheticFrames
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.config import car_config
    from papc_tpu_torch.nn.layers import init_params
    from papc_tpu_torch.detect.train import make_pillarizer

    cfg = car_config()
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    gen = builders.build_anchor_generator(
        cfg.TARGET_ASSIGNER.ANCHOR_GENERATORS[0])
    seeded = builders.build_network(cfg, vg, gen, coder)
    init_params(seeded, torch.Generator().manual_seed(0))
    weights = ROOT / "build" / "chip_smoke" / "pointpillars_seed0.npz"
    np.savez(weights, **state_dict_to_flax(seeded.state_dict()))
    model = load_flax_weights(builders.build_network(cfg, vg, gen, coder),
                              weights).cuda().eval()
    anchors = builders.build_anchors(cfg, vg)
    reader = cfg.EVAL_INPUT_READER
    frames = SyntheticFrames(DET_FRAMES, anchors,
                             max_points=int(reader.MAX_POINTS_PER_FRAME),
                             seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"    PointPillars car config: grid {vg.grid_size.tolist()}, "
          f"{anchors.shape[0]} anchors, {n_params} parameters, seed-0 "
          f"weights via {weights.relative_to(ROOT)}")
    return {"cfg": cfg, "coder": coder, "model": model, "frames": frames,
            "pillarize": make_pillarizer(vg,
                                         int(reader.MAX_NUMBER_OF_VOXELS))}


def _clustered_boxes(seed, B, K):
    """Clustered rotated boxes [B, K, 5] (as the JAX package's Pallas NMS
    tests draw them), so that suppression really happens."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(B):
        centers = rs.uniform(0, 40, size=(max(K // 4, 1), 2))
        pick = centers[rs.randint(0, len(centers), K)]
        out.append(np.stack([pick[:, 0] + rs.randn(K) * 0.8,
                             pick[:, 1] + rs.randn(K) * 0.8,
                             rs.uniform(1.5, 2.0, K), rs.uniform(3.5, 4.5, K),
                             rs.uniform(-np.pi, np.pi, K)], axis=1))
    return torch.from_numpy(np.stack(out).astype(np.float32)).cuda()


def _swept_pairs(iou, keep, valid, thr) -> int:
    """Pairs (i, j) the sweep compares in this run: row i kept, j > i
    valid and not yet suppressed when row i runs, i.e. no kept row
    before i exceeds the threshold with j."""
    B, K, _ = iou.shape
    idx = torch.arange(K, device=iou.device)
    over = (iou > thr) & keep[:, :, None] & (idx[:, None] < idx[None, :])
    first = torch.where(over.any(1), over.float().argmax(1), K)
    kept_upto = torch.cumsum(keep.long(), 1)
    last = torch.minimum(first, idx - 1)
    count = torch.where(last >= 0,
                        kept_upto.gather(1, last.clamp_min(0)), 0)
    return int((count * valid).sum())


def _check_keep(row, stage, got, want, iou, thr):
    """Keep masks must be equal; on a difference, print the deciding pair
    (the first differing box and the plain version's kept box whose IoU
    with it lies nearest the threshold) before failing."""
    if not torch.equal(got, want):
        b, j = (int(v) for v in (got != want).nonzero()[0])
        rows = torch.nonzero(want[b, :j]).flatten()
        if len(rows):
            vals = iou[b, rows, j].double()
            i = int(rows[(vals - thr).abs().argmin()])
            print(f"    {row['name']} {stage}: frame {b} box {j} kernel "
                  f"{bool(got[b, j])} plain {bool(want[b, j])}; deciding "
                  f"pair ({i}, {j}) plain IoU {float(iou[b, i, j]):.9g}, "
                  f"{float(iou[b, i, j]) - thr:+.3e} from {thr}")
        raise SmokeFailure(f"{row['name']} {stage}: keep masks differ")


def phase_nms_kernels(det):
    """Both NMS sweeps at the detection shapes against their plain
    versions, on the slice's own top-1000 boxes and on clustered ones.
    The rows keep the times and bounds of the main path's call: the
    slice's boxes at the config's threshold."""
    from papc_tpu_torch.data.synthetic_kitti import collate_batch
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.detector import top_candidates
    from papc_tpu_torch.detect.train import batch_to_device
    from papc_tpu_torch.ops.iou import box5_to_corners, iou_2d, rotate_iou
    from papc_tpu_torch.ops.kernels import nms

    rows = {
        "nms_greedy": _kernel_row("nms_greedy",
                                  "papc_tpu_torch/csrc/nms_greedy.cu",
                                  "papc_tpu/ops/pallas/nms.py:77"),
        "nms_rotate": _kernel_row("nms_rotate",
                                  "papc_tpu_torch/csrc/nms_rotate.cu",
                                  "papc_tpu/ops/pallas/nms.py:269"),
    }
    print(f"[7 detection kernels] kernel vs plain at B={DET_B}, K={DET_K}")
    batch = batch_to_device(collate_batch(
        [det["frames"][i] for i in range(DET_B)]), torch.device("cuda"))
    pcfg = builders.build_predict_config(det["cfg"], det["coder"])
    with torch.inference_mode():
        preds = det["model"](*det["pillarize"](batch))
        b, _, _, _, ok = top_candidates(preds, batch["anchors"],
                                        det["coder"].decode, pcfg)
    sets = [(f"slice top-{DET_K}", b[..., [0, 1, 3, 4, 6]].contiguous(), ok),
            ("clustered", _clustered_boxes(5, DET_B, DET_K),
             torch.ones(DET_B, DET_K, dtype=torch.bool, device="cuda"))]
    main_thr = pcfg.nms_iou_threshold
    for name, boxes, valid in sets:
        check(boxes.shape == (DET_B, DET_K, 5), f"{name}: {boxes.shape}")
        iou_t = rotate_iou(boxes, boxes).transpose(-1, -2)
        corners = box5_to_corners(boxes)
        standup = torch.cat([corners.amin(-2), corners.amax(-2)], dim=-1)
        iou_s = iou_2d(standup, standup).contiguous()
        for thr in NMS_THRESHOLDS:
            tag = f"{name} thr {thr}"
            main = name.startswith("slice") and thr == main_thr
            got = nms.rotate_nms(boxes, valid, thr)
            want = nms.rotate_nms(boxes, valid, thr, impl="plain")
            _check_keep(rows["nms_rotate"], tag, got, want, iou_t, thr)
            pairs = _swept_pairs(iou_t, want, valid, thr)
            _compare(rows["nms_rotate"],
                     tag + f" kept {int(want.sum())}/{want.numel()}",
                     got, want, exact=True,
                     fn_kernel=lambda: nms.rotate_nms(boxes, valid, thr),
                     fn_plain=lambda: nms.rotate_nms(boxes, valid, thr,
                                                     impl="plain"),
                     work=(_nbytes(boxes, valid, got),
                           pairs * CLIP_OPS / F32_OPS_PER_S), record=main)
            got = nms.greedy_suppress(iou_s, valid, thr)
            want = nms.greedy_suppress(iou_s, valid, thr, impl="plain")
            _check_keep(rows["nms_greedy"], tag + " standup", got, want,
                        iou_s, thr)
            pairs = _swept_pairs(iou_s, want, valid, thr)
            _compare(rows["nms_greedy"],
                     tag + f" standup kept {int(want.sum())}/{want.numel()}",
                     got, want,
                     exact=True,
                     fn_kernel=lambda: nms.greedy_suppress(iou_s, valid, thr),
                     fn_plain=lambda: nms.greedy_suppress(iou_s, valid, thr,
                                                          impl="plain"),
                     work=(4 * pairs + _nbytes(valid, got),
                           pairs / F32_OPS_PER_S), record=main)
    del iou_t, iou_s
    return rows


def _device_busy(fn, steps: int = 5, top: int = 0):
    """Device busy share of ``steps`` calls: kernel time on the card
    (``torch.profiler``) over the synchronized host-clock wall. With
    ``top``, also prints the ``top`` device kernels by time a call, with
    their launches a call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    if top:
        by_name: dict = {}
        for e in device:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0][:44]
            t, n = by_name.get(name, (0.0, 0))
            by_name[name] = (t + e.time_range.elapsed_us(), n + 1)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        print(f"    device ms a call by kernel ({len(device) // steps} "
              f"kernels a call; the top {top}, launches a call): " + "; ".join(
                  f"{name} {t / steps / 1e3:.3f} ({n // steps})"
                  for name, (t, n) in ranked[:top]))
    return busy_us / steps / 1e3, wall_us / steps / 1e3


def phase_detect_slice(det, rows, smi):
    """``detect.train.evaluate`` over the synthetic frames: kernels, then
    plain, for the default config (rotated NMS) and the standup one."""
    from papc_tpu_torch.data.synthetic_kitti import collate_batch
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.config import cfg_from_list
    from papc_tpu_torch.detect.detector import (nms_keep, predict,
                                                top_candidates)
    from papc_tpu_torch.detect.train import (batch_to_device, evaluate,
                                             make_predict_step)
    from papc_tpu_torch.ops.kernels import nms

    cfg, coder, model = det["cfg"], det["coder"], det["model"]
    pillarize, frames = det["pillarize"], det["frames"]
    print(f"[8 detection slice] evaluate: PointPillars car, {len(frames)} "
          f"synthetic frames in batches of {DET_B}, TF32 off")

    def step(rotate, impl=None):
        cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms",
                            str(rotate)])
        pcfg = builders.build_predict_config(cfg, coder)
        return make_predict_step(model, pcfg, coder, pillarize, "cuda",
                                 impl=impl), pcfg

    for rotate, kernel, name in [(True, nms.ROTATE, "nms_rotate"),
                                 (False, nms.GREEDY, "nms_greedy")]:
        for k in nms.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        got = evaluate(step(rotate)[0], frames, cfg, log=lambda line: None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rows[name]["launches"] = kernel.launches
        check(kernel.launches > 0,
              f"the detection slice never launched the {name} kernel")
        want = evaluate(step(rotate, "plain")[0], frames, cfg,
                        log=lambda line: None)
        check(len(got) == len(want) == len(frames), f"{len(got)} frames")
        err = 0.0
        for g, w in zip(got, want):
            check(g["box3d_lidar"].shape == (300, 7)
                  and np.isfinite(g["box3d_lidar"][g["valid"]]).all(),
                  "detections not finite or misshapen")
            for key in ("valid", "label_preds"):
                check(np.array_equal(g[key], w[key]),
                      f"{name}: {key} differs from the plain run")
            for key in ("box3d_lidar", "scores"):
                check(np.allclose(g[key], w[key], rtol=DET_TOL, atol=DET_TOL),
                      f"{name}: {key} outside {DET_TOL} of the plain run")
                err = max(err, float(np.abs(g[key] - w[key]).max()))
        kept = [int(g["valid"].sum()) for g in got]
        print(f"    {'rotated' if rotate else 'standup'} NMS: launches "
              f"{name} {kernel.launches} ({seconds:.2f} s with the first "
              f"call's set-up); detections per frame {kept}; max abs err vs "
              f"plain {err:.3e} (tolerance {DET_TOL} abs + rel)")

    step_k, pcfg = step(True)
    step_p, _ = step(True, "plain")
    batches = [batch_to_device(collate_batch([frames[i], frames[i + 1]]),
                               torch.device("cuda"))
               for i in range(0, len(frames) - 1, DET_B)]
    with torch.inference_mode():
        pillars = [int(n) for bt in batches
                   for n in (pillarize(bt)[2][..., 0] >= 0).sum(1)]
    print(f"    pillars per frame {pillars} (cap "
          f"{cfg.EVAL_INPUT_READER.MAX_NUMBER_OF_VOXELS})")
    batch = batches[0]
    host_batch = collate_batch([frames[0], frames[1]])
    serve_ms = cuda_ms(lambda: step_k(host_batch), reps=10)
    serve_dev_ms = cuda_ms(lambda: step_k(batch), reps=10)
    plain_ms = cuda_ms(lambda: step_p(batch), reps=5, warmup=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_k(batch)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.inference_mode():
        vox, num, coords = pillarize(batch)
        feats = model.pfn(vox, num, coords)
        canvas = model.scatter(feats, coords)
        preds = model.rpn(canvas)
        cand = top_candidates(preds, batch["anchors"], coder.decode, pcfg)
        stages = {
            "voxelize": cuda_ms(lambda: pillarize(batch)),
            "PFN": cuda_ms(lambda: model.pfn(vox, num, coords)),
            "scatter": cuda_ms(lambda: model.scatter(feats, coords)),
            "RPN": cuda_ms(lambda: model.rpn(canvas)),
            "predict": cuda_ms(lambda: predict(preds, batch["anchors"],
                                               coder.decode, pcfg)),
            "NMS": cuda_ms(lambda: nms_keep(cand[0], cand[4], pcfg)),
        }
    busy_ms, wall_ms = _device_busy(lambda: step_k(batch))
    busy = (f"{100 * busy_ms / wall_ms:.1f} % ({busy_ms:.3f} of "
            f"{wall_ms:.3f} ms)" if busy_ms > 0 else "not measured")
    print(f"    serving per batch of {DET_B} x 25000 points (rotated NMS, "
          f"CUDA events, median): kernels {serve_dev_ms:.3f} ms from device "
          f"tensors, {serve_ms:.3f} ms from host numpy; plain "
          f"{plain_ms:.3f} ms; peak device memory {peak_gb:.2f} GB ({smi})")
    print("    stage split (ms, predict includes the NMS): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    print(f"    device busy share over 5 kernel steps (profiler): {busy}")


def main() -> int:
    name, smi = phase_device()
    from papc_tpu_torch.models import init_model

    phase_build()
    model = init_model("pointnet2_ssg", "clas", NUM_CLASSES, seed=0,
                       device="cuda").model
    clouds = torch.from_numpy(_loader(B, "clas", seed=0).data).cuda()
    with torch.inference_mode():
        rows, groups = phase_kernels(model, clouds)
    t_rows = train_rows()
    print("[4 training kernels] kernel vs plain, pass by pass, at the SSG "
          "shapes")
    with torch.no_grad():
        phase_train_kernels(groups, t_rows)
    del groups, model
    phase_serving("[5 slice]", "pointnet2_ssg", "clas", smi, rows)
    phase_training("[6 training]", "pointnet2_ssg", "clas", smi, t_rows)
    det = _detect_setup()
    det_rows = phase_nms_kernels(det)
    phase_detect_slice(det, det_rows, smi)
    del det
    scatter_row = phase_new_shapes(rows, t_rows)
    phase_serving("[10 MSG clas serving]", "pointnet2_msg", "clas", smi)
    phase_training("[10 MSG clas training]", "pointnet2_msg", "clas", smi)
    phase_serving("[11 seg serving]", "pointnet2_msg", "seg", smi)
    phase_training("[11 seg training]", "pointnet2_msg", "seg", smi,
                   {"scatter_rows_add": scatter_row})
    phase_serving("[11 seg serving]", "pointnet2_ssg", "seg", smi)
    phase_training("[11 seg training]", "pointnet2_ssg", "seg", smi)
    all_rows = (list(rows.values()) + list(t_rows.values()) + [scatter_row]
                + list(det_rows.values()))
    _finish_bounds(all_rows)
    print(json.dumps({"kernels": all_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
