#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the serving path and the training path of ``papc_tpu_torch``
(PointNet++ SSG classification, B=32 clouds x 1024 points, 16 classes,
seeded weights) on the card, in seven phases; any failure raises and
exits non-zero.

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
   the same run with every op on its plain version; forward ms per
   batch for both.
6. Training slice: ``papc_tpu_torch.train.train`` for 10 steps on one
   repeated synthetic batch and a val pass, from seed-0 weights, with
   every launch count of the nine kernels read around it; the loss must
   be finite and fall. Then one step with the kernels against one step
   on the plain versions from the same weights and dropout masks, both
   held against a plain step with f32 operands (loss within
   ``LOSS_RTOL``; each gradient as ``GRAD_RATIO`` says), and step ms
   (CUDA events, median) for both.
7. The per-kernel JSON line, then the result line.
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
            "ms": 0.0, "plain_ms": 0.0}


def _bf16_ulp(t):
    t = t.double().abs()
    return torch.where(t == 0, torch.zeros_like(t),
                       torch.exp2(torch.floor(torch.log2(t)) - 7))


def _compare(row, stage, got, want, *, exact=False, rel=None, ulp=False,
             scale=None, fn_kernel=None, fn_plain=None):
    """Hold a kernel's output against its plain version's: ``exact``;
    or within ``rel`` of the largest magnitude of ``want`` (of ``scale``
    when given; plus one bf16 ulp of each element with ``ulp``); else the
    eval MLP's ``MLP_TOL``. Times both functions when given."""
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
    row["ms"] += ms
    row["plain_ms"] += plain_ms
    print(f"    {row['name']:<18} {stage:<34} max_abs_err {max_err:.3e}  "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")


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
    groups = []  # (stage, grouped, idx, source points, PointMLP) for phase 4
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
                     xyz, npoint, start, impl="plain"))
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
                     radius, k, xyz, new_xyz, impl="plain"))
        c = 3 + (0 if feats is None else feats.shape[-1])
        tag = f"SA{i} [{B},{npoint},{k},{c}]"
        grouped = gather.group_gather(xyz, feats, idx, new_xyz)
        _compare(rows["group_gather"], tag, grouped,
                 gather.group_gather(xyz, feats, idx, new_xyz, impl="plain"),
                 exact=True,
                 fn_kernel=lambda: gather.group_gather(
                     xyz, feats, idx, new_xyz),
                 fn_plain=lambda: gather.group_gather(
                     xyz, feats, idx, new_xyz, impl="plain"))
        groups.append((f"SA{i}", grouped, idx, xyz.shape[1], sa.PointMLP_0))
        feats = _check_mlp(rows["samlp_eval"], f"SA{i}", sa.PointMLP_0,
                           grouped)
        xyz = new_xyz
    grouped = torch.cat([xyz, feats], dim=-1)[:, None]  # SA3: group_all
    _check_mlp(rows["samlp_eval"], "SA3", model.SetAbstraction_2.PointMLP_0,
               grouped)
    groups.append(("SA3", grouped, None, None,
                   model.SetAbstraction_2.PointMLP_0))
    return rows, groups


TRAIN_ROWS = [  # name, source, TPU kernel it replaces
    ("group_scatter_add", "group_scatter_add.cu", "gather_t.py:172"),
    ("samlp_linear_stats", "samlp_linear_stats.cu", "samlp.py:158"),
    ("samlp_finalize_max", "samlp_finalize_seed.cu", "samlp.py:236"),
    ("samlp_bwd_seed", "samlp_finalize_seed.cu", "samlp.py:366"),
    ("samlp_bwd_layer", "samlp_bwd_layer.cu", "samlp.py:492"),
]


def phase_train_kernels(groups):
    """The training passes of every SA stage on the grouped tensors of
    phase 3, each pass fed the plain chain's outputs so that kernel and
    plain see identical inputs; the scatter-add at SA2's shape (SA1's
    input is data and gets no gradient on the training path)."""
    from papc_tpu_torch.nn.layers import BN_EPS
    from papc_tpu_torch.ops.kernels import gather
    from papc_tpu_torch.ops.kernels import samlp_train as st

    rows = {name: _kernel_row(name, f"papc_tpu_torch/csrc/{src}",
                              f"papc_tpu/ops/pallas/{tpu}")
            for name, src, tpu in TRAIN_ROWS}
    print("[4 training kernels] kernel vs plain, pass by pass, at the SSG "
          "shapes")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for stage, grouped, idx, n_src, mlp in groups:
        b, s, k, c0 = grouped.shape
        m = b * s * k
        if idx is not None and stage != "SA1":
            g = torch.randn(grouped.shape, generator=gen, device="cuda")
            _compare(rows["group_scatter_add"], f"{stage} {list(g.shape)}",
                     gather.scatter_add(g, idx, n_src),
                     gather.scatter_add(g, idx, n_src, impl="plain"),
                     rel=SCATTER_TOL,
                     fn_kernel=lambda: gather.scatter_add(g, idx, n_src),
                     fn_plain=lambda: gather.scatter_add(g, idx, n_src,
                                                         impl="plain"))
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
            _compare(row, tag + " sums", sums, psums, rel=TRAIN_TOL,
                     fn_kernel=lambda: st.linear_stats(h, vec, w, bias,
                                                       w_packed=wp),
                     fn_plain=lambda: st.linear_stats(h, vec, w, bias,
                                                      impl="plain"))
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
                 fn_plain=lambda: st.finalize_max(h, vec, k=k, impl="plain"))
        dout = torch.randn(pout.shape, generator=gen, device="cuda")
        row = rows["samlp_bwd_seed"]
        dy, sd = st.bwd_seed(h, vec, dout, pamax, k=k)
        pdy, psd = st.bwd_seed(h, vec, dout, pamax, k=k, impl="plain")
        _compare(row, tag + " dy", dy, pdy, exact=True)
        _compare(row, tag + " sums", sd, psd, rel=TRAIN_TOL,
                 fn_kernel=lambda: st.bwd_seed(h, vec, dout, pamax, k=k),
                 fn_plain=lambda: st.bwd_seed(h, vec, dout, pamax, k=k,
                                              impl="plain"))
        dy, sd = pdy, psd
        row = rows["samlp_bwd_layer"]
        for i in range(len(layers) - 1, -1, -1):
            w = layers[i][0]
            a_prev = a_list[i - 1] if i else g2
            vprev = vecs[i - 1] if i else None
            need = bool(i) or stage != "SA1"  # SA1's input is data

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
            _compare(row, tag + " dW", got[1], want[1], rel=TRAIN_TOL,
                     fn_kernel=lambda: run(None), fn_plain=lambda: run("plain"))
            dy, sd = want[0], want[3]
    return rows


def _check_mlp(row, stage, mlp, grouped):
    """One SA stage's MLP+max (``PointMLP`` with ``pool_max``: BN folded,
    then the samlp_eval wrapper) on its grouped input."""
    b, s, k, c0 = grouped.shape
    got = mlp(grouped)
    widths = "->".join(str(f) for f in mlp.features)
    _compare(row, f"{stage} M={b * s * k} k={k} {c0}->{widths}", got,
             mlp(grouped, impl="plain"), exact=False,
             fn_kernel=lambda: mlp(grouped),
             fn_plain=lambda: mlp(grouped, impl="plain"))
    return got


def phase_slice(weights: Path, rows: dict, smi: str):
    from papc_tpu_torch.data import SyntheticLoader
    from papc_tpu_torch.ops.kernels import ball_query, fps, gather, samlp
    from papc_tpu_torch.train import evaluate

    kernels = {"fps": fps, "ball_query": ball_query,
               "group_gather": gather, "samlp_eval": samlp}
    # 100 clouds: three full batches of 32 and a last one padded from 4
    loader = SyntheticLoader(100, n_points=N, num_classes=NUM_CLASSES,
                             batchsize=B, seed=1)
    print(f"[5 slice] evaluate: pointnet2_ssg clas, {loader.num_samples} "
          f"clouds in {len(loader)} batches of {B} x {N}")

    def run(impl):
        return evaluate("pointnet2_ssg", "clas", N, NUM_CLASSES, batchsize=B,
                        weights=weights, make_loader=lambda split: loader,
                        device="cuda", impl=impl,
                        log=lambda line: print(f"    {impl or 'kernels'}: "
                                               f"{line}"))

    for mod in kernels.values():
        mod.KERNEL.launches = 0
    t0 = time.perf_counter()
    got = run(None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for name, mod in kernels.items():
        rows[name]["launches"] = mod.KERNEL.launches
    print("    launches: " + ", ".join(
        f"{n} {r['launches']}" for n, r in rows.items())
        + f" ({seconds:.2f} s with the first call's set-up)")
    for name, row in rows.items():
        check(row["launches"] > 0,
              f"the slice never launched the {name} kernel")
    want = run("plain")
    logits, ref = got["logits"], want["logits"]
    check(logits.shape == (loader.num_samples, NUM_CLASSES),
          f"logits have shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "logits are not finite")
    err = float((logits - ref).abs().max())
    check(torch.allclose(logits, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
          f"kernel logits differ from plain by {err}")
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"    logits [{logits.shape[0]}, {logits.shape[1]}] finite, max abs "
          f"err vs plain {err:.3e} (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}), "
          f"argmax agreement {agree:.3f}, |logits| max "
          f"{float(ref.abs().max()):.3f}")

    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.convert import load_flax_weights

    model = load_flax_weights(init_model().model, weights).cuda()
    batch = torch.from_numpy(next(iter(loader())).points).cuda()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(batch), reps=10)
        plain_ms = cuda_ms(lambda: model(batch, impl="plain"), reps=10)
    print(f"    forward per batch of {B} x {N}: kernels {fwd_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms ({smi})")


def _noise_grad(name: str) -> bool:
    """A Dense bias that feeds a BatchNorm: its true gradient is 0."""
    parts = name.split(".")
    return (parts[-1] == "bias" and parts[-2].startswith("Dense_")
            and name != "MLPHead_0.Dense_2.bias")


def phase_train(rows: dict, smi: str):
    """The training path through its entry point, then one kernel step
    against one plain step, then step times."""
    from papc_tpu_torch.data import SyntheticLoader
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.ops import fused_mlp
    from papc_tpu_torch.ops.kernels import (ball_query, fps, gather, samlp,
                                            samlp_train)
    from papc_tpu_torch.train import make_optimizer, train, train_step

    counters = {"fps": fps.KERNEL, "ball_query": ball_query.KERNEL,
                "group_gather": gather.KERNEL, "samlp_eval": samlp.KERNEL,
                "group_scatter_add": gather.SCATTER_KERNEL,
                "samlp_linear_stats": samlp_train.LINEAR_STATS,
                "samlp_finalize_max": samlp_train.FINALIZE_MAX,
                "samlp_bwd_seed": samlp_train.BWD_SEED,
                "samlp_bwd_layer": samlp_train.BWD_LAYER}
    batch = next(iter(SyntheticLoader(B, n_points=N, num_classes=NUM_CLASSES,
                                      batchsize=B, seed=2)()))
    val = SyntheticLoader(2 * B, n_points=N, num_classes=NUM_CLASSES,
                          batchsize=B, seed=3)
    loaders = {"train": lambda: iter([batch] * TRAIN_STEPS), "val": val}
    print(f"[6 training] train: pointnet2_ssg clas from seed-0 weights, "
          f"{TRAIN_STEPS} steps on one batch of {B} x {N}, then a val pass "
          f"over {val.num_samples} clouds")
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    _, history = train("pointnet2_ssg", "clas", N, NUM_CLASSES, epoch_num=1,
                       batchsize=B, info_iter=3, save_iter=1,
                       model_dir=str(ROOT / "build" / "chip_smoke" / "model"),
                       seed=0, make_loader=loaders.__getitem__,
                       device="cuda", log=lambda line: print(f"    {line}"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    print("    launches: " + ", ".join(f"{n} {v}" for n, v in launches.items())
          + f" ({seconds:.2f} s with the first call's set-up)")
    for name, count in launches.items():
        check(count > 0, f"the training path never launched the {name} kernel")
        if name in rows:
            rows[name]["launches"] = count
    losses = history[0]["train_loss"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(losses[-1] < losses[0],
          f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    print(f"    loss step 1 {losses[0]:.6f} -> step {TRAIN_STEPS} "
          f"{losses[-1]:.6f}; val loss {history[0]['val_loss']:.6f}, "
          f"val accuracy {history[0]['val_metric']:.4f}")

    gen = torch.Generator().manual_seed(4)
    masks = [torch.rand(B, 512, generator=gen) < 0.6,
             torch.rand(B, 256, generator=gen) < 0.6]
    bdict = batch._asdict()
    dev = torch.device("cuda")

    def one_step(impl):
        model = init_model("pointnet2_ssg", "clas", NUM_CLASSES, seed=0,
                           device=dev).model
        opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
        loss, _ = train_step(model, opt, bdict, dev, impl=impl,
                             dropout_masks=masks)
        return float(loss), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}, model, opt

    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k, model, opt = one_step(None)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss_p, grads_p, model_p, opt_p = one_step("plain")
    with fused_mlp.override(operand_dtype=torch.float32):
        loss_f, grads_f, _, _ = one_step("plain")
    print(f"    one step from the same weights and masks: loss kernels "
          f"{loss_k:.6f}, plain {loss_p:.6f}, plain with f32 operands "
          f"{loss_f:.6f}")
    failures, rels, ratios, noise = [], {}, {}, {}
    for name, gk in grads_k.items():
        gp, gf = grads_p[name], grads_f[name]
        if not bool(torch.isfinite(gk).all()):
            failures.append(f"{name}: gradient not finite")
        if _noise_grad(name):
            module = name.rsplit(".", 2)[0]
            scale = max(float(g.abs().max()) for n, g in grads_p.items()
                        if n.startswith(module + "."))
            noise[name] = float((gk - gp).abs().max()) / max(scale, 1e-30)
            continue
        rels[name] = float((gk - gp).norm() / gp.norm().clamp_min(1e-30))
        ratios[name] = float((gk - gf).norm()
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
    step_ms = cuda_ms(lambda: train_step(model, opt, bdict, dev,
                                         dropout_masks=masks), reps=10)
    plain_ms = cuda_ms(lambda: train_step(model_p, opt_p, bdict, dev,
                                          impl="plain", dropout_masks=masks),
                       reps=3, warmup=1)
    print(f"    train step of {B} x {N}: kernels {step_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms (CUDA events, median); peak device memory "
          f"of the first kernel step {peak_gb:.2f} GB ({smi})")


def main() -> int:
    name, smi = phase_device()
    from papc_tpu_torch.convert import state_dict_to_flax
    from papc_tpu_torch.data import SyntheticLoader
    from papc_tpu_torch.models import init_model

    phase_build()
    spec = init_model("pointnet2_ssg", "clas", NUM_CLASSES, seed=0)
    weights = ROOT / "build" / "chip_smoke" / "pointnet2_ssg_seed0.npz"
    weights.parent.mkdir(parents=True, exist_ok=True)
    np.savez(weights, **state_dict_to_flax(spec.model.state_dict()))
    model = spec.model.cuda()
    clouds = torch.from_numpy(
        SyntheticLoader(B, n_points=N, num_classes=NUM_CLASSES,
                        batchsize=B, seed=0).data).cuda()
    with torch.inference_mode():
        rows, groups = phase_kernels(model, clouds)
    with torch.no_grad():
        train_rows = phase_train_kernels(groups)
    del groups
    phase_slice(weights, rows, smi)
    phase_train(train_rows, smi)
    print(json.dumps({"kernels": list(rows.values())
                      + list(train_rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
