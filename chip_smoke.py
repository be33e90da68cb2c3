#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the serving path of ``papc_tpu_torch`` (eval-mode PointNet++ SSG
classification, B=32 clouds x 1024 points, 16 classes, seeded weights) on
the card, in five phases; any failure raises and exits non-zero.

1. Device: needs CUDA (there is no CPU mode), prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles the kernels from ``papc_tpu_torch/csrc`` with nvcc.
3. Kernels at the SSG shapes: each kernel against its plain PyTorch
   version on the same inputs (FPS, ball query and gather exactly, the
   eval SA-MLP within 1e-2 abs and rel: both round every activation to
   bf16 and sum exact f32 products in another order), and both times
   from CUDA events, median of 20 after warm-up.
4. Slice: ``papc_tpu_torch.train.evaluate`` over synthetic batches with
   the kernels, its launch counts, and its logits against the same run
   with every op on its plain version; forward ms per batch for both.
5. The per-kernel JSON line, then the result line.
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


def _compare(row, stage, got, want, *, exact, fn_kernel, fn_plain):
    err = (got.double() - want.double()).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if exact:
        check(torch.equal(got, want),
              f"{row['name']} {stage}: kernel differs from plain "
              f"(max abs err {max_err})")
    else:
        bound = MLP_TOL + MLP_TOL * want.double().abs()
        check(bool((err <= bound).all()),
              f"{row['name']} {stage}: kernel outside {MLP_TOL} of plain "
              f"(max abs err {max_err})")
    ms, plain_ms = cuda_ms(fn_kernel), cuda_ms(fn_plain)
    row["max_abs_err"] = max(row["max_abs_err"], max_err)
    row["ms"] += ms
    row["plain_ms"] += plain_ms
    print(f"    {row['name']:<13} {stage:<28} max_abs_err {max_err:.3e}  "
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
        feats = _check_mlp(rows["samlp_eval"], f"SA{i}", sa.PointMLP_0,
                           grouped)
        xyz = new_xyz
    grouped = torch.cat([xyz, feats], dim=-1)[:, None]  # SA3: group_all
    _check_mlp(rows["samlp_eval"], "SA3", model.SetAbstraction_2.PointMLP_0,
               grouped)
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
    print(f"[4 slice] evaluate: pointnet2_ssg clas, {loader.num_samples} "
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
        rows = phase_kernels(model, clouds)
    phase_slice(weights, rows, smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
