"""How far apart two correct f32 detection steps lie on host-pillarized
batches, over seeds, on the card: the data behind ``chip_smoke.py``'s
``DT_HOST_GRAD_RL2``.

    python3 tools/detect_host_grad_seeds.py [--seeds 2:0,3:0,4:1,5:2,6:3]

Each seed pair ``frames:weights`` makes phase 20's batch (the car config
at full width, B=2 synthetic frames of ``SyntheticFrames(seed=frames)``,
host-pillarized into the flat view of the flat PFN) and its network
(``init_params`` seeded with ``weights``), then takes one
``make_detection_train_step`` step on it four ways: on the card with
cuDNN (the port's training convolutions, f32 without TF32), on the card
with cuDNN off (PyTorch's own convolutions), on the CPU in f32 and on
the CPU in float64 (the port's float64 step; its flat PFN keeps JAX's f32
statistics). A line a pair of steps gives the median and the largest of
the parameters' gradients' relative L2 distances, and the tensor at the
largest.
"""

from __future__ import annotations

import argparse
import copy
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PAIRS = (("cuDNN", "CPU"), ("no cuDNN", "CPU"), ("CPU", "float64"),
         ("cuDNN", "float64"), ("no cuDNN", "float64"))


def _grads(seeded, cfg, loss_cfg, pillarize, batch, device):
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.train import make_detection_train_step

    model = copy.deepcopy(seeded)
    opt, sched = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER,
                                          model.parameters())
    step, init_rm = make_detection_train_step(model, loss_cfg, opt, sched,
                                              pillarize, device=device)
    step(batch, init_rm())
    return {n: p.grad.detach().cpu().double()
            for n, p in model.named_parameters()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="2:0,3:0,4:1,5:2,6:3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from papc_tpu_torch.data.synthetic_kitti import (SyntheticFrames,
                                                     collate_batch,
                                                     host_pillarize)
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect import train as dtrain
    from papc_tpu_torch.detect.config import car_config, cfg_from_list
    from papc_tpu_torch.nn import layers

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = car_config()
    cfg_from_list(cfg, ["MODEL.DEVICE_PILLARIZE", "False"])
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    ta = builders.build_target_assigner(cfg.TARGET_ASSIGNER, coder)
    gen = ta.generate_anchors([1, int(vg.grid_size[1]) // 2,
                               int(vg.grid_size[0]) // 2])
    reader = cfg.TRAIN_INPUT_READER
    n_cap, max_voxels = (int(reader.MAX_POINTS_PER_FRAME),
                         int(reader.MAX_NUMBER_OF_VOXELS))
    loss_cfg = builders.build_loss_config(cfg, coder)
    pillarize = dtrain.make_pillarizer(vg, max_voxels)
    f32_cudnn = layers.f32_cudnn
    for pair in args.seeds.split(","):
        f_seed, w_seed = (int(v) for v in pair.split(":"))
        frames = SyntheticFrames(
            2, gen["anchors"].reshape(-1, 7), max_points=n_cap, seed=f_seed,
            target_assigner=ta, matched_thresholds=gen["matched_thresholds"],
            unmatched_thresholds=gen["unmatched_thresholds"])
        batch = dtrain.example_to_batch(collate_batch(
            [host_pillarize(frames[i], vg, max_voxels, True)
             for i in range(2)]))
        seeded = builders.build_network(cfg, vg, ta)
        layers.init_params(seeded, torch.Generator().manual_seed(w_seed))
        b64 = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
               for k, v in batch.items()}
        g = {"float64": _grads(seeded.double(), cfg, loss_cfg, pillarize,
                               b64, "cpu")}
        seeded.float()
        g["CPU"] = _grads(seeded, cfg, loss_cfg, pillarize, batch, "cpu")
        g["cuDNN"] = _grads(seeded, cfg, loss_cfg, pillarize, batch, "cuda")
        layers.f32_cudnn = lambda: torch.backends.cudnn.flags(
            enabled=False, allow_tf32=False)
        try:
            g["no cuDNN"] = _grads(seeded, cfg, loss_cfg, pillarize, batch,
                                   "cuda")
        finally:
            layers.f32_cudnn = f32_cudnn
        print(f"frames seed {f_seed}, weights seed {w_seed}:")
        for a, b in PAIRS:
            rel = {n: float((g[a][n] - g[b][n]).norm() / g[b][n].norm())
                   for n in g[b]}
            worst = max(rel, key=rel.get)
            print(f"    {a} vs {b}: median {statistics.median(rel.values()):.3e}"
                  f", largest {rel[worst]:.3e} ({worst})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
