"""papc_tpu_torch: the PyTorch / CUDA port of papc_tpu for NVIDIA Hopper.

The JAX package ``papc_tpu`` is the reference; this package mirrors its
module paths and names (``ops``, ``nn``, ``models``, ``data``, ``train``)
so each counterpart is easy to find. It imports ``torch`` and numpy and
never ``jax``, ``flax`` or ``papc_tpu``.

Ported so far: the whole classification / part-segmentation zoo of the
JAX registry (14 model / mode combos: PointNet-Basic, PointNet and its
Conv2D variant, VFE, VoxNet, KD-Net, KD-UNet and PointNet++ SSG / MSG),
its training step (``train.train``) and its eval-mode inference
(``train.evaluate``), with the ShapeNet, kd-tree and voxel loaders, and
PointPillars detection: serving from raw lidar frames
(``detect.train.make_predict_step``), training on KITTI
(``detect.train.train``, the pipeline under ``detect/kitti/``) and the
official mAP (``detect.train.evaluate_checkpoint``).
Every TPU kernel on those paths is a hand-written CUDA kernel under
``csrc/``, compiled by ``nvcc`` for ``sm_90a`` at first use
(:mod:`papc_tpu_torch._build`). Each kernel's wrapper in
``ops/kernels/`` holds the plain PyTorch version of the same function:
a CPU tensor takes the plain version, a CUDA tensor launches the kernel
or raises.
"""

from papc_tpu_torch.models import init_model

__all__ = ["init_model"]
