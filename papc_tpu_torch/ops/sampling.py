"""Farthest point sampling.

Counterpart of ``papc_tpu/ops/sampling.py::farthest_point_sample``. On a
CUDA tensor it runs the hand-written kernel (``ops/kernels/fps.py``), on
a CPU tensor its plain version; both give the XLA loop's picks.
"""

from __future__ import annotations

import torch

from papc_tpu_torch.ops.kernels import fps


def farthest_point_sample(
    xyz: torch.Tensor,
    npoint: int,
    *,
    generator: torch.Generator | None = None,
    start_idx: torch.Tensor | int | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """Iteratively pick the point farthest from the already-picked set.

    Args:
      xyz: ``[B, N, 3]`` point positions.
      npoint: number of samples.
      generator: draws a random start point per cloud (JAX's ``key``);
        the start is drawn on the generator's device and moved to xyz's.
      start_idx: fixed start index (scalar or ``[B]``); wins over
        ``generator``. With neither, every cloud starts at point 0.
      impl: ``None`` (kernel on CUDA, plain on the CPU) or ``"plain"``.

    Returns:
      ``[B, npoint]`` int32 indices into ``N``.
    """
    B, N, _ = xyz.shape
    if start_idx is not None:
        start = torch.as_tensor(start_idx, dtype=torch.int32)
        start = start.to(xyz.device).broadcast_to((B,))
        if isinstance(start_idx, int) and not 0 <= start_idx < N:
            raise ValueError(f"start_idx={start_idx} outside [0, {N})")
    elif generator is not None:
        start = torch.randint(
            0, N, (B,), generator=generator, dtype=torch.int32,
            device=generator.device,
        ).to(xyz.device)
    else:
        start = torch.zeros((B,), dtype=torch.int32, device=xyz.device)
    return fps.farthest_point_sample(xyz, npoint, start.contiguous(),
                                     impl=impl)
