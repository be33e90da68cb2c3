"""Hand-written CUDA kernels of the port, each beside its plain version.

Every wrapper module here holds:

- the plain PyTorch version of its function (the CPU path and the
  kernel's test oracle);
- a :class:`papc_tpu_torch._build.Kernel` (the C entry point and its
  launch count);
- the dispatching function, which takes the plain version only for a
  tensor on the CPU (or when asked with ``impl="plain"``) and for a CUDA
  tensor launches the kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import torch

IMPLS = (None, "plain")


def use_kernel(t: torch.Tensor, impl: str | None) -> bool:
    """Whether an op on ``t`` launches its kernel.

    ``impl=None`` decides by device: CUDA → kernel, CPU → plain; a
    tensor on any other device raises. ``"plain"`` takes the plain
    version on any device (tests and the card's comparisons).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "plain":
        return False
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel and no plain path for {t.device}")
    return False


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple) -> None:
    """Validate a kernel argument: CUDA, dtype, contiguity and shape
    (``None`` entries in ``shape`` match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be on a CUDA device, is on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, is {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if len(t.shape) != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
