"""Mixed precision for training (counterpart of
``papc_tpu/train/precision.py``).

The same design as the JAX package's: parameters, optimizer state and
BatchNorm running statistics stay f32 masters; the forward and backward
run on bf16 copies of the parameters and the batch; the loss is taken in
f32. bf16 has f32's exponent range, so no loss scaling is needed; a
dynamic loss scale is provided all the same, as the JAX package provides
one (its tests are its only user there, and no flag of the port turns it
on).
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from papc_tpu_torch.data.prefetch import map_arrays

PRECISIONS = ("fp32", "bf16")  # the training and serving steps' precisions


def cast_floating(tree, dtype: torch.dtype):
    """``tree`` with every floating tensor cast to ``dtype``: a tensor, or
    dicts, lists and tuples of them (a ``state_dict`` too). Integer, bool
    and non-tensor leaves are returned as they are."""
    return map_arrays(lambda t: t.to(dtype) if isinstance(t, torch.Tensor)
                      and t.is_floating_point() else t, tree)


def is_bf16(precision: str) -> bool:
    """Whether a step's ``precision`` is ``"bf16"``; one other than
    :data:`PRECISIONS` raises ``ValueError``."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return precision == "bf16"


def bf16_call(model: torch.nn.Module, *args, **kwargs):
    """``model(*args, **kwargs)`` on bf16 copies of its parameters and of
    the floating tensors in ``args``: the bf16 steps' forward. The copies
    are differentiable, so the f32 parameters take their gradients in
    f32; the buffers (BatchNorm's running statistics) stay the module's
    own f32 tensors. ``kwargs`` pass as they are."""
    params = cast_floating(dict(model.named_parameters()), torch.bfloat16)
    return torch.func.functional_call(
        model, params, cast_floating(args, torch.bfloat16), kwargs)


def bf16_compute(loss_fn: Callable) -> Callable:
    """Wrap ``loss_fn(params, *args)`` so that it runs on bf16 copies of
    the floating ``params``; the copies are differentiable, so gradients
    reach the f32 ``params`` in f32."""

    def wrapped(params, *args, **kwargs):
        return loss_fn(cast_floating(params, torch.bfloat16), *args, **kwargs)

    return wrapped


class LossScaleState(NamedTuple):
    scale: torch.Tensor  # f32 scalar
    good_steps: torch.Tensor  # int32 scalar: clean steps since the last change


class dynamic_loss_scale:  # noqa: N801 (named after the JAX transform)
    """Dynamic loss scaling, as the JAX package's optax transform:
    ``update(grads, state)`` unscales the incoming gradients (a tensor or
    a dict or list of them); on any non-finite value it zeroes every
    gradient and multiplies the scale by ``backoff_factor``; otherwise it
    multiplies the scale by ``growth_factor`` once ``growth_interval``
    clean steps have passed, and then starts the count again."""

    def __init__(self, init_scale: float = 512.0, growth_interval: int = 2000,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5):
        self.init_scale = init_scale
        self.growth_interval = growth_interval
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor

    def init(self, params=None) -> LossScaleState:
        del params
        return LossScaleState(torch.tensor(self.init_scale, dtype=torch.float32),
                              torch.zeros((), dtype=torch.int32))

    def update(self, grads, state: LossScaleState):
        unscaled = map_arrays(lambda g: g / state.scale, grads)
        leaves = []
        map_arrays(leaves.append, unscaled)
        finite = all(bool(torch.isfinite(g).all()) for g in leaves)
        grown = int(state.good_steps) + 1 >= self.growth_interval
        if finite:
            scale = state.scale * self.growth_factor if grown else state.scale
            good = 0 if grown else int(state.good_steps) + 1
            out = unscaled
        else:
            scale, good = state.scale * self.backoff_factor, 0
            out = map_arrays(torch.zeros_like, unscaled)
        return out, LossScaleState(scale.to(torch.float32),
                                   torch.tensor(good, dtype=torch.int32))

