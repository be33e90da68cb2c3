"""Shared building blocks (counterpart of ``papc_tpu/nn/layers.py``).

Submodules carry the flax tree's names (``Dense_0``, ``BatchNorm_0``, ...)
so that ``convert.py`` maps each flax leaf onto exactly one entry of the
``state_dict`` and each module is easy to find from its JAX counterpart.
Layouts are channel-last, as in JAX. ``train()`` / ``eval()`` select the
mode, as flax's ``train`` argument does: batch statistics with the running
update, and dropout, in training; running statistics in eval.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
from torch import nn

from papc_tpu_torch.ops import fused_mlp

# Paddle BatchNorm defaults kept by the JAX package (momentum 0.9 is
# flax's convention: running = 0.9·running + 0.1·batch).
BN_MOMENTUM = 0.9
BN_EPS = 1e-5

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so the truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax's names and arithmetic:
    ``(x - mean) · (rsqrt(var + eps) · weight) + bias``.

    Training takes ``mean`` and ``var`` over every other axis in f32,
    with flax's fast biased variance ``E[x²] - E[x]²`` clipped at 0, and
    updates the running statistics in flax's form ``m·running +
    (1 - m)·batch`` with that biased variance; ``momentum`` m is flax's,
    0.9 by default (``BN_MOMENTUM``), 0.01 in the detector. (Not
    ``torch.nn.BatchNorm1d``: it stores the unbiased variance, and its
    ``momentum`` is the weight of the batch, 0.1 for flax's 0.9.)
    ``forward(x, dim)`` normalises channel axis ``dim``, the last by
    default (``dim=1`` for an NCHW map).

    A bf16 input or bf16 ``weight`` / ``bias`` (the bf16 training step)
    follows flax 0.12's ``force_float32_reductions``: the statistics are
    f32 and the running ones stay f32, the normalisation is computed in
    f32, and the output is rounded once to the promoted dtype of the
    input, ``weight`` and ``bias`` (``_normalize``'s
    ``canonicalize_dtype``).
    """

    def __init__(self, features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        dim = dim % x.dim()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            x2 = x.to(torch.promote_types(x.dtype, torch.float32))
            if dim == x.dim() - 1:
                x2, axes = x2.reshape(-1, x.shape[-1]), 0
            else:
                axes = [d for d in range(x.dim()) if d != dim]
            mean = x2.mean(axes)
            var = torch.clamp_min((x2 * x2).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        shape = [1] * x.dim()
        shape[dim] = -1
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return out.to(torch.promote_types(
            torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype))


def dense(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax's ``Dense`` on ``linear``'s parameters: input, kernel and bias
    promoted to one dtype first (``promote_dtype``), so a bf16 layer on
    an f32 input computes in f32, as in JAX's bf16 step. In bf16 the
    product is rounded before the bias is added, as flax adds it."""
    w, b = linear.weight, linear.bias
    dtype = torch.promote_types(x.dtype, w.dtype)
    if b is not None:
        dtype = torch.promote_types(dtype, b.dtype)
    x, w = x.to(dtype), w.to(dtype)
    if dtype == torch.bfloat16 and b is not None:
        return x @ w.t() + b.to(dtype)
    return nn.functional.linear(x, w, None if b is None else b.to(dtype))


def f32_cudnn():
    """cuDNN in full float32 (PyTorch's own default lets cuDNN use TF32),
    as a context local to the caller."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


class _F32Cudnn(torch.autograd.Function):
    """``op(x, w)`` with its forward and its backward both under
    :func:`f32_cudnn`: a convolution's backward runs at
    ``loss.backward()``, outside the model's call, and reads the flag
    then."""

    @staticmethod
    def forward(ctx, op, x, w):
        with torch.enable_grad(), f32_cudnn():
            ins = [t.detach().requires_grad_(t.requires_grad) for t in (x, w)]
            out = op(*ins)
        ctx.graph = (ins, out)
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        ins, out = ctx.graph
        del ctx.graph
        need = [t for t in ins if t.requires_grad]
        with f32_cudnn():
            got = iter(torch.autograd.grad(out, need, grad))
        return (None, *(next(got) if t.requires_grad else None
                        for t in ins))


def conv(module: nn.Module, x: torch.Tensor, op) -> torch.Tensor:
    """flax's ``Conv`` / ``ConvTranspose`` on ``module``'s parameters:
    ``op(x, weight)`` (channels first), input, kernel and bias (if any)
    promoted to one dtype first and the bias added after the convolution,
    as flax adds it; cuDNN in float32 forward and backward
    (:func:`f32_cudnn`)."""
    w, b = module.weight, module.bias
    dtype = torch.promote_types(x.dtype, w.dtype)
    if b is not None:
        dtype = torch.promote_types(dtype, b.dtype)
    x, w = x.to(dtype), w.to(dtype)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _F32Cudnn.apply(op, x, w)
    else:
        with f32_cudnn():
            y = op(x, w)
    if b is None:
        return y
    shape = (1, -1) + (1,) * (y.dim() - 2)
    return y + b.to(dtype).reshape(shape)


def dropout(x: torch.Tensor, rate: float, mask: torch.Tensor | None,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``Dropout``: ``where(keep, x / (1 - rate), 0)``, the divisor
    and the quotient rounded to ``x``'s dtype as JAX rounds a Python
    scalar and the result (bf16 in the bf16 step). ``keep`` is ``mask``
    when given, else drawn as ``uniform < 1 - rate`` from ``generator``
    on the generator's device (then moved to ``x``'s)."""
    keep_prob = 1.0 - rate
    if mask is None:
        if generator is None:
            raise ValueError(
                "training-mode dropout needs an explicit torch.Generator "
                "(or the masks)")
        mask = torch.rand(x.shape, generator=generator,
                          device=generator.device) < keep_prob
    mask = mask.to(device=x.device, dtype=torch.bool)
    return torch.where(mask, x / _rounded(keep_prob, x.dtype),
                       torch.zeros_like(x))


@functools.lru_cache(maxsize=64)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a Python scalar."""
    return float(torch.tensor(value, dtype=dtype))


_KERNELS = (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose1d,
            nn.ConvTranspose2d)
_TRANSPOSED = (nn.ConvTranspose1d, nn.ConvTranspose2d)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initial values from a seeded generator: lecun-normal
    kernels (fan-in: input features, or input channels × kernel volume),
    zero biases, BatchNorm scale 1 / bias 0, running mean 0 and variance
    1, and each :class:`TNet`'s last Dense zero with the identity as its
    bias."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _KERNELS):
                w = m.weight
                fan_in = (w.shape[0] * w[0, 0].numel()
                          if isinstance(m, _TRANSPOSED) else w[0].numel())
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        for m in module.modules():
            if isinstance(m, TNet):
                m.reset_transform()


class PointMLP(nn.Module):
    """Dense→BN→ReLU stack over the last axis.

    ``pool_max=True``: the input is grouped ``[B, S, K, C]`` and the output
    the max over K, ``[B, S, features[-1]]``, computed by the fused passes
    (``ops/fused_mlp.py``: in eval the samlp kernel, in training the four
    kernels of the active ``fused_mlp.override``'s mode on the card, the
    stream passes unless it says ``mode="recompute"`` or ``"recompute1"``,
    the latter demoted to stream on a stack its gate refuses), which also
    update
    the running statistics in training. Otherwise the plain per-layer ops,
    ``[..., C]`` → ``[..., features[-1]]``.
    """

    def __init__(self, in_features: int, features: Sequence[int],
                 pool_max: bool = False):
        super().__init__()
        self.features = tuple(features)
        self.pool_max = pool_max
        cins = (in_features,) + self.features[:-1]
        for i, (cin, f) in enumerate(zip(cins, self.features)):
            self.add_module(f"Dense_{i}", nn.Linear(cin, f))
            self.add_module(f"BatchNorm_{i}", BatchNorm(f))

    def layers(self):
        return [(getattr(self, f"Dense_{i}"), getattr(self, f"BatchNorm_{i}"))
                for i in range(len(self.features))]

    def forward(self, x: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        if self.pool_max:
            params = [(d.weight.t(), d.bias, bn.weight, bn.bias)
                      for d, bn in self.layers()]
            running = [(bn.running_mean, bn.running_var)
                       for _, bn in self.layers()]
            if not self.training:
                return fused_mlp.fused_mlp_max(x, params, running, eps=BN_EPS,
                                               impl=impl)
            out, new_running = fused_mlp.fused_mlp_max(
                x, params, running, train=True, momentum=BN_MOMENTUM,
                eps=BN_EPS, impl=impl)
            with torch.no_grad():
                for (_, bn), (mean, var) in zip(self.layers(), new_running):
                    bn.running_mean.copy_(mean)
                    bn.running_var.copy_(var)
            return out
        for linear, bn in self.layers():
            x = torch.relu(bn(dense(linear, x)))
        return x


class MLPHead(nn.Module):
    """Classifier head: Dense(→BN)→ReLU per hidden width, then a final
    Dense. ``dropout_rate`` applies in training before the final Dense
    only, or after every hidden stage with ``per_layer_dropout`` (the
    PointNet++ heads). Dropout has no parameters, so no module."""

    def __init__(self, in_features: int, hidden: Sequence[int], out: int,
                 bn: bool = False, dropout_rate: float = 0.0,
                 per_layer_dropout: bool = False):
        super().__init__()
        self.hidden = tuple(hidden)
        self.bn = bn
        self.dropout_rate = dropout_rate
        self.per_layer_dropout = per_layer_dropout
        cins = (in_features,) + self.hidden
        for i, h in enumerate(self.hidden):
            self.add_module(f"Dense_{i}", nn.Linear(cins[i], h))
            if bn:
                self.add_module(f"BatchNorm_{i}", BatchNorm(h))
        self.add_module(f"Dense_{len(self.hidden)}", nn.Linear(cins[-1], out))

    def dropout_sites(self) -> int:
        """How many dropout masks a training forward draws."""
        if not self.dropout_rate > 0:
            return 0
        return len(self.hidden) if self.per_layer_dropout else 1

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                masks: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        """``masks``: one keep-mask per dropout site, in order (the
        parity tests hand both frameworks the same ones); else they are
        drawn from ``generator``. Both are ignored in eval mode."""
        drop = self.training and self.dropout_sites() > 0
        masks = list(masks) if masks is not None else None
        if drop and masks is not None and len(masks) != self.dropout_sites():
            raise ValueError(f"{len(masks)} dropout masks for "
                             f"{self.dropout_sites()} sites")

        def apply_dropout(h):
            mask = masks.pop(0) if masks is not None else None
            return dropout(h, self.dropout_rate, mask, generator)

        for i in range(len(self.hidden)):
            x = dense(getattr(self, f"Dense_{i}"), x)
            if self.bn:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = torch.relu(x)
            if drop and self.per_layer_dropout:
                x = apply_dropout(x)
        if drop and not self.per_layer_dropout:
            x = apply_dropout(x)
        return dense(getattr(self, f"Dense_{len(self.hidden)}"), x)


class SegHead(nn.Module):
    """Per-point segmentation head: a :class:`PointMLP` over ``hidden``,
    then a Dense to ``out`` classes (no dropout)."""

    def __init__(self, in_features: int, hidden: Sequence[int], out: int):
        super().__init__()
        self.PointMLP_0 = PointMLP(in_features, hidden)
        self.Dense_0 = nn.Linear(tuple(hidden)[-1], out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.Dense_0, self.PointMLP_0(x))


def global_max_pool(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Max over the points axis: the PointNet symmetric function."""
    return torch.amax(x, dim=axis)


class TNet(nn.Module):
    """Spatial / feature transform net: ``[B, N, k]`` → a ``[B, k, k]``
    matrix. A 64-128-1024 :class:`PointMLP`, the global max, Dense 512
    and 256 with ReLU, then a Dense to ``k·k`` whose initial weights are
    zero and bias the flattened identity (:meth:`reset_transform`), so
    the initial transform is I."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k
        self.PointMLP_0 = PointMLP(k, (64, 128, 1024))
        self.Dense_0 = nn.Linear(1024, 512)
        self.Dense_1 = nn.Linear(512, 256)
        self.Dense_2 = nn.Linear(256, k * k)

    def reset_transform(self) -> None:
        with torch.no_grad():
            self.Dense_2.weight.zero_()
            self.Dense_2.bias.copy_(torch.eye(self.k).reshape(-1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = global_max_pool(self.PointMLP_0(x))
        h = torch.relu(dense(self.Dense_0, h))
        h = torch.relu(dense(self.Dense_1, h))
        return dense(self.Dense_2, h).reshape(-1, self.k, self.k)
