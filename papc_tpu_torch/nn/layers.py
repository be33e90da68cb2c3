"""Shared building blocks (counterpart of ``papc_tpu/nn/layers.py``).

Submodules carry the flax tree's names (``Dense_0``, ``BatchNorm_0``, ...)
so that ``convert.py`` maps each flax leaf onto exactly one entry of the
``state_dict`` and each module is easy to find from its JAX counterpart.
Layouts are channel-last, as in JAX. ``train()`` / ``eval()`` select the
mode, as flax's ``train`` argument does: batch statistics with the running
update, and dropout, in training; running statistics in eval.
"""

from __future__ import annotations

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
    updates the running statistics in flax's form ``0.9·running +
    0.1·batch`` (``BN_MOMENTUM``) with that biased variance. (Not
    ``torch.nn.BatchNorm1d``: it stores the unbiased variance, and its
    ``momentum`` is the weight of the batch, 0.1 for flax's 0.9.)
    """

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            x2 = x.reshape(-1, x.shape[-1]).float()
            mean = x2.mean(0)
            var = torch.clamp_min((x2 * x2).mean(0) - mean * mean, 0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


def dropout(x: torch.Tensor, rate: float, mask: torch.Tensor | None,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``Dropout``: ``where(keep, x / (1 - rate), 0)``. ``keep`` is
    ``mask`` when given, else drawn as ``uniform < 1 - rate`` from
    ``generator`` on the generator's device (then moved to ``x``'s)."""
    keep_prob = 1.0 - rate
    if mask is None:
        if generator is None:
            raise ValueError(
                "training-mode dropout needs an explicit torch.Generator "
                "(or the masks)")
        mask = torch.rand(x.shape, generator=generator,
                          device=generator.device) < keep_prob
    mask = mask.to(device=x.device, dtype=torch.bool)
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initial values from a seeded generator: lecun-normal
    kernels, zero biases, BatchNorm scale 1 / bias 0, running mean 0 and
    variance 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


class PointMLP(nn.Module):
    """Dense→BN→ReLU stack over the last axis.

    ``pool_max=True``: the input is grouped ``[B, S, K, C]`` and the output
    the max over K, ``[B, S, features[-1]]``, computed by the fused passes
    (``ops/fused_mlp.py``: in eval the samlp kernel, in training the four
    stream-mode kernels on the card), which also update the running
    statistics in training. Otherwise the plain per-layer ops,
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
        for dense, bn in self.layers():
            x = torch.relu(bn(dense(x)))
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
            x = getattr(self, f"Dense_{i}")(x)
            if self.bn:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = torch.relu(x)
            if drop and self.per_layer_dropout:
                x = apply_dropout(x)
        if drop and not self.per_layer_dropout:
            x = apply_dropout(x)
        return getattr(self, f"Dense_{len(self.hidden)}")(x)
