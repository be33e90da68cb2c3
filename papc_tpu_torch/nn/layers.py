"""Shared building blocks, eval mode (counterpart of ``papc_tpu/nn/layers.py``).

Submodules carry the flax tree's names (``Dense_0``, ``BatchNorm_0``, ...)
so that ``convert.py`` maps each flax leaf onto exactly one entry of the
``state_dict`` and each module is easy to find from its JAX counterpart.
Layouts are channel-last, as in JAX. Training mode is not ported yet:
a module in ``train()`` mode raises (see ``ROADMAP.md``).
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


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: training mode is not ported yet "
            "(ROADMAP.md, Queue 1); call .eval() first"
        )


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax's names and eval arithmetic:
    ``(x - mean) · (rsqrt(var + eps) · weight) + bias``."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


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
    the max over K, ``[B, S, features[-1]]``, computed by the fused eval
    pass (``ops/fused_mlp.py``: the samlp kernel on the card). Otherwise
    the plain per-layer ops, ``[..., C]`` → ``[..., features[-1]]``.
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
        _eval_only(self)
        if self.pool_max:
            params = [(d.weight.t(), d.bias, bn.weight, bn.bias)
                      for d, bn in self.layers()]
            running = [(bn.running_mean, bn.running_var)
                       for _, bn in self.layers()]
            return fused_mlp.fused_mlp_max(x, params, running, eps=BN_EPS,
                                           impl=impl)
        for dense, bn in self.layers():
            x = torch.relu(bn(dense(x)))
        return x


class MLPHead(nn.Module):
    """Classifier head: (Dense→BN→ReLU→Dropout) per hidden width, then a
    final Dense. Dropout is inactive in eval mode, so it has no module."""

    def __init__(self, in_features: int, hidden: Sequence[int], out: int,
                 bn: bool = False):
        super().__init__()
        self.hidden = tuple(hidden)
        self.bn = bn
        cins = (in_features,) + self.hidden
        for i, h in enumerate(self.hidden):
            self.add_module(f"Dense_{i}", nn.Linear(cins[i], h))
            if bn:
                self.add_module(f"BatchNorm_{i}", BatchNorm(h))
        self.add_module(f"Dense_{len(self.hidden)}", nn.Linear(cins[-1], out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        for i in range(len(self.hidden)):
            x = getattr(self, f"Dense_{i}")(x)
            if self.bn:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = torch.relu(x)
        return getattr(self, f"Dense_{len(self.hidden)}")(x)
