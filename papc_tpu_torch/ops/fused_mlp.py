"""Fused grouped Dense→BN→ReLU stack + max over K, eval mode.

Counterpart of the eval branch of ``papc_tpu/ops/fused_mlp.py::fused_mlp_max``:
BatchNorm with running statistics is a constant affine, folded into
``(scale, shift) = (γ·rsqrt(var + eps), β - mean·scale)``, and the whole
stack plus the max runs as one pass (``ops/kernels/samlp.py``, whose
``eval_mlp_max_plain`` is the twin of the JAX ``_jnp_eval_mlp_max``). Training
(batch statistics, the backward kernels) is not ported yet; see
``ROADMAP.md``.
"""

from __future__ import annotations

import torch

from papc_tpu_torch.ops.kernels import samlp

# ``with override(impl="plain", operand_dtype=torch.float32)`` changes the
# defaults of fused_mlp_max for a test, as the JAX package's
# ``fused_mlp.override`` does. Arguments passed explicitly win.
_OVERRIDE = {"impl": None, "operand_dtype": torch.bfloat16}


class override:
    def __init__(self, impl: str | None = None,
                 operand_dtype: torch.dtype = torch.bfloat16):
        self._new = {"impl": impl, "operand_dtype": operand_dtype}

    def __enter__(self):
        self._old = dict(_OVERRIDE)
        _OVERRIDE.update(self._new)
        return self

    def __exit__(self, *exc):
        _OVERRIDE.update(self._old)


def fold_bn(gamma, beta, mean, var, eps: float):
    """Running-statistics BatchNorm as ``(scale, shift)``, in f32."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    shift = beta.float() - mean.float() * scale
    return scale, shift


def fused_mlp_max(grouped: torch.Tensor, params, running, *,
                  train: bool = False, eps: float = 1e-5,
                  impl: str | None = None,
                  operand_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Eval-mode fused Dense→BN→ReLU stack + max over the K axis.

    Args:
      grouped: ``[B, S, K, C0]`` neighbourhoods.
      params: per layer ``(W [Cin, Cout], b, gamma, beta)``.
      running: per layer ``(mean, var)`` running statistics.
      impl: ``None`` (kernel on CUDA, plain on the CPU) or ``"plain"``;
        defaults to the active :class:`override`.
      operand_dtype: the matrix products' operand type, bf16 unless an
        :class:`override` or the caller says f32 (plain version only).

    Returns:
      ``[B, S, C_last]`` f32.
    """
    if train:
        raise NotImplementedError(
            "fused_mlp_max: training mode is not ported yet (ROADMAP.md, "
            "Queue 1)"
        )
    impl = _OVERRIDE["impl"] if impl is None else impl
    if operand_dtype is None:
        operand_dtype = _OVERRIDE["operand_dtype"]
    b, s, k, c0 = grouped.shape
    ws, bs, scales, shifts = [], [], [], []
    for (w, bias, gamma, beta), (mean, var) in zip(params, running):
        scale, shift = fold_bn(gamma, beta, mean, var, eps)
        ws.append(w)
        bs.append(bias.float())
        scales.append(scale)
        shifts.append(shift)
    out2 = samlp.eval_mlp_max(
        grouped.reshape(b * s * k, c0), ws, bs, scales, shifts, k=k,
        impl=impl, operand_dtype=operand_dtype,
    )
    return out2.reshape(b, s, -1)
