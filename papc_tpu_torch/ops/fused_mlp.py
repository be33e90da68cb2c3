"""Fused grouped Dense→BN→ReLU stack + max over K.

Counterpart of ``papc_tpu/ops/fused_mlp.py::fused_mlp_max``, stream mode.

- Eval: BatchNorm with running statistics is a constant affine, folded
  into ``(scale, shift) = (γ·rsqrt(var + eps), β - mean·scale)``, and the
  whole stack plus the max runs as one pass (``ops/kernels/samlp.py``,
  whose ``eval_mlp_max_plain`` is the twin of the JAX ``_jnp_eval_mlp_max``).
- Train: one ``linear_stats`` pass per layer and ``finalize_max`` forward;
  ``bwd_seed`` and one ``bwd_layer`` pass per layer backward
  (``ops/kernels/samlp_train.py``), behind one ``torch.autograd.Function``,
  the counterpart of ``_make_core``'s custom VJP. Its gradient semantics
  are the JAX one's: the analytic BatchNorm backward with batch
  statistics as functions of the input, the max's cotangent routed to the
  FIRST argmax (``torch.amax``'s autograd would split ties), no gradient
  through the batch mean and variance, which only feed the running
  update (flax's ``0.9·running + 0.1·batch``, biased variance).
"""

from __future__ import annotations

import torch

from papc_tpu_torch.ops.kernels import samlp, samlp_train, use_kernel

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


class _FusedTrain(torch.autograd.Function):
    """Training forward and backward of the stack over ``x [M, C0]`` f32
    (the grouped rows): ``forward(x, k, eps, impl, operand_dtype, W0, b0,
    γ0, β0, W1, ...)`` → ``(out [M/k, C_last] f32, mean_0, ..., var_0,
    ...)``, the batch statistics marked non-differentiable.

    ``x`` is cast to the operand dtype inside (``g2``, as
    ``fused_mlp.py:448`` does), so its gradient comes back in f32 and
    unrounded. Saved for the backward: ``g2``, every layer's stored
    pre-activation, the ``[4, C]`` BN vectors, the argmax and, on the
    kernel path, the bf16 weights packed once in the forward.
    """

    @staticmethod
    def forward(ctx, x, k, eps, impl, operand_dtype, *flat):
        params = [flat[i:i + 4] for i in range(0, len(flat), 4)]
        m = x.shape[0]
        kernel = use_kernel(x, impl)
        g2 = x.to(operand_dtype)
        packed = ([samlp_train.pack_weight(w) for w, *_ in params]
                  if kernel else [None] * len(params))
        h, vec, a_list, vecs, means, vars_ = g2, None, [], [], [], []
        for (w, bias, gamma, beta), wp in zip(params, packed):
            a, sums = samlp_train.linear_stats(
                h, vec, w, bias, impl=impl, operand_dtype=operand_dtype,
                w_packed=wp)
            vec, (mean, var) = samlp_train.bn_vectors(sums, gamma, beta, m,
                                                      eps)
            a_list.append(a)
            vecs.append(vec)
            means.append(mean)
            vars_.append(var)
            h = a
        out, amax = samlp_train.finalize_max(a_list[-1], vecs[-1], k=k,
                                             impl=impl)
        weights = packed if kernel else [p[0] for p in params]
        ctx.save_for_backward(g2, amax, *a_list, *vecs, *weights)
        ctx.n, ctx.k, ctx.impl = len(params), k, impl
        ctx.operand_dtype, ctx.kernel = operand_dtype, kernel
        ctx.mark_non_differentiable(*means, *vars_)
        return (out, *means, *vars_)

    @staticmethod
    def backward(ctx, dout, *_stats):
        n, k, impl, odt = ctx.n, ctx.k, ctx.impl, ctx.operand_dtype
        g2, amax, *rest = ctx.saved_tensors
        a_list, vecs, weights = rest[:n], rest[n:2 * n], rest[2 * n:]
        dy, s = samlp_train.bwd_seed(a_list[-1], vecs[-1], dout, amax, k=k,
                                     impl=impl, operand_dtype=odt)
        grads = [None] * n
        for i in range(n - 1, -1, -1):
            first = i == 0
            w = weights[i]
            dy_prev, dw, db, s_prev = samlp_train.bwd_layer(
                dy, a_list[i], g2 if first else a_list[i - 1],
                None if ctx.kernel else w, vecs[i], s,
                None if first else vecs[i - 1], impl=impl,
                operand_dtype=odt,
                need_dprev=not first or ctx.needs_input_grad[0],
                w_packed=w if ctx.kernel else None)
            grads[i] = (dw, db, s[1], s[0])
            dy, s = dy_prev, s_prev
        flat = [g for layer in grads for g in layer]
        return (dy, None, None, None, None, *flat)


def fused_mlp_max(grouped: torch.Tensor, params, running, *,
                  train: bool = False, momentum: float = 0.9,
                  eps: float = 1e-5, impl: str | None = None,
                  operand_dtype: torch.dtype | None = None):
    """Fused Dense→BN→ReLU stack + max over the K axis.

    Args:
      grouped: ``[B, S, K, C0]`` neighbourhoods.
      params: per layer ``(W [Cin, Cout], b, gamma, beta)``.
      running: per layer ``(mean, var)`` running statistics.
      train: batch statistics and a differentiable result (the stream
        passes), else the running statistics (the fused eval pass).
      momentum: flax's: ``running ← momentum·running + (1-momentum)·batch``.
      impl: ``None`` (kernel on CUDA, plain on the CPU) or ``"plain"``;
        defaults to the active :class:`override`.
      operand_dtype: the matrix products' operand type, bf16 unless an
        :class:`override` or the caller says f32 (plain version only).

    Returns:
      eval: ``[B, S, C_last]`` f32. train: ``(out [B, S, C_last] f32,
      new_running)``, the updated ``(mean, var)`` per layer computed
      without gradient, for the caller to store.
    """
    impl = _OVERRIDE["impl"] if impl is None else impl
    if operand_dtype is None:
        operand_dtype = _OVERRIDE["operand_dtype"]
    b, s, k, c0 = grouped.shape
    if train:
        if not params:
            raise ValueError("fused_mlp_max needs at least one layer")
        flat = [t for p in params for t in p]
        out2, *stats = _FusedTrain.apply(
            grouped.reshape(b * s * k, c0).float(), k, float(eps), impl,
            operand_dtype, *flat)
        n = len(params)
        with torch.no_grad():
            new_running = [
                (momentum * rm + (1.0 - momentum) * mean,
                 momentum * rv + (1.0 - momentum) * var)
                for (rm, rv), mean, var in zip(running, stats[:n], stats[n:])
            ]
        return out2.reshape(b, s, -1), new_running
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
