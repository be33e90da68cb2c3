"""Fused grouped Dense→BN→ReLU stack + max over K.

Counterpart of ``papc_tpu/ops/fused_mlp.py::fused_mlp_max``, in its three
training modes, ``"stream"`` (the default), ``"recompute"`` and
``"recompute1"``.

- Eval: BatchNorm with running statistics is a constant affine, folded
  into ``(scale, shift) = (γ·rsqrt(var + eps), β - mean·scale)``, and the
  whole stack plus the max runs as one pass (``ops/kernels/samlp.py``,
  whose ``eval_mlp_max_plain`` is the twin of the JAX ``_jnp_eval_mlp_max``).
  The mode does not change it.
- Train, stream mode: one ``linear_stats`` pass per layer and
  ``finalize_max`` forward; ``bwd_seed`` and one ``bwd_layer`` pass per
  layer backward (``ops/kernels/samlp_train.py``), behind one
  ``torch.autograd.Function``, the counterpart of ``_make_core``'s custom
  VJP. Pre-activations are stored in the operand dtype between passes.
- Train, recompute mode: every pass re-derives the chain from the block
  input (``ops/kernels/samlp_recompute.py``): one stats pass per layer and
  a final max forward, one bwd-stats pass per layer and a bwd-final pass
  backward. Nothing of ``M`` rows but the block input is kept for the
  backward, and no pre-activation is rounded.
- Train, recompute1 mode: the same passes, each as one persistent launch
  (``ops/kernels/samlp_single.py``), on the stacks its gate admits; a
  stack it does not admit (the ``group_all`` ones) demotes to stream mode
  with a warning, as in JAX (:func:`effective_mode`).

bf16 parameters and a bf16 grouped tensor (the bf16 training step) go in
as they are: the products round their operands to bf16 anyway, a bias
is widened exactly, the BN vectors are f32 from the bf16 γ and β
(``_bn_vectors``), the output is cast to the grouped tensor's dtype
(``papc_tpu/ops/fused_mlp.py:489``) and autograd casts each parameter's
f32 gradient to its dtype (JAX's ``core_bwd`` casts, ``:396-407``).

Every training mode has the JAX one's gradient semantics: the analytic
BatchNorm backward with batch statistics as functions of the input, the
max's cotangent routed to the FIRST argmax (``torch.amax``'s autograd
would split ties), no gradient through the batch mean and variance, which
only feed the running update (flax's ``0.9·running + 0.1·batch``, biased
variance).
"""

from __future__ import annotations

import logging

import torch

from papc_tpu_torch.ops.kernels import (samlp, samlp_recompute,
                                        samlp_single, samlp_train,
                                        use_kernel)

_logger = logging.getLogger(__name__)

MODES = ("stream", "recompute", "recompute1")

# ``with override(impl="plain", operand_dtype=torch.float32,
# mode="recompute")`` changes the defaults of fused_mlp_max for a test or
# a run, as the JAX package's ``fused_mlp.override`` does. Arguments passed
# explicitly win. Entering an override sets EVERY key, to the defaults
# where it is not given: an inner ``override(impl="plain")`` puts an outer
# ``mode="recompute"`` back to stream, so give all keys in one call.
_OVERRIDE = {"impl": None, "operand_dtype": torch.bfloat16, "mode": "stream"}


class override:
    def __init__(self, impl: str | None = None,
                 operand_dtype: torch.dtype = torch.bfloat16,
                 mode: str = "stream"):
        self._new = {"impl": impl, "operand_dtype": operand_dtype,
                     "mode": mode}

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
    or bf16 (the grouped rows): ``forward(x, k, eps, impl, operand_dtype,
    W0, b0, γ0, β0, W1, ...)`` → ``(out [M/k, C_last] f32, mean_0, ...,
    var_0, ...)``, the batch statistics marked non-differentiable.

    ``x`` is cast to the operand dtype inside (``g2``, as
    ``fused_mlp.py:448`` does), so the gradient of an f32 ``x`` comes back
    in f32 and unrounded. The gradients are computed in f32; autograd
    casts each to its input's dtype (bf16 for the bf16 step's ``x`` and
    parameters, as JAX's ``core_bwd`` casts them). Saved for the backward: ``g2``, every layer's stored
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


def _recompute_passes(mode: str):
    """The four recompute passes of ``mode`` (stats, final, bwd stats, bwd
    final), looked up when called: ``"recompute"`` the grid passes (#11-14),
    ``"recompute1"`` the single-launch ones (#15-18), as the JAX package's
    ``_rc_module(single)``. Both take the same arguments and compute the
    same function."""
    if mode == "recompute1":
        return (samlp_single.rc1_stats, samlp_single.rc1_final,
                samlp_single.rc1_bwd_stats, samlp_single.rc1_bwd_final)
    return (samlp_recompute.rc_stats, samlp_recompute.rc_final,
            samlp_recompute.rc_bwd_stats, samlp_recompute.rc_bwd_final)


class _FusedRecompute(torch.autograd.Function):
    """Recompute-mode training forward and backward, the counterpart of
    ``_make_core(mode="recompute" | "recompute1")``: ``forward(x, k, eps,
    impl, operand_dtype, mode, W0, b0, γ0, β0, W1, ...)``, otherwise the
    arguments and outputs of :class:`_FusedTrain`; ``mode`` picks the
    passes (:func:`_recompute_passes`).

    Forward: one stats pass per layer (layer ``l`` re-derives ``a_1 ..
    a_l`` from ``g2`` with the ``l-1`` BN affines known so far), then the
    final max pass. Backward: one bwd-stats pass per layer from the top
    down (each needs the gradient means ``mus`` of the layers above it),
    then the bwd-final pass for ``dW``, ``db`` and, when
    ``needs_input_grad[0]``, the block input's gradient. Saved for the
    backward: ``g2``, the argmax, the ``[4, C]`` BN vectors, the weights
    and biases and, on the kernel path, the bf16 weights packed once in the
    forward; no tensor of ``M`` rows but ``g2`` (as
    ``papc_tpu/ops/fused_mlp.py:727``).
    """

    @staticmethod
    def forward(ctx, x, k, eps, impl, operand_dtype, mode, *flat):
        params = [flat[i:i + 4] for i in range(0, len(flat), 4)]
        n, m = len(params), x.shape[0]
        stats_pass, final_pass, _, _ = _recompute_passes(mode)
        kernel = use_kernel(x, impl)
        g2 = x.to(operand_dtype)
        ws = [p[0] for p in params]
        bs = [p[1] for p in params]
        packed = [samlp_train.pack_weight(w) for w in ws] if kernel else None
        opts = {"impl": impl, "operand_dtype": operand_dtype,
                "w_packed": packed}
        vecs, means, vars_ = [], [], []
        for upto, (_, _, gamma, beta) in enumerate(params, start=1):
            sums = stats_pass(g2, vecs, ws, bs, upto=upto, **opts)
            vec, (mean, var) = samlp_train.bn_vectors(sums, gamma, beta, m,
                                                      eps)
            vecs.append(vec)
            means.append(mean)
            vars_.append(var)
        out, amax = final_pass(g2, vecs, ws, bs, k=k, **opts)
        ctx.save_for_backward(g2, amax, *vecs, *ws, *bs,
                              *(packed if kernel else ()))
        ctx.n, ctx.k, ctx.impl, ctx.mode = n, k, impl, mode
        ctx.operand_dtype, ctx.kernel = operand_dtype, kernel
        ctx.mark_non_differentiable(*means, *vars_)
        return (out, *means, *vars_)

    @staticmethod
    def backward(ctx, dout, *_stats):
        n, k = ctx.n, ctx.k
        _, _, bwd_stats_pass, bwd_final_pass = _recompute_passes(ctx.mode)
        g2, amax, *rest = ctx.saved_tensors
        vecs, ws, bs = rest[:n], rest[n:2 * n], rest[2 * n:3 * n]
        opts = {"impl": ctx.impl, "operand_dtype": ctx.operand_dtype,
                "w_packed": list(rest[3 * n:]) if ctx.kernel else None}
        m = g2.shape[0]
        mus, s_list = [None] * n, [None] * n
        for level in range(n, 0, -1):
            s = bwd_stats_pass(g2, dout, amax, vecs, ws, bs, mus,
                               level=level, k=k, **opts)
            s_list[level - 1] = s
            mus[level - 1] = s / m
        dg, dws, dbs = bwd_final_pass(
            g2, dout, amax, vecs, ws, bs, mus, k=k,
            need_dg=ctx.needs_input_grad[0], **opts)
        flat = [g for j in range(n)
                for g in (dws[j], dbs[j], s_list[j][1], s_list[j][0])]
        return (dg, None, None, None, None, None, *flat)


def effective_mode(mode: str, m: int, k: int, c0: int, widths) -> str:
    """The training mode one stack of ``m`` grouped rows (groups of ``k``,
    ``c0`` input channels, layer ``widths``) actually runs: ``recompute1``
    demotes to ``stream`` where the single-launch passes have no plan
    within the card's shared memory (``samlp_single.fits``: the
    ``group_all`` stacks, whose resident bf16 weights alone exceed it).
    A/B harnesses query this to report which stacks ran the labelled
    mode (``papc_tpu/ops/fused_mlp.py:126``)."""
    if mode == "recompute1" and not samlp_single.fits(m, k, c0, widths):
        return "stream"
    return mode


_DEMOTED: set = set()  # the stack shapes whose demotion was logged


def _demote(mode: str, m: int, k: int, c0: int, widths) -> str:
    """:func:`effective_mode`, with JAX's warning once per stack shape (JAX
    warns once per trace of a stack)."""
    eff = effective_mode(mode, m, k, c0, widths)
    if eff != mode and (m, k, c0, tuple(widths)) not in _DEMOTED:
        _DEMOTED.add((m, k, c0, tuple(widths)))
        _logger.warning(
            "fused_mlp: recompute1 demoted to stream for layer stack m=%d "
            "k=%d c0=%d widths=%s (fails samlp_single.fits) — A/Bs labeled "
            "recompute1 run stream for this stack", m, k, c0, list(widths))
    return eff


def fused_mlp_max(grouped: torch.Tensor, params, running, *,
                  train: bool = False, momentum: float = 0.9,
                  eps: float = 1e-5, impl: str | None = None,
                  operand_dtype: torch.dtype | None = None,
                  mode: str | None = None):
    """Fused Dense→BN→ReLU stack + max over the K axis.

    Args:
      grouped: ``[B, S, K, C0]`` neighbourhoods, f32 or bf16.
      params: per layer ``(W [Cin, Cout], b, gamma, beta)``, f32 or bf16.
      running: per layer ``(mean, var)`` running statistics.
      train: batch statistics and a differentiable result (the passes
        of ``mode``), else the running statistics (the fused eval pass).
      momentum: flax's: ``running ← momentum·running + (1-momentum)·batch``.
      impl: ``None`` (kernel on CUDA, plain on the CPU) or ``"plain"``;
        defaults to the active :class:`override`.
      operand_dtype: the matrix products' operand type, bf16 unless an
        :class:`override` or the caller says f32 (plain version only).
      mode: the training passes, ``"stream"``, ``"recompute"`` or
        ``"recompute1"``; defaults to the active :class:`override`'s
        (``"stream"``). ``"recompute1"`` runs stream mode on a stack that
        :func:`effective_mode` demotes, and logs it once per stack shape.

    Returns:
      eval: ``[B, S, C_last]``. train: ``(out [B, S, C_last],
      new_running)``, the updated ``(mean, var)`` per layer computed
      without gradient (f32), for the caller to store. ``out`` is in
      ``grouped``'s dtype, computed in f32.
    """
    impl = _OVERRIDE["impl"] if impl is None else impl
    if operand_dtype is None:
        operand_dtype = _OVERRIDE["operand_dtype"]
    mode = _OVERRIDE["mode"] if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, s, k, c0 = grouped.shape
    if train:
        if not params:
            raise ValueError("fused_mlp_max needs at least one layer")
        flat = [t for p in params for t in p]
        x = grouped.reshape(b * s * k, c0)
        if x.dtype != torch.bfloat16:  # a bf16 x goes in without a copy
            x = x.float()
        mode = _demote(mode, x.shape[0], k, c0,
                       [p[0].shape[1] for p in params])
        if mode == "stream":
            out2, *stats = _FusedTrain.apply(x, k, float(eps), impl,
                                             operand_dtype, *flat)
        else:
            out2, *stats = _FusedRecompute.apply(x, k, float(eps), impl,
                                                 operand_dtype, mode, *flat)
        n = len(params)
        with torch.no_grad():
            new_running = [
                (momentum * rm + (1.0 - momentum) * mean,
                 momentum * rv + (1.0 - momentum) * var)
                for (rm, rv), mean, var in zip(running, stats[:n], stats[n:])
            ]
        return out2.reshape(b, s, -1).to(grouped.dtype), new_running
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
    return out2.reshape(b, s, -1).to(grouped.dtype)
