"""The port's training path against the JAX package, on the CPU.

Inputs are numpy arrays from one seed, handed to both packages in the
same process. The JAX side runs as its own suite runs on the CPU: the
jnp twins of the stream passes (``papc_tpu/ops/fused_mlp.py``), the
Pallas kernels with ``interpret=True``, and ``make_train_step`` on the
classic flax path or under ``fused_mlp.override(enable=True,
impl="jnp")``. The port runs its plain versions (no card here).

Tolerances, stated at each test:
- f32 operands: the same arithmetic up to f32 summation order, 1e-5.
- bf16 operands: stored activations within one bf16 ulp (a sum taken in
  another order can round to the neighbouring bf16 value), f32 sums
  within 1e-4 of the vector's largest magnitude, ``amax`` and the
  routed ``dy`` exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn

from papc_tpu.models.classify import PointNet2SSGClas as JaxSSG
from papc_tpu.ops import fused_mlp as jfused
from papc_tpu.ops import geometry as jgeom
from papc_tpu.ops.pallas import samlp as jsamlp
from papc_tpu.ops.pallas.gather_t import gather_cols
from papc_tpu.train import trainer as jtrainer

from papc_tpu_torch import __main__ as cli
from papc_tpu_torch.convert import load_flax_weights, state_dict_to_flax
from papc_tpu_torch.data import SyntheticLoader
from papc_tpu_torch.models.classify import PointNet2SSGClas
from papc_tpu_torch.nn import BN_EPS, BN_MOMENTUM, BatchNorm, MLPHead
from papc_tpu_torch.ops import fused_mlp
from papc_tpu_torch.ops.kernels import gather, samlp_train
from papc_tpu_torch.train import evaluate, make_optimizer, train

from tests import torch_parity as P

T = torch.from_numpy
F32, BF16 = torch.float32, torch.bfloat16
J_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(x):
    """``x`` rounded to bf16, as a writable f32 numpy array."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _within_bf16_ulp(got, want):
    """|got - want| ≤ one bf16 ulp of ``want`` (zero allowed exactly)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.where(want == 0, 0.0,
                   2.0 ** (np.floor(np.log2(np.abs(want) + 1e-38)) - 7))
    err = np.abs(got - want)
    assert (err <= ulp).all(), (float(err.max()), int((err > ulp).sum()))


def _close_to_max(got, want, rel, scale=0.0):
    """Each entry within ``rel`` of the largest magnitude of ``want`` (or
    of ``scale``, for a tensor that is rounding noise around 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rel * max(float(np.abs(want).max()), scale, 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _vec4(rng, c):
    """(scale, shift, mean, inv_std) rows as a BN layer would give them."""
    return np.stack([1 + 0.3 * rng.randn(c), 0.2 * rng.randn(c),
                     0.1 * rng.randn(c), rng.uniform(0.5, 2.0, c)]
                    ).astype(np.float32)


# --------------------------------------------------------- single passes

LINEAR_CASES = [(256, 3, 64, False), (96, 20, 48, True),
                (128, 131, 128, False)]


@pytest.mark.parametrize("m,cin,cout,pre", LINEAR_CASES)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_linear_stats_matches_twin_and_pallas(rng, m, cin, cout, pre, dtype):
    x = rng.randn(m, cin).astype(np.float32)
    if dtype == BF16:
        x = _bf16(x)  # a stored pre-activation (or g2) is bf16
    w = (rng.randn(cin, cout) / np.sqrt(cin)).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    vec = _vec4(rng, cin) if pre else None
    got_a, got_s = samlp_train.linear_stats_plain(
        T(x), None if vec is None else T(vec), T(w), T(b),
        operand_dtype=dtype)
    assert got_a.dtype == dtype and got_s.shape == (2, cout)
    jx = jnp.asarray(x).astype(J_DTYPE[dtype])
    jvec = None if vec is None else jnp.asarray(vec[:2])
    want_a, want_s = jfused._jnp_linear_stats(
        jx, jvec, jnp.asarray(w), jnp.asarray(b), sdtype=J_DTYPE[dtype])
    if dtype == F32:
        np.testing.assert_allclose(got_a.numpy(), _np(want_a), rtol=1e-5,
                                   atol=1e-5)
        _close_to_max(got_s.numpy(), _np(want_s), 1e-5)
        return
    _within_bf16_ulp(got_a.float().numpy(), _np(want_a))
    _close_to_max(got_s.numpy(), _np(want_s), 1e-4)
    pl_a, pl_s = jsamlp.linear_stats(jx, jvec, jnp.asarray(w),
                                     jnp.asarray(b), interpret=True)
    _within_bf16_ulp(got_a.float().numpy(), _np(pl_a))
    _close_to_max(got_s.numpy(), _np(pl_s), 1e-4)


@pytest.mark.parametrize("groups,k,c", [(16, 8, 16), (8, 32, 40), (8, 128, 24)])
def test_finalize_max_matches_twin_and_pallas(rng, groups, k, c):
    """``amax`` exact: the first index attaining the max (a column of
    zeros after the ReLU makes many ties; so do the duplicated rows
    below). The max within one f32 ulp of the largest: XLA on the CPU
    contracts ``a·scale + shift`` into an FMA, which the port (and its
    kernel) round as two operations."""
    a = _bf16(rng.randn(groups * k, c))
    a[1::k] = a[0::k]  # ties inside each group
    vec = _vec4(rng, c)
    got, amax = samlp_train.finalize_max_plain(T(a).to(BF16), T(vec[:2]), k=k)
    want, want_amax = jfused._jnp_finalize_max(
        jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(vec[:2]), k=k)
    _close_to_max(got.numpy(), _np(want), 2.4e-7)
    np.testing.assert_array_equal(amax.numpy(), np.asarray(want_amax))
    pl, pl_amax = jsamlp.finalize_max(jnp.asarray(a).astype(jnp.bfloat16),
                                      jnp.asarray(vec[:2]), k=k,
                                      interpret=True)
    _close_to_max(got.numpy(), _np(pl), 2.4e-7)
    np.testing.assert_array_equal(amax.numpy(), np.asarray(pl_amax))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_bwd_seed_matches_twin_and_pallas(rng, dtype):
    """dy exact (one routed element a column, gated); the sums within
    1e-5 (f32) / 1e-4 (bf16) of their largest magnitude."""
    groups, k, c = 16, 8, 32
    a = _bf16(rng.randn(groups * k, c))
    vec = _vec4(rng, c)
    _, amax = samlp_train.finalize_max_plain(T(a).to(BF16), T(vec), k=k)
    dout = rng.randn(groups, c).astype(np.float32)
    ja = jnp.asarray(a).astype(J_DTYPE[dtype])
    got_dy, got_s = samlp_train.bwd_seed_plain(
        T(a).to(dtype), T(vec), T(dout), amax, k=k, operand_dtype=dtype)
    want_dy, want_s = jfused._jnp_bwd_seed(
        ja, jnp.asarray(vec), jnp.asarray(dout), jnp.asarray(amax.numpy()),
        k=k, sdtype=J_DTYPE[dtype])
    np.testing.assert_array_equal(got_dy.float().numpy(), _np(want_dy))
    rel = 1e-5 if dtype == F32 else 1e-4
    _close_to_max(got_s.numpy(), _np(want_s), rel)
    if dtype == BF16:
        pl_dy, pl_s = jsamlp.bwd_seed(ja, jnp.asarray(vec), jnp.asarray(dout),
                                      jnp.asarray(amax.numpy()), k=k,
                                      interpret=True)
        np.testing.assert_array_equal(got_dy.float().numpy(), _np(pl_dy))
        _close_to_max(got_s.numpy(), _np(pl_s), 1e-4)


@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_bwd_layer_matches_twin_and_pallas(rng, first, dtype):
    """f32: every output within 1e-5 of its largest magnitude. bf16
    against the twin: dy_prev within one bf16 ulp, dW/db/dg/sums within
    1e-4. Against the Pallas kernel, which forms ``x̂·(s₁/M)`` where the
    twin forms ``(x̂·s₁)/M``, ``da`` can round to the other bf16
    neighbour, so dy_prev is held within 1e-2 of its largest magnitude
    and the f32 outputs within 1e-3."""
    m, cin, cout = 256, (5 if first else 24), 16
    cast = _bf16 if dtype == BF16 else (lambda v: v.astype(np.float32))
    dy = cast(rng.randn(m, cout))
    a = cast(rng.randn(m, cout))
    a_prev = cast(rng.randn(m, cin))
    w = (rng.randn(cin, cout) / np.sqrt(cin)).astype(np.float32)
    vec = _vec4(rng, cout)
    s_in = (rng.randn(2, cout) * 8).astype(np.float32)
    vec_prev = None if first else _vec4(rng, cin)
    got = samlp_train.bwd_layer_plain(
        T(dy).to(dtype), T(a).to(dtype), T(a_prev).to(dtype), T(w), T(vec),
        T(s_in), None if first else T(vec_prev), operand_dtype=dtype)
    jargs = (jnp.asarray(dy).astype(J_DTYPE[dtype]),
             jnp.asarray(a).astype(J_DTYPE[dtype]),
             jnp.asarray(a_prev).astype(J_DTYPE[dtype]), jnp.asarray(w),
             jnp.asarray(vec), jnp.asarray(s_in),
             None if first else jnp.asarray(vec_prev))
    want = jfused._jnp_bwd_layer(*jargs, sdtype=J_DTYPE[dtype])
    names = ("dprev", "dw", "db", "s")
    for name, g, wv in zip(names, got, want):
        if g is None:
            assert wv is None and name == "s"
            continue
        g, wv = g.float().numpy().reshape(-1), _np(wv).reshape(-1)
        if dtype == F32:
            _close_to_max(g, wv, 1e-5)
        elif name == "dprev" and not first:
            _within_bf16_ulp(g, wv)
        else:
            _close_to_max(g, wv, 1e-4)
    if dtype == BF16:
        pl = jsamlp.bwd_layer(*jargs, interpret=True)
        for name, g, wv in zip(names, got, pl):
            if g is None:
                continue
            rel = 1e-2 if name == "dprev" and not first else 1e-3
            _close_to_max(g.float().numpy().reshape(-1),
                          _np(wv).reshape(-1), rel)


def test_bwd_layer_can_skip_the_input_gradient(rng):
    args = [T(rng.randn(64, 8).astype(np.float32)) for _ in range(2)]
    a_prev = T(rng.randn(64, 3).astype(np.float32))
    w, vec = T(rng.randn(3, 8).astype(np.float32)), T(_vec4(rng, 8))
    s_in = T(rng.randn(2, 8).astype(np.float32))
    full = samlp_train.bwd_layer_plain(*args, a_prev, w, vec, s_in, None,
                                       operand_dtype=F32)
    skip = samlp_train.bwd_layer_plain(*args, a_prev, w, vec, s_in, None,
                                       operand_dtype=F32, need_dprev=False)
    assert skip[0] is None and skip[3] is None
    torch.testing.assert_close(skip[1], full[1], rtol=0, atol=0)
    torch.testing.assert_close(skip[2], full[2], rtol=0, atol=0)


# ------------------------------------------------ the fused Function

def _stack(rng, c0, widths):
    layers, cin = [], c0
    for c in widths:
        layers.append(((rng.randn(cin, c) / np.sqrt(cin)).astype(np.float32),
                       (0.1 * rng.randn(c)).astype(np.float32),
                       (1 + 0.2 * rng.randn(c)).astype(np.float32),
                       (0.1 * rng.randn(c)).astype(np.float32)))
        cin = c
    running = [((0.1 * rng.randn(c)).astype(np.float32),
                rng.uniform(0.5, 2.0, c).astype(np.float32)) for c in widths]
    return layers, running


def _fused_pair(rng, dtype, shape=(2, 16, 8, 6), widths=(32, 16, 24)):
    """The port's and JAX's fused training stack on the same inputs and
    cotangent: (port outputs, JAX outputs), each
    ``(out, new_running, dg, [(dW, db, dγ, dβ)])``."""
    g = (rng.randn(*shape) + 0.5).astype(np.float32)
    layers, running = _stack(rng, shape[-1], widths)
    cot = rng.randn(*shape[:2], widths[-1]).astype(np.float32)

    gt = T(g).requires_grad_()
    params = [tuple(T(p).requires_grad_() for p in layer) for layer in layers]
    out, new_running = fused_mlp.fused_mlp_max(
        gt, params, [(T(m), T(v)) for m, v in running], train=True,
        impl="plain", operand_dtype=dtype)
    (out * T(cot)).sum().backward()
    port = (out.detach().numpy(), [(m.numpy(), v.numpy())
                                   for m, v in new_running],
            gt.grad.numpy(), [[p.grad.numpy() for p in layer]
                              for layer in params])

    jrun = tuple((jnp.asarray(m), jnp.asarray(v)) for m, v in running)

    def loss(gj, pj):
        o, nr = jfused.fused_mlp_max(gj, pj, jrun, train=True, impl="jnp",
                                     sdtype=J_DTYPE[dtype])
        return jnp.sum(o * jnp.asarray(cot)), (o, nr)

    jp = tuple(tuple(jnp.asarray(p) for p in layer) for layer in layers)
    (_, (o, nr)), (dg, dp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(g), jp)
    want = (_np(o), [(_np(m), _np(v)) for m, v in nr], _np(dg),
            [[_np(p) for p in layer] for layer in dp])
    return port, want


def _compare_fused(port, want, rel_out, rel_grad):
    """Gradients against the largest of their layer's: ``db`` feeds a BN,
    so its true value is 0 and what both sides hold is rounding noise."""
    _close_to_max(port[0], want[0], rel_out)
    for (m, v), (wm, wv) in zip(port[1], want[1]):
        _close_to_max(m, wm, rel_out)
        _close_to_max(v, wv, rel_out)
    _close_to_max(port[2], want[2], rel_grad)
    for layer, wlayer in zip(port[3], want[3]):
        scale = max(float(np.abs(wg).max()) for wg in wlayer)
        for g, wg in zip(layer, wlayer):
            _close_to_max(g, wg, rel_grad, scale)


def test_fused_train_f32_matches_jax_fused_jnp(rng):
    """f32 operands on both sides: outputs and new running statistics
    within 1e-5, every gradient (dg, dW, db, dγ, dβ) within 1e-4 of the
    largest magnitude of its layer's (the BN backward subtracts sums of
    M terms)."""
    port, want = _fused_pair(rng, F32)
    _compare_fused(port, want, 1e-5, 1e-4)


def test_fused_train_bf16_matches_jax_fused_jnp(rng):
    """bf16 operands and storage on both sides. A product summed in
    another order can round a stored activation to its other bf16
    neighbour and carry that into the later layers and the backward:
    outputs and statistics within 1e-2, gradients within 2e-2 of the
    largest magnitude of their layer's."""
    port, want = _fused_pair(rng, BF16)
    _compare_fused(port, want, 1e-2, 2e-2)


def test_fused_train_gradcheck_in_float64():
    """The Function's backward is the derivative of its forward: the
    plain passes in float64 (operands and storage) under gradcheck."""
    rng = np.random.RandomState(3)
    k, widths = 4, (5, 3)
    x = torch.tensor(rng.randn(3 * k, 2) + 0.3, dtype=torch.float64,
                     requires_grad=True)
    flat = []
    cin = 2
    for c in widths:
        flat += [torch.tensor(rng.randn(cin, c), dtype=torch.float64),
                 torch.tensor(0.1 * rng.randn(c), dtype=torch.float64),
                 torch.tensor(1 + 0.2 * rng.randn(c), dtype=torch.float64),
                 torch.tensor(0.1 * rng.randn(c), dtype=torch.float64)]
        cin = c
    flat = [t.requires_grad_() for t in flat]

    def f(x, *flat):
        return fused_mlp._FusedTrain.apply(x, k, 1e-5, "plain",
                                           torch.float64, *flat)[0]

    assert torch.autograd.gradcheck(f, (x, *flat), eps=1e-6, atol=1e-5,
                                    rtol=1e-4)


def test_fused_train_skips_the_input_gradient_of_data():
    """``needs_input_grad``: a grouped input that is data (SA1's) gets no
    gradient and its product is not computed; the parameters still do."""
    rng = np.random.RandomState(4)
    layers, running = _stack(rng, 3, (8, 8))
    params = [tuple(T(p).requires_grad_() for p in layer) for layer in layers]
    calls = []
    real = samlp_train.bwd_layer

    def spy(*args, **kw):
        calls.append(kw["need_dprev"])
        return real(*args, **kw)

    samlp_train.bwd_layer = spy
    try:
        out, _ = fused_mlp.fused_mlp_max(
            T(rng.randn(1, 4, 8, 3).astype(np.float32)), params,
            [(T(m), T(v)) for m, v in running], train=True, impl="plain")
        out.sum().backward()
    finally:
        samlp_train.bwd_layer = real
    assert calls == [True, False]
    assert all(p.grad is not None for layer in params for p in layer)


# ------------------------------------------------- gather's backward

def test_group_gather_backward_matches_jax(rng):
    """The Function's backward against ``gather_cols``' VJP (the Pallas
    ``scatter_cols_add_pallas``, interpreted) and against ``jax.vjp`` of
    the row path ``index_points`` + centring (``grouping.py:160-165``):
    gradients of xyz, points and new_xyz within 1e-5 (sums in another
    order; the Pallas one through a three-plane bf16 split)."""
    B, N, D, S, K = 2, 40, 5, 6, 8
    xyz = rng.randn(B, N, 3).astype(np.float32)
    pts = rng.randn(B, N, D).astype(np.float32)
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    new_xyz = rng.randn(B, S, 3).astype(np.float32)
    g = rng.randn(B, S, K, 3 + D).astype(np.float32)

    tx, tp, tn = (T(v).requires_grad_() for v in (xyz, pts, new_xyz))
    out = gather.group_gather(tx, tp, T(idx), tn)
    out.backward(T(g))

    def row_path(x, p, c):
        grouped = jgeom.index_points(jnp.concatenate([x, p], -1),
                                     jnp.asarray(idx))
        return grouped.at[..., :3].add(-c[:, :, None, :])

    want_out, vjp = jax.vjp(row_path, jnp.asarray(xyz), jnp.asarray(pts),
                            jnp.asarray(new_xyz))
    np.testing.assert_array_equal(out.detach().numpy(), _np(want_out))
    for got, want in zip((tx.grad, tp.grad, tn.grad), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)

    src_t = jnp.asarray(np.concatenate([xyz, pts], -1).transpose(0, 2, 1))
    _, vjp_t = jax.vjp(lambda s: gather_cols(s, jnp.asarray(idx),
                                             interpret=True), src_t)
    (dsrc,) = vjp_t(jnp.asarray(g.reshape(B, S * K, 3 + D).transpose(0, 2, 1)))
    got = gather.scatter_add_plain(T(g), T(idx), N).numpy()
    np.testing.assert_allclose(got, _np(dsrc).transpose(0, 2, 1), rtol=1e-5,
                               atol=1e-5)


def test_scatter_add_clamps_like_the_forward():
    g = torch.ones(1, 1, 4, 2)
    idx = torch.tensor([[[-3, 0, 9, 2]]], dtype=torch.int32)
    out = gather.scatter_add_plain(g, idx, 3)
    assert out[0, :, 0].tolist() == [2.0, 0.0, 2.0]


# ------------------------------------------------------- BN and head

def test_batchnorm_train_matches_flax(rng):
    """Output, gradients and the updated running mean/var against
    ``flax.linen.BatchNorm(use_running_average=False, momentum=0.9)``,
    on inputs with a mean far from 0 and few rows, where torch's own
    convention (unbiased variance, momentum 0.1 meaning the batch's
    weight) would be visibly off. Within 1e-5."""
    x = (3.0 + 2.0 * rng.randn(6, 7)).astype(np.float32)
    w = rng.randn(6, 7).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=BN_MOMENTUM,
                        epsilon=BN_EPS)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"scale": jnp.asarray(rng.uniform(0.5, 2, 7),
                                                 jnp.float32),
                            "bias": jnp.asarray(rng.randn(7), jnp.float32)},
                 "batch_stats": {"mean": jnp.asarray(rng.randn(7),
                                                     jnp.float32),
                                 "var": jnp.asarray(rng.uniform(0.5, 2, 7),
                                                    jnp.float32)}}

    def loss(params, xx):
        y, upd = jbn.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w)), (y, upd["batch_stats"])

    (_, (want_y, want_stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    bn = BatchNorm(7).train()
    load_flax_weights(bn, jax.tree_util.tree_map(np.asarray, variables))
    xt = T(x).requires_grad_()
    y = bn(xt)
    (y * T(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), _np(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               _np(want_stats["mean"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               _np(want_stats["var"]), rtol=1e-5, atol=1e-5)
    for got, want in [(xt.grad, gx), (bn.weight.grad, gp["scale"]),
                      (bn.bias.grad, gp["bias"])]:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4,
                                   atol=1e-4)
    # torch's convention would store the unbiased variance at the batch's
    # weight 0.1: a different number at six rows
    unbiased = 0.9 * _np(variables["batch_stats"]["var"]) + 0.1 * x.var(
        0, ddof=1)
    assert np.abs(bn.running_var.numpy() - unbiased).max() > 1e-2


def test_head_dropout_masks_and_generator(rng):
    """flax's Dropout arithmetic (``where(keep, x / 0.6, 0)``) from given
    masks; from a generator the keep rate is about 0.6; eval drops
    nothing; training without either raises."""
    head = MLPHead(8, (6, 4), 3, bn=True, dropout_rate=0.4,
                   per_layer_dropout=True).train()
    assert head.dropout_sites() == 2
    x = T(rng.randn(5, 8).astype(np.float32))
    ones = [torch.ones(5, 6, dtype=torch.bool),
            torch.ones(5, 4, dtype=torch.bool)]
    zeros = [torch.zeros(5, 6, dtype=torch.bool), ones[1]]
    out_zero = head(x, masks=zeros)
    # every hidden unit dropped: the output is the last bias after BN
    torch.testing.assert_close(out_zero, head.Dense_2(
        torch.relu(head.BatchNorm_1(head.Dense_1(torch.zeros(5, 6)))) / 0.6))
    with pytest.raises(ValueError, match="Generator"):
        head(x)
    with pytest.raises(ValueError, match="masks"):
        head(x, masks=ones[:1])
    from papc_tpu_torch.nn.layers import dropout

    kept = dropout(torch.ones(200, 100), 0.4, None,
                   torch.Generator().manual_seed(0))
    assert set(kept.unique().tolist()) <= {0.0, float(torch.tensor(1 / 0.6))}
    assert abs(float((kept > 0).float().mean()) - 0.6) < 0.01
    head.eval()
    torch.testing.assert_close(head(x), head(x, masks=zeros))


# ----------------------------------------------- one whole train step

def _masks(B, seed):
    rs = np.random.RandomState(seed)
    return [rs.uniform(size=(B, 512)) < 0.6, rs.uniform(size=(B, 256)) < 0.6]


def _step_case(B, N, npoints, nsamples, seed):
    b = P.batch(B, N, seed=seed)
    jmodel = JaxSSG(num_classes=16, npoints=npoints, nsamples=nsamples)
    variables = P.perturbed_variables(jmodel, "clas", b, seed)

    def make():
        return PointNet2SSGClas(num_classes=16, npoints=npoints,
                                nsamples=nsamples)

    return b, jmodel, variables, _masks(B, seed + 1), make


def test_train_step_f32_matches_jax_classic_step():
    """(a) Port with f32 operands vs ``make_train_step`` on JAX's default
    CPU path (classic flax Dense/BN/ReLU, autodiff), same weights, running
    statistics and dropout masks. The port routes the max's cotangent to
    the first argmax where autodiff splits ties; the ties are duplicated
    ball-query rows, which the scatter-add sums back onto one point, so
    the two agree to f32 rounding. That rounding is JAX's, mostly: the
    same step of the port in float64 is within 3.3e-5 of the port's f32
    gradients and within 4.6e-4 of JAX's (relative to the largest of
    the tensor). So: loss within 1e-5 relative, BN statistics within
    1e-4, every gradient within 1e-3 of the largest of its module's."""
    lr, wd = 1e-3, 1e-3
    b, jmodel, variables, masks, make = _step_case(4, 128, (32, 16), (8, 16),
                                                   5)
    want = P.jax_step(jmodel, "clas", variables, b, masks, lr, wd,
                      fused=False)
    port = P.port_step(make, variables, b, masks, lr, wd, F32)
    grads, w_grads = P.compare_step(port, want, variables, lr, wd, 1e-5,
                                    1e-4)
    for key, g in grads.items():
        _close_to_max(g, w_grads[key], 1e-3, P.module_scale(w_grads, key))


def test_train_step_bf16_matches_jax_fused_jnp_step():
    """(b) Port with bf16 operands (the card's contract) vs
    ``make_train_step`` under ``fused_mlp.override(enable=True,
    impl="jnp")``: B=32, N=192, npoints (128, 128), nsamples (16, 16), so
    every SA stage (SA3's grouped [32, 1, 128, 259] too) runs the fused
    passes on both sides.

    Each side rounds every stored activation and backward activation to
    bf16, which ties values within a group: the max and its gradient go
    to whichever tied row comes first, and a sum taken in another order
    flips some of those ties. Measured against the same step in float64:
    both sides' gradients are 22-65 % off in relative L2 (JAX's and the
    port's alike, the port's at most 1.08 times as far), and 10-27 % off
    each other; the loss 2.4e-4, the statistics 2.7e-3 relative. So:
    loss within 1e-3, statistics within 5e-3 of the largest, every
    gradient within 0.35 of JAX's in relative L2 and no more than 1.25
    times as far from the float64 step as JAX's is. The Dense biases
    before a BN have a true gradient of 0 and hold the rounding of the
    bf16 x-hat (measured up to 2.6e-2 of their module's largest
    gradient, on both sides): within 5e-2 of that, and no farther from
    the float64 step than 1.25 times JAX's."""
    lr, wd = 1e-3, 1e-3
    b, jmodel, variables, masks, make = _step_case(32, 192, (128, 128),
                                                   (16, 16), 7)
    want = P.jax_step(jmodel, "clas", variables, b, masks, lr, wd,
                      fused=True)
    port = P.port_step(make, variables, b, masks, lr, wd, BF16)
    exact = P.port_step(make, variables, b, masks, lr, wd,
                        torch.float64)[1]
    grads, w_grads = P.compare_step(port, want, variables, lr, wd, 1e-3,
                                    5e-3)
    for key, g in grads.items():
        wg, norm = w_grads[key], np.linalg.norm
        if P.is_noise(key, grads):
            _close_to_max(g, wg, 5e-2, P.module_scale(w_grads, key))
        else:
            assert norm(g - wg) <= 0.35 * norm(wg), key
        assert norm(g - exact[key]) <= 1.25 * norm(wg - exact[key]), key


def test_adam_with_l2_matches_optax_chain(rng):
    """Two steps of ``make_optimizer`` (torch Adam, ``weight_decay`` added
    to the gradient) vs ``optax.chain(add_decayed_weights, adam)`` on the
    same gradients: within 1e-6 (AdamW's decoupled decay would be off by
    lr·wd·p)."""
    lr, wd = 1e-2, 1e-1
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(2)]
    tx = jtrainer.make_optimizer(lr, wd)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    p = torch.nn.Parameter(T(p0.copy()))
    opt = make_optimizer([p], lr, wd)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = T(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), _np(jp), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------- entry points

def test_train_entry_point_writes_weights_that_evaluate_serves(tmp_path):
    """``train`` over a synthetic loader (B=4 x 128 points, 2 epochs of 2
    batches): the JAX trainer's log lines, a finite per-step loss in the
    history, a val pass per epoch, and ``.npz`` weights at epochs 0 and
    1 that ``evaluate`` serves with the trained model's logits."""
    loaders = {"train": SyntheticLoader(8, n_points=128, batchsize=4, seed=1),
               "val": SyntheticLoader(4, n_points=128, batchsize=4, seed=2)}
    logs = []
    model, history = train(max_point=128, epoch_num=2, batchsize=4,
                           info_iter=1, save_iter=1,
                           model_dir=str(tmp_path / "model"),
                           make_loader=loaders.__getitem__, device="cpu",
                           log=logs.append)
    assert [h["epoch"] for h in history] == [0, 1]
    for h in history:
        assert len(h["train_loss"]) == 2
        assert np.isfinite(h["train_loss"]).all() and np.isfinite(h["val_loss"])
        assert 0.0 <= h["val_metric"] <= 1.0
    assert logs[0] == "=" * 35 + "train" + "=" * 43
    assert logs[1].startswith("epoch: 0, batch_id: 0, loss is: [")
    assert "accuracy is: [" in logs[1]
    assert "=" * 35 + "val" + "=" * 45 in logs
    for epoch in (0, 1):
        assert (tmp_path / "model" / f"pointnet2_ssg_{epoch}.npz").exists()
    served = evaluate(weights=tmp_path / "model" / "pointnet2_ssg_1.npz",
                      make_loader=loaders.__getitem__, split="val",
                      max_point=128, device="cpu", log=lambda line: None)
    model.eval()
    with torch.inference_mode():
        want = model(T(loaders["val"].data))
    torch.testing.assert_close(served["logits"], want, rtol=1e-6, atol=1e-6)


def test_trained_weights_round_trip_through_flax_keys(rng):
    model = PointNet2SSGClas(npoints=(16, 8), nsamples=(4, 4))
    with torch.no_grad():
        for t in model.state_dict().values():
            t.copy_(T(rng.randn(*t.shape).astype(np.float32)))
    flat = state_dict_to_flax(model.state_dict())
    again = load_flax_weights(PointNet2SSGClas(npoints=(16, 8),
                                               nsamples=(4, 4)), flat)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[key], value,
                                   rtol=0, atol=0)


def test_cli_trains_and_refuses_unported_modes(tmp_path, capsys):
    from papc_tpu.data.synthetic import write_shapenet_h5

    data = write_shapenet_h5(str(tmp_path / "data"), n_train=2, n_test=0,
                             n_val=2, n_points=128, num_classes=16)
    model_dir = tmp_path / "model"
    assert cli.main(["--path", data, "--max_point", "128", "--batchsize",
                     "2", "--epoch_num", "1", "--model_dir", str(model_dir),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "epoch: 0, batch_id: 0, loss is: [" in out
    assert os.path.exists(model_dir / "pointnet2_ssg_0.npz")
    for flags, words in [(["--precision", "bf16"], "Queue 1 item 4"),
                         (["--scan_steps", "4"], "Queue 1 item 4")]:
        with pytest.raises(SystemExit) as exc:
            cli.main(["--path", data, "--device", "cpu", *flags])
        assert exc.value.code == 2
        assert words in capsys.readouterr().err
