"""The port's recompute-mode training passes against the JAX package, on
the CPU.

Inputs are numpy arrays from one seed, handed to both packages in the
same process. The JAX side runs as its own suite runs on the CPU: the jnp
twins of the recompute passes (``papc_tpu/ops/fused_mlp.py:578-686``), the
Pallas passes with ``interpret=True`` and ``make_train_step`` under
``fused_mlp.override(enable=True, impl="jnp", mode="recompute")``. The port
runs its plain versions (no card here).

Tolerances, stated at each test:
- f32 operands: the same arithmetic up to f32 summation order, within
  1e-5 of the largest magnitude.
- bf16 operands: sums and products within 1e-4 of the largest (a product
  summed in another order can round an operand to the other bf16
  neighbour); the argmax exact and the max within one f32 ulp of the
  largest (XLA on the CPU contracts ``a·scale + shift`` into an FMA, the
  port rounds the two operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.models.classify import PointNet2MSGClas as JaxMSG
from papc_tpu.models.classify import PointNet2SSGClas as JaxSSG
from papc_tpu.ops import fused_mlp as jfused
from papc_tpu.ops.pallas import samlp as jsamlp

from papc_tpu_torch.models import registry
from papc_tpu_torch.models.classify import PointNet2MSGClas, PointNet2SSGClas
from papc_tpu_torch.nn import PointMLP, SetAbstraction, SetAbstractionMsg
from papc_tpu_torch.ops import fused_mlp
from papc_tpu_torch.ops.kernels import samlp_recompute as rc
from papc_tpu_torch.ops.kernels import samlp_single, samlp_train

from tests import torch_parity as P
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

# The registry's models with fused SA stacks: the PointNet++ family (the
# rest of the zoo runs no SA kernel).
SA_COMBOS = tuple(c for c in registry.registry_combos()
                  if c[0].startswith("pointnet2"))

T = torch.from_numpy
F32, BF16 = torch.float32, torch.bfloat16
J_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16}
# (grouped shape [B, S, K, C0], widths): the shapes of test_fused_mlp.py,
# and a three-layer stack
CASES = [((4, 16, 8, 6), (16, 32)), ((2, 8, 16, 19), (24, 40)),
         ((2, 8, 8, 5), (16, 24, 8))]
CASE_IDS = ["4x16x8x6-16-32", "2x8x16x19-24-40", "2x8x8x5-16-24-8"]
F32_ULP = 2.0 ** -23


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _stack(seed, shape, widths, dtype):
    """g2 (rounded to bf16 for bf16 operands), per layer W, b and the
    ``[4, C]`` BN vectors, the cotangent of the max, and gradient means
    ``[2, C]`` as the bwd-stats passes would give them: numpy f32."""
    rs = np.random.RandomState(seed)
    b, s, k, c0 = shape
    g2 = (rs.randn(b * s * k, c0) + 0.5).astype(np.float32)
    if dtype == BF16:
        g2 = np.array(jnp.asarray(g2).astype(jnp.bfloat16).astype(jnp.float32))
    ws, bs, vecs, mus = [], [], [], []
    cin = c0
    for c in widths:
        ws.append((rs.randn(cin, c) / np.sqrt(cin)).astype(np.float32))
        bs.append((0.1 * rs.randn(c)).astype(np.float32))
        vecs.append(np.stack([1 + 0.3 * rs.randn(c), 0.2 * rs.randn(c),
                              0.1 * rs.randn(c), rs.uniform(0.5, 2.0, c)]
                             ).astype(np.float32))
        mus.append((0.05 * rs.randn(2, c)).astype(np.float32))
        cin = c
    dout = rs.randn(b * s, widths[-1]).astype(np.float32)
    return g2, ws, bs, vecs, mus, dout


def _port(g2, ws, bs, vecs, mus, dtype):
    return (T(g2).to(dtype), [T(w) for w in ws], [T(b) for b in bs],
            [T(v) for v in vecs], [T(m) for m in mus])


def _jax(g2, ws, bs, vecs, mus, dtype):
    return (jnp.asarray(g2).astype(J_DTYPE[dtype]),
            [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
            [jnp.asarray(v) for v in vecs], [jnp.asarray(m) for m in mus])


def _amax(g2, ws, bs, vecs, k):
    """The port's argmax of the stack (f32 operands), fed to both sides'
    backward passes."""
    _, amax = rc.rc_final_plain(T(g2), [T(v) for v in vecs],
                                [T(w) for w in ws], [T(b) for b in bs], k=k,
                                operand_dtype=F32)
    return amax


def _tol(dtype):
    return 1e-5 if dtype == F32 else 1e-4


# --------------------------------------------------------- single passes

@pytest.mark.parametrize("shape,widths", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_rc_stats_matches_twin_and_pallas(shape, widths, dtype):
    """Every layer's ``(Σa, Σa²)`` against ``_jnp_rc_stats`` and, with
    bf16 operands, the interpret-mode ``recompute_stats``: within 1e-5
    (f32) / 1e-4 (bf16) of the largest."""
    g2, ws, bs, vecs, mus, _ = _stack(1, shape, widths, dtype)
    pg, pw, pb, pv, _ = _port(g2, ws, bs, vecs, mus, dtype)
    jg, jw, jb, jv, _ = _jax(g2, ws, bs, vecs, mus, dtype)
    for upto in range(1, len(widths) + 1):
        got = rc.rc_stats_plain(pg, pv, pw, pb, upto=upto,
                                operand_dtype=dtype)
        assert got.shape == (2, widths[upto - 1]) and got.dtype == F32
        want = jfused._jnp_rc_stats(jg, [v[:2] for v in jv], jw, jb,
                                    upto=upto, sdtype=J_DTYPE[dtype])
        P.close_to_max(got.numpy(), _np(want), _tol(dtype))
        if dtype == BF16:
            pl = jsamlp.recompute_stats(jg, jv, jw, jb, upto=upto,
                                        interpret=True)
            P.close_to_max(got.numpy(), _np(pl), 1e-4)


@pytest.mark.parametrize("shape,widths", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_rc_final_matches_twin_and_pallas(shape, widths, dtype):
    """The first argmax exact and the max within one f32 ulp of the
    largest with bf16 operands (JAX's FMA), within 1e-5 with f32 operands
    (products summed in another order), against ``_jnp_rc_final`` and,
    with bf16 operands, the interpret-mode ``recompute_final_max``."""
    k = shape[2]
    g2, ws, bs, vecs, mus, _ = _stack(2, shape, widths, dtype)
    pg, pw, pb, pv, _ = _port(g2, ws, bs, vecs, mus, dtype)
    jg, jw, jb, jv, _ = _jax(g2, ws, bs, vecs, mus, dtype)
    out, amax = rc.rc_final_plain(pg, pv, pw, pb, k=k, operand_dtype=dtype)
    assert out.shape == amax.shape == (shape[0] * shape[1], widths[-1])
    assert amax.dtype == torch.int32
    wants = [jfused._jnp_rc_final(jg, [v[:2] for v in jv], jw, jb, k=k,
                                  sdtype=J_DTYPE[dtype])]
    if dtype == BF16:
        wants.append(jsamlp.recompute_final_max(jg, jv, jw, jb, k=k,
                                                interpret=True))
    for want, want_amax in wants:
        P.close_to_max(out.numpy(), _np(want),
                      F32_ULP if dtype == BF16 else _tol(dtype))
        np.testing.assert_array_equal(amax.numpy(), np.asarray(want_amax))


@pytest.mark.parametrize("shape,widths", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_rc_bwd_stats_matches_twin_and_pallas(shape, widths, dtype):
    """Every level's ``(Σdy, Σdy·x̂)`` against ``_jnp_rc_bwd_stats`` and,
    with bf16 operands, the interpret-mode ``recompute_bwd_stats``, with
    the gradient means of the layers above the level given: within 1e-5
    (f32) / 1e-4 (bf16) of the largest."""
    k, n = shape[2], len(widths)
    g2, ws, bs, vecs, mus, dout = _stack(3, shape, widths, dtype)
    amax = _amax(g2, ws, bs, vecs, k)
    pg, pw, pb, pv, pm = _port(g2, ws, bs, vecs, mus, dtype)
    jg, jw, jb, jv, jm = _jax(g2, ws, bs, vecs, mus, dtype)
    for level in range(n, 0, -1):
        above = [None] * level + pm[level:]
        got = rc.rc_bwd_stats_plain(pg, T(dout), amax, pv, pw, pb, above,
                                    level=level, k=k, operand_dtype=dtype)
        assert got.shape == (2, widths[level - 1])
        jabove = [None] * level + jm[level:]
        want = jfused._jnp_rc_bwd_stats(
            jg, jnp.asarray(dout), jnp.asarray(amax.numpy()), jv, jw, jb,
            jabove, level=level, k=k, sdtype=J_DTYPE[dtype])
        P.close_to_max(got.numpy(), _np(want), _tol(dtype))
        if dtype == BF16:
            pl = jsamlp.recompute_bwd_stats(
                jg, jnp.asarray(dout), jnp.asarray(amax.numpy()), jv, jw, jb,
                jabove, level=level, k=k, interpret=True)
            P.close_to_max(got.numpy(), _np(pl), 1e-4)


@pytest.mark.parametrize("shape,widths", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_rc_bwd_final_matches_twin_and_pallas(shape, widths, dtype):
    """``dg``, every ``dW`` and ``db`` against ``_jnp_rc_bwd_final`` and,
    with bf16 operands, the interpret-mode ``recompute_bwd_final``: each
    within 1e-5 (f32) / 1e-4 (bf16) of its largest. Without
    ``need_dg`` the same ``dW`` and ``db`` and no ``dg``."""
    k = shape[2]
    g2, ws, bs, vecs, mus, dout = _stack(4, shape, widths, dtype)
    amax = _amax(g2, ws, bs, vecs, k)
    pg, pw, pb, pv, pm = _port(g2, ws, bs, vecs, mus, dtype)
    jg, jw, jb, jv, jm = _jax(g2, ws, bs, vecs, mus, dtype)
    dg, dws, dbs = rc.rc_bwd_final_plain(pg, T(dout), amax, pv, pw, pb, pm,
                                         k=k, operand_dtype=dtype)
    jargs = (jg, jnp.asarray(dout), jnp.asarray(amax.numpy()), jv, jw, jb, jm)
    wants = [jfused._jnp_rc_bwd_final(*jargs, k=k, sdtype=J_DTYPE[dtype])]
    if dtype == BF16:
        wants.append(jsamlp.recompute_bwd_final(*jargs, k=k, interpret=True))
    for want_dg, want_dws, want_dbs in wants:
        P.close_to_max(dg.numpy(), _np(want_dg), _tol(dtype))
        for got, want in zip(dws + dbs, list(want_dws) + list(want_dbs)):
            P.close_to_max(got.numpy(), _np(want).reshape(got.shape),
                          _tol(dtype))
    none, dws2, dbs2 = rc.rc_bwd_final_plain(pg, T(dout), amax, pv, pw, pb,
                                             pm, k=k, operand_dtype=dtype,
                                             need_dg=False)
    assert none is None
    for got, want in zip(dws2 + dbs2, dws + dbs):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------ the fused Function

def _layers(rs, c0, widths):
    layers, cin = [], c0
    for c in widths:
        layers.append(((rs.randn(cin, c) / np.sqrt(cin)).astype(np.float32),
                       (0.1 * rs.randn(c)).astype(np.float32),
                       (1 + 0.2 * rs.randn(c)).astype(np.float32),
                       (0.1 * rs.randn(c)).astype(np.float32)))
        cin = c
    running = [((0.1 * rs.randn(c)).astype(np.float32),
                rs.uniform(0.5, 2.0, c).astype(np.float32)) for c in widths]
    return layers, running


def _port_fused(g, layers, running, cot, *, mode, dtype, impl="plain"):
    """The port's training stack: ``(out, new_running, dg, [[dW, db, dγ,
    dβ]])`` as numpy."""
    gt = T(g).requires_grad_()
    params = [tuple(T(p).requires_grad_() for p in layer) for layer in layers]
    out, new_running = fused_mlp.fused_mlp_max(
        gt, params, [(T(m), T(v)) for m, v in running], train=True,
        impl=impl, operand_dtype=dtype, mode=mode)
    (out * T(cot)).sum().backward()
    return (out.detach().numpy(), [(m.numpy(), v.numpy())
                                   for m, v in new_running],
            gt.grad.numpy(), [[p.grad.numpy() for p in layer]
                              for layer in params])


def _compare_fused(port, want, rel_out, rel_grad):
    """Outputs and statistics against the largest of theirs; gradients
    against the largest of their layer's (``db`` feeds a BN: its true
    value is 0 and both sides hold rounding noise)."""
    P.close_to_max(port[0], want[0], rel_out)
    for (m, v), (wm, wv) in zip(port[1], want[1]):
        P.close_to_max(m, wm, rel_out)
        P.close_to_max(v, wv, rel_out)
    P.close_to_max(port[2], want[2], rel_grad)
    for layer, wlayer in zip(port[3], want[3]):
        scale = max(float(np.abs(wg).max()) for wg in wlayer)
        for g, wg in zip(layer, wlayer):
            P.close_to_max(g, wg, rel_grad, scale)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_fused_recompute_matches_jax(dtype):
    """``_FusedRecompute`` (``fused_mlp_max(mode="recompute")``) against
    ``fused_mlp_max(train=True, impl="jnp", mode="recompute")`` with
    ``jax.value_and_grad``, same inputs and cotangent. f32 operands:
    outputs and statistics within 1e-5, every gradient within 1e-4 of its
    layer's largest (the BN backward subtracts sums of M terms). bf16
    operands: a product summed in another order can round an operand to
    the other bf16 neighbour and carry it through the later layers:
    outputs and statistics within 1e-3, gradients within 1e-2."""
    rs = np.random.RandomState(5)
    shape, widths = (2, 16, 8, 6), (32, 16, 24)
    g = (rs.randn(*shape) + 0.5).astype(np.float32)
    layers, running = _layers(rs, shape[-1], widths)
    cot = rs.randn(*shape[:2], widths[-1]).astype(np.float32)
    port = _port_fused(g, layers, running, cot, mode="recompute", dtype=dtype)

    jrun = tuple((jnp.asarray(m), jnp.asarray(v)) for m, v in running)

    def loss(gj, pj):
        o, nr = jfused.fused_mlp_max(gj, pj, jrun, train=True, impl="jnp",
                                     sdtype=J_DTYPE[dtype], mode="recompute")
        return jnp.sum(o * jnp.asarray(cot)), (o, nr)

    jp = tuple(tuple(jnp.asarray(p) for p in layer) for layer in layers)
    (_, (o, nr)), (dg, dp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(g), jp)
    want = (_np(o), [(_np(m), _np(v)) for m, v in nr], _np(dg),
            [[_np(p) for p in layer] for layer in dp])
    if dtype == F32:
        _compare_fused(port, want, 1e-5, 1e-4)
    else:
        _compare_fused(port, want, 1e-3, 1e-2)


def test_fused_recompute_gradcheck_in_float64():
    """The Function's backward is the derivative of its forward: the
    plain recompute passes in float64 under gradcheck."""
    rs = np.random.RandomState(3)
    k, widths = 4, (5, 4, 3)
    x = torch.tensor(rs.randn(3 * k, 2) + 0.3, dtype=torch.float64,
                     requires_grad=True)
    flat, cin = [], 2
    for c in widths:
        flat += [torch.tensor(rs.randn(cin, c), dtype=torch.float64),
                 torch.tensor(0.1 * rs.randn(c), dtype=torch.float64),
                 torch.tensor(1 + 0.2 * rs.randn(c), dtype=torch.float64),
                 torch.tensor(0.1 * rs.randn(c), dtype=torch.float64)]
        cin = c
    flat = [t.requires_grad_() for t in flat]

    def f(x, *flat):
        return fused_mlp._FusedRecompute.apply(x, k, 1e-5, "plain",
                                               torch.float64, "recompute",
                                               *flat)[0]

    assert torch.autograd.gradcheck(f, (x, *flat), eps=1e-6, atol=1e-5,
                                    rtol=1e-4)


def test_recompute_close_to_stream():
    """The port's two modes compute the same function with different
    storage rounding (stream stores bf16 pre-activations, recompute keeps
    them f32): outputs within 5e-2 and statistics within 2e-3 absolute,
    the bands of JAX's ``test_recompute_close_to_stream``, at its shapes
    and with flax's initial values (zero biases, unit BN scales)."""
    rs = np.random.RandomState(0)
    shape, widths = (4, 16, 8, 6), (16, 32)
    g = rs.randn(*shape).astype(np.float32)
    layers, running = _layers(rs, shape[-1], widths)
    layers = [(w, np.zeros_like(b), np.ones_like(b), np.zeros_like(b))
              for w, b, _, _ in layers]
    cot = np.ones((*shape[:2], widths[-1]), np.float32)
    a = _port_fused(g, layers, running, cot, mode="stream", dtype=BF16)
    b = _port_fused(g, layers, running, cot, mode="recompute", dtype=BF16)
    np.testing.assert_allclose(b[0], a[0], rtol=0, atol=5e-2)
    for (ma, va), (mb, vb) in zip(a[1], b[1]):
        np.testing.assert_allclose(mb, ma, rtol=0, atol=2e-3)
        np.testing.assert_allclose(vb, va, rtol=0, atol=2e-3)


@pytest.mark.parametrize("mode,rows", [("recompute", 1), ("stream", 4),
                                       ("recompute1", 1)])
def test_saved_for_backward(mode, rows):
    """What each mode keeps for the backward, counted under
    ``saved_tensors_hooks``: tensors of ``M`` rows. Recompute and
    recompute1 save ``g2`` alone; stream saves ``g2`` and the L = 3 stored
    pre-activations."""
    rs = np.random.RandomState(6)
    shape, widths = (2, 8, 8, 5), (16, 24, 8)
    m = shape[0] * shape[1] * shape[2]
    layers, running = _layers(rs, shape[-1], widths)
    params = [tuple(T(p).requires_grad_() for p in layer) for layer in layers]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, _ = fused_mlp.fused_mlp_max(
            T(rs.randn(*shape).astype(np.float32)), params,
            [(T(a), T(b)) for a, b in running], train=True, impl="plain",
            mode=mode)
    assert sum(s[0] == m for s in saved) == rows, saved
    assert (m, shape[-1]) in saved  # g2
    out.sum().backward()


def test_input_gradient_only_when_asked():
    """``needs_input_grad``: data (SA1's grouped input) gets no gradient
    and the bwd-final pass skips its product; the parameters still do."""
    rs = np.random.RandomState(4)
    layers, running = _layers(rs, 3, (8, 8))
    params = [tuple(T(p).requires_grad_() for p in layer) for layer in layers]
    calls = []
    real = rc.rc_bwd_final

    def spy(*args, **kw):
        calls.append(kw["need_dg"])
        return real(*args, **kw)

    rc.rc_bwd_final = spy
    try:
        out, _ = fused_mlp.fused_mlp_max(
            T(rs.randn(1, 4, 8, 3).astype(np.float32)), params,
            [(T(m), T(v)) for m, v in running], train=True, impl="plain",
            mode="recompute")
        out.sum().backward()
    finally:
        rc.rc_bwd_final = real
    assert calls == [False]
    assert all(p.grad is not None for layer in params for p in layer)


# ------------------------------------------------------- mode routing

STREAM_PASSES = ("linear_stats", "finalize_max", "bwd_seed", "bwd_layer")
RC_PASSES = ("rc_stats", "rc_final", "rc_bwd_stats", "rc_bwd_final")
RC1_PASSES = ("rc1_stats", "rc1_final", "rc1_bwd_stats", "rc1_bwd_final")


@pytest.mark.parametrize("mode,features,want", [
    ("stream", (16, 24, 8), dict(zip(STREAM_PASSES, (3, 1, 1, 3)))),
    ("recompute", (16, 24, 8), dict(zip(RC_PASSES, (3, 1, 3, 1)))),
    ("recompute1", (16, 24, 8), dict(zip(RC1_PASSES, (3, 1, 3, 1)))),
    # bf16 weights of 2.1 MB: no single-launch plan, stream passes
    ("recompute1", (1024, 1024), dict(zip(STREAM_PASSES, (2, 1, 1, 2)))),
], ids=["stream", "recompute", "recompute1", "recompute1-demoted"])
def test_mode_routes_every_pass(monkeypatch, mode, features, want):
    """Under ``override(mode=...)`` a training step of a PointMLP calls
    only that mode's passes (the dispatchers: kernel on the card, plain
    here), each as often as the mode says (L = 3: stream 3/1/1/3,
    recompute and recompute1 3/1/3/1); the other modes' passes never. A
    stack that ``samlp_single.fits`` refuses runs the stream passes under
    ``recompute1``."""
    counts = {}
    for mod, names in ((samlp_train, STREAM_PASSES), (rc, RC_PASSES),
                       (samlp_single, RC1_PASSES)):
        for name in names:
            real = getattr(mod, name)

            def spy(*args, _real=real, _name=name, **kw):
                counts[_name] = counts.get(_name, 0) + 1
                return _real(*args, **kw)

            monkeypatch.setattr(mod, name, spy)
    mlp = PointMLP(5, features, pool_max=True).train()
    with fused_mlp.override(mode=mode):
        mlp(torch.randn(2, 8, 8, 5)).sum().backward()
    assert counts == want


def test_unported_and_unknown_modes_raise():
    """``recompute1`` (kernels #15-18) trains: its step gives the
    recompute step's output and gradients exactly (the same plain passes
    here); an unknown mode raises and does not fall back to stream."""
    x = torch.randn(1, 8, 8, 5)
    got = []
    for mode in ("recompute", "recompute1"):
        torch.manual_seed(0)
        mlp = PointMLP(5, (16, 8), pool_max=True).train()
        with fused_mlp.override(mode=mode):
            out = mlp(x)
        out.sum().backward()
        got.append([out.detach()] + [p.grad for p in mlp.parameters()])
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode must be one of"):
        fused_mlp.fused_mlp_max(x, [(torch.ones(5, 16), torch.zeros(16),
                                     torch.ones(16), torch.zeros(16))],
                                [(torch.zeros(16), torch.ones(16))],
                                train=True, mode="bogus")


def test_nested_override_resets_the_mode():
    """Entering an override sets every key, as the JAX package's does: an
    inner ``override(impl="plain")`` puts an outer ``mode="recompute"``
    back to stream. Give all keys in one call."""
    with fused_mlp.override(mode="recompute"):
        assert fused_mlp._OVERRIDE["mode"] == "recompute"
        with fused_mlp.override(impl="plain"):
            assert fused_mlp._OVERRIDE["mode"] == "stream"
        with fused_mlp.override(impl="plain", mode="recompute"):
            assert fused_mlp._OVERRIDE["mode"] == "recompute"
    assert fused_mlp._OVERRIDE["mode"] == "stream"


# ------------------------------------------------------------ the plans

def _stacks(model):
    """``(name, c0, widths, k)`` of every fused SA stack of a model: K is
    the stage's ball-query size, or for ``group_all`` the previous stage's
    centre count."""
    out, points = [], None
    for name, mod in model.named_modules():
        if isinstance(mod, SetAbstraction):
            k = points if mod.group_all else mod.nsample
            mlps = [mod.PointMLP_0]
            ks = [k]
        elif isinstance(mod, SetAbstractionMsg):
            mlps = [getattr(mod, f"PointMLP_{i}")
                    for i in range(len(mod.nsample_list))]
            ks = list(mod.nsample_list)
        else:
            continue
        for mlp, kk in zip(mlps, ks):
            out.append((name, mlp.Dense_0.in_features, mlp.features, kk))
        points = mod.npoint
    return out


def _bwd_smem(kind, pl, k, c0, widths, level=None):
    """``bwd_smem_bytes`` of a plan, from the plan's own choices."""
    return rc.bwd_smem_bytes(kind, pl["tm"], k, c0, widths, level=level,
                             keep_h=pl["dw"] in ("smem", "slot"),
                             a_smem=pl["a_smem"], dw_smem=pl["dw"] == "smem",
                             stages=pl["stages"])


def _bwd_passes(widths):
    """``(kind, kwargs)`` of #13 at every level and #14 with and without
    dg."""
    return ([("bwd_stats", {"level": lv}) for lv in range(1, len(widths) + 1)]
            + [("bwd_final", {"need_dg": True}),
               ("bwd_final", {"need_dg": False})])


@pytest.mark.parametrize("combo", SA_COMBOS,
                         ids=lambda c: "-".join(c))
def test_every_plan_fits_the_card(combo):
    """Every pass of every SA stack of the registry's models at B=32 x
    1024 (c0 3 to 643, widths up to 1024 with 196, K 16 to 128) fits the
    H100's 232 448 B of shared memory a block, at tiles of 32, 64 or 128
    rows: #11 and #12 (``fwd_plan``, the bytes of ``fwd_smem_bytes`` at
    the plan's ring or resident weights), #13 and #14 (``bwd_plan``),
    SSG/MSG SA3's backward at 32 (the f32 a_1, a_2 of 3 KB a row then
    live in device scratch; the wmma design fell to 16-row tiles
    there)."""
    spec = registry.init_model(*combo, device="cpu")
    stacks = _stacks(spec.model)
    assert stacks
    limit, seen, seen_bwd = 232448, set(), set()
    for name, c0, widths, k in stacks:
        m = 32 * 128 * k
        for kind in ("stats", "final"):
            for lv in (range(1, len(widths) + 1) if kind == "stats"
                       else [None]):
                kw = {"upto": lv} if kind == "stats" else {}
                pl = rc.fwd_plan(kind, m, k, c0, tuple(widths), limit, **kw)
                assert pl["smem"] <= limit and pl["tm"] in (32, 64, 128)
                assert pl["smem"] == rc.fwd_smem_bytes(
                    kind, pl["tm"], k, c0, widths, stages=pl["stages"],
                    w_res=pl["w_res"], **kw)
                assert 1 <= pl["blocks"] <= pl["tiles"]
                seen.add((c0, k, pl["tm"]))
        for kind, kw in _bwd_passes(widths)[:-1]:
            lv = kw.get("level")
            pl = rc.bwd_plan(kind, m, k, c0, tuple(widths), limit, level=lv)
            assert pl["smem"] <= limit and pl["tm"] in (32, 64, 128)
            assert pl["smem"] == _bwd_smem(kind, pl, k, c0, widths, lv)
            assert 1 <= pl["blocks"] <= pl["tiles"]
            seen_bwd.add((c0, k, pl["tm"]))
    if combo == ("pointnet2_ssg", "clas"):
        assert (259, 128, 32) in seen_bwd  # SA3's backward
    with pytest.raises(ValueError, match="shared memory"):
        rc.bwd_plan("bwd_final", 4096, 128, 259, (256, 512, 1024), 100_000)
    with pytest.raises(ValueError, match="backward passes"):
        rc.bwd_plan("stats", 4096, 128, 259, (256, 512, 1024), limit)


def _covers(pieces, n: int) -> bool:
    """Whether the half-open ranges ``pieces`` cover ``[0, n)`` once."""
    hit = [0] * n
    for lo, hi in pieces:
        for x in range(lo, hi):
            if x >= n:
                return False
            hit[x] += 1
    return all(h == 1 for h in hit)


@pytest.mark.parametrize("combo", SA_COMBOS,
                         ids=lambda c: "-".join(c))
def test_bwd_plan_takes_every_tile_product_and_column_once(combo):
    """#13 and #14's plan at every stack of the model, at the rows above
    and, for a ``group_all`` stage, its own 32 x K: the blocks take every
    row tile once; the plan's schedule (``prods``, which the kernel runs
    as it is) holds the chain forward 1..n, then the walk down to the
    pass's last layer, and each product takes every k16 step once through
    ring slices of at most ``ks`` rows and every output column once in
    n16 pairs of at most four a warp, so every sum column has one owner;
    dW's warp units (32 x 64) cover every layer's [p_{j-1}, p_j] once, as
    do the rows kernel's 64 x 256 tiles and row splits, and the rows are
    chosen only where they and their partials take fewer bytes than the
    slots; all within 232 448 B."""
    spec = registry.init_model(*combo, device="cpu")
    limit = 232448
    shapes = {(c0, tuple(w), k, 32 * 128 * k)
              for _, c0, w, k in _stacks(spec.model)}
    shapes |= {(c0, tuple(w), k, 32 * k) for name, c0, w, k in
               _stacks(spec.model) if name.startswith("SetAbstraction_")
               and getattr(spec.model, name).group_all}
    for c0, widths, k, m in sorted(shapes):
        p = [samlp_train._pad(c) for c in (c0, *widths)]
        n = len(widths)
        for kind, kw in _bwd_passes(widths):
            lv = kw.get("level")
            need_dg = kw.get("need_dg", True)
            pl = rc.bwd_plan(kind, m, k, c0, widths, limit, level=lv,
                             need_dg=need_dg)
            assert pl["tm"] >= 32 and pl["smem"] <= limit
            tiles = [t for b in range(pl["blocks"])
                     for t in range(b, pl["tiles"], pl["blocks"])]
            assert sorted(tiles) == list(range(pl["tiles"]))
            assert pl["tiles"] * pl["tm"] >= m > (pl["tiles"] - 1) * pl["tm"]
            rw, chunk, ks = rc._bwd_shape(pl["tm"])
            stop = lv + 1 if lv else 1 if need_dg else 2
            assert [(j, w) for j, w, _ in pl["prods"]] == (
                [(j, 0) for j in range(1, n + 1)]
                + [(j, 1) for j in range(n, stop - 1, -1)])
            for j, walk, span in pl["prods"]:
                assert span % 16 == 0 and 16 <= span <= 64
                kdim, ndim = (p[j], p[j - 1]) if walk else (p[j - 1], p[j])
                slices = [(s, min(s + ks, kdim)) for s in range(0, kdim, ks)]
                assert _covers(slices, kdim)
                assert all((hi - lo) % 16 == 0 for lo, hi in slices)
                cols = []
                for c0_ in range(0, ndim, chunk):
                    width = min(chunk, ndim - c0_)
                    sp = span if c0_ + chunk >= ndim else 64
                    for wc in range(8 // rw):
                        pairs = max(0, min(sp, width - wc * sp)) // 16
                        assert pairs <= 4
                        cols.append((c0_ + wc * sp, c0_ + wc * sp + 16 * pairs))
                assert _covers(cols, ndim)
            if kind == "bwd_stats":
                continue
            for j in range(1, n + 1):
                units = [(ci * 32, co * 64) for ci in range(-(-p[j - 1] // 32))
                         for co in range(-(-p[j] // 64))]
                cells = [(r, c) for r0, c0_ in units
                         for r in range(r0, min(r0 + 32, p[j - 1]))
                         for c in range(c0_, min(c0_ + 64, p[j]))]
                assert len(cells) == len(set(cells)) == p[j - 1] * p[j]
            if pl["dw"] == "rows":
                dw_floats = sum(a * b for a, b in zip(p, p[1:]))
                assert 2 * pl["rows"] + 4 * pl["dw_part"] < (
                    4 * pl["blocks"] * dw_floats)
                for a, b in zip(p, p[1:]):
                    assert _covers([(t, min(t + 64, a))
                                    for t in range(0, a, 64)], a)
                    assert _covers([(t, min(t + 256, b))
                                    for t in range(0, b, 256)], b)
                rps = pl["rows_per_split"]
                assert rps % 32 == 0
                assert _covers([(s * rps, min((s + 1) * rps, pl["m_pad"]))
                                for s in range(pl["dw_splits"])], pl["m_pad"])


# (m, k, c0, widths) beside the registry's: ragged groups and last tiles
# (the card tests' RC_STACKS and RC1_STACKS cases)
FWD_RAGGED = [(160, 32, 3, (64, 64, 128)), (72, 8, 20, (16, 16, 16, 32)),
              (35, 5, 7, (16, 24)), (1200, 20, 9, (32, 48))]


@pytest.mark.parametrize("combo", SA_COMBOS,
                         ids=lambda c: "-".join(c))
def test_fwd_plan_takes_every_tile_product_column_and_group_once(combo):
    """#11 and #12's plan at every stack of the model (at the rows above
    and, for a ``group_all`` stage, its own 32 x K) and at the ragged
    cases: the blocks take every row tile once; the schedule (``prods``,
    which the kernel runs as it is) holds a_1 .. a_n in order, each
    product taking every k16 step once through slices of at most ``ks``
    rows and every output column once in n16 pairs of at most four a
    warp; #12 covers every group once: where tiles hold whole groups
    (``whole``, one launch) the tile that writes a group holds all its
    rows, and no group is written twice; elsewhere every tile that
    touches a group keeps its key in one of its ``gpt`` slots, and the
    merge reads exactly the tiles that hold the group's rows."""
    spec = registry.init_model(*combo, device="cpu")
    limit = 232448
    shapes = {(32 * 128 * k, k, c0, tuple(w))
              for _, c0, w, k in _stacks(spec.model)}
    shapes |= {(32 * k, k, c0, tuple(w)) for name, c0, w, k in
               _stacks(spec.model) if name.startswith("SetAbstraction_")
               and getattr(spec.model, name).group_all}
    shapes |= set(FWD_RAGGED)
    for m, k, c0, widths in sorted(shapes):
        p = [samlp_train._pad(c) for c in (c0, *widths)]
        for kind, upto in ([("stats", lv) for lv in range(1, len(widths) + 1)]
                           + [("final", None)]):
            n = upto or len(widths)
            pl = rc.fwd_plan(kind, m, k, c0, widths, limit, upto=upto)
            tm = pl["tm"]
            assert tm in (32, 64, 128) and pl["smem"] <= limit
            tiles = [t for b in range(pl["blocks"])
                     for t in range(b, pl["tiles"], pl["blocks"])]
            assert sorted(tiles) == list(range(pl["tiles"]))
            assert pl["tiles"] * tm >= m > (pl["tiles"] - 1) * tm
            rw, chunk, ks = rc._bwd_shape(tm)
            assert [(j, w) for j, w, _ in pl["prods"]] == [
                (j, 0) for j in range(1, n + 1)]
            for j, _, span in pl["prods"]:
                assert span % 16 == 0 and 16 <= span <= 64
                kdim, ndim = p[j - 1], p[j]
                slices = [(s, min(s + ks, kdim)) for s in range(0, kdim, ks)]
                assert _covers(slices, kdim)
                assert all((hi - lo) % 16 == 0 for lo, hi in slices)
                cols = []
                for c0_ in range(0, ndim, chunk):
                    width = min(chunk, ndim - c0_)
                    sp = span if c0_ + chunk >= ndim else 64
                    for wc in range(8 // rw):
                        pairs = max(0, min(sp, width - wc * sp)) // 16
                        assert pairs <= 4
                        cols.append((c0_ + wc * sp, c0_ + wc * sp + 16 * pairs))
                assert _covers(cols, ndim)
            if kind == "stats":
                continue
            groups, gpt = m // k, pl["gpt"]
            assert pl["whole"] == (tm % k == 0)
            if pl["whole"]:
                assert pl["keys"] == 0 and gpt == tm // k
                written = [(t * tm // k + gi) for t in range(pl["tiles"])
                           for gi in range(gpt) if t * tm // k + gi < groups]
                assert sorted(written) == list(range(groups))
                for t in range(pl["tiles"]):  # the tile holds its groups
                    for g in range(t * tm // k,
                                   min(groups, t * tm // k + gpt)):
                        assert t * tm <= g * k and (g + 1) * k <= (t + 1) * tm
                continue
            assert pl["keys"] == pl["tiles"] * gpt * widths[-1]
            for t in range(pl["tiles"]):  # each touched group has a slot
                lo, hi = t * tm, min(m, (t + 1) * tm) - 1
                assert hi // k - t * tm // k < gpt
            for g in range(groups):  # the merge's tiles hold the group
                t0, t1 = g * k // tm, ((g + 1) * k - 1) // tm
                assert _covers([(max(g * k, t * tm) - g * k,
                                 min((g + 1) * k, (t + 1) * tm) - g * k)
                                for t in range(t0, t1 + 1)], k)
                assert all(0 <= g - t * tm // k < gpt
                           for t in range(t0, t1 + 1))


def test_bwd_final_keeps_dw_on_chip_and_sa3_scratch_small():
    """#14's dW at the SSG clas stacks (B=32 x 1024): SA1's 53 KB on chip
    (no dW slot), SA2's 270 KB in one slot a block, SA3 (4096 rows, group
    all) from its bf16 rows: h and da written once (23.2 MB) plus split
    partials, under 64 MB, against the wmma design's 383 MB of slots."""
    limit = 232448
    sa1 = rc.bwd_plan("bwd_final", 524288, 32, 3, (64, 64, 128), limit)
    assert sa1["dw"] == "smem" and sa1["tm"] == 128
    assert sa1["dw_part"] == 132 * (16 * 64 + 64 * 64 + 64 * 128)
    sa2 = rc.bwd_plan("bwd_final", 262144, 64, 131, (128, 128, 256), limit)
    assert sa2["dw"] == "slot" and sa2["tm"] >= 64
    sa3 = rc.bwd_plan("bwd_final", 4096, 128, 259, (256, 512, 1024), limit)
    assert sa3["dw"] == "rows" and sa3["tm"] == 32
    rows_mb = 2 * sa3["rows"] / 1e6
    scratch_mb = rows_mb + 4 * sa3["dw_part"] / 1e6
    assert abs(rows_mb - 23.2) < 0.1 and scratch_mb < 64
    with pytest.raises(ValueError, match="forward passes"):
        rc.fwd_plan("bwd_final", 4096, 128, 259, (256, 512, 1024), limit)


# (c0, widths, k) -> (tm, smem) at m = 32·128·k of samlp_single.fwd_plan
# for stats at each layer and final (#11 / #12's layout: a plan at every
# stack, whether the gate admits it or not), and of samlp_single.bwd_plan
# for bwd stats at each level and bwd final (#13 / #14's layout, weights
# resident where they fit).
SINGLE_PLANS = {
    (3, (64, 64, 128), 32): [(128, 10496), (128, 38144), (128, 69888), (128, 69888), (128, 163328), (128, 163328), (128, 165376), (128, 169472)],
    (131, (128, 128, 256), 64): [(128, 82176), (128, 112640), (128, 108032), (128, 112640), (128, 157952), (128, 157952), (128, 162048), (128, 231680)],
    (259, (256, 512, 1024), 128): [(128, 114688), (128, 190464), (64, 184320), (128, 226304), (32, 216320), (32, 218368), (32, 222464), (32, 231680)],
    (3, (32, 32, 64), 16): [(128, 41984), (128, 52224), (128, 57344), (128, 59392), (128, 83968), (128, 83968), (128, 84992), (128, 115712)],
    (3, (64, 96, 128), 128): [(128, 10496), (128, 43264), (128, 90880), (128, 87808), (128, 197632), (128, 198656), (128, 199680), (128, 212480)],
    (323, (64, 64, 128), 32): [(128, 107520), (128, 166144), (128, 185600), (128, 185600), (128, 205312), (128, 205312), (128, 207360), (128, 210176)],
    (323, (128, 128, 256), 64): [(128, 109568), (128, 161792), (128, 165888), (128, 161792), (128, 207104), (128, 207104), (128, 211200), (64, 203008)],
    (323, (128, 128, 256), 128): [(128, 109568), (128, 161792), (128, 165888), (128, 159744), (128, 205056), (128, 205056), (128, 209152), (64, 203008)],
    (643, (256, 512, 1024), 128): [(128, 212992), (64, 194560), (64, 202752), (64, 194560), (32, 225536), (32, 227584), (32, 231680), (32, 231680)],
    (6, (64, 64, 128), 32): [(128, 10496), (128, 38144), (128, 69888), (128, 69888), (128, 163328), (128, 163328), (128, 165376), (128, 169472)],
    (6, (32, 32, 64), 32): [(128, 8448), (128, 21248), (128, 30976), (128, 30976), (128, 81920), (128, 81920), (128, 82944), (128, 113664)],
    (6, (64, 64, 128), 64): [(128, 10496), (128, 38144), (128, 69888), (128, 67840), (128, 161280), (128, 161280), (128, 163328), (128, 167424)],
    (6, (64, 96, 128), 128): [(128, 10496), (128, 43264), (128, 90880), (128, 87808), (128, 197632), (128, 198656), (128, 199680), (128, 212480)],
    (323, (128, 196, 256), 128): [(128, 109568), (128, 164352), (128, 165888), (128, 159744), (128, 205056), (128, 207616), (128, 209152), (64, 213888)],
    (515, (256, 512, 1024), 128): [(128, 180224), (64, 178176), (64, 186368), (128, 230400), (32, 217344), (32, 219392), (32, 223488), (32, 223488)],
}


@pytest.mark.parametrize("stack", list(SINGLE_PLANS),
                         ids=lambda s: f"{s[0]}-{'-'.join(map(str, s[1]))}-k{s[2]}")
def test_single_launch_plans_unchanged(stack):
    """#15-18's plans at every registry stack: #15 and #16's
    (``samlp_single.fwd_plan``) the tile and bytes of #11 / #12's layout
    with the weights resident where a block's range holds several tiles;
    #17 and #18's (``samlp_single.bwd_plan``) the tile and bytes of #13 /
    #14's layout with the weights resident where they fit."""
    c0, widths, k = stack
    got = []
    for kind in ("stats", "final", "bwd_stats", "bwd_final"):
        for lv in (range(1, len(widths) + 1)
                   if kind in ("stats", "bwd_stats") else [None]):
            kw = ({"upto": lv} if kind == "stats" else
                  {"level": lv} if kind == "bwd_stats" else {})
            plan = (samlp_single.fwd_plan if kind in ("stats", "final")
                    else samlp_single.bwd_plan)
            try:
                pl = plan(kind, 32 * 128 * k, k, c0, widths, 232448, **kw)
                got.append((pl["tm"], pl["smem"]))
            except ValueError:
                got.append(None)
    assert got == SINGLE_PLANS[stack]


# ------------------------------------------------- whole steps, bf16

def _ssg_case():
    b = P.batch(4, 128, seed=5)
    kw = {"npoints": (32, 16), "nsamples": (8, 16)}
    jmodel = JaxSSG(num_classes=16, **kw)
    variables = P.perturbed_variables(jmodel, "clas", b, 5)
    return b, jmodel, variables, lambda: PointNet2SSGClas(num_classes=16,
                                                          **kw)


def _msg_case():
    b = P.batch(4, 512, seed=5)
    jmodel = JaxMSG(num_classes=16)
    variables = P.perturbed_variables(jmodel, "clas", b, 5)
    return b, jmodel, variables, lambda: PointNet2MSGClas(num_classes=16)


# Measured on these inputs (B=4, each bf16 step against the port's
# float64 step, both sides in recompute mode), SSG / MSG: losses 3.9e-5 /
# 2.0e-3 apart (each 0.4 % / 2.5 % from float64: bf16 operands, no
# storage rounding); statistics 9.7e-5 / 4.1e-3 of their largest; the
# gradients 0.005 / 0.30 apart in median relative L2 (MSG's four clouds
# route each SA3 channel's gradient through one of 128 rows, and operand
# rounding flips which); the port's at most 1.23 / 1.26 times (median 1.00
# / 0.94) as far from float64 as JAX's; noise biases 9.4e-6 / 2.2e-4.
STEP_LIMITS = {
    "ssg": {"loss": 1e-3, "stats": 1e-3, "ratio": 1.5, "median_ratio": 1.1,
            "median_rel": 0.05, "noise": 1e-3},
    "msg": {"loss": 1e-2, "stats": 2e-2, "ratio": 1.6, "median_ratio": 1.15,
            "median_rel": 0.5, "noise": 1e-2},
}


@pytest.mark.parametrize("name", ["ssg", "msg"])
def test_recompute_train_step_matches_jax(name, monkeypatch):
    """One clas step at B=4 (SSG at the reduced size of the f32 step test,
    MSG at full width) with bf16 operands under
    ``override(mode="recompute")``, against ``make_train_step`` under
    ``override(enable=True, impl="jnp", mode="recompute")`` with every SA
    stage fused (``permissive_fused_gate``), both judged by the port's
    float64 step (``check_bf16_step``, within ``STEP_LIMITS``)."""
    b, jmodel, variables, make = _ssg_case() if name == "ssg" else _msg_case()
    rs = np.random.RandomState(6)
    masks = [rs.uniform(size=(4, 512)) < 0.6, rs.uniform(size=(4, 256)) < 0.5]
    lr = wd = 1e-3
    P.permissive_fused_gate(monkeypatch)
    want = P.jax_step(jmodel, "clas", variables, b, masks, lr, wd, fused=True,
                      fused_mode="recompute")
    port = P.port_step(make, variables, b, masks, lr, wd, BF16,
                       fused_mode="recompute")
    exact = P.port_step(make, variables, b, masks, lr, wd, torch.float64,
                        fused_mode="recompute")
    P.check_bf16_step(port, want, exact, variables, lr, wd,
                      STEP_LIMITS[name])
