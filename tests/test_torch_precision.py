"""The port's bf16 training (``precision="bf16"``) against the JAX
package, on the CPU.

Inputs are numpy arrays from one seed, handed to both packages in the
same process. The JAX side runs as its own suite runs on the CPU: the
Pallas gather kernels with ``interpret=True`` and ``make_train_step(...,
precision="bf16")`` under ``fused_mlp.override(enable=True,
impl="jnp")``. The port runs its plain versions (no card here), which
are the kernels' oracles on the card.

Tolerances, stated at each test: ``cast_floating`` and the loss scale
exact; the bf16 gather exact; the bf16 scatter-add within one bf16 ulp;
the bf16 step by its distance from JAX's and from the float64 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn

import papc_tpu.ops.grouping as jgrouping
from papc_tpu.models.classify import PointNet2SSGClas as JaxSSG
from papc_tpu.models.registry import ModelSpec
from papc_tpu.ops import fused_mlp as jfused
from papc_tpu.ops.pallas.gather_t import (gather_cols_pallas,
                                          scatter_cols_add_pallas)
from papc_tpu.train import precision as jprecision
from papc_tpu.train import trainer as jtrainer

from papc_tpu_torch.convert import flatten, state_dict_to_flax
from papc_tpu_torch.data import SyntheticLoader
from papc_tpu_torch.models import init_model
from papc_tpu_torch.models.classify import PointNet2SSGClas
from papc_tpu_torch.ops.kernels import gather
from papc_tpu_torch.train import make_optimizer, train_step
from papc_tpu_torch.train.precision import (bf16_compute, cast_floating,
                                            dynamic_loss_scale)
from tests import torch_parity as P
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

T = torch.from_numpy
BF16 = torch.bfloat16


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_np(x):
    """``x`` rounded to bf16, as f32 numpy (the values the bf16 step
    computes with)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _ulp(x):
    """One bf16 ulp of each value of ``x`` (0 at 0)."""
    x = np.abs(np.asarray(x, np.float64))
    return np.where(x == 0, 0.0, np.exp2(np.floor(np.log2(x + 1e-300)) - 7))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


# ------------------------------------------------------------ precision

def test_cast_floating_matches_jax(rng):
    """Nested dicts (a ``state_dict`` too), lists and tuples: every
    floating leaf cast to bf16 with JAX's bits, integer and bool leaves
    untouched, exactly."""
    tree = {"a": rng.randn(3, 4).astype(np.float32),
            "b": {"c": rng.randn(5).astype(np.float16),
                  "i": rng.randint(0, 9, (4,)).astype(np.int32),
                  "m": rng.rand(3) > 0.5},
            "l": [rng.randn(2).astype(np.float32),
                  rng.randint(0, 3, (2,)).astype(np.int64)]}
    want = jprecision.cast_floating(jax.tree_util.tree_map(jnp.asarray, tree),
                                    jnp.bfloat16)
    port_tree = {"a": T(tree["a"]),
                 "b": {k: T(v) for k, v in tree["b"].items()},
                 "l": [T(v) for v in tree["l"]]}
    got = cast_floating(port_tree, BF16)
    got_leaves = [got["a"], got["b"]["c"], got["b"]["i"], got["b"]["m"],
                  got["l"][0], got["l"][1]]
    want_leaves = [want["a"], want["b"]["c"], want["b"]["i"], want["b"]["m"],
                   want["l"][0], want["l"][1]]
    given = [tree["a"], tree["b"]["c"], tree["b"]["i"], tree["b"]["m"],
             tree["l"][0], tree["l"][1]]
    for g, w, x in zip(got_leaves, want_leaves, given):
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            assert g.dtype == BF16
            np.testing.assert_array_equal(_bits(g), w.view(np.int16))
        else:  # as given (JAX without x64 narrows int64 to int32)
            assert g.dtype == T(x).dtype
            np.testing.assert_array_equal(g.numpy(), w)
    model = PointNet2SSGClas(npoints=(16, 8), nsamples=(4, 4))
    sd = cast_floating(model.state_dict(), BF16)
    assert type(sd) is type(model.state_dict())
    assert {t.dtype for t in sd.values()} == {BF16}
    assert cast_floating((T(tree["a"]), 3, None), BF16)[1:] == (3, None)


def test_bf16_compute_gives_f32_gradients(rng):
    """The wrapped loss sees bf16 parameters; the gradient reaches the f32
    parameter in f32, the bf16 gradient widened (JAX's ``astype`` VJP)."""
    w = torch.tensor(rng.randn(4, 3).astype(np.float32), requires_grad=True)
    x = T(rng.randn(5, 4).astype(np.float32))
    seen = []

    def loss_fn(params, x):
        seen.append(params["w"].dtype)
        return (x.to(BF16) @ params["w"]).float().square().sum()

    bf16_compute(loss_fn)({"w": w}, x).backward()
    assert seen == [BF16] and w.grad.dtype == torch.float32
    wb = w.detach().to(BF16).requires_grad_(True)
    (x.to(BF16) @ wb).float().square().sum().backward()
    assert torch.equal(w.grad, wb.grad.float())


def test_dynamic_loss_scale_matches_jax(rng):
    """A sequence of gradient trees with an ``inf`` and a ``nan``
    injected and growth at ``growth_interval=2``: the unscaled (or zeroed)
    gradients, the scale and the clean-step count equal JAX's optax
    transform's after every step, exactly."""
    steps = []
    for i in range(7):
        g = {"w": (64 * rng.randn(3, 2)).astype(np.float32),
             "b": [(64 * rng.randn(2)).astype(np.float32)]}
        if i == 2:
            g["w"][1, 0] = np.inf
        if i == 5:
            g["b"][0][1] = np.nan
        steps.append(g)
    jtx = jprecision.dynamic_loss_scale(init_scale=16.0, growth_interval=2)
    tx = dynamic_loss_scale(init_scale=16.0, growth_interval=2)
    jstate, state = jtx.init(None), tx.init()
    scales = []
    for g in steps:
        jout, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jstate)
        out, state = tx.update({"w": T(g["w"]), "b": [T(g["b"][0])]}, state)
        np.testing.assert_array_equal(out["w"].numpy(), np.asarray(jout["w"]))
        np.testing.assert_array_equal(out["b"][0].numpy(),
                                      np.asarray(jout["b"][0]))
        assert float(state.scale) == float(jstate.scale)
        assert int(state.good_steps) == int(jstate.good_steps)
        assert state.scale.dtype == torch.float32
        scales.append(float(state.scale))
    assert scales == [16.0, 32.0, 16.0, 16.0, 32.0, 16.0, 16.0]


# --------------------------------------------- #3 and #4 in bf16 (plain)

def _gather_case(seed, B, N, D, S, K):
    rs = np.random.RandomState(seed)
    xyz = _bf16_np(rs.randn(B, N, 3))
    feats = _bf16_np(rs.randn(B, N, D)) if D else None
    idx = rs.randint(0, N, (B, S, K)).astype(np.int32)
    idx[:, :, K // 2:] = idx[:, :, :1]  # ball-query padding: the first hit
    new_xyz = xyz[np.arange(B)[:, None], rs.randint(0, N, (B, S))]
    new_xyz[:, ::3] *= 1e-3  # centres whose exponents lie apart
    return xyz, feats, idx, _bf16_np(new_xyz)


@pytest.mark.parametrize("B,N,D,S,K", [(2, 64, 0, 16, 8), (2, 96, 5, 12, 16),
                                       (1, 40, 13, 7, 5)])
def test_group_gather_bf16_plain_equals_jax_gather_cols(B, N, D, S, K):
    """#3's plain twin on a bf16 source (the card kernel's oracle) against
    JAX's interpreted ``gather_cols_pallas`` on the same bf16 source (its
    one-pass bf16 branch) followed by the bf16 centring of
    ``papc_tpu/ops/grouping.py:216-219``: the same bits."""
    xyz, feats, idx, new_xyz = _gather_case(B * N + D, B, N, D, S, K)
    combined = xyz if feats is None else np.concatenate([xyz, feats], -1)
    src_t = jnp.asarray(combined.transpose(0, 2, 1), jnp.bfloat16)
    out = gather_cols_pallas(src_t, jnp.asarray(idx.reshape(B, -1)),
                             interpret=True)
    grouped = out.transpose(0, 2, 1).reshape(B, S, K, -1)
    centre = jnp.asarray(new_xyz, jnp.bfloat16)[:, :, None, :]
    want = grouped.at[..., :3].add(-centre)
    assert want.dtype == jnp.bfloat16
    got = gather.group_gather(T(xyz).to(BF16),
                              None if feats is None else T(feats).to(BF16),
                              T(idx), T(new_xyz).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_array_equal(_bits(got), np.asarray(want).view(np.int16))


@pytest.mark.parametrize("B,N,C,S,K", [(2, 64, 3, 16, 8), (2, 96, 8, 12, 16),
                                       (1, 40, 16, 7, 5)])
def test_scatter_add_bf16_plain_within_one_ulp_of_jax(B, N, C, S, K):
    """#4's plain twin on a bf16 g against JAX's interpreted
    ``scatter_cols_add_pallas`` on the same bf16 g (f32 accumulation over
    the one-hot) cast to bf16 as the gather's VJP casts it to the
    source's dtype: within one bf16 ulp (both sum the same bf16 values in
    f32, in other orders, and round once)."""
    _, _, idx, _ = _gather_case(B * N + C + 1, B, N, 0, S, K)
    rs = np.random.RandomState(C)
    g = _bf16_np(rs.randn(B, S, K, C))
    g_t = jnp.asarray(g.reshape(B, S * K, C).transpose(0, 2, 1), jnp.bfloat16)
    out = scatter_cols_add_pallas(g_t, jnp.asarray(idx.reshape(B, -1)), N,
                                  interpret=True)
    want = np.asarray(out.transpose(0, 2, 1).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    got = gather.scatter_add(T(g).to(BF16), T(idx), N)
    assert got.dtype == BF16
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= _ulp(want))


def test_three_nn_interpolate_bf16_follows_jax():
    """The 3-NN interpolation on bf16 positions and features (the bf16
    seg step's feature propagation) against JAX's as its jitted train
    step computes it: squared norms summed in f32 and rounded once to
    bf16 (XLA keeps the squares in f32 inside the sum; JAX's eager call
    also rounds each square), the cross term in f32, f32 weights, bf16
    neighbours times f32 weights summed in f32, so an f32 result. Half
    the queries sit on a source, where the true distance is 0 and the
    bf16 norms leave about ±2^-8 |s|²: the weights ``1 / d`` leave the
    convex range (measured: up to 158 on this input, so any rounding of
    the features is amplified in JAX's step and the port's alike). The
    distances and the neighbours equal JAX's bit for bit; the result
    within 1e-6 of ``Σ |w_i f_i|`` (f32 rounding of the sum; measured
    2.9e-7)."""
    from papc_tpu.ops.grouping import knn as jknn
    from papc_tpu.ops.interpolate import three_nn_interpolate as jinterp

    from papc_tpu_torch.ops.grouping import knn
    from papc_tpu_torch.ops.interpolate import three_nn_interpolate

    rs = np.random.RandomState(0)
    xyz1 = rs.uniform(-1, 1, (2, 256, 3)).astype(np.float32)
    xyz2, pts2 = xyz1[:, ::2].copy(), rs.randn(2, 128, 16).astype(np.float32)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (xyz1, xyz2, pts2)]
    tx = [T(a).to(BF16) for a in (xyz1, xyz2, pts2)]
    want_d, want_i = jax.jit(lambda a, b: jknn(3, a, b))(jx[1], jx[0])
    got_d, got_i = knn(3, tx[1], tx[0])
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    want = jax.jit(jinterp)(*jx)
    got = three_nn_interpolate(*tx)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    w = 1.0 / (np.asarray(want_d, np.float64) + 1e-8)
    w /= w.sum(-1, keepdims=True)
    assert np.abs(w).max() > 100
    feats = np.stack([_np(jx[2])[b][np.asarray(want_i)[b]] for b in range(2)])
    scale = np.abs(feats * w[..., None]).sum(2)
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= 1e-6 * scale)


# ------------------------------------------------------- the bf16 step

def _jax_bf16_step(jmodel, variables, b, masks, lr, wd, mode="clas",
                   fused=True):
    """``make_train_step(precision="bf16")`` with the given dropout
    keep-masks, under ``override(enable=True, impl="jnp")`` where
    ``fused``, else on JAX's classic path: (loss, grads, new params, new
    batch_stats), flax-keyed numpy (``torch_parity.jax_step`` with the
    bf16 step)."""
    spec = ModelSpec(model=jmodel, input_kind="points", mode=mode)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    fresh = jax.tree_util.tree_map(jnp.array, variables)
    state = jtrainer.TrainState.create(
        apply_fn=jmodel.apply, params=fresh["params"],
        batch_stats=fresh["batch_stats"],
        tx=optax.chain(P._capture_grads(), jtrainer.make_optimizer(lr, wd)))

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            site = int(context.module.name.split("_")[-1])
            keep = 1.0 - context.module.rate
            return jnp.where(jnp.asarray(masks[site]), args[0] / keep, 0.0)
        return next_fun(*args, **kwargs)

    step, _ = jtrainer.make_train_step(spec, precision="bf16")
    with fnn.intercept_methods(intercept):
        with jfused.override(enable=fused, impl="jnp"):
            state, loss, _ = step(state, jb, jax.random.PRNGKey(1))
    for leaf in jax.tree_util.tree_leaves((state.params, state.batch_stats)):
        assert leaf.dtype == jnp.float32
    return (float(loss), jax.tree_util.tree_map(np.asarray, state.opt_state[0]),
            jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats))


def _port_bf16_step(make, variables, b, masks, lr, wd):
    model = P.port_model(make, variables)
    opt = make_optimizer(model.parameters(), lr, wd)
    loss, _ = train_step(model, opt, b, torch.device("cpu"),
                         dropout_masks=[T(m) for m in masks],
                         precision="bf16")
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
    grads = state_dict_to_flax({n: p.grad for n, p in
                                model.named_parameters()})
    return float(loss), grads, state_dict_to_flax(model.state_dict())


def test_train_step_bf16_matches_jax_bf16_step(monkeypatch):
    """The port's ``train_step(precision="bf16")`` against JAX's
    ``make_train_step(precision="bf16")`` under
    ``fused_mlp.override(enable=True, impl="jnp")`` (which runs in bf16),
    as ``test_train_step_bf16_matches_jax_fused_jnp_step``: B=32, N=192,
    npoints (128, 128), nsamples (16, 16), every SA stage on the fused
    passes on both sides, the same weights, statistics and dropout masks.

    Two choices make the comparison one of rounding only:
    - JAX's CPU ball query takes ``|s|²`` in bf16 for bf16 points (its
      TPU kernel widens to f32, ``ball_query.py:150,153``, as the port
      does): it picks other neighbours for a quarter of the queries. The
      test wraps JAX's ``query_ball_point`` with that widening.
    - The exact reference is the port's float64 step on the values the
      bf16 step computes with: points and parameters rounded to bf16
      (the f32 points would pick other neighbours).

    Measured: the loss 2.1e-3 from JAX's, the statistics 2.6e-3 of their
    largest; each gradient at most 42 % from JAX's in relative L2 (median
    23 %), with JAX's own a median 50 % from the float64 step; the port's
    no farther from float64 than 1.06 times JAX's (median 0.96); the Dense
    biases before a BN (true gradient 0, rounding noise on both sides)
    within 5.1e-2 of their module's largest gradient of JAX's. So: loss
    within 5e-3 relative, statistics within 5e-3 of their largest (and
    the updated parameters as ``compare_step`` holds them), every other
    gradient within 0.5 of JAX's in relative L2 and no farther from the
    float64 step than 1.25 times JAX's, the biases within 0.1 of their
    module's largest (the card smoke's ``NOISE_TOL``)."""
    widen = jgrouping.query_ball_point

    def widened(radius, nsample, xyz, new_xyz, **kw):
        return widen(radius, nsample, xyz.astype(jnp.float32),
                     new_xyz.astype(jnp.float32), **kw)

    monkeypatch.setattr(jgrouping, "query_ball_point", widened)
    P.permissive_fused_gate(monkeypatch)
    lr = wd = 1e-3
    B, npoints, nsamples, seed = 32, (128, 128), (16, 16), 7
    b = P.batch(B, 192, seed=seed)
    jmodel = JaxSSG(num_classes=16, npoints=npoints, nsamples=nsamples)
    variables = P.perturbed_variables(jmodel, "clas", b, seed)
    rs = np.random.RandomState(seed + 1)
    masks = [rs.uniform(size=(B, 512)) < 0.6, rs.uniform(size=(B, 256)) < 0.6]

    def make():
        return PointNet2SSGClas(num_classes=16, npoints=npoints,
                                nsamples=nsamples)

    want = _jax_bf16_step(jmodel, variables, b, masks, lr, wd)
    port = _port_bf16_step(make, variables, b, masks, lr, wd)
    rounded = {"params": jax.tree_util.tree_map(_bf16_np, variables["params"]),
               "batch_stats": variables["batch_stats"]}
    exact = P.port_step(make, rounded, dict(b, points=_bf16_np(b["points"])),
                        masks, lr, wd, torch.float64)[1]
    grads, w_grads = P.compare_step(port, want, variables, lr, wd, 5e-3,
                                    5e-3)
    norm = np.linalg.norm
    for key, g in grads.items():
        wg = w_grads[key]
        if P.is_noise(key, grads):
            P.close_to_max(g, wg, 0.1, P.module_scale(w_grads, key))
            continue
        assert norm(g - wg) <= 0.5 * norm(wg), key
        assert norm(g - exact[key]) <= 1.25 * norm(wg - exact[key]), key


def test_seg_train_step_bf16_matches_jax_bf16_step(monkeypatch):
    """The port's SSG seg ``train_step(precision="bf16")`` against JAX's
    ``make_train_step(precision="bf16")`` on JAX's classic path: JAX's
    fused path fails its bf16 seg step (the ``group_all`` stage
    concatenates bf16 positions with f32 features, and the fused pass's
    VJP returns a cotangent of the wrong dtype). The shapes of
    ``tests/test_torch_seg.py`` (full widths, B=2 x 256 points, SA
    stages cut to 128 and 32 centres), the same weights, statistics and
    dropout mask; JAX's ball query widened to f32, and the float64 step
    on bf16-rounded points and parameters the exact reference, as the
    classifier's test above.

    The feature propagation is the seg step's own: every coarser level's
    points are FPS centres, so half the 3-NN queries sit on a source,
    whose distance the bf16 squared norms leave at about ±2^-8 |s|²
    (``test_three_nn_interpolate_bf16_follows_jax``), and the weights
    ``1 / d`` amplify each side's rounding. So both bf16 steps sit about
    one norm from the float64 step. Measured: the loss 3.7e-4 from
    JAX's, the statistics 8.9e-3 of their largest; each gradient a median
    0.67 from JAX's in relative L2, JAX's a median 0.99 from float64; the
    port's no farther from float64 than 1.14 times JAX's (median 1.00).
    The Dense biases before a BN (true gradient 0) are held against the
    float64 step: JAX's classic path adds them in bf16 before its BN and
    reads up to 0.25 of its module's largest gradient, the port's fused
    passes 4e-3. So: the loss within 5e-3 relative, statistics within
    2e-2 of their largest, the median relative L2 to JAX's at most 1.0,
    every gradient no farther from float64 than 1.5 times JAX's and
    their median 1.25 times, the biases within 0.02 of their module's
    largest gradient of the float64 step."""
    from papc_tpu.models.segment import PointNet2SSGSeg as JaxSSGSeg

    from papc_tpu_torch.models.segment import PointNet2SSGSeg

    widen = jgrouping.query_ball_point

    def widened(radius, nsample, xyz, new_xyz, **kw):
        return widen(radius, nsample, xyz.astype(jnp.float32),
                     new_xyz.astype(jnp.float32), **kw)

    monkeypatch.setattr(jgrouping, "query_ball_point", widened)
    lr = wd = 1e-3
    npoints, nsamples = (128, 32), (16, 32)
    b = P.batch(2, 256, seed=8)
    jmodel = JaxSSGSeg(num_classes=16, num_parts=50, npoints=npoints,
                       nsamples=nsamples)
    variables = P.perturbed_variables(jmodel, "seg", b, 8)
    masks = [np.random.RandomState(9).uniform(size=(2, 256, 128)) < 0.5]

    def make():
        return PointNet2SSGSeg(num_classes=16, num_parts=50, npoints=npoints,
                               nsamples=nsamples)

    want = _jax_bf16_step(jmodel, variables, b, masks, lr, wd, mode="seg",
                          fused=False)
    port = _port_bf16_step(make, variables, b, masks, lr, wd)
    rounded = {"params": jax.tree_util.tree_map(_bf16_np, variables["params"]),
               "batch_stats": variables["batch_stats"]}
    exact = P.port_step(make, rounded, dict(b, points=_bf16_np(b["points"])),
                        masks, lr, wd, torch.float64)
    grads, w_grads = P.compare_step(port, want, variables, lr, wd, 5e-3,
                                    2e-2)
    norm, g64 = np.linalg.norm, exact[1]
    rels, ratios = [], []
    for key, g in grads.items():
        if P.is_noise(key, grads):
            P.close_to_max(g, g64[key], 0.02, P.module_scale(g64, key))
            continue
        rels.append(norm(g - w_grads[key]) / norm(w_grads[key]))
        ratios.append(norm(g - g64[key]) / norm(w_grads[key] - g64[key]))
    assert max(ratios) <= 1.5 and np.median(ratios) <= 1.25, ratios
    assert np.median(rels) <= 1.0, rels


@pytest.mark.parametrize("name,mode", [
    ("pointnet2_ssg", "clas"), ("pointnet2_ssg", "seg"),
    ("pointnet2_msg", "clas"), ("pointnet2_msg", "seg")])
def test_bf16_steps_keep_f32_state(monkeypatch, name, mode):
    """Each registry combination, three bf16 steps on 2 clouds of 128
    points (as ``tests/test_precision_bf16.py`` pins JAX's): after every
    step every parameter, Adam moment and BatchNorm running statistic is
    f32, the loss finite. SSG's grouping gather (#3) gets a bf16 source
    and its backward (#4) a bf16 gradient: no f32 copy on the way."""
    seen = []
    plain_gather, plain_scatter = (gather.group_gather_plain,
                                   gather.scatter_add_plain)
    monkeypatch.setattr(gather, "group_gather_plain", lambda *a: seen.append(
        ("gather", a[0].dtype)) or plain_gather(*a))
    monkeypatch.setattr(gather, "scatter_add_plain", lambda g, *a: seen.append(
        ("scatter", g.dtype)) or plain_scatter(g, *a))
    model = init_model(name, mode, 16, 50, 128, seed=0, device="cpu").model
    opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
    raw = next(iter(SyntheticLoader(2, n_points=128, batchsize=2, seed=1,
                                    with_pid=mode == "seg")()))
    batch = {k: v for k, v in raw._asdict().items() if v is not None}
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        loss, metric = train_step(model, opt, batch, torch.device("cpu"), gen,
                                  precision="bf16")
        assert bool(torch.isfinite(loss)) and loss.dtype == torch.float32
        state = [*model.parameters(), *model.buffers(),
                 *(v for s in opt.state.values() for k, v in s.items()
                   if k != "step")]
        assert {t.dtype for t in state if t.is_floating_point()} == {
            torch.float32}
    if name == "pointnet2_ssg":
        assert ("gather", BF16) in seen and ("scatter", BF16) in seen
        assert all(dt == BF16 for _, dt in seen)
    else:
        assert not seen
    with pytest.raises(ValueError, match="unknown precision"):
        train_step(model, opt, batch, torch.device("cpu"), gen,
                   precision="fp16")


def test_flax_bf16_layers(rng):
    """The dtype rules of flax 0.12's layers on bf16 parameters: Dense on
    a bf16 input gives bf16, on an f32 input computes in f32 (the bf16
    kernel widened); BatchNorm on bf16 gives bf16 with f32 statistics and
    f32 running statistics; dropout rounds ``x / keep`` in bf16 (flax's
    ``select(keep, x / keep_prob, 0)``). Each against flax on the same
    values: BatchNorm and dropout exactly; Dense in bf16 within one bf16
    ulp of the product (summed in another order, then rounded before the
    bias as flax rounds it) plus one of the result, in f32 within 1e-6."""
    from flax import linen as nn
    from papc_tpu_torch.nn.layers import BatchNorm, dense, dropout

    torch.set_grad_enabled(False)
    try:
        _check_flax_bf16_layers(rng, nn, BatchNorm, dense, dropout)
    finally:
        torch.set_grad_enabled(True)


def _check_flax_bf16_layers(rng, nn, BatchNorm, dense, dropout):

    x = _bf16_np(rng.randn(64, 12))
    w = _bf16_np(rng.randn(12, 5) / 4)
    bias = _bf16_np(rng.randn(5) / 4)
    lin = torch.nn.Linear(12, 5)
    with torch.no_grad():
        lin.weight.copy_(T(w.T))
        lin.bias.copy_(T(bias))
    params = {"params": {"kernel": jnp.asarray(w, jnp.bfloat16),
                         "bias": jnp.asarray(bias, jnp.bfloat16)}}
    lin_b = lin.to(BF16)
    for xin, dt in ((jnp.asarray(x, jnp.bfloat16), BF16),
                    (jnp.asarray(x, jnp.float32), torch.float32)):
        want = nn.Dense(5).apply(params, xin)
        got = dense(lin_b, T(np.asarray(xin.astype(jnp.float32))).to(dt))
        assert got.dtype == dt and str(want.dtype) == str(dt).split(".")[1]
        wf = np.asarray(want.astype(jnp.float32))
        dot = np.asarray(xin.astype(jnp.float32)) @ w
        bound = _ulp(wf) + (_ulp(dot) if dt == BF16 else 1e-6)
        assert np.all(np.abs(got.float().numpy() - wf) <= bound)
    scale, shift = _bf16_np(1 + rng.randn(12) / 4), _bf16_np(rng.randn(12))
    bn = BatchNorm(12)
    with torch.no_grad():
        bn.weight.copy_(T(scale))
        bn.bias.copy_(T(shift))
    bn = bn.to(BF16)
    bn.running_mean, bn.running_var = bn.running_mean.float(), \
        bn.running_var.float()
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale, jnp.bfloat16),
                            "bias": jnp.asarray(shift, jnp.bfloat16)},
                 "batch_stats": {"mean": jnp.zeros(12), "var": jnp.ones(12)}}
    want, upd = fbn.apply(variables, jnp.asarray(x, jnp.bfloat16),
                          mutable=["batch_stats"])
    got = bn.train()(T(x).to(BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got), np.asarray(want).view(np.int16))
    for name, leaf in (("running_mean", "mean"), ("running_var", "var")):
        ours = getattr(bn, name)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(),
                                   np.asarray(upd["batch_stats"][leaf]),
                                   rtol=1e-5, atol=1e-7)
    keep = rng.rand(64, 12) < 0.6
    got = dropout(T(x).to(BF16), 0.4, T(keep), None)
    want = jnp.where(jnp.asarray(keep), jnp.asarray(x, jnp.bfloat16) / 0.6,
                     0.0)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got), np.asarray(want).view(np.int16))
