"""Helpers shared by the port's model and training-step parity tests
(``tests/test_torch_msg.py``, ``tests/test_torch_seg.py``,
``tests/test_torch_zoo.py``): the same numpy inputs and flax weights
through a JAX model and its port, one training step on each side, and
the comparisons with their tolerances. ``kind`` is the model's input
kind (``"points"``, ``"kd"`` or ``"voxel"``), which picks its inputs as
the trainers' ``model_inputs`` do."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn

from papc_tpu.models.registry import ModelSpec
from papc_tpu.ops import fused_mlp as jfused
from papc_tpu.train import trainer as jtrainer

from papc_tpu_torch.convert import (flatten, load_flax_weights,
                                    state_dict_to_flax)
from papc_tpu_torch.data import make_cloud
from papc_tpu_torch.nn import SetAbstraction, SetAbstractionMsg
from papc_tpu_torch.ops import fused_mlp
from papc_tpu_torch.train import make_optimizer, train_step
from papc_tpu_torch.train.evaluate import model_inputs

T = torch.from_numpy
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads for a module's torch ops, then the count it
    found. The suite runs in six worker processes on the host's cores,
    and torch's default of a thread a core in each of them oversubscribes
    the cores: four such processes of ``tests/test_torch_learning.py``
    at once had passed 4 of its 6 tests after 900 s, where with two
    threads each they took 35-38 s (26 s alone with the default)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def close_to_max(got, want, rel, scale=0.0):
    """Each entry within ``rel`` of the largest magnitude of ``want`` (or
    of ``scale``, for a tensor that is rounding noise around 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rel * max(float(np.abs(want).max()), scale, 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def batch(B, N, num_classes=16, seed=0):
    """``{"points", "label", "pid", "mask"}`` of ``B`` synthetic clouds,
    the part labels by octant."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(num_classes, size=B).astype(np.int32)
    clouds = [make_cloud(rs, int(y), N, num_classes) for y in labels]
    return {"points": np.stack([c[0] for c in clouds]), "label": labels,
            "pid": np.stack([c[1] for c in clouds]),
            "mask": np.ones(B, bool)}


def inputs(mode, b, kind="points"):
    """The JAX model's positional inputs for a batch."""
    spec = ModelSpec(model=None, input_kind=kind, mode=mode)
    return jtrainer.model_inputs(spec, jax.tree_util.tree_map(jnp.asarray, b))


def cast_floats(b, dtype):
    """``b`` with its floating arrays (points, voxels) cast to ``dtype``."""
    return {k: v.astype(dtype) if isinstance(v, np.ndarray)
            and v.dtype.kind == "f" else v for k, v in b.items()}


def perturbed_variables(jmodel, mode, b, seed, kind="points"):
    """flax's initial values with running statistics away from (0, 1),
    as a trained model's are."""
    variables = jax.jit(lambda *x: jmodel.init(jax.random.PRNGKey(seed), *x,
                                               train=False))(
        *inputs(mode, b, kind))
    return perturb_stats(variables, seed + 1)


def perturb_stats(variables, seed):
    """Running means ~ N(0, 0.1²) and variances in [0.5, 2)."""
    rs = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (
            jnp.asarray(0.1 * rs.randn(*v.shape), jnp.float32) if k == "mean"
            else jnp.asarray(rs.uniform(0.5, 2.0, v.shape), jnp.float32))
            for k, v in tree.items()}

    return {"params": variables["params"],
            "batch_stats": walk(variables.get("batch_stats", {}))}


def port_model(make, variables):
    model = make()
    load_flax_weights(model, jax.tree_util.tree_map(np.asarray, variables))
    return model


def jax_eval(jmodel, mode, variables, b, kind="points"):
    return np.asarray(jax.jit(lambda v, *x: jmodel.apply(v, *x, train=False))(
        variables, *inputs(mode, b, kind)))


def port_eval(model, mode, b, operand_dtype=F32):
    assert model.mode == mode
    args = model_inputs(model, b, torch.device("cpu"))
    with fused_mlp.override(impl="plain", operand_dtype=operand_dtype):
        with torch.inference_mode():
            return model.eval()(*args).numpy()


def permissive_fused_gate(monkeypatch):
    """``fused_mlp.supported``'s row-count and alignment rules fit the
    TPU's tiles, not the arithmetic: the jnp twins compute the same
    function at any shape. Open the gate to every grouped tensor, so at
    a small batch every SA stage (group_all too) runs the fused passes
    on the JAX side as it does on the port's."""
    monkeypatch.setattr(jfused, "supported",
                        lambda shape, feats: len(shape) == 4 and bool(feats))


def _capture_grads():
    """An optax transform that keeps the incoming gradients in its state
    and passes them on unchanged."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def jax_step(jmodel, mode, variables, b, masks, lr, wd, fused,
             fused_mode="stream", kind="points", precision="fp32"):
    """One ``make_train_step(precision=precision)`` step with the given
    dropout keep-masks (by the Dropout module's index): (loss, grads, new
    params, new batch_stats), flax-keyed numpy. ``fused``: under
    ``override(enable=True, impl="jnp", mode=fused_mode)``, every key in
    the one call (entering an override resets the keys it is not given)."""
    spec = ModelSpec(model=jmodel, input_kind=kind, mode=mode)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    fresh = jax.tree_util.tree_map(jnp.array, variables)  # step donates
    state = jtrainer.TrainState.create(
        apply_fn=jmodel.apply, params=fresh["params"],
        batch_stats=fresh.get("batch_stats", {}),
        tx=optax.chain(_capture_grads(), jtrainer.make_optimizer(lr, wd)))

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            site = int(context.module.name.split("_")[-1])
            keep = 1.0 - context.module.rate
            return jnp.where(jnp.asarray(masks[site]), args[0] / keep, 0.0)
        return next_fun(*args, **kwargs)

    step, _ = jtrainer.make_train_step(spec, precision=precision)
    with fnn.intercept_methods(intercept):
        if fused:
            with jfused.override(enable=True, impl="jnp", mode=fused_mode):
                state, loss, _ = step(state, jb, jax.random.PRNGKey(1))
        else:
            state, loss, _ = step(state, jb, jax.random.PRNGKey(1))
    grads = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
    return (float(loss), grads,
            jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats))


def port_step(make, variables, b, masks, lr, wd, dtype, fused_mode="stream",
              precision="fp32"):
    """One port step from the same weights; ``dtype`` float64 runs the
    whole model and the plain passes in float64 (the exact reference).
    ``fused_mode`` goes into the same ``override`` call as ``impl`` and
    ``operand_dtype``: a nested override would put it back to stream."""
    model = port_model(make, variables)
    if dtype == torch.float64:
        model = model.double()
        b = cast_floats(b, np.float64)
    opt = make_optimizer(model.parameters(), lr, wd)
    with fused_mlp.override(impl="plain", operand_dtype=dtype,
                            mode=fused_mode):
        loss, _ = train_step(model, opt, b, torch.device("cpu"),
                             dropout_masks=[T(m) for m in masks],
                             precision=precision)
    grads = state_dict_to_flax({n: p.grad for n, p in
                                model.named_parameters()})
    return float(loss), grads, state_dict_to_flax(model.state_dict())


def is_noise(key, keys):
    """A Dense bias that feeds a BatchNorm: its true gradient is 0, so
    both sides hold rounding noise."""
    *path, leaf = key.split("/")
    if leaf != "bias" or not path[-1].startswith("Dense_"):
        return False
    bn = "/".join(path[:-1] + ["BatchNorm_" + path[-1].split("_")[1], "scale"])
    return bn in keys


def module_scale(grads, key):
    """The largest gradient of ``key``'s module (for a leaf at the top of
    the tree, of the top-level leaves: the inline head)."""
    group = key.rsplit("/", 2)[0]
    if group == "params":
        members = [k for k in grads if k.count("/") == 2]
    else:
        members = [k for k in grads if k.startswith(group + "/")]
    return max(float(np.abs(grads[k]).max()) for k in members)


def compare_step(port, want, variables, lr, wd, rel_loss, rel_stats):
    """Loss, every updated parameter and BN statistic (the gradients are
    the callers'). Adam's first step is ``lr·g'/(|g'| + 1e-8)`` with
    ``g' = g + wd·p``, about ``lr·sign(g')``: where both sides' ``g'``
    have one sign and are above 1e-5 the updated parameters agree within
    2e-6; elsewhere (noise-level gradients) within ``2·lr``."""
    loss, grads, state = port
    w_loss, w_grads, w_params, w_stats = want
    assert loss == pytest.approx(w_loss, rel=rel_loss)
    w_grads = flatten({"params": w_grads})
    old = flatten({"params": jax.tree_util.tree_map(np.asarray,
                                                    variables["params"])})
    assert set(grads) == set(w_grads)
    for key, want_p in flatten({"params": w_params}).items():
        gp, gj = grads[key] + wd * old[key], w_grads[key] + wd * old[key]
        agree = (np.sign(gp) == np.sign(gj)) & (
            np.minimum(np.abs(gp), np.abs(gj)) > 1e-5)
        got = state[key]
        np.testing.assert_allclose(got[agree], want_p[agree], rtol=0,
                                   atol=2e-6)
        np.testing.assert_allclose(got, want_p, rtol=0, atol=2 * lr + 1e-6)
    for key, want_s in flatten({"batch_stats": w_stats}).items():
        close_to_max(state[key], want_s, rel_stats)
    return grads, w_grads


def jax_step_x64(jmodel, mode, variables, b, masks, lr, wd, kind="points"):
    """:func:`jax_step` on JAX's classic path in float64 (weights and
    points or voxels cast up), the JAX side's exact reference."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x), jnp.float64), variables)
        return jax_step(jmodel, mode, v64, cast_floats(b, np.float64), masks,
                        lr, wd, fused=False, kind=kind)


def check_f32_step(port, want, exact, want64, variables, lr, wd, tol):
    """The f32 step against JAX's classic f32 step ``want``, with the
    port's float64 step ``exact`` and JAX's float64 step ``want64`` as
    the references that set the tolerances (``tol``, each a fraction of
    the largest gradient of the module or of the loss):

    - ``"port"``: the port's f32 step from its own float64 step;
    - ``"jax"``: JAX's f32 step from the port's float64 step (XLA's CPU
      reductions sum in f32 in order, over up to 262 144 rows a BN);
    - ``"x64"``: the two float64 steps from each other (the port picks
      neighbours and takes the loss in f32 at every precision, JAX in
      float64, so a point within rounding of a radius can differ).
    """
    grads, w_grads = compare_step(port, want, variables, lr, wd,
                                  tol["loss"], 1e-4)
    assert port[0] == pytest.approx(exact[0], rel=1e-5)
    assert want64[0] == pytest.approx(exact[0], rel=1e-5)
    g64, w64 = exact[1], flatten({"params": want64[1]})
    for key, g in grads.items():
        scale = module_scale(g64, key)
        close_to_max(g, g64[key], tol["port"], scale)
        close_to_max(w_grads[key], g64[key], tol["jax"], scale)
        close_to_max(w64[key], g64[key], tol["x64"], scale)


def check_bf16_step(port, want, exact, variables, lr, wd, lim):
    """A bf16 step against JAX's fused bf16 step ``want``, both judged
    against the port's float64 step ``exact``. Two correct bf16 steps
    differ: stored activations tie within a group and the max's gradient
    goes to whichever tied row comes first, so which row takes it flips
    with the order of a sum. The limits ``lim``:

    - ``"loss"``: the loss within this of JAX's, relative;
    - ``"stats"``: the BN statistics within this of their largest;
    - ``"ratio"``: every gradient at most this many times as far from
      the float64 step as JAX's (``"median_ratio"``: their median);
    - ``"median_rel"``: the median relative L2 distance from JAX's;
    - ``"noise"``: the Dense biases before a BN (true gradient 0) within
      this of their module's largest gradient.
    """
    grads, w_grads = compare_step(port, want, variables, lr, wd,
                                  lim["loss"], lim["stats"])
    norm, g64 = np.linalg.norm, exact[1]
    rels, ratios = [], {}
    for key, g in grads.items():
        wg = w_grads[key]
        ratios[key] = norm(g - g64[key]) / max(norm(wg - g64[key]), 1e-30)
        if is_noise(key, grads):
            close_to_max(g, wg, lim["noise"], module_scale(w_grads, key))
        else:
            rels.append(norm(g - wg) / max(norm(wg), 1e-30))
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= lim["ratio"], (worst, ratios[worst])
    assert np.median(list(ratios.values())) <= lim["median_ratio"]
    assert np.median(rels) <= lim["median_rel"], np.median(rels)


def stack_shapes(model, batch=32):
    """``(stage, m, k, c0, widths)`` of every fused SA stack of a model at
    ``batch`` clouds: K is the ball-query size, or for ``group_all`` the
    previous stage's centre count (one centre a cloud)."""
    out, prev = [], None
    for name, mod in model.named_modules():
        if isinstance(mod, SetAbstraction):
            mlps = [(mod.PointMLP_0, prev if mod.group_all else mod.nsample)]
            centres = 1 if mod.group_all else mod.npoint
        elif isinstance(mod, SetAbstractionMsg):
            mlps = [(getattr(mod, f"PointMLP_{i}"), k)
                    for i, k in enumerate(mod.nsample_list)]
            centres = mod.npoint
        else:
            continue
        for mlp, k in mlps:
            out.append((name, batch * centres * k, k,
                        mlp.Dense_0.in_features, mlp.features))
        prev = mod.npoint
    return out
