"""The port's PointPillars training against the JAX package, on the CPU.

Both packages run in one process on the same numpy inputs; weights and
optimizer state cross through ``papc_tpu_torch.convert``. Tolerances:

- the nine losses, ``compute_loss`` and their gradients (f32): within
  1e-5 relative (1e-6 absolute), sums in another order;
- the rate schedules within 1e-6 relative (optax computes them in f32);
  the optimizers' state within 1e-5 relative, 1e-7 absolute, their
  parameters also within 1e-5 of the rate a step (optax's f32 bias
  corrections), over three steps;
- the running metrics exactly (sums of 0 / 1 values);
- the whole step over three steps at the tiny config of
  ``tests/test_torch_detect_target.py``, JAX's network built in the
  reference form (its four TPU rewrites off, the form the port runs).
  The sharp check is the port's float64 step against JAX's step function
  run op by op (``train_step.impl``) under ``jax.enable_x64``: loss and
  metrics within 1e-7, parameters and BatchNorm statistics within 1e-6
  of each tensor's largest (measured: 2.4e-9 and 8e-8; Adam divides
  each gradient by its own size, so float64 rounding of gradients near
  its epsilon reaches the parameters). Against JAX's jitted f32 step, as
  a user runs it: the first step's loss within 1e-5 and its other metrics
  within 1e-4 (a forward at the same weights; sums over a few positive
  anchors), also against the default build with the rewrites on, whose
  BatchNorm statistics after that step agree within 1e-4 of the largest
  (its upsample BatchNorm pools phase statistics in f32); later losses
  within 2e-3 (measured 2.7e-4) and the statistics within 5e-2 of the
  largest (measured 1.05e-2: the parameters' spread reaches the deep
  layers' variances). Each parameter tensor's move over the three f32
  steps is held, as a relative L2 distance, within 1e-3 of the float64
  op-by-op step's move (measured 1.5e-4) and within 0.5 of the jitted
  f32 step's (measured 0.33); a gradient of the wrong sign moves its
  tensor the other way, a distance near 2. XLA's jitted CPU step gives
  the PFN's parameters other gradients than JAX's op-by-op evaluation of
  the same step (in float64 up to 56 % of the PFN BatchNorm's largest;
  the RPN's agree within 1e-13, and the port's agree with the op-by-op
  ones within 1e-13), and the spread that leaves reaches every later
  layer's moves, so the jitted step is no sharper reference.
"""

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.detect import builders as jbuilders
from papc_tpu.detect import detector as jdetector
from papc_tpu.detect import losses as jlosses
from papc_tpu.detect.train import make_detection_train_step as jax_make_step
from papc_tpu.detect.train import make_pillarizer as jax_make_pillarizer
from papc_tpu.train import running_metrics as jrm
from papc_tpu.train.trainer import TrainState

from papc_tpu_torch import convert
from papc_tpu_torch.data.synthetic_kitti import SyntheticFrames, collate_batch
from papc_tpu_torch.detect import builders, detector, losses
from papc_tpu_torch.detect.config import Config, cfg_from_list
from papc_tpu_torch.detect.train import (make_detection_train_step,
                                         make_pillarizer)
from papc_tpu_torch.nn.layers import BatchNorm
from papc_tpu_torch.train import running_metrics as rm
from papc_tpu_torch.utils.profiling import StepTimer
from tests.test_torch_detect_target import (TINY_VOXELS, tiny_anchors,
                                            tiny_configs)
from tests.torch_parity import few_threads, perturb_stats  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")
T = torch.from_numpy
F32 = np.float32


# --------------------------------------------------------------- losses

def _loss_inputs(seed=0, C=3):
    rs = np.random.RandomState(seed)
    return {
        "pred": (2 * rs.randn(2, 50, C)).astype(F32),
        "target": rs.uniform(-1, 1, (2, 50, C)).astype(F32),
        "soft": rs.uniform(0, 1, (2, 50, C)).astype(F32),
        "onehot": np.eye(C, dtype=F32)[rs.randint(C, size=(2, 50))],
        "weights": rs.uniform(0, 2, (2, 50)).astype(F32),
    }


CODE_W = [1.0, 0.5, 2.0]
LOSSES = {
    "sigmoid_cross_entropy_with_logits": lambda m, x: (
        m.sigmoid_cross_entropy_with_logits(x["pred"], x["soft"])),
    "softmax_cross_entropy_with_logits": lambda m, x: (
        m.softmax_cross_entropy_with_logits(x["pred"], x["onehot"])),
    "weighted_l2_localization_loss": lambda m, x: (
        m.weighted_l2_localization_loss(x["pred"], x["target"], x["weights"],
                                        code_weights=CODE_W)),
    "weighted_smooth_l1_localization_loss": lambda m, x: (
        m.weighted_smooth_l1_localization_loss(
            x["pred"], x["target"], x["weights"], sigma=3.0,
            code_weights=CODE_W)),
    "weighted_smooth_l1_localization_loss_summed": lambda m, x: (
        m.weighted_smooth_l1_localization_loss(
            x["pred"], x["target"], x["weights"], sigma=1.5,
            codewise=False)),
    "weighted_sigmoid_classification_loss": lambda m, x: (
        m.weighted_sigmoid_classification_loss(x["pred"], x["onehot"],
                                                x["weights"])),
    "sigmoid_focal_classification_loss": lambda m, x: (
        m.sigmoid_focal_classification_loss(x["pred"], x["onehot"],
                                            x["weights"])),
    "sigmoid_focal_classification_loss_plain": lambda m, x: (
        m.sigmoid_focal_classification_loss(x["pred"], x["onehot"],
                                            x["weights"], gamma=0.0,
                                            alpha=None)),
    "softmax_focal_classification_loss": lambda m, x: (
        m.softmax_focal_classification_loss(x["pred"], x["onehot"],
                                            x["weights"])),
    "weighted_softmax_classification_loss": lambda m, x: (
        m.weighted_softmax_classification_loss(x["pred"], x["onehot"],
                                               x["weights"], logit_scale=2.0)),
    "bootstrapped_sigmoid_classification_loss_soft": lambda m, x: (
        m.bootstrapped_sigmoid_classification_loss(
            x["pred"], x["onehot"], x["weights"], alpha=0.7)),
    "bootstrapped_sigmoid_classification_loss_hard": lambda m, x: (
        m.bootstrapped_sigmoid_classification_loss(
            x["pred"], x["onehot"], x["weights"], alpha=0.7,
            bootstrap_type="hard")),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_jax(name):
    """Each loss and its gradient with respect to the prediction, on
    seeded inputs (every one of the nine functions appears)."""
    x = _loss_inputs()
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    want = np.asarray(LOSSES[name](jlosses, jx))
    r = np.random.RandomState(1).randn(*want.shape).astype(F32)
    w_grad = np.asarray(jax.grad(lambda p: jnp.sum(
        LOSSES[name](jlosses, {**jx, "pred": p}) * r))(jx["pred"]))
    tx = {k: T(v) for k, v in x.items()}
    tx["pred"].requires_grad_(True)
    got = LOSSES[name](losses, tx)
    (got * T(r)).sum().backward()
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tx["pred"].grad.numpy(), w_grad, rtol=1e-5,
                               atol=1e-6)


def _head_inputs(ncls_out, ncls, seed):
    rs = np.random.RandomState(seed)
    B, H, W, na = 2, 6, 5, 2
    A = H * W * na
    preds = {"box_preds": (0.5 * rs.randn(B, H, W, na * 7)).astype(F32),
             "cls_preds": rs.randn(B, H, W, na * ncls_out).astype(F32),
             "dir_cls_preds": rs.randn(B, H, W, na * 2).astype(F32)}
    labels = rs.randint(-1, ncls + 1, (B, A)).astype(np.int32)
    labels[1] = np.where(labels[1] > 0, 0, labels[1])  # a frame, no positive
    reg = (0.5 * rs.randn(B, A, 7)).astype(F32)
    anchors = np.concatenate([rs.uniform(0, 40, (B, A, 3)),
                              rs.uniform(1, 4, (B, A, 3)),
                              rs.uniform(-3, 3, (B, A, 1))], -1).astype(F32)
    return preds, labels, reg, anchors


@pytest.mark.parametrize("norm", ["NormByNumPositives", "NormByNumExamples",
                                  "NormByNumPosNeg"])
@pytest.mark.parametrize("ncls,background_as_zeros", [(1, True), (2, False)])
def test_compute_loss_matches_jax(norm, ncls, background_as_zeros):
    """``compute_loss`` in the ``[B, A, C]`` layout against JAX's
    production ``compute_loss`` (its ``[B, C, A]`` layout): the loss, every
    metric and the gradients of the three head maps; one frame has no
    positive anchor."""
    ncls_out = ncls if background_as_zeros else ncls + 1
    preds, labels, reg, anchors = _head_inputs(ncls_out, ncls, seed=ncls)
    kw = dict(num_class=ncls, encode_background_as_zeros=background_as_zeros,
              loss_norm_type=norm, pos_cls_weight=1.5, neg_cls_weight=0.7,
              code_weights=(1.0,) * 6 + (0.5,))
    jcfg, cfg = jdetector.LossConfig(**kw), detector.LossConfig(**kw)

    def jloss(p):
        return jdetector.compute_loss(p, jnp.asarray(labels), jnp.asarray(reg),
                                      jnp.asarray(anchors), jcfg)

    (w_loss, w_metrics), w_grads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: T(v).requires_grad_(True) for k, v in preds.items()}
    loss, metrics = detector.compute_loss(tp, T(labels), T(reg), T(anchors),
                                          cfg)
    loss.backward()
    assert set(metrics) == set(w_metrics)
    for k, v in w_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                   rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ("num_pos", "num_neg"):
        assert int(metrics[k]) == int(w_metrics[k])
    assert int(metrics["num_pos"]) > 0
    for k, g in w_grads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(tp[k].grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)


def test_loss_weights_and_direction_targets_match_jax():
    _, labels, reg, anchors = _head_inputs(1, 2, seed=3)
    for norm in ("NormByNumPositives", "NormByNumExamples",
                 "NormByNumPosNeg"):
        got = detector.prepare_loss_weights(T(labels), 1.5, 0.7, norm)
        want = jdetector.prepare_loss_weights(jnp.asarray(labels), 1.5, 0.7,
                                              norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    with pytest.raises(ValueError, match="norm type"):
        detector.prepare_loss_weights(T(labels), loss_norm_type="nope")
    for one_hot in (True, False):
        np.testing.assert_array_equal(
            detector.get_direction_target(T(anchors), T(reg),
                                          one_hot).numpy(),
            np.asarray(jdetector.get_direction_target(
                jnp.asarray(anchors), jnp.asarray(reg), one_hot)))
    b1, b2 = detector.add_sin_difference(T(reg), T(reg[::-1].copy()))
    w1, w2 = jdetector.add_sin_difference(jnp.asarray(reg),
                                          jnp.asarray(reg[::-1].copy()))
    np.testing.assert_allclose(b1.numpy(), np.asarray(w1), atol=1e-6)
    np.testing.assert_allclose(b2.numpy(), np.asarray(w2), atol=1e-6)
    loss = np.random.RandomState(4).rand(2, 60, 3).astype(F32)
    for shape in ((2, 60), (2, 60, 1), (2, 60, 3)):
        x = loss[..., 0] if len(shape) == 2 else loss[..., :shape[-1]]
        got = detector.get_pos_neg_loss(T(x), T(labels))
        want = jdetector.get_pos_neg_loss(jnp.asarray(x), jnp.asarray(labels))
        np.testing.assert_allclose([float(v) for v in got],
                                   [float(v) for v in want], rtol=1e-5)


# ------------------------------------------------ schedules, optimizers

SCHEDULES = {
    "constant_learning_rate": {},
    "exponential_decay_learning_rate": dict(decay_steps=10, decay_factor=0.8,
                                            staircase=True),
    "exponential_decay_smooth": dict(decay_steps=10, decay_factor=0.8,
                                     staircase=False),
    "exponential_decay_with_burnin": dict(decay_steps=10, decay_factor=0.5,
                                          burnin_learning_rate=1e-3,
                                          burnin_steps=5),
    "manual_step_learning_rate": dict(schedule=[
        {"step": 10, "learning_rate": 1e-4},
        {"step": 20, "learning_rate": 1e-5}]),
    "cosine_decay_learning_rate": dict(warmup_learning_rate=1e-5,
                                       warmup_steps=10, total_steps=40),
}


def _opt_cfg(name, schedule, lr=2e-3, **kw):
    lr_name = ("exponential_decay_learning_rate"
               if schedule == "exponential_decay_smooth" else schedule)
    return Config.wrap({"name": name, "learning_rate": {
        "name": lr_name, "initial_learning_rate": lr,
        **SCHEDULES[schedule]}, **kw})


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_lr_schedule_matches_optax(schedule):
    """Every schedule at steps 0, 1, d - 1, d and 3·d (d = 10: the decay
    step, the first manual boundary, the warmup's end). optax computes in
    f32: the warmup's ``(init - peak)·frac + peak`` rounds at the peak's
    magnitude, so the limit has an absolute part of 1e-6 of the peak."""
    cfg = _opt_cfg("adam_optimizer", schedule)
    got = builders.build_lr_schedule(cfg, 2e-3)
    want = jbuilders.build_lr_schedule(cfg, 2e-3)
    for step in (0, 1, 9, 10, 30):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-6 * 2e-3), step
    with pytest.raises(ValueError, match="unknown lr schedule"):
        builders.build_lr_schedule(Config.wrap(
            {"learning_rate": {"name": "nope"}}), 1.0)


class _Small(torch.nn.Module):
    """A Dense, a BatchNorm and a Conv: flax-keyed parameters of every
    layout ``convert`` maps."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(3, 4)
        self.BatchNorm_0 = BatchNorm(4)
        self.Conv_0 = torch.nn.Conv2d(2, 3, 3)


PARAM_ATOL = 3 * 1e-5 * 0.05  # three steps at a rate of at most 0.05
OPTAX_FIELDS = {"adam_optimizer": ("mu", "nu"),
                "momentum_optimizer": ("trace",),
                "rms_prop_optimizer": ("nu", "trace")}


def _params(model):
    return {k[len("params/"):]: v for k, v in
            convert.state_dict_to_flax(model.state_dict()).items()
            if k.startswith("params/")}


def _optax_fields(state, fields):
    found = {}
    for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda t: hasattr(t, "_fields")):
        for f in getattr(s, "_fields", ()):
            if f in fields:
                found.setdefault(f, convert.flatten(
                    jax.tree_util.tree_map(np.asarray, getattr(s, f))))
    return found


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("name", list(OPTAX_FIELDS))
def test_optimizer_matches_optax(name, wd):
    """``build_optimizer``'s optimizer and scheduler against JAX's optax
    chain over three steps of the same gradients, the rate halving every
    step (so RMSProp's rate inside its momentum trace shows); the optax
    state after step 1 carried into a fresh port optimizer
    (``optimizer_state_from_optax``) continues to the same parameters, and
    ``optimizer_state_to_optax`` gives back optax's state after step 3.
    optax takes Adam's bias corrections in f32 (its ``1 - 0.999`` is
    1.3e-5 off), torch in float64, so the parameters agree within 1e-5
    of the rate a step (``PARAM_ATOL``)."""
    cfg = _opt_cfg(name, "exponential_decay_learning_rate", lr=0.05,
                   weight_decay=wd, momentum=0.8, decay=0.85, epsilon=1e-6)
    cfg.learning_rate.decay_steps, cfg.learning_rate.decay_factor = 1, 0.5
    torch.manual_seed(0)
    model = _Small()
    start = copy.deepcopy(model)
    rs = np.random.RandomState(5)
    grads = [{n: torch.from_numpy(rs.randn(*p.shape).astype(F32))
              for n, p in model.named_parameters()} for _ in range(3)]
    flax_grads = [{k[len("params/"):]: jnp.asarray(v) for k, v in
                   convert.state_dict_to_flax(g).items()} for g in grads]

    tx = jbuilders.build_optimizer(cfg)
    params = {k: jnp.asarray(v) for k, v in _params(model).items()}
    state = tx.init(params)
    opt, sched = builders.build_optimizer(cfg, model.parameters())
    after_one = None
    for i, g in enumerate(grads):
        assert opt.param_groups[0]["lr"] == pytest.approx(0.05 * 0.5**i)
        upd, state = tx.update(flax_grads[i], state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
        for n, p in model.named_parameters():
            p.grad = g[n].clone()
        opt.step()
        sched.step()
        got = _params(model)
        for k, v in params.items():
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-5,
                                       atol=PARAM_ATOL, err_msg=f"step {i} {k}")
        if i == 0:
            after_one = (jax.tree_util.tree_map(np.asarray, state),
                         {k: np.asarray(v) for k, v in params.items()})

    # resume from optax's state after step 1
    resumed = copy.deepcopy(start)
    convert.load_flax_weights(resumed, {
        **{"params/" + k: v for k, v in after_one[1].items()},
        **{k: v for k, v in convert.state_dict_to_flax(
            start.state_dict()).items() if k.startswith("batch_stats/")}})
    opt2, sched2 = builders.build_optimizer(cfg, resumed.parameters())
    convert.optimizer_state_from_optax(resumed, opt2, after_one[0], sched2)
    assert opt2.param_groups[0]["lr"] == pytest.approx(0.025)
    for g in grads[1:]:
        for n, p in resumed.named_parameters():
            p.grad = g[n].clone()
        opt2.step()
        sched2.step()
    got = _params(resumed)
    for k, v in params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-5,
                                   atol=PARAM_ATOL, err_msg=f"resumed {k}")
    back = convert.optimizer_state_to_optax(resumed, opt2, sched2)
    assert int(back["count"]) == 3
    for field, want in _optax_fields(state, OPTAX_FIELDS[name]).items():
        assert set(back[field]) == set(want), field
        for k, v in want.items():
            np.testing.assert_allclose(back[field][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=f"{field} {k}")
    with pytest.raises(ValueError, match="unknown optimizer"):
        builders.build_optimizer(Config.wrap({
            "name": "nope", "learning_rate": {
                "name": "constant_learning_rate",
                "initial_learning_rate": 1.0}}), model.parameters())


# -------------------------------------------------- running metrics, timer

@pytest.mark.parametrize("background_as_zeros", [True, False])
def test_running_metrics_match_jax(background_as_zeros):
    """Two updates of each state from zero, with and without weights, and
    the scalar state: equal to JAX's."""
    rs = np.random.RandomState(6)
    C = 2 if background_as_zeros else 3
    kw = dict(encode_background_as_zeros=background_as_zeros)
    acc, pr = rm.AccuracyState.create(), rm.PrecisionRecallState.create()
    jacc, jpr = jrm.AccuracyState.create(), jrm.PrecisionRecallState.create()
    sc, jsc = rm.ScalarState.create(), jrm.ScalarState.create()
    for i in range(2):
        labels = rs.randint(-1, C + 1, (2, 300)).astype(np.int32)
        preds = (2 * rs.randn(2, 300, C)).astype(F32)
        weights = None if i == 0 else rs.uniform(0, 1, (2, 300)).astype(F32)
        tw = None if weights is None else T(weights)
        jw = None if weights is None else jnp.asarray(weights)
        acc = acc.update(T(labels), T(preds), tw, **kw)
        pr = pr.update(T(labels), T(preds), tw, **kw)
        jacc = jacc.update(jnp.asarray(labels), jnp.asarray(preds), jw, **kw)
        jpr = jpr.update(jnp.asarray(labels), jnp.asarray(preds), jw, **kw)
        sc, jsc = sc.update(float(i) + 0.5), jsc.update(float(i) + 0.5)
    for got, want in ((acc.total, jacc.total), (acc.count, jacc.count),
                      (acc.value, jacc.value), (sc.value, jsc.value)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for f in ("tp", "fp", "fn", "tn", "precision", "recall"):
        np.testing.assert_allclose(getattr(pr, f).numpy(),
                                   np.asarray(getattr(jpr, f)), rtol=1e-6,
                                   err_msg=f)
    assert float(pr.tp.sum()) > 0 and float(pr.fp.sum()) > 0


def test_step_timer_windows():
    """A window of two steps (``sync=False``, then a syncing stop), then
    one of a single step; ``discard`` drops an open window."""
    timer = StepTimer(device="cpu")
    timer.start()
    assert timer.stop(sync=False) is None
    timer.start()
    first = timer.stop()
    assert first is not None and first >= 0 and timer.count == 2
    timer.start()
    timer.discard()
    timer.start()
    assert timer.stop(sync=True) >= 0 and timer.count == 3
    timer.start()
    assert timer.stop(steps=2) >= 0 and timer.count == 5
    assert timer.avg == pytest.approx(timer.total / 5)


# ------------------------------------------------------- the whole step

CLASSIC = ("SCATTER_S2D", "PFN_FLAT", "RPN_DEFERRED_UPS", "RPN_BATCH_FOLD")
STEPS = 3
LR_DECAY = ["TRAIN_CONFIG.OPTIMIZER.learning_rate.decay_steps", "1"]


def _cast(b, dtype):
    return {k: v.astype(dtype) if v.dtype.kind == "f" else v
            for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items() if k != "reg_weights"}


def _jax_metrics(m):
    return {k: float(v) for k, v in m.items()}


def _jax_state(state):
    """A train state's (or a variables dict's) flat parameters and
    statistics as numpy arrays."""
    if hasattr(state, "params"):
        state = {"params": state.params, "batch_stats": state.batch_stats}
    return convert.flatten(jax.tree_util.tree_map(
        np.asarray, {k: state[k] for k in ("params", "batch_stats")}))


@pytest.fixture(scope="module")
def det():
    """The tiny config in both packages (the rate decaying every step:
    2e-4, 1.6e-4, 1.28e-4), three batches of two synthetic frames with the
    port's targets, seeded weights with perturbed running statistics, and
    JAX's runs: its jitted f32 step over the batches (the reference form),
    its op-by-op step in float64, and one jitted step of the default build
    (the four rewrites on)."""
    jcfg, cfg = tiny_configs()
    from papc_tpu.detect.config import cfg_from_list as jax_cfg_from_list

    jax_cfg_from_list(jcfg, LR_DECAY)
    cfg_from_list(cfg, LR_DECAY)
    ta, gen = tiny_anchors(cfg)
    frames = SyntheticFrames(2 * STEPS, gen["anchors"], max_points=3000,
                             seed=3, num_cars=4, n_background=2400,
                             target_assigner=ta,
                             matched_thresholds=gen["matched_thresholds"],
                             unmatched_thresholds=gen["unmatched_thresholds"])
    batches = [collate_batch([frames[2 * i], frames[2 * i + 1]])
               for i in range(STEPS)]

    jvg = jbuilders.build_voxel_generator(jcfg.VOXEL_GENERATOR)
    jta = jbuilders.build_target_assigner(
        jcfg.TARGET_ASSIGNER, jbuilders.build_box_coder(jcfg.BOX_CODER))
    jloss = jbuilders.build_loss_config(jcfg, jta)
    jpil = jax_make_pillarizer(jvg, TINY_VOXELS)
    default_model = jbuilders.build_network(jcfg, jvg, jta)
    for key in CLASSIC:
        jcfg.MODEL[key] = False
    jmodel = jbuilders.build_network(jcfg, jvg, jta)
    variables = jax.jit(lambda b: jmodel.init(
        jax.random.PRNGKey(0), *jpil(b), train=False))(_jax_batch(batches[0]))
    variables = perturb_stats(variables, 7)

    def fresh_state(v):
        return TrainState.create(
            apply_fn=jmodel.apply, params=v["params"],
            batch_stats=v["batch_stats"],
            tx=jbuilders.build_optimizer(jcfg.TRAIN_CONFIG.OPTIMIZER))

    out = {"cfg": cfg, "batches": batches, "variables": variables}
    step, init_rm = jax_make_step(jmodel, jloss, pillarize=jpil)
    state, r, metrics = fresh_state(jax.tree_util.tree_map(
        jnp.array, variables)), init_rm(), []
    for b in batches:
        state, m, r = step(state, _jax_batch(b), r)
        metrics.append(_jax_metrics(m))
    out["f32"] = (metrics, _jax_state(state))

    dstep, dinit = jax_make_step(default_model, jloss, pillarize=jpil)
    dstate, dm, _ = dstep(fresh_state(jax.tree_util.tree_map(
        jnp.array, variables)), _jax_batch(batches[0]), dinit())
    out["default_first"] = (_jax_metrics(dm), _jax_state(dstate))

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x), jnp.float64), variables)
        step64, init64 = jax_make_step(jmodel, jloss, pillarize=jpil)
        state, r, metrics = fresh_state(v64), init64(), []
        for b in batches:
            state, m, r = step64.impl(state, _jax_batch(_cast(b, np.float64)),
                                      r)
            metrics.append(_jax_metrics(m))
        out["x64"] = (metrics, _jax_state(state))
    return out


def _port_run(det, dtype):
    cfg = det["cfg"]
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    model = builders.build_network(cfg, vg, builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, coder))
    convert.load_flax_weights(model, jax.tree_util.tree_map(
        np.asarray, det["variables"]))
    model = model.to(dtype)
    opt, sched = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER,
                                          model.parameters())
    step, init_rm = make_detection_train_step(
        model, builders.build_loss_config(cfg, coder), opt, sched,
        make_pillarizer(vg, TINY_VOXELS), device="cpu")
    r, metrics, lrs = init_rm(), [], []
    for b in det["batches"]:
        lrs.append(opt.param_groups[0]["lr"])
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        m, r = step(_cast(b, np_dtype), r)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, convert.state_dict_to_flax(model.state_dict()), lrs, r


@pytest.fixture(scope="module")
def port_f32(det):
    return _port_run(det, torch.float32)


def test_train_step_float64_matches_jax_op_by_op(det):
    """The port's float64 step against JAX's step function run op by op
    in float64, over three steps: every metric a step, and the parameters
    and running statistics after."""
    metrics, state, lrs, _ = _port_run(det, torch.float64)
    w_metrics, w_state = det["x64"]
    assert lrs == pytest.approx([2e-4, 1.6e-4, 1.28e-4])
    for got, want in zip(metrics, w_metrics):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-7, abs=1e-12), k
    assert set(state) == set(w_state)
    for k, v in w_state.items():
        np.testing.assert_allclose(state[k], v, rtol=0,
                                   atol=1e-6 * np.abs(v).max(), err_msg=k)


def test_train_step_f32_matches_jax_jitted(det, port_f32):
    """The port's f32 step against JAX's jitted f32 step, its parameters'
    moves also against the float64 op-by-op step's (see the module
    docstring for the limits); the first step also against the default
    build. Positives, negatives and the running accuracy's inputs match
    exactly; the loss falls."""
    metrics, state, _, r = port_f32
    w_metrics, w_state = det["f32"]
    d_metrics, _ = det["default_first"]
    for want in (w_metrics[0], d_metrics):
        for k, v in want.items():
            rel = 1e-5 if k == "loss" else 1e-4
            assert metrics[0][k] == pytest.approx(v, rel=rel, abs=1e-6), k
    for got, want in zip(metrics, w_metrics):
        for k in ("num_pos", "num_neg"):
            assert got[k] == want[k]
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-3)
    assert metrics[-1]["loss"] < metrics[0]["loss"]
    start = _jax_state(det["variables"])
    _, x64_state = det["x64"]
    for k, v in w_state.items():
        if k.startswith("params/"):
            moved = state[k] - start[k]
            for want, limit in ((x64_state[k] - start[k], 1e-3),
                                (v - start[k], 0.5)):
                err = np.linalg.norm(moved - want) / np.linalg.norm(want)
                assert err < limit, (k, err)
    for k, v in w_state.items():
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(state[k], v, rtol=0,
                                       atol=5e-2 * np.abs(v).max(),
                                       err_msg=k)
    assert float(r["acc"].count) == sum(m["num_pos"] + m["num_neg"]
                                        for m in metrics)
    assert 0 <= metrics[-1]["rpn_acc"] <= 1


def test_first_step_statistics_match_jax(det):
    """One port step: the BatchNorm running statistics are flax's
    ``0.01·running + 0.99·batch`` of the batch, as JAX's jitted step of
    the default build gives them."""
    one = {**det, "batches": det["batches"][:1]}
    _, state, _, _ = _port_run(one, torch.float32)
    _, d_state = det["default_first"]
    stats = [k for k in d_state if k.startswith("batch_stats/")]
    assert len(stats) == 2 * 20  # PFN, 16 conv blocks' and 3 upsample BNs
    for k in stats:
        np.testing.assert_allclose(state[k], d_state[k], rtol=0,
                                   atol=1e-4 * np.abs(d_state[k]).max(),
                                   err_msg=k)


def test_train_step_contract():
    sig = inspect.signature(make_detection_train_step)
    assert sig.parameters["device"].default == "cuda"
    assert sig.parameters["precision"].default == "fp32"
    model = torch.nn.Linear(1, 1)
    with pytest.raises(ValueError, match="precision"):
        make_detection_train_step(model, detector.LossConfig(), None, None,
                                  None, "cpu", precision="fp16")
