"""bf16 detection (``TRAIN_CONFIG.PRECISION: bf16``) against the JAX
package, on the CPU.

JAX's bf16 steps run the network on ``cast_floating`` bf16 copies of the
f32 parameters and of the float inputs, take the loss on the head maps
cast back to f32, keep the BatchNorm statistics f32 and serve the decode
and the NMS in f32 (``papc_tpu/detect/train.py:119-154``, ``:257-300``);
the port's do the same (``detect/train.py::head_maps``). Two correct bf16
steps differ, since sums in another order round differently, so as in
``tests/test_torch_precision.py`` each side is held against the exact
step, not one against the other: the port's float64 step on the
bf16-rounded weights and inputs. The detection step's gradients are very
sensitive to rounding at this tiny config: the port's f32 step from the
unrounded weights lies 0.2-0.7 (relative L2, most tensors) from the
exact step, both bf16 steps 0.3-0.9, and the two bf16 steps 0.45-1.1
from each other (median 0.64); the BatchNorm statistics of both bf16
steps lie up to 3 % of their largest from the exact step's. The
per-tensor distances are heavy-tailed noise (the port's over JAX's range
from 0.004 to 2), so the limits hold their aggregates: the median of the
port's distances over JAX's at most 1.25 and their mean at most 1.25
times JAX's (measured 0.84 / 0.85 flat, 0.95 / 0.93 grid), for the
gradients and for the statistics; each tensor as a guard against a gross
fault (a gradient of the wrong sign lies about 2 from the exact step) at
most 3 times as far as the farthest of JAX's bf16 step, the port's f32
step and 5 % for a gradient (measured at most 1.62), of JAX's and 1e-3
for the statistics (1.93); the loss within 5e-3 of JAX's, relative. The
serving heads: each side's bf16 heads against the f32 heads, the port's
at most 1.5 times as far as JAX's.

The batches come from the host prep of ``tests/test_torch_detect_host.py``
(the flat PFN, JAX's default for host pillarize, and the classic PFN on
the host's grid), two frames of the tiny grid; the weights are the
port's seeded ones with moved running statistics, carried to JAX by
``convert``. Also: ``cast_floating`` of the detection parameters
exactly, the f32 state after a bf16 step, the RPN's GroupNorm (the
3-class config's) in bf16 against flax's, and ``train()`` in bf16
through the CLI.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from papc_tpu.detect import builders as jbuilders
from papc_tpu.train.precision import cast_floating as jax_cast_floating

from papc_tpu_torch import convert
from papc_tpu_torch.detect import builders
from papc_tpu_torch.detect import train as dtrain
from papc_tpu_torch.detect.config import cfg_from_list, save_config
from papc_tpu_torch.detect.model import _RPNNorm
from papc_tpu_torch.train import checkpoint as ckpt
from papc_tpu_torch.train.precision import cast_floating
from tests.test_torch_detect_host import root  # noqa: F401
from tests.test_torch_detect_host import (NARROW, PFNS, _reader_caps, cast,
                                          host_batch, host_configs,
                                          jax_sgd_step, port_step,
                                          seeded_model)
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

T = torch.from_numpy
LIMITS = {"loss": 5e-3, "guard": 3.0, "grad_floor": 5e-2,
          "stats_floor": 1e-3, "median": 1.25, "mean": 1.25}


def _bf16(x):
    """``x`` rounded to bf16, back in its own dtype."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(x.dtype))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_cast_floating_of_the_detection_parameters_equals_jax(root):
    _, cfg = host_configs(root, True, NARROW)
    model, variables = seeded_model(cfg)
    got = cast_floating(dict(model.named_parameters()), torch.bfloat16)
    want = convert.flatten(jax_cast_floating(variables["params"],
                                             jnp.bfloat16))
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    assert all(v.dtype == jnp.bfloat16 for v in want.values())
    got = convert.state_dict_to_flax({k: v.float() for k, v in got.items()})
    assert set(got) == {"params/" + k for k in want}
    for k, w in want.items():
        np.testing.assert_array_equal(got["params/" + k],
                                      np.asarray(w).astype(np.float32))
    # the running statistics are no parameters: they stay f32
    assert all(b.dtype == torch.float32 for b in model.buffers()
               if b.is_floating_point())


@pytest.fixture(scope="module")
def bf16_steps(root):
    """Per PFN, on one host batch (4 096 points a frame): the port's bf16
    step, JAX's bf16 step run op by op, the port's float64 step on the
    bf16-rounded weights and inputs, the port's f32 step; the port's
    model and optimizer after its bf16 step."""
    out = {}
    for pfn, flat in PFNS.items():
        jcfg, cfg, _, batch = host_batch(
            root, flat, extra=_reader_caps(points=4096))
        model, variables = seeded_model(cfg)
        port = port_step(cfg, model, batch, precision="bf16")
        opt = port[3]
        want = jax_sgd_step(jcfg, variables, batch, precision="bf16")
        exact_model, _ = seeded_model(cfg)
        with torch.no_grad():
            for p in exact_model.parameters():
                p.copy_(p.bfloat16().float())
        rounded = {k: _bf16(v) if k in ("points_flat", "voxels") else v
                   for k, v in batch.items()}
        exact = port_step(cfg, exact_model, cast(rounded, np.float64),
                          torch.float64)
        f32 = port_step(cfg, seeded_model(cfg)[0], batch)
        out[pfn] = (port[:3], want, exact[:3], (model, opt), f32[:3])
    return out


@pytest.mark.parametrize("pfn", list(PFNS))
def test_bf16_train_step_against_jax(bf16_steps, pfn):
    (metrics, grads, stats), (w_metrics, w_grads, w_stats), \
        (_, g64, s64), _, (_, g32, _) = bf16_steps[pfn]
    assert np.isfinite(metrics["loss"])
    assert metrics["loss"] == pytest.approx(w_metrics["loss"],
                                            rel=LIMITS["loss"])
    for k in ("num_pos", "num_neg"):
        assert metrics[k] == w_metrics[k]
    assert set(grads) == set(w_grads) == set(g64)
    _hold(grads, w_grads, g64, _rel,
          lambda k: max(_rel(g32[k], g64[k]), LIMITS["grad_floor"]))

    def of_largest(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert set(stats) == set(w_stats) == set(s64)
    _hold(stats, w_stats, s64, of_largest, lambda k: LIMITS["stats_floor"])


def _hold(mine, jaxs, exact, dist, floor):
    """Each side's distance ``dist`` from ``exact``, the port's against
    JAX's: their median ratio and mean ratio, and each key's guard over
    the farther of JAX's and ``floor(key)``."""
    d_port = {k: dist(v, exact[k]) for k, v in mine.items()}
    d_jax = {k: dist(v, exact[k]) for k, v in jaxs.items()}
    guard = {k: d_port[k] / max(d_jax[k], floor(k)) for k in d_port}
    worst = max(guard, key=guard.get)
    assert guard[worst] <= LIMITS["guard"], (worst, d_port[worst],
                                             d_jax[worst])
    median = np.median([d_port[k] / max(d_jax[k], 1e-30) for k in d_port])
    assert median <= LIMITS["median"], median
    mean = np.mean(list(d_port.values())) / np.mean(list(d_jax.values()))
    assert mean <= LIMITS["mean"], mean


@pytest.mark.parametrize("pfn", list(PFNS))
def test_bf16_step_keeps_the_state_f32(bf16_steps, pfn):
    """The parameters take f32 gradients, and they, Adam's moments and
    the running statistics stay f32 after a bf16 step; the statistics
    moved."""
    model, opt = bf16_steps[pfn][3]
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers()
               if b.is_floating_point())
    moments = [opt.state[p][k] for p in model.parameters()
               for k in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 2 * len(list(model.parameters()))
    assert all(m.dtype == torch.float32 for m in moments)
    bn = model.pfn.PFNLayer_0.BatchNorm_0
    assert bn.running_var.dtype == torch.float32
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))


def _heads(model, cfg, batch, bf16):
    """The network's head maps of ``batch`` in eval mode, as the serving
    step computes them (``detect.train.head_maps``)."""
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    model.eval()
    b = dtrain.batch_to_device(batch, torch.device("cpu"))
    with torch.inference_mode():
        return {k: v.numpy() for k, v in dtrain.head_maps(
            model, b, dtrain.make_pillarizer(vg, 800), bf16).items()}


def _jax_heads(jcfg, variables, batch, bf16):
    jvg = jbuilders.build_voxel_generator(jcfg.VOXEL_GENERATOR)
    jta = jbuilders.build_target_assigner(
        jcfg.TARGET_ASSIGNER, jbuilders.build_box_coder(jcfg.BOX_CODER))
    jmodel = jbuilders.build_network(jcfg, jvg, jta)
    params = variables["params"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    points, voxels = jb.get("points_flat"), jb.get("voxels")
    if bf16:
        params = jax_cast_floating(params, jnp.bfloat16)
        points = None if points is None else points.astype(jnp.bfloat16)
        voxels = None if voxels is None else voxels.astype(jnp.bfloat16)
    out = jmodel.apply({"params": params,
                        "batch_stats": variables["batch_stats"]}, voxels,
                       jb["num_points"], jb["coordinates"], train=False,
                       points=points, point_pillar=jb.get("point_pillar"))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


@pytest.mark.parametrize("pfn", list(PFNS))
def test_bf16_serving_against_jax(root, pfn):
    """The bf16 head maps of an eval batch, each side's against the f32
    maps of the same weights; then ``make_predict_step(precision="bf16")``
    serves f32 detections from them."""
    jcfg, cfg, _, batch = host_batch(root, PFNS[pfn], training=False)
    model, variables = seeded_model(cfg, seed=3)
    f32 = _heads(model, cfg, batch, False)
    got = _heads(model, cfg, batch, True)
    want = _jax_heads(jcfg, variables, batch, True)
    w32 = _jax_heads(jcfg, variables, batch, False)
    for k, v in f32.items():
        np.testing.assert_allclose(v, w32[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        port_err, jax_err = _rel(got[k], v), _rel(want[k], v)
        assert 0 < port_err <= 1.5 * jax_err, (k, port_err, jax_err)
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    pcfg = builders.build_predict_config(cfg, coder)
    dets = {p: dtrain.make_predict_step(
        model, pcfg, coder, dtrain.make_pillarizer(vg, 800), device="cpu",
        precision=p)(batch) for p in ("fp32", "bf16")}
    assert dets["bf16"]["box3d_lidar"].dtype == torch.float32
    assert dets["bf16"]["scores"].dtype == torch.float32
    assert (dets["bf16"]["valid"].sum(-1) > 0).all()
    assert torch.isfinite(dets["bf16"]["box3d_lidar"]).all()
    assert all(b.dtype == torch.float32 for b in model.buffers()
               if b.is_floating_point())
    with pytest.raises(ValueError, match="precision"):
        dtrain.make_predict_step(model, pcfg, coder, None, "cpu",
                                 precision="fp16")


def test_rpn_group_norm_in_bf16_equals_flax():
    """The 3-class config's RPN norm (flax's ``GroupNorm``, 32 groups,
    epsilon 1e-3) on a bf16 map with bf16 scale and bias: flax computes
    in f32 and rounds once; torch's bf16 group norm computes in f32 too,
    its affine in another order, so a value next to a bf16 rounding
    boundary may take the other neighbour: every element within one bf16
    ulp, and the output bf16."""
    rs = np.random.RandomState(0)
    x = (3 * rs.randn(2, 12, 10, 64) + 1).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rs.randn(64).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale, jnp.bfloat16),
                            "bias": jnp.asarray(bias, jnp.bfloat16)}}
    want = fnn.GroupNorm(num_groups=32, epsilon=1e-3).apply(
        variables, jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    owner, rpn_norm = torch.nn.Module(), _RPNNorm(True, True, 32)
    rpn_norm.add(owner, 0, 64)
    with torch.no_grad():
        owner.GroupNorm_0.weight.copy_(T(scale))
        owner.GroupNorm_0.bias.copy_(T(bias))
        owner.bfloat16()  # the bf16 step's parameter casts
        got = rpn_norm(owner, 0, T(x).bfloat16().permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() > 0.99


def test_train_cli_in_bf16_with_host_pillarize(root, tmp_path):
    """``train()`` through the CLI with ``--set TRAIN_CONFIG.PRECISION bf16
    MODEL.DEVICE_PILLARIZE False``: three steps with a finite loss, a
    checkpoint of f32 arrays, then ``evaluate``."""
    _, cfg = host_configs(root, True, NARROW)
    cfg_from_list(cfg, ["MODEL.DEVICE_PILLARIZE", "True"])
    path = str(tmp_path / "cfg.json")
    save_config(cfg, path)
    model_dir = str(tmp_path / "model")
    args = ["--cfg_file", path, "--model_dir", model_dir, "--device", "cpu",
            "--set", "TRAIN_CONFIG.PRECISION", "bf16",
            "MODEL.DEVICE_PILLARIZE", "False"]
    assert dtrain.main(["train", *args, "--max_steps", "3",
                        "--display_step", "1"]) == 0
    lines = pathlib.Path(model_dir, "log.txt").read_text().splitlines()
    losses = [float(line.split("loss=")[1].split(",")[0]) for line in lines]
    assert len(losses) == 3 and np.isfinite(losses).all()
    saved = json.loads(pathlib.Path(model_dir, "pipeline.config")
                       .read_text())
    assert saved["TRAIN_CONFIG"]["PRECISION"] == "bf16"
    arrays = ckpt.try_restore_latest(model_dir, dtrain.MODEL_NAME)
    assert int(arrays["step"]) == 3
    assert all(v.dtype == np.float32 for k, v in arrays.items()
               if k.startswith(("params/", "batch_stats/", "opt_state/mu")))
    assert dtrain.main(["evaluate", *args]) == 0
