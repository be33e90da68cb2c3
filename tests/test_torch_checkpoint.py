"""The port's checkpoints, optimizer state, checkpoint discovery and input
prefetch against the JAX package, on the CPU.

A checkpoint is JAX's layout without Orbax (``{model_dir}/{name}_{epoch}``,
a directory holding one ``numpy.savez`` file of flax-keyed variables,
optax's Adam state and the step): resuming from it continues a run bit
for bit; Adam's state carried over from optax continues JAX's run within
the f32 tolerance of ``test_adam_with_l2_matches_optax_chain``.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from papc_tpu.data import prefetch as jprefetch
from papc_tpu.train import trainer as jtrainer

from papc_tpu_torch import __main__ as cli
from papc_tpu_torch.convert import (flatten, load_flax_weights,
                                    optimizer_state_from_optax,
                                    optimizer_state_to_optax,
                                    state_dict_to_flax)
from papc_tpu_torch.data import SyntheticLoader, prefetch_to_device
from papc_tpu_torch.models.classify import PointNet2SSGClas
from papc_tpu_torch.train import (evaluate, latest_checkpoint_path,
                                  make_optimizer, restore_checkpoint,
                                  save_checkpoint, train, train_step)
from papc_tpu_torch.train.trainer import read_checkpoint

T = torch.from_numpy
CPU = torch.device("cpu")


def _small_model(seed=0):
    torch.manual_seed(seed)
    model = PointNet2SSGClas(npoints=(32, 16), nsamples=(8, 8))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    return model


def _batch(seed):
    raw = next(iter(SyntheticLoader(4, n_points=96, batchsize=4,
                                    seed=seed)()))
    return {k: v for k, v in raw._asdict().items() if v is not None}


def _masks(seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand(4, 512, generator=gen) < 0.6,
            torch.rand(4, 256, generator=gen) < 0.6]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_restored_checkpoint_continues_bit_for_bit(tmp_path, precision):
    """Two steps, a save, a restore into a fresh model and optimizer, then
    step 3 with the same batch and dropout masks: every parameter, Adam
    moment and running statistic equals the uninterrupted run's step 3
    bit for bit, and the restored step count is 2."""
    batches = [_batch(s) for s in (1, 2, 3)]
    masks = [_masks(s) for s in (4, 5, 6)]
    model = _small_model()
    opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
    for b, m in zip(batches[:2], masks[:2]):
        train_step(model, opt, b, CPU, dropout_masks=m, precision=precision)
    path = save_checkpoint(model, opt, str(tmp_path), "ssg", 1, step=2)
    assert path == os.path.abspath(tmp_path / "ssg_1")
    train_step(model, opt, batches[2], CPU, dropout_masks=masks[2],
               precision=precision)

    fresh = _small_model(seed=9)
    opt2 = make_optimizer(fresh.parameters(), 1e-3, 1e-3)
    assert restore_checkpoint(fresh, opt2, path) == 2
    train_step(fresh, opt2, batches[2], CPU, dropout_masks=masks[2],
               precision=precision)
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    for p, q in zip(model.parameters(), fresh.parameters()):
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][name], opt2.state[q][name]), name


def test_checkpoint_layout_and_replacement(tmp_path):
    """The saved names are JAX's: ``params/...`` and ``batch_stats/...``
    flax variables, ``opt_state/count``, ``opt_state/mu|nu/...`` with the
    params' keys, and ``step``; the file loads without pickles. A second
    save of the same epoch replaces the first whole and leaves no
    temporary directory."""
    model = _small_model()
    opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
    save_checkpoint(model, opt, str(tmp_path), "ssg", 0, step=0)
    arrays = read_checkpoint(str(tmp_path / "ssg_0"))
    flat = state_dict_to_flax(model.state_dict())
    params = [k for k in flat if k.startswith("params/")]
    want = set(flat) | {"opt_state/count", "step"} | {
        f"opt_state/{part}/{k[len('params/'):]}" for part in ("mu", "nu")
        for k in params}
    assert set(arrays) == want
    assert int(arrays["opt_state/count"]) == 0 and int(arrays["step"]) == 0
    assert all(not arrays[f"opt_state/mu/{k[7:]}"].any() for k in params)
    train_step(model, opt, _batch(1), CPU, dropout_masks=_masks(2))
    save_checkpoint(model, opt, str(tmp_path), "ssg", 0, step=1)
    assert os.listdir(tmp_path) == ["ssg_0"]
    assert os.listdir(tmp_path / "ssg_0") == ["checkpoint.npz"]
    again = read_checkpoint(str(tmp_path / "ssg_0"))
    assert int(again["step"]) == 1 and int(again["opt_state/count"]) == 1
    for k in params:
        np.testing.assert_array_equal(again[k], state_dict_to_flax(
            model.state_dict())[k])


def test_adam_state_from_optax_continues_jax_run(rng):
    """Two steps of optax's ``chain(add_decayed_weights, adam)`` on a
    model's flax-keyed parameters in JAX; their parameters and Adam state
    carried into the port (``optimizer_state_from_optax``: mu → exp_avg, nu →
    exp_avg_sq, count → step, kernels transposed); step 3 on the same
    gradients on both sides: the parameters within 1e-6, as
    ``test_adam_with_l2_matches_optax_chain`` holds torch's Adam to
    optax's. ``optimizer_state_to_optax`` gives back JAX's state after step 3
    within the same tolerance, its count exact."""
    lr, wd = 1e-2, 1e-1
    model = _small_model()
    flat = {k[len("params/"):]: v for k, v in
            state_dict_to_flax(model.state_dict()).items()
            if k.startswith("params/")}
    params = {k: jnp.asarray(v) for k, v in flat.items()}
    grads = [{k: jnp.asarray(rng.randn(*v.shape).astype(np.float32))
              for k, v in flat.items()} for _ in range(3)]
    tx = jtrainer.make_optimizer(lr, wd)
    update = jax.jit(tx.update)
    state = tx.init(params)
    for g in grads[:2]:
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
    load_flax_weights(model, {"params/" + k: np.asarray(v)
                              for k, v in params.items()} | {
        k: v for k, v in state_dict_to_flax(model.state_dict()).items()
        if k.startswith("batch_stats/")})
    opt = make_optimizer(model.parameters(), lr, wd)
    optimizer_state_from_optax(model, opt, jax.tree_util.tree_map(
        np.asarray, state))
    upd, state = update(grads[2], state, params)
    params = optax.apply_updates(params, upd)
    g3 = {k: torch.from_numpy(np.array(v)) for k, v in grads[2].items()}
    for name, p in model.named_parameters():
        key, = [k for k in state_dict_to_flax({name: p.detach()})]
        g = g3[key[len("params/"):]]
        p.grad = g.t().contiguous() if g.ndim == 2 else g
    opt.step()
    got = state_dict_to_flax(model.state_dict())
    for k, v in params.items():
        np.testing.assert_allclose(got["params/" + k], np.asarray(v),
                                   rtol=1e-6, atol=1e-6)
    back = optimizer_state_to_optax(model, opt)
    adam = state[1][0]
    assert int(back["count"]) == int(adam.count) == 3
    for part in ("mu", "nu"):
        want = flatten(getattr(adam, part))
        assert set(back[part]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(back[part][k], v, rtol=1e-6,
                                       atol=1e-6)


def test_latest_checkpoint_path_matches_jax(tmp_path):
    """The highest epoch of ``{name}_<epoch>`` wins (numerically: 10 over
    9); other names, suffixes and temporary directories are ignored; a
    missing directory or no match gives None. The same answers as JAX's
    function on the same directory."""
    for entry in ("pointnet2_ssg_1", "pointnet2_ssg_9", "pointnet2_ssg_10",
                  "pointnet2_msg_99", "pointnet2_ssg_11.tmp-4",
                  "pointnet2_ssg_x", "xpointnet2_ssg_12"):
        os.makedirs(tmp_path / entry)
    for name, want in (("pointnet2_ssg", "pointnet2_ssg_10"),
                       ("pointnet2_msg", "pointnet2_msg_99"),
                       ("pointnet", None)):
        got = latest_checkpoint_path(name, str(tmp_path))
        assert got == jtrainer.latest_checkpoint_path(name, str(tmp_path))
        assert got == (None if want is None else str(tmp_path / want))
    assert latest_checkpoint_path("pointnet2_ssg",
                                  str(tmp_path / "missing")) is None


def test_evaluate_without_weights_serves_the_latest_checkpoint(tmp_path,
                                                               capsys):
    """``train`` writes epochs 0 and 1; ``evaluate`` with neither weights
    nor a checkpoint path logs and serves ``{model_dir}/pointnet2_ssg_1``:
    the trained model's logits. The CLI's ``--evaluate`` with neither
    ``--weights`` nor ``--checkpoint`` does the same. With no checkpoint
    under ``model_dir``, ``FileNotFoundError`` with JAX's message."""
    loaders = {"train": SyntheticLoader(4, n_points=128, batchsize=4, seed=1),
               "val": SyntheticLoader(4, n_points=128, batchsize=4, seed=2)}
    model_dir = str(tmp_path / "model")
    model, _ = train("pointnet2_ssg", max_point=128, epoch_num=2,
                     batchsize=4, save_iter=1, model_dir=model_dir, make_loader=loaders.__getitem__,
                     device="cpu", log=lambda line: None)
    logs = []
    served = evaluate("pointnet2_ssg", make_loader=loaders.__getitem__,
                      split="val", max_point=128, model_dir=model_dir,
                      device="cpu",
                      log=logs.append)
    assert logs[0] == ("eval: restoring latest checkpoint "
                       f"{model_dir}/pointnet2_ssg_1")
    model.eval()
    with torch.inference_mode():
        want = model(T(loaders["val"].data))
    torch.testing.assert_close(served["logits"], want, rtol=1e-6, atol=1e-6)
    with pytest.raises(FileNotFoundError,
                       match=r"no .*/empty/pointnet2_ssg_<epoch> checkpoint "
                       "found — train first or pass --checkpoint explicitly"):
        evaluate("pointnet2_ssg", make_loader=loaders.__getitem__,
                 split="val", max_point=128,
                 model_dir=str(tmp_path / "empty"), device="cpu")

    from papc_tpu.data.synthetic import write_shapenet_h5

    data = write_shapenet_h5(str(tmp_path / "data"), n_train=0, n_test=2,
                             n_val=0, n_points=128, num_classes=16)
    assert cli.main(["--model_name", "pointnet2_ssg", "--evaluate", "--path",
                     data, "--max_point", "128",
                     "--batchsize", "2", "--model_dir", model_dir,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"restoring latest checkpoint {model_dir}/pointnet2_ssg_1" in out
    assert "eval[test]: loss=" in out


# -------------------------------------------------------------- prefetch

def _items():
    rs = np.random.RandomState(0)
    for i in range(7):
        yield {"points": rs.randn(2, 5, 3).astype(np.float32),
               "label": rs.randint(0, 4, (2,)).astype(np.int32),
               "tag": ("scan", i), "none": None}


def test_prefetch_yields_jax_items_in_jax_order():
    """The same iterable through the port's and JAX's
    ``prefetch_to_device`` (with the same ``transform``): the same items
    in the same order, arrays as tensors of the same values, non-array
    leaves (a tag tuple, ``None``) untouched."""
    def transform(item):
        return dict(item, scaled=item["points"] * 2)

    got = list(prefetch_to_device(_items(), size=2, transform=transform,
                                  device="cpu"))
    want = list(jprefetch.prefetch_to_device(_items(), size=2,
                                             transform=transform))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["tag"] == w["tag"] and g["none"] is None
        for k in ("points", "label", "scaled"):
            assert isinstance(g[k], torch.Tensor) and g[k].device == CPU
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_prefetch_raises_the_producers_exception():
    """An exception raised by the iterable (or the transform) after two
    items reaches the consumer after those items, in both packages."""
    def failing():
        yield {"x": np.ones(2)}
        yield {"x": np.zeros(2)}
        raise KeyError("loader broke")

    for prefetch in (prefetch_to_device, jprefetch.prefetch_to_device):
        it = (prefetch(failing(), size=2, device="cpu")
              if prefetch is prefetch_to_device else prefetch(failing()))
        assert len([next(it), next(it)]) == 2
        with pytest.raises(KeyError, match="loader broke"):
            next(it)
    it = prefetch_to_device(iter([1]), transform=lambda x: 1 / 0,
                            device="cpu")
    with pytest.raises(ZeroDivisionError):
        next(it)


@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_holds_at_most_size_items_ahead(size):
    """While the consumer holds still, the producer has drawn at most
    ``size`` items beyond those consumed plus the one it waits to put
    (the queue holds ``size``), as JAX's does; then every item comes."""
    for prefetch in ("port", "jax"):
        drawn = []
        more = threading.Event()

        def source():
            for i in range(20):
                drawn.append(i)
                if len(drawn) > size + 1:
                    more.set()
                yield {"i": np.asarray(i)}

        it = (prefetch_to_device(source(), size=size, device="cpu")
              if prefetch == "port"
              else jprefetch.prefetch_to_device(source(), size=size))
        first = next(it)
        assert int(first["i"]) == 0
        more.wait(0.5)
        assert len(drawn) <= 1 + size + 1, (prefetch, len(drawn))
        assert [int(x["i"]) for x in it] == list(range(1, 20))
