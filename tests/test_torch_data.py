"""The port's data, metrics and evaluate path against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.data.shapenet import ShapeNetLoader as JaxLoader
from papc_tpu.data.synthetic import _make_cloud, write_shapenet_h5
from papc_tpu.train import metrics as jmetrics

from papc_tpu_torch import __main__ as cli
from papc_tpu_torch.convert import state_dict_to_flax
from papc_tpu_torch.data import ShapeNetLoader, SyntheticLoader, make_cloud
from papc_tpu_torch.models import init_model
from papc_tpu_torch.train import evaluate, metrics


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_shapenet_h5(str(tmp_path_factory.mktemp("shapenet")),
                             n_train=23, n_test=7, n_val=5, n_points=96,
                             num_classes=4, num_parts=8, seed=3)


@pytest.mark.parametrize("mode,with_pid,bs", [
    ("train", False, 5), ("train", True, 8), ("test", False, 3),
    ("val", True, 2),
])
def test_loader_matches_jax(dataset, mode, with_pid, bs):
    want = JaxLoader(dataset, mode, 64, bs, with_pid=with_pid, seed=11)
    got = ShapeNetLoader(dataset, mode, 64, bs, with_pid=with_pid, seed=11)
    assert len(got) == len(want) and got.num_samples == want.num_samples
    for _ in range(2):  # two epochs: the shuffle stream advances alike
        pairs = list(zip(got(), want(), strict=True))
        for g, w in pairs:
            np.testing.assert_array_equal(g.points, w.points)
            np.testing.assert_array_equal(g.label, w.label)
            np.testing.assert_array_equal(g.mask, w.mask)
            assert g.points.shape == (bs, 64, 3)
            if with_pid:
                np.testing.assert_array_equal(g.pid, w.pid)
            else:
                assert g.pid is None and w.pid is None


def test_make_cloud_matches_jax():
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    for label in (0, 3, 15):
        pa, oa = make_cloud(a, label, 50, 16)
        pb, ob = _make_cloud(b, label, 50, 16)
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(oa, ob)


def test_synthetic_loader_batches():
    loader = SyntheticLoader(10, n_points=32, num_classes=4, batchsize=4,
                             seed=2)
    batches = list(loader())
    assert len(batches) == len(loader) == 3
    assert [int(b.mask.sum()) for b in batches] == [4, 4, 2]
    assert all(b.points.shape == (4, 32, 3) for b in batches)
    again = list(SyntheticLoader(10, n_points=32, num_classes=4,
                                 batchsize=4, seed=2)())
    for x, y in zip(batches, again):
        np.testing.assert_array_equal(x.points, y.points)


def test_metrics_match_jax(rng):
    logits = rng.randn(6, 5).astype(np.float32)
    labels = rng.randint(5, size=6).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 0, 1], bool)
    for m in (None, mask):
        tm = None if m is None else torch.from_numpy(m)
        jm = None if m is None else jnp.asarray(m)
        np.testing.assert_allclose(
            float(metrics.softmax_cross_entropy(
                torch.from_numpy(logits), torch.from_numpy(labels), tm)),
            float(jmetrics.softmax_cross_entropy(
                jnp.asarray(logits), jnp.asarray(labels), jm)), rtol=1e-6)
        assert float(metrics.accuracy(
            torch.from_numpy(logits), torch.from_numpy(labels), tm)) == float(
            jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(labels), jm))


def _seeded_weights(tmp_path):
    spec = init_model("pointnet2_ssg", seed=0, device="cpu")
    path = tmp_path / "ssg_seed0.npz"
    np.savez(path, **state_dict_to_flax(spec.model.state_dict()))
    return spec.model, path


def test_evaluate_on_the_cpu(tmp_path):
    """evaluate() over a padded synthetic split equals the model and the
    metrics applied batch by batch to the valid rows."""
    model, weights = _seeded_weights(tmp_path)
    loader = SyntheticLoader(5, n_points=1024, num_classes=16, batchsize=3,
                             seed=1)
    logs = []
    result = evaluate("pointnet2_ssg", weights=weights,
                      make_loader=lambda split: loader,
                      device="cpu", log=logs.append)
    assert result["num_samples"] == 5 and logs[0].startswith("eval[test]")
    with torch.inference_mode():
        logits = model(torch.from_numpy(loader.data))
    torch.testing.assert_close(result["logits"], logits, rtol=1e-5,
                               atol=1e-5)
    labels = torch.from_numpy(loader.label)
    assert result["accuracy"] == pytest.approx(
        float(metrics.accuracy(logits, labels)))
    assert result["loss"] == pytest.approx(
        float(metrics.softmax_cross_entropy(logits, labels)), rel=1e-5)
    with pytest.raises(FileNotFoundError, match="checkpoint found"):
        evaluate("pointnet2_ssg", make_loader=lambda split: loader,
                 device="cpu",
                 model_dir=str(tmp_path / "no_model"))


def test_cli_evaluates_an_h5_split(tmp_path, capsys):
    _, weights = _seeded_weights(tmp_path)
    data = write_shapenet_h5(str(tmp_path / "data"), n_train=0, n_test=3,
                             n_val=0, n_points=1024, num_classes=16)
    assert cli.main(["--model_name", "pointnet2_ssg", "--mode", "clas",
                     "--evaluate", "--path", data, "--weights", str(weights),
                     "--batchsize", "2", "--device", "cpu"]) == 0
    assert "eval[test]: loss=" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # --scan_steps is not ported yet
        cli.main(["--path", data, "--scan_steps", "4"])
