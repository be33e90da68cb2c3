"""The zoo's data paths against the JAX package: the kd-trees (bit for
bit, ties included), the kd and voxel loaders, the offline voxel
dataset, ``make_dataloader`` for every input kind and mode, and the
batches' ``split_dims`` through ``batch_tensor`` and the prefetch; and
the zoo through the port's entry points on the CPU (``train``,
``evaluate``, ``python -m papc_tpu_torch``)."""

import os

import numpy as np
import pytest
import torch

from papc_tpu.data import dispatch as jdispatch
from papc_tpu.data import kd as jkd
from papc_tpu.data import voxel as jvoxel
from papc_tpu.data.synthetic import write_shapenet_h5
from tests.torch_parity import few_threads  # noqa: F401

from papc_tpu_torch import __main__ as cli
from papc_tpu_torch.data import (KDLoader, VoxelFileLoader, VoxelLoader,
                                 build_kd_tree, make_dataloader,
                                 prefetch_to_device, rasterize)
from papc_tpu_torch.data.kd import build_kd_trees
from papc_tpu_torch.data.voxel import build_voxel_dataset
from papc_tpu_torch.models import registry_combos
from papc_tpu_torch.train import evaluate, train
from papc_tpu_torch.train.evaluate import (batch_dict, batch_tensor,
                                           model_inputs)

N = 64

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_shapenet_h5(str(tmp_path_factory.mktemp("zoo_shapenet")),
                             n_train=13, n_test=5, n_val=6, n_points=N,
                             num_classes=4, num_parts=8, seed=4)


def _clouds():
    """Seeded gaussian clouds, clouds on a coarse lattice (many tied
    coordinates, tied spreads), and clouds of repeated points."""
    rs = np.random.RandomState(0)
    out = [rs.randn(n, 3).astype(np.float32) for n in (2, 8, 64, 1024)]
    out += [rs.randint(-2, 3, size=(n, 3)).astype(np.float32)
            for n in (16, 128, 512)]
    out += [np.repeat(rs.randn(8, 3), 16, 0).astype(np.float32),
            np.zeros((32, 3), np.float32)]
    return out


@pytest.mark.parametrize("i", range(9))
def test_build_kd_tree_matches_jax(i):
    """The leaf order and every level's split axes equal JAX's
    ``build_kd_tree`` (its native build here, which its own tests hold
    equal to its recursion) bit for bit, on clouds with and without
    ties; the labels follow the points."""
    pts = _clouds()[i]
    labels = np.arange(len(pts), dtype=np.int32) * 7 % 5
    got = build_kd_tree(pts, labels)
    want = jkd.build_kd_tree(pts, labels)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert len(got[1]) == len(want[1]) == int(np.log2(len(pts)))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


def test_build_kd_tree_refuses_other_sizes():
    with pytest.raises(ValueError, match="power-of-two N, got 48"):
        build_kd_tree(np.zeros((48, 3), np.float32))


def test_build_kd_trees_over_clouds_equals_one_by_one():
    """The vectorised build over a block of clouds equals each cloud's
    own build."""
    rs = np.random.RandomState(1)
    data = np.concatenate([rs.randn(5, 128, 3),
                           rs.randint(-1, 2, size=(3, 128, 3))]).astype(
        np.float32)
    order, splits = build_kd_trees(data)
    for c, cloud in enumerate(data):
        leaf, sp, _ = build_kd_tree(cloud)
        np.testing.assert_array_equal(cloud[order[c]], leaf)
        for level, s in enumerate(sp):
            np.testing.assert_array_equal(splits[level][c], s)


@pytest.mark.parametrize("mode,with_pid,bs", [("train", False, 4),
                                              ("train", True, 5),
                                              ("val", True, 4)])
def test_kd_loader_matches_jax(dataset, mode, with_pid, bs):
    got = KDLoader(dataset, mode, N, bs, with_pid=with_pid, seed=3)
    want = jkd.KDLoader(dataset, mode, N, bs, with_pid=with_pid, seed=3)
    assert len(got) == len(want) and got.num_samples == want.num_samples
    for _ in range(2):
        for g, w in zip(got(), want(), strict=True):
            for field in ("points", "label", "pid", "mask"):
                if w._asdict()[field] is None:
                    assert g._asdict()[field] is None
                else:
                    np.testing.assert_array_equal(g._asdict()[field],
                                                  w._asdict()[field])
            assert len(g.split_dims) == len(w.split_dims) == 6
            for a, b in zip(g.split_dims, w.split_dims):
                np.testing.assert_array_equal(a, b)


def test_rasterize_matches_jax_on_edge_coordinates(rng):
    """±1, 0, values past the box (clipped) and just below a cell's edge
    (truncated toward 0 as JAX's ``astype``)."""
    edges = np.array([[-1, -1, -1], [1, 1, 1], [0, 0, 0], [1, -1, 0],
                      [-1.2, 1.5, 0.999999], [-0.0322, 0.0322, 0.5],
                      [15.5 / 15.5 - 1e-7, -1 + 1e-7, 0.0645]], np.float32)
    for pts in (edges, rng.uniform(-1, 1, (500, 3)).astype(np.float32)):
        got = rasterize(pts)
        np.testing.assert_array_equal(got, jvoxel.rasterize(pts))
        assert got.dtype == np.float32 and got.shape == (32, 32, 32)
    assert rasterize(edges)[0, 0, 0] == rasterize(edges)[31, 31, 31] == 1
    assert rasterize(edges)[15, 15, 15] == 1


@pytest.mark.parametrize("mode", ["train", "test"])
def test_voxel_loader_matches_jax(dataset, mode):
    got = VoxelLoader(dataset, mode, N, 4, seed=2)
    want = jvoxel.VoxelLoader(dataset, mode, N, 4, seed=2)
    assert len(got) == len(want) and got.num_samples == want.num_samples
    for _ in range(2):
        for g, w in zip(got(), want(), strict=True):
            assert g.voxels.shape == (4, 32, 32, 32, 1) and g.pid is None
            np.testing.assert_array_equal(g.voxels, w.voxels)
            np.testing.assert_array_equal(g.label, w.label)
            np.testing.assert_array_equal(g.mask, w.mask)


def test_voxel_file_dataset_matches_jax(tmp_path, rng):
    """``build_voxel_dataset`` writes JAX's grids and lists (every 60th
    cloud of a category to test), and ``VoxelFileLoader`` reads them as
    JAX's does."""
    src = tmp_path / "modelnet"
    for name, n in (("chair", 61), ("sofa", 3)):
        os.makedirs(src / name)
        for i in range(n):
            np.savetxt(src / name / f"{name}_{i:04d}.txt",
                       rng.uniform(-1, 1, (20, 6)), delimiter=",")
    build_voxel_dataset(str(src), str(tmp_path / "got"))
    jvoxel.build_voxel_dataset(str(src), str(tmp_path / "want"))
    for split in ("train.txt", "test.txt"):
        got = (tmp_path / "got" / split).read_text().splitlines()
        want = (tmp_path / "want" / split).read_text().splitlines()
        assert [g.replace("/got/", "/want/") for g in got] == want
        for line in got:
            path = line.rsplit(" ", 1)[0]
            np.testing.assert_array_equal(
                np.load(path), np.load(path.replace("/got/", "/want/")))
    for mode in ("train", "test"):
        g_loader = VoxelFileLoader(str(tmp_path / "got"), mode, 8, seed=1)
        w_loader = jvoxel.VoxelFileLoader(str(tmp_path / "want"), mode, 8,
                                          seed=1)
        for g, w in zip(g_loader(), w_loader(), strict=True):
            np.testing.assert_array_equal(g.voxels, w.voxels)
            np.testing.assert_array_equal(g.label, w.label)
            np.testing.assert_array_equal(g.mask, w.mask)


@pytest.mark.parametrize("combo", registry_combos(), ids="-".join)
def test_make_dataloader_matches_jax(dataset, combo):
    """Every registry combo's loader: the same family and the same
    batches as JAX's ``make_dataloader`` (the val split, one epoch)."""
    name, mode = combo
    got = make_dataloader(name, N, 4, dataset, mode, "val")
    want = jdispatch.make_dataloader(name, N, 4, dataset, mode, "val")
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got(), want(), strict=True):
        g, w = batch_dict(g), batch_dict(w)
        assert set(g) == set(w)
        for key, value in w.items():
            if key == "split_dims":
                for a, b in zip(g[key], value, strict=True):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(g[key], value)


def test_unknown_names_and_modes_raise_as_jax(dataset):
    for args in (("nonexistent", N, 4, dataset, "clas"),
                 ("voxnet", N, 4, dataset, "seg"),
                 ("pointnet_basic", N, 4, dataset, "detect")):
        with pytest.raises(SystemExit) as got:
            make_dataloader(*args)
        with pytest.raises(SystemExit) as want:
            jdispatch.make_dataloader(*args)
        assert str(got.value) == str(want.value)


def test_split_dims_through_batch_tensor_and_the_prefetch(dataset):
    """A kd batch's ``split_dims`` (a tuple of arrays) becomes a tuple of
    tensors, inline and through ``prefetch_to_device``."""
    loader = KDLoader(dataset, "val", N, 4)
    raw = next(iter(loader()))
    got = batch_tensor(batch_dict(raw), "split_dims", torch.device("cpu"))
    assert isinstance(got, tuple) and len(got) == 6
    for t, a in zip(got, raw.split_dims):
        np.testing.assert_array_equal(t.numpy(), a)
    fetched = list(prefetch_to_device(loader(), transform=batch_dict,
                                      device="cpu"))
    assert len(fetched) == len(loader)
    first = fetched[0]["split_dims"]
    assert isinstance(first, tuple)
    for t, a in zip(first, raw.split_dims):
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("name,mode", [("voxnet", "clas"), ("kdnet", "clas"),
                                       ("kdunet", "seg")])
def test_zoo_trains_and_serves_through_the_entry_points(dataset, tmp_path,
                                                        name, mode):
    """``train`` and ``evaluate`` with their default loaders (the voxel and
    kd families by ``make_dataloader``) on the CPU, then the CLI on the
    checkpoint: finite losses, a checkpoint of every leaf, the served
    logits the trained model's."""
    model_dir = str(tmp_path / "model")
    model, history = train(name, mode, N, 4, 8, epoch_num=1, batchsize=4,
                           save_iter=1, path=dataset, model_dir=model_dir,
                           device="cpu", log=lambda line: None)
    assert np.isfinite(history[0]["train_loss"]).all()
    assert len(history[0]["train_loss"]) == 4  # 13 clouds in batches of 4
    result = evaluate(name, mode, N, 4, 8, batchsize=4, path=dataset,
                      split="val", model_dir=model_dir, device="cpu",
                      log=lambda line: None)
    assert result["num_samples"] == 6
    shape = (6, 4) if mode == "clas" else (6, N, 8)
    assert tuple(result["logits"].shape) == shape
    model.eval()
    with torch.inference_mode():
        want = torch.cat([
            model(*model_inputs(model, batch_dict(b), torch.device("cpu")))[
                torch.from_numpy(b.mask)]
            for b in make_dataloader(name, N, 4, dataset, mode, "val")()])
    torch.testing.assert_close(result["logits"], want, rtol=1e-6, atol=1e-6)
    assert cli.main(["--model_name", name, "--mode", mode, "--evaluate",
                     "--path", dataset, "--max_point", str(N),
                     "--num_classes", "4", "--num_parts", "8", "--split",
                     "val", "--batchsize", "4", "--model_dir", model_dir,
                     "--device", "cpu"]) == 0
