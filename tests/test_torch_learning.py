"""The port learns: the six floors of ``tests/test_learning.py`` with its
recipes, sizes and floors, through the port's ``train`` and
``train_step`` on the CPU. Weights start from the port's seeded init,
dropout draws from a seeded ``torch.Generator``."""

import numpy as np
import pytest
import torch

from papc_tpu.data.synthetic import write_shapenet_h5
from tests.torch_parity import few_threads  # noqa: F401

from papc_tpu_torch.data import build_kd_tree
from papc_tpu_torch.models import init_model
from papc_tpu_torch.models.classify import PointNet2SSGClas
from papc_tpu_torch.models.segment import PointNet2SSGSeg
from papc_tpu_torch.train import eval_step, make_optimizer, train, train_step

N_POINTS = 64
NUM_CLASSES = 4
CPU = torch.device("cpu")

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("shapenet_learn")
    return write_shapenet_h5(str(path), n_train=192, n_test=32, n_val=32,
                             n_points=N_POINTS, num_classes=NUM_CLASSES,
                             num_parts=8)


def _mini_train(model, batch, steps, lr=1e-3):
    """``steps`` train steps on one batch (Adam, no weight decay), then
    the metric of an eval step on it."""
    opt = make_optimizer(model.parameters(), lr, 0.0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        train_step(model, opt, batch, CPU, gen)
    model.eval()
    return float(eval_step(model, batch, CPU)[2])


def test_pointnet_basic_reaches_90pct(dataset, tmp_path):
    _, history = train("pointnet_basic", "clas", N_POINTS, NUM_CLASSES, 8,
                       learning_rate=1e-3, weight_decay=1e-4, epoch_num=8,
                       batchsize=16, info_iter=1000, save_iter=1000,
                       path=dataset, model_dir=str(tmp_path / "model"),
                       device="cpu", log=lambda line: None)
    acc = max(h["val_metric"] for h in history)
    assert acc >= 0.9, f"val accuracy {acc:.3f} < 0.9"


def test_pointnet2_ssg_reaches_90pct():
    """Through FPS, ball query and the grouping gather, at JAX's reduced
    SA sizes: separable blobs along x, 80 steps on one batch."""
    rng = np.random.RandomState(0)
    B = 32
    labels = rng.randint(0, NUM_CLASSES, size=(B,))
    pts = rng.randn(B, N_POINTS, 3) * 0.15
    pts[..., 0] += labels[:, None]
    batch = {"points": pts.astype(np.float32),
             "label": labels.astype(np.int32), "mask": np.ones(B, bool)}
    model = PointNet2SSGClas(num_classes=NUM_CLASSES, npoints=(16, 8),
                             nsamples=(8, 8),
                             generator=torch.Generator().manual_seed(0))
    acc = _mini_train(model, batch, 80)
    assert acc >= 0.9, f"train accuracy {acc:.3f} < 0.9"


def test_voxnet_reaches_90pct(rng):
    """Separable occupancy grids (class k fills cube k)."""
    B = 32
    labels = rng.randint(0, NUM_CLASSES, size=(B,))
    vox = np.zeros((B, 32, 32, 32, 1), np.float32)
    for b, k in enumerate(labels):
        x = 2 + 7 * k
        vox[b, x:x + 6, 4:28, 4:28] = rng.rand(6, 24, 24)[..., None] > 0.5
    batch = {"voxels": vox, "label": labels.astype(np.int32),
             "mask": np.ones(B, bool)}
    model = init_model("voxnet", "clas", NUM_CLASSES, device="cpu").model
    acc = _mini_train(model, batch, 60)
    assert acc >= 0.9, acc


def test_kdnet_reaches_90pct(rng):
    """Through real kd-tree split-axis routing, N = 128."""
    N, B = 128, 32
    labels = rng.randint(0, NUM_CLASSES, size=(B,))
    leaves, splits = [], []
    for k in labels:
        pts = rng.randn(N, 3) * 0.15
        pts[:, 0] += k
        leaf, sp, _ = build_kd_tree(pts.astype(np.float32))
        leaves.append(leaf)
        splits.append(sp)
    batch = {"points": np.stack(leaves).astype(np.float32),
             "split_dims": tuple(np.stack([s[level] for s in splits])
                                 for level in range(int(np.log2(N)))),
             "label": labels.astype(np.int32), "mask": np.ones(B, bool)}
    model = init_model("kdnet", "clas", NUM_CLASSES, max_point=N,
                       device="cpu").model
    acc = _mini_train(model, batch, 80)
    assert acc >= 0.9, acc


def _quadrant_batch(rng, B, N):
    """Clouds whose part is the (x, y) quadrant: position-determined."""
    labels = rng.randint(0, NUM_CLASSES, size=(B,))
    pts = rng.randn(B, N, 3).astype(np.float32) * 0.3
    pid = (pts[..., 0] > 0).astype(np.int32) + 2 * (pts[..., 1] > 0).astype(
        np.int32)
    return {"points": pts, "label": labels.astype(np.int32), "pid": pid,
            "mask": np.ones(B, bool)}


def test_pointnet2_ssg_seg_miou(rng):
    """SA → FP → the class one-hot at the last FP, JAX's reduced SA
    sizes: mIoU >= 0.8 after 150 steps."""
    N, PARTS = 64, 4
    batch = _quadrant_batch(rng, 16, N)
    model = PointNet2SSGSeg(num_classes=NUM_CLASSES, num_parts=PARTS,
                            npoints=(16, 8), nsamples=(8, 8),
                            generator=torch.Generator().manual_seed(0))
    miou = _mini_train(model, batch, 150)
    assert miou >= 0.8, miou


def test_pointnet_basic_seg_miou(rng):
    N, PARTS = 64, 4
    batch = _quadrant_batch(rng, 32, N)
    model = init_model("pointnet_basic", "seg", NUM_CLASSES, PARTS, N,
                       device="cpu").model
    miou = _mini_train(model, batch, 120)
    assert miou >= 0.8, miou
