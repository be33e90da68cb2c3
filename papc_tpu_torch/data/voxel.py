"""Occupancy grids for VoxNet (counterpart of ``papc_tpu/data/voxel.py``).

:func:`rasterize` maps a cloud in [-1, 1] onto a ``32³`` binary grid by
``int(x · (grid-1)/2 + (grid-1)/2)``, clipped to the grid.
:class:`VoxelLoader` rasterises ShapeNet ``.h5`` clouds at load time, each
normalised first (centred, divided by its largest absolute coordinate);
:func:`build_voxel_dataset` and :class:`VoxelFileLoader` are the
reference's offline path: ModelNet ``.txt`` clouds rasterised into
``.npy`` grids with ``train.txt`` / ``test.txt`` lists.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np

from papc_tpu_torch.data.shapenet import load_split

GRID = 32

# ModelNet-10 category map of the reference's rasteriser
CATEGORY = {
    "bathtub": 0, "bed": 1, "chair": 2, "door": 3, "dresser": 4,
    "airplane": 5, "piano": 6, "sofa": 7, "person": 8, "cup": 9,
}
CATEGORY_LIST = list(CATEGORY)


def rasterize(points: np.ndarray, grid: int = GRID) -> np.ndarray:
    """A normalised cloud (coordinates in [-1, 1]) → a binary ``[grid,
    grid, grid]`` float32 occupancy array."""
    half = (grid - 1) / 2.0
    ijk = (points[:, :3] * half + half).astype(np.int64)
    ijk = np.clip(ijk, 0, grid - 1)
    arr = np.zeros((grid, grid, grid), dtype=np.float32)
    arr[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = 1.0
    return arr


def build_voxel_dataset(modelnet_dir: str, out_dir: str) -> None:
    """Offline tool: rasterise ModelNet ``.txt`` clouds (``modelnet_dir/
    <category>/*.txt``) into ``.npy`` grids under ``out_dir``, with
    ``train.txt`` / ``test.txt`` lists (every 60th cloud of a category to
    test)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train.txt"), "w") as f_train, \
            open(os.path.join(out_dir, "test.txt"), "w") as f_test:
        for name in CATEGORY_LIST:
            src = os.path.join(modelnet_dir, name)
            if not os.path.isdir(src):
                continue
            dst = os.path.join(out_dir, name)
            os.makedirs(dst, exist_ok=True)
            for count, fname in enumerate(sorted(os.listdir(src))):
                pts = np.loadtxt(os.path.join(src, fname), delimiter=",",
                                 usecols=(0, 1, 2))
                out = os.path.join(dst, fname.split(".")[0] + ".npy")
                np.save(out, rasterize(pts.astype(np.float32)))
                (f_test if count % 60 == 0 else f_train).write(
                    f"{out} {name}\n")


class VoxBatch(NamedTuple):
    voxels: np.ndarray  # [B, 32, 32, 32, 1]
    label: np.ndarray  # [B]
    pid: None
    mask: np.ndarray  # [B]


def normalized(pts: np.ndarray) -> np.ndarray:
    """A cloud centred and divided by its largest absolute coordinate
    (plus 1e-6)."""
    pts = pts - pts.mean(0)
    return pts / (np.abs(pts).max() + 1e-6)


def _batches(voxels, label, mode, batchsize, rng) -> Iterator[VoxBatch]:
    n = len(voxels)
    order = np.arange(n)
    if mode == "train":
        rng.shuffle(order)
    for start in range(0, n, batchsize):
        idx = order[start:start + batchsize]
        mask = np.zeros(batchsize, dtype=bool)
        mask[:len(idx)] = True
        if len(idx) < batchsize:  # pad the final batch to the static shape
            idx = np.resize(idx, batchsize)
        yield VoxBatch(voxels[idx], label[idx], None, mask)


class VoxelLoader:
    """Rasterises a ShapeNet ``.h5`` split into occupancy grids at load
    time; batches as :class:`~papc_tpu_torch.data.ShapeNetLoader` does."""

    def __init__(self, path: str, mode: str = "train", max_point: int = 1024,
                 batchsize: int = 32, seed: int = 0):
        self.mode = mode
        self.batchsize = batchsize
        self._rng = np.random.RandomState(seed)
        data, self.label = load_split(path, mode, max_point)
        self.voxels = np.zeros((len(data), GRID, GRID, GRID, 1), np.float32)
        for i, pts in enumerate(data):
            self.voxels[i, ..., 0] = rasterize(normalized(pts))

    def __len__(self) -> int:
        return -(-len(self.voxels) // self.batchsize)

    @property
    def num_samples(self) -> int:
        return len(self.voxels)

    def __call__(self) -> Iterator[VoxBatch]:
        return _batches(self.voxels, self.label, self.mode, self.batchsize,
                        self._rng)


class VoxelFileLoader:
    """Reads the reference's ``train.txt`` / ``test.txt`` lists of ``.npy``
    grids (:func:`build_voxel_dataset`)."""

    def __init__(self, data_dir: str, mode: str = "train",
                 batchsize: int = 64, seed: int = 0):
        self.mode = mode
        self.batchsize = batchsize
        self._rng = np.random.RandomState(seed)
        list_file = os.path.join(
            data_dir, "train.txt" if mode == "train" else "test.txt")
        voxels, labels = [], []
        with open(list_file) as f:
            for line in f:
                p, name = line.rsplit(" ", 1)
                voxels.append(np.load(p))
                labels.append(CATEGORY[name.strip()])
        self.voxels = np.asarray(voxels, np.float32)[..., None]
        self.label = np.asarray(labels, np.int32)

    def __call__(self) -> Iterator[VoxBatch]:
        return _batches(self.voxels, self.label, self.mode, self.batchsize,
                        self._rng)
