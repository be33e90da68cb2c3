"""Synthetic ShapeNet-like clouds held in memory
(counterpart of ``papc_tpu/data/synthetic.py``).

:func:`make_cloud` draws the same class-dependent gaussian blob mixture as
the JAX package's ``_make_cloud`` from the same ``RandomState`` stream.
:class:`SyntheticLoader` batches such clouds like
:class:`papc_tpu_torch.data.shapenet.ShapeNetLoader`, without writing
``.h5`` files, so a run needs neither a dataset nor ``h5py``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from papc_tpu_torch.data.shapenet import Batch


def make_cloud(rng: np.random.RandomState, label: int, n_points: int,
               num_classes: int):
    """Classes separable by centroid offset and anisotropic scale, parts
    by octant. Returns ``(points [n, 3] f32, part ids [n] i32)``."""
    offset = np.array([
        np.cos(2 * np.pi * label / num_classes),
        np.sin(2 * np.pi * label / num_classes),
        (label / num_classes) - 0.5,
    ])
    scale = 0.1 + 0.5 * (label + 1) / num_classes
    pts = rng.randn(n_points, 3) * scale + offset
    octant = ((pts[:, 0] > offset[0]).astype(int)
              + 2 * (pts[:, 1] > offset[1]).astype(int)
              + 4 * (pts[:, 2] > offset[2]).astype(int))
    return pts.astype(np.float32), octant.astype(np.int32)


class SyntheticLoader:
    """``n_samples`` seeded clouds in fixed-shape batches of ``batchsize``
    (the last one padded, with its mask), in a fixed order. With
    ``with_pid`` each batch carries the per-point part labels (the
    octants, as the JAX package's synthetic shards hold them), for part
    segmentation."""

    def __init__(self, n_samples: int, n_points: int = 1024,
                 num_classes: int = 16, batchsize: int = 32, seed: int = 0,
                 with_pid: bool = False):
        rng = np.random.RandomState(seed)
        self.batchsize = batchsize
        self.label = rng.randint(num_classes, size=n_samples).astype(np.int32)
        clouds = [make_cloud(rng, int(y), n_points, num_classes)
                  for y in self.label]
        self.data = (np.stack([c[0] for c in clouds]) if n_samples
                     else np.zeros((0, n_points, 3), np.float32))
        self.pid = None
        if with_pid:
            self.pid = (np.stack([c[1] for c in clouds]) if n_samples
                        else np.zeros((0, n_points), np.int32))

    def __len__(self) -> int:
        return -(-len(self.data) // self.batchsize)

    @property
    def num_samples(self) -> int:
        return len(self.data)

    def __call__(self) -> Iterator[Batch]:
        n, bs = len(self.data), self.batchsize
        for start in range(0, n, bs):
            idx = np.arange(start, min(start + bs, n))
            mask = np.zeros(bs, dtype=bool)
            mask[:len(idx)] = True
            idx = np.resize(idx, bs)
            yield Batch(points=self.data[idx], label=self.label[idx],
                        pid=None if self.pid is None else self.pid[idx],
                        mask=mask)
