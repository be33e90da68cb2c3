"""Balanced kd-trees and their loader for KDNet / KD-UNet (counterpart
of ``papc_tpu/data/kd.py``).

Each cloud gets a balanced kd-tree: every node splits its points at the
median of its axis of largest spread (``max - min``, the first axis on a
tie), its points ordered by a stable sort on that axis. The leaves give
the point order, and ``split_dims[l]`` (``N >> l`` entries) holds at
positions ``2i, 2i+1`` the axis of the node whose two children of size
``2^l`` they are: the layout the models read.

JAX builds each tree by recursion (or through its C++ library). Here the
trees are built a level at a time, vectorised over the nodes of a level
and over a block of clouds: per node the spread's argmax, then one
stable argsort of the gathered coordinates. Each node's points keep the
order the recursion gives them, so the result is the same bit for bit.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from papc_tpu_torch.data.shapenet import load_split

# clouds a vectorised build takes at once (bounds its temporaries to
# some tens of MB at N = 1024)
BUILD_BLOCK = 1024


def build_kd_trees(points: np.ndarray):
    """Trees over ``points [C, N, 3]`` (N a power of two), the coordinates
    taken as float32 as JAX's native build takes them. Returns ``(order
    [C, N] int64, split_dims)``: ``order`` the leaf order of each cloud's
    point indices, ``split_dims[l]`` ``[C, N >> l]`` int32."""
    pts = np.asarray(points)[..., :3].astype(np.float32, copy=False)
    C, N, _ = pts.shape
    depth = int(np.log2(N)) if N else 0
    if 2 ** depth != N:
        raise ValueError(f"a kd-tree needs a power-of-two N, got {N}")
    order = np.broadcast_to(np.arange(N), (C, N)).copy()
    splits = [np.zeros((C, N >> l), np.int32) for l in range(depth)]
    rows = np.arange(C)[:, None, None]
    for d in range(depth):  # 2^d nodes of s points each
        nodes, s = 1 << d, N >> d
        idx = order.reshape(C, nodes, s)
        coords = pts[rows, idx]  # [C, nodes, s, 3]
        spread = coords.max(axis=2) - coords.min(axis=2)
        axis = np.argmax(spread, axis=-1)  # [C, nodes], first on ties
        key = np.take_along_axis(coords, axis[:, :, None, None],
                                 axis=3)[..., 0]
        perm = np.argsort(key, axis=-1, kind="stable")
        order = np.take_along_axis(idx, perm, axis=-1).reshape(C, N)
        splits[depth - 1 - d][:] = np.repeat(axis, 2, axis=1)
    return order, splits


def build_kd_tree(points: np.ndarray, labels: np.ndarray | None = None):
    """One cloud ``points [N, 3]``: ``(leaf_points [N, 3], split_dims,
    leaf_labels)``, ``split_dims[l]`` ``[N >> l]`` int32 and
    ``leaf_labels`` ``labels`` in leaf order (or None), as JAX's."""
    order, splits = build_kd_trees(np.asarray(points)[None])
    order = order[0]
    return (points[order], [s[0] for s in splits],
            None if labels is None else labels[order])


class KDBatch(NamedTuple):
    points: np.ndarray  # [B, N, 3] leaf-ordered
    split_dims: tuple  # tuple of [B, N >> l] int32, l = 0..depth-1
    label: np.ndarray  # [B] int32
    pid: np.ndarray | None  # [B, N] int32 leaf-ordered part labels
    mask: np.ndarray  # [B] bool


class KDLoader:
    """Loads a ShapeNet split and builds every cloud's kd-tree up front
    (:func:`build_kd_trees`, ``BUILD_BLOCK`` clouds at a time)."""

    def __init__(self, path: str, mode: str = "train", max_point: int = 1024,
                 batchsize: int = 32, with_pid: bool = False, seed: int = 0):
        self.mode = mode
        self.batchsize = batchsize
        self._rng = np.random.RandomState(seed)
        if with_pid:
            data, label, pid = load_split(path, mode, max_point, True)
        else:
            (data, label), pid = load_split(path, mode, max_point), None
        self.label = label
        self.points, self.splits, self.pid = leaf_order(data, pid)

    def __len__(self) -> int:
        return -(-len(self.points) // self.batchsize)

    @property
    def num_samples(self) -> int:
        return len(self.points)

    def __call__(self) -> Iterator[KDBatch]:
        n = len(self.points)
        order = np.arange(n)
        if self.mode == "train":
            self._rng.shuffle(order)
        bs = self.batchsize
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            mask = np.zeros(bs, dtype=bool)
            mask[:len(idx)] = True
            if len(idx) < bs:  # pad the final batch to the static shape
                idx = np.resize(idx, bs)
            yield KDBatch(points=self.points[idx],
                          split_dims=tuple(s[idx] for s in self.splits),
                          label=self.label[idx],
                          pid=None if self.pid is None else self.pid[idx],
                          mask=mask)


def leaf_order(data: np.ndarray, pid: np.ndarray | None = None):
    """Every cloud of ``data [C, N, 3]`` in its tree's leaf order: ``(points,
    split_dims, pid)`` with ``split_dims[l]`` ``[C, N >> l]`` and ``pid``
    reordered alike (or None)."""
    C, N = data.shape[:2]
    depth = int(np.log2(N)) if N else 0
    points = np.zeros_like(data)
    splits = [np.zeros((C, N >> l), np.int32) for l in range(depth)]
    out_pid = None if pid is None else np.zeros_like(pid)
    for start in range(0, C, BUILD_BLOCK):
        block = slice(start, start + BUILD_BLOCK)
        order, sp = build_kd_trees(data[block])
        points[block] = np.take_along_axis(data[block], order[..., None], 1)
        for l in range(depth):
            splits[l][block] = sp[l]
        if pid is not None:
            out_pid[block] = np.take_along_axis(pid[block], order, 1)
    return points, splits, out_pid
