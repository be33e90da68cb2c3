#!/usr/bin/env python3
"""Time the kd loader's tree build over a ShapeNet-sized split:
``python tools/kd_build_time.py [--clouds 12000] [--points 1024]``.

Builds every cloud's balanced kd-tree the way ``KDLoader`` does
(``papc_tpu_torch.data.kd.leaf_order``: a level at a time, vectorised
over the nodes and over blocks of clouds) for seeded synthetic clouds
(``make_cloud``), and prints the host seconds it took as one JSON line,
beside the per-cloud recursion (the JAX package's pure-Python build,
copied here) timed on the first ``--recursion`` clouds, whose trees must
equal the vectorised ones.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from papc_tpu_torch.data.kd import BUILD_BLOCK, leaf_order  # noqa: E402
from papc_tpu_torch.data.synthetic import make_cloud  # noqa: E402


def recursion(points: np.ndarray):
    """One cloud's tree by the per-node recursion: (order, split_dims)."""
    n = len(points)
    depth = int(np.log2(n))
    splits = [np.zeros(n >> level, np.int32) for level in range(depth)]

    def rec(idx, pos):
        if len(idx) == 1:
            return idx
        pts = points[idx]
        axis = int(np.argmax(pts.max(0) - pts.min(0)))
        sidx = idx[np.argsort(pts[:, axis], kind="stable")]
        half = len(idx) // 2
        left, right = rec(sidx[:half], 2 * pos), rec(sidx[half:], 2 * pos + 1)
        level = int(np.log2(len(idx))) - 1
        splits[level][2 * pos:2 * pos + 2] = axis
        return np.concatenate([left, right])

    return rec(np.arange(n), 0), splits


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--clouds", type=int, default=12000)
    parser.add_argument("--points", type=int, default=1024)
    parser.add_argument("--recursion", type=int, default=200)
    args = parser.parse_args()
    rng = np.random.RandomState(0)
    data = np.stack([make_cloud(rng, int(y), args.points, 16)[0]
                     for y in rng.randint(16, size=args.clouds)])
    t0 = time.perf_counter()
    points, splits, _ = leaf_order(data)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    trees = [recursion(cloud) for cloud in data[:args.recursion]]
    rec_s = time.perf_counter() - t0
    for c, (order, sp) in enumerate(trees):
        assert np.array_equal(points[c], data[c][order])
        assert all(np.array_equal(splits[level][c], s)
                   for level, s in enumerate(sp))
    print(json.dumps({
        "clouds": args.clouds, "points": args.points, "block": BUILD_BLOCK,
        "build_s": round(seconds, 3),
        "ms_per_cloud": round(1e3 * seconds / args.clouds, 4),
        "recursion_clouds": len(trees),
        "recursion_ms_per_cloud": round(1e3 * rec_s / max(len(trees), 1), 4),
        "equal": True}))


if __name__ == "__main__":
    main()
