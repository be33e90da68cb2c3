"""The port's host pillarization against the JAX package, on the CPU.

``detect/voxelize_np.py`` is numpy in the port. JAX runs a C++ pass where
its library loads (``papc_tpu.cc``: ``points_to_voxel``,
``points_to_voxel_padded``, ``points_to_voxel_flat``) and a numpy one
otherwise (``voxelize_np._points_to_voxel_np``). The port must equal
both bit for bit: the padded grid with its first-come order, the
truncation at ``max_points`` and the drop past ``max_voxels``; the flat
view of the C++ streamer, a frame past its cap ``n_cap`` included; and
the BEV maps. The clouds are KITTI-sized (the car
config's range and cells) with a dense clump, so pillars fill up.
"""

import numpy as np
import pytest

from papc_tpu import cc
from papc_tpu.detect import pfn_fast as jpfn
from papc_tpu.detect import voxelize_np as jvox

from papc_tpu_torch.detect import voxelize_np

VOXEL_SIZE = [0.16, 0.16, 4.0]
PC_RANGE = [0.0, -39.68, -3.0, 69.12, 39.68, 1.0]


def _cloud(seed, n=20000, clump=2000, dtype=np.float32):
    """``n`` points over and around the range (some outside it), the
    first ``clump`` of them within a few cells of (20, 0, -1)."""
    rs = np.random.RandomState(seed)
    xyz = rs.uniform([-5, -45, -4], [75, 45, 2], (n, 3))
    xyz[:clump] = [20.0, 0.0, -1.0] + 0.05 * rs.randn(clump, 3)
    return np.concatenate([xyz, rs.rand(n, 1)], 1).astype(dtype)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(autouse=True)
def _cc_loads():
    assert cc.available()


# (max_points, max_voxels, pad_output): the car config's pillars; a
# truncation at 5 points and a drop past 300 pillars, padded and trimmed;
# 40 points and 800 pillars
GRIDS = {"car": (100, 12000, True), "truncate+drop": (5, 300, True),
         "trimmed": (5, 300, False), "mid": (40, 800, True)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_points_to_voxel_equals_jax_numpy_and_cc(grid, seed):
    mp, mv, pad = GRIDS[grid]
    pts = _cloud(seed)
    got = voxelize_np.points_to_voxel(pts, VOXEL_SIZE, PC_RANGE, mp, mv,
                                      pad_output=pad)
    _equal(got, jvox._points_to_voxel_np(pts, VOXEL_SIZE, PC_RANGE, mp, mv,
                                         pad_output=pad))
    _equal(got, jvox.points_to_voxel(pts, VOXEL_SIZE, PC_RANGE, mp, mv,
                                     pad_output=pad))
    voxels, coords, num_points = got
    assert num_points.max() == mp  # a pillar filled up
    if grid == "truncate+drop":  # the cap dropped pillars whole
        assert (num_points > 0).all() and len(num_points) == mv


def test_points_to_voxel_float64_equals_jax_numpy():
    """A float64 cloud computes its cells in float64 (JAX's C++ pass takes
    float32 only, so JAX runs its numpy pass)."""
    pts = _cloud(2, dtype=np.float64)
    got = voxelize_np.points_to_voxel(pts, VOXEL_SIZE, PC_RANGE, 20, 2000,
                                      pad_output=True)
    _equal(got, jvox.points_to_voxel(pts, VOXEL_SIZE, PC_RANGE, 20, 2000,
                                     pad_output=True))
    assert got[0].dtype == np.float64


def test_empty_and_outside_clouds():
    for pts in (np.zeros((0, 4), np.float32),
                np.full((10, 4), -100.0, np.float32)):
        _equal(voxelize_np.points_to_voxel(pts, VOXEL_SIZE, PC_RANGE, 5, 30,
                                           pad_output=True),
               jvox._points_to_voxel_np(pts, VOXEL_SIZE, PC_RANGE, 5, 30,
                                        pad_output=True))
        got = voxelize_np.points_to_voxel_flat(pts, VOXEL_SIZE, PC_RANGE, 5,
                                               30, 64)
        want = cc.points_to_voxel_flat(pts, VOXEL_SIZE, PC_RANGE, 5, 30, 64)
        _equal(got[:4], want[:4])
        assert got[4] == want[4] == 0


# (max_points, max_voxels, n_cap): the car config (25 000 points a
# frame, under the cap); pillars dropped and truncated, then a cap of 200
# points that new pillars still pass (they keep their rank, no point);
# the car's pillars under a cap of 5000
FLATS = {"car": (100, 12000, 25000), "drop+cap": (5, 300, 200),
         "cap": (100, 12000, 5000)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("flat", list(FLATS))
def test_points_to_voxel_flat_equals_jax_cc(flat, seed):
    mp, mv, cap = FLATS[flat]
    pts = _cloud(seed)
    got = voxelize_np.points_to_voxel_flat(pts, VOXEL_SIZE, PC_RANGE, mp, mv,
                                           cap)
    want = cc.points_to_voxel_flat(pts, VOXEL_SIZE, PC_RANGE, mp, mv, cap)
    _equal(got[:4], want[:4])
    assert got[4] == want[4]
    flat_pts, owner, coords, num_points, k = got
    n = int((owner >= 0).sum())
    assert num_points.sum() == n and (owner[n:] == -1).all()
    assert (np.diff(owner[:n]) >= 0).all()  # grouped, ascending pillar
    if flat != "car":  # past the cap: pillars with no point keep a rank
        assert n == cap and (num_points[:k] == 0).any()


def test_flat_view_is_the_grid_in_slot_order():
    """Under the cap the flat view is the padded grid's points in (pillar,
    slot) order: JAX's ``flatten_pillars`` of :func:`points_to_voxel`."""
    pts = _cloud(3)
    voxels, coords, num_points = voxelize_np.points_to_voxel(
        pts, VOXEL_SIZE, PC_RANGE, 100, 12000, pad_output=True)
    flat, owner, f_coords, f_num, k = voxelize_np.points_to_voxel_flat(
        pts, VOXEL_SIZE, PC_RANGE, 100, 12000, 25000)
    want_pts, want_owner = jpfn.flatten_pillars(
        voxels[None], num_points[None], coords[None], n_max=25000)
    np.testing.assert_array_equal(flat, want_pts[0])
    np.testing.assert_array_equal(owner, want_owner[0])
    np.testing.assert_array_equal(f_coords, coords)
    np.testing.assert_array_equal(f_num, num_points)
    assert k == int((num_points > 0).sum())


@pytest.mark.parametrize("with_reflectivity", [False, True])
def test_points_to_bev_equals_jax(with_reflectivity):
    pts = _cloud(5)
    vs = np.asarray([0.08, 0.08, 1.0], np.float32)  # four height slices
    got = voxelize_np.points_to_bev(pts, vs, PC_RANGE, with_reflectivity)
    want = jvox.points_to_bev(pts, vs, PC_RANGE, with_reflectivity)
    _equal([got], [want])
    assert got.shape == (5 + with_reflectivity, 992, 864)
    assert got[3:].any(axis=(1, 2)).all()  # the top slice, density, refl


@pytest.mark.parametrize("max_voxels", [12000, 100])
def test_voxel_generator_equals_jax(max_voxels):
    """The generator's grid equals JAX's, and the port's host pillarizer on
    its fields (``kitti/preprocess.py::host_pillars`` passes them) equals
    JAX's ``VoxelGenerator.generate``."""
    kw = dict(voxel_size=VOXEL_SIZE, point_cloud_range=PC_RANGE,
              max_num_points=100)
    got, want = voxelize_np.VoxelGenerator(**kw), jvox.VoxelGenerator(**kw)
    for name in ("voxel_size", "point_cloud_range", "grid_size"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.max_num_points == want.max_num_points
    pts = _cloud(6)
    _equal(voxelize_np.points_to_voxel(pts, got.voxel_size,
                                       got.point_cloud_range,
                                       got.max_num_points, max_voxels),
           want.generate(pts, max_voxels))
