"""The port's single-launch recompute mode (``mode="recompute1"``, kernels
#15-18) against the JAX package on the CPU, its gate, and the repairs of
three faults of the port (the training shuffle, ``evaluate`` on an empty
split, f32 detection convolutions).

Inputs are numpy arrays from one seed, handed to both packages in the same
process. The JAX side runs as its own suite runs on the CPU:
``fused_mlp_max(..., impl="jnp", mode="recompute1")`` (the same jnp twins
as recompute mode), the Pallas single-launch passes with
``interpret=True`` and ``make_train_step`` under ``fused_mlp.override``.
The port runs its plain versions (no card here), which for recompute1 ARE
the recompute passes' plain versions.

Tolerances, stated at each test, are those of ``test_torch_recompute.py``.
"""

import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.data.dispatch import make_dataloader
from papc_tpu.data.synthetic import write_shapenet_h5
from papc_tpu.models.classify import PointNet2SSGClas as JaxSSG
from papc_tpu.ops import fused_mlp as jfused
from papc_tpu.ops.pallas import samlp_single as jsingle

from papc_tpu_torch.convert import state_dict_to_flax
from papc_tpu_torch.detect import train as detect_train
from papc_tpu_torch.models import init_model, registry
from papc_tpu_torch.models.classify import PointNet2SSGClas
from papc_tpu_torch.ops import fused_mlp
from papc_tpu_torch.ops.kernels import samlp_recompute as rc
from papc_tpu_torch.ops.kernels import samlp_single
from papc_tpu_torch.train import evaluate
from papc_tpu_torch.train import trainer

from tests import torch_parity as P
from tests.test_torch_recompute import (J_DTYPE, SA_COMBOS, _compare_fused,
                                        _layers, _np, _port_fused)
from tests.torch_parity import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

F32, BF16 = torch.float32, torch.bfloat16


def _jax_fused(g, layers, running, cot, *, mode, dtype, impl="jnp"):
    """JAX's training stack under ``jax.value_and_grad``: ``(out,
    new_running, dg, [[dW, db, dγ, dβ]])`` as numpy."""
    jrun = tuple((jnp.asarray(m), jnp.asarray(v)) for m, v in running)

    def loss(gj, pj):
        o, nr = jfused.fused_mlp_max(gj, pj, jrun, train=True, impl=impl,
                                     interpret=impl == "pallas",
                                     sdtype=J_DTYPE[dtype], mode=mode)
        return jnp.sum(o * jnp.asarray(cot)), (o, nr)

    jp = tuple(tuple(jnp.asarray(p) for p in layer) for layer in layers)
    (_, (o, nr)), (dg, dp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(g), jp)
    return (_np(o), [(_np(m), _np(v)) for m, v in nr], _np(dg),
            [[_np(p) for p in layer] for layer in dp])


def _case(seed, shape, widths):
    rs = np.random.RandomState(seed)
    g = (rs.randn(*shape) + 0.5).astype(np.float32)
    layers, running = _layers(rs, shape[-1], widths)
    cot = rs.randn(*shape[:2], widths[-1]).astype(np.float32)
    return g, layers, running, cot


def _both_gates(shape, widths):
    b, s, k, c0 = shape
    m = b * s * k
    return (jfused.effective_mode("recompute1", m, k, c0, list(widths)),
            fused_mlp.effective_mode("recompute1", m, k, c0, widths))


# ------------------------------------------------ the fused Function

SHAPES = [((2, 16, 8, 6), (32, 16, 24)), ((4, 16, 8, 6), (16, 32))]


@pytest.mark.parametrize("shape,widths", SHAPES,
                         ids=["2x16x8x6-32-16-24", "4x16x8x6-16-32"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_fused_recompute1_matches_jax(shape, widths, dtype):
    """``fused_mlp_max(mode="recompute1")`` against JAX's
    ``fused_mlp_max(train=True, impl="jnp", mode="recompute1")`` at shapes
    where both gates keep recompute1 (``m % 8k == 0`` for JAX, the port's
    plan fits): outputs, BN statistics and every gradient, within 1e-5 /
    1e-4 of the largest with f32 operands, 1e-3 / 1e-2 with bf16 (the
    tolerances of ``test_fused_recompute_matches_jax``)."""
    assert _both_gates(shape, widths) == ("recompute1", "recompute1")
    g, layers, running, cot = _case(5, shape, widths)
    port = _port_fused(g, layers, running, cot, mode="recompute1",
                       dtype=dtype)
    want = _jax_fused(g, layers, running, cot, mode="recompute1",
                      dtype=dtype)
    if dtype == F32:
        _compare_fused(port, want, 1e-5, 1e-4)
    else:
        _compare_fused(port, want, 1e-3, 1e-2)


def test_fused_recompute1_matches_jax_pallas_interpret():
    """At a tiny shape, against JAX's Pallas single-launch passes
    (``impl="pallas"``, ``interpret=True``, bf16 operands, as
    ``tests/test_fused_mlp.py:404`` runs them): outputs and statistics
    within 1e-3 of the largest, gradients within 1e-2."""
    shape, widths = (2, 8, 8, 6), (16, 24)
    assert _both_gates(shape, widths) == ("recompute1", "recompute1")
    g, layers, running, cot = _case(7, shape, widths)
    port = _port_fused(g, layers, running, cot, mode="recompute1",
                       dtype=BF16)
    want = _jax_fused(g, layers, running, cot, mode="recompute1",
                      dtype=BF16, impl="pallas")
    _compare_fused(port, want, 1e-3, 1e-2)


def test_gates_disagree_on_a_ragged_batch(caplog):
    """96 rows of groups of 8: JAX's gate wants whole 64-row chunks and
    demotes the stack to stream (with its warning); the port's plan takes
    any row count and keeps recompute1. The port's recompute1 step then
    matches JAX's ``mode="recompute"``, the same arithmetic (f32 operands:
    1e-5 / 1e-4 of the largest), and the port logs no demotion."""
    shape, widths = (1, 12, 8, 5), (16, 24)
    assert _both_gates(shape, widths) == ("stream", "recompute1")
    g, layers, running, cot = _case(8, shape, widths)
    with caplog.at_level(logging.WARNING):
        port = _port_fused(g, layers, running, cot, mode="recompute1",
                           dtype=F32)
        _jax_fused(g, layers, running, cot, mode="recompute1", dtype=F32)
    want = _jax_fused(g, layers, running, cot, mode="recompute", dtype=F32)
    _compare_fused(port, want, 1e-5, 1e-4)
    names = [r.name for r in caplog.records if "demoted" in r.getMessage()]
    assert names == ["papc_tpu.ops.fused_mlp"]


def test_demotion_runs_stream_and_warns_once(caplog, monkeypatch):
    """A stack whose single-launch plan does not fit (2.1 MB of bf16
    weights) trains in stream mode: the same output and gradients as
    ``mode="stream"``; JAX's message is logged once for the stack shape,
    however many steps run."""
    monkeypatch.setattr(fused_mlp, "_DEMOTED", set())
    shape, widths = (1, 4, 8, 5), (1024, 1024)
    g, layers, running, cot = _case(9, shape, widths)
    with caplog.at_level(logging.WARNING, logger="papc_tpu_torch"):
        got = [_port_fused(g, layers, running, cot, mode="recompute1",
                           dtype=BF16) for _ in range(2)]
    want = _port_fused(g, layers, running, cot, mode="stream", dtype=BF16)
    for a, b in zip(jax.tree_util.tree_leaves(got[1]),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "papc_tpu_torch.ops.fused_mlp"]
    assert msgs == ["fused_mlp: recompute1 demoted to stream for layer "
                    "stack m=32 k=8 c0=5 widths=[1024, 1024] (fails "
                    "samlp_single.fits) — A/Bs labeled recompute1 run "
                    "stream for this stack"]


# ------------------------------------------------------------- the gate

# Each registry stack's recompute1 decision at B=32 x 1024, in stack
# order: (JAX's samlp_single.fits, the port's). The port keeps SSG SA1 and
# SA2 as JAX does and demotes every group_all stack as JAX does; it also
# demotes MSG SA2 at c0 = 323 with 128-128-256 (184 320 B of resident bf16
# weights, 282 304 B a bwd block at 16 rows) where JAX keeps it.
GATES = {
    ("pointnet2_ssg", "clas"): [(True, True), (True, True), (False, False)],
    ("pointnet2_msg", "clas"): [(True, True)] * 4 + [(True, False)]
    + [(False, False)] * 2,
    ("pointnet2_ssg", "seg"): [(True, True), (True, True), (False, False)],
    ("pointnet2_msg", "seg"): [(True, True)] * 3 + [(True, False)]
    + [(False, False)] * 2,
}


def _bwd_plans(m, k, c0, w):
    """#17 at every level and #18's plans of a stack: ``(kind, level,
    plan)``."""
    w = tuple(w)
    return ([("bwd_stats", lv, samlp_single.bwd_plan(
                "bwd_stats", m, k, c0, w, samlp_single.SMEM_LIMIT, level=lv))
             for lv in range(1, len(w) + 1)]
            + [("bwd_final", None, samlp_single.bwd_plan(
                "bwd_final", m, k, c0, w, samlp_single.SMEM_LIMIT))])


@pytest.mark.parametrize("combo", SA_COMBOS,
                         ids=lambda c: "-".join(c))
def test_recompute1_gate_of_every_stack(combo):
    """Every registry stack's gate decision at B=32 x 1024, the JAX
    package's and the port's, pinned (``GATES``); every admitted stack's
    backward plans fit the H100's shared memory (the bytes of
    ``samlp_recompute.bwd_smem_bytes`` for the plan's own choices), and
    SSG SA1's bwd final keeps dW on chip where SA2's keeps it in a slot a
    block in device memory."""
    spec = registry.init_model(*combo, device="cpu")
    got = [(jsingle.fits(m, k, c0, list(w)), samlp_single.fits(m, k, c0, w))
           for _, m, k, c0, w in P.stack_shapes(spec.model)]
    assert got == GATES[combo]
    for (_, m, k, c0, w), (_, port) in zip(P.stack_shapes(spec.model), got):
        assert fused_mlp.effective_mode("recompute1", m, k, c0, w) == (
            "recompute1" if port else "stream")
        if not port:
            continue
        for kind, lv, pl in _bwd_plans(m, k, c0, w):
            assert pl["smem"] <= samlp_single.SMEM_LIMIT
            assert pl["smem"] == rc.bwd_smem_bytes(
                kind, pl["tm"], k, c0, w, level=lv,
                keep_h=pl["dw"] is not None, a_smem=pl["a_smem"],
                dw_smem=pl["dw"] == "smem", stages=pl["stages"],
                w_res=pl["w_res"])
        if combo == ("pointnet2_ssg", "clas"):
            assert (pl["dw"] == "smem") == (c0 == 3)


@pytest.mark.parametrize("combo", SA_COMBOS,
                         ids=lambda c: "-".join(c))
def test_single_bwd_plans_of_every_admitted_stack(combo):
    """At every stack the gate admits (B=32 x 1024), #17 at every level
    and #18 have a plan within 232 448 B: #13 / #14's tile or a larger one
    (residency never costs tile rows), dW on chip or in a slot (never from
    the rows, a second kernel), a ring of 2-4 stages or the weights
    resident (stages 0), one block an SM at most and a group at least
    each, and a product table that walks down to the pass's last layer."""
    spec = registry.init_model(*combo, device="cpu")
    for _, m, k, c0, w in P.stack_shapes(spec.model):
        if not samlp_single.fits(m, k, c0, w):
            continue
        for kind, lv, pl in _bwd_plans(m, k, c0, w):
            grid = rc.bwd_plan(kind, m, k, c0, tuple(w),
                               samlp_single.SMEM_LIMIT, level=lv)
            assert pl["smem"] <= samlp_single.SMEM_LIMIT
            assert pl["tm"] >= grid["tm"]
            assert pl["dw"] in ((None,) if kind == "bwd_stats"
                                else ("smem", "slot"))
            assert (pl["stages"] == 0) == pl["w_res"]
            assert pl["w_res"] or 2 <= pl["stages"] <= 4
            assert pl["unit"] == k  # k * c0 a multiple of 8 at each
            assert pl["blocks"] == min(132, m // k)
            stop = lv + 1 if lv else 1
            assert [j for j, walk, _ in pl["prods"] if walk] == list(
                range(len(w), stop - 1, -1))


@pytest.mark.parametrize("m,k,c0,unit", [
    (524288, 32, 3, 32),     # SSG SA1: 16384 groups
    (262144, 64, 131, 64),   # SSG SA2: 4096 groups
    (160, 32, 3, 32),        # fewer groups than SMs: a group a block
    (1536, 16, 3, 16),       # MSG clas SA1 at K = 16
    (35, 5, 7, 40),          # rows of 14 B: 8 groups of 5 start on 16 B
    (72, 8, 20, 8),          # the four layers' card test stack
])
def test_single_bwd_block_ranges_cover_every_group_once(m, k, c0, unit):
    """#17 / #18's block ranges (``samlp_single.block_rows`` at the plan's
    ``unit``, the mirrors of the C ``block_rows`` and of the unit the C
    entries accept): the unit is whole groups whose ``g2`` rows start on
    16 bytes, the ranges cover every row once in block order, each cut at
    a unit, no block empty where there are units enough and none more
    than one unit longer than another."""
    pl = samlp_single.bwd_plan("bwd_final", m, k, c0, (16, 32),
                               samlp_single.SMEM_LIMIT)
    assert pl["unit"] == unit == samlp_single.range_unit(k, c0)
    assert unit % k == 0 and unit * c0 * 2 % 16 == 0
    blocks = pl["blocks"]
    assert blocks == min(132, -(-m // unit))
    ranges = samlp_single.block_rows(m, unit, blocks)
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo % unit == 0 and (hi % unit == 0 or hi == m)
               for lo, hi in ranges)
    sizes = [-(-(hi - lo) // unit) for lo, hi in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_single_bwd_plan_keeps_weights_resident_at_sa1():
    """At the SSG clas stacks (B=32 x 1024) #17 and #18 stage the weights
    once at SA1 (29 KB: no ring) and stream them through the ring at SA2
    (138 KB would not fit beside the tile), both at #13 / #14's 128-row
    tile (the wmma single-launch design fell to 16 rows at SA2); #18's
    dW on chip at SA1 (53 KB) and in a slot a block at SA2 (270 KB)."""
    limit = samlp_single.SMEM_LIMIT
    sa1 = (524288, 32, 3, (64, 64, 128))
    sa2 = (262144, 64, 131, (128, 128, 256))
    for lv in (1, 2, 3):
        for stack, res in ((sa1, True), (sa2, False)):
            pl = samlp_single.bwd_plan("bwd_stats", *stack, limit, level=lv)
            assert pl["w_res"] == res and pl["tm"] == 128
    f1 = samlp_single.bwd_plan("bwd_final", *sa1, limit, need_dg=False)
    f2 = samlp_single.bwd_plan("bwd_final", *sa2, limit)
    assert f1["w_res"] and f1["dw"] == "smem" and f1["tm"] == 128
    assert not f2["w_res"] and f2["dw"] == "slot" and f2["tm"] >= 64
    assert f1["dw_part"] == 132 * (16 * 64 + 64 * 64 + 64 * 128)
    assert f2["dw_part"] * 4 // 132 == (144 * 128 + 128 * 128
                                        + 128 * 256) * 4 == 270336
    with pytest.raises(ValueError, match="shared memory"):
        samlp_single.bwd_plan("bwd_final", *sa2, 40_000)
    with pytest.raises(ValueError, match="backward passes"):
        samlp_single.bwd_plan("final", *sa2, limit)


def test_plan_counts_the_resident_constants():
    """The forward plan is #11 / #12's layout with the weights resident
    in the ring's place where a block's range holds several tiles: at
    SSG SA1 (524 288 rows, 16 tiles of 128 a range at two blocks an SM)
    the stats pass at layer 3 needs the ring-free layout's bytes, the
    three W_j in rows of p_j + 8 (28 928 B) where a 4-stage ring would
    take 34 816 B. The gate is not the plan: a stack whose weights alone
    exceed the first design's block fails the admission rule and the
    gate (SSG SA3), though its forward passes now have a plan."""
    w, tm = (64, 64, 128), 128
    pl = samlp_single.fwd_plan("stats", 524288, 1, 3, w,
                               samlp_single.SMEM_LIMIT, upto=3)
    assert pl["w_res"] and pl["stages"] == 0 and pl["tm"] == tm
    resident = pl["smem"] - rc.fwd_smem_bytes("stats", tm, 1, 3, w, upto=3,
                                              stages=0)
    ring = (rc.fwd_smem_bytes("stats", tm, 1, 3, w, upto=3, stages=4)
            - rc.fwd_smem_bytes("stats", tm, 1, 3, w, upto=3, stages=0))
    assert resident == (16 * 72 + 64 * 72 + 64 * 136) * 2 == 28928
    assert ring == 4 * 32 * (128 + 8) * 2 == 34816
    sa3 = (4096, 128, 259, (256, 512, 1024))
    assert not samlp_single._admitted(*sa3[1:])
    assert not samlp_single.fits(*sa3)
    final = samlp_single.fwd_plan("final", *sa3, samlp_single.SMEM_LIMIT)
    assert final["tm"] == 32 and final["smem"] == 124928
    with pytest.raises(ValueError, match="shared memory"):
        samlp_single.fwd_plan("final", *sa3, 40_000)
    with pytest.raises(ValueError, match="forward passes"):
        samlp_single.fwd_plan("bwd_final", *sa3, samlp_single.SMEM_LIMIT)


def _fwd_plans(m, k, c0, w):
    """#15 at every layer and #16's plans of a stack: ``(kind, upto,
    plan)``."""
    w = tuple(w)
    return ([("stats", lv, samlp_single.fwd_plan(
                "stats", m, 1, c0, w, samlp_single.SMEM_LIMIT, upto=lv))
             for lv in range(1, len(w) + 1)]
            + [("final", None, samlp_single.fwd_plan(
                "final", m, k, c0, w, samlp_single.SMEM_LIMIT))])


@pytest.mark.parametrize("combo", SA_COMBOS,
                         ids=lambda c: "-".join(c))
def test_single_fwd_plans_of_every_stack(combo):
    """At every registry stack (B=32 x 1024), admitted or not, #15 at
    every layer and #16 have a plan whose bytes are #11 / #12's layout for
    its own choices (``samlp_recompute.fwd_smem_bytes``) within 232 448 B
    and, at its blocks an SM, within an SM; a tile at least #11 / #12's;
    the weights resident (no ring) or a ring of 2-4 stages, resident only
    where the block's longest range holds ``_FWD_RES_TILES`` tiles; unit 8
    rows for stats and ``range_unit(k, c0)`` for final; block ranges that
    cover every row once in block order, each cut at a unit; and a
    product table a_1 .. a_n."""
    spec = registry.init_model(*combo, device="cpu")
    for _, m, k, c0, w in P.stack_shapes(spec.model):
        for kind, lv, pl in _fwd_plans(m, k, c0, w):
            kk = 1 if kind == "stats" else k
            assert pl["smem"] == rc.fwd_smem_bytes(
                kind, pl["tm"], kk, c0, w, upto=lv, stages=pl["stages"],
                w_res=pl["w_res"])
            assert pl["smem"] <= samlp_single.SMEM_LIMIT
            assert pl["per_sm"] * (pl["smem"] + 1024) <= rc._SM_SMEM
            grid = rc.fwd_plan(kind, m, kk, c0, tuple(w),
                               samlp_single.SMEM_LIMIT, upto=lv)
            assert pl["tm"] >= grid["tm"]
            assert (pl["stages"] == 0) == pl["w_res"]
            assert pl["w_res"] or 2 <= pl["stages"] <= 4
            assert not pl["w_res"] or pl["tiles"] >= rc._FWD_RES_TILES
            unit = 8 if kind == "stats" else samlp_single.range_unit(k, c0)
            assert pl["unit"] == unit
            units = -(-m // unit)
            assert pl["blocks"] == min(units, 132 * pl["per_sm"])
            ranges = samlp_single.block_rows(m, unit, pl["blocks"])
            assert ranges[0][0] == 0 and ranges[-1][1] == m
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(lo % unit == 0 for lo, _ in ranges)
            assert max(-(-(hi - lo) // pl["tm"]) for lo, hi in ranges) \
                == pl["tiles"]
            n = lv or len(w)
            assert [(j, walk) for j, walk, _ in pl["prods"]] == [
                (j, 0) for j in range(1, n + 1)]


@pytest.mark.parametrize("m,unit", [
    (524288, 8),   # SSG SA1 stats: 65 536 units over 264 blocks
    (262144, 8),   # SSG SA2 stats
    (4096, 8),     # SSG SA3 stats: more blocks than tiles of 32 rows
    (35, 40),      # rows of 14 B at k = 5: fewer rows than a unit
    (4104, 8),     # a ragged last unit is never split
])
def test_single_fwd_block_ranges_cover_every_row_once(m, unit):
    """#15 / #16's block ranges (``block_rows`` at the plan's unit, the
    mirror of the C ``block_rows``) cover every row once in block order,
    each range starting on a unit (so its tiles' ``g2`` rows start on 16
    bytes) and none more than one unit longer than another. A range ends
    inside a tile wherever it is not a multiple of the tile: the tile
    loop's row-end mask decides which rows a block sums."""
    blocks = min(-(-m // unit), 264)
    ranges = samlp_single.block_rows(m, unit, blocks)
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo % unit == 0 for lo, _ in ranges)
    sizes = [-(-(hi - lo) // unit) for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    covered = np.zeros(m, int)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_single_fwd_plan_at_the_ssg_stacks():
    """At the SSG clas stacks (B=32 x 1024) #15 and #16 plan #11 / #12's
    choices, counted from the block ranges: two blocks an SM (264), SA1's
    ranges 16 tiles of 128 rows and SA2's 8, the weights resident at SA1
    (every pass) and at SA2's layer 1; a 4- or 3-stage ring at SA2's
    layers 2-3 and final, where resident weights (151 808-223 488 B) would
    fit only one block an SM."""
    limit = samlp_single.SMEM_LIMIT
    for (m, k, c0, w), res, tiles in (
            ((524288, 32, 3, (64, 64, 128)), [True] * 4, 16),
            ((262144, 64, 131, (128, 128, 256)),
             [True, False, False, False], 8)):
        plans = _fwd_plans(m, k, c0, w)
        assert [pl["w_res"] for _, _, pl in plans] == res
        for kind, lv, pl in plans:
            assert pl["per_sm"] == 2 and pl["blocks"] == 264
            assert pl["tm"] == 128 and pl["tiles"] == tiles
            if not pl["w_res"]:
                kk = 1 if kind == "stats" else k
                held = rc.fwd_smem_bytes(kind, 128, kk, c0, w, upto=lv,
                                         w_res=True)
                assert 151808 <= held <= 223488
                assert 2 * (held + 1024) > rc._SM_SMEM


# ------------------------------------------------- whole steps, bf16

# Measured on these inputs (B=8, reduced SSG; SA1 and SA2 in recompute1 on
# both sides, SA3 demoted to stream on both): the port's gradients at most
# 1.21 times (median 0.95) as far from its float64 step as JAX's, 0.145
# apart in median relative L2, the noise biases within 1.3e-3 of their
# module's largest. SA3 stores bf16 activations: its input differs between
# the two sides by the recompute passes' sum order, which flips ties of its
# max (at B=4 one such flip put a BN scale's gradient 2.5 times as far).
STEP_LIMITS = {"loss": 1e-3, "stats": 1e-2, "ratio": 1.5,
               "median_ratio": 1.15, "median_rel": 0.35, "noise": 2e-2}


def test_recompute1_train_step_matches_jax(monkeypatch):
    """One reduced SSG clas step at B=8 with bf16 operands under
    ``override(mode="recompute1")`` against ``make_train_step`` under
    ``override(enable=True, impl="jnp", mode="recompute1")``, every SA
    stage fused (``permissive_fused_gate``), both judged by the port's
    float64 step (``check_bf16_step``, within ``STEP_LIMITS``)."""
    b = P.batch(8, 128, seed=5)
    kw = {"npoints": (32, 16), "nsamples": (8, 16)}
    jmodel = JaxSSG(num_classes=16, **kw)
    variables = P.perturbed_variables(jmodel, "clas", b, 5)
    rs = np.random.RandomState(6)
    masks = [rs.uniform(size=(8, 512)) < 0.6, rs.uniform(size=(8, 256)) < 0.5]
    P.permissive_fused_gate(monkeypatch)

    def make():
        return PointNet2SSGClas(num_classes=16, **kw)

    want = P.jax_step(jmodel, "clas", variables, b, masks, 1e-3, 1e-3,
                      fused=True, fused_mode="recompute1")
    port = P.port_step(make, variables, b, masks, 1e-3, 1e-3, BF16,
                       fused_mode="recompute1")
    exact = P.port_step(make, variables, b, masks, 1e-3, 1e-3, torch.float64,
                        fused_mode="recompute1")
    P.check_bf16_step(port, want, exact, variables, 1e-3, 1e-3, STEP_LIMITS)


# ---------------------------------------------- repairs of three faults

@pytest.fixture(scope="module")
def shapenet(tmp_path_factory):
    return write_shapenet_h5(str(tmp_path_factory.mktemp("shapenet")),
                             n_train=23, n_test=3, n_val=3, n_points=64,
                             num_classes=4, num_parts=8, seed=3)


def test_train_shuffles_as_jax_whatever_the_seed(shapenet, monkeypatch,
                                                 tmp_path):
    """``train(seed=1)`` feeds the train split in the order JAX's
    ``make_dataloader`` gives it (``RandomState(0)``: JAX's ``train`` never
    passes its seed to the loaders); the seed moves weights and dropout
    only. A loader shuffled with the seed would differ."""
    seen = []

    def step(model, opt, batch, device, generator=None, impl=None,
             precision="fp32"):
        seen.append(np.asarray(batch["label"])[np.asarray(batch["mask"])])
        return torch.zeros(()), torch.zeros(())

    monkeypatch.setattr(trainer, "train_step", step)
    monkeypatch.setattr(trainer, "eval_step", lambda *a: (None, 0.0, 0.0))
    trainer.train("pointnet2_ssg", max_point=64, epoch_num=1, batchsize=5,
                  path=shapenet, model_dir=str(tmp_path), seed=1,
                  device="cpu", log=lambda line: None)
    want = [w.label[w.mask] for w in make_dataloader(
        "pointnet2_ssg", 64, 5, shapenet, "clas", "train")()]
    np.testing.assert_array_equal(np.concatenate(seen), np.concatenate(want))
    seeded = make_dataloader("pointnet2_ssg", 64, 5, shapenet, "clas",
                             "train", seed=1)
    assert not np.array_equal(np.concatenate(seen), np.concatenate(
        [w.label[w.mask] for w in seeded()]))


@pytest.mark.parametrize("mode,shape", [("clas", (0, 16)),
                                        ("seg", (0, 1024, 50))])
def test_evaluate_on_an_empty_split(tmp_path, mode, shape):
    """An empty split reports ``num_samples`` 1, as JAX's ``evaluate``
    (``int(max(Σmask, 1))``), and logits of the mode's shape with no rows:
    ``[0, classes]``, or ``[0, N, parts]`` for segmentation."""
    spec = init_model("pointnet2_ssg", mode, seed=0, device="cpu")
    weights = tmp_path / "w.npz"
    np.savez(weights, **state_dict_to_flax(spec.model.state_dict()))
    result = evaluate("pointnet2_ssg", mode, weights=weights,
                      make_loader=lambda split: lambda: iter(()),
                      device="cpu", log=lambda line: None)
    assert result["num_samples"] == 1
    assert tuple(result["logits"].shape) == shape
    assert result["loss"] == 0.0


def test_detection_serving_runs_f32_convolutions(monkeypatch):
    """``predict_step`` runs the network inside
    ``torch.backends.cudnn.flags(enabled=True, allow_tf32=False)``: cuDNN
    may not take TF32 for the float32 convolutions while the network runs,
    and the process-wide flag is what it was before and after."""
    seen = []

    class Net(torch.nn.Module):
        def forward(self, *args):
            seen.append((torch.backends.cudnn.enabled,
                         torch.backends.cudnn.allow_tf32))
            return {}

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(detect_train, "predict",
                        lambda *args, **kw: {"valid": torch.ones(1)})
    step = detect_train.make_predict_step(
        Net(), SimpleNamespace(multiclass_nms=False),
        SimpleNamespace(decode=None), lambda batch: (), device="cpu")
    assert step({"anchors": np.zeros((1, 2, 7), np.float32)})["valid"].shape \
        == (1,)
    assert seen == [(True, False)]
    assert torch.backends.cudnn.allow_tf32
