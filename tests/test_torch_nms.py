"""The two stages of the port's NMS kernels, in their plain twins, on the CPU.

Both kernels build a suppression bitmask and sweep it
(``papc_tpu_torch/ops/kernels/nms.py``). The twins of the stages,
``greedy_mask_plain`` / ``rotate_mask_plain`` and ``sweep_mask_plain``,
are the kernels' oracles on the card; here, composed, they must give
exactly the keep mask of ``greedy_suppress_plain``, of the JAX package's
matrix path and of its interpret-mode Pallas kernels, on score-sorted
boxes at K = 1 to 200, all invalid, one box suppressing every other and
identical boxes. The scratch layout and the sweep's plan are pinned
against the shared-memory budget they claim.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.ops.pallas.nms import greedy_suppress_pallas, rotate_nms_pallas

from papc_tpu_torch.ops.iou import box5_to_corners
from papc_tpu_torch.ops.kernels import nms as knms
from tests.nms_boxes import (DEGENERATE_GROUP, clip_vertices,
                             clustered_rboxes, near_degenerate_rboxes)
from tests.torch_parity import few_threads  # noqa: F401

# Two torch threads: the suite runs six worker processes on the host's
# cores, and with a thread a core each the plain masks' small ops took
# 150 times their time alone (the rotated cases' plain pieces: 5 s alone,
# 760 s in six concurrent processes, 32-40 s with two threads each).
pytestmark = pytest.mark.usefixtures("few_threads")

jiou = importlib.import_module("papc_tpu.ops.iou")
jnms = importlib.import_module("papc_tpu.ops.nms")

# the threshold traced, not static: one compile a K for both thresholds
_matrix_path = jax.jit(lambda b, v, thr: jnms.greedy_suppress(
    jiou.rotate_iou(b, b), v, thr))


def _random_iou(rs, B, K):
    m = rs.rand(B, K, K).astype(np.float32)
    m = np.maximum(m, np.swapaxes(m, 1, 2))
    for b in range(B):
        np.fill_diagonal(m[b], 1.0)
    return torch.from_numpy(m)


def _cases(K):
    """(name, boxes [2, K, 5], valid [2, K]) at K: clustered boxes with
    one frame partly invalid, all invalid, box 0 covering every other,
    and K copies of one box."""
    rs = np.random.RandomState(K)
    boxes = clustered_rboxes(K, 2, K)
    valid = torch.ones(2, K, dtype=torch.bool)
    valid[1] = torch.from_numpy(rs.rand(K) > 0.3)
    # box 0 and the others at most 0.3 m and 0.05 rad from it: each
    # other overlaps box 0 with an IoU above 0.5
    cover = torch.tensor([20.0, 20.0, 4.0, 4.0, 0.3]).repeat(2, K, 1)
    cover[:, 1:, :2] += torch.from_numpy(
        rs.uniform(-0.3, 0.3, (2, K - 1, 2)).astype(np.float32))
    cover[:, 1:, 4] += torch.from_numpy(
        rs.uniform(-0.05, 0.05, (2, K - 1)).astype(np.float32))
    same = boxes[:, :1].expand(2, K, 5).contiguous()
    all_valid = torch.ones(2, K, dtype=torch.bool)
    return [("clustered", boxes, valid),
            ("all invalid", boxes, torch.zeros(2, K, dtype=torch.bool)),
            ("one covers all", cover, all_valid),
            ("identical", same, all_valid)]


@pytest.mark.parametrize("K", [1, 63, 64, 65, 200])
def test_rotate_stages_compose_to_every_keep_mask(K):
    for name, boxes, valid in _cases(K):
        for thr in (0.1, 0.5):
            mask = knms.rotate_mask_plain(boxes, valid, thr)
            assert mask.shape == (2, K, knms.mask_words(K))
            got = knms.sweep_mask_plain(mask, valid)
            torch.testing.assert_close(
                got, knms.rotate_nms_plain(boxes, valid, thr), rtol=0, atol=0)
            for b in range(2):
                jb, jv = jnp.asarray(boxes[b].numpy()), jnp.asarray(
                    valid[b].numpy())
                np.testing.assert_array_equal(
                    got[b].numpy(), np.asarray(_matrix_path(jb, jv, thr)),
                    err_msg=f"{name} thr {thr} frame {b}")
                if thr == 0.5 and name in ("clustered", "one covers all"):
                    np.testing.assert_array_equal(got[b].numpy(), np.asarray(
                        rotate_nms_pallas(jb, jv, thr, interpret=True)))
            if name == "all invalid":
                assert not got.any() and not mask.any()
            if name == "one covers all":
                assert got[:, 0].all() and not got[:, 1:].any()
            if name == "identical":
                assert got[:, 0].all() and not got[:, 1:].any()


@pytest.mark.parametrize("K", [1, 63, 64, 65, 200])
def test_greedy_stages_compose_to_every_keep_mask(K):
    rs = np.random.RandomState(K + 1)
    iou = _random_iou(rs, 2, K)
    valid = torch.from_numpy(rs.rand(2, K) > 0.3)
    cover = torch.zeros(2, K, K)
    cover[:, 0, :] = cover[:, :, 0] = 0.95  # box 0 covers every other
    same = torch.ones(2, K, K)  # identical boxes
    nan = iou.clone()
    nan[:, ::3] = float("nan")  # NaN suppresses nothing
    ones = torch.ones(2, K, dtype=torch.bool)
    for name, m, v in [("random", iou, valid), ("random all valid", iou, ones),
                       ("all invalid", iou, torch.zeros_like(ones)),
                       ("one covers all", cover, ones),
                       ("identical", same, ones), ("nan rows", nan, ones)]:
        for thr in (0.3, 0.5, 0.9):
            mask = knms.greedy_mask_plain(m, v, thr)
            got = knms.sweep_mask_plain(mask, v)
            torch.testing.assert_close(
                got, knms.greedy_suppress_plain(m, v, thr), rtol=0, atol=0)
            for b in range(2):
                jm, jv = jnp.asarray(m[b].numpy()), jnp.asarray(v[b].numpy())
                np.testing.assert_array_equal(
                    got[b].numpy(),
                    np.asarray(jnms.greedy_suppress(jm, jv, thr)),
                    err_msg=f"{name} thr {thr} frame {b}")
                if thr == 0.5:
                    np.testing.assert_array_equal(got[b].numpy(), np.asarray(
                        greedy_suppress_pallas(jm, jv, thr, interpret=True)))
            if name in ("one covers all", "identical"):
                assert got[:, 0].all() and not got[:, 1:].any()


@pytest.mark.parametrize("K", [1, 63, 64, 65, 130])
def test_every_pair_has_one_bit_of_one_word(K):
    """Bit j % 64 of word j // 64 of row i, for every valid pair i < j
    and no other; packing and unpacking are inverse."""
    over = torch.ones(1, K, K, dtype=torch.bool)
    mask = knms.pair_mask_plain(over, torch.ones(1, K, dtype=torch.bool))
    assert mask.shape == (1, K, knms.mask_words(K)) and mask.dtype == torch.int64
    bits = knms.unpack_bits(mask, K)
    assert torch.equal(bits[0], torch.ones(K, K, dtype=torch.bool).triu(1))
    for i in range(K):
        for j in {i + 1, K - 1}:
            if i < j < K:
                word = int(mask[0, i, j // 64])
                assert (word >> (j % 64)) & 1
    per_word = [bin(int(w) & (2 ** 64 - 1)).count("1")
                for w in mask.flatten()]
    assert sum(per_word) == K * (K - 1) // 2
    rs = np.random.RandomState(K)
    rand = torch.from_numpy(rs.rand(3, K) > 0.5)
    assert torch.equal(knms.unpack_bits(knms.pack_bits(rand), K), rand)


@pytest.mark.parametrize("B,K,rotate", [(2, 1000, True), (2, 1000, False),
                                        (1, 1, True), (3, 65, True),
                                        (2, 130, False)])
def test_scratch_is_the_wrappers_allocation(B, K, rotate):
    """The mask rows padded to 64 W, then (rotated) one int a mask block:
    the views cover the wrapper's allocation exactly, without overlap."""
    W = knms.mask_words(K)
    n = knms.scratch_bytes(B, K, rotate)
    mask_bytes = 8 * B * 64 * W * W
    over_bytes = 4 * B * 2 * W * -(-K // knms.MASK_WARPS) if rotate else 0
    assert n == mask_bytes + over_bytes
    if (B, K) == (2, 1000):
        assert mask_bytes == 256 * 1024  # B x 1024 rows x 16 words
    scratch = torch.zeros(n, dtype=torch.uint8)
    mask, over = knms.scratch_views(scratch, B, K, rotate)
    assert mask.shape == (B, K, W) and mask.dtype == torch.int64
    assert mask.data_ptr() == scratch.data_ptr()
    # frame b, row i, word w at byte 8 (b 64 W W + i W + w)
    mask[-1, -1, -1] = -1
    at = 8 * ((B - 1) * 64 * W * W + (K - 1) * W + W - 1)
    assert bool((scratch[at:at + 8] == 255).all())
    assert int(scratch.sum()) == 8 * 255
    if rotate:
        assert over.shape == (B, 2 * W, -(-K // knms.MASK_WARPS))
        assert over.data_ptr() == scratch.data_ptr() + mask_bytes
        assert over.numel() * 4 == over_bytes
    else:
        assert over is None


def test_sweep_plan_and_limits():
    """The sweep holds a bit a box in one block's shared memory, with a
    ring of row blocks where it fits; the limits cover every K the
    one-block-per-frame kernels took."""
    assert knms.ROTATE_MAX_K >= 6282 and knms.GREEDY_MAX_K >= 232448
    top = knms.sweep_plan(knms.MAX_K)
    assert not top.staged and top.smem_bytes <= knms.SMEM_BYTES
    assert 8 * (knms.mask_words(knms.MAX_K + 1)) + 8 > knms.SMEM_BYTES
    plan = knms.sweep_plan(1000)
    assert plan == knms.SweepPlan(128, True, 16 * 8 + 8 + 3 * 64 * 16 * 8)
    for k in (1, 64, 65, 2048, 9000, 20000, 232448, knms.MAX_K):
        p = knms.sweep_plan(k)
        w = knms.mask_words(k)
        assert p.threads == min(1024, 128 * -(-w // 32)) >= min(w, 1024)
        assert p.smem_bytes <= knms.SMEM_BYTES
        assert p.staged == (8 * w + 8 + 3 * 64 * w * 8 <= knms.SMEM_BYTES)
    with pytest.raises(ValueError, match=f"limit of {knms.MAX_K}"):
        knms.rotate_nms_cuda(torch.zeros(1, knms.MAX_K + 1, 5),
                             torch.ones(1, knms.MAX_K + 1, dtype=torch.bool),
                             0.5)


def test_near_degenerate_boxes_overflow_the_register_ring():
    """The card tests' near-degenerate set holds pairs whose clip, in the
    mask kernel's arithmetic, emits more than the register ring's 8
    vertices (the kernel clips those again in its 64-slot ring)."""
    corners = box5_to_corners(near_degenerate_rboxes(2048, 2, 2048))[0]
    c = corners.numpy()
    g = DEGENERATE_GROUP
    found = 0
    for first in range(0, 2048, g):
        for i in range(first, first + g):
            for j in range(i + 1, first + g):
                found += clip_vertices(c[j], c[i]) > 8
        if found:
            break
    assert found
