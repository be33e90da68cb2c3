"""The owner-computes scatter-add shared by the port's two scatter
backwards (``csrc/scatter_sorted.cuh``): its plan and the plain twins of
its two steps.

``out[b, j] = Σ g[b, e]`` over the entries ``e`` of cloud ``b`` whose
point is ``j``. The grouping gather's backward (``gather.scatter_add``,
#4) clamps an entry's index into ``[0, n)``; the row gather's
(``scatter_rows.scatter_rows_add``, #5) drops an index outside it. On the
card, first a stable counting sort of each cloud's entries by point (the
inverse index, :func:`inverse_index_plain`), then a sum of each point's
entries in that order, every output row written once
(:func:`scatter_add_sorted_plain`; a long list is split over consecutive
workers whose parts are added in order, :func:`sum_schedule`). No
atomics on the output: two calls give the same bits. :func:`sorted_plan`
sizes both launches and raises above ``SCATTER_N_LIMIT`` points.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

SMEM_LIMIT = 232448  # dynamic shared memory a block may opt into (H100)
THREADS = 256  # threads of a sum block
SCATTER_N_LIMIT = 8192  # points a cloud the inverse index counts
INDEX_WARPS = (32, 16, 8, 4)  # the index kernel's warps a cloud, by choice
MAX_CHANS = 8  # channels a sum lane holds a walk


class ScatterPlan(NamedTuple):
    warps: int  # inverse index: warps a cloud
    lanes: int  # sum: lanes an output row
    chans: int  # sum: channels a lane a walk of the row's list
    smem: int  # inverse index: bytes of counts, offsets and scan totals
    blocks: int  # sum: blocks of THREADS threads, sum_rows(lanes) rows each


def sum_rows(lanes: int) -> int:
    """Rows a sum block takes: half its workers, so that a long list
    spreads over at least two workers' parts."""
    return THREADS // lanes // 2


def index_smem(warps: int, n: int) -> int:
    """The inverse index's shared memory: a row of ``n`` counts a warp,
    the ``n`` offsets and 32 scan totals, 4 bytes each."""
    return 4 * (warps * n + n + 32)


@functools.lru_cache(maxsize=None)
def sorted_plan(b: int, n: int, entries: int, c: int) -> ScatterPlan:
    """The two launches for ``b`` clouds of ``entries`` entries into ``n``
    points of ``c`` channels. The inverse index: a block a cloud, the most
    warps of ``INDEX_WARPS`` whose counts fit in shared memory (32 up to
    1760 points, 4 at ``SCATTER_N_LIMIT``); warp w sorts the w-th
    contiguous chunk of the cloud's entries. The sum: a block of
    ``THREADS // lanes`` workers takes ``sum_rows(lanes)`` rows of one
    cloud and splits their entries evenly over its workers (see
    :func:`sum_schedule`); a worker is ``lanes`` lanes, the power of two
    at or above ``c`` between 4 and 32, each lane holding ``chans``
    channels (up to ``MAX_CHANS``; wider rows take more walks). Raises
    ``ValueError`` above ``SCATTER_N_LIMIT`` points."""
    if min(b, n, entries, c) < 1:
        raise ValueError(f"the scatter-add needs positive shapes, got b={b}, "
                         f"n={n}, entries={entries}, c={c}")
    if n > SCATTER_N_LIMIT:
        raise ValueError(f"the scatter-add's inverse index counts at most "
                         f"{SCATTER_N_LIMIT} points a cloud, got n={n}")
    warps = next(w for w in INDEX_WARPS if index_smem(w, n) <= SMEM_LIMIT)
    lanes = max(4, min(32, 1 << (c - 1).bit_length()))
    chans = 1 if lanes < 32 else min(MAX_CHANS, -(-c // 32))
    return ScatterPlan(warps, lanes, chans, index_smem(warps, n),
                       b * -(-n // sum_rows(lanes)))


def sum_schedule(offsets: list[int], workers: int):
    """How one sum block of ``workers`` workers shares the rows whose
    lists start at ``offsets`` (the block's ``rows + 1`` offsets of the
    inverse index), as ``scatter_sum`` splits them: worker w walks the
    entries ``ranges[w]`` in order; a row inside one worker's range is
    written by that worker, any other (empty, or split over workers
    ``first..last``) by the merge, which adds the partials of ``first..
    last`` in order. Returns ``(ranges, writers)``, ``writers[r]`` the
    workers whose partials make row r (one for a row written whole)."""
    begin, total = offsets[0], offsets[-1] - offsets[0]
    per = -(-total // workers)
    ranges = [(begin + min(w * per, total), begin + min((w + 1) * per, total))
              for w in range(workers)]
    writers = []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        if lo == hi:
            writers.append(range(0))
            continue
        writers.append(range((lo - begin) // per, (hi - 1 - begin) // per + 1))
    return ranges, writers


def inverse_index_plain(idx: torch.Tensor, n: int, *,
                        drop: bool = False) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Each cloud's entries ``idx [B, ...]`` sorted stably by point, as the
    first kernel builds them: ``offsets [B, n + 1]`` and ``order [B, E]``
    int32, point j's entries (flat, ascending) at ``order[b, offsets[b,
    j]:offsets[b, j + 1]]``. An index outside ``[0, n)`` is clamped into
    it, or with ``drop`` in no list: then ``offsets[b, n]`` counts the
    entries kept, and the dropped ones follow them in ``order`` (which the
    kernel leaves unwritten)."""
    B = idx.shape[0]
    flat = idx.reshape(B, -1).long()
    if drop:
        points = torch.where((flat >= 0) & (flat < n), flat, n)
    else:
        points = flat.clamp(0, n - 1)
    clouds = (torch.arange(B, device=idx.device) * (n + 1))[:, None]
    counts = torch.bincount((points + clouds).reshape(-1),
                            minlength=B * (n + 1)).reshape(B, n + 1)[:, :n]
    offsets = torch.nn.functional.pad(counts.cumsum(1), (1, 0))
    order = torch.argsort(points, dim=1, stable=True)
    return offsets.int(), order.int()


def scatter_add_sorted_plain(g: torch.Tensor, offsets: torch.Tensor,
                             order: torch.Tensor, n: int) -> torch.Tensor:
    """The scatter-add through the inverse index in the order the second
    kernel walks it: point j's rows of ``g [B, ..., C]`` (f32, or bf16
    widened) added in its list's order, into zeros where the list is
    empty (a list the kernel splits over workers adds their parts' sums
    instead) → ``[B, n, C]`` f32."""
    B, C = g.shape[0], g.shape[-1]
    rows = g.reshape(B, -1, C).float()
    entries = rows.shape[1]
    taken = torch.gather(rows, 1, order.long()[..., None].expand(-1, -1, C))
    slots = torch.arange(entries, device=g.device).expand(B, -1).contiguous()
    point = torch.searchsorted(offsets[:, 1:].long().contiguous(), slots,
                               right=True)
    point = point + (torch.arange(B, device=g.device) * n)[:, None]
    kept = slots < offsets[:, n:].long()
    out = torch.zeros((B * n, C), dtype=torch.float32, device=g.device)
    out.index_add_(0, point[kept], taken[kept])
    return out.reshape(B, n, C)
