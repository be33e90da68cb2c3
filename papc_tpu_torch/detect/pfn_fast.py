"""The flat-points PillarFeatureNet (counterpart of
``papc_tpu/detect/pfn_fast.py``'s ``pfn_forward_flat`` and ``nnrelu``;
its ``pfn_forward_t`` is a record of a TPU layout and is not carried).

The classic PFN (decorate → Linear → BatchNorm → ReLU → max over a
pillar's ``P`` slots) computed on the real points only: ``points [B, N,
D]`` with their pillar rows ``point_pillar [B, N]`` (-1 for padding)
instead of the ``[B, V, P, D]`` slot grid, which at the KITTI workload
holds about 50 times more slots than points. The classic semantics are
kept exactly:

* the BatchNorm statistics take the whole slot population ``n = B·V·P``:
  the padded slots add zeros to the sums, so only the divisor changes,
  and the variance is the uncentred ``M2 - μμᵀ`` of the decorated
  features projected through the kernel (``mean_h = Wᵀμ``, ``var_h =
  wᵀ Cov w``), never ``h`` itself; the running statistics follow flax
  (momentum 0.01, the biased variance);
* BatchNorm folds into the Dense (``W' = W·γ/σ``, ``b' = β - mean_h·γ/σ``),
  and a padded slot's activation is ``a0 = max(b', 0)``: it joins a
  pillar's max where the pillar has fewer than ``P`` points (an empty
  pillar gives ``a0``, as the classic all-zero row does);
* the max is one scatter-max of the points' rows onto a ``-inf`` canvas
  (``scatter_reduce("amax", include_self=True)``: a tie shares the
  gradient evenly between the tied points, as JAX's scatter-max does),
  then ``where(count < P, maximum(seg, a0), seg)``;
* the ReLU is ``maximum(x, 0)``, whose gradient at exactly 0 is 0.5 in
  JAX and in ``torch.maximum`` (``torch.relu`` gives 0 there).

The statistics' small products (``M2``, ``Wᵀμ``, ``wᵀ Cov w``) are
elementwise products summed in float32, with no matrix unit, so they
take no TF32 on the card. The per-pillar sums are one segment sum over
the rows in sorted order, so a forward gives the same bits every call
on the card (a scatter-add's atomics would add in any order, which in
bf16 moved the served boxes between two calls); a bf16 sum accumulates
in f32 and rounds once, where JAX's bf16 scatter-add rounds each add.
No kernel of the port runs here: JAX computes this outside any Pallas
kernel, in XLA's scatters and dots.
"""

from __future__ import annotations

import torch


def nnrelu(x: torch.Tensor) -> torch.Tensor:
    """``maximum(x, 0)``: JAX's ``jnp.maximum(x, 0)`` with its gradient
    of 0.5 at 0."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def pfn_forward_flat(kernel, scale, bias, running, points, point_pillar,
                     num_points, coords, max_points_per_pillar: int, *,
                     voxel_size, pc_range, with_distance: bool = False,
                     train: bool = True, momentum: float = 0.01,
                     eps: float = 1e-3):
    """One PFN layer (Dense without bias, BatchNorm, ReLU, max) on flat
    points → ``(out [B, V, O], new_running)``.

    ``kernel [C, O]`` (C = D + 5, + 1 ``with_distance``), BatchNorm's
    ``scale`` and ``bias [O]``, its f32 ``running`` ``(mean, var)``;
    ``points [B, N, D]`` (xyz first, zero rows past the real points),
    ``point_pillar [B, N]`` (a pillar row in ``[0, V)``, -1 for
    padding), ``num_points [B, V]`` (each pillar's count of points in
    the flat view, as the flat streamer gives it), ``coords [B, V, 3]``
    (z, y, x).
    The compute dtype is ``points``' (bf16 in the bf16 step); the
    statistics are f32. In eval the running statistics normalise and
    come back as they are."""
    B, N, _ = points.shape
    V = num_points.shape[1]
    P = int(max_points_per_pillar)
    dt = points.dtype
    dev = points.device
    valid = point_pillar >= 0
    rows = torch.where(valid,
                       torch.arange(B, device=dev)[:, None] * V
                       + point_pillar.long(),
                       B * V).reshape(B * N)

    # per-pillar xyz mean: one segment sum over the real points, their
    # rows sorted (stable: a pillar's points keep their order), so the
    # sums do not depend on the order of atomics on the card; the
    # segments' lengths are the counts, and the padding's row last
    xyz = torch.where(valid[..., None], points[..., :3],
                      torch.zeros((), dtype=dt, device=dev))
    order = torch.argsort(rows, stable=True)
    counts = num_points.reshape(B * V).long()
    lengths = torch.cat([counts, (B * N - counts.sum()).reshape(1)])
    sums = torch.segment_reduce(xyz.reshape(B * N, 3)[order], "sum",
                                lengths=lengths, axis=0)
    denom = torch.clamp_min(num_points, 1).to(dt).reshape(B * V, 1)
    mean_pp = sums[:B * V] / denom
    grows = torch.clamp_max(rows, B * V - 1)  # the dump row reads a real one
    mean_pt = mean_pp[grows].reshape(B, N, 3)
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    centers = torch.stack([
        coords[..., 2].to(dt) * vx + (vx / 2 + float(pc_range[0])),
        coords[..., 1].to(dt) * vy + (vy / 2 + float(pc_range[1])),
    ], dim=-1).reshape(-1, 2)
    center_pt = centers[grows].reshape(B, N, 2)
    feats = [points, points[..., :3] - mean_pt, points[..., :2] - center_pt]
    if with_distance:
        feats.append(torch.linalg.vector_norm(points[..., :3], dim=-1,
                                              keepdim=True))
    f = torch.cat(feats, dim=-1) * valid[..., None].to(dt)
    C = f.shape[-1]
    f2 = f.reshape(B * N, C)

    k32 = kernel.float()
    if train:
        n = B * V * P  # the classic population: every slot, padded or not
        s1 = f2.sum(0, dtype=torch.float32) / n
        f32 = f2.float()
        m2 = (f32[:, :, None] * f32[:, None, :]).sum(0) / n
        cov = m2 - s1[:, None] * s1[None, :]
        mean_h = (s1[:, None] * k32).sum(0)
        var_h = (k32[:, None, :] * cov[:, :, None]
                 * k32[None, :, :]).sum((0, 1))
        var_h = torch.maximum(var_h, torch.zeros((), device=dev))
        new_running = (momentum * running[0] + (1.0 - momentum)
                       * mean_h.detach(),
                       momentum * running[1] + (1.0 - momentum)
                       * var_h.detach())
    else:
        mean_h, var_h = running
        new_running = running

    inv = scale.float() * torch.rsqrt(var_h + eps)
    w_f = (k32 * inv[None, :]).to(dt)
    b_f = (bias.float() - mean_h * inv).to(dt)
    h = nnrelu(f2 @ w_f + b_f[None, :])  # [B·N, O]
    O = h.shape[1]
    neg = torch.full((), float("-inf"), dtype=dt, device=dev)
    seg = torch.full((B * V + 1, O), float("-inf"), dtype=dt, device=dev)
    seg = seg.scatter_reduce(0, rows[:, None].expand(B * N, O),
                             torch.where(valid.reshape(B * N, 1), h, neg),
                             "amax", include_self=True)
    seg = seg[:B * V].reshape(B, V, O)
    # the padded slots' activation joins the max where a pillar has any
    a0 = nnrelu(b_f)
    has_pad = (num_points < P)[..., None]
    out = torch.where(has_pad, torch.maximum(seg, a0), seg)
    return out, new_running

