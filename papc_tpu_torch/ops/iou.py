"""Box IoU, axis-aligned and exact rotated (counterpart of
``papc_tpu/ops/iou.py``), in plain PyTorch with leading batch axes.

These are the plain versions behind the NMS kernels and their oracles.
The rotated intersection is the JAX package's Sutherland–Hodgman clip
over a doubling-slot masked ring (4 → 8 → 16 → 32 → 64 slots), op for op
in the same f32 order, so that the plain rotated NMS equals the JAX
matrix path and the fused Pallas sweep.
"""

from __future__ import annotations

import torch


def iou_2d(boxes: torch.Tensor, query: torch.Tensor,
           eps: float = 0.0) -> torch.Tensor:
    """Axis-aligned IoU matrix: ``[..., N, 4] x [..., K, 4] → [..., N, K]``
    for ``(x1, y1, x2, y2)`` boxes."""
    b = boxes[..., :, None, :]
    q = query[..., None, :, :]
    iw = (torch.minimum(b[..., 2], q[..., 2])
          - torch.maximum(b[..., 0], q[..., 0]) + eps)
    ih = (torch.minimum(b[..., 3], q[..., 3])
          - torch.maximum(b[..., 1], q[..., 1]) + eps)
    inter = torch.clamp_min(iw, 0) * torch.clamp_min(ih, 0)
    area_b = (b[..., 2] - b[..., 0] + eps) * (b[..., 3] - b[..., 1] + eps)
    area_q = (q[..., 2] - q[..., 0] + eps) * (q[..., 3] - q[..., 1] + eps)
    out = inter / (area_b + area_q - inter)
    return torch.where((iw > 0) & (ih > 0), out, 0.0)


def box5_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """``[..., 5]`` (x, y, w, l, yaw) → ``[..., 4, 2]`` corners, clockwise
    from the minimum corner before rotation. The rotation is the row
    vector product ``p @ [[c, -s], [s, c]]``, written out so that every
    product and sum is rounded on its own."""
    x, y, w, l, r = boxes.unbind(-1)
    c, s = torch.cos(r), torch.sin(r)
    hw, hl = w / 2, l / 2
    rel_x = torch.stack([-hw, -hw, hw, hw], dim=-1)
    rel_y = torch.stack([-hl, hl, hl, -hl], dim=-1)
    c, s = c[..., None], s[..., None]
    rot_x = rel_x * c + rel_y * s
    rot_y = rel_x * -s + rel_y * c
    return torch.stack([rot_x + x[..., None], rot_y + y[..., None]], dim=-1)


def _fill_invalid_with_left(vx, vy, m, slots: int):
    """Replace invalid ring slots with the nearest valid slot to the left
    (cyclically): a doubling scan of rolls and selects."""
    k = 1
    while k < slots:
        take = ~m
        vx = torch.where(take, torch.roll(vx, k, dims=-1), vx)
        vy = torch.where(take, torch.roll(vy, k, dims=-1), vy)
        m = m | torch.roll(m, k, dims=-1)
        k *= 2
    return vx, vy, m


def _clip_halfplane(vx, vy, ax, ay, dx, dy, orient):
    """One Sutherland–Hodgman clip of the ring ``[..., S]`` against the
    halfplane on side ``orient`` of the edge ``(ax, ay) + t(dx, dy)``.
    Slot 2i keeps vertex i when inside, slot 2i+1 the intersection when
    edge (i, i+1) crosses → ``[..., 2S]``."""
    cr = (dx * (vy - ay) - dy * (vx - ax)) * orient
    inside = cr >= 0
    nvx = torch.roll(vx, -1, dims=-1)
    nvy = torch.roll(vy, -1, dims=-1)
    ncr = torch.roll(cr, -1, dims=-1)
    ninside = torch.roll(inside, -1, dims=-1)
    denom = cr - ncr
    t = cr / torch.where(denom == 0, 1.0, denom)
    ix = vx + t * (nvx - vx)
    iy = vy + t * (nvy - vy)
    crossing = (inside != ninside) & (denom != 0)
    s2 = vx.shape[-1] * 2
    shape = (*vx.shape[:-1], s2)
    return (torch.stack([vx, ix], dim=-1).reshape(shape),
            torch.stack([vy, iy], dim=-1).reshape(shape),
            torch.stack([inside, crossing], dim=-1).reshape(shape))


def rotated_intersection_area(ca: torch.Tensor,
                              cb: torch.Tensor) -> torch.Tensor:
    """Intersection area of two convex quads given as corners ``[..., 4,
    2]`` (broadcast): quad A clipped by quad B's four halfplanes."""
    batch = torch.broadcast_shapes(ca.shape[:-2], cb.shape[:-2])
    ca = ca.expand(*batch, 4, 2)
    cb = cb.expand(*batch, 4, 2)
    bx, by = cb[..., 0], cb[..., 1]
    nbx = torch.roll(bx, -1, dims=-1)
    nby = torch.roll(by, -1, dims=-1)
    # clip winding: the sign of B's shoelace, per pair
    orient = torch.sign(torch.sum(bx * nby - nbx * by, dim=-1))[..., None]

    vx, vy = ca[..., 0], ca[..., 1]
    m = torch.ones(vx.shape, dtype=torch.bool, device=vx.device)
    slots = 4
    for e in range(4):
        ax = cb[..., e, 0][..., None]
        ay = cb[..., e, 1][..., None]
        dx = cb[..., (e + 1) % 4, 0][..., None] - ax
        dy = cb[..., (e + 1) % 4, 1][..., None] - ay
        vx, vy, m = _fill_invalid_with_left(vx, vy, m, slots)
        any_valid = m[..., :1]  # all-true after the fill iff nonempty
        vx, vy, m = _clip_halfplane(vx, vy, ax, ay, dx, dy, orient)
        m = m & any_valid
        slots *= 2
    vx, vy, m = _fill_invalid_with_left(vx, vy, m, slots)
    nvx = torch.roll(vx, -1, dims=-1)
    nvy = torch.roll(vy, -1, dims=-1)
    area2 = torch.sum(vx * nvy - nvx * vy, dim=-1)
    return torch.where(m[..., 0], 0.5 * torch.abs(area2), 0.0)


def rotate_iou(rbboxes: torch.Tensor, qrbboxes: torch.Tensor,
               criterion: int = -1) -> torch.Tensor:
    """Exact rotated BEV IoU ``[..., N, K]`` for ``[..., N, 5]`` and
    ``[..., K, 5]`` (x, y, w, l, yaw) boxes: entry ``[i, j]`` clips box i
    by box j. ``criterion``: -1 IoU, 0 inter / area of ``rbboxes``, 1
    inter / area of ``qrbboxes``, else the raw intersection area."""
    ca = box5_to_corners(rbboxes)
    cb = box5_to_corners(qrbboxes)
    inter = rotated_intersection_area(ca[..., :, None, :, :],
                                      cb[..., None, :, :, :])
    area_a = (rbboxes[..., 2] * rbboxes[..., 3])[..., :, None]
    area_b = (qrbboxes[..., 2] * qrbboxes[..., 3])[..., None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = area_a.expand_as(inter)
    elif criterion == 1:
        denom = area_b.expand_as(inter)
    else:
        denom = torch.ones_like(inter)
    return torch.where(denom > 0, inter / denom, 0.0)
