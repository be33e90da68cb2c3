"""Rotated boxes for the NMS tests, and a numpy model of the rotated mask
kernel's clip (no JAX: the card's tests import this too)."""

import numpy as np
import torch


def clustered_rboxes(seed, B, K):
    """Clustered rotated boxes [B, K, 5] (x, y, w, l, yaw), so that
    suppression happens (as the JAX package's Pallas NMS tests draw
    them)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(B):
        centers = rs.uniform(0, 40, size=(max(K // 4, 1), 2))
        pick = centers[rs.randint(0, len(centers), K)]
        out.append(np.stack([pick[:, 0] + rs.randn(K) * 0.8,
                             pick[:, 1] + rs.randn(K) * 0.8,
                             rs.uniform(1.5, 2.0, K), rs.uniform(3.5, 4.5, K),
                             rs.uniform(-np.pi, np.pi, K)], axis=1))
    return torch.from_numpy(np.stack(out).astype(np.float32))


DEGENERATE_GROUP = 8


def near_degenerate_rboxes(seed, B, K):
    """Groups of ``DEGENERATE_GROUP`` copies of one box turned by
    multiples of pi/2 (w and l swapped on the odd turns): each copy is the
    same quad up to the rounding of its sine and cosine, and the groups
    lie within 2 m of each other. Clipping one copy by another puts
    vertices within an ulp of the clip's lines, and now and then such a
    clip emits more than 8 vertices."""
    rs = np.random.RandomState(seed)
    g = DEGENERATE_GROUP
    n = -(-K // g)
    out = []
    for _ in range(B):
        base = np.stack([rs.uniform(0, 2, n), rs.uniform(0, 2, n),
                         rs.uniform(3, 4, n), rs.uniform(7, 9, n),
                         rs.uniform(-np.pi, np.pi, n)], axis=1)
        boxes = np.repeat(base, g, axis=0)[:K]
        turn = np.arange(K) % g - g // 2 + 1
        boxes[:, 4] += turn * np.pi / 2
        odd = turn % 2 == 1
        boxes[odd, 2], boxes[odd, 3] = boxes[odd, 3].copy(), boxes[odd, 2].copy()
        out.append(boxes)
    return torch.from_numpy(np.stack(out).astype(np.float32))


def clip_vertices(q, b) -> int:
    """The most vertices any of the four clips emits when quad ``q``
    (corners ``[4, 2]`` f32) is clipped by quad ``b``'s halfplanes, in
    the rotated mask kernel's arithmetic: each f32 operation rounded on
    its own, the winding from b's shoelace summed in order."""
    f = np.float32
    bx, by = [f(v) for v in b[:, 0]], [f(v) for v in b[:, 1]]
    s = f(0)
    for e in range(4):
        s = f(s + f(f(bx[e] * by[(e + 1) % 4]) - f(bx[(e + 1) % 4] * by[e])))
    orient = f(1) if s > 0 else (f(-1) if s < 0 else s)
    px, py = [f(v) for v in q[:, 0]], [f(v) for v in q[:, 1]]
    most = 4
    for e in range(4):
        if not px:
            break
        ax, ay = bx[e], by[e]
        dx, dy = f(bx[(e + 1) % 4] - ax), f(by[(e + 1) % 4] - ay)
        cr = [f(f(f(dx * f(vy - ay)) - f(dy * f(vx - ax))) * orient)
              for vx, vy in zip(px, py)]
        ox, oy = [], []
        n = len(px)
        for v in range(n):
            nv = (v + 1) % n
            c, nc = cr[v], cr[nv]
            if c >= 0:
                ox.append(px[v])
                oy.append(py[v])
            den = f(c - nc)
            if (c >= 0) != (nc >= 0) and den != 0:
                t = f(c / den)
                ox.append(f(px[v] + f(t * f(px[nv] - px[v]))))
                oy.append(f(py[v] + f(t * f(py[nv] - py[v]))))
        px, py = ox, oy
        most = max(most, len(px))
    return most
