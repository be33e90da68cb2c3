"""Box coders (counterpart of ``papc_tpu/detect/box_coder.py``):
``encode`` in numpy on the host (target assignment), ``decode`` in torch
on the device (prediction), op for op as JAX's ``encode`` and
``decode_jnp``."""

from __future__ import annotations

import numpy as np
import torch

from papc_tpu_torch.detect import box_np


class GroundBox3dCoder:
    """7-dof SECOND encoding; code_size 7 (or 8 with the angle vector)."""

    def __init__(self, linear_dim=False, vec_encode=False):
        self.linear_dim = linear_dim
        self.vec_encode = vec_encode

    @property
    def code_size(self) -> int:
        return 8 if self.vec_encode else 7

    def encode(self, boxes: np.ndarray, anchors: np.ndarray) -> np.ndarray:
        """``boxes [..., 7]`` relative to ``anchors [..., 7]`` → codes
        ``[..., code_size]`` (numpy)."""
        return box_np.second_box_encode(boxes, anchors, self.vec_encode,
                                        self.linear_dim)

    def decode(self, encodings: torch.Tensor,
               anchors: torch.Tensor) -> torch.Tensor:
        """``encodings [..., code_size]`` relative to ``anchors [..., 7]``
        → boxes ``[..., 7]``."""
        xa, ya, za, wa, la, ha, ra = torch.split(anchors, 1, dim=-1)
        if self.vec_encode:
            xt, yt, zt, wt, lt, ht, rtx, rty = torch.split(encodings, 1, -1)
        else:
            xt, yt, zt, wt, lt, ht, rt = torch.split(encodings, 1, dim=-1)
        za = za + ha / 2
        diagonal = torch.sqrt(la**2 + wa**2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * ha + za
        if self.linear_dim:
            lg, wg, hg = (lt + 1) * la, (wt + 1) * wa, (ht + 1) * ha
        else:
            lg = torch.exp(lt) * la
            wg = torch.exp(wt) * wa
            hg = torch.exp(ht) * ha
        if self.vec_encode:
            rg = torch.atan2(rty + torch.sin(ra), rtx + torch.cos(ra))
        else:
            rg = rt + ra
        zg = zg - hg / 2
        return torch.cat([xg, yg, zg, wg, lg, hg, rg], dim=-1)


class BevBoxCoder:
    """5-dof BEV encoding over (x, y, w, l, yaw); code_size 5 (or 6 with
    the angle vector). ``decode`` gives 7-dof boxes with the fixed
    ``z_fixed`` and ``h_fixed``."""

    def __init__(self, linear_dim=False, vec_encode=False, z_fixed=-1.0,
                 h_fixed=2.0):
        self.linear_dim = linear_dim
        self.vec_encode = vec_encode
        self.z_fixed = z_fixed
        self.h_fixed = h_fixed

    @property
    def code_size(self) -> int:
        return 6 if self.vec_encode else 5

    def encode(self, boxes: np.ndarray, anchors: np.ndarray) -> np.ndarray:
        return box_np.bev_box_encode(boxes[..., [0, 1, 3, 4, 6]],
                                     anchors[..., [0, 1, 3, 4, 6]],
                                     self.vec_encode, self.linear_dim)

    def decode(self, encodings: torch.Tensor,
               anchors: torch.Tensor) -> torch.Tensor:
        """``encodings [..., code_size]`` relative to ``anchors [..., 7]``
        → boxes ``[..., 7]`` at ``z_fixed`` with height ``h_fixed``."""
        xa, ya, _, wa, la, _, ra = torch.split(anchors, 1, dim=-1)
        if self.vec_encode:
            xt, yt, wt, lt, rtx, rty = torch.split(encodings, 1, dim=-1)
        else:
            xt, yt, wt, lt, rt = torch.split(encodings, 1, dim=-1)
        diagonal = torch.sqrt(la**2 + wa**2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        if self.linear_dim:
            lg, wg = (lt + 1) * la, (wt + 1) * wa
        else:
            lg, wg = torch.exp(lt) * la, torch.exp(wt) * wa
        if self.vec_encode:
            rg = torch.atan2(rty + torch.sin(ra), rtx + torch.cos(ra))
        else:
            rg = rt + ra
        z = torch.full_like(xg, self.z_fixed)
        h = torch.full_like(xg, self.h_fixed)
        return torch.cat([xg, yg, z, wg, lg, h, rg], dim=-1)
