"""The SECOND 7-dof box decoder in torch (counterpart of
``papc_tpu/detect/box_coder.py::GroundBox3dCoder.decode_jnp``)."""

from __future__ import annotations

import torch


class GroundBox3dCoder:
    """7-dof SECOND encoding; code_size 7 (or 8 with the angle vector)."""

    def __init__(self, linear_dim=False, vec_encode=False):
        self.linear_dim = linear_dim
        self.vec_encode = vec_encode

    @property
    def code_size(self) -> int:
        return 8 if self.vec_encode else 7

    def decode(self, encodings: torch.Tensor,
               anchors: torch.Tensor) -> torch.Tensor:
        """``encodings [..., code_size]`` relative to ``anchors [..., 7]``
        → boxes ``[..., 7]``, op for op as ``decode_jnp``."""
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
