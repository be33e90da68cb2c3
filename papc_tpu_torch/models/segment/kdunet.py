"""KD-UNet part segmentation: a kd-tree encoder and a transposed-conv
decoder (counterpart of ``papc_tpu/models/segment/kdunet.py``).

Five ``KDConv`` levels with BN (widths 32, 64, 256, 512, 1024), each
halving the points and keeping its input as a shortcut; then five
``ConvTranspose(k=2, s=2)`` levels over the point axis, each doubling
it, concatenated with the matching shortcut and followed by a double
``PointMLP`` (the last by ``PointMLP((128,))`` and a Dense to the parts).

flax's ``ConvTranspose`` kernel ``[2, in, out]`` applies mirrored
(``lax.conv_transpose``): ``out[2i + p] = x[i] · kernel[1 - p]``. The
port's ``ConvTranspose1d`` holds ``weight[c, o, p] = kernel[1 - p, c,
o]`` (``convert.py``). Its cuDNN convolutions run in float32, forward
and backward (``nn.layers.conv``).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from papc_tpu_torch.models.classify.kdnet import KDConv
from papc_tpu_torch.nn import PointMLP
from papc_tpu_torch.nn.layers import conv, dense, init_params

KDUNET_WIDTHS = (32, 64, 256, 512, 1024)
DECONV_CH = (512, 512, 256, 256, 128)
DOUBLE_CH = ((512, 512), (512, 512), (256, 256), (128, 128), (128,))


def _deconv(x, w):
    return F.conv_transpose1d(x, w, stride=2)


class KDUNet(nn.Module):
    mode = "seg"
    input_kind = "kd"

    def __init__(self, num_classes: int = 50,
                 generator: torch.Generator | None = None):
        """``num_classes``: the number of parts, as in JAX."""
        super().__init__()
        self.num_parts = num_classes
        cins = (3,) + KDUNET_WIDTHS[:-1]
        for level, (cin, width) in enumerate(zip(cins, KDUNET_WIDTHS)):
            self.add_module(f"KDConv_{level}", KDConv(cin, width, use_bn=True))
        c = KDUNET_WIDTHS[-1]
        for i, (dc, dbl) in enumerate(zip(DECONV_CH, DOUBLE_CH)):
            self.add_module(f"ConvTranspose_{i}", nn.ConvTranspose1d(
                c, dc, 2, stride=2))
            self.add_module(f"PointMLP_{i}",
                            PointMLP(dc + cins[-(i + 1)], dbl))
            c = dbl[-1]
        self.Dense_0 = nn.Linear(c, num_classes)
        if generator is not None:
            init_params(self, generator)

    def forward(self, points: torch.Tensor, split_dims: Sequence[torch.Tensor],
                impl: str | None = None, *,
                generator: torch.Generator | None = None,
                dropout_masks=None) -> torch.Tensor:
        """``points [B, N, 3]`` leaf-ordered (N at least 32),
        ``split_dims``: at least 5 tensors, level l ``[B, N >> l]`` →
        per-point logits ``[B, N, parts]``. ``impl`` and the dropout
        arguments as for ``KDNet.forward``."""
        x, shortcuts = points, []
        for level in range(len(KDUNET_WIDTHS)):
            shortcuts.append(x)
            x = getattr(self, f"KDConv_{level}")(x, split_dims[level])
        for i in range(len(DECONV_CH)):
            up = getattr(self, f"ConvTranspose_{i}")
            x = conv(up, x.transpose(1, 2), _deconv).transpose(1, 2)
            skip = shortcuts[-(i + 1)]
            x = torch.cat([x, skip], dim=-1)
            x = getattr(self, f"PointMLP_{i}")(x)
        return dense(self.Dense_0, x)
