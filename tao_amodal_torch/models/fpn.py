"""Feature Pyramid Network (top-down, lateral 1x1s, output 3x3s).

Port of :class:`tao_amodal_tpu.models.fpn.FPN` with NCHW tensors:
``lateral_i`` 1x1 convs, integer-factor nearest upsampling done as a
broadcast, ``post_i`` 3x3 SAME convs (padding 1), and ``extra_j``
stride-2 3x3 convs with explicit (1, 1) padding for the P6/P7 levels,
computed in ``dtype`` (the upsample-adds too).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tao_amodal_torch.models import layers


def upsample_nearest(lo, hw):
    """Nearest upsampling of ``lo [B, C, h, w]`` to ``hw``: an
    integer-factor broadcast where the factor is exact, else half-pixel
    nearest (``jax.image.resize(method='nearest')``)."""
    B, C, h, w = lo.shape
    fy, fx = hw[0] // h, hw[1] // w
    if (h * fy, w * fx) == tuple(hw):
        return lo[:, :, :, None, :, None].expand(
            B, C, h, fy, w, fx).reshape(B, C, h * fy, w * fx)
    return F.interpolate(lo, size=tuple(hw), mode="nearest-exact")


class FPN(nn.Module):
    def __init__(self, in_channels, features=256, num_extra_levels=1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_levels = len(in_channels)
        self.num_extra_levels = num_extra_levels
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", nn.Conv2d(c, features, 1))
            self.add_module(f"post_{i}",
                            nn.Conv2d(features, features, 3, padding=1))
        for j in range(num_extra_levels):
            self.add_module(f"extra_{j}", nn.Conv2d(
                features, features, 3, stride=2, padding=1))

    def forward(self, inputs):
        dt = self.dtype
        laterals = [layers.conv(x, getattr(self, f"lateral_{i}"), dt)
                    for i, x in enumerate(inputs)]
        for i in range(len(laterals) - 2, -1, -1):
            hi = laterals[i]
            laterals[i] = hi + upsample_nearest(laterals[i + 1],
                                                hi.shape[-2:])
        outs = [layers.conv(x, getattr(self, f"post_{i}"), dt)
                for i, x in enumerate(laterals)]
        x = outs[-1]
        for j in range(self.num_extra_levels):
            x = layers.conv(x, getattr(self, f"extra_{j}"), dt)
            outs.append(x)
        return outs
