"""ResNet bottleneck trunk (classic stem) for the clip detector.

Port of the serving configuration of
:class:`tao_amodal_tpu.models.backbones.ResNet`: ``ConvBN``,
``Bottleneck`` and ``ResNet`` with the ``classic`` stem and
``out_stages=(2, 3, 4)``.  Submodules carry the Flax auto-names
(``ConvBN_i``, ``Bottleneck_i``, ``Conv_0``, ``BatchNorm_0``) so the
weight bridge maps parameter paths one to one.

Tensors are NCHW inside the trunk (PyTorch's convolution layout); the
detector hands in an NHWC clip as a permuted view.  Padding follows the
JAX modules exactly: symmetric ``(k-1)//2 * dilation`` for every
``ConvBN``, stride on the bottleneck's 3x3, and a 3x3/2 max-pool padded
with -inf after the 7x7/2 stem conv.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class ConvBN(nn.Module):
    """Conv (no bias) + inference BatchNorm (eps 1e-5) + optional ReLU."""

    def __init__(self, in_features, features, kernel=3, strides=1,
                 dilation=1, use_relu=True):
        super().__init__()
        pad = (kernel - 1) // 2 * dilation
        self.Conv_0 = nn.Conv2d(in_features, features, kernel,
                                stride=strides, padding=pad,
                                dilation=dilation, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5)
        self.use_relu = use_relu

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.use_relu else x


class Bottleneck(nn.Module):
    def __init__(self, in_features, features, strides=1, downsample=False):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_features, features, 1)
        self.ConvBN_1 = ConvBN(features, features, 3, strides=strides)
        self.ConvBN_2 = ConvBN(features, features * 4, 1, use_relu=False)
        if downsample:
            self.ConvBN_3 = ConvBN(in_features, features * 4, 1,
                                   strides=strides, use_relu=False)
        self.downsample = downsample

    def forward(self, x):
        out = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        residual = self.ConvBN_3(x) if self.downsample else x
        return F.relu(out + residual)


class ResNet(nn.Module):
    """Bottleneck ResNet; returns the outputs of ``out_stages``
    (1-indexed conv2..conv5), NCHW."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), out_stages=(2, 3, 4),
                 strides=(1, 2, 2, 2)):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 64, 7, strides=2)
        self.out_stages = tuple(out_stages)
        self.stage_sizes = tuple(stage_sizes)
        in_f, features, block = 64, 64, 0
        for stage, blocks in enumerate(stage_sizes):
            for i in range(blocks):
                self.add_module(f"Bottleneck_{block}", Bottleneck(
                    in_f, features,
                    strides=strides[stage] if i == 0 else 1,
                    downsample=(i == 0)))
                in_f = features * 4
                block += 1
            features *= 2

    def out_channels(self):
        return [64 * 2 ** (s - 1) * 4 for s in self.out_stages]

    def forward(self, x):
        x = self.ConvBN_0(x)
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        outputs, block = [], 0
        for stage, blocks in enumerate(self.stage_sizes):
            for _ in range(blocks):
                x = getattr(self, f"Bottleneck_{block}")(x)
                block += 1
            if (stage + 1) in self.out_stages:
                outputs.append(x)
        return outputs
