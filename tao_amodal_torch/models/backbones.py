"""ResNet bottleneck trunk for the clip detector.

Port of the serving configuration of
:class:`tao_amodal_tpu.models.backbones.ResNet`: ``ConvBN``,
``Bottleneck`` and ``ResNet`` with the ``classic``, ``s2d`` and
``s2d_pre`` stems, ``out_stages=(2, 3, 4)``, optional ``fused_stages``,
in f32 or bf16 (``dtype``: the JAX modules' rounding points, see
:mod:`tao_amodal_torch.models.layers`; the parameters stay f32), and
with ``int8=True`` the JAX package's int8 trunk: every ``ConvBN``
quantizes its input and its ``qkernel`` and convolves in int8
(:mod:`tao_amodal_torch.ops.int8_conv`), then BatchNorm as before.
Submodules carry the Flax auto-names (``ConvBN_i``, ``Bottleneck_i``,
``Conv_0``, ``BatchNorm_0``) so the weight bridge maps parameter paths
one to one.

Tensors are NCHW inside the trunk (PyTorch's convolution layout); the
detector hands in an NHWC clip as a permuted view, so the trunk's
memory is channels-last and a fused stage reads the NHWC view of its
input in place.  Padding follows the JAX modules exactly: symmetric
``(k-1)//2 * dilation`` for every ``ConvBN``, stride on the
bottleneck's 3x3, and a 3x3/2 max-pool padded with -inf after the 7x7/2
stem conv.  The s2d stems (all three land at stride 4, 64 channels) fold
each 4x4 pixel block into 48 channels (:func:`space_to_depth`; the
``s2d_pre`` stem takes the clip already folded, as
``ops/preproc.py::preprocess_clip_s2d`` makes it) and run one 3x3
``ConvBN`` from 48 to 64 channels, with no max-pool.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tao_amodal_torch.models import layers
from tao_amodal_torch.ops import int8_conv
from tao_amodal_torch.ops.fused_stage import (
    fold_convbn,
    fused_bottleneck_chain,
)
from tao_amodal_torch.ops.preproc import space_to_depth
from tao_amodal_torch.utils.weights import derived

STEMS = ("classic", "s2d", "s2d_pre")


class ConvBN(nn.Module):
    """Conv (no bias) + inference BatchNorm (eps 1e-5) + optional ReLU,
    computed in ``dtype``.

    ``int8=True`` is JAX's int8 inference mode (``_int8_conv``): no
    ``Conv_0``, but an f32 ``qkernel`` in HWIO, as the Flax module holds
    it, quantized per output channel once per load (:meth:`quantized`);
    the input is quantized with one scale for the whole batch
    (``act_scale``, a static calibrated scale, or the abs-max), the conv
    sums in int32 and is dequantized to ``dtype`` before BatchNorm.
    """

    def __init__(self, in_features, features, kernel=3, strides=1,
                 dilation=1, use_relu=True, dtype=torch.float32, int8=False,
                 act_scale=None):
        super().__init__()
        pad = (kernel - 1) // 2 * dilation
        if int8:
            if dilation != 1:
                raise ValueError("the int8 ConvBN takes no dilation")
            self.qkernel = nn.Parameter(torch.empty(
                kernel, kernel, in_features, features))
            self.strides, self.pad = strides, pad
        else:
            self.Conv_0 = nn.Conv2d(in_features, features, kernel,
                                    stride=strides, padding=pad,
                                    dilation=dilation, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5)
        self.use_relu = use_relu
        self.dtype = dtype
        self.int8 = int8
        self.act_scale = act_scale

    def quantized(self):
        """``(w8, s_w)`` of ``qkernel`` (:func:`~tao_amodal_torch.ops.
        int8_conv.quantize_weight`), once per load (:func:`~tao_amodal_
        torch.utils.weights.derived`)."""
        return derived(self.qkernel, "int8", int8_conv.quantize_weight)

    def quantize_input(self, x):
        """``(x8, s_x)``: NCHW ``x`` quantized as :meth:`_int8_conv`
        quantizes it, for a caller that feeds one input to two convs."""
        return int8_conv.quantize_activation_s8(x, self.act_scale)

    def _int8_conv(self, x, xq=None):
        """JAX's ``_int8_conv`` on NCHW ``x``: NCHW out in ``dtype``;
        ``xq``, where given, is :meth:`quantize_input` of ``x``."""
        w8, s_w = self.quantized()
        return int8_conv.quantized_conv(x, w8, s_w, self.strides, self.pad,
                                        self.dtype, self.act_scale, xq)

    def forward(self, x, xq=None):
        x = (self._int8_conv(x, xq) if self.int8
             else layers.conv(x, self.Conv_0, self.dtype))
        x = layers.batch_norm(x, self.BatchNorm_0, self.dtype)
        return F.relu(x) if self.use_relu else x

    def folded(self):
        """``(OIHW weight, bias)`` with the inference BN folded in."""
        bn = self.BatchNorm_0
        return fold_convbn(self.Conv_0.weight, bn.weight, bn.bias,
                           bn.running_mean, bn.running_var, bn.eps)


class Bottleneck(nn.Module):
    def __init__(self, in_features, features, strides=1, downsample=False,
                 dtype=torch.float32, int8=False):
        super().__init__()
        kw = dict(dtype=dtype, int8=int8)
        self.ConvBN_0 = ConvBN(in_features, features, 1, **kw)
        self.ConvBN_1 = ConvBN(features, features, 3, strides=strides, **kw)
        self.ConvBN_2 = ConvBN(features, features * 4, 1, use_relu=False,
                               **kw)
        if downsample:
            self.ConvBN_3 = ConvBN(in_features, features * 4, 1,
                                   strides=strides, use_relu=False, **kw)
        self.downsample = downsample

    def forward(self, x):
        # In int8 the first conv and the projection quantize the same x:
        # once, where their scales agree (under jit, XLA's CSE can merge
        # the pair that JAX's block writes twice).
        first = self.ConvBN_0
        proj = self.ConvBN_3 if self.downsample else None
        xq = (first.quantize_input(x)
              if proj is not None and first.int8 and proj.int8
              and first.act_scale == proj.act_scale else None)
        out = self.ConvBN_2(self.ConvBN_1(first(x, xq)))
        residual = proj(x, xq) if proj is not None else x
        return F.relu(out + residual)


class ResNet(nn.Module):
    """Bottleneck ResNet; returns the outputs of ``out_stages``
    (1-indexed conv2..conv5), NCHW.

    ``fused_stages`` (1-indexed) run their stride-1 bottleneck chain
    through :func:`fused_bottleneck_chain` with BN folded, at inference
    only (never in training mode).  A stage fuses when its chain has at
    least 2 blocks: stage 1 (stride 1) fuses whole, its block 0 carrying
    the projection; the strided first block of stages 2-4 runs unfused
    ahead of the fused tail.  The port's trunk has no dilation, so the
    JAX condition ``dilation == 1`` always holds.  The folded f32
    parameters of a fused stage are computed once per load (the chain
    rounds them to the activations' dtype), and recomputed when a
    parameter changes.  ``int8=True`` builds JAX's int8 trunk (every
    ``ConvBN`` in int8 mode) and ignores ``fused_stages``, as JAX's
    ``not self.int8`` does.
    """

    def __init__(self, stage_sizes=(3, 4, 6, 3), out_stages=(2, 3, 4),
                 strides=(1, 2, 2, 2), fused_stages=(), stem="classic",
                 dtype=torch.float32, int8=False):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown stem: {stem!r}")
        self.stem = stem
        self.dtype = dtype
        self.int8 = int8
        if stem == "classic":
            self.ConvBN_0 = ConvBN(3, 64, 7, strides=2, dtype=dtype,
                                   int8=int8)
        else:
            self.ConvBN_0 = ConvBN(48, 64, 3, dtype=dtype, int8=int8)
        self.out_stages = tuple(out_stages)
        self.stage_sizes = tuple(stage_sizes)
        self.strides = tuple(strides)
        self.fused_stages = tuple(fused_stages)
        self._folded = {}
        in_f, features, block = 64, 64, 0
        for stage, blocks in enumerate(stage_sizes):
            for i in range(blocks):
                self.add_module(f"Bottleneck_{block}", Bottleneck(
                    in_f, features,
                    strides=strides[stage] if i == 0 else 1,
                    downsample=(i == 0), dtype=dtype, int8=int8))
                in_f = features * 4
                block += 1
            features *= 2

    def out_channels(self):
        return [64 * 2 ** (s - 1) * 4 for s in self.out_stages]

    def _folded_block_params(self, block, has_ds):
        """Inference-folded (conv+BN -> conv+bias) params of one
        ``Bottleneck`` for the fused chain."""
        m = getattr(self, f"Bottleneck_{block}")
        p = {}
        for key, cb in (("a", m.ConvBN_0), ("3", m.ConvBN_1),
                        ("b", m.ConvBN_2)):
            p[f"w{key}"], p[f"b{key}"] = cb.folded()
        if has_ds:
            p["wd"], p["bd"] = m.ConvBN_3.folded()
        return p

    def _fused_params(self, first, start, blocks):
        """The folded params of blocks ``first + start .. first + blocks
        - 1`` (block ``first`` carries the projection when ``start`` is
        0), cached until one of their tensors changes."""
        mods = [getattr(self, f"Bottleneck_{first + i}")
                for i in range(start, blocks)]
        key = tuple((t._version, t.device, t.data_ptr()) for m in mods
                    for t in (*m.parameters(), *m.buffers()))
        hit = self._folded.get(first)
        if hit is None or hit[0] != key:
            hit = (key, [self._folded_block_params(
                first + i, has_ds=(i == 0 and start == 0))
                for i in range(start, blocks)])
            self._folded[first] = hit
        return hit[1]

    def forward(self, x):
        if self.stem == "s2d":
            x = space_to_depth(x.permute(0, 2, 3, 1), 4).permute(0, 3, 1, 2)
        x = self.ConvBN_0(x)
        if self.stem == "classic":
            x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        outputs, block = [], 0
        for stage, blocks in enumerate(self.stage_sizes):
            # The fused chain is stride 1; a strided first block runs
            # unfused ahead of it.
            start = 0 if self.strides[stage] == 1 else 1
            if ((stage + 1) in self.fused_stages and not self.training
                    and not self.int8 and blocks - start >= 2):
                for i in range(start):
                    x = getattr(self, f"Bottleneck_{block + i}")(x)
                params = self._fused_params(block, start, blocks)
                x = fused_bottleneck_chain(
                    x.permute(0, 2, 3, 1).to(self.dtype),
                    params).permute(0, 3, 1, 2)
            else:
                for i in range(blocks):
                    x = getattr(self, f"Bottleneck_{block + i}")(x)
            block += blocks
            if (stage + 1) in self.out_stages:
                outputs.append(x)
        return outputs
