"""Siamese RPN tracker model (SiamRPN++ and SiamMask).

Port of ``tao_amodal_tpu/models/siamese.py``: an atrous ResNet-50
(stages 2-4 at stride 8, :func:`~tao_amodal_torch.models.backbones.
resnet50`), one ``AdjustLayer`` neck a level (1x1 conv + BN, the
template's map cropped to its central 7x7), one depthwise-correlation
RPN head a level (cls and loc towers, ``xcorr_depthwise``, 1x1 heads),
the levels fused by softmax weights (``cls_weight``/``loc_weight``), and
optionally SiamMask's mask head (depthwise correlation of the last level
-> 63x63 mask logits a location) and refine head (the mask embedding at
one location upsampled 1 -> 4 -> 16 -> 64 -> 128 through 3x3 convs, then
JAX's antialiased linear resize to 127).

Submodules carry the Flax auto-names (``backbone``, ``necks_i``,
``heads_i`` with ``z_cls_conv``/``z_cls_bn``/.../``cls_out``,
``mask_head.Conv_0/1``, ``refine_head.Conv_0..4``), so the weight bridge
(:func:`tao_amodal_torch.utils.weights.load_variables`) maps the JAX
variables one to one.  Inputs and outputs are NHWC, as JAX's are; the
modules compute in NCHW on permuted views, with TF32 off (f32 parity
with JAX, as the detector runs).  BatchNorm uses the running
statistics, in training too (JAX's trainer applies ``mode="train"``,
which leaves ``train=False``; its ``train=True``, batch statistics, only
runs in ``full_init``, to initialize, and is not ported).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tao_amodal_torch.models import layers
from tao_amodal_torch.models.backbones import resnet50
from tao_amodal_torch.models.detector import ALLOW_TF32, _tf32
from tao_amodal_torch.ops.resize import linear_resize_weights
from tao_amodal_torch.ops.xcorr import xcorr_depthwise

f32 = torch.float32
MODES = ("template", "track", "train")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _center_crop(x, size):
    """The central ``size`` x ``size`` of an NCHW map larger than it."""
    h = x.shape[2]
    if h <= size:
        return x
    lo = (h - size) // 2
    return x[:, :, lo:lo + size, lo:lo + size]


def _conv_bn(conv, bn, x, dtype):
    return layers.batch_norm(layers.conv(x, conv, dtype), bn, dtype)


class AdjustLayer(nn.Module):
    """1x1 conv + BN channel adapter; ``crop=True`` (the template
    branch) keeps the central ``crop_size`` x ``crop_size``."""

    def __init__(self, in_features, features=256, crop_size=7, dtype=f32):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5)
        self.crop_size = crop_size
        self.dtype = dtype

    def forward(self, x, crop=False):
        x = _conv_bn(self.Conv_0, self.BatchNorm_0, x, self.dtype)
        return _center_crop(x, self.crop_size) if crop else x


class DepthwiseRPNHead(nn.Module):
    """cls + loc over a depthwise correlation map: 3x3 VALID towers embed
    template and search, ``xcorr_depthwise`` joins them, a 1x1 head
    predicts ``2A`` scores and ``4A`` box deltas a location.  A template
    of batch 1 serves every search map (its towers run once)."""

    def __init__(self, anchor_num=5, features=256, dtype=f32):
        super().__init__()
        for name in ("z_cls", "x_cls", "z_loc", "x_loc"):
            self.add_module(f"{name}_conv", nn.Conv2d(
                features, features, 3, bias=False))
            self.add_module(f"{name}_bn", nn.BatchNorm2d(features, eps=1e-5))
        for name, out_ch in (("cls", 2 * anchor_num), ("loc", 4 * anchor_num)):
            self.add_module(f"{name}_conv1", nn.Conv2d(
                features, features, 1, bias=False))
            self.add_module(f"{name}_bn", nn.BatchNorm2d(features, eps=1e-5))
            self.add_module(f"{name}_out", nn.Conv2d(features, out_ch, 1))
        self.dtype = dtype

    def _tower(self, x, name):
        return F.relu(_conv_bn(getattr(self, f"{name}_conv"),
                               getattr(self, f"{name}_bn"), x, self.dtype))

    def _head(self, x, name):
        x = F.relu(_conv_bn(getattr(self, f"{name}_conv1"),
                            getattr(self, f"{name}_bn"), x, self.dtype))
        return layers.conv(x, getattr(self, f"{name}_out"), self.dtype)

    def forward(self, zf, xf):
        cls = self._head(xcorr_depthwise(self._tower(xf, "x_cls"),
                                         self._tower(zf, "z_cls")), "cls")
        loc = self._head(xcorr_depthwise(self._tower(xf, "x_loc"),
                                         self._tower(zf, "z_loc")), "loc")
        return cls, loc


class MaskHead(nn.Module):
    """SiamMask's mask head: depthwise correlation -> 1x1 conv + ReLU ->
    ``mask_size**2`` mask logits a location; returns (mask, corr)."""

    def __init__(self, mask_size=63, features=256, dtype=f32):
        super().__init__()
        self.Conv_0 = nn.Conv2d(features, features, 1)
        self.Conv_1 = nn.Conv2d(features, mask_size * mask_size, 1)
        self.dtype = dtype

    def forward(self, zf, xf):
        corr = xcorr_depthwise(xf, zf)
        x = F.relu(layers.conv(corr, self.Conv_0, self.dtype))
        return layers.conv(x, self.Conv_1, self.dtype), corr


class RefineHead(nn.Module):
    """SiamMask's refine module: the correlation feature at one location
    upsampled (nearest, JAX's ``jax.image.resize`` at integer factors)
    through 3x3 SAME convs, halving the width each time (at least 16),
    to ``out_size + 1``, then one 3x3 conv to a logit map resized to
    ``out_size`` by JAX's antialiased linear resize (a matrix product a
    axis, :func:`~tao_amodal_torch.ops.resize.linear_resize_weights`)."""

    def __init__(self, in_features=256, out_size=127, dtype=f32):
        super().__init__()
        self.sizes = []
        size, feats, i = 1, in_features, 0
        while size < out_size:
            size = min(size * 4, out_size + 1)
            new = max(feats // 2, 16)
            self.add_module(f"Conv_{i}", nn.Conv2d(feats, new, 3, padding=1))
            self.sizes.append(size)
            feats, i = new, i + 1
        self.add_module(f"Conv_{i}", nn.Conv2d(feats, 1, 3, padding=1))
        self.out_size = out_size
        self.dtype = dtype
        w = torch.from_numpy(linear_resize_weights(size, out_size))
        self.register_buffer("resize_w", w, persistent=False)

    def forward(self, corr, pos_yx):
        """``corr`` NHWC ``[B, H, W, C]``, ``pos_yx`` ``[B, 2]`` int ->
        ``[B, out, out]`` logits at each sample's position."""
        B, H, W, C = corr.shape
        idx = (pos_yx[:, 0] * W + pos_yx[:, 1]).long()
        flat = _nchw(corr).reshape(B, C, H * W)
        x = torch.gather(flat, 2, idx[:, None, None].expand(B, C, 1))
        x = x[..., None]                                  # [B, C, 1, 1]
        for i, size in enumerate(self.sizes):
            x = F.interpolate(x, size=(size, size), mode="nearest-exact")
            x = F.relu(layers.conv(x, getattr(self, f"Conv_{i}"),
                                   self.dtype))
        logits = layers.conv(x, getattr(self, f"Conv_{len(self.sizes)}"),
                             self.dtype)[:, 0].float()
        w = self.resize_w
        return torch.einsum("bHw,wW->bHW",
                            torch.einsum("bhw,hH->bHw", logits, w), w)


class SiameseTracker(nn.Module):
    """The whole Siamese model on ``device``; :meth:`forward` switches on
    ``mode`` as JAX's ``__call__`` does:

    * ``template``: template image -> the adjusted template features (a
      list of NHWC maps, one a level);
    * ``track``: (template features ``zf`` or a template image, search
      image) -> ``{"cls", "loc"}`` NHWC (+ ``"mask"``, ``"mask_corr"``
      with the mask head);
    * ``train``: (template batch, search batch) -> the same dict.

    :meth:`extract`, :meth:`fuse`, :meth:`refine` and :meth:`full_init`
    are JAX's methods of the same names.  Images are NHWC f32 ``[B, S,
    S, 3]`` on 0-255.
    """

    def __init__(self, anchor_num=5, features=256, num_levels=3,
                 with_mask=False, with_refine=False, mask_output_size=127,
                 dtype=f32, device="cuda"):
        super().__init__()
        self.backbone = resnet50(out_stages=(2, 3, 4), atrous=True,
                                 dtype=dtype, device="cpu")
        channels = self.backbone.out_channels()
        for i in range(num_levels):
            self.add_module(f"necks_{i}", AdjustLayer(
                channels[i], features, dtype=dtype))
            self.add_module(f"heads_{i}", DepthwiseRPNHead(
                anchor_num, features, dtype=dtype))
        self.cls_weight = nn.Parameter(torch.ones(num_levels))
        self.loc_weight = nn.Parameter(torch.ones(num_levels))
        if with_mask:
            self.mask_head = MaskHead(features=features, dtype=dtype)
        if with_refine:
            self.refine_head = RefineHead(features, mask_output_size,
                                          dtype=dtype)
        self.num_levels = num_levels
        self.with_mask = with_mask
        self.with_refine = with_refine
        self._response_sizes = {}
        self.to(device).eval()

    @property
    def device(self):
        return self.cls_weight.device

    def extract(self, img, is_template=False):
        """NHWC image -> the necks' NHWC maps (zipped with the backbone's
        levels, as JAX zips them)."""
        feats = self.backbone(_nchw(img))
        return [_nhwc(getattr(self, f"necks_{i}")(f, crop=is_template))
                for i, f in zip(range(self.num_levels), feats)]

    def fuse(self, outs, weights):
        w = torch.softmax(weights, 0)
        return sum(o * w[i] for i, o in enumerate(outs))

    def forward(self, template=None, search=None, zf=None, mode="track"):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        with _tf32(ALLOW_TF32):
            return self._forward(template, search, zf, mode)

    def _forward(self, template, search, zf, mode):
        if mode == "template":
            return self.extract(template, is_template=True)
        if zf is None:
            zf = self.extract(template, is_template=True)
        zf = [_nchw(z) for z in zf]
        xf = [_nchw(x) for x in self.extract(search)]
        cls_outs, loc_outs = [], []
        for i, (z, x) in enumerate(zip(zf, xf)):
            c, l = getattr(self, f"heads_{i}")(z, x)
            cls_outs.append(c)
            loc_outs.append(l)
        out = {"cls": _nhwc(self.fuse(cls_outs, self.cls_weight)),
               "loc": _nhwc(self.fuse(loc_outs, self.loc_weight))}
        if self.with_mask:
            mask, corr = self.mask_head(zf[-1], xf[-1])
            out["mask"] = _nhwc(mask)
            out["mask_corr"] = _nhwc(corr)
        return out

    def full_init(self, template, search):
        """The ``train`` outputs plus ``"refined"`` (the refine head at
        position (0, 0)), every submodule run (JAX's init helper)."""
        out = self(template=template, search=search, mode="train")
        if self.with_refine:
            pos = torch.zeros(out["mask_corr"].shape[0], 2,
                              dtype=torch.long, device=self.device)
            out["refined"] = self.refine(out["mask_corr"], pos)
        return out

    def refine(self, corr_feature, pos_yx):
        """Refined mask logits ``[B, out, out]`` at one response position
        a sample (``corr_feature`` NHWC, ``pos_yx`` ``[B, 2]``)."""
        with _tf32(ALLOW_TF32):
            return self.refine_head(corr_feature, pos_yx)

    @torch.no_grad()
    def response_size(self, exemplar_size, instance_size):
        """The side of the ``cls`` map for these crop sizes, from one
        forward of zeros (JAX takes it from ``jax.eval_shape``), kept per
        pair of sizes."""
        key = (exemplar_size, instance_size)
        if key not in self._response_sizes:
            def zeros(s):
                return torch.zeros(1, s, s, 3, device=self.device)

            out = self(template=zeros(exemplar_size),
                       search=zeros(instance_size), mode="track")
            self._response_sizes[key] = out["cls"].shape[1]
        return self._response_sizes[key]
