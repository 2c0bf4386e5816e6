"""DiMP/ATOM model pieces: the online filter classifier and the IoUNet.

Port of ``tao_amodal_tpu/models/dimp.py`` (the reference's
``pytracking/tracker/dimp/dimp.py``): a correlation filter optimized
online for each sequence by Gauss-Newton/CG
(:func:`~tao_amodal_torch.ops.optimization.gauss_newton_cg`), and an
IoU predictor that refines the target box by gradient ascent on its
predicted IoU (``refine_target_box``).

The IoUNet pools with the plain PrRoI (:func:`tao_amodal_torch.ops.roi.
prroi_pool`, two einsums, differentiable in the boxes as JAX's is), not
through a PrRoI kernel: the ascent needs the gradient in the box, which
the kernels' wrappers refuse.  Pooled features are NHWC and flatten in
``(p, p, C)`` order, as JAX's do, so the weight bridge needs no
permutation.  Submodules carry the Flax names (``Conv_0``,
``BatchNorm_0``; ``Dense_0``, ``mod_proj``, ``Dense_1``, ``Dense_2``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tao_amodal_torch.models import layers
from tao_amodal_torch.ops.optimization import gauss_newton_cg
from tao_amodal_torch.ops.roi import prroi_pool
from tao_amodal_torch.ops.xcorr import xcorr_depthwise


class FilterClassifier(nn.Module):
    """Feature embedding for the online filter: a 3x3 conv (no bias),
    BatchNorm, ReLU, on NHWC ``[B, H, W, C]``.  ``train=True`` normalizes
    by the batch's statistics (Flax's ``use_running_average=False``)
    and leaves the running ones as they are."""

    def __init__(self, in_features, features=256, device="cuda"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, 3, padding=1,
                                bias=False, device=device)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5, device=device)

    def forward(self, x, train=False):
        x = self.Conv_0(x.permute(0, 3, 1, 2))
        bn = self.BatchNorm_0
        if train:
            x = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0,
                             bn.eps)
        else:
            x = layers.batch_norm(x, bn, torch.float32)
        return F.relu(x).permute(0, 2, 3, 1)


class IoUNet(nn.Module):
    """Predicted IoU of candidate boxes against the target, from
    PrRoI-pooled features modulated by a target vector (ATOM/DiMP's
    IoUNet).  ``channels`` is the feature map's C: both the pooled
    features and the modulation vector are ``pool_size ** 2 * C``
    long."""

    def __init__(self, channels, features=256, pool_size=5, device="cuda"):
        super().__init__()
        d = pool_size ** 2 * channels
        self.pool_size = pool_size
        self.Dense_0 = nn.Linear(d, features, device=device)
        self.mod_proj = nn.Linear(d, features, device=device)
        self.Dense_1 = nn.Linear(features, features, device=device)
        self.Dense_2 = nn.Linear(features, 1, device=device)

    @classmethod
    def from_variables(cls, flat, pool_size=5, device="cuda"):
        """An IoUNet shaped by, and holding, the flat variables of JAX's
        ``IoUNet`` (``params/Dense_0/kernel`` ``[p*p*C, features]``)."""
        from tao_amodal_torch.utils.weights import load_variables

        d, features = flat["params/Dense_0/kernel"].shape
        net = cls(d // pool_size ** 2, features, pool_size, device)
        load_variables(net, flat)
        return net

    def forward(self, feat, target_feat_vec, boxes_xyxy, spatial_scale=1.0):
        """``feat [H, W, C]``, ``target_feat_vec`` (from
        :meth:`modulation`), ``boxes_xyxy [N, 4]`` in feature
        coordinates over ``spatial_scale`` -> ``[N]``, differentiable in
        the boxes."""
        pooled = prroi_pool(feat, boxes_xyxy, out_size=self.pool_size,
                            spatial_scale=spatial_scale)   # [N, p, p, C]
        x = F.relu(self.Dense_0(pooled.reshape(pooled.shape[0], -1)))
        mod = F.relu(self.mod_proj(target_feat_vec))
        x = F.relu(self.Dense_1(x * mod[None, :]))
        return self.Dense_2(x)[:, 0]

    def modulation(self, feat, box_xyxy, spatial_scale=1.0):
        """The target modulation vector of the reference frame."""
        pooled = prroi_pool(feat, box_xyxy[None], out_size=self.pool_size,
                            spatial_scale=spatial_scale)
        return pooled.reshape(-1)


def classify(feats, filt):
    """Correlation response of ``filt [fh, fw, C]`` over ``feats [B, H,
    W, C]`` -> ``[B, Ho, Wo]`` ('valid'; JAX's depthwise correlation
    summed over channels)."""
    resp = xcorr_depthwise(feats.permute(0, 3, 1, 2),
                           filt.permute(2, 0, 1)[None])
    return resp.sum(1)


def train_filter(feats, labels, filter_shape, num_gn_iters=5,
                 num_cg_iters=8, reg=1e-2):
    """Optimize a correlation filter on memory samples (DiMP's model
    optimizer as Gauss-Newton/CG).

    ``feats [M, H, W, C]``, ``labels [M, Ho, Wo]`` (``Ho = H - fh +
    1``), ``filter_shape (fh, fw, C)``.  Returns ``(filter [fh, fw, C],
    losses [num_gn_iters + 1])``."""
    sqrt_reg = math.sqrt(reg)

    def residual(filt):
        return {"data": classify(feats, filt) - labels,
                "reg": sqrt_reg * filt}

    filt0 = torch.zeros(filter_shape, dtype=feats.dtype, device=feats.device)
    return gauss_newton_cg(residual, filt0, num_gn_iters=num_gn_iters,
                           num_cg_iters=num_cg_iters)


def _to_param(b):
    return torch.stack([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2,
                        torch.log(b[2] - b[0]), torch.log(b[3] - b[1])])


def _to_box(p):
    w = torch.exp(p[2])
    h = torch.exp(p[3])
    return torch.stack([p[0] - w / 2, p[1] - h / 2, p[0] + w / 2,
                        p[1] + h / 2])


def refine_box_ascent(iou_net, feat, mod_vec, box_xyxy, steps=5,
                      step_size=1.0, spatial_scale=1.0):
    """Gradient-ascent box refinement on the predicted IoU (the
    reference's ``refine_target_box``), in ``(cx, cy, log w, log h)`` so
    the ascent is scale-equivariant; each step's gradient comes through
    the PrRoI weights (``torch.autograd.grad``, grad on whatever the
    caller's mode).  Returns ``(box xyxy [4], predicted IoU)``."""
    p = _to_param(box_xyxy.detach())
    with torch.enable_grad():
        for _ in range(steps):
            p = p.detach().requires_grad_(True)
            iou = iou_net(feat, mod_vec, _to_box(p)[None],
                          spatial_scale=spatial_scale)[0]
            (g,) = torch.autograd.grad(iou, p)
            p = p.detach()
            scale = torch.cat([torch.exp(p[2:4]), torch.ones_like(p[:2])])
            p = p + step_size * g * scale
    with torch.no_grad():
        return _to_box(p), iou_net(feat, mod_vec, _to_box(p)[None],
                                   spatial_scale=spatial_scale)[0]
