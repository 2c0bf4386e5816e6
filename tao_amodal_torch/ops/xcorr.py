"""Cross-correlation of template features over search features.

Port of ``tao_amodal_tpu/ops/xcorr.py``: each sample's template slides
over the same sample's search map, as one grouped convolution (the batch
folded into the channels, ``groups`` doing the per-sample grouping), as
JAX's ``lax.conv_general_dilated`` with ``feature_group_count`` does.
JAX runs no Pallas kernel here, so the port calls ``F.conv2d`` too.

Layout: NCHW, as the port's modules hold their features; the search map
``x`` is ``[B, C, Hx, Wx]`` and the template ``kernel`` ``[B, C, Hz, Wz]``
or ``[1, C, Hz, Wz]`` (one template for every search map, as the
hyperparameter sweep runs).  The sums are f32, JAX's
``preferred_element_type``.
"""

from __future__ import annotations

import torch.nn.functional as F


def _fold(x, kernel):
    b = x.shape[0]
    kernel = kernel.expand(b, *kernel.shape[1:])
    return x.float().reshape(1, -1, *x.shape[2:]), kernel.float(), b


def xcorr_depthwise(x, kernel):
    """Per-sample, per-channel correlation -> ``[B, C, Ho, Wo]``: each
    (sample, channel) plane of ``kernel`` slides over the same plane of
    ``x`` (JAX ``xcorr_depthwise``, ``B*C`` groups)."""
    xr, kernel, b = _fold(x, kernel)
    c = x.shape[1]
    out = F.conv2d(xr, kernel.reshape(b * c, 1, *kernel.shape[2:]),
                   groups=b * c)
    return out.reshape(b, c, *out.shape[2:])


def xcorr_full(x, kernel):
    """Per-sample dense correlation -> ``[B, 1, Ho, Wo]``: each sample's
    template is one filter over all its channels (JAX ``xcorr_full``,
    ``B`` groups)."""
    xr, kernel, b = _fold(x, kernel)
    out = F.conv2d(xr, kernel, groups=b)
    return out.reshape(b, 1, *out.shape[2:])

