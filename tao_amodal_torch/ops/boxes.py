"""Box geometry: xyxy IoU for NMS and SORT, xywh (COCO) for the evaluators.

The JAX package computes the same pairwise xyxy IoU twice, in
``ops/nms.py::_pairwise_iou_xyxy`` and ``trackers/sort.py::_iou_matrix``
(identical formulas); the port keeps one copy here.

The xywh IoU functions mirror ``tao_amodal_tpu/ops/boxes.py``, whose ``xp=``
argument picks numpy or ``jax.numpy``.  Here the inputs pick: numpy
arrays run the host evaluators' float64 formulas (the reference's
precision; greedy matching is tie-sensitive), torch tensors the device
evaluators' on the tensors' device and dtype.  The formulas and their
order of operations are the JAX package's, so the numpy path equals its
numpy path bit for bit.  Every function broadcasts over leading axes.
"""

from __future__ import annotations

import numpy as np
import torch


def box_iou_xyxy(a, b):
    """Pairwise IoU ``[..., N, M]`` of xyxy boxes ``a [..., N, 4]`` and
    ``b [..., M, 4]``; 0 where the union is empty."""
    x0 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y0 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x1 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y1 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x1 - x0).clamp_min(0) * (y1 - y0).clamp_min(0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def array_module(x):
    """``torch`` for a tensor, else ``numpy``."""
    return torch if isinstance(x, torch.Tensor) else np


def _cat(xp, parts):
    return torch.cat(parts, -1) if xp is torch else np.concatenate(parts, -1)


def xywh_to_xyxy(boxes):
    """``[x, y, w, h] -> [x1, y1, x2, y2]`` over the last axis."""
    x, y, w, h = (boxes[..., i:i + 1] for i in range(4))
    return _cat(array_module(boxes), [x, y, x + w, y + h])


def xyxy_to_xywh(boxes):
    """``[x1, y1, x2, y2] -> [x, y, w, h]`` over the last axis."""
    x1, y1, x2, y2 = (boxes[..., i:i + 1] for i in range(4))
    return _cat(array_module(boxes), [x1, y1, x2 - x1, y2 - y1])


def box_area(boxes):
    """Area ``w * h`` of ``[..., 4]`` xywh boxes -> ``[...]``."""
    return boxes[..., 2] * boxes[..., 3]


def box_intersect_union(d, g):
    """Elementwise ``(intersection, union)`` of broadcastable xywh boxes
    ``d [..., 4]`` and ``g [..., 4]``, with ``union = area_d + area_g -
    inter`` (the reference's ``bb_intersect_union``,
    ``tao_amodal/evaluation/tao_amodal/eval.py:15-48``)."""
    xp = array_module(d)
    dx, dy, dw, dh = (d[..., i] for i in range(4))
    gx, gy, gw, gh = (g[..., i] for i in range(4))

    left = xp.maximum(dx, gx)
    right = xp.minimum(dx + dw, gx + gw)
    top = xp.maximum(dy, gy)
    bottom = xp.minimum(dy + dh, gy + gh)

    iw = (right - left).clip(min=0.0)
    ih = (bottom - top).clip(min=0.0)
    inter = iw * ih
    union = dw * dh + gw * gh - inter
    return inter, union


def box_iou_matrix(dt, gt, iscrowd=None):
    """Pairwise IoU ``[..., D, G]`` between xywh boxes ``dt [..., D, 4]``
    and ``gt [..., G, 4]``.  With ``iscrowd[g]`` true the denominator is
    the detection's area alone (the COCO crowd convention)."""
    xp = array_module(dt)
    inter, union = box_intersect_union(dt[..., :, None, :],
                                       gt[..., None, :, :])
    if iscrowd is not None:
        crowd = (torch.as_tensor(iscrowd, dtype=torch.bool,
                                 device=dt.device) if xp is torch
                 else np.asarray(iscrowd, bool))
        union = xp.where(crowd[..., None, :], box_area(dt)[..., :, None],
                         union)
    return xp.where(union > 0, inter / xp.where(union > 0, union, 1.0), 0.0)
