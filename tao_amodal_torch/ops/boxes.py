"""Box geometry shared by NMS and SORT (xyxy convention).

The JAX package computes the same pairwise IoU twice, in
``ops/nms.py::_pairwise_iou_xyxy`` and ``trackers/sort.py::_iou_matrix``
(identical formulas); the port keeps one copy here.  The COCO-xywh
helpers of ``tao_amodal_tpu/ops/boxes.py`` serve the evaluators and are
not on the serving path.
"""

from __future__ import annotations

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
