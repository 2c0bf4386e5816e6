"""Numeric ops: box geometry, track IoU, greedy matching and PR curves
(the names of :mod:`tao_amodal_tpu.ops`; the device matcher is
``greedy_match_torch``, JAX's ``greedy_match_jax``)."""

from tao_amodal_torch.ops.boxes import (  # noqa: F401
    box_area,
    box_intersect_union,
    box_iou_matrix,
    xywh_to_xyxy,
    xyxy_to_xywh,
)
from tao_amodal_torch.ops.track_iou import track_iou_matrix  # noqa: F401
from tao_amodal_torch.ops.matching import (  # noqa: F401
    greedy_match,
    greedy_match_torch,
)
from tao_amodal_torch.ops.pr import pr_curves  # noqa: F401
