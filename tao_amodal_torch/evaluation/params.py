"""Typed parameter objects for both evaluators.

One dataclass-style config replaces the reference's two hardcoded
``Params`` classes (``tao_amodal/evaluation/tao_amodal/eval.py:720-757``
and ``lvis_amodal/eval.py:553-583``).  Values are byte-identical to the
reference protocol: IoU thresholds 0.5:0.05:0.95, 101 recall points, 300
max detections, the amodal visibility splits, and the TAO area/time
ranges including the "highly-and-partially-occluded" pseudo-range.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


def _iou_thrs():
    # linspace, not arange: arange accumulates float error
    # (reference comment at ``eval.py:725-726``).
    return np.linspace(0.5, 0.95, int(np.round((0.95 - 0.5) / 0.05)) + 1,
                       endpoint=True)


def _rec_thrs():
    return np.linspace(0.0, 1.00, int(np.round((1.00 - 0.0) / 0.01)) + 1,
                       endpoint=True)


@dataclasses.dataclass
class TrackEvalParams:
    """Track-mAP protocol (reference ``tao_amodal/eval.py:720-757``)."""

    iou_type: str = "bbox"
    # 3d_iou: sum_t I / sum_t U; avg_iou: mean_t IoU; imagenetvid:
    # fraction of frames with IoU > 0.5.
    iou_3d_type: str = "3d_iou"
    vid_ids: List[int] = dataclasses.field(default_factory=list)
    cat_ids: List[int] = dataclasses.field(default_factory=list)
    iou_thrs: np.ndarray = dataclasses.field(default_factory=_iou_thrs)
    rec_thrs: np.ndarray = dataclasses.field(default_factory=_rec_thrs)
    max_dets: int = 300
    area_rng: Sequence[Sequence[float]] = (
        (0 ** 2, 1e5 ** 2),
        (0 ** 2, 32 ** 2),
        (32 ** 2, 96 ** 2),
        (96 ** 2, 1e5 ** 2),
        (0 ** 2, 1e5 ** 2),  # HP pseudo-range, gated on occluded frames
    )
    area_rng_lbl: Sequence[str] = (
        "all", "small", "medium", "large", "highly-and-partially-occluded")
    time_rng: Sequence[Sequence[float]] = (
        (0, 1e5), (0, 3), (3, 10), (10, 1e5))
    time_rng_lbl: Sequence[str] = ("all", "short", "medium", "long")
    use_cats: int = 1
    # Track counts as occluded-enough for the HP range only with > 5
    # frames below this visibility (reference ``eval.py:358-368``).
    hp_visibility_thr: float = 0.8
    hp_min_frames: int = 6
    vid_count_lbl: Sequence[str] = ("r", "c", "f")


@dataclasses.dataclass
class DetectionEvalParams:
    """Amodal detection AP protocol (reference ``lvis_amodal/eval.py:553``)."""

    iou_type: str = "bbox"
    img_ids: List[int] = dataclasses.field(default_factory=list)
    cat_ids: List[int] = dataclasses.field(default_factory=list)
    iou_thrs: np.ndarray = dataclasses.field(default_factory=_iou_thrs)
    rec_thrs: np.ndarray = dataclasses.field(default_factory=_rec_thrs)
    max_dets: int = 300
    visibility_rng: Sequence[Sequence[float]] = (
        (0, 1.0),      # all
        (0, 0.1),      # highly-occluded
        (0.1, 0.8),    # partially-occluded
        (0.8, 1.0),    # highly-visible
        (0, 0.8),      # highly-and-partially-occluded
        (0, 1.0),      # pseudo range: out-of-frame gts
    )
    visibility_rng_lbl: Sequence[str] = (
        "all", "highly-occluded", "partially-occluded", "highly-visible",
        "highly-and-partially-occluded", "out-of-frame")
    use_cats: int = 1
    img_count_lbl: Sequence[str] = ("r", "c", "f")
