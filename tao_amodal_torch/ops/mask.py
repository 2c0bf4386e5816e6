"""pycocotools-style ``iou`` for boxes: the part of the JAX package's RLE
mask codec (``tao_amodal_tpu/ops/mask.py``) that bbox evaluation reaches.

Mask IoU, the RLE codec and its C++ backend (``tao_amodal_tpu/native``)
serve segm evaluation, which the port does not carry yet (ROADMAP.md
Queue A #9b); mask inputs raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import numpy as np

from tao_amodal_torch.ops.boxes import box_iou_matrix

SEGM_UNPORTED = ("segm evaluation (RLE masks) is not ported to "
                 "tao_amodal_torch yet: ROADMAP.md Queue A #9b")


def iou(dt, gt, iscrowd):
    """Pairwise IoU ``[n_dt, n_gt]`` of ``[n, 4]`` xywh boxes, in float64;
    ``iscrowd[g]`` switches the denominator to the dt area.  ``[]`` when
    either side is empty (pycocotools' ``mask.iou``)."""
    if not (_is_box_input(dt) and _is_box_input(gt)):
        raise NotImplementedError(SEGM_UNPORTED)
    d = np.asarray(dt, dtype=np.float64).reshape(-1, 4)
    g = np.asarray(gt, dtype=np.float64).reshape(-1, 4)
    if d.size == 0 or g.size == 0:
        return []
    return np.asarray(box_iou_matrix(d, g, iscrowd=np.asarray(
        iscrowd, dtype=bool) if len(iscrowd) else None))


def _is_box_input(x):
    if isinstance(x, np.ndarray):
        return x.ndim == 2 and x.shape[1] == 4
    if isinstance(x, (list, tuple)) and x:
        el = x[0]
        return (isinstance(el, (list, tuple, np.ndarray)) and len(el) == 4
                and not isinstance(el, dict))
    return isinstance(x, (list, tuple)) and not x
