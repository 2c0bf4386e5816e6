"""Track-level (3D) IoU as one batched contraction over frames.

The reference computes each entry of the (dt_track x gt_track) IoU matrix
with a Python loop over the union of frame ids
(``tao_amodal/evaluation/tao_amodal/eval.py:51-117``).  Here, as in
``tao_amodal_tpu/ops/track_iou.py``, a video's tracks are padded onto a
shared frame axis:

  boxes:  ``[..., T, F, 4]``  xywh per track per frame slot
  valid:  ``[..., T, F]``     bool, True where the track has a box there

and every mode reduces over ``F``.  Leading axes (videos of a bucket)
broadcast.  numpy inputs compute in their dtype on the host (the host
evaluator's float64), torch tensors on their device (the device
evaluator's float32); see :mod:`tao_amodal_torch.ops.boxes`.

Modes (reference ``eval.py:752-757``):
  * ``3d_iou``:       sum_f intersect / sum_f union
  * ``avg_iou``:      mean_f (intersect / union)      (0 where only one side)
  * ``imagenetvid``:  (#frames with IoU > thr) / (#frames either side present)

:func:`track_mask_iou_matrix` is the same over per-frame RLE masks (segm
evaluation), on the host through the RLE codec.
"""

from __future__ import annotations

import numpy as np

from tao_amodal_torch.ops import mask as mask_ops
from tao_amodal_torch.ops.boxes import array_module, box_intersect_union


def _pairwise_frame_terms(dt_boxes, dt_valid, gt_boxes, gt_valid):
    """Per-frame I and U terms for every (dt, gt) pair.

    Returns ``inter[..., D, G, F]``, ``union``, ``both``, ``either``,
    where ``union`` already includes the lone-box frames: when only one
    side has a box its area counts toward the union (reference
    ``eval.py:91-94``).
    """
    xp = array_module(dt_boxes)
    d = dt_boxes[..., :, None, :, :]  # [..., D, 1, F, 4]
    g = gt_boxes[..., None, :, :, :]  # [..., 1, G, F, 4]
    inter, union = box_intersect_union(d, g)  # [..., D, G, F]

    dv = dt_valid[..., :, None, :]  # [..., D, 1, F]
    gv = gt_valid[..., None, :, :]  # [..., 1, G, F]
    both = dv & gv
    only_d = dv & ~gv
    only_g = ~dv & gv

    d_area = (dt_boxes[..., 2] * dt_boxes[..., 3])[..., :, None, :]
    g_area = (gt_boxes[..., 2] * gt_boxes[..., 3])[..., None, :, :]

    inter = xp.where(both, inter, 0.0)
    union = (
        xp.where(both, union, 0.0)
        + xp.where(only_d, d_area, 0.0)
        + xp.where(only_g, g_area, 0.0)
    )
    return inter, union, both, dv | gv


def track_iou_matrix(dt_boxes, dt_valid, gt_boxes, gt_valid, mode="3d_iou",
                     vid_thr=0.5):
    """Track-IoU matrix ``[..., D, G]`` of one video (or a bucket).

    Args:
      dt_boxes: ``[..., D, F, 4]`` xywh; arbitrary values in invalid slots.
      dt_valid: ``[..., D, F]`` bool.
      gt_boxes: ``[..., G, F, 4]`` xywh.
      gt_valid: ``[..., G, F]`` bool.
      mode: ``3d_iou`` | ``avg_iou`` | ``imagenetvid``.
      vid_thr: per-frame match threshold for ``imagenetvid`` mode
        (reference ``eval.py:51`` default 0.5).
    """
    xp = array_module(dt_boxes)
    inter, union, both, either = _pairwise_frame_terms(
        dt_boxes, dt_valid, gt_boxes, gt_valid)

    if mode == "3d_iou":
        i_sum = inter.sum(-1)
        u_sum = union.sum(-1)
        return xp.where(u_sum > 0, i_sum / xp.where(u_sum > 0, u_sum, 1.0),
                        0.0)
    if mode == "avg_iou":
        # Per-frame IoU where both present; 0 where exactly one present;
        # frames where neither is present do not enter the mean
        # (reference ``eval.py:107-117``).
        per_frame = xp.where(union > 0,
                             inter / xp.where(union > 0, union, 1.0), 0.0)
        per_frame = xp.where(both, per_frame, 0.0)
        count = either.sum(-1)
        return xp.where(count > 0, per_frame.sum(-1) / count.clip(min=1),
                        0.0)
    if mode == "imagenetvid":
        # Frame matched when intersect > thr * union (strict >,
        # reference ``eval.py:65``); denominator counts frames where
        # either side has a box.
        matched = both & (inter > vid_thr * union)
        num = matched.sum(-1)
        den = either.sum(-1)
        return xp.where(den > 0, num / den.clip(min=1), 0.0)
    raise ValueError(f"unknown track IoU mode: {mode}")


def track_mask_iou_matrix(dt_rles, gt_rles, mode="3d_iou", vid_thr=0.5):
    """Track-IoU matrix over per-frame segmentation masks (host path).

    The reference's segm branch is non-functional (its per-frame kernel
    unpacks RLE dicts as xywh boxes, ``eval.py:306-335`` feeding
    ``eval.py:27-48``); this implements the semantics that branch
    clearly intends — the YTVIS mask 3D IoU the box version is
    explicitly "modified from" (``eval.py:79-81``): per-frame mask
    intersection/union areas with lone-frame masks counting toward the
    union, reduced per mode exactly like the box modes above.

    Args:
      dt_rles: ``[D][F]`` nested lists of RLE dicts, ``None`` where the
        track has no mask in that frame slot.
      gt_rles: ``[G][F]`` likewise.
      mode: ``3d_iou`` | ``avg_iou`` | ``imagenetvid``.

    Returns ``[D, G]`` float64 matrix.
    """
    D, G = len(dt_rles), len(gt_rles)
    F = len(dt_rles[0]) if D else (len(gt_rles[0]) if G else 0)
    # Each mask's counts once (the native codec decompresses them), its
    # area the sum of its foreground runs.
    dc = [[None if r is None else mask_ops.counts_of(r) for r in row]
          for row in dt_rles]
    gc = [[None if r is None else mask_ops.counts_of(r) for r in row]
          for row in gt_rles]

    def areas(rows, n):
        return np.array([[0 if c is None else int(c[1::2].sum(
            dtype=np.int64)) for c in row] for row in rows],
            np.float64).reshape(n, F)

    d_area, g_area = areas(dc, D), areas(gc, G)
    inter = np.zeros((D, G, F), np.float64)
    for f in range(F):
        for i in range(D):
            d = dc[i][f]
            if d is None:
                continue
            for j in range(G):
                g = gc[j][f]
                if g is not None:
                    inter[i, j, f] = mask_ops.intersect_counts(d, g)

    # Presence = an RLE exists in the slot (a zero-area mask still counts
    # as present, like a degenerate box does in the box path: the
    # reference's ``if d and g`` is truthy for any non-empty list).
    dv = np.array([[r is not None for r in row] for row in dt_rles],
                  bool).reshape(D, F)
    gv = np.array([[r is not None for r in row] for row in gt_rles],
                  bool).reshape(G, F)
    both = dv[:, None, :] & gv[None, :, :]
    only_d = dv[:, None, :] & ~gv[None, :, :]
    only_g = ~dv[:, None, :] & gv[None, :, :]
    union = (np.where(both,
                      d_area[:, None, :] + g_area[None, :, :] - inter,
                      0.0)
             + np.where(only_d, d_area[:, None, :], 0.0)
             + np.where(only_g, g_area[None, :, :], 0.0))
    inter = np.where(both, inter, 0.0)

    if mode == "3d_iou":
        i_sum, u_sum = inter.sum(-1), union.sum(-1)
        return np.where(u_sum > 0, i_sum / np.where(u_sum > 0, u_sum, 1.0),
                        0.0)
    if mode == "avg_iou":
        per_frame = np.where(union > 0,
                             inter / np.where(union > 0, union, 1.0), 0.0)
        per_frame = np.where(both, per_frame, 0.0)
        count = (dv[:, None, :] | gv[None, :, :]).sum(-1)
        return np.where(count > 0, per_frame.sum(-1) / np.maximum(count, 1),
                        0.0)
    if mode == "imagenetvid":
        matched = both & (inter > vid_thr * union)
        den = (dv[:, None, :] | gv[None, :, :]).sum(-1)
        return np.where(den > 0, matched.sum(-1) / np.maximum(den, 1), 0.0)
    raise ValueError(f"unknown track IoU mode: {mode}")


def track_iou_partials(dt_boxes, dt_valid, gt_boxes, gt_valid):
    """Partial (I, U) sums ``[..., D, G]`` over this frame slice.

    3D IoU is ``sum_f I / sum_f U``, so the sums of frame shards add up
    to the whole video's exactly: the building block of a frame-sharded
    (context-parallel) evaluation.
    """
    inter, union, _, _ = _pairwise_frame_terms(
        dt_boxes, dt_valid, gt_boxes, gt_valid)
    return inter.sum(-1), union.sum(-1)
