"""Greedy NMS as a batched parallel fixpoint (exact).

Port of :mod:`tao_amodal_tpu.ops.nms`.  Greedy NMS is the unique
solution of ``keep[j] = not exists i ranked above j with keep[i] and
IoU > thr``; Jacobi rounds of that recurrence converge to it in at most
chain-depth rounds.  Ranking is (score desc, index asc), the tie order
of score-sorted sequential NMS.

All functions take a leading batch (frame) axis or none.  The JAX
version runs 8 unrolled rounds and then a device ``while_loop``; eager
PyTorch cannot branch on the device, so here the rounds run in blocks of
``unrolled_rounds`` and the host checks convergence after each block:
one host sync per call when the fixpoint is reached within the first
block (the usual case), bounded by ``N`` rounds in all.
"""

from __future__ import annotations

import torch

from tao_amodal_torch.ops.boxes import box_iou_xyxy


def topk_stable(x, k):
    """Top-``k`` along the last axis, equal values in index order (the
    tie order of ``jax.lax.top_k``, which ``torch.topk`` does not
    promise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_keep_mask(boxes, scores, iou_thr, valid=None, unrolled_rounds=8):
    """Exact greedy-NMS keep mask ``[..., N]`` for ``boxes [..., N, 4]``
    and ``scores [..., N]``; entries with ``valid=False`` are never
    kept."""
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    iou = box_iou_xyxy(boxes, boxes)
    idx = torch.arange(n, device=boxes.device)
    s_i, s_j = scores[..., :, None], scores[..., None, :]
    ranked_above = (s_i > s_j) | ((s_i == s_j)
                                  & (idx[:, None] < idx[None, :]))
    sup = (iou > iou_thr) & ranked_above & valid[..., :, None]

    keep, prev, rounds = valid, None, 0
    while rounds < n:
        for _ in range(min(unrolled_rounds, n - rounds)):
            prev = keep
            keep = valid & ~(sup & keep[..., :, None]).any(dim=-2)
            rounds += 1
        if not bool((keep != prev).any()):   # host sync
            break
    return keep


def batched_nms(boxes, scores, iou_thr, max_out, valid=None):
    """NMS returning the top-``max_out`` surviving indices by score,
    ``-1`` marking exhausted slots."""
    keep = nms_keep_mask(boxes, scores, iou_thr, valid=valid)
    masked = torch.where(keep, scores, float("-inf"))
    top_scores, top_idx = topk_stable(masked, max_out)
    return torch.where(top_scores > float("-inf"), top_idx, -1)


def class_aware_nms(boxes, scores, classes, iou_thr, max_out,
                    valid=None):
    """Per-class NMS by the coordinate-offset trick: boxes of different
    classes are translated 1e5 apart, so one pass suppresses only within
    a class."""
    offset = classes.to(boxes.dtype)[..., None] * 1e5
    return batched_nms(boxes + offset, scores, iou_thr, max_out,
                       valid=valid)
