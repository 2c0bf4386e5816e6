"""Greedy NMS as a batched parallel fixpoint (exact).

Port of :mod:`tao_amodal_tpu.ops.nms`.  Greedy NMS is the unique
solution of ``keep[j] = not exists i ranked above j with keep[i] and
IoU > thr``; Jacobi rounds of that recurrence converge to it in at most
chain-depth rounds.  Ranking is (score desc, index asc), the tie order
of score-sorted sequential NMS.

All functions take a leading batch (frame) axis or none.  The JAX
version runs 8 unrolled rounds and then a device ``while_loop``.  Here
the suppression matrix is built by the same tensor ops, and the rounds
run in :func:`nms_fixpoint`: on a CUDA tensor one launch of
``tao_nms_fixpoint`` (``csrc/fixpoint.cu``), every round on the card and
no host sync, so a clip captures as one CUDA graph; on a CPU tensor its
plain version :func:`nms_fixpoint_torch`, which runs the rounds in blocks
of ``unrolled_rounds`` and checks convergence on the host after each
block (eager PyTorch cannot branch on the device), bounded by ``N``
rounds in all.
"""

from __future__ import annotations

import math

import torch

from tao_amodal_torch import _build
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
    return nms_fixpoint(sup, valid, unrolled_rounds)


def nms_fixpoint_torch(sup, valid, unrolled_rounds=8):
    """Plain version of :func:`nms_fixpoint`: Jacobi rounds ``keep =
    valid & ~any_i(sup[i, :] & keep[i])`` from ``keep = valid`` until a
    round changes nothing (a host check after each block of
    ``unrolled_rounds``), at most ``N`` rounds."""
    n = sup.shape[-1]
    keep, prev, rounds = valid, None, 0
    while rounds < n:
        for _ in range(min(unrolled_rounds, n - rounds)):
            prev = keep
            keep = valid & ~(sup & keep[..., :, None]).any(dim=-2)
            rounds += 1
        if not bool((keep != prev).any()):   # host sync
            break
    return keep


def nms_fixpoint(sup, valid, unrolled_rounds=8):
    """The greedy-NMS fixpoint of ``sup [..., N, N]`` (``sup[i, j]``: box
    ``i`` suppresses box ``j`` if kept) and ``valid [..., N]``, both
    bool -> ``keep [..., N]`` bool.

    A CPU ``sup`` takes the plain version (``unrolled_rounds`` sets its
    host checks); a CUDA ``sup`` launches ``tao_nms_fixpoint`` once, one
    block a leading index, all rounds on the card, or this raises.
    ``launches`` counts the launches.
    """
    if sup.device.type == "cpu":
        return nms_fixpoint_torch(sup, valid, unrolled_rounds)
    if sup.device.type != "cuda":
        raise ValueError(f"nms_fixpoint: unsupported device {sup.device}")
    n = sup.shape[-1]
    if (sup.dtype != torch.bool or valid.dtype != torch.bool
            or sup.dim() < 2 or sup.shape[-2] != n
            or valid.device != sup.device):
        raise ValueError(f"nms_fixpoint: want bool sup [..., N, N] and "
                         f"valid [..., N] on {sup.device}, got "
                         f"{sup.dtype} {tuple(sup.shape)}, {valid.dtype} "
                         f"{tuple(valid.shape)} on {valid.device}")
    lead = sup.shape[:-2]
    valid = valid.expand(*lead, n)
    B = math.prod(lead)
    if B == 0 or n == 0:
        return valid.clone()
    if B >= 1 << 31:
        raise ValueError(f"nms_fixpoint: {B} rows exceed a grid")
    sup = sup.reshape(B, n, n).contiguous()
    valid = valid.reshape(B, n).contiguous()
    keep = torch.empty((B, n), dtype=torch.bool, device=sup.device)
    err = _build.library().tao_nms_fixpoint(
        sup.data_ptr(), valid.data_ptr(), keep.data_ptr(), B, n,
        torch.cuda.current_stream(sup.device).cuda_stream)
    _build.check("tao_nms_fixpoint", err)
    nms_fixpoint.launches += 1
    return keep.reshape(*lead, n)


nms_fixpoint.launches = 0


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
