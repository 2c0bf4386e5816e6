"""Greedy NMS as a batched parallel fixpoint (exact).

Port of :mod:`tao_amodal_tpu.ops.nms`.  Greedy NMS is the unique
solution of ``keep[j] = not exists i ranked above j with keep[i] and
IoU > thr``; Jacobi rounds of that recurrence converge to it in at most
chain-depth rounds.  Ranking is (score desc, index asc), the tie order
of score-sorted sequential NMS.

All functions take a leading batch (frame) axis or none.  The JAX
version builds the suppression matrix with array ops, runs 8 unrolled
rounds and then a device ``while_loop``.  Here :func:`nms_keep_mask`
on a CUDA tensor is one C call, ``tao_nms_keep`` (``csrc/fixpoint.cu``):
a kernel spread over the card builds the suppression matrix from the
boxes as packed bits (no ``[B, N, N]`` tensor), and one block a frame
runs every round on the card, no host sync, so a clip captures as one
CUDA graph.  On a CPU tensor it takes its plain version
:func:`nms_keep_mask_torch`: the IoU matrix and the ranking as tensor
ops, then :func:`nms_fixpoint_torch`, which runs the rounds in blocks of
``unrolled_rounds`` and checks convergence on the host after each block
(eager PyTorch cannot branch on the device), bounded by ``N`` rounds in
all.  :func:`nms_fixpoint` runs the rounds of a given suppression
matrix (``tao_nms_fixpoint`` on the card).
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


def suppression_torch(boxes, scores, iou_thr, valid=None):
    """The suppression matrix of :func:`nms_keep_mask_torch` as tensor
    ops: ``(sup [..., N, N], valid [..., N])``, ``sup[i, j]`` where box
    ``i`` ranks above ``j`` (score, then index), is valid and overlaps
    ``j`` with IoU > ``iou_thr`` (:func:`box_iou_xyxy`); ``valid`` all
    True where None."""
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    iou = box_iou_xyxy(boxes, boxes)
    idx = torch.arange(n, device=boxes.device)
    s_i, s_j = scores[..., :, None], scores[..., None, :]
    ranked_above = (s_i > s_j) | ((s_i == s_j)
                                  & (idx[:, None] < idx[None, :]))
    return (iou > iou_thr) & ranked_above & valid[..., :, None], valid


def nms_keep_mask_torch(boxes, scores, iou_thr, valid=None,
                        unrolled_rounds=8):
    """Plain version of :func:`nms_keep_mask`:
    :func:`suppression_torch`, then :func:`nms_fixpoint_torch`."""
    sup, valid = suppression_torch(boxes, scores, iou_thr, valid)
    return nms_fixpoint_torch(sup, valid, unrolled_rounds)


def nms_keep_mask(boxes, scores, iou_thr, valid=None, unrolled_rounds=8):
    """Exact greedy-NMS keep mask ``[..., N]`` for ``boxes [..., N, 4]``
    and ``scores [..., N]``; entries with ``valid=False`` are never
    kept.

    CPU tensors take the plain version :func:`nms_keep_mask_torch`
    (``unrolled_rounds`` sets its host checks).  CUDA tensors launch
    ``tao_nms_keep`` once, or this raises: f32 boxes, f32, bf16 or f16
    scores (compared in f32, exactly as in their own type), a Python
    number ``iou_thr`` (compared in f32, as PyTorch compares an f32
    tensor with a Python float).  Its result equals the plain version's
    bit for bit, NaN and infinite coordinates included.  ``launches``
    counts the launches.
    """
    if boxes.device.type == "cpu":
        return nms_keep_mask_torch(boxes, scores, iou_thr, valid,
                                   unrolled_rounds)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep_mask: unsupported device "
                         f"{boxes.device}")
    if (boxes.dtype != torch.float32 or boxes.dim() < 2
            or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:-1]
            or scores.dtype not in (torch.float32, torch.bfloat16,
                                    torch.float16)
            or scores.device != boxes.device
            or (valid is not None and (valid.dtype != torch.bool
                                       or valid.device != boxes.device))
            or isinstance(iou_thr, (bool, torch.Tensor))
            or not isinstance(iou_thr, (int, float))):
        raise ValueError(
            f"nms_keep_mask: want f32 boxes [..., N, 4], f32/bf16/f16 "
            f"scores [..., N] and bool valid on {boxes.device} and a Python "
            f"number iou_thr, got {boxes.dtype} {tuple(boxes.shape)}, "
            f"{scores.dtype} {tuple(scores.shape)} on {scores.device}, "
            f"valid {None if valid is None else (valid.dtype, valid.device)}"
            f", iou_thr {type(iou_thr).__name__}")
    lead, n = boxes.shape[:-2], boxes.shape[-2]
    B = math.prod(lead)
    if B == 0 or n == 0:
        return (torch.ones((*lead, n), dtype=torch.bool, device=boxes.device)
                if valid is None else valid.expand(*lead, n).clone())
    if B * -(-n // 128) >= 1 << 31 or n > 65535 * 32:
        raise ValueError(f"nms_keep_mask: {B} frames of {n} boxes exceed "
                         f"a grid")
    boxes = boxes.reshape(B, n, 4).contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    scores = scores.reshape(B, n).to(torch.float32).contiguous()
    if valid is not None:
        valid = valid.expand(*lead, n).reshape(B, n).contiguous()
    keep = torch.empty((B, n), dtype=torch.bool, device=boxes.device)
    cols = torch.empty((B, (n + 31) // 32, n), dtype=torch.int32,
                       device=boxes.device)
    err = _build.library().tao_nms_keep(
        boxes.data_ptr(), scores.data_ptr(),
        None if valid is None else valid.data_ptr(), keep.data_ptr(),
        cols.data_ptr(), B, n, float(iou_thr),
        torch.cuda.current_stream(boxes.device).cuda_stream)
    _build.check("tao_nms_keep", err)
    nms_keep_mask.launches += 1
    return keep.reshape(*lead, n)


nms_keep_mask.launches = 0


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
    host checks); a CUDA ``sup`` launches ``tao_nms_fixpoint`` once (a
    kernel packs ``sup`` into bits, then one block a leading index runs
    all rounds on the card, as :func:`nms_keep_mask`'s), or this raises.
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
    if B * -(-n // 128) >= 1 << 31 or n > 65535 * 32:
        raise ValueError(f"nms_fixpoint: {B} rows of {n} exceed a grid")
    sup = sup.reshape(B, n, n).contiguous()
    valid = valid.reshape(B, n).contiguous()
    keep = torch.empty((B, n), dtype=torch.bool, device=sup.device)
    cols = torch.empty((B, (n + 31) // 32, n), dtype=torch.int32,
                       device=sup.device)
    err = _build.library().tao_nms_fixpoint(
        sup.data_ptr(), valid.data_ptr(), keep.data_ptr(), cols.data_ptr(),
        B, n, torch.cuda.current_stream(sup.device).cuda_stream)
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
