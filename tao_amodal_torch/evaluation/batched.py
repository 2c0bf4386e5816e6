"""Track-mAP evaluation of a bucket of padded videos as batched tensor ops.

The port of ``tao_amodal_tpu/evaluation/batched.py``: ``eval_video_device``,
with ``pr_curves_device`` (every cell's PR summary on the device) and
``pack_video`` (a video's host-side padding).
The host evaluator (:mod:`tao_amodal_torch.evaluation.track_eval`) is
the float64 parity oracle; this is the device path.  Where the JAX
package ``vmap``s one video's program over (category, area range, time
range) cells and over the videos of a bucket, here every cell and video
is a leading batch axis of the same tensors:

  * one track-IoU matrix per video (``track_iou_matrix``, float32);
  * per-category cells by validity masks (no ragged slicing), with a
    stable per-cell permutation that orders gts ignore-last;
  * one global stable score sort per video (padding sorts last);
  * the greedy matcher (:func:`greedy_match_torch`) steps over the D
    detection slots, each step one update of every cell, threshold and
    video of the bucket.

Every argument lives on the caller's device; nothing here syncs with the
host but the matcher's one read of how many steps to run.
"""

from __future__ import annotations

import numpy as np
import torch

from tao_amodal_torch.ops.matching import greedy_match_torch
from tao_amodal_torch.ops.track_iou import track_iou_matrix

# dt_matches travel as int16 holding gt ids arange(G) + GT_ID_BASE.
GT_ID_BASE = 101


def resolve_device(device):
    """``torch.device(device)``; raises for a CUDA device where there is
    none, rather than evaluating somewhere the caller did not ask for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device evaluation on 'cuda' needs a CUDA device; pass "
            "device='cpu' to run it on the CPU")
    return device


def check_int16_ids(G):
    """The padded gt count must fit the int16 match ids."""
    if G + GT_ID_BASE >= 2 ** 15:
        raise ValueError(
            f"padded gt count {G} overflows the int16 match ids")


def gather_last(x, index):
    """``x`` gathered along its last axis by ``index``, broadcasting the
    leading axes of both."""
    shape = np.broadcast_shapes(x.shape[:-1], index.shape[:-1])
    return x.expand(*shape, x.shape[-1]).gather(
        -1, index.expand(*shape, index.shape[-1]))


def eval_video_device(dt, gt, area_rngs, time_rngs, use_occ, iou_thrs,
                      hp_min_frames=6, ious=None):
    """Evaluate a bucket of N padded videos over all cells.

    Args:
      dt: dict of tensors with a leading video axis N: ``boxes [N, D, F,
        4]`` (xywh), ``frame_valid [N, D, F]``, ``scores [N, D]``, ``cats
        [N, D]``, ``areas [N, D]``, ``durs [N, D]``, ``nel [N, D]``
        (category-not-exhaustive flag), ``exists [N, D]``, and
        ``cell_cats [N, K]``, the cells' categories: each video's
        candidates, padded with ``-2`` (the JAX package's
        ``dt["cell_cats"]``; a video touches a handful of the
        vocabulary).
      gt: ``boxes [N, G, F, 4]``, ``frame_valid [N, G, F]``, ``cats``,
        ``areas``, ``durs``, ``hp_frames``, ``ignore0``, ``exists``, each
        ``[N, G]``.
      area_rngs: ``[A, 2]``; time_rngs ``[Tm, 2]``; use_occ ``[A]`` bool,
        the HP pseudo-range flag per area range; iou_thrs ``[T]``;
        hp_min_frames: the HP range's least count of occluded frames.
      ious: ``[N, D, G]`` precomputed track-IoU matrices (segm mode: the
        mask IoU is host RLE math; the matching stays on the device), or
        None for the box track IoU of ``boxes``.

    Returns a dict: ``dt_matches [N, K, A, Tm, T, D]`` int16 (gt ids,
    -1 unmatched), ``dt_ignore [N, K, A, Tm, T, D]`` bool, ``gt_ignore
    [N, K, A, Tm, G]`` int8, ``dt_in_cell [N, K, D]``, ``cell_valid [N,
    K]``, ``dt_scores [N, D]`` and ``dt_order [N, D]``, detections in
    the score order.
    """
    f32 = torch.float32
    N, D = dt["scores"].shape
    G = gt["cats"].shape[1]
    dev = dt["scores"].device
    check_int16_ids(G)

    if ious is None:
        ious = track_iou_matrix(dt["boxes"], dt["frame_valid"], gt["boxes"],
                                gt["frame_valid"])
    ious = ious.to(f32)                                        # [N, D, G]
    # Global stable score-descending order for detections.
    order = torch.argsort(-dt["scores"], dim=-1, stable=True)
    ious_sorted = ious.gather(1, order[:, :, None].expand(N, D, G))
    dt_ids = (torch.arange(D, dtype=f32, device=dev) + 1.0)[order]

    cell_cats = dt["cell_cats"][:, :, None]                    # [N, K, 1]
    dt_mask = (dt["cats"][:, None] == cell_cats) & dt["exists"][:, None]
    gt_mask = (gt["cats"][:, None] == cell_cats) & gt["exists"][:, None]
    dt_mask_sorted = gather_last(dt_mask, order[:, None])      # [N, K, D]

    # Per-range gt ignore flags, [N, A, Tm, G].
    a_lo, a_hi = area_rngs[:, 0, None, None], area_rngs[:, 1, None, None]
    t_lo, t_hi = time_rngs[:, 0, None], time_rngs[:, 1, None]
    g_area = gt["areas"][:, None, None]
    g_dur = gt["durs"][:, None, None]
    ignore = ((gt["ignore0"] != 0)[:, None, None]
              | (g_area < a_lo) | (g_area > a_hi)
              | (g_dur < t_lo) | (g_dur > t_hi))
    ignore = ignore | (use_occ[:, None, None]
                       & (gt["hp_frames"] <= hp_min_frames - 1)
                       [:, None, None])

    # Order each cell's gts: valid non-ignored, valid ignored, padding.
    key = (ignore.to(torch.int32)[:, None]
           + 2 * (~gt_mask).to(torch.int32)[:, :, None, None])
    perm = torch.argsort(key, dim=-1, stable=True)        # [N, K, A, Tm, G]
    gt_ig = gather_last(ignore.to(f32)[:, None], perm)
    gt_ids = (torch.arange(G, dtype=f32, device=dev) + GT_ID_BASE)[perm]
    gt_valid = gather_last(gt_mask[:, :, None, None], perm)
    ious_cell = gather_last(ious_sorted[:, None, None, None],
                            perm[..., None, :])     # [N, K, A, Tm, D, G]

    dt_m, _, dt_igm = greedy_match_torch(
        ious_cell, gt_ig, dt_ids[:, None, None, None], gt_ids, iou_thrs,
        dt_valid=dt_mask_sorted[:, :, None, None], gt_valid=gt_valid,
        unmatched=-1.0)                             # [N, K, A, Tm, T, D]

    d_area = dt["areas"][:, None, None]
    d_dur = dt["durs"][:, None, None]
    dt_ig_mask = ((d_area < a_lo) | (d_area > a_hi)
                  | (d_dur < t_lo) | (d_dur > t_hi)
                  | dt["nel"][:, None, None])             # [N, A, Tm, D]
    dt_ig_mask = gather_last(dt_ig_mask, order[:, None, None])
    dt_ig = (dt_igm != 0) | ((dt_m == -1) & dt_ig_mask[:, None, :, :, None])
    return {
        # Compact dtypes for the copy to the host: dt_matches holds
        # small gt ids (-1 = unmatched), gt_ignore a 0/1 flag; the host
        # precision/recall math only tests ``!= -1`` / ``== 0``.
        "dt_matches": dt_m.to(torch.int16),
        "dt_ignore": dt_ig,
        "gt_ignore": torch.where(gt_valid, gt_ig, 1.0).to(torch.int8),
        "dt_in_cell": dt_mask_sorted,
        "cell_valid": dt_mask.any(-1) | gt_mask.any(-1),
        "dt_scores": dt["scores"].gather(1, order),
        "dt_order": order,
    }


def pr_curves_device(tps, fps, num_gt, rec_thrs):
    """PR summary of every cell as tensor ops on the inputs' device (JAX's
    ``pr_curves_device``).

    Args:
      tps / fps: ``[..., T, N]`` bool, N globally score-sorted.
      num_gt: ``[...]`` per-cell non-ignored gt counts.
      rec_thrs: ``[R]`` recall thresholds.

    Returns (precision ``[..., T, R]``, recall ``[..., T]``), f32: the
    reference's right-max interpolation (a reversed cumulative max) and
    left ``searchsorted``; cells with ``num_gt == 0`` give -1 (absent).
    """
    tp = torch.cumsum(tps, dim=-1).to(torch.float32)
    fp = torch.cumsum(fps, dim=-1).to(torch.float32)
    num_gt = torch.as_tensor(num_gt, device=tp.device)
    rec_thrs = torch.as_tensor(rec_thrs, dtype=torch.float32,
                               device=tp.device)
    rc = tp / num_gt.clamp_min(1)[..., None, None]
    pr = tp / (fp + tp + torch.finfo(torch.float32).eps)
    pr = torch.cummax(pr.flip(-1), dim=-1).values.flip(-1)
    n = rc.shape[-1]
    idx = torch.searchsorted(
        rc.contiguous(), rec_thrs.expand(*rc.shape[:-1], -1).contiguous(),
        side="left")
    prec = torch.where(idx < n, pr.gather(-1, idx.clamp_max(n - 1)), 0.0)
    absent = num_gt == 0
    prec = torch.where(absent[..., None, None], -1.0, prec)
    recall = torch.where(absent[..., None], -1.0, rc[..., -1])
    return prec, recall


def pack_video(cells_dt, cells_gt, pad_d, pad_g, num_frames):
    """One video's tracks packed into padded numpy arrays on the host
    (JAX's ``pack_video``, the same dict schema).

    ``cells_dt`` / ``cells_gt`` are lists of per-track dicts: ``boxes``
    ``{frame: xywh}``, ``category_id``, ``area``, ``duration``, and
    ``score`` and ``nel`` (dt) or ``hp_frames`` and ``ignore`` (gt).
    Returns (dt, gt) dicts: ``boxes [pad, F, 4]``, ``frame_valid``,
    ``cats`` (-1 padding), ``areas``, ``durs``, ``exists``, and
    ``scores`` (-inf padding) and ``nel`` or ``hp_frames`` and
    ``ignore0``.  Tracks past ``pad`` are dropped.
    """
    def pack(tracks, pad, is_gt):
        boxes = np.zeros((pad, num_frames, 4), np.float32)
        fvalid = np.zeros((pad, num_frames), bool)
        cats = np.full((pad,), -1, np.int32)
        areas = np.zeros((pad,), np.float32)
        durs = np.zeros((pad,), np.float32)
        exists = np.zeros((pad,), bool)
        extra = {}
        if is_gt:
            extra["hp_frames"] = np.zeros((pad,), np.float32)
            extra["ignore0"] = np.zeros((pad,), np.float32)
        else:
            extra["scores"] = np.full((pad,), -np.inf, np.float32)
            extra["nel"] = np.zeros((pad,), bool)
        for i, tr in enumerate(tracks[:pad]):
            for f, b in tr["boxes"].items():
                boxes[i, f] = b
                fvalid[i, f] = True
            cats[i] = tr["category_id"]
            areas[i] = tr["area"]
            durs[i] = tr["duration"]
            exists[i] = True
            if is_gt:
                extra["hp_frames"][i] = tr.get("hp_frames", 0)
                extra["ignore0"][i] = tr.get("ignore", 0)
            else:
                extra["scores"][i] = tr["score"]
                extra["nel"][i] = tr.get("nel", False)
        out = {"boxes": boxes, "frame_valid": fvalid, "cats": cats,
               "areas": areas, "durs": durs, "exists": exists}
        out.update(extra)
        return out

    return pack(cells_dt, pad_d, False), pack(cells_gt, pad_g, True)
