"""COCO-style greedy score-ordered matching.

The reference runs a triple Python loop (threshold x dt x gt) per
(video, category) cell (``tao_amodal/evaluation/tao_amodal/eval.py:396-428``
and the identical per-frame variant ``lvis_amodal/eval.py:245-277``).  The
loop body is equivalent to, per detection (processed in score order):

  1. candidate gts: not yet matched AND iou >= threshold;
  2. among *non-ignored* candidates pick argmax-iou (LAST index on ties:
     the reference's ``ious < iou -> continue`` is a strict-less skip, so
     an equal-iou later gt replaces the running best);
  3. if none, pick argmax-iou among *ignored* candidates (gts are
     pre-sorted ignore-last, and the loop breaks out of the ignore region
     only when a real match was already found — so ignored gts are a
     fallback pool, never an upgrade);
  4. record matched ids; a gt counts as "matched" when its stored dt id
     is ``> 0`` (reference ``eval.py:407``) — reproduced bit for bit,
     including the consequence that a dt with id <= 0 never blocks a gt.

Two implementations with identical results (the JAX package's
``tao_amodal_tpu/ops/matching.py``):

  * :func:`greedy_match` — numpy float64, loops over detections,
    vectorized over the IoU thresholds.  The host evaluators' matcher.
  * :func:`greedy_match_torch` — torch, a loop over the D detection
    slots whose every step is one batched update of all cells and
    thresholds at once (the JAX package's ``lax.scan`` over D under
    ``vmap``); the device evaluators' matcher.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS_CAP = 1.0 - 1e-10  # reference: iou = min(thr, 1 - 1e-10)


def greedy_match(ious, gt_ig, dt_ids, gt_ids, iou_thrs, unmatched=-1.0):
    """Greedy matcher over one cell; numpy host path.

    Args:
      ious: ``[D, G]`` IoU matrix, detections already score-sorted and gts
        already ignore-last sorted (the caller permutes, as the reference
        does at ``eval.py:371-383``).
      gt_ig: ``[G]`` 0/1 ignore flags (post-permutation).
      dt_ids: ``[D]`` ids stored into ``gt_m`` on match.
      gt_ids: ``[G]`` ids stored into ``dt_m`` on match.
      iou_thrs: ``[T]`` IoU thresholds.
      unmatched: sentinel for unmatched entries; the reference uses ``-1``
        in TaoEval (``eval.py:390-391``) and ``0`` in LVISEval
        (``lvis_amodal/eval.py:239-240``).

    Returns:
      ``(dt_m[T, D], gt_m[T, G], dt_ig_from_match[T, D])`` — matched ids
      (or the sentinel) and, for matched dts, the ignore flag of their gt.
    """
    ious = np.asarray(ious, dtype=np.float64)
    gt_ig = np.asarray(gt_ig)
    dt_ids = np.asarray(dt_ids, dtype=np.float64)
    gt_ids = np.asarray(gt_ids, dtype=np.float64)
    iou_thrs = np.asarray(iou_thrs, dtype=np.float64)

    T = len(iou_thrs)
    D, G = ious.shape
    dt_m = np.full((T, D), unmatched, dtype=np.float64)
    gt_m = np.full((T, G), unmatched, dtype=np.float64)
    dt_igm = np.zeros((T, D), dtype=np.float64)
    if D == 0 or G == 0:
        return dt_m, gt_m, dt_igm

    thr = np.minimum(iou_thrs, _EPS_CAP)[:, None]  # [T,1]

    # Fast path for the (very common) single-gt cell: per threshold the
    # first score-ordered detection clearing it takes the gt.  Only
    # valid when ids are positive (the ``> 0`` matched-test quirk can't
    # fire) — exact otherwise.
    if G == 1 and gt_ig[0] == 0 and dt_ids.min() > 0:
        ok = ious[:, 0][None, :] >= thr            # [T, D]
        has = ok.any(axis=1)
        first = ok.argmax(axis=1)
        t_idx = np.nonzero(has)[0]
        d_idx = first[t_idx]
        dt_m[t_idx, d_idx] = gt_ids[0]
        gt_m[t_idx, 0] = dt_ids[d_idx]
        return dt_m, gt_m, dt_igm

    is_real = (gt_ig == 0)[None, :]                # [1,G]
    # Detections that cannot clear the lowest threshold never match at
    # any threshold; skip them wholesale (big win on sparse matrices).
    row_max = ious.max(axis=1)
    thr_min = thr.min()
    for d in range(D):
        if row_max[d] < thr_min:
            continue
        row = ious[d][None, :]                     # [1,G]
        avail = ~(gt_m > 0)                        # [T,G]  (the ``> 0`` quirk)
        cand = avail & (row >= thr)                # [T,G]
        real = cand & is_real
        ignored = cand & ~is_real

        # argmax with LAST-index tie-break (reverse trick); -inf rows
        # yield garbage indices but are masked off by ``has_*`` below.
        def _last_argmax(mask):
            vals = np.where(mask, ious[d][None, :], -np.inf)
            return G - 1 - np.argmax(vals[:, ::-1], axis=1)

        m_real = _last_argmax(real)
        has_real = real.any(axis=1)
        m_ign = _last_argmax(ignored)
        has_ign = ignored.any(axis=1)

        m = np.where(has_real, m_real, m_ign)
        has = has_real | has_ign

        t_idx = np.nonzero(has)[0]
        if t_idx.size:
            g_idx = m[t_idx]
            dt_m[t_idx, d] = gt_ids[g_idx]
            gt_m[t_idx, g_idx] = dt_ids[d]
            dt_igm[t_idx, d] = gt_ig[g_idx]
    return dt_m, gt_m, dt_igm


def greedy_match_torch(ious, gt_ig, dt_ids, gt_ids, iou_thrs,
                       dt_valid=None, gt_valid=None, unmatched=-1.0):
    """Greedy matcher over a batch of cells on their tensors' device.

    Same semantics as :func:`greedy_match` (and the JAX package's
    ``greedy_match_jax``), in float32 on padded shapes: padded
    detections/gts are masked by ``dt_valid``/``gt_valid`` and produce
    sentinel outputs.  Every argument but ``iou_thrs`` may carry the same
    leading batch axes ``B...`` (cells, videos); they broadcast.

    Args:
      ious: ``[B..., D, G]``.
      gt_ig: ``[B..., G]`` 0/1; dt_ids ``[B..., D]``; gt_ids ``[B..., G]``.
      iou_thrs: ``[T]``.
      dt_valid: ``[B..., D]`` bool; gt_valid ``[B..., G]`` bool.

    Returns ``(dt_m [B..., T, D], gt_m [B..., T, G], dt_igm [B..., T,
    D])``, float32.

    The D steps run in order, each one batched update of every cell and
    threshold.  Steps past the last slot any cell holds a valid
    detection in change nothing and are skipped (one host read of
    ``dt_valid``).  The gt axis is reversed once up front, so the
    first-index ``argmax`` picks the LAST index of the original order.
    """
    f32 = torch.float32
    ious = ious.to(f32)
    D, G = ious.shape[-2:]
    dev = ious.device
    dt_valid = (torch.ones(D, dtype=torch.bool, device=dev)
                if dt_valid is None else dt_valid.to(torch.bool))
    gt_valid = (torch.ones(G, dtype=torch.bool, device=dev)
                if gt_valid is None else gt_valid.to(torch.bool))
    gt_ig = gt_ig.to(f32).flip(-1)
    gt_ids = gt_ids.to(f32).flip(-1)
    gt_valid = gt_valid.flip(-1)
    ious = ious.flip(-1)
    dt_ids = dt_ids.to(f32)
    thr = iou_thrs.to(f32).clamp(max=_EPS_CAP)[:, None]      # [T, 1]

    # numpy's, not torch.broadcast_shapes: its first call imports sympy.
    batch = np.broadcast_shapes(
        ious.shape[:-2], gt_ig.shape[:-1], gt_ids.shape[:-1],
        gt_valid.shape[:-1], dt_ids.shape[:-1], dt_valid.shape[:-1])
    T = thr.shape[0]
    # [B..., 1, G]: broadcast against the thresholds' axis.
    is_real = ((gt_ig == 0) & gt_valid).unsqueeze(-2)
    gt_valid = gt_valid.unsqueeze(-2)
    gt_ids = gt_ids.expand(*batch, G).unsqueeze(-2).expand(*batch, T, G)
    gt_ig = gt_ig.expand(*batch, G).unsqueeze(-2).expand(*batch, T, G)
    g_rev = torch.arange(G, device=dev)
    gt_match = torch.full((*batch, T, G), unmatched, dtype=f32, device=dev)
    dt_m = torch.full((*batch, T, D), unmatched, dtype=f32, device=dev)
    dt_igm = torch.zeros((*batch, T, D), dtype=f32, device=dev)

    steps = dt_valid.reshape(-1, D).any(0).nonzero()
    steps = int(steps[-1]) + 1 if len(steps) and G else 0
    neg_inf = torch.tensor(-torch.inf, dtype=f32, device=dev)
    for d in range(steps):
        row = ious[..., d, :].unsqueeze(-2)                  # [B..., 1, G]
        cand = (~(gt_match > 0) & gt_valid & (row >= thr)
                & dt_valid[..., d, None, None])              # [B..., T, G]
        real = cand & is_real
        ignored = cand & ~is_real
        m_real = torch.where(real, row, neg_inf).argmax(-1, keepdim=True)
        m_ign = torch.where(ignored, row, neg_inf).argmax(-1, keepdim=True)
        has_real = real.any(-1, keepdim=True)
        has = has_real | ignored.any(-1, keepdim=True)       # [B..., T, 1]
        m = torch.where(has_real, m_real, m_ign)
        dt_m[..., d] = torch.where(has, gt_ids.gather(-1, m),
                                   unmatched).squeeze(-1)
        dt_igm[..., d] = torch.where(has, gt_ig.gather(-1, m),
                                     0.0).squeeze(-1)
        gt_match = torch.where(has & (g_rev == m),
                               dt_ids[..., d, None, None], gt_match)
    return dt_m, gt_match.flip(-1), dt_igm
