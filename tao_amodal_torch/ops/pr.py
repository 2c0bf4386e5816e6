"""Precision/recall accumulation as array ops.

Replaces the reference's per-threshold Python loops
(``tao_amodal/evaluation/tao_amodal/eval.py:539-573`` and
``lvis_amodal/eval.py:382-417``) with vectorized numpy/XLA-style math:

  * cumulative TP/FP via ``cumsum``;
  * the right-to-left "max precision to the right" interpolation loop is
    exactly a reversed ``np.maximum.accumulate``;
  * sampling precision at the 101 recall points via ``searchsorted`` with
    out-of-range indices mapping to 0.0 (the reference achieves this with
    an IndexError swallowed by a bare ``except`` — once an insert index
    walks past the end every later one does too, so elementwise
    ``where(idx < n, pr[idx], 0)`` is equivalent).
"""

from __future__ import annotations

import numpy as np


def pr_curves(tps, fps, num_gt, rec_thrs):
    """Precision/recall summary for one (category, range) slice.

    Args:
      tps: ``[T, N]`` bool — true-positive flags per IoU threshold, with N
        detections already globally score-sorted.
      fps: ``[T, N]`` bool — false-positive flags.
      num_gt: number of non-ignored gts.
      rec_thrs: ``[R]`` recall sample points.

    Returns:
      ``(precision[T, R], recall[T])`` matching the reference's
      per-threshold results (recall = final recall, 0 when N == 0).
    """
    tps = np.asarray(tps)
    fps = np.asarray(fps)
    T, N = tps.shape
    R = len(rec_thrs)
    precision = np.zeros((T, R), dtype=np.float64)
    recall = np.zeros((T,), dtype=np.float64)
    if N == 0:
        return precision, recall

    tp = np.cumsum(tps, axis=1).astype(np.float64)
    fp = np.cumsum(fps, axis=1).astype(np.float64)

    rc = tp / num_gt                                  # [T, N]
    recall[:] = rc[:, -1]
    pr = tp / (fp + tp + np.spacing(1))               # [T, N]

    # Right-max interpolation == reversed cumulative max
    # (reference ``eval.py:557-559``).
    pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]

    # Sample at recall thresholds; searchsorted per threshold row.
    for t in range(T):
        idx = np.searchsorted(rc[t], rec_thrs, side="left")
        valid = idx < N
        precision[t, valid] = pr[t, idx[valid]]
    return precision, recall
