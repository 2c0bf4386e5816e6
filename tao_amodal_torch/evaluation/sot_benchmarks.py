"""SOT benchmark metrics: OPE success/precision, VOT EAO/A-R, F1.

The port's numpy copy of ``tao_amodal_tpu/evaluation/sot_benchmarks.py``
(the reference toolkit's ``ope``/``eao``/``ar``/``f1`` benchmarks and its
statistics kernels), float64 on the host.  Polygon (rotated-box)
overlaps go through the port's host library
(:mod:`tao_amodal_torch.native.lib`, ``region.cc``).
"""

from __future__ import annotations

import numpy as np

from tao_amodal_torch.native.lib import load as _load


def overlap_ratio(rect1, rect2):
    """IoU between ``[T, 4]`` xywh trajectories (reference
    ``statistics.py:overlap_ratio``)."""
    rect1 = np.atleast_2d(np.asarray(rect1, np.float64))
    rect2 = np.atleast_2d(np.asarray(rect2, np.float64))
    left = np.maximum(rect1[:, 0], rect2[:, 0])
    right = np.minimum(rect1[:, 0] + rect1[:, 2],
                       rect2[:, 0] + rect2[:, 2])
    top = np.maximum(rect1[:, 1], rect2[:, 1])
    bottom = np.minimum(rect1[:, 1] + rect1[:, 3],
                        rect2[:, 1] + rect2[:, 3])
    inter = np.maximum(right - left, 0) * np.maximum(bottom - top, 0)
    union = (rect1[:, 2] * rect1[:, 3] + rect2[:, 2] * rect2[:, 3]
             - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def success_overlap(gt, pred, n_frame=None):
    """Success curve over 21 overlap thresholds (OPE success AUC
    input; reference ``statistics.py:success_overlap``)."""
    if n_frame is None:
        n_frame = len(gt)
    thresholds = np.arange(0, 1.05, 0.05)
    mask = np.asarray(gt)[:, 2] > 0
    iou = np.full(len(gt), -1.0)
    iou[mask] = overlap_ratio(np.asarray(gt)[mask],
                              np.asarray(pred)[mask])
    return np.array([np.sum(iou > t) / n_frame for t in thresholds])


def success_error(gt_center, pred_center, thresholds, n_frame=None):
    """Precision curve over center-distance thresholds (reference
    ``statistics.py:success_error``)."""
    if n_frame is None:
        n_frame = len(gt_center)
    dist = np.sqrt(np.sum(
        (np.asarray(gt_center) - np.asarray(pred_center)) ** 2, axis=1))
    return np.array([np.sum(dist <= t) / n_frame for t in thresholds])


def center_of(rects):
    r = np.asarray(rects, np.float64)
    return np.stack([r[:, 0] + (r[:, 2] - 1) / 2,
                     r[:, 1] + (r[:, 3] - 1) / 2], axis=1)


class OPEBenchmark:
    """One-pass evaluation: success AUC + precision@20px.

    Capability of reference ``ope_benchmark.py:23-122``.  ``dataset``
    maps sequence name -> dict with ``gt_traj [T, 4]`` and per-tracker
    ``pred_traj [T, 4]``.
    """

    def __init__(self, dataset):
        self.dataset = dataset

    def eval_success(self, tracker_names):
        out = {}
        for name in tracker_names:
            out[name] = {
                seq: success_overlap(d["gt_traj"],
                                     d["pred_trajs"][name])
                for seq, d in self.dataset.items()
                if name in d["pred_trajs"]
            }
        return out

    def eval_precision(self, tracker_names, max_dist=50):
        thresholds = np.arange(0, max_dist + 1)
        out = {}
        for name in tracker_names:
            res = {}
            for seq, d in self.dataset.items():
                if name not in d["pred_trajs"]:
                    continue
                res[seq] = success_error(
                    center_of(d["gt_traj"]),
                    center_of(d["pred_trajs"][name]), thresholds)
            out[name] = res
        return out

    def show_result(self, success, precision=None):
        lines = []
        for name, seqs in sorted(
                success.items(),
                key=lambda kv: -np.mean([v.mean()
                                        for v in kv[1].values()])):
            auc = np.mean([v.mean() for v in seqs.values()])
            line = f"{name:<20s} success(AUC): {auc:.3f}"
            if precision and name in precision:
                p20 = np.mean([v[20] for v in precision[name].values()])
                line += f"  precision@20: {p20:.3f}"
            lines.append(line)
        return "\n".join(lines)


def calculate_accuracy(pred, gt, burnin=10, ignore_unknown=True,
                       bound=None):
    """Mean overlap excluding ``burnin`` frames after each
    (re-)initialization (VOT accuracy; reference
    ``statistics.py:calculate_accuracy`` capability).

    ``pred`` entries: [x,y,w,h] boxes, [1.0] init markers, [2.0]
    failure markers, [0.0] skip markers.
    """
    overlaps = []
    skip_until = -1
    for i, p in enumerate(pred):
        if len(p) == 1:
            if p[0] == 1.0:  # init frame
                skip_until = i + burnin
            continue
        if i < skip_until:
            continue
        overlaps.append(float(overlap_ratio(
            np.asarray([gt[i]]), np.asarray([p]))[0]))
    return (np.mean(overlaps) if overlaps else 0.0), len(overlaps)


def calculate_failures(trajectory):
    """Count VOT failure markers ([2.0] entries) (reference
    ``statistics.py:calculate_failures``)."""
    failures = [i for i, p in enumerate(trajectory)
                if len(p) == 1 and p[0] == 2.0]
    return len(failures), failures


def trajectory_overlaps(pred, gt, bound=None):
    """Per-frame overlaps for a VOT-style trajectory, ``NaN`` at marker
    frames ([1] init / [2] failure / [0] skip).

    The per-frame overlap list the reference gets from
    ``region.vot_overlap_traj`` inside ``calculate_accuracy``
    (``statistics.py:20-55`` with ``burnin=0``, as the EAO path calls
    it).  Rect-vs-rect goes through the vectorized ``overlap_ratio``;
    polygon entries (8+ values) go through the native VOT region
    rasterizer of the port's host library.
    """
    T = min(len(pred), len(gt))
    out = np.full(T, np.nan)
    rect_idx = [i for i in range(T) if len(pred[i]) == 4
                and len(np.atleast_1d(gt[i])) == 4]
    if rect_idx:
        p = np.asarray([pred[i] for i in rect_idx], np.float64)
        g = np.asarray([gt[i] for i in rect_idx], np.float64)
        out[rect_idx] = overlap_ratio(g, p)
    def as_poly(r):
        if len(r) == 4:
            x, y, w, h = map(float, r)
            return [x, y, x + w, y, x + w, y + h, x, y + h]
        return list(map(float, r))

    for i in range(T):
        p = np.atleast_1d(np.asarray(pred[i], np.float64))
        g = np.atleast_1d(np.asarray(gt[i], np.float64))
        if len(p) == 1 or (len(p) == 4 and len(g) == 4):
            continue
        bounds = None if bound is None else (bound[0] + 1, bound[1] + 1)
        out[i] = float(_load().polygon_overlap(
            np.asarray(as_poly(p), np.float64), as_poly(g),
            bounds=bounds))
    return out


def expected_overlap_curve(fragments, fweights):
    """Weighted expected-overlap curve over fragment prefixes.

    Vectorized form of reference
    ``statistics.py:calculate_expected_overlap:156-169``: for each
    length ``i``, the weighted mean over fragments alive at ``i`` of
    their frames ``1..i`` mean.  The reference's per-length Python loop
    becomes one cumulative sum; interior NaNs are treated as 0 exactly
    as the reference's fragment builder scrubs them.
    """
    fragments = np.asarray(fragments, np.float64)
    fweights = np.asarray(fweights, np.float64)
    N, L = fragments.shape
    expected = np.zeros(L, np.float32)
    if L == 0 or N == 0:
        return expected
    expected[0] = 1.0
    alive = ~np.isnan(fragments)                       # [N, L]
    filled = np.where(alive, fragments, 0.0)
    cs = np.cumsum(filled, axis=1)                     # [N, L]
    lengths = np.arange(1, L, dtype=np.float64)
    seq_mean = (cs[:, 1:] - cs[:, :1]) / lengths       # mean of 1..i
    w = np.where(np.isnan(fweights[:, None]), 0.0,
                 fweights[:, None]) * alive[:, 1:]
    den = w.sum(axis=0)
    num = (seq_mean * w).sum(axis=0)
    expected[1:] = np.where(den > 0, num / np.maximum(den, 1e-300), 0.0)
    return expected


class EAOBenchmark:
    """Full VOT fragment-based Expected Average Overlap.

    Reference protocol (``eao_benchmark.py:91-163``): per run, the
    overlap trajectory is segmented at failures (re-init happens
    ``skipping`` frames after each failure); non-terminal fragments are
    zero-extended (the tracker failed — overlap 0 from there on),
    terminal fragments stay NaN-padded; each fragment is weighted by
    the per-run weight times the fraction of frames carrying the
    evaluated tag; the expected-overlap curve is averaged over the
    dataset's [low, high] typical-sequence-length interval.

    ``dataset`` maps sequence name -> dict with ``gt_traj`` (list of
    per-frame boxes/polygons), ``pred_trajs`` {tracker: one run or a
    list of runs of VOT-style entries}, optional ``width``/``height``
    and per-frame ``tags`` {tag: [T] 0/1}.
    """

    INTERVALS = {  # dataset name -> (low, high) [eao_benchmark.py:17-29]
        "VOT2019": (46, 291),
        "VOT2018": (100, 356),
        "VOT2017": (100, 356),
        "VOT2016": (108, 371),
    }

    def __init__(self, dataset, low=None, high=None, name="VOT2018",
                 skipping=5, tags=("all",)):
        if low is None or high is None:
            low, high = self.INTERVALS.get(name, (100, 356))
        self.dataset = dataset
        self.low, self.high = low, high
        self.skipping = skipping
        self.tags = tuple(tags)

    def eval(self, eval_trackers):
        if isinstance(eval_trackers, str):
            eval_trackers = [eval_trackers]
        return {name: self._calculate_eao(name)
                for name in eval_trackers}

    def _select_tag(self, seq, tag, start, end):
        tags = self.dataset[seq].get("tags", {})
        if tag == "all" or tag not in tags:
            return np.ones(max(end - start, 0))
        return np.asarray(tags[tag][start:end], np.float64)

    def _runs(self, seq, tracker):
        runs = self.dataset[seq]["pred_trajs"].get(tracker)
        if runs is None:
            return []
        first = runs[0]
        if isinstance(first, (list, tuple)) and np.ndim(first[0]) == 0 \
                and not isinstance(first[0], (list, tuple)):
            return [runs]  # single run: list of per-frame entries
        if isinstance(runs, np.ndarray):
            return [list(runs)]
        return list(runs)

    def _calculate_eao(self, tracker):
        all_overlaps, all_failures = [], []
        seq_names, gt_lens = [], []
        num_runs = 1
        for seq, d in self.dataset.items():
            bound = None
            if "width" in d and "height" in d:
                bound = (d["width"] - 1, d["height"] - 1)
            runs = self._runs(seq, tracker)
            if runs:
                num_runs = len(runs)
            for traj in runs:
                gt_lens.append(len(d["gt_traj"]))
                seq_names.append(seq)
                all_overlaps.append(
                    trajectory_overlaps(traj, d["gt_traj"], bound))
                all_failures.append(calculate_failures(traj)[1])
        if not all_overlaps:
            return {tag: 0.0 for tag in self.tags}
        fragment_num = sum(len(f) + 1 for f in all_failures)
        max_len = max(len(o) for o in all_overlaps)
        # Per-run weight: the reference divides by the (constant) runs
        # per sequence of the last video [eao_benchmark.py:112].
        seq_weight = 1.0 / (num_runs + 1e-10)

        eao = {}
        for tag in self.tags:
            fweights = np.full(fragment_num, np.nan)
            fragments = np.full((fragment_num, max_len), np.nan)
            seg = 0
            for seq, traj_len, failures, overlaps in zip(
                    seq_names, gt_lens, all_failures, all_overlaps):
                if failures:
                    points = [0] + [f + self.skipping for f in failures
                                    if f + self.skipping <= len(overlaps)]
                    for i in range(len(points)):
                        if i != len(points) - 1:
                            frag = np.array(
                                overlaps[points[i]:points[i + 1] + 1])
                            fragments[seg, :] = 0.0
                            span = points[i + 1] - points[i] + 1
                            tagv = self._select_tag(
                                seq, tag, points[i], points[i + 1] + 1)
                            w = tagv.sum() / span
                        else:
                            frag = np.array(overlaps[points[i]:])
                            tagv = self._select_tag(
                                seq, tag, points[i], len(overlaps))
                            w = tagv.sum() / (traj_len - points[i]
                                              + 1e-16)
                        frag[np.isnan(frag)] = 0.0
                        fragments[seg, :len(frag)] = frag
                        fweights[seg] = seq_weight * w
                        seg += 1
                else:
                    max_idx = min(len(overlaps), max_len)
                    fragments[seg, :max_idx] = overlaps[:max_idx]
                    tagv = self._select_tag(seq, tag, 0, max_idx)
                    fweights[seg] = seq_weight * (tagv.sum() / max_idx)
                    seg += 1

            expected = expected_overlap_curve(fragments, fweights)
            weight = np.zeros(len(expected))
            weight[self.low - 1:self.high] = 1.0
            ok = ~np.isnan(expected)
            denom = weight[ok].sum()
            eao[tag] = float(
                (expected[ok] * weight[ok]).sum() / denom
                if denom > 0 else 0.0)
        return eao

    def show_result(self, result, topk=10):
        lines = []
        for name, ret in sorted(result.items(),
                                key=lambda kv: -kv[1].get("all", 0.0)
                                )[:topk]:
            vals = "  ".join(f"{t}: {v:.3f}" for t, v in ret.items())
            lines.append(f"{name:<20s} EAO {vals}")
        return "\n".join(lines)


def calculate_eao(sequence_overlaps, sequence_lengths, low, high):
    """Simplified EAO over pre-segmented overlap curves — kept for the
    quick-look path; the full fragment protocol is
    :class:`EAOBenchmark` (reference ``eao_benchmark.py:32-163``).

    Args:
      sequence_overlaps: list of per-run overlap arrays (0 after
        failure, per VOT convention).
    """
    max_len = max((len(o) for o in sequence_overlaps), default=0)
    if max_len == 0:
        return 0.0
    # Expected overlap curve: mean of running means at each length.
    curves = np.zeros((len(sequence_overlaps), max_len))
    for i, o in enumerate(sequence_overlaps):
        o = np.asarray(o, np.float64)
        ext = np.zeros(max_len)
        ext[:len(o)] = o
        curves[i] = np.cumsum(ext) / (np.arange(max_len) + 1)
    expected = curves.mean(axis=0)
    lo = max(low - 1, 0)
    hi = min(high, max_len)
    if hi <= lo:
        return float(expected[-1])
    return float(expected[lo:hi].mean())


class F1Benchmark:
    """Long-term tracking F1 (reference ``f1_benchmark.py``
    capability): precision/recall over confidence thresholds."""

    def __init__(self, dataset):
        self.dataset = dataset

    def eval(self, tracker_name, thresholds=None):
        if thresholds is None:
            thresholds = np.linspace(0, 1, 41)
        precisions = np.zeros_like(thresholds)
        recalls = np.zeros_like(thresholds)
        n_seq = 0
        for seq, d in self.dataset.items():
            if tracker_name not in d["pred_trajs"]:
                continue
            n_seq += 1
            gt = np.asarray(d["gt_traj"], np.float64)
            pred = np.asarray(d["pred_trajs"][tracker_name], np.float64)
            conf = np.asarray(d["pred_scores"][tracker_name])
            visible = gt[:, 2] > 0
            iou = overlap_ratio(gt, pred)
            for k, thr in enumerate(thresholds):
                reported = conf >= thr
                tp_overlap = np.where(reported & visible, iou, 0.0)
                precisions[k] += (tp_overlap.sum()
                                  / max(reported.sum(), 1))
                recalls[k] += tp_overlap.sum() / max(visible.sum(), 1)
        if n_seq == 0:
            return {"f1": 0.0, "precision": 0.0, "recall": 0.0}
        precisions /= n_seq
        recalls /= n_seq
        f1 = 2 * precisions * recalls / np.maximum(
            precisions + recalls, 1e-12)
        best = int(np.argmax(f1))
        return {"f1": float(f1[best]),
                "precision": float(precisions[best]),
                "recall": float(recalls[best]),
                "threshold": float(thresholds[best])}
