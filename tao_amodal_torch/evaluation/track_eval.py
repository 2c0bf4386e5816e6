"""Track-mAP (federated, 3D-IoU) evaluator.

The port's copy of ``tao_amodal_tpu/evaluation/track_eval.py``, the
float64 host oracle: a metric-parity rebuild of the reference ``TaoEval``
(``tao_amodal/evaluation/tao_amodal/eval.py:120-718``) with a different
engine: instead of a Python triple loop per (video, category) cell, each
video's tracks are padded onto a shared frame axis and the whole
dt x gt track-IoU matrix comes out of one vectorized contraction
(:func:`tao_amodal_torch.ops.track_iou.track_iou_matrix`); greedy
matching is the vectorized :func:`tao_amodal_torch.ops.matching.greedy_match`;
precision/recall accumulation is :func:`tao_amodal_torch.ops.pr.pr_curves`.

Protocol details preserved exactly (same numbers out):
  * federated filtering by neg/not-exhaustive category lists
    (reference ``eval.py:209-233``);
  * per-range gt ignore flags incl. the "highly-and-partially-occluded"
    pseudo area range gated on > 5 frames with visibility < 0.8
    (``eval.py:358-368``);
  * stable (mergesort) score ordering everywhere;
  * ``-1`` unmatched sentinels and the ``gt_m > 0`` matched test
    (``eval.py:390-428``);
  * unmatched-dt ignore mask over area/time/not-exhaustive
    (``eval.py:432-443``);
  * 101-point right-max interpolated precision/recall (``eval.py:553-573``);
  * summary keys, template, and ``print_results`` formatting
    (``eval.py:625-712``).
"""

from __future__ import annotations

import datetime
import logging
from collections import OrderedDict, defaultdict

import numpy as np

from tao_amodal_torch.data.results import TaoResultsDataset
from tao_amodal_torch.data.tao import TaoDataset
from tao_amodal_torch.evaluation.params import TrackEvalParams
from tao_amodal_torch.ops.matching import greedy_match
from tao_amodal_torch.ops.pr import pr_curves
from tao_amodal_torch.ops.track_iou import (
    track_iou_matrix,
    track_mask_iou_matrix,
)


class TrackMapEvaluator:
    """Drop-in equivalent of the reference ``TaoEval``."""

    def __init__(self, tao_gt, tao_dt, logger=None, iou_type="bbox",
                 iou_3d_type="3d_iou"):
        if not logger:
            self.logger = logging.getLogger("tao.eval")
        elif isinstance(logger, str):
            self.logger = logging.getLogger(logger)
        else:
            self.logger = logger

        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"iou_type: {iou_type} is not supported.")
        # segm mode: mask-based track IoU. NB the reference's own segm
        # branch is non-functional (it unpacks RLE dicts as xywh boxes,
        # ``eval.py:306-335`` -> ``eval.py:27-48``); here the mode works,
        # implementing the YTVIS mask-3D-IoU semantics that branch is
        # "modified from" (see ops.track_iou.track_mask_iou_matrix).

        if isinstance(tao_gt, TaoDataset):
            self.tao_gt = tao_gt
        elif isinstance(tao_gt, (str, dict)):
            self.tao_gt = TaoDataset(tao_gt)
        else:
            raise TypeError(
                f"Unsupported type {type(tao_gt)} of tao_gt.")

        if isinstance(tao_dt, TaoResultsDataset):
            self.tao_dt = tao_dt
        elif isinstance(tao_dt, (str, list)):
            self.tao_dt = TaoResultsDataset(self.tao_gt, tao_dt)
        else:
            raise TypeError(f"Unsupported type {tao_dt} of tao_dt.")

        self.params = TrackEvalParams(iou_type=iou_type,
                                      iou_3d_type=iou_3d_type)
        self.params.vid_ids = sorted(self.tao_gt.get_vid_ids())
        self.params.cat_ids = sorted(self.tao_gt.get_cat_ids())

        self.results = OrderedDict()
        self.eval = {}
        self._cells = {}      # (vid_id, cat_id) -> cell arrays
        self.eval_vids = {}   # (c, a, t) -> results in video order
        self.ious = {}        # (vid_id, cat_id) -> [D, G] matrix

    # ------------------------------------------------------------------
    # Cell construction
    # ------------------------------------------------------------------

    def _grouped_tracks(self):
        """Federated-filtered gt/dt tracks grouped per (video, category).

        Mirrors reference ``_prepare`` (``eval.py:178-233``): dts whose
        category is neither present in the video's gt nor in its negative
        list are dropped; ``vid_nel`` drives the unmatched-dt ignore mask
        later.
        """
        p = self.params
        cat_ids = p.cat_ids if p.cat_ids else None
        gt_anns = self.tao_gt.load_anns(
            self.tao_gt.get_ann_ids(vid_ids=p.vid_ids, cat_ids=cat_ids))
        dt_anns = self.tao_dt.load_anns(
            self.tao_dt.get_ann_ids(vid_ids=p.vid_ids, cat_ids=cat_ids))
        if not gt_anns:
            raise ValueError(
                "Found no groundtruth annotations for given params")
        if not dt_anns:
            raise ValueError("Found no predicted annotations for given params")

        if p.iou_type == "segm":
            # Convert every annotation to compressed RLE up front
            # (reference ``_to_mask``, ``eval.py:173-176,194-197``).
            for ann in gt_anns:
                ann["segmentation"] = self.tao_gt.ann_to_rle(ann)
            for ann in dt_anns:
                ann["segmentation"] = self.tao_dt.ann_to_rle(ann)

        gts = self.tao_gt.group_ann_tracks(gt_anns)
        dts = self.tao_dt.group_ann_tracks(dt_anns)
        for gt in gts:
            gt.setdefault("ignore", 0)

        vid_data = self.tao_gt.load_vids(ids=p.vid_ids)
        vid_nl = {d["id"]: d["neg_category_ids"] for d in vid_data}
        vid_pl = defaultdict(set)
        for track in gts:
            vid_pl[track["video_id"]].add(track["category_id"])
        self.vid_nel = {
            d["id"]: d["not_exhaustive_category_ids"] for d in vid_data
        }

        gt_cells = defaultdict(list)
        for gt in gts:
            gt_cells[gt["video_id"], gt["category_id"]].append(gt)
        dt_cells = defaultdict(list)
        for dt in dts:
            vid_id, cat_id = dt["video_id"], dt["category_id"]
            if (p.use_cats and cat_id not in vid_nl[vid_id]
                    and cat_id not in vid_pl[vid_id]):
                continue
            dt_cells[vid_id, cat_id].append(dt)
        return gt_cells, dt_cells

    @staticmethod
    def _track_columns(tracks, fidx, dtype=np.float64):
        """Pad one cell's tracks over the video frame axis.

        Later annotations on the same image overwrite earlier ones,
        matching the reference dict-comprehension collapse
        (``eval.py:322-325``).
        """
        T, F = len(tracks), len(fidx)
        boxes = np.zeros((T, F, 4), dtype=dtype)
        valid = np.zeros((T, F), dtype=bool)
        for t, track in enumerate(tracks):
            for ann in track["annotations"]:
                f = fidx[ann["image_id"]]
                boxes[t, f] = ann["bbox"]
                valid[t, f] = True
        return boxes, valid

    @staticmethod
    def _track_rle_columns(tracks, fidx):
        """Segm-mode analogue of :meth:`_track_columns`: ``[T][F]``
        nested lists of RLE dicts (``None`` = absent), same
        later-annotation-overwrites semantics."""
        T, F = len(tracks), len(fidx)
        rles = [[None] * F for _ in range(T)]
        for t, track in enumerate(tracks):
            for ann in track["annotations"]:
                rles[t][fidx[ann["image_id"]]] = ann["segmentation"]
        return rles

    def _build_cells(self):
        """Materialize per-cell arrays + the per-cell IoU matrices."""
        p = self.params
        gt_cells, dt_cells = self._grouped_tracks()
        cat_ids = p.cat_ids if p.use_cats else [-1]
        if not p.use_cats:
            # Category-agnostic mode: merge every category into one
            # pseudo-cell per video (reference ``_get_gt_dt`` else
            # branch, eval.py:293-304).
            def merge(cells):
                merged = defaultdict(list)
                vids = {vid for vid, _ in cells}
                for vid in vids:
                    for cat in p.cat_ids:  # reference cat order
                        merged[vid, -1].extend(cells.get((vid, cat),
                                                         ()))
                return merged

            gt_cells, dt_cells = merge(gt_cells), merge(dt_cells)

        # Per-video frame index over images annotated in either side.
        vid_frames = defaultdict(set)
        for (vid_id, _), tracks in list(gt_cells.items()) + \
                list(dt_cells.items()):
            for tr in tracks:
                for ann in tr["annotations"]:
                    vid_frames[vid_id].add(ann["image_id"])

        self._cells = {}
        self.ious = {}
        for vid_id in p.vid_ids:
            fidx = {f: i for i, f in enumerate(sorted(vid_frames[vid_id]))}
            for cat_id in cat_ids:
                gt = gt_cells.get((vid_id, cat_id), [])
                dt = dt_cells.get((vid_id, cat_id), [])
                if not gt and not dt:
                    continue
                # Score-sort detections (stable, high first) before IoU,
                # as the reference does (``eval.py:313``).
                order = np.argsort([-d["score"] for d in dt],
                                   kind="mergesort")
                dt = [dt[i] for i in order]

                if p.iou_type == "segm":
                    ious = np.asarray(track_mask_iou_matrix(
                        self._track_rle_columns(dt, fidx),
                        self._track_rle_columns(gt, fidx),
                        mode=p.iou_3d_type), dtype=np.float64)
                else:
                    d_boxes, d_valid = self._track_columns(dt, fidx)
                    g_boxes, g_valid = self._track_columns(gt, fidx)
                    ious = np.asarray(track_iou_matrix(
                        d_boxes, d_valid, g_boxes, g_valid,
                        mode=p.iou_3d_type), dtype=np.float64)

                hp = [
                    sum(a["visibility"] < p.hp_visibility_thr
                        for a in g["annotations"]) for g in gt
                ]
                cell = {
                    "gt_ids": np.array([g["id"] for g in gt], np.float64),
                    "gt_area": np.array([g["area"] for g in gt], np.float64),
                    "gt_dur": np.array([len(g["annotations"]) for g in gt],
                                       np.float64),
                    "gt_hp_frames": np.array(hp, np.float64),
                    "gt_ignore0": np.array([g["ignore"] for g in gt],
                                           np.float64),
                    "dt_ids": np.array([d["id"] for d in dt], np.float64),
                    "dt_area": np.array([d["area"] for d in dt], np.float64),
                    "dt_dur": np.array([len(d["annotations"]) for d in dt],
                                       np.float64),
                    "dt_scores": np.array([d["score"] for d in dt],
                                          np.float64),
                    "dt_nel": np.array([
                        d["category_id"] in self.vid_nel[d["video_id"]]
                        for d in dt], bool),
                    "ious": ious,
                }
                self._cells[vid_id, cat_id] = cell
                self.ious[vid_id, cat_id] = ious

    # ------------------------------------------------------------------
    # Per-range matching
    # ------------------------------------------------------------------

    def _match_cell_ranges(self, cell):
        """Match one cell across ALL (area, time) ranges at once.

        The per-range inputs to the matcher are just two boolean
        vectors (gt ignore, dt ignore-mask); they're computed for all
        ranges in one broadcast, deduplicated (most ranges collapse to
        the same signature), and each unique signature is matched once.
        Returns ``{(a, t): result}``.
        """
        p = self.params
        area = np.asarray(p.area_rng, np.float64)   # [A, 2]
        time = np.asarray(p.time_rng, np.float64)   # [Tm, 2]
        A, Tm = len(area), len(time)

        g_area = cell["gt_area"]
        g_dur = cell["gt_dur"]
        gt_ig = ((cell["gt_ignore0"] != 0)[None, None, :]
                 | (g_area[None, None, :] < area[:, None, 0:1])
                 | (g_area[None, None, :] > area[:, None, 1:2])
                 | (g_dur[None, None, :] < time[None, :, 0:1])
                 | (g_dur[None, None, :] > time[None, :, 1:2]))
        # HP pseudo-range (last area index) adds the occlusion gate.
        gt_ig[A - 1] |= (cell["gt_hp_frames"]
                         <= p.hp_min_frames - 1)[None, :]

        d_area = cell["dt_area"]
        d_dur = cell["dt_dur"]
        dt_mask = ((d_area[None, None, :] < area[:, None, 0:1])
                   | (d_area[None, None, :] > area[:, None, 1:2])
                   | (d_dur[None, None, :] < time[None, :, 0:1])
                   | (d_dur[None, None, :] > time[None, :, 1:2])
                   | cell["dt_nel"][None, None, :])

        G = gt_ig.shape[-1]
        flat = np.concatenate(
            [gt_ig.reshape(A * Tm, -1), dt_mask.reshape(A * Tm, -1)],
            axis=1)
        _, first_idx, inverse = np.unique(
            flat, axis=0, return_index=True, return_inverse=True)
        memo = {}
        out = {}
        for k, (a, t) in enumerate(
                (a, t) for a in range(A) for t in range(Tm)):
            sig = inverse[k]
            if sig not in memo:
                memo[sig] = self._match_cell_signed(
                    cell, gt_ig[a, t], dt_mask[a, t])
            out[a, t] = memo[sig]
        return out

    def _match_cell_signed(self, cell, gt_ignore, dt_ig_mask):
        """One cell match for a precomputed ignore signature, all
        thresholds (HP occlusion gate already folded into
        ``gt_ignore`` — reference ``eval.py:358-368``)."""
        p = self.params
        gt_ig = gt_ignore.astype(np.float64)

        # gts sorted ignore-last (stable).
        order = np.argsort(gt_ig, kind="mergesort")
        gt_ig = gt_ig[order]
        gt_ids = cell["gt_ids"][order]
        ious = cell["ious"][:, order] if cell["ious"].size else cell["ious"]

        num_dt = len(cell["dt_ids"])
        if cell["ious"].shape[0] and cell["ious"].shape[1]:
            dt_m, gt_m, dt_igm = greedy_match(
                ious, gt_ig, cell["dt_ids"], gt_ids, p.iou_thrs,
                unmatched=-1.0)
        else:
            T = len(p.iou_thrs)
            dt_m = np.full((T, num_dt), -1.0)
            gt_m = np.full((T, len(gt_ids)), -1.0)
            dt_igm = np.zeros((T, num_dt))

        dt_ig = np.logical_or(
            dt_igm, np.logical_and(dt_m == -1, dt_ig_mask[None, :]))

        return {
            "dt_ids": cell["dt_ids"],
            "gt_ids": gt_ids,
            "dt_matches": dt_m,
            "gt_matches": gt_m,
            "dt_scores": cell["dt_scores"],
            "gt_ignore": gt_ig,
            "dt_ignore": dt_ig,
        }

    def evaluate(self, show_progress=False):
        """Per-video evaluation over all (cat, area, time) ranges."""
        del show_progress
        self.logger.info("Running per video evaluation.")
        self.logger.info(
            "Evaluate annotation type *{}*".format(self.params.iou_type))
        p = self.params
        p.vid_ids = list(np.unique(p.vid_ids))
        cat_ids = p.cat_ids if p.use_cats else [-1]

        self._build_cells()

        n_area = len(p.area_rng)
        n_time = len(p.time_rng)
        # Sparse per-(c, a, t) result lists in video order (absent
        # cells are simply never appended): at real TAO scale a dense
        # (videos x cats x ranges) structure is hundreds of millions of
        # mostly-None entries.
        self.eval_vids = defaultdict(list)
        for v, vid_id in enumerate(p.vid_ids):
            for c, cat_id in enumerate(cat_ids):
                cell = self._cells.get((vid_id, cat_id))
                if cell is None:
                    continue
                results = self._match_cell_ranges(cell)
                for a in range(n_area):
                    for t in range(n_time):
                        self.eval_vids[c, a, t].append(results[a, t])

    # ------------------------------------------------------------------
    # Accumulation + summary
    # ------------------------------------------------------------------

    def accumulate(self):
        self.logger.info("Accumulating evaluation results.")
        if not self.eval_vids:
            self.logger.warning("Please run evaluate first.")
        p = self.params
        cat_ids = p.cat_ids if p.use_cats else [-1]

        num_thrs = len(p.iou_thrs)
        num_recalls = len(p.rec_thrs)
        num_cats = len(cat_ids)
        num_area = len(p.area_rng)
        num_time = len(p.time_rng)
        num_vids = len(p.vid_ids)

        precision = -np.ones(
            (num_thrs, num_recalls, num_cats, num_area, num_time))
        recall = -np.ones((num_thrs, num_cats, num_area, num_time))
        # Per-cell analysis pointers (reference ``eval.py:533-537``).
        dt_pointers = {c: {a: {t: {} for t in range(num_time)}
                           for a in range(num_area)}
                       for c in range(num_cats)}

        del num_vids
        for c in range(num_cats):
            for a in range(num_area):
                for t in range(num_time):
                    E = self.eval_vids.get((c, a, t), ())
                    if not E:
                        continue
                    scores = np.concatenate([e["dt_scores"] for e in E])
                    order = np.argsort(-scores, kind="mergesort")
                    dt_m = np.concatenate(
                        [e["dt_matches"] for e in E], axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [e["dt_ignore"] for e in E], axis=1)[:, order]
                    gt_ig = np.concatenate([e["gt_ignore"] for e in E])
                    num_gt = np.count_nonzero(gt_ig == 0)
                    if num_gt == 0:
                        continue
                    tps = np.logical_and(dt_m != -1, np.logical_not(dt_ig))
                    fps = np.logical_and(dt_m == -1, np.logical_not(dt_ig))
                    dt_ids = (np.concatenate(
                        [e["dt_ids"] for e in E])[order]
                        if all("dt_ids" in e for e in E) else None)
                    dt_pointers[c][a][t] = {
                        "dt_ids": dt_ids, "tps": tps, "fps": fps,
                    }
                    prec, rec = pr_curves(tps, fps, num_gt, p.rec_thrs)
                    precision[:, :, c, a, t] = prec
                    recall[:, c, a, t] = rec

        self.eval = {
            "params": p,
            "counts": [num_thrs, num_recalls, num_cats, num_area, num_time],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision,
            "recall": recall,
            "dt_pointers": dt_pointers,
        }

    def _summarize(self, summary_type, iou_thr=None, area_rng="all",
                   time_rng="all"):
        p = self.params
        aidx = [i for i, lbl in enumerate(p.area_rng_lbl) if lbl == area_rng]
        tidx = [i for i, lbl in enumerate(p.time_rng_lbl) if lbl == time_rng]
        if summary_type == "ap":
            s = self.eval["precision"]
            if iou_thr is not None:
                s = s[np.where(iou_thr == p.iou_thrs)[0]]
            s = s[:, :, :, aidx, tidx]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                s = s[np.where(iou_thr == p.iou_thrs)[0]]
            s = s[:, :, aidx, tidx]
        if len(s[s > -1]) == 0:
            return -1
        return np.mean(s[s > -1])

    def summarize(self):
        if not self.eval:
            raise RuntimeError("Please run accumulate() first.")
        max_dets = self.params.max_dets
        hp = "highly-and-partially-occluded"

        self.results["AP"] = self._summarize("ap")
        self.results["AP50"] = self._summarize("ap", iou_thr=0.50)
        self.results["AP75"] = self._summarize("ap", iou_thr=0.75)
        self.results["AP-HP"] = self._summarize("ap", area_rng=hp)
        self.results["AP50-HP"] = self._summarize("ap", area_rng=hp,
                                                  iou_thr=0.50)
        self.results["AP75-HP"] = self._summarize("ap", area_rng=hp,
                                                  iou_thr=0.75)
        for area_rng in ("small", "medium", "large"):
            self.results[("AP", "area", area_rng, max_dets)] = (
                self._summarize("ap", area_rng=area_rng))
        for time_rng in ("short", "medium", "long"):
            self.results[("AP", "time", time_rng, max_dets)] = (
                self._summarize("ap", time_rng=time_rng))
        self.results[f"AR@{max_dets}"] = self._summarize("ar")
        for area_rng in ("small", "medium", "large"):
            self.results[("AR", "area", area_rng, max_dets)] = (
                self._summarize("ar", area_rng=area_rng))
        for time_rng in ("short", "medium", "long"):
            self.results[("AR", "time", time_rng, max_dets)] = (
                self._summarize("ar", time_rng=time_rng))

    def run(self, show_progress=False):
        self.evaluate(show_progress=show_progress)
        self.accumulate()
        self.summarize()

    def print_results(self):
        template = (
            " {:<18} {}"
            " @[ IoU={:<9} | area={:>6s} | dur={:>6s} | maxDets={:>3d} "
            "catIds={:>3s}] ="
            " {:0.3f}"
        )
        for key, value in self.results.items():
            max_dets = self.params.max_dets
            if "AP" in key:
                title, _type = "Average Precision", "(AP)"
            else:
                title, _type = "Average Recall", "(AR)"
            area_rng = "all"
            time_rng = "all"
            if isinstance(key, tuple):
                subset_type, subset_rng, max_dets = key[1:]
                if subset_type == "time":
                    time_rng = subset_rng[0]
                elif subset_type == "area":
                    area_rng = subset_rng[0]
                else:
                    raise ValueError("This should not happen")
            if len(key) > 2 and key[2].isdigit():
                iou = "{:0.2f}".format(float(key[2:4]) / 100)
            else:
                iou = "{:0.2f}:{:0.2f}".format(self.params.iou_thrs[0],
                                               self.params.iou_thrs[-1])
            if len(key) > 2 and key[2] in ("r", "c", "f"):
                cat_group_name = key[2]
            else:
                cat_group_name = "all"
            self.logger.info(template.format(
                title, _type, iou, area_rng, time_rng, max_dets,
                cat_group_name, value))

    def get_results(self):
        if not self.results:
            self.logger.warning("results is empty. Call run().")
        return self.results
