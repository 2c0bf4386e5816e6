"""Amodal detection AP evaluator (per-frame, visibility-range splits).

The port's copy of ``tao_amodal_tpu/evaluation/detection_eval.py``, the
float64 host oracle: a metric-parity rebuild of the reference amodal
``LVISEval`` (``tao_amodal/evaluation/lvis_amodal/eval.py``) on
vectorized kernels: per-image IoU matrices come from one broadcast op
(:func:`tao_amodal_torch.ops.boxes.box_iou_matrix`, replacing the
``mask_utils.iou`` C call at reference ``eval.py:191``), matching from
:func:`tao_amodal_torch.ops.matching.greedy_match`, precision/recall
accumulation from :func:`tao_amodal_torch.ops.pr.pr_curves`.

Protocol preserved exactly:
  * visibility ranges all/HO/PO/HV/HP plus the out-of-frame pseudo-range
    (``Params`` at reference ``eval.py:567-575``; OOF gating at
    ``eval.py:209-217``);
  * federated dt filtering by neg/present category lists
    (``eval.py:83-103``);
  * ``0`` unmatched sentinels (``eval.py:239-240``) — note this differs
    from the track evaluator's ``-1``;
  * unmatched-dt ignore mask over area/not-exhaustive
    (``eval.py:281-290``);
  * rare/common/frequent category groups (``eval.py:107-113``);
  * summary keys incl. the 21 AP metrics and the printed label map
    (``eval.py:459-545``).
"""

from __future__ import annotations

import datetime
import logging
from collections import OrderedDict, defaultdict

import numpy as np

from tao_amodal_torch.data.lvis import LvisDataset
from tao_amodal_torch.data.results import LvisResultsDataset
from tao_amodal_torch.evaluation.params import DetectionEvalParams
from tao_amodal_torch.ops import mask as mask_ops
from tao_amodal_torch.ops.matching import greedy_match
from tao_amodal_torch.ops.pr import pr_curves


class AmodalDetectionEvaluator:
    """Drop-in equivalent of the reference amodal ``LVISEval``."""

    def __init__(self, lvis_gt, lvis_dt, iou_type="segm"):
        self.logger = logging.getLogger(__name__)
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"iou_type: {iou_type} is not supported.")

        if isinstance(lvis_gt, LvisDataset):
            self.lvis_gt = lvis_gt
        elif isinstance(lvis_gt, (str, dict)):
            self.lvis_gt = LvisDataset(lvis_gt)
        else:
            raise TypeError(
                f"Unsupported type {type(lvis_gt)} of lvis_gt.")

        if isinstance(lvis_dt, LvisResultsDataset):
            self.lvis_dt = lvis_dt
        elif isinstance(lvis_dt, (str, list)):
            self.lvis_dt = LvisResultsDataset(self.lvis_gt, lvis_dt)
        else:
            raise TypeError(f"Unsupported type {lvis_dt} of lvis_dt.")

        self.params = DetectionEvalParams(iou_type=iou_type)
        self.params.img_ids = sorted(self.lvis_gt.get_img_ids())
        self.params.cat_ids = sorted(self.lvis_gt.get_cat_ids())

        self.results = OrderedDict()
        self.eval = {}
        self._cells = {}
        self.eval_imgs = {}
        self.ious = {}

    # ------------------------------------------------------------------

    def _prepare_cells(self):
        p = self.params
        cat_ids = p.cat_ids if p.cat_ids else None
        gts = self.lvis_gt.load_anns(
            self.lvis_gt.get_ann_ids(img_ids=p.img_ids, cat_ids=cat_ids))
        dts = self.lvis_dt.load_anns(
            self.lvis_dt.get_ann_ids(img_ids=p.img_ids, cat_ids=cat_ids))

        if p.iou_type == "segm":
            for ann in gts:
                ann["segmentation"] = self.lvis_gt.ann_to_rle(ann)
            for ann in dts:
                ann["segmentation"] = self.lvis_dt.ann_to_rle(ann)

        for gt in gts:
            gt.setdefault("ignore", 0)

        gt_cells = defaultdict(list)
        for gt in gts:
            gt_cells[gt["image_id"], gt["category_id"]].append(gt)

        img_data = self.lvis_gt.load_imgs(ids=p.img_ids)
        img_nl = {d["id"]: d["neg_category_ids"] for d in img_data}
        img_pl = defaultdict(set)
        for ann in gts:
            img_pl[ann["image_id"]].add(ann["category_id"])
        self.img_nel = {
            d["id"]: d["not_exhaustive_category_ids"] for d in img_data
        }

        dt_cells = defaultdict(list)
        for dt in dts:
            img_id, cat_id = dt["image_id"], dt["category_id"]
            if cat_id not in img_nl[img_id] and cat_id not in img_pl[img_id]:
                continue
            dt_cells[img_id, cat_id].append(dt)
        return gt_cells, dt_cells

    def _prepare_freq_group(self):
        freq_groups = [[] for _ in self.params.img_count_lbl]
        cat_data = self.lvis_gt.load_cats(self.params.cat_ids)
        for idx, c in enumerate(cat_data):
            freq_groups[self.params.img_count_lbl.index(
                c["frequency"])].append(idx)
        return freq_groups

    def _cell_iou(self, dt, gt):
        """Score-sorted dt x gt IoU matrix for one (image, cat) cell."""
        if self.params.iou_type == "bbox":
            d = np.array([x["bbox"] for x in dt], np.float64).reshape(-1, 4)
            g = np.array([x["bbox"] for x in gt], np.float64).reshape(-1, 4)
            return mask_ops.iou(d, g, [0] * len(gt))
        return mask_ops.iou([x["segmentation"] for x in dt],
                            [x["segmentation"] for x in gt], [0] * len(gt))

    def evaluate(self):
        self.logger.info("Running per image evaluation.")
        self.logger.info(
            "Evaluate annotation type *{}*".format(self.params.iou_type))
        p = self.params
        p.img_ids = list(np.unique(p.img_ids))
        cat_ids = p.cat_ids if p.use_cats else [-1]

        gt_cells, dt_cells = self._prepare_cells()
        self.freq_groups = self._prepare_freq_group()

        self._cells = {}
        self.ious = {}
        # Iterate only populated cells, in (image, category) order (the
        # dense imgs x cats product is ~30M mostly-empty pairs at real
        # LVIS scale).
        img_index = {im: i for i, im in enumerate(p.img_ids)}
        cat_index = {c: i for i, c in enumerate(cat_ids)}
        cell_keys = sorted(
            set(gt_cells) | set(dt_cells),
            key=lambda k: (img_index[k[0]], cat_index.get(k[1], 0)))
        for img_id, cat_id in cell_keys:
            if cat_id in cat_index:
                gt = gt_cells.get((img_id, cat_id), [])
                dt = dt_cells.get((img_id, cat_id), [])
                if not gt and not dt:
                    continue
                order = np.argsort([-d["score"] for d in dt],
                                   kind="mergesort")
                dt = [dt[i] for i in order]
                ious = self._cell_iou(dt, gt)
                ious = (np.asarray(ious, np.float64).reshape(len(dt), len(gt))
                        if len(dt) and len(gt)
                        else np.zeros((len(dt), len(gt))))
                self.ious[img_id, cat_id] = ious
                self._cells[img_id, cat_id] = {
                    "gt_ids": np.array([g["id"] for g in gt], np.float64),
                    "gt_vis": np.array(
                        [g.get("visibility", 1.0) for g in gt], np.float64),
                    "gt_oof": np.array(
                        [bool(g.get("out_of_frame", False)) for g in gt],
                        bool),
                    "gt_ignore0": np.array([g["ignore"] for g in gt],
                                           np.float64),
                    "dt_ids": np.array([d["id"] for d in dt], np.float64),
                    "dt_area": np.array([d["area"] for d in dt], np.float64),
                    "dt_scores": np.array([d["score"] for d in dt],
                                          np.float64),
                    "dt_nel": np.array([
                        d["category_id"] in self.img_nel[d["image_id"]]
                        for d in dt], bool),
                    "ious": ious,
                }

        n_vis = len(p.visibility_rng)
        # Sparse per-(c, a) result lists in image order: a dense
        # (imgs x cats x ranges) map is hundreds of millions of
        # mostly-None entries at real LVIS scale.
        self.eval_imgs = defaultdict(list)
        for img_id, cat_id in cell_keys:
            if cat_id in cat_index:
                c = cat_index[cat_id]
                cell = self._cells.get((img_id, cat_id))
                if cell is None:
                    continue
                # Visibility ranges often produce identical ignore
                # vectors for a cell -> match once per signature.
                memo = {}
                for a, vis_rng in enumerate(p.visibility_rng):
                    use_oof = a == n_vis - 1
                    if not use_oof:
                        ignore = (
                            (cell["gt_ignore0"] != 0)
                            | (cell["gt_vis"] < vis_rng[0])
                            | (cell["gt_vis"] > vis_rng[1]))
                    else:
                        ignore = ((cell["gt_ignore0"] != 0)
                                  | ~cell["gt_oof"])
                    key = ignore.tobytes()
                    if key not in memo:
                        memo[key] = self._match_cell_signed(cell,
                                                            ignore)
                    self.eval_imgs[c, a].append(memo[key])

    def _match_cell_signed(self, cell, ignore):
        p = self.params
        gt_ig = ignore.astype(np.float64)

        order = np.argsort(gt_ig, kind="mergesort")
        gt_ig = gt_ig[order]
        gt_ids = cell["gt_ids"][order]
        ious = cell["ious"][:, order] if cell["ious"].size else cell["ious"]

        num_dt = len(cell["dt_ids"])
        if cell["ious"].shape[0] and cell["ious"].shape[1]:
            # LVIS uses 0 as the unmatched sentinel
            # (reference ``lvis_amodal/eval.py:239-240``).
            dt_m, gt_m, dt_igm = greedy_match(
                ious, gt_ig, cell["dt_ids"], gt_ids, p.iou_thrs,
                unmatched=0.0)
        else:
            T = len(p.iou_thrs)
            dt_m = np.zeros((T, num_dt))
            gt_m = np.zeros((T, len(gt_ids)))
            dt_igm = np.zeros((T, num_dt))

        dt_ig_mask = (
            (cell["dt_area"] < 0) | (cell["dt_area"] > 1e5 ** 2)
            | cell["dt_nel"]
        )[None, :]
        dt_ig = np.logical_or(dt_igm, np.logical_and(dt_m == 0, dt_ig_mask))
        return {
            "dt_ids": cell["dt_ids"],
            "gt_ids": gt_ids,
            "dt_matches": dt_m,
            "gt_matches": gt_m,
            "dt_scores": cell["dt_scores"],
            "gt_ignore": gt_ig,
            "dt_ignore": dt_ig,
        }

    # ------------------------------------------------------------------

    def accumulate(self):
        self.logger.info("Accumulating evaluation results.")
        if not self.eval_imgs:
            self.logger.warning("Please run evaluate first.")
        p = self.params
        cat_ids = p.cat_ids if p.use_cats else [-1]

        num_thrs = len(p.iou_thrs)
        num_recalls = len(p.rec_thrs)
        num_cats = len(cat_ids)
        num_vis = len(p.visibility_rng)
        num_imgs = len(p.img_ids)

        precision = -np.ones((num_thrs, num_recalls, num_cats, num_vis))
        recall = -np.ones((num_thrs, num_cats, num_vis))

        del num_imgs
        for c in range(num_cats):
            for a in range(num_vis):
                E = self.eval_imgs.get((c, a), ())
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
                tps = np.logical_and(dt_m != 0, np.logical_not(dt_ig))
                fps = np.logical_and(dt_m == 0, np.logical_not(dt_ig))
                prec, rec = pr_curves(tps, fps, num_gt, p.rec_thrs)
                precision[:, :, c, a] = prec
                recall[:, c, a] = rec

        self.eval = {
            "params": p,
            "counts": [num_thrs, num_recalls, num_cats, num_vis],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision,
            "recall": recall,
        }

    def _summarize(self, summary_type, iou_thr=None, visibility_rng="all",
                   freq_group_idx=None):
        p = self.params
        aidx = [i for i, lbl in enumerate(p.visibility_rng_lbl)
                if lbl == visibility_rng]
        if summary_type == "ap":
            s = self.eval["precision"]
            if iou_thr is not None:
                s = s[np.where(iou_thr == p.iou_thrs)[0]]
            if freq_group_idx is not None:
                s = s[:, :, self.freq_groups[freq_group_idx], aidx]
            else:
                s = s[:, :, :, aidx]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                s = s[np.where(iou_thr == p.iou_thrs)[0]]
            s = s[:, :, aidx]
        if len(s[s > -1]) == 0:
            return -1
        return np.mean(s[s > -1])

    def summarize(self):
        if not self.eval:
            raise RuntimeError("Please run accumulate() first.")
        max_dets = self.params.max_dets
        splits = {
            "HO": "highly-occluded",
            "PO": "partially-occluded",
            "HP": "highly-and-partially-occluded",
            "HV": "highly-visible",
            "OOF": "out-of-frame",
        }
        self.results["AP"] = self._summarize("ap")
        self.results["AP50"] = self._summarize("ap", iou_thr=0.50)
        self.results["AP75"] = self._summarize("ap", iou_thr=0.75)
        for abbr in ("HO", "PO", "HP", "HV", "OOF"):
            rng = splits[abbr]
            self.results[f"AP-{abbr}"] = self._summarize(
                "ap", visibility_rng=rng)
            self.results[f"AP50-{abbr}"] = self._summarize(
                "ap", iou_thr=0.50, visibility_rng=rng)
            self.results[f"AP75-{abbr}"] = self._summarize(
                "ap", iou_thr=0.75, visibility_rng=rng)
        self.results["APr"] = self._summarize("ap", freq_group_idx=0)
        self.results["APc"] = self._summarize("ap", freq_group_idx=1)
        self.results["APf"] = self._summarize("ap", freq_group_idx=2)
        self.results[f"AR@{max_dets}"] = self._summarize("ar")
        for rng in ("highly-occluded", "partially-occluded",
                    "highly-visible", "highly-and-partially-occluded",
                    "out-of-frame"):
            self.results[f"AR{rng[0]}@{max_dets}"] = self._summarize(
                "ar", visibility_rng=rng)

    def run(self):
        self.evaluate()
        self.accumulate()
        self.summarize()

    def print_results(self):
        template = (" {:<18} {} @[ IoU={:<9} | visibility={:>6s} | "
                    "maxDets={:>3d} catIds={:>3s}] = {:0.3f}")
        abbrv_to_full_name = {
            "HO": "Highly Occluded (vis < 0.1)",
            "PO": "Partially Occluded (0.1 < vis < 0.8)",
            "HP": "Highly + Partially Occluded (vis < 0.8)",
            "HV": "Highly Visible (vis > 0.8)",
        }
        for key, value in self.results.items():
            max_dets = self.params.max_dets
            if "AP" in key:
                title, _type = "Average Precision", "(AP)"
            else:
                title, _type = "Average Recall", "(AR)"
            if len(key) > 2 and key[2].isdigit():
                iou = "{:0.2f}".format(float(key[2:4]) / 100)
            else:
                iou = "{:0.2f}:{:0.2f}".format(self.params.iou_thrs[0],
                                               self.params.iou_thrs[-1])
            if len(key) > 2 and key[2] in ("r", "c", "f"):
                cat_group_name = key[2]
            else:
                cat_group_name = "all"
            if len(key) > 2 and key[-2:] in abbrv_to_full_name:
                visibility_rng = abbrv_to_full_name[key[-2:]]
            elif len(key) > 2 and key[-3:] == "OOF":
                visibility_rng = "Out-of-Frame"
            else:
                visibility_rng = "all"
            print(template.format(title, _type, iou, visibility_rng,
                                  max_dets, cat_group_name, value))

    def get_results(self):
        if not self.results:
            self.logger.warning("results is empty. Call run().")
        return self.results
