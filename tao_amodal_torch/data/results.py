"""Prediction wrappers over the GT datasets.

The port's copy of ``tao_amodal_tpu/data/results.py``: parity rebuilds
of the reference's ``TaoResults``
(``tao_amodal/evaluation/tao_amodal/results.py``) and ``LVISResults``
(``tao_amodal/evaluation/lvis_amodal/results.py``), plus the CLI's
cross-video track-id uniquification
(``tools/eval_on_tao_amodal.py:44-66``).

Prediction JSON contract (reference ``README.md:107-116``): a list of
``{image_id, category_id, bbox[x,y,w,h], score, track_id, video_id}``.
"""

from __future__ import annotations

import itertools
import logging
from collections import defaultdict
from copy import deepcopy

import numpy as np

from tao_amodal_torch.data.lvis import LvisDataset
from tao_amodal_torch.data.tao import TaoDataset
from tao_amodal_torch.ops import mask as mask_ops


def make_track_ids_unique(result_anns):
    """Re-id tracks whose id appears in more than one video.

    Same algorithm as the reference CLI
    (``tools/eval_on_tao_amodal.py:44-66``): first video keeps the id;
    later (track, video) pairs get fresh ids beyond the current max.
    Returns the number of reassigned track ids.
    """
    track_id_videos = {}
    track_ids_to_update = set()
    max_track_id = 0
    for ann in result_anns:
        t = ann["track_id"]
        if t not in track_id_videos:
            track_id_videos[t] = ann["video_id"]
        if ann["video_id"] != track_id_videos[t]:
            track_ids_to_update.add(t)
        max_track_id = max(max_track_id, t)

    if track_ids_to_update:
        next_id = itertools.count(max_track_id + 1)
        new_track_ids = defaultdict(lambda: next(next_id))
        for ann in result_anns:
            t = ann["track_id"]
            v = ann["video_id"]
            if t in track_ids_to_update:
                ann["track_id"] = new_track_ids[t, v]
    return len(track_ids_to_update)


def _limit_dets_per_image(anns, max_dets):
    """Keep the top-``max_dets`` scored annotations per frame.

    NOTE: per *frame*, not per video (reference ``results.py:121-132``);
    ordering of the survivors follows the reference exactly (per-image
    groups in first-seen order; within an over-limit image, sorted by
    descending score).
    """
    img_ann = defaultdict(list)
    for ann in anns:
        img_ann[ann["image_id"]].append(ann)
    for img_id, _anns in img_ann.items():
        if len(_anns) <= max_dets:
            continue
        _anns = sorted(_anns, key=lambda ann: ann["score"], reverse=True)
        img_ann[img_id] = _anns[:max_dets]
    return [ann for anns in img_ann.values() for ann in anns]


class TaoResultsDataset(TaoDataset):
    """Predictions indexed as a Tao dataset (tracks synthesized).

    Reference semantics preserved: assert unique track ids per video,
    300-det/frame cap, degenerate polygon segmentations from boxes
    (``results.py:68``), per-track score = mean of annotation scores with
    all annotation scores overwritten by the mean (``results.py:87-103``).
    """

    def __init__(self, tao_gt, results, max_dets=300):
        if isinstance(tao_gt, TaoDataset):
            self.dataset = deepcopy(tao_gt.dataset)
        elif isinstance(tao_gt, str):
            self.dataset = self._load_json(tao_gt)
        else:
            raise TypeError(
                "Unsupported type {} of tao_gt.".format(type(tao_gt)))

        self.logger = logging.getLogger("tao.results")
        self.logger.info("Loading and preparing results.")

        if isinstance(results, str):
            result_anns = self._load_json(results)
        else:
            self.logger.warning(
                "Assuming user provided the results in correct format.")
            result_anns = results

        merge_map = TaoDataset._construct_merge_map(self.dataset)
        for x in result_anns:
            if x["category_id"] in merge_map:
                x["category_id"] = merge_map[x["category_id"]]

        assert isinstance(result_anns, list), "results is not a list."
        self.ensure_unique_track_ids(result_anns)

        if max_dets >= 0:
            result_anns = _limit_dets_per_image(result_anns, max_dets)

        tracks = {}
        if result_anns and "bbox" in result_anns[0]:
            for idx, ann in enumerate(result_anns):
                x1, y1, w, h = ann["bbox"]
                x2 = x1 + w
                y2 = y1 + h
                if "segmentation" not in ann:
                    ann["segmentation"] = [[x1, y1, x1, y2, x2, y2, x2, y1]]
                track_id = ann["track_id"]
                if track_id not in tracks:
                    tracks[track_id] = {
                        "id": track_id,
                        "video_id": ann["video_id"],
                        "category_id": ann["category_id"],
                    }
                assert tracks[track_id]["category_id"] == ann["category_id"], (
                    f"Annotations for track {track_id} have multiple "
                    f"categories")
                ann["area"] = w * h
                ann["id"] = idx + 1

        self.dataset["annotations"] = result_anns
        self.dataset["tracks"] = list(tracks.values())
        self._create_index()

        _required_average = False
        for track_id, track_anns in self.track_ann_map.items():
            scores = [float(x["score"]) for x in track_anns]
            unique_scores = set(scores)
            if len(unique_scores) > 1:
                _required_average = True
                avg = np.mean(scores)
                self.tracks[track_id]["score"] = avg
                for x in track_anns:
                    x["score"] = avg
            elif len(unique_scores) == 1:
                self.tracks[track_id]["score"] = unique_scores.pop()
        if _required_average:
            self.logger.warning(
                "At least one track had annotations with different scores; "
                "using average of individual annotation scores as track "
                "scores.")

        img_ids_in_result = [ann["image_id"] for ann in result_anns]
        assert set(img_ids_in_result) == (
            set(img_ids_in_result) & set(self.get_img_ids())
        ), "Results do not correspond to current Tao set."

    def ensure_unique_track_ids(self, result_anns):
        track_id_videos = {}
        for ann in result_anns:
            t = ann["track_id"]
            if t not in track_id_videos:
                track_id_videos[t] = ann["video_id"]
            assert ann["video_id"] == track_id_videos[t], (
                f"Track id {t} appears in more than one video: "
                f"{track_id_videos[t]} and {ann['video_id']}")


class LvisResultsDataset(LvisDataset):
    """Predictions indexed as an LVIS dataset.

    Reference semantics preserved (``lvis_amodal/results.py``): 300/image
    cap, box -> degenerate polygon, segm -> area/bbox via the RLE codec.
    """

    def __init__(self, lvis_gt, results, max_dets=300):
        if isinstance(lvis_gt, LvisDataset):
            self.dataset = deepcopy(lvis_gt.dataset)
        elif isinstance(lvis_gt, str):
            self.dataset = self._load_json(lvis_gt)
        else:
            raise TypeError(
                "Unsupported type {} of lvis_gt.".format(type(lvis_gt)))

        self.logger = logging.getLogger(__name__)
        self.logger.info("Loading and preparing results.")

        if isinstance(results, str):
            result_anns = self._load_json(results)
        else:
            self.logger.warning(
                "Assuming user provided the results in correct format.")
            result_anns = results

        assert isinstance(result_anns, list), "results is not a list."

        if max_dets >= 0:
            result_anns = _limit_dets_per_image(result_anns, max_dets)

        if result_anns and "bbox" in result_anns[0]:
            for idx, ann in enumerate(result_anns):
                x1, y1, w, h = ann["bbox"]
                x2 = x1 + w
                y2 = y1 + h
                if "segmentation" not in ann:
                    ann["segmentation"] = [[x1, y1, x1, y2, x2, y2, x2, y1]]
                ann["area"] = w * h
                ann["id"] = idx + 1
        elif result_anns and "segmentation" in result_anns[0]:
            for idx, ann in enumerate(result_anns):
                ann["area"] = mask_ops.area(ann["segmentation"])
                if "bbox" not in ann:
                    ann["bbox"] = mask_ops.to_bbox(ann["segmentation"])
                ann["id"] = idx + 1

        self.dataset["annotations"] = result_anns
        self._create_index()

        img_ids_in_result = [ann["image_id"] for ann in result_anns]
        assert set(img_ids_in_result) == (
            set(img_ids_in_result) & set(self.get_img_ids())
        ), "Results do not correspond to current LVIS set."
