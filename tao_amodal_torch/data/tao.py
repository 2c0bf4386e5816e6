"""TAO-Amodal dataset API (host index).

The port's copy of :class:`tao_amodal_tpu.data.tao.TaoDataset` (the
JAX package's ``data/__init__.py`` pulls in jax-backed modules), itself
a behaviour-parity rebuild of the reference ``Tao`` class
(``tao_amodal/evaluation/tao_amodal/tao.py``): same JSON schema (amodal
fields ``visibility: float`` and ``out_of_frame: bool`` per annotation),
same category merge-map (``tao.py:97-118``), same track grouping sorted
by ``frame_index`` with per-track average area (``tao.py:172-188``), same
filter semantics in ``get_ann_ids`` (strict area inequalities,
``tao.py:247-253``).  The serving CLI reads ``vids``, ``cats`` and
``vid_img_map``; the evaluators read the rest; a single-object
tracker starts from :meth:`TaoDataset.get_single_object_init`.  Segmentations
(polygons, uncompressed and compressed RLE) convert to compressed RLE
through the port's codec (:meth:`TaoDataset.ann_to_rle`).
"""

from __future__ import annotations

import json
import logging
from collections import defaultdict

import numpy as np

from tao_amodal_torch.ops import mask as mask_ops


def _grouped(items, key):
    out = defaultdict(list)
    for item in items:
        out[item[key]].append(item)
    return out


class TaoDataset:
    """Index over a TAO-Amodal annotation JSON."""

    def __init__(self, annotation_path, logger=None):
        if not logger:
            self.logger = logging.getLogger("tao.tao")
        elif isinstance(logger, str):
            self.logger = logging.getLogger(logger)
        else:
            self.logger = logger

        self.logger.info("Loading annotations.")
        if isinstance(annotation_path, dict):
            for key in ("info", "images", "annotations", "categories",
                        "videos", "tracks"):
                assert key in annotation_path, (
                    f"Provided dictionary does not contain key {key}")
            self.dataset = annotation_path
        else:
            self.dataset = self._load_json(annotation_path)
        assert isinstance(self.dataset, dict), (
            "Annotation file format {} not supported.".format(
                type(self.dataset)))
        # A file that only lists videos and frames (a test split) still
        # drives the serving CLI.
        for key in ("annotations", "tracks"):
            self.dataset.setdefault(key, [])
        self._create_index()

    @staticmethod
    def _construct_merge_map(dataset):
        """Map merged-away category ids onto their canonical id."""
        merge_map = {}
        for category in dataset["categories"]:
            for to_merge in category.get("merged", ()):
                merge_map[to_merge["id"]] = category["id"]
        if not merge_map:
            logging.error("Did not merge any categories.")
        return merge_map

    @staticmethod
    def _load_json(path):
        with open(path, "r") as f:
            return json.load(f)

    def _create_index(self):
        self.logger.info("Creating index.")
        self.merge_categories = self._construct_merge_map(self.dataset)
        if self.merge_categories:
            remap = self.merge_categories
            for x in self.dataset["annotations"]:
                x["category_id"] = remap.get(x["category_id"],
                                             x["category_id"])
            for x in self.dataset["tracks"]:
                x["category_id"] = remap.get(x["category_id"],
                                             x["category_id"])

        self.vids = {v["id"]: v for v in self.dataset["videos"]}
        self.tracks = {t["id"]: t for t in self.dataset["tracks"]}
        self.cats = {c["id"]: c for c in self.dataset["categories"]}
        self.imgs = {im["id"]: im for im in self.dataset["images"]}

        # Grouped views.
        self.vid_img_map = _grouped(self.dataset["images"], "video_id")
        self.vid_track_map = _grouped(self.dataset["tracks"],
                                      "video_id")

        anns = self.dataset["annotations"]
        track_cat = {t["id"]: t["category_id"]
                     for t in self.dataset["tracks"]}
        bad_coords = []
        for ann in anns:
            box = [float(v) for v in ann["bbox"]]
            ann["bbox"] = box
            if min(box[0], box[1]) < 0 or box[2] <= 0 or box[3] <= 0:
                bad_coords.append(ann["id"])
            # category_id is denormalized from the track; keep them in
            # agreement (same invariant the reference asserts).
            assert "category_id" in ann, ann
            assert ann["category_id"] == track_cat[ann["track_id"]]
        self.anns = {a["id"]: a for a in anns}
        self.img_ann_map = _grouped(anns, "image_id")
        self.track_ann_map = _grouped(anns, "track_id")
        self.cat_img_map = defaultdict(list)
        for a in anns:
            self.cat_img_map[a["category_id"]].append(a["image_id"])
        if bad_coords:
            self.logger.warning(
                f"{len(bad_coords)} annotations had negative values in "
                f"coordinates!")
        self.logger.info("Index created.")

    # ------------------------------------------------------------------
    # Query API (reference-parity)
    # ------------------------------------------------------------------

    def get_track_ids(self, vid_ids=None, img_ids=None, cat_ids=None,
                      area_rng=None):
        return list({
            self.anns[x]["track_id"]
            for x in self.get_ann_ids(vid_ids, img_ids, cat_ids, area_rng)
        })

    def group_ann_tracks(self, anns):
        """Group annotations into track dicts (reference ``tao.py:172-188``).

        Each output track carries its annotations sorted by the image's
        ``frame_index`` and an ``area`` equal to the per-annotation mean.
        """
        tracks = {}
        for ann in anns:
            tid = ann["track_id"]
            if tid not in tracks:
                tracks[tid] = self.tracks[tid].copy()
                tracks[tid]["annotations"] = []
            tracks[tid]["annotations"].append(ann)

        for track in tracks.values():
            track["annotations"] = sorted(
                track["annotations"],
                key=lambda x: self.imgs[x["image_id"]]["frame_index"])
            track["area"] = (sum(x["area"] for x in track["annotations"])
                             / len(track["annotations"]))
        return list(tracks.values())

    def get_single_object_init(self, track_id, init_type="first"):
        """The annotation a single-object tracker starts from: the
        track's first in frame order, or its largest."""
        if init_type == "first":
            return self.get_kth_annotation(track_id, k=0)
        if init_type == "biggest":
            return max(self.track_ann_map[track_id], key=lambda x: x["area"])
        raise NotImplementedError(f"Unsupported init type, {init_type}")

    def get_kth_annotation(self, track_id, k):
        return sorted(self.track_ann_map[track_id],
                      key=lambda x: self.imgs[x["image_id"]]["frame_index"])[k]

    def get_ann_ids(self, vid_ids=None, img_ids=None, cat_ids=None,
                    area_rng=None):
        anns = []
        if vid_ids is not None:
            video_images = []
            for video_id in vid_ids:
                video_images.extend(
                    [x["id"] for x in self.vid_img_map[video_id]])
            if img_ids is None:
                img_ids = video_images
            img_ids = list(set(img_ids) & set(video_images))

        if img_ids is not None:
            for img_id in img_ids:
                anns.extend(self.img_ann_map[img_id])
        else:
            anns = self.dataset["annotations"]

        if cat_ids is None and area_rng is None:
            return [_ann["id"] for _ann in anns]

        cat_ids = set(cat_ids)
        if area_rng is None:
            area_rng = [0, float("inf")]
        return [
            _ann["id"] for _ann in anns
            if _ann["category_id"] in cat_ids
            and _ann["area"] > area_rng[0] and _ann["area"] < area_rng[1]
        ]

    def get_cat_ids(self):
        return list(self.cats.keys())

    def get_vid_ids(self):
        return list(self.vids.keys())

    def get_img_ids(self):
        return list(self.imgs.keys())

    def _load_helper(self, _dict, ids):
        if ids is None:
            return list(_dict.values())
        return [_dict[i] for i in ids]

    def load_anns(self, ids=None):
        return self._load_helper(self.anns, ids)

    def load_tracks(self, ids=None):
        return self._load_helper(self.tracks, ids)

    def load_cats(self, ids):
        return self._load_helper(self.cats, ids)

    def load_imgs(self, ids):
        return self._load_helper(self.imgs, ids)

    def load_vids(self, ids):
        return self._load_helper(self.vids, ids)

    def ann_to_rle(self, ann):
        """Annotation segmentation -> compressed RLE.

        Accepts polygons, uncompressed RLE (list counts), or compressed
        RLE; annotations without a ``segmentation`` fall back to the
        bbox rectangle (so segm-mode track IoU is defined for box-only
        predictions, matching the degenerate box-polygon segmentations
        ``TaoResultsDataset`` synthesizes).
        """
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann.get("segmentation")
        if segm is None:
            return mask_ops.from_bbox(
                np.asarray(ann["bbox"], np.float64), h, w)[0]
        if isinstance(segm, list):
            return mask_ops.merge(mask_ops.fr_py_objects(segm, h, w))
        if isinstance(segm.get("counts"), list):
            return mask_ops.fr_py_objects(segm, h, w)
        return segm

    def ann_to_mask(self, ann):
        return mask_ops.decode(self.ann_to_rle(ann))
