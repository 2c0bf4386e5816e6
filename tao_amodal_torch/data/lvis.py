"""LVIS-style per-frame dataset API.

The port's copy of :class:`tao_amodal_tpu.data.lvis.LvisDataset`, a
parity rebuild of the reference ``LVIS`` class
(``tao_amodal/evaluation/lvis_amodal/lvis.py``): same index structure,
same ``get_ann_ids`` filter semantics (strict area inequalities,
reference ``lvis.py:90-96``), and the same polygon/uncompressed-RLE ->
RLE conversion (``ann_to_rle``, reference ``lvis.py:171-193``) through
the port's codec (:mod:`tao_amodal_torch.ops.mask`).
"""

from __future__ import annotations

import json
import logging
from collections import defaultdict

from tao_amodal_torch.ops import mask as mask_ops


class LvisDataset:
    def __init__(self, annotation_path):
        self.logger = logging.getLogger(__name__)
        self.logger.info("Loading annotations.")
        if isinstance(annotation_path, dict):
            self.dataset = annotation_path
        else:
            self.dataset = self._load_json(annotation_path)
        assert isinstance(self.dataset, dict), (
            "Annotation file format {} not supported.".format(
                type(self.dataset)))
        self._create_index()

    def _load_json(self, path):
        with open(path, "r") as f:
            return json.load(f)

    def _create_index(self):
        self.logger.info("Creating index.")
        self.img_ann_map = defaultdict(list)
        self.cat_img_map = defaultdict(list)
        self.anns = {}
        self.cats = {}
        self.imgs = {}
        for ann in self.dataset["annotations"]:
            self.img_ann_map[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
        for img in self.dataset["images"]:
            self.imgs[img["id"]] = img
        for cat in self.dataset["categories"]:
            self.cats[cat["id"]] = cat
        for ann in self.dataset["annotations"]:
            self.cat_img_map[ann["category_id"]].append(ann["image_id"])
        self.logger.info("Index created.")

    def get_ann_ids(self, img_ids=None, cat_ids=None, area_rng=None):
        anns = []
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

    def get_img_ids(self):
        return list(self.imgs.keys())

    def _load_helper(self, _dict, ids):
        if ids is None:
            return list(_dict.values())
        return [_dict[i] for i in ids]

    def load_anns(self, ids=None):
        return self._load_helper(self.anns, ids)

    def load_cats(self, ids):
        return self._load_helper(self.cats, ids)

    def load_imgs(self, ids):
        return self._load_helper(self.imgs, ids)

    def ann_to_rle(self, ann):
        """Polygons / uncompressed RLE / RLE -> compressed RLE."""
        img_data = self.imgs[ann["image_id"]]
        h, w = img_data["height"], img_data["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            return mask_ops.merge(mask_ops.fr_py_objects(segm, h, w))
        if isinstance(segm["counts"], list):
            return mask_ops.fr_py_objects(segm, h, w)
        return segm

    def ann_to_mask(self, ann):
        return mask_ops.decode(self.ann_to_rle(ann))
