"""Minimal TAO-Amodal annotation reader for the serving CLI.

The port imports nothing of the JAX package, whose
``tao_amodal_tpu/data/__init__.py`` pulls in jax-backed modules along
with :class:`tao_amodal_tpu.data.tao.TaoDataset`.  So the port carries
the three indices the inference CLI reads, built the same way: ``vids``
and ``cats`` keyed by id, and ``vid_img_map`` grouping images by
``video_id``.
"""

from __future__ import annotations

import json
from collections import defaultdict


class TaoDataset:
    """Index over a TAO-Amodal annotation JSON file."""

    def __init__(self, annotation):
        with open(annotation) as f:
            dataset = json.load(f)
        for key in ("images", "categories", "videos"):
            if key not in dataset:
                raise KeyError(f"annotation has no {key!r} list")
        self.dataset = dataset
        self.vids = {v["id"]: v for v in dataset["videos"]}
        self.cats = {c["id"]: c for c in dataset["categories"]}
        self.vid_img_map = defaultdict(list)
        for im in dataset["images"]:
            self.vid_img_map[im["video_id"]].append(im)
