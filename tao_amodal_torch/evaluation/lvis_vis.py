"""Matplotlib rendering of LVIS-style ground truth and results.

Port of :mod:`tao_amodal_tpu.evaluation.lvis_vis` (the reference
``LVISVis``, ``tao_amodal/evaluation/lvis_amodal/vis.py:15``): one
image's annotations or results with category synsets, box and mask
overlays and optional score labels.  matplotlib is imported inside the
functions that draw; a machine without it raises its ``ImportError``
there.
"""

from __future__ import annotations

import os

import numpy as np

from tao_amodal_torch.ops import mask as mask_ops
from tao_amodal_torch.utils.colormap import color_for_id


class LvisVis:
    def __init__(self, lvis_gt, lvis_dt=None, img_dir=None):
        self.gt = lvis_gt
        self.dt = lvis_dt
        self.img_dir = img_dir

    def load_img(self, img_id):
        from PIL import Image

        info = self.gt.imgs[img_id]
        name = info.get("file_name") or info.get(
            "coco_url", "").split("/")[-1]
        if self.img_dir:
            path = os.path.join(self.img_dir, name)
            if os.path.exists(path):
                return np.asarray(Image.open(path).convert("RGB"))
        return np.full((info["height"], info["width"], 3), 128,
                       np.uint8)

    def get_synset(self, cat_id):
        cat = self.gt.cats.get(cat_id, {})
        return cat.get("synset", cat.get("name", str(cat_id)))

    def _draw(self, ax, anns, show_segms=True, show_boxes=True,
              show_scores=False):
        import matplotlib.patches as patches

        for ann in anns:
            color = color_for_id(ann.get("category_id", 0)) / 255.0
            if show_boxes and "bbox" in ann:
                x, y, w, h = ann["bbox"]
                ax.add_patch(patches.Rectangle(
                    (x, y), w, h, fill=False, edgecolor=color,
                    linewidth=2))
                label = self.get_synset(ann["category_id"])
                if show_scores and "score" in ann:
                    label += f" {ann['score']:.2f}"
                ax.text(x, y - 2, label, fontsize=8, color="white",
                        bbox=dict(facecolor=color, alpha=0.7, pad=1))
            if show_segms and isinstance(ann.get("segmentation"), dict):
                m = mask_ops.decode(ann["segmentation"])
                overlay = np.zeros(m.shape + (4,))
                overlay[m.astype(bool)] = (*color, 0.4)
                ax.imshow(overlay)

    def vis_img(self, img_id, show_boxes=True, show_segms=True,
                show_classes=True, ax=None):
        """Render one image's ground truth."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(1)
        ax.imshow(self.load_img(img_id))
        anns = self.gt.load_anns(self.gt.get_ann_ids(img_ids=[img_id]))
        self._draw(ax, anns, show_segms=show_segms,
                   show_boxes=show_boxes)
        ax.axis("off")
        return ax

    def vis_result(self, img_id, score_thrs=0.0, show_boxes=True,
                   show_segms=True, ax=None):
        """Render one image's results."""
        import matplotlib.pyplot as plt

        assert self.dt is not None, "no result set loaded"
        if ax is None:
            _, ax = plt.subplots(1)
        ax.imshow(self.load_img(img_id))
        anns = self.dt.load_anns(self.dt.get_ann_ids(img_ids=[img_id]))
        anns = [a for a in anns if a.get("score", 1.0) >= score_thrs]
        self._draw(ax, anns, show_segms=show_segms,
                   show_boxes=show_boxes, show_scores=True)
        ax.axis("off")
        return ax
