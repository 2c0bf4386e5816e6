"""Device-batched amodal detection (LVIS-style) evaluation.

The port of ``tao_amodal_tpu/evaluation/device_detection.py``: the
per-frame counterpart of :mod:`tao_amodal_torch.evaluation.device_eval`.
A chunk of padded images evaluates in one batched call across all
(category x visibility-range x threshold) cells: per-image box IoU
matrices are one broadcast (segm: mask IoU on the host through the RLE
codec, passed in), matching steps over the detection slots with
every image and cell a batch axis, and the out-of-frame pseudo-range
rides the same tensors with a flag.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from tao_amodal_torch.evaluation.batched import (
    GT_ID_BASE,
    check_int16_ids,
    gather_last,
    resolve_device,
)
from tao_amodal_torch.evaluation.detection_eval import (
    AmodalDetectionEvaluator,
)
from tao_amodal_torch.evaluation.device_eval import to_device
from tao_amodal_torch.ops import mask as mask_ops
from tao_amodal_torch.ops.boxes import box_iou_matrix
from tao_amodal_torch.ops.matching import greedy_match_torch


def eval_images_device(dt, gt, vis_rngs, use_oof, iou_thrs, ious=None):
    """Evaluate a padded batch of I images over all cells.

    Args:
      dt: dict of ``boxes [I, D, 4]`` (xywh), ``scores [I, D]``, ``cats
        [I, D]``, ``nel [I, D]``, ``exists [I, D]``, and ``cell_cats [I,
        K]``, the cells' categories: each image's candidates, padded with
        ``-2`` (an image touches a handful of the vocabulary).
      gt: dict of ``boxes [I, G, 4]``, ``vis [I, G]``, ``oof [I, G]``,
        ``ignore0 [I, G]``, ``cats [I, G]``, ``exists [I, G]``.
      vis_rngs: ``[A, 2]``; use_oof ``[A]`` bool; iou_thrs ``[T]``.
      ious: ``[I, D, G]`` precomputed IoU matrices (segm mode: mask IoU
        on the host through the RLE codec), or None for the box IoU of
        ``boxes``.

    Returns ``dt_matches [I, K, A, T, D]`` int16 (gt ids, 0 unmatched),
    ``dt_ignore [I, K, A, T, D]`` bool, ``gt_ignore [I, K, A, G]`` int8,
    ``dt_in_cell [I, K, D]``, ``cell_valid [I, K]`` and ``dt_scores [I,
    D]`` in the score order.
    """
    f32 = torch.float32
    n, D = dt["scores"].shape
    G = gt["cats"].shape[1]
    dev = dt["scores"].device
    check_int16_ids(G)

    if ious is None:
        ious = box_iou_matrix(dt["boxes"].to(f32), gt["boxes"].to(f32))
    ious = ious.to(f32)
    order = torch.argsort(-dt["scores"], dim=-1, stable=True)
    iou_s = ious.gather(1, order[:, :, None].expand(n, D, G))
    dt_ids = (torch.arange(D, dtype=f32, device=dev) + 1.0)[order]

    cell_cats = dt["cell_cats"][:, :, None]                    # [I, K, 1]
    dt_mask = (dt["cats"][:, None] == cell_cats) & dt["exists"][:, None]
    gt_mask = (gt["cats"][:, None] == cell_cats) & gt["exists"][:, None]
    dt_mask_s = gather_last(dt_mask, order[:, None])           # [I, K, D]

    # Per-range gt ignore flags, [I, A, G].
    ignore0 = (gt["ignore0"] != 0)[:, None]
    vis = gt["vis"][:, None]
    ig_vis = (ignore0 | (vis < vis_rngs[:, 0, None])
              | (vis > vis_rngs[:, 1, None]))
    ig_oof = ignore0 | ~gt["oof"][:, None]
    ignore = torch.where(use_oof[:, None], ig_oof, ig_vis)

    key = (ignore.to(torch.int32)[:, None]
           + 2 * (~gt_mask).to(torch.int32)[:, :, None])
    perm = torch.argsort(key, dim=-1, stable=True)        # [I, K, A, G]
    gt_ig = gather_last(ignore.to(f32)[:, None], perm)
    gt_ids = (torch.arange(G, dtype=f32, device=dev) + GT_ID_BASE)[perm]
    gt_valid = gather_last(gt_mask[:, :, None], perm)
    ious_cell = gather_last(iou_s[:, None, None],
                            perm[..., None, :])           # [I, K, A, D, G]

    dt_m, _, dt_igm = greedy_match_torch(
        ious_cell, gt_ig, dt_ids[:, None, None], gt_ids, iou_thrs,
        dt_valid=dt_mask_s[:, :, None], gt_valid=gt_valid,
        unmatched=0.0)                                    # [I, K, A, T, D]
    dt_ig_mask = dt["nel"].gather(1, order)[:, None, None, None]
    dt_ig = (dt_igm != 0) | ((dt_m == 0) & dt_ig_mask)
    return {
        # Compact dtypes: dt_matches holds small non-negative gt ids
        # (0 = unmatched), gt_ignore a 0/1 flag.
        "dt_matches": dt_m.to(torch.int16),
        "dt_ignore": dt_ig,
        "gt_ignore": torch.where(gt_valid, gt_ig, 1.0).to(torch.int8),
        "dt_in_cell": dt_mask_s,
        "cell_valid": dt_mask.any(-1) | gt_mask.any(-1),
        "dt_scores": dt["scores"].gather(1, order),
    }


def _next_pow2(n, lo=4):
    p = lo
    while p < n:
        p *= 2
    return p


class DeviceDetectionEval(AmodalDetectionEvaluator):
    """AmodalDetectionEvaluator with per-image cells on ``device``
    (``"cuda"`` unless the caller asks for another; without a card
    ``"cuda"`` raises)."""

    # Memory bound of one chunk's match tensors, and the least chunk.
    chunk_budget_bytes = 100 << 20
    min_chunk = 32

    def __init__(self, lvis_gt, lvis_dt, iou_type="segm", device="cuda"):
        self.device = resolve_device(device)
        super().__init__(lvis_gt, lvis_dt, iou_type)

    def evaluate(self):
        self.logger.info("Running per image evaluation.")
        self.logger.info(
            "Evaluate annotation type *{}*".format(self.params.iou_type))
        p = self.params
        p.img_ids = list(np.unique(p.img_ids))
        cat_ids = p.cat_ids if p.use_cats else [-1]
        gt_cells, dt_cells = self._prepare_cells()
        self.freq_groups = self._prepare_freq_group()

        per_img = defaultdict(lambda: {"dt": [], "gt": []})
        for (img, _cat), anns in gt_cells.items():
            per_img[img]["gt"].extend(anns)
        for (img, _cat), anns in dt_cells.items():
            per_img[img]["dt"].extend(anns)

        # Bucket images by padded (D, G, K); K bounds the per-image
        # candidate category list.
        cat_pos = {cat: c for c, cat in enumerate(cat_ids)}
        buckets = defaultdict(list)
        for i, img_id in enumerate(p.img_ids):
            entry = per_img.get(img_id)
            if entry is None or (not entry["dt"] and not entry["gt"]):
                continue
            present = sorted({a["category_id"]
                              for side in ("dt", "gt")
                              for a in entry[side]
                              if a["category_id"] in cat_pos})
            entry = dict(entry, cats=present)
            D = _next_pow2(max(len(entry["dt"]), 1))
            G = _next_pow2(max(len(entry["gt"]), 1))
            K = _next_pow2(max(len(present), 1))
            buckets[D, G, K].append((i, img_id, entry))

        dev = self.device
        vis_arr = torch.tensor(np.asarray(p.visibility_rng, np.float32),
                               device=dev)
        oof_arr = torch.tensor(
            np.arange(len(p.visibility_rng))
            == len(p.visibility_rng) - 1, device=dev)
        thrs = torch.tensor(np.asarray(p.iou_thrs, np.float32), device=dev)

        self.eval_imgs = defaultdict(list)
        # Accumulation must see cells in image order regardless of
        # bucket processing order: collect then sort by image index.
        staging = defaultdict(list)
        # Bound the per-call image batch: the outputs are [n, K, A, T,
        # D]-shaped, so a many-thousand-image bucket would take the
        # card's memory.  The chunk keeps each output under the budget.
        for (D, G, K), bucket_items in buckets.items():
            per_img_bytes = K * len(p.visibility_rng) \
                * len(p.iou_thrs) * (D + G) * 3
            chunk = max(self.min_chunk,
                        min(4096, self.chunk_budget_bytes
                            // max(per_img_bytes, 1)))
            chunk = min(chunk, _next_pow2(len(bucket_items),
                                          lo=self.min_chunk))
            for s in range(0, len(bucket_items), chunk):
                items = bucket_items[s:s + chunk]
                dt, gt = self._pack(items, D, G, K)
                ious = (torch.from_numpy(self._segm_ious(items, D, G))
                        .to(dev) if p.iou_type == "segm" else None)
                out = eval_images_device(to_device(dt, dev),
                                         to_device(gt, dev), vis_arr,
                                         oof_arr, thrs, ious=ious)
                out = {k: v.cpu().numpy() for k, v in out.items()}
                self._unpack(out, items, cat_pos, p, staging)

        for key, entries in staging.items():
            entries.sort(key=lambda item: item[0])
            self.eval_imgs[key] = [e for _, e in entries]

    def _unpack(self, out, items, cat_pos, p, staging):
        for bi, (i, img_id, entry) in enumerate(items):
            for k, cat in enumerate(entry["cats"]):
                if not out["cell_valid"][bi, k]:
                    continue
                c = cat_pos[cat]
                in_cell = out["dt_in_cell"][bi, k]
                for a in range(len(p.visibility_rng)):
                    staging[c, a].append((i, {
                        "dt_matches":
                            out["dt_matches"][bi, k, a][:, in_cell],
                        "dt_ignore":
                            out["dt_ignore"][bi, k, a][:, in_cell],
                        "dt_scores": out["dt_scores"][bi][in_cell],
                        "gt_ignore": out["gt_ignore"][bi, k, a],
                    }))

    def _pack(self, items, D, G, K):
        n = len(items)
        dt = {"boxes": np.zeros((n, D, 4), np.float32),
              "scores": np.full((n, D), -np.inf, np.float32),
              "cats": np.full((n, D), -1, np.int32),
              "nel": np.zeros((n, D), bool),
              "exists": np.zeros((n, D), bool),
              # Per-image candidate categories; -2 pad can't collide
              # with the -1 category-agnostic pseudo-id.
              "cell_cats": np.full((n, K), -2, np.int32)}
        gt = {"boxes": np.zeros((n, G, 4), np.float32),
              "vis": np.zeros((n, G), np.float32),
              "oof": np.zeros((n, G), bool),
              "ignore0": np.zeros((n, G), np.float32),
              "cats": np.full((n, G), -1, np.int32),
              "exists": np.zeros((n, G), bool)}
        for b, (_i, img_id, entry) in enumerate(items):
            for k, cat in enumerate(entry["cats"][:K]):
                dt["cell_cats"][b, k] = cat
            for j, ann in enumerate(entry["dt"][:D]):
                dt["boxes"][b, j] = ann["bbox"]
                dt["scores"][b, j] = ann["score"]
                dt["cats"][b, j] = ann["category_id"]
                dt["nel"][b, j] = (ann["category_id"]
                                   in self.img_nel[ann["image_id"]])
                dt["exists"][b, j] = True
            for j, ann in enumerate(entry["gt"][:G]):
                gt["boxes"][b, j] = ann["bbox"]
                gt["vis"][b, j] = ann.get("visibility", 1.0)
                gt["oof"][b, j] = bool(ann.get("out_of_frame", False))
                gt["ignore0"][b, j] = ann.get("ignore", 0)
                gt["cats"][b, j] = ann["category_id"]
                gt["exists"][b, j] = True
        return dt, gt

    @staticmethod
    def _segm_ious(items, D, G):
        """Padded ``[n, D, G]`` f32 mask IoU of a chunk's images, on the
        host through the native RLE run-sweep codec (no decode); only
        the (C, A, T) cell machinery runs on the device.  Annotation
        order: the device function applies its own score sort."""
        ious = np.zeros((len(items), D, G), np.float32)
        for b, (_i, _img, entry) in enumerate(items):
            if entry["dt"] and entry["gt"]:
                m = np.asarray(mask_ops.iou(
                    [a["segmentation"] for a in entry["dt"][:D]],
                    [a["segmentation"] for a in entry["gt"][:G]],
                    [0] * len(entry["gt"][:G])), np.float32)
                ious[b, :m.shape[0], :m.shape[1]] = m
        return ious
