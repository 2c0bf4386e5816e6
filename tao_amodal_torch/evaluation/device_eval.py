"""Device-backed Track-mAP evaluation.

The port of ``tao_amodal_tpu/evaluation/device_eval.py::DeviceTrackEval``:
glue between the host dataset plumbing and the batched device tensors
(:func:`tao_amodal_torch.evaluation.batched.eval_video_device`).  Videos
are packed into padded buckets (powers of two on every axis), each
bucket evaluates in chunks of a fixed size under a memory budget, every
chunk in one batched call across all (category x area x time x
threshold) cells, and accumulation reuses the host precision/recall
math on the device's match tensors.

The host evaluator stays the float64 parity oracle; float32 IoU can flip
a comparison that lies within an f32 ulp of a threshold, so device
metrics may differ in the last decimals (``tests/test_device_tolerance.py``
states the contract).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from tao_amodal_torch.evaluation.batched import (
    eval_video_device,
    resolve_device,
)
from tao_amodal_torch.evaluation.track_eval import TrackMapEvaluator
from tao_amodal_torch.ops.track_iou import track_mask_iou_matrix


def _next_pow2(n, lo=8):
    p = lo
    while p < n:
        p *= 2
    return p


def to_device(arrays, device):
    """numpy dict -> dict of tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


class DeviceTrackEval(TrackMapEvaluator):
    """TrackMapEvaluator with the per-video cell math on ``device``.

    ``device`` is ``"cuda"`` unless the caller asks for another; without
    a card ``"cuda"`` raises.

    With ``mesh`` (a :mod:`tao_amodal_torch.parallel` mesh; every rank
    of it evaluates, with ``device`` its own), each video is evaluated
    alone, and a bbox video whose padded frame axis is at
    least ``cp_min_frames`` and divides over the mesh's data axis takes
    its track-IoU matrix context-parallel: frames split over the ranks,
    the partial (I, U) sums combined with one ``all_reduce``
    (:func:`~tao_amodal_torch.parallel.cp.sharded_track_iou`), exact by
    the 3D-IoU decomposition, as JAX's ``psum``.
    """

    # Memory bound of one chunk's match tensors, and the least chunk.
    chunk_budget_bytes = 100 << 20
    min_chunk = 4

    def __init__(self, *args, mesh=None, cp_min_frames=64, device="cuda",
                 **kwargs):
        self.device = resolve_device(device)
        self._mesh = mesh
        self._cp_min_frames = cp_min_frames
        super().__init__(*args, **kwargs)

    def _cell_ious(self, dt_pack, gt_pack, F):
        """The video's ``[D, G]`` track IoU, context-parallel, or None
        (computed by the batched call) where the video is short or its
        frames do not split over the mesh."""
        n_data = self._mesh.shape["data"]
        if F < self._cp_min_frames or F % n_data:
            return None
        from tao_amodal_torch.parallel.cp import sharded_track_iou

        return sharded_track_iou(
            self._mesh, dt_pack["boxes"], dt_pack["frame_valid"],
            gt_pack["boxes"], gt_pack["frame_valid"]).to(self.device)

    def evaluate(self, show_progress=False):
        del show_progress
        self.logger.info("Running per video evaluation.")
        self.logger.info(
            "Evaluate annotation type *{}*".format(self.params.iou_type))
        p = self.params
        p.vid_ids = list(np.unique(p.vid_ids))
        cat_ids = p.cat_ids if p.use_cats else [-1]
        gt_cells, dt_cells = self._grouped_tracks()

        # Group cells per video and pack to padded buckets.
        per_video = defaultdict(lambda: {"dt": [], "gt": []})
        for (vid, cat), tracks in gt_cells.items():
            per_video[vid]["gt"].extend(tracks)
        for (vid, cat), tracks in dt_cells.items():
            per_video[vid]["dt"].extend(tracks)

        dev = self.device
        area_arr = torch.tensor(np.asarray(p.area_rng, np.float32),
                                device=dev)
        time_arr = torch.tensor(np.asarray(p.time_rng, np.float32),
                                device=dev)
        use_occ = torch.tensor(
            np.arange(len(p.area_rng)) == len(p.area_rng) - 1, device=dev)
        thrs = torch.tensor(np.asarray(p.iou_thrs, np.float32), device=dev)

        # Bucket videos by padded (D, G, F, K); each chunk of a bucket is
        # one batched call (per-video calls would be launch-bound).
        cat_pos = {cat: c for c, cat in enumerate(cat_ids)}
        buckets = defaultdict(list)
        for v, vid_id in enumerate(p.vid_ids):
            entry = per_video.get(vid_id)
            if entry is None or (not entry["dt"] and not entry["gt"]):
                continue
            present = sorted({tr["category_id"]
                              for side in ("dt", "gt")
                              for tr in entry[side]
                              if tr["category_id"] in cat_pos})
            K = _next_pow2(max(len(present), 1), lo=4)
            dt_pack, gt_pack, F = self._pack(entry, p)
            cell_cats = np.full((K,), -2, np.int32)
            cell_cats[:len(present)] = present
            dt_pack["cell_cats"] = cell_cats
            D = dt_pack["boxes"].shape[0]
            G = gt_pack["boxes"].shape[0]
            if p.iou_type == "segm":
                ious = self._segm_ious(entry, p, D, G)
            elif self._mesh is not None:
                ious = self._cell_ious(dt_pack, gt_pack, F)
            else:
                ious = None
            buckets[D, G, F, K].append((v, dt_pack, gt_pack, present, ious))

        self.eval_vids = defaultdict(list)
        staged = []  # (video index, host out dict, present cats)
        for (D, G, F, K), items in sorted(buckets.items()):
            per_video_bytes = K * len(p.area_rng) * len(p.time_rng) \
                * len(p.iou_thrs) * (D + G) * 3
            chunk = max(self.min_chunk,
                        min(1024, self.chunk_budget_bytes
                            // max(per_video_bytes, 1)))
            chunk = min(chunk, _next_pow2(len(items), lo=self.min_chunk))
            if self._mesh is not None:
                # Context-parallel mode: a video a call (its track IoU
                # may come from the frame-sharded sums), as JAX's.
                chunk = 1
            for s in range(0, len(items), chunk):
                part = items[s:s + chunk]

                def stack(idx):
                    return to_device(
                        {k: np.stack([it[idx][k] for it in part])
                         for k in part[0][idx]}, dev)

                ious = [it[4] for it in part]
                seg = (None if ious[0] is None else torch.stack(
                    [torch.as_tensor(i) for i in ious]).to(dev))
                out = eval_video_device(stack(1), stack(2), area_arr,
                                        time_arr, use_occ, thrs,
                                        hp_min_frames=p.hp_min_frames,
                                        ious=seg)
                out = {k: val.cpu().numpy() for k, val in out.items()}
                for bi, (v, _d, _g, present, _s) in enumerate(part):
                    staged.append(
                        (v, {k: val[bi] for k, val in out.items()},
                         present))
        # Unpack in VIDEO order: accumulate()'s stable score sort is
        # order-sensitive on ties, and the host oracle appends cells in
        # video order.
        staged.sort(key=lambda item: item[0])
        for _v, out, present in staged:
            self._unpack_video(out, present, cat_pos, p)

    def _unpack_video(self, out, present, cat_pos, p):
        for k, cat in enumerate(present):
            if not out["cell_valid"][k]:
                continue
            c = cat_pos[cat]
            in_cell = out["dt_in_cell"][k]
            for a in range(len(p.area_rng)):
                for t in range(len(p.time_rng)):
                    self.eval_vids[c, a, t].append({
                        "dt_matches":
                            out["dt_matches"][k, a, t][:, in_cell],
                        "dt_ignore":
                            out["dt_ignore"][k, a, t][:, in_cell],
                        "dt_scores": out["dt_scores"][in_cell],
                        "gt_ignore": out["gt_ignore"][k, a, t],
                    })

    def _pack(self, entry, p):
        """One video's tracks as padded numpy arrays (dt, gt, F)."""
        frames = sorted({ann["image_id"] for side in ("dt", "gt")
                         for tr in entry[side]
                         for ann in tr["annotations"]})
        fidx = {f: i for i, f in enumerate(frames)}
        # Pow2 buckets on every axis: few bucket shapes to batch over.
        F = _next_pow2(max(len(frames), 1))
        D = _next_pow2(len(entry["dt"]))
        G = _next_pow2(len(entry["gt"]))

        def base(n):
            return {
                "boxes": np.zeros((n, F, 4), np.float32),
                "frame_valid": np.zeros((n, F), bool),
                "cats": np.full((n,), -1, np.int32),
                "areas": np.zeros((n,), np.float32),
                "durs": np.zeros((n,), np.float32),
                "exists": np.zeros((n,), bool),
            }

        dt = base(D)
        dt["scores"] = np.full((D,), -np.inf, np.float32)
        dt["nel"] = np.zeros((D,), bool)
        for i, tr in enumerate(entry["dt"]):
            for ann in tr["annotations"]:
                f = fidx[ann["image_id"]]
                dt["boxes"][i, f] = ann["bbox"]
                dt["frame_valid"][i, f] = True
            dt["cats"][i] = tr["category_id"]
            dt["areas"][i] = tr["area"]
            dt["durs"][i] = len(tr["annotations"])
            dt["scores"][i] = tr["score"]
            dt["nel"][i] = (tr["category_id"]
                            in self.vid_nel[tr["video_id"]])
            dt["exists"][i] = True

        gt = base(G)
        gt["hp_frames"] = np.zeros((G,), np.float32)
        gt["ignore0"] = np.zeros((G,), np.float32)
        for i, tr in enumerate(entry["gt"]):
            for ann in tr["annotations"]:
                f = fidx[ann["image_id"]]
                gt["boxes"][i, f] = ann["bbox"]
                gt["frame_valid"][i, f] = True
            gt["cats"][i] = tr["category_id"]
            gt["areas"][i] = tr["area"]
            gt["durs"][i] = len(tr["annotations"])
            gt["hp_frames"][i] = sum(
                a["visibility"] < p.hp_visibility_thr
                for a in tr["annotations"])
            gt["ignore0"][i] = tr.get("ignore", 0)
            gt["exists"][i] = True
        return dt, gt, F

    def _segm_ious(self, entry, p, D, G):
        """Padded ``[D, G]`` f32 mask track-IoU matrix of one video.

        Mask runs stay on the host (the native RLE run-sweep codec:
        shipping dense HxW masks per track would swamp the host-device
        link); the (C, A, T, thr) matching cells still run on the
        device.  Annotation-order matrix: the device function applies
        its own score sort.
        """
        frames = sorted({ann["image_id"] for side in ("dt", "gt")
                         for tr in entry[side]
                         for ann in tr["annotations"]})
        fidx = {f: i for i, f in enumerate(frames)}
        out = np.zeros((D, G), np.float32)
        if entry["dt"] and entry["gt"]:
            m = np.asarray(track_mask_iou_matrix(
                self._track_rle_columns(entry["dt"], fidx),
                self._track_rle_columns(entry["gt"], fidx),
                mode=p.iou_3d_type), np.float32)
            out[:m.shape[0], :m.shape[1]] = m
        return out
