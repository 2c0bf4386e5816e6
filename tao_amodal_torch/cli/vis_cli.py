"""Visualization command-line entry points.

Port of :mod:`tao_amodal_tpu.cli.vis_cli` (the reference's
``visualization/vis_amodal_mask_videos.py``, ``vis_prediction.py``,
``vis_prediction_comparison.py`` and the shared argparse of
``visualization/utils.py``): annotation or prediction videos on the 1.5x
padded white canvas with amodal and modal boxes, BURST masks,
interpolation, slow-down, track filtering, and a fan-out over videos.
Drawing is numpy on the host (:mod:`tao_amodal_torch.utils.vis`, no cv2);
frames go to :func:`tao_amodal_torch.utils.video.video_writer` (imageio,
then cv2, then a PNG frame directory, whichever is installed first).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from collections import defaultdict

import numpy as np

from tao_amodal_torch.data.tao import TaoDataset
from tao_amodal_torch.utils import vis as vis_utils
from tao_amodal_torch.utils.interpolation import interpolate_annotations
from tao_amodal_torch.utils.video import video_writer

logger = logging.getLogger(__name__)


def default_arg_parser(description=""):
    """Shared flags (reference ``visualization/utils.py:10-105``)."""
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--annotation", type=str, required=True)
    p.add_argument("--images_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--video_name", type=str, default=None)
    p.add_argument("--prediction", type=str, default=None)
    p.add_argument("--prediction2", type=str, default=None,
                   help="second prediction set (comparison mode)")
    p.add_argument("--mask_annotations", type=str, default=None,
                   help="BURST mask annotation JSON")
    p.add_argument("--score_threshold", type=float, default=0.5)
    p.add_argument("--interpolate", action="store_true")
    p.add_argument("--clip_annotation", action="store_true",
                   help="clip amodal boxes to the frame bounds "
                        "(reference utils.py:215-224)")
    p.add_argument("--transparent", action="store_true",
                   help="dim background outside boxes")
    p.add_argument("--modal", action="store_true",
                   help="also draw modal boxes")
    p.add_argument("--show_visibility", action="store_true")
    p.add_argument("--reference_style", action="store_true",
                   help="render GT overlays with the pixel-exact "
                        "reference style (utils/vis_ref.py)")
    p.add_argument("--filter_tracks", type=int, nargs="*", default=None)
    p.add_argument("--expand_ratio", type=float, default=1.5,
                   help="canvas scale factor")
    p.add_argument("--slow_down", type=int, default=1)
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--num_videos", type=int, default=1,
                   help="random sample size when no --video_name")
    p.add_argument("--seed", type=int, default=0)
    return p


class PredictionIndex:
    """Score-thresholded image_id -> predictions map (reference
    ``load_prediction.py:9-29``)."""

    def __init__(self, path, score_threshold=0.0):
        with open(path) as f:
            anns = json.load(f)
        self.img_to_anns = defaultdict(list)
        for ann in anns:
            if ann.get("score", 1.0) >= score_threshold:
                self.img_to_anns[ann["image_id"]].append(ann)

    def __getitem__(self, image_id):
        return self.img_to_anns.get(image_id, [])


def clip_annotation_boxes(anns, width, height):
    """Clip each box to the frame (out-of-frame extent removed)."""
    out = []
    for ann in anns:
        x, y, w, h = ann["bbox"]
        x0, y0 = max(x, 0.0), max(y, 0.0)
        x1, y1 = min(x + w, width), min(y + h, height)
        a = dict(ann)
        a["bbox"] = [x0, y0, max(x1 - x0, 0.0), max(y1 - y0, 0.0)]
        out.append(a)
    return out


def _load_frame(images_dir, file_name, wh):
    from PIL import Image

    path = os.path.join(images_dir, file_name) if images_dir else None
    if path and os.path.exists(path):
        return np.asarray(Image.open(path).convert("RGB"))
    # Frames unavailable: gray placeholder with the right geometry so
    # box/mask layout can still be checked.
    w, h = wh
    return np.full((h, w, 3), 128, np.uint8)


def occlusion_score(dataset, video_id):
    """Mean occludedness of a video's annotations: 1 - visibility when
    the amodal field carries it, else 1 - IoU(modal, amodal)
    (capability of reference ``visualization/utils.py:139-212``
    ``select_video``)."""
    from tao_amodal_torch.ops.boxes import box_iou_matrix

    scores = []
    for im in dataset.vid_img_map[video_id]:
        for ann in dataset.img_ann_map[im["id"]]:
            if "visibility" in ann:
                scores.append(1.0 - float(ann["visibility"]))
            elif "modal_bbox" in ann:
                iou = box_iou_matrix(
                    np.asarray([ann["modal_bbox"]], np.float64),
                    np.asarray([ann["bbox"]], np.float64))
                scores.append(1.0 - float(iou[0, 0]))
    return float(np.mean(scores)) if scores else 0.0


def select_videos(dataset, args, mode="random"):
    names = sorted({v["name"] for v in dataset.vids.values()})
    if args.video_name:
        return [args.video_name]
    if mode == "occlusion":
        ranked = sorted(
            dataset.vids.values(),
            key=lambda v: -occlusion_score(dataset, v["id"]))
        return [v["name"] for v in ranked[:args.num_videos]]
    rng = np.random.RandomState(args.seed)
    k = min(args.num_videos, len(names))
    return list(rng.choice(names, size=k, replace=False))


def render_video(dataset, video, args, category_names,
                 prediction=None, prediction2=None, burst_video=None):
    """Render one video to ``<output_dir>/<video_name>.mp4``."""
    images = sorted(dataset.vid_img_map[video["id"]],
                    key=lambda im: im["frame_index"])
    anns_by_img = dataset.img_ann_map

    if args.interpolate and prediction is None:
        vid_anns = [a for im in images for a in anns_by_img[im["id"]]]
        augmented = interpolate_annotations(vid_anns, dataset.imgs)
        anns_by_img = defaultdict(list)
        for a in augmented:
            anns_by_img[a["image_id"]].append(a)

    out_path = os.path.join(
        args.output_dir, video["name"].replace("/", "_") + ".mp4")
    os.makedirs(args.output_dir, exist_ok=True)

    scale = args.expand_ratio
    wh = (int(round(video["width"] * scale)),
          int(round(video["height"] * scale)))
    if prediction2 is not None:
        wh = (wh[0] * 2, wh[1])

    with video_writer(out_path, fps=args.fps, size_wh=wh) as writer:
        for im in images:
            frame = _load_frame(args.images_dir, im["file_name"],
                                (video["width"], video["height"]))
            canvas, origin = vis_utils.make_padded_canvas(frame, scale)
            anns = (prediction[im["id"]] if prediction is not None
                    else anns_by_img[im["id"]])
            if args.filter_tracks:
                anns = [a for a in anns
                        if a.get("track_id") in set(args.filter_tracks)]
            if args.clip_annotation:
                anns = clip_annotation_boxes(anns, video["width"],
                                             video["height"])
            if burst_video is not None:
                fname = os.path.basename(im["file_name"])
                masks = burst_video.get_mask_by_frame(fname)
                vis_utils.overlay_masks(canvas, masks, origin)
            if args.transparent and anns:
                canvas = vis_utils.transparent_except_boxes(
                    canvas, [a["bbox"] for a in anns], origin=origin)
            if getattr(args, "reference_style", False):
                # The reference's own rendering (the vis_ref family).
                from tao_amodal_torch.utils import vis_ref

                oy, ox = origin[1], origin[0]
                ref_anns = [dict(a, amodal_bbox=a["bbox"])
                            for a in anns]
                cats = {cid: {"name": name} for cid, name in
                        (category_names or {}).items()}
                vis_ref.overlay_amodal_boxes_coco(
                    canvas, ref_anns, oy=oy, ox=ox)
                if cats:
                    vis_ref.overlay_amodal_class_coco(
                        canvas, ref_anns, cats, oy=oy, ox=ox)
                if args.show_visibility:
                    vis_ref.overlay_amodal_visibility_coco(
                        canvas, [dict(a, amodal_is_uncertain=False)
                                 for a in ref_anns], cats,
                        oy=oy, ox=ox)
            elif prediction is not None:
                vis_utils.overlay_prediction_boxes(
                    canvas, anns, origin,
                    score_thr=args.score_threshold,
                    category_names=category_names)
            else:
                vis_utils.overlay_amodal_boxes(
                    canvas, anns, origin,
                    show_visibility=args.show_visibility,
                    category_names=category_names)
                if args.modal:
                    vis_utils.overlay_modal_boxes(
                        canvas, anns, origin,
                        category_names=category_names)
            if prediction2 is not None:
                canvas2, origin2 = vis_utils.make_padded_canvas(
                    frame, scale)
                vis_utils.overlay_prediction_boxes(
                    canvas2, prediction2[im["id"]], origin2,
                    score_thr=args.score_threshold,
                    category_names=category_names)
                canvas = np.concatenate([canvas, canvas2], axis=1)
            for _ in range(max(args.slow_down, 1)):
                writer.write_frame(canvas)
    return out_path


def main(argv=None, mode="annotations"):
    args = default_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dataset = TaoDataset(args.annotation)
    category_names = {c["id"]: c.get("name", str(c["id"]))
                      for c in dataset.cats.values()}

    prediction = (PredictionIndex(args.prediction, args.score_threshold)
                  if args.prediction else None)
    prediction2 = (PredictionIndex(args.prediction2,
                                   args.score_threshold)
                   if args.prediction2 else None)
    burst = None
    if args.mask_annotations:
        from tao_amodal_torch.data.burst import BurstDataset

        burst = BurstDataset(args.mask_annotations, args.images_dir)

    names = select_videos(dataset, args)
    vids = {v["name"]: v for v in dataset.vids.values()}

    def render_one(name):
        video = vids[name]
        burst_video = None
        if burst is not None and name in burst._by_name:
            burst_video = burst.get_video_by_name(name)
        out = render_video(dataset, video, args, category_names,
                           prediction=prediction,
                           prediction2=prediction2,
                           burst_video=burst_video)
        logger.info("wrote %s", out)
        return out

    if args.workers and args.workers > 1 and len(names) > 1:
        # Per-video fan-out over threads (the reference's scripts use a
        # multiprocessing.Pool), as the JAX package does.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(args.workers) as pool:
            return list(pool.map(render_one, names))
    return [render_one(name) for name in names]


if __name__ == "__main__":
    main()
