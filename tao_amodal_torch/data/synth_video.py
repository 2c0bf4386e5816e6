"""Synthetic TAO-Amodal video dataset: rendered frames + annotations.

Port of :mod:`tao_amodal_tpu.data.synth_video` (numpy only, the same
bytes from the same seed; PIL is imported only inside
:func:`write_frames`).  Zero-egress stand-in for real TAO-Amodal data:
videos of moving textured rectangles over a noise background, three
appearance-distinct categories, amodal boxes that keep their full
extent when objects exit the frame (the dataset's defining property --
reference ``README.md:6-20``), visibility from z-order occlusion, and
the GT JSON in the reference's TAO schema
(``tao_amodal/evaluation/tao_amodal/tao.py:1-61``).
:func:`training_batches` samples detector-training batches from it.
"""

from __future__ import annotations

import os

import numpy as np

# Base RGB per category id (1-indexed): appearance is what the
# classifier must learn.
_CAT_COLORS = {
    1: (200, 60, 50),
    2: (60, 190, 70),
    3: (70, 90, 210),
}


def _category_colors(num_categories):
    """Appearance-distinct base RGB per category id (1..n).

    The first three keep the historical palette (closed-loop studies
    and fixtures depend on those exact pixels); extra categories take
    golden-ratio-spaced hues at high saturation — maximally spread
    colors for a classifier that must learn appearance, matching the
    crowded-scene study's need for a wider vocabulary (the reference's
    protocol assumes LVIS-scale category counts,
    ``tao_amodal/evaluation/tao_amodal/results.py:121``)."""
    import colorsys

    colors = dict(_CAT_COLORS)
    for c in range(4, num_categories + 1):
        h = (c * 0.6180339887) % 1.0
        r, g, b = colorsys.hsv_to_rgb(h, 0.85, 0.82)
        colors[c] = (int(r * 255), int(g * 255), int(b * 255))
    return colors


def _draw_rect(frame, x0, y0, x1, y1, color, texture):
    H, W = frame.shape[:2]
    ix0, iy0 = max(0, int(x0)), max(0, int(y0))
    ix1, iy1 = min(W, int(x1)), min(H, int(y1))
    if ix1 <= ix0 or iy1 <= iy0:
        return
    patch = np.asarray(color, np.float32)[None, None, :] + texture[
        iy0 - int(y0):iy0 - int(y0) + iy1 - iy0,
        ix0 - int(x0):ix0 - int(x0) + ix1 - ix0]
    frame[iy0:iy1, ix0:ix1] = np.clip(patch, 0, 255).astype(np.uint8)


def make_synth_videos(seed=0, num_videos=8, frames_per_video=32,
                      hw=512, tracks_per_video=6, min_size=14,
                      max_size=150, num_categories=3):
    """Generate videos; returns ``(gt_dict, frames)`` with ``frames`` a
    dict ``video_id -> uint8 [T, H, W, 3]``."""
    rng = np.random.RandomState(seed)
    H = W = hw
    cat_colors = _category_colors(num_categories)
    categories = [
        {"id": c, "name": f"synth_cat_{c}", "synset": "unknown",
         "frequency": "cf f"[c % 2], "image_count": num_videos,
         "instance_count": num_videos * tracks_per_video}
        for c in cat_colors
    ]
    for c in categories:
        c["frequency"] = ["r", "c", "f"][c["id"] % 3]

    videos, images, tracks, annotations = [], [], [], []
    frames_by_video = {}
    img_id = ann_id = track_id = 1

    for v in range(1, num_videos + 1):
        videos.append({
            "id": v, "name": f"synth_video_{v}", "width": W,
            "height": H, "neg_category_ids": [],
            "not_exhaustive_category_ids": [],
            "metadata": {"dataset": "synthetic"},
        })
        vid_img_ids = []
        for f in range(frames_per_video):
            images.append({
                "id": img_id, "video_id": v,
                "file_name": f"synth_video_{v}/frame_{f:04d}.png",
                "license": 0, "width": W, "height": H,
                "frame_index": f, "neg_category_ids": [],
                "not_exhaustive_category_ids": [],
            })
            vid_img_ids.append(img_id)
            img_id += 1

        # Object state: z-order = index (later drawn on top).
        objs = []
        for z in range(tracks_per_video):
            cat = int(rng.randint(1, len(cat_colors) + 1))
            w0 = float(rng.uniform(min_size, max_size))
            h0 = float(rng.uniform(min_size, max_size))
            objs.append({
                "track_id": track_id, "cat": cat, "w": w0, "h": h0,
                "cx": float(rng.uniform(0.1 * W, 0.9 * W)),
                "cy": float(rng.uniform(0.1 * H, 0.9 * H)),
                "vx": float(rng.uniform(-6, 6)),
                "vy": float(rng.uniform(-6, 6)),
                "color": np.asarray(cat_colors[cat], np.float32)
                * float(rng.uniform(0.8, 1.2)),
                "tex_seed": int(rng.randint(1 << 30)),
            })
            tracks.append({"id": track_id, "category_id": cat,
                           "video_id": v})
            track_id += 1

        vid_frames = np.empty((frames_per_video, H, W, 3), np.uint8)
        for f in range(frames_per_video):
            frame = rng.randint(70, 110, (H, W, 3)).astype(np.uint8)
            boxes_px = []
            for o in objs:
                cx = o["cx"] + o["vx"] * f
                cy = o["cy"] + o["vy"] * f
                x0, x1 = cx - o["w"] / 2, cx + o["w"] / 2
                y0, y1 = cy - o["h"] / 2, cy + o["h"] / 2
                trng = np.random.RandomState(o["tex_seed"])
                tex = trng.uniform(-25, 25, (int(o["h"]) + 2,
                                             int(o["w"]) + 2, 3))
                _draw_rect(frame, x0, y0, x1, y1, o["color"], tex)
                boxes_px.append((x0, y0, x1, y1))
            vid_frames[f] = frame

            # Annotations: amodal bbox keeps the full extent; visible
            # area discounts frame clipping AND later-drawn occluders.
            for zi, (o, (x0, y0, x1, y1)) in enumerate(
                    zip(objs, boxes_px)):
                area = (x1 - x0) * (y1 - y0)
                vx0, vy0 = max(x0, 0.0), max(y0, 0.0)
                vx1, vy1 = min(x1, float(W)), min(y1, float(H))
                if vx1 <= vx0 or vy1 <= vy0:
                    vis_area = 0.0
                else:
                    # Monte-Carlo-free visibility: subtract occluder
                    # overlaps (union approximated by max single
                    # overlap; exact enough for eval splits).
                    vis_area = (vx1 - vx0) * (vy1 - vy0)
                    occ = 0.0
                    for (ox0, oy0, ox1, oy1) in boxes_px[zi + 1:]:
                        ix = max(0.0, min(vx1, ox1) - max(vx0, ox0))
                        iy = max(0.0, min(vy1, oy1) - max(vy0, oy0))
                        occ = max(occ, ix * iy)
                    vis_area = max(vis_area - occ, 0.0)
                if area <= 0:
                    continue
                annotations.append({
                    "id": ann_id,
                    "image_id": vid_img_ids[f],
                    "video_id": v,
                    "track_id": o["track_id"],
                    "bbox": [round(float(x0), 1), round(float(y0), 1),
                             round(float(x1 - x0), 1),
                             round(float(y1 - y0), 1)],
                    "area": round(float(area), 1),
                    "category_id": o["cat"],
                    "visibility": round(float(vis_area / area), 3),
                    "out_of_frame": bool(x0 < 0 or y0 < 0 or x1 > W
                                         or y1 > H),
                })
                ann_id += 1
        frames_by_video[v] = vid_frames

    gt = {
        "info": {"description": "synthetic TAO-Amodal videos"},
        "images": images, "videos": videos, "tracks": tracks,
        "annotations": annotations, "categories": categories,
        "licenses": [{"id": 0, "name": "synthetic", "url": ""}],
    }
    return gt, frames_by_video


def write_frames(gt, frames_by_video, images_dir):
    """Write frames to ``images_dir`` per the TAO file layout."""
    from PIL import Image

    by_video = {}
    for im in gt["images"]:
        by_video.setdefault(im["video_id"], []).append(im)
    for v, ims in by_video.items():
        arr = frames_by_video[v]
        for im in sorted(ims, key=lambda i: i["frame_index"]):
            path = os.path.join(images_dir, im["file_name"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(arr[im["frame_index"]]).save(path)


# Threads that make a training batch's frames.
FRAME_WORKERS = 8


def _augmented_frame(frame, flip, scale, gain, shift, out):
    """One training frame into ``out`` (f32 ``[H, W, 3]``): JAX's
    augmentation of the uint8 ``frame`` (a flip, a nearest-neighbour
    rescale padded or cropped back to ``H x W``, then ``clip(x * gain +
    shift, 0, 255)`` in f32), the same values.  The pixels are moved as
    uint8 and converted once."""
    H, W = frame.shape[:2]
    if scale is None:
        src = frame[:, ::-1] if flip else frame
    else:
        nh, nw = max(int(H * scale), 8), max(int(W * scale), 8)
        ys = np.clip((np.arange(nh) / scale).astype(np.int64), 0, H - 1)
        xs = np.clip((np.arange(nw) / scale).astype(np.int64), 0, W - 1)
        if flip:
            xs = W - 1 - xs
        ch, cw = min(nh, H), min(nw, W)
        src = np.zeros((H, W, 3), np.uint8)
        src[:ch, :cw] = frame[ys[:ch]][:, xs[:cw]]
    np.copyto(out, src, casting="unsafe")
    if gain is not None:
        np.multiply(out, np.float32(gain), out=out)
        np.add(out, np.float32(shift), out=out)
        np.clip(out, 0, 255, out=out)


def training_batches(gt, frames_by_video, rng, batch_size, max_gt=8,
                     steps=100, augment=False, scale_range=(0.7, 1.3)):
    """Yield detector-training batches (images + visible/amodal gt)
    sampled from the synthetic videos.

    ``augment=True`` adds horizontal flips, multi-scale jitter (resize
    by a factor in ``scale_range``, then pad/crop back to the fixed
    HxW — static shapes for XLA), and brightness jitter, matching the
    levers the closed-loop study needs to train a detector whose
    deltas exceed noise (VERDICT r2 item 2).  The draws are taken in
    JAX's order on the host thread; a batch's frames are then made by
    :data:`FRAME_WORKERS` threads (numpy releases the GIL in the copies
    and the arithmetic).
    """
    from concurrent.futures import ThreadPoolExecutor

    images = gt["images"]
    anns_by_img = {}
    for a in gt["annotations"]:
        anns_by_img.setdefault(a["image_id"], []).append(a)
    W = images[0]["width"]
    H = images[0]["height"]
    pool = ThreadPoolExecutor(FRAME_WORKERS)
    try:
        for _ in range(steps):
            batch_imgs = np.empty((batch_size, H, W, 3), np.float32)
            gt_boxes = np.zeros((batch_size, max_gt, 4), np.float32)
            gt_amodal = np.zeros((batch_size, max_gt, 4), np.float32)
            gt_classes = np.zeros((batch_size, max_gt), np.int32)
            gt_valid = np.zeros((batch_size, max_gt), bool)
            jobs = []
            for b in range(batch_size):
                im = images[rng.randint(len(images))]
                frame = frames_by_video[im["video_id"]][im["frame_index"]]
                anns = anns_by_img.get(im["id"], [])[:max_gt]
                boxes = np.asarray(
                    [a["bbox"] for a in anns], np.float32).reshape(-1, 4)
                boxes = np.stack([boxes[:, 0], boxes[:, 1],
                                  boxes[:, 0] + boxes[:, 2],
                                  boxes[:, 1] + boxes[:, 3]],
                                 axis=1) if len(boxes) else boxes
                flip, scale, gain, shift = False, None, None, None
                if augment:
                    if rng.rand() < 0.5:  # horizontal flip
                        flip = True
                        if len(boxes):
                            boxes = np.stack(
                                [W - boxes[:, 2], boxes[:, 1],
                                 W - boxes[:, 0], boxes[:, 3]], axis=1)
                    s = rng.uniform(*scale_range)  # multi-scale jitter
                    if abs(s - 1.0) > 1e-3:
                        scale = s
                        boxes = boxes * s
                    gain = rng.uniform(0.8, 1.2)   # brightness
                    shift = rng.uniform(-15, 15)
                jobs.append(pool.submit(_augmented_frame, frame, flip, scale,
                                        gain, shift, batch_imgs[b]))
                for g, a in enumerate(anns):
                    x0, y0, x1, y1 = boxes[g]
                    gt_amodal[b, g] = [x0, y0, x1, y1]
                    gt_boxes[b, g] = [max(x0, 0), max(y0, 0),
                                      min(x1, W), min(y1, H)]
                    gt_classes[b, g] = a["category_id"]
                    gt_valid[b, g] = (gt_boxes[b, g, 2] > gt_boxes[b, g, 0]
                                      and gt_boxes[b, g, 3]
                                      > gt_boxes[b, g, 1])
            for job in jobs:
                job.result()
            yield {"images": batch_imgs, "gt_boxes": gt_boxes,
                   "gt_amodal": gt_amodal, "gt_classes": gt_classes,
                   "gt_valid": gt_valid}
    finally:
        pool.shutdown(wait=True)
