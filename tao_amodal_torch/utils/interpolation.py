"""Track box interpolation between annotated keyframes.

Port of :mod:`tao_amodal_tpu.utils.interpolation` (the reference's
``visualization/tao/utils/coco.py:1-63``): linear interpolation of a
track's boxes on the frames between its annotated keyframes, for the
modal or the amodal box field; one ``np.interp`` per coordinate and track.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def interpolate_track(frame_indices, boxes, all_frames):
    """Linearly interpolate ``[K, 4]`` boxes at ``all_frames``.

    Frames outside [min, max] of the keyframes are left out (no
    extrapolation, as the reference).  Returns (frames, boxes).
    """
    frame_indices = np.asarray(frame_indices)
    boxes = np.asarray(boxes, np.float64)
    order = np.argsort(frame_indices)
    fi = frame_indices[order]
    bx = boxes[order]
    lo, hi = fi[0], fi[-1]
    targets = np.asarray([f for f in all_frames if lo <= f <= hi])
    if targets.size == 0:
        return targets, np.zeros((0, 4))
    out = np.stack([np.interp(targets, fi, bx[:, i]) for i in range(4)],
                   axis=1)
    return targets, out


def interpolate_annotations(anns, images_by_id, bbox_field="bbox"):
    """Fill each track's gaps with interpolated annotations.

    ``anns``: annotation dicts (``track_id``, ``image_id``,
    ``bbox_field``); ``images_by_id``: image id -> image dict (its
    ``frame_index`` and ``video_id``).  Returns the annotations with the
    synthesized ones appended, each marked ``{"interpolated": True}``.
    """
    by_track = defaultdict(list)
    for ann in anns:
        by_track[ann["track_id"]].append(ann)

    video_frames = defaultdict(list)
    for img in images_by_id.values():
        video_frames[img["video_id"]].append(img)
    for v in video_frames:
        video_frames[v].sort(key=lambda im: im["frame_index"])

    out = list(anns)
    for track_anns in by_track.values():
        if len(track_anns) < 2:
            continue
        img0 = images_by_id[track_anns[0]["image_id"]]
        frames = video_frames[img0["video_id"]]
        fidx = [im["frame_index"] for im in frames]
        key_f = [images_by_id[a["image_id"]]["frame_index"]
                 for a in track_anns]
        key_b = [a[bbox_field] for a in track_anns]
        have = set(key_f)
        targets, boxes = interpolate_track(key_f, key_b, fidx)
        frame_to_img = {im["frame_index"]: im["id"] for im in frames}
        proto = track_anns[0]
        for f, b in zip(targets, boxes):
            if f in have:
                continue
            out.append({
                **{k: proto[k] for k in ("track_id", "category_id")
                   if k in proto},
                "image_id": frame_to_img[int(f)],
                bbox_field: [float(x) for x in b],
                "area": float(b[2] * b[3]),
                "interpolated": True,
            })
    return out
