"""The evaluators' f32-threshold fixture, without jax.

``chip_smoke.py`` runs the device evaluators on the card against this
fixture, and it imports nothing of jax; ``tests/test_device_tolerance.py``,
where the fixture comes from, imports the JAX package.
"""

import numpy as np


def threshold_fixture(on_threshold, num_videos=2, tracks=12, frames=4,
                      num_cats=2):
    """gt/dt where dt track-IoU sits ON (or just off) the eval
    thresholds 0.5..0.95: ``tests/test_device_tolerance.py::_fixture``,
    copied here without its jax imports (the tests hold the copy equal to
    it)."""
    thrs = np.arange(0.5, 1.0, 0.05)
    videos, images, tracks_j, anns_gt, anns_dt = [], [], [], [], []
    img_id = ann_id = track_id = 1
    for v in range(1, num_videos + 1):
        videos.append({"id": v, "name": f"v{v}", "width": 640,
                       "height": 480, "neg_category_ids": [],
                       "not_exhaustive_category_ids": [],
                       "metadata": {}})
        vid_imgs = []
        for f in range(frames):
            images.append({"id": img_id, "video_id": v,
                           "file_name": f"v{v}/{f}.jpg",
                           "width": 640, "height": 480,
                           "frame_index": f, "license": 0,
                           "neg_category_ids": [],
                           "not_exhaustive_category_ids": []})
            vid_imgs.append(img_id)
            img_id += 1
        for t in range(tracks):
            cat = 1 + t % num_cats
            thr = thrs[t % len(thrs)]
            # gt box [x0, y0, 20, 20]; dt box height h = 20*thr ->
            # per-frame (and 3D) IoU exactly thr.
            x0 = 30.0 * t
            if on_threshold:
                # IoU = thr * (1 - 3e-8): BELOW the threshold in
                # float64 (host: no match) but inside half a float32
                # ulp, so the device's f32 IoU rounds onto the
                # threshold (match) — a guaranteed precision flip.
                h = 20.0 * thr * (1.0 - 3e-8)
            else:
                h = 20.0 * thr + 0.1  # ~5e-3 IoU off the threshold
            tracks_j.append({"id": track_id, "video_id": v,
                             "category_id": cat})
            for f, iid in enumerate(vid_imgs):
                anns_gt.append({
                    "id": ann_id, "image_id": iid, "video_id": v,
                    "track_id": track_id, "category_id": cat,
                    "bbox": [x0, 0.0, 20.0, 20.0], "area": 400.0,
                    "iscrowd": 0, "segmentation": [],
                    "visibility": 1.0})
                ann_id += 1
                anns_dt.append({
                    "image_id": iid, "video_id": v,
                    "track_id": track_id, "category_id": cat,
                    "bbox": [x0, 0.0, 20.0, h],
                    "score": 0.5})  # ALL scores tied
            track_id += 1
    cats = [{"id": c, "name": f"c{c}", "synset": "x",
             "frequency": "f", "image_count": 1, "instance_count": 1}
            for c in range(1, num_cats + 1)]
    gt = {"videos": videos, "images": images, "tracks": tracks_j,
          "annotations": anns_gt, "categories": cats,
          "licenses": [{"id": 0, "name": "", "url": ""}]}
    return gt, anns_dt
