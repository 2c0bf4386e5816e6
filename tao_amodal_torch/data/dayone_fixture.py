"""A schema-exact TAO-Amodal directory tree from synthetic videos.

Port of ``tools/make_dayone_fixture.py::build``: the official dataset
layout (reference ``README.md:66-85``) from
:func:`~tao_amodal_torch.data.synth_video.make_synth_videos`, so that a
real-data command sequence (frames on disk, the annotation file, the
inference and evaluation CLIs) runs end to end without the dataset::

    TAO-Amodal/
      frames/train/{ArgoVerse,BDD,Charades,HACS,LaSOT,YFCC100M}/<video>/
      amodal_annotations/validation_lvis_v1.json
      example_output/prediction.json      (jittered ground truth)
      BURST_annotations/train/train_visibility.json  (RLE masks)

The same seed writes the same JSON and the same image bytes as the JAX
tool (the same arrays through the same PIL call; PIL is imported only
inside :func:`build`); the BURST masks are encoded by the port's RLE
codec (:mod:`tao_amodal_torch.ops.mask`).
"""

from __future__ import annotations

import json
import os

import numpy as np

SOURCES = ["ArgoVerse", "BDD", "Charades", "HACS", "LaSOT", "YFCC100M"]


def _jittered_predictions(gt, seed):
    """``example_output/prediction.json``: the ground truth with 15 %
    dropped and its boxes jittered (the official schema and key order,
    reference ``README.md:107-116``)."""
    rng = np.random.RandomState(seed + 1)
    preds = []
    for a in gt["annotations"]:
        if rng.rand() < 0.15:
            continue
        x, y, w, h = a["bbox"]
        jit = rng.randn(4) * 2.0
        preds.append({
            "image_id": a["image_id"],
            "category_id": a["category_id"],
            "bbox": [round(float(x + jit[0]), 2),
                     round(float(y + jit[1]), 2),
                     round(float(max(w + jit[2], 2.0)), 2),
                     round(float(max(h + jit[3], 2.0)), 2)],
            "score": round(float(rng.uniform(0.3, 1.0)), 4),
            "track_id": a["track_id"],
            "video_id": a["video_id"],
        })
    return preds


def _burst_sequences(gt):
    """BURST sequences: each annotation's visible rectangle as an RLE
    mask, per frame and track."""
    from tao_amodal_torch.ops import mask as mask_ops

    anns_by_img, imgs_by_video = {}, {}
    for a in gt["annotations"]:
        anns_by_img.setdefault(a["image_id"], []).append(a)
    for im in gt["images"]:
        imgs_by_video.setdefault(im["video_id"], []).append(im)
    sequences = []
    for v in gt["videos"]:
        imgs = sorted(imgs_by_video[v["id"]],
                      key=lambda im: im["frame_index"])
        segmentations, track_cats = [], {}
        for im in imgs:
            seg = {}
            for a in anns_by_img.get(im["id"], []):
                x, y, w, h = a["bbox"]
                m = np.zeros((v["height"], v["width"]), np.uint8)
                x0, y0 = max(int(x), 0), max(int(y), 0)
                x1 = min(int(x + w), v["width"])
                y1 = min(int(y + h), v["height"])
                if x1 <= x0 or y1 <= y0:
                    continue
                m[y0:y1, x0:x1] = 1
                counts = mask_ops.encode(m)["counts"]
                seg[str(a["track_id"])] = {
                    "rle": counts.decode() if isinstance(counts, bytes)
                    else counts}
                track_cats[str(a["track_id"])] = a["category_id"]
            segmentations.append(seg)
        src, seq = v["name"].split("/")[1:]
        sequences.append({
            "id": v["id"], "width": v["width"], "height": v["height"],
            "dataset": src, "seq_name": seq,
            "annotated_image_paths": [
                os.path.basename(im["file_name"]) for im in imgs],
            "segmentations": segmentations,
            "track_category_ids": track_cats,
        })
    return sequences


def _write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def build(out, num_videos=6, frames_per_video=16, hw=160,
          tracks_per_video=4, seed=0, jpeg=True):
    """Write the tree under ``<out>/TAO-Amodal``; returns that root."""
    from PIL import Image

    from tao_amodal_torch.data.synth_video import make_synth_videos

    root = os.path.join(out, "TAO-Amodal")
    gt, frames_by_video = make_synth_videos(
        seed=seed, num_videos=num_videos, frames_per_video=frames_per_video,
        hw=hw, tracks_per_video=tracks_per_video)

    ext = "jpg" if jpeg else "png"
    # The official source-bucketed names: video "train/<SOURCE>/<seq>",
    # file names relative to frames/.
    names = {}
    for v in gt["videos"]:
        src = SOURCES[(v["id"] - 1) % len(SOURCES)]
        names[v["id"]] = v["name"] = f"train/{src}/video_{v['id']:04d}"
        v["metadata"] = {"dataset": src}
    for im in gt["images"]:
        im["file_name"] = (f"{names[im['video_id']]}/"
                           f"frame_{im['frame_index']:04d}.{ext}")
    for im in gt["images"]:
        path = os.path.join(root, "frames", im["file_name"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(
            frames_by_video[im["video_id"]][im["frame_index"]]).save(path)

    _write_json(os.path.join(root, "amodal_annotations",
                             "validation_lvis_v1.json"), gt)
    _write_json(os.path.join(root, "example_output", "prediction.json"),
                _jittered_predictions(gt, seed))
    _write_json(os.path.join(root, "BURST_annotations", "train",
                             "train_visibility.json"),
                {"split": "train", "sequences": _burst_sequences(gt)})
    return root


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--videos", type=int, default=6)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--hw", type=int, default=160)
    p.add_argument("--tracks", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    root = build(args.out, args.videos, args.frames, args.hw, args.tracks,
                 args.seed)
    for dirpath, _, filenames in sorted(os.walk(root)):
        rel = os.path.relpath(dirpath, root)
        if rel.count(os.sep) < 2:
            print(f"{rel}/ ({len(filenames)} files)")
    print("fixture root:", root)
    return root
