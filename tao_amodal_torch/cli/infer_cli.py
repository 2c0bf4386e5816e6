"""Inference CLI: video frames -> tracked amodal prediction JSON.

Port of :mod:`tao_amodal_tpu.cli.infer_cli` (single-stream path): run
the pipeline (detector -> expander -> SORT) over a dataset's videos,
SORT state threaded across each video's clips, and write the prediction
JSON the evaluator consumes.  Flags match the JAX CLI's, all but
``--data_parallel`` (the multi-device lanes, ROADMAP.md Queue A #8);
``--assignment`` picks SORT's association (greedy, gated_auction or
auction), ``--fused_stages 1,2,3,4`` runs those trunk stages through the
fused bottleneck-chain kernel (B4) and ``--device`` picks the card.

Frames load from ``--images_dir`` per the TAO layout; a missing frame
falls back to synthetic gray (PIL is imported only when a frame file
exists), so the path runs end to end without the dataset.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

logger = logging.getLogger(__name__)

# Track ids are emitted as video_id * 10**6 + sort_id; a SORT id at or
# past 10**6 would collide with the next video's ids.
TRACK_ID_STRIDE = 10 ** 6


def load_clip(images, images_dir, size_hw):
    frames = []
    for im in images:
        path = (os.path.join(images_dir, im["file_name"])
                if images_dir else None)
        if path and os.path.exists(path):
            from PIL import Image

            frames.append(np.asarray(Image.open(path).convert("RGB")))
        else:
            frames.append(np.full((*size_hw, 3), 128, np.uint8))
    return np.stack(frames)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--annotation", required=True,
                   help="TAO-Amodal annotation JSON (for video/frame "
                        "ids)")
    p.add_argument("--images_dir", default=None)
    p.add_argument("--output", required=True,
                   help="prediction JSON path "
                        "(lvis_instances_results.json)")
    p.add_argument("--checkpoint", default=None,
                   help="npz of the JAX pipeline variables "
                        "(tao_amodal_tpu.utils.checkpoint.save_pytree)")
    p.add_argument("--input_size", type=int, default=512)
    p.add_argument("--clip_len", type=int, default=8,
                   help="frames per clip (output-invariant: SORT state "
                        "threads across clips)")
    p.add_argument("--score_threshold", type=float, default=0.05)
    p.add_argument("--num_videos", type=int, default=None)
    # Architecture flags (must match the checkpoint being loaded).
    p.add_argument("--backbone_stages", default="3,4,6,3",
                   help="comma list of ResNet stage sizes")
    p.add_argument("--num_dets", type=int, default=64)
    p.add_argument("--num_proposals", type=int, default=96)
    p.add_argument("--pre_nms_topk", type=int, default=100)
    p.add_argument("--assignment", default="greedy",
                   choices=["greedy", "gated_auction", "auction"])
    p.add_argument("--fused_stages", default="",
                   help="comma list of trunk stages for the fused "
                        "bottleneck chain (kernel B4)")
    p.add_argument("--sort_on", default="visible",
                   choices=["amodal", "visible"],
                   help="boxes feeding SORT association; 'visible' = "
                        "associate on detector boxes, report amodal")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (e.g. cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from tao_amodal_torch.data.tao import TaoDataset
    from tao_amodal_torch.pipeline import (
        AmodalPipeline,
        video_detections_to_json,
    )

    device = torch.device(args.device)
    dataset = TaoDataset(args.annotation)
    # Detector class index i <-> i-th dataset category id.
    cat_ids = sorted(dataset.cats.keys())
    class_id_map = dict(enumerate(cat_ids))
    pipeline = AmodalPipeline.create(
        num_classes=len(cat_ids),
        backbone_stages=tuple(
            int(s) for s in args.backbone_stages.split(",")),
        num_dets=args.num_dets, num_proposals=args.num_proposals,
        pre_nms_topk=args.pre_nms_topk,
        sort_assignment=args.assignment, sort_on=args.sort_on,
        fused_stages=tuple(int(s) for s in args.fused_stages.split(",")
                           if s.strip()),
        device=device)
    S, T = args.input_size, args.clip_len

    if args.checkpoint:
        pipeline.load(args.checkpoint)
    else:
        logger.warning("no checkpoint given: random weights "
                       "(pipeline smoke mode)")
        pipeline.init(torch.Generator().manual_seed(0))

    records = []
    vids = sorted(dataset.vids.values(), key=lambda v: v["id"])
    if args.num_videos:
        vids = vids[:args.num_videos]

    for video in vids:
        images = sorted(dataset.vid_img_map[video["id"]],
                        key=lambda im: im["frame_index"])
        scale = min(S / video["height"], S / video["width"])
        # SORT state threads across the video's clips; fresh per video.
        state = pipeline.init_tracker_state()
        clips = []
        for start in range(0, len(images), T):
            chunk = images[start:start + T]
            pad = T - len(chunk)
            raw = load_clip(chunk, args.images_dir,
                            (video["height"], video["width"]))
            clip, _ = pipeline.preprocess(
                torch.from_numpy(raw).to(device), out_size=S)
            if pad:
                # Zero frames, padded after normalization (as the JAX
                # CLI does), not -mean/std.
                clip = torch.cat([clip, clip.new_zeros((pad, S, S, 3))])
            out, state = pipeline.streaming(
                clip, state, score_thr=args.score_threshold)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            # Undo the letterbox scale back to source pixels.
            out["boxes"] = out["boxes"] / scale
            clips.append((out, [im["id"] for im in chunk] + [-1] * pad))
        last_id = int(state.next_id) - 1
        if last_id >= TRACK_ID_STRIDE:
            raise ValueError(f"video {video['id']}: SORT id {last_id} "
                             f"overflows the per-video id range")
        records.extend(video_detections_to_json(
            clips, video["id"], class_id_map=class_id_map,
            track_id_base=video["id"] * TRACK_ID_STRIDE))
        logger.info("video %s: %d records so far", video["name"],
                    len(records))

    with open(args.output, "w") as f:
        json.dump(records, f)
    logger.info("wrote %d predictions to %s", len(records), args.output)
    return records


if __name__ == "__main__":
    main()
