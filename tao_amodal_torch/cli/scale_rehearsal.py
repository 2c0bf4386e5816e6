"""Dress rehearsal at scale: the day-one tree, the inference CLI, the
evaluation CLI, one command.

Port of ``tools/scale_rehearsal.py``: builds the official TAO-Amodal
layout from synthetic videos (:func:`tao_amodal_torch.data.dayone_fixture.
build`: JPEG frames on disk, ``amodal_annotations/validation_lvis_v1.
json``), runs the port's inference CLI over every video (frames decoded
from disk, ``lvis_instances_results.json``), then its evaluation CLI, and
writes JAX's summary keys: the wall seconds of each part, frames a second
end to end (JPEG decoding included), Track-mAP and detection AP.  The AP
fields are JAX's too: the evaluation CLI's percentages times 100 once
more (``track_map`` 2534.5 is 25.345 %), so both tools' files compare.

Usage (after the accuracy study leaves a checkpoint)::

    python tools/scale_rehearsal_torch.py \\
        --checkpoint <workdir>/ckpt_2000.npz --backbone_stages 1,1,1,1 \\
        --num_dets 32 --out experiments/scale_rehearsal_torch.json

``--cpu`` runs the inference CLI with ``--device cpu``; otherwise it runs
on the card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time

logger = logging.getLogger("scale_rehearsal")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "scale_rehearsal"))
    p.add_argument("--out", default="experiments/scale_rehearsal_torch.json")
    p.add_argument("--videos", type=int, default=16)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--hw", type=int, default=512)
    p.add_argument("--tracks", type=int, default=10)
    p.add_argument("--seed", type=int, default=1000,
                   help="1000 = the accuracy study's val distribution")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--backbone_stages", default="1,1,1,1")
    p.add_argument("--num_dets", type=int, default=32)
    p.add_argument("--num_proposals", type=int, default=128)
    p.add_argument("--pre_nms_topk", type=int, default=100)
    p.add_argument("--score_threshold", type=float, default=0.3)
    p.add_argument("--input_size", type=int, default=512)
    p.add_argument("--cpu", action="store_true",
                   help="run inference on the CPU; the default is the card")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from tao_amodal_torch.cli.eval_cli import main as eval_main
    from tao_amodal_torch.cli.infer_cli import main as infer_main
    from tao_amodal_torch.data.dayone_fixture import build

    t0 = time.time()
    root = build(args.workdir, num_videos=args.videos,
                 frames_per_video=args.frames, hw=args.hw,
                 tracks_per_video=args.tracks, seed=args.seed)
    ann = os.path.join(root, "amodal_annotations", "validation_lvis_v1.json")
    build_s = time.time() - t0
    logger.info("fixture built in %.1fs at %s", build_s, root)

    pred = os.path.join(root, "lvis_instances_results.json")
    infer_args = [
        "--annotation", ann,
        "--images_dir", os.path.join(root, "frames"),
        "--output", pred,
        "--input_size", str(args.input_size),
        "--score_threshold", str(args.score_threshold),
        "--backbone_stages", args.backbone_stages,
        "--num_dets", str(args.num_dets),
        "--num_proposals", str(args.num_proposals),
        "--pre_nms_topk", str(args.pre_nms_topk),
        "--device", "cpu" if args.cpu else "cuda",
    ]
    if args.checkpoint:
        infer_args += ["--checkpoint", args.checkpoint]
    t0 = time.time()
    records = infer_main(infer_args)
    infer_s = time.time() - t0
    n_frames = args.videos * args.frames
    logger.info("inference: %d records over %d frames in %.1fs "
                "(%.1f f/s end-to-end incl. JPEG decode)",
                len(records), n_frames, infer_s, n_frames / infer_s)

    t0 = time.time()
    det, trk = eval_main([
        "--track_result", pred,
        "--output_log", os.path.join(args.workdir, "eval.log"),
        "--annotation", ann])
    eval_s = time.time() - t0

    summary = {
        "videos": args.videos, "frames_per_video": args.frames,
        "hw": args.hw, "tracks_per_video": args.tracks,
        "checkpoint": args.checkpoint,
        "num_predictions": len(records),
        "build_seconds": round(build_s, 1),
        "infer_seconds": round(infer_s, 1),
        "infer_fps_end_to_end": round(n_frames / infer_s, 1),
        "eval_seconds": round(eval_s, 1),
        "track_map": round(100 * float(trk["TAO 3DmAP"]), 3),
        "track_map50": round(100 * float(trk["TAO 3DmAP50"]), 3),
        "det_ap": round(100 * float(det["AP"]), 3),
        "det_ap50": round(100 * float(det["AP50"]), 3),
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    logger.info("summary: %s -> %s", summary, args.out)
    return summary


if __name__ == "__main__":
    main()
