#!/usr/bin/env python
"""Run a single-object tracker of the PyTorch port over a video file or a
frame directory, on the card unless --cpu is given (same flags as
tools/run_video.py, plus --cpu).

The reference's ``pytracking/run_video.py`` opens a window and asks for the
first box; here ``--init_box`` gives it, tracking runs without a display,
and the overlay video or frames (drawn in numpy) and the boxes are written.

Usage:
  python tools/run_video_torch.py siamrpn path/to/frames_dir \
      --init_box 120,80,60,90 --output /tmp/out_frames --boxes_out b.txt
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


def iter_frames(source):
    """RGB uint8 frames of a directory of image files (sorted by name,
    read with PIL) or of a video file (read with imageio)."""
    if os.path.isdir(source):
        from PIL import Image

        names = sorted(
            f for f in os.listdir(source)
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
        if not names:
            raise ValueError(f"no image frames found in {source}")
        for name in names:
            yield np.asarray(
                Image.open(os.path.join(source, name)).convert("RGB"))
        return
    import imageio.v2 as imageio

    reader = imageio.get_reader(source)
    try:
        for frame in reader:
            yield np.asarray(frame)[..., :3]
    finally:
        reader.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("tracker", help="registered tracker name "
                                   "(siamrpn, siamrpn_lt, siammask, "
                                   "eco, atom, dimp, ...)")
    p.add_argument("source", help="video file or frame directory")
    p.add_argument("--init_box", required=True,
                   help="x,y,w,h box in the first frame")
    p.add_argument("--output", default=None,
                   help="output video (.mp4) or frame directory; "
                        "default <source>_tracked.mp4")
    p.add_argument("--boxes_out", default=None,
                   help="write per-frame 'x,y,w,h,score' lines here")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop after N frames (0 = all)")
    p.add_argument("--cpu", action="store_true",
                   help="track on the CPU (default: the card)")
    args = p.parse_args(argv)

    from contextlib import ExitStack

    from tao_amodal_torch.trackers.factory import build_tracker
    from tao_amodal_torch.utils.video import video_writer
    from tao_amodal_torch.utils.vis import vis_bbox, vis_class

    init_box = [float(v) for v in args.init_box.split(",")]
    if len(init_box) != 4:
        raise ValueError("--init_box must be x,y,w,h")

    out_path = args.output or (
        os.path.splitext(args.source.rstrip("/"))[0] + "_tracked.mp4")

    tracker = build_tracker(args.tracker,
                            device="cpu" if args.cpu else "cuda")
    records = []
    with ExitStack() as stack:
        writer = None
        for f, frame in enumerate(iter_frames(args.source)):
            if args.max_frames and f >= args.max_frames:
                break
            if f == 0:
                tracker.init(frame, init_box)
                box, score = np.asarray(init_box, np.float64), 1.0
                writer = stack.enter_context(
                    video_writer(out_path, fps=args.fps,
                                 size_wh=frame.shape[1::-1]))
            else:
                box, score = tracker.update(frame)
                box = np.asarray(box, np.float64)
            records.append((box, float(score)))
            canvas = frame.copy()
            vis_bbox(canvas, box, color=(50, 220, 50), thick=2)
            vis_class(canvas, (int(box[0]), int(box[1]) - 2),
                      f"{args.tracker} {score:.2f}")
            writer.write_frame(canvas)

    if args.boxes_out:
        with open(args.boxes_out, "w") as fh:
            for box, score in records:
                fh.write(",".join(f"{v:.2f}" for v in box)
                         + f",{score:.4f}\n")
    print(f"tracked {len(records)} frames -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
