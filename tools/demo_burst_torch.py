#!/usr/bin/env python
"""BURST mask viewer of the PyTorch port (same flags as tools/demo_burst.py):
export one video's per-frame mask overlays, drawn in numpy, as PNGs.

    python tools/demo_burst_torch.py --annotations burst.json \
        --images_dir frames/ --video LaSOT/cat-1 --output_dir out/
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--annotations", required=True)
    p.add_argument("--images_dir", default=None)
    p.add_argument("--video", default=None,
                   help="dataset/seq_name; default: first video")
    p.add_argument("--output_dir", required=True)
    args = p.parse_args(argv)

    from PIL import Image

    from tao_amodal_torch.data.burst import BurstDataset
    from tao_amodal_torch.utils.colormap import color_for_id
    from tao_amodal_torch.utils.vis import vis_mask

    ds = BurstDataset(args.annotations, args.images_dir)
    video = (ds.get_video_by_name(args.video) if args.video
             else ds.get_video_by_index(0))
    os.makedirs(args.output_dir, exist_ok=True)
    for f, frame_name in enumerate(video.annotated_image_paths):
        masks = video.load_masks(f)
        if not masks:
            continue
        h, w = next(iter(masks.values())).shape
        path = (os.path.join(args.images_dir, video.name, frame_name)
                if args.images_dir else None)
        img = (np.asarray(Image.open(path).convert("RGB"))
               if path and os.path.exists(path)
               else np.full((h, w, 3), 128, np.uint8))
        for tid, mask in masks.items():
            img = vis_mask(img, mask, color_for_id(int(tid)))
        out = os.path.join(args.output_dir, f"{f:05d}.png")
        Image.fromarray(img).save(out)
        print(f"wrote {out} ({len(masks)} masks)")


if __name__ == "__main__":
    main()
