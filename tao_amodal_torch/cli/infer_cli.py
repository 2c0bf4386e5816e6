"""Inference CLI: video frames -> tracked amodal prediction JSON.

Port of :mod:`tao_amodal_tpu.cli.infer_cli`: run the pipeline (detector
-> expander -> SORT) over a dataset's videos, SORT state threaded across
each video's clips, and write the prediction JSON the evaluator
consumes.  On the card every clip's device work is one CUDA graph replay
(``pipeline.make_streaming_fn``, as the JAX CLI jits ``streaming``;
preprocessing runs before it), SORT's association included whatever
``--assignment``.  Flags match the JAX CLI's: ``--assignment`` picks
SORT's association (greedy, gated_auction or auction), ``--fused_stages
1,2,3,4`` runs those trunk stages through the fused bottleneck-chain
kernel (B4), ``--data_parallel`` serves video lanes spread over ranks;
``--device`` picks the card, ``--lanes`` counts the lanes' ranks.

``--data_parallel``: JAX's records in JAX's order (JAX serves them
through ``make_sharded_streaming``), one lane a rank.  The CLI starts
the ranks itself (``torch.multiprocessing``, a file store; this process
is rank 0): ``--lanes`` of them, by default one a visible card (``--device cuda``: lane r on card r, NCCL) or one
on the CPU (``--device cpu``: gloo).  Videos go in groups of ``lanes``,
longest first, and lane b serves video b of every group: video i of
that order goes to rank ``i % lanes``, which serves it as the single
stream does (a fresh state a video, its clips through one CUDA graph,
the short last clip zero-padded).  JAX's lanes run in lockstep and feed
an exhausted or padding lane zero clips whose records it drops; here no
rank waits for another, so none serves such clips.  Rank 0 gathers
every rank's records (``all_gather_object``) and writes them group by
group, lane by lane, as JAX does.  The records are the single stream's,
in another order.

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
# Seconds the ranks of --data_parallel may take, collectives included.
LANE_TIMEOUT = 24 * 3600.0


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
    p.add_argument("--data_parallel", action="store_true",
                   help="serve video lanes spread over ranks "
                        "(make_sharded_streaming): groups of --lanes "
                        "videos run side by side, one lane a rank, SORT "
                        "state threaded per lane; output-equivalent to "
                        "the single-stream path")
    p.add_argument("--lanes", type=int, default=None,
                   help="ranks of --data_parallel (default: one a "
                        "visible card; 1 with --device cpu)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (e.g. cuda, cuda:1, cpu); "
                        "with --data_parallel, 'cuda' puts lane r on "
                        "card r")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.data_parallel:
        return serve_lanes(args)

    device = torch.device(args.device)
    dataset, class_id_map, pipeline, vids = _setup(args, device)
    records = [r for served in _serve_videos(args, dataset, class_id_map,
                                             pipeline, vids, device)
               for r in served]
    with open(args.output, "w") as f:
        json.dump(records, f)
    logger.info("wrote %d predictions to %s", len(records), args.output)
    return records


def _serve_videos(args, dataset, class_id_map, pipeline, videos, device):
    """The single stream over ``videos``: each video's records, in
    order."""
    from tao_amodal_torch.pipeline import make_streaming_fn

    S, T = args.input_size, args.clip_len
    # One CUDA graph per clip geometry, as the JAX CLI jits streaming:
    # every clip of every video (the last one padded) has the same one.
    run = make_streaming_fn(pipeline, score_thr=args.score_threshold)
    served = []
    for video in videos:
        images = sorted(dataset.vid_img_map[video["id"]],
                        key=lambda im: im["frame_index"])
        scale = min(S / video["height"], S / video["width"])
        # SORT state threads across the video's clips; fresh per video.
        state = pipeline.init_tracker_state()
        clips = []
        for start in range(0, len(images), T):
            chunk = images[start:start + T]
            clip, ids = _clip(args, pipeline, video, chunk, device)
            out, state = run(clip, state)
            clips.append((_host_boxes(out, scale), ids))
        _check_ids(video, state.next_id)
        served.append(_video_records(clips, video, class_id_map))
        logger.info("video %s: %d records", video["name"], len(served[-1]))
    return served


def _setup(args, device):
    """(dataset, class id map, pipeline with its weights, the videos to
    serve in id order)."""
    from tao_amodal_torch.data.tao import TaoDataset
    from tao_amodal_torch.pipeline import AmodalPipeline

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
    if args.checkpoint:
        pipeline.load(args.checkpoint)
    else:
        logger.warning("no checkpoint given: random weights "
                       "(pipeline smoke mode)")
        pipeline.init(torch.Generator().manual_seed(0))
    vids = sorted(dataset.vids.values(), key=lambda v: v["id"])
    if args.num_videos:
        vids = vids[:args.num_videos]
    return dataset, class_id_map, pipeline, vids


def _clip(args, pipeline, video, chunk, device):
    """(the preprocessed clip of the images ``chunk``, zero-padded to
    ``--clip_len`` frames, their image ids with -1 for the padding)."""
    S, T = args.input_size, args.clip_len
    pad = T - len(chunk)
    raw = load_clip(chunk, args.images_dir, (video["height"], video["width"]))
    clip, _ = pipeline.preprocess(torch.from_numpy(raw).to(device),
                                  out_size=S)
    if pad:
        # Zero frames, padded after normalization (as the JAX CLI does),
        # not -mean/std.
        clip = torch.cat([clip, clip.new_zeros((pad, S, S, 3))])
    return clip, [im["id"] for im in chunk] + [-1] * pad


def _host_boxes(out, scale):
    """Clip outputs on the host, boxes back in source pixels (the
    letterbox scale undone)."""
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["boxes"] = out["boxes"] / scale
    return out


def _check_ids(video, next_id):
    last_id = int(next_id) - 1
    if last_id >= TRACK_ID_STRIDE:
        raise ValueError(f"video {video['id']}: SORT id {last_id} "
                         f"overflows the per-video id range")


def _video_records(clips, video, class_id_map):
    from tao_amodal_torch.pipeline import video_detections_to_json

    return video_detections_to_json(
        clips, video["id"], class_id_map=class_id_map,
        track_id_base=video["id"] * TRACK_ID_STRIDE)


def serve_lanes(args):
    """``--data_parallel``: start the ranks (this process is rank 0),
    serve, and return (and write) the records rank 0 gathered."""
    from tao_amodal_torch.parallel.launch import run_ranks

    on_cpu = torch.device(args.device).type == "cpu"
    lanes = args.lanes or (1 if on_cpu else torch.cuda.device_count())
    if lanes < 1:
        raise RuntimeError("--data_parallel found no card; pass --device "
                           "cpu to serve lanes on the CPU")
    return run_ranks(_lane_rank, lanes, args=(args,),
                     backend="gloo" if on_cpu else "nccl",
                     timeout=LANE_TIMEOUT)[0]


def _lane_rank(rank, args):
    """One rank of ``--data_parallel``: lane ``rank`` of every group."""
    import torch.distributed as dist

    from tao_amodal_torch.parallel.mesh import make_mesh

    logging.basicConfig(level=logging.INFO)
    mesh = make_mesh(model=1, device=args.device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    dataset, class_id_map, pipeline, vids = _setup(args, mesh.device)
    B, b = mesh.shape["data"], mesh.data_index
    # JAX groups videos of similar length, longest first, so that its
    # lockstep lanes idle little; the groups fix the JSON's order.
    order = sorted(vids, key=lambda v: -len(dataset.vid_img_map[v["id"]]))
    mine = _serve_videos(args, dataset, class_id_map, pipeline, order[b::B],
                         mesh.device)
    lanes = [None] * B
    dist.all_gather_object(lanes, mine)
    if rank != 0:
        return None
    records = [r for g in range(len(lanes[0])) for lane in lanes
               if g < len(lane) for r in lane[g]]
    with open(args.output, "w") as f:
        json.dump(records, f)
    logger.info("wrote %d predictions of %d lanes to %s", len(records), B,
                args.output)
    return records


if __name__ == "__main__":
    main()
