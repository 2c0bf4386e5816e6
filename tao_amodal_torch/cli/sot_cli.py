"""SOT tracking + benchmark CLI.

Port of ``tao_amodal_tpu/cli/sot_cli.py``: run a tracker over a benchmark
dataset (one-pass, or the VOT restart protocol), write the trajectories
in the reference's text formats, and evaluate OPE success/precision or
the VOT fragment EAO; :func:`hp_search` runs a grid of full trackers.
The trackers run on the card unless ``--cpu`` is given; ``--checkpoint``
is an ``.npz`` of the JAX ``SiameseTracker``'s variables (its
``save_pytree``).  :func:`sweep_main` (``tools/hp_search_torch.py``)
is the batched hyperparameter sweep: every grid cell tracks each
sequence in one batch (:func:`~tao_amodal_torch.trackers.siamrpn.
make_siamrpn_hp_sweep`), ranked by OPE success AUC.  ``--plots``
writes the success/precision and EAO figures with matplotlib
(:mod:`tao_amodal_torch.evaluation.sot_plots`, imported only then);
:func:`track_video` reads a video file with cv2 (imported only there) and
draws with the port's numpy :func:`~tao_amodal_torch.utils.vis.vis_bbox`.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import logging
import os
from glob import glob

import numpy as np

from tao_amodal_torch.evaluation.sot_benchmarks import (
    EAOBenchmark,
    OPEBenchmark,
    calculate_accuracy,
    calculate_failures,
    overlap_ratio,
)
from tao_amodal_torch.native.lib import load as native_lib
from tao_amodal_torch.trackers.base import read_rgb

logger = logging.getLogger(__name__)

def run_dataset(tracker, dataset, result_dir, tracker_name="tracker"):
    """Run a tracker over every sequence; write ``<seq>.txt``
    trajectories and ``<seq>_confidence.txt`` scores (OPE)."""
    out_dir = os.path.join(result_dir, tracker_name)
    os.makedirs(out_dir, exist_ok=True)
    fps_all = []
    for seq in dataset:
        boxes, scores, times = tracker.track(seq.frames, seq.init_box)
        np.savetxt(os.path.join(out_dir, f"{seq.name}.txt"), boxes,
                   delimiter=",", fmt="%.2f")
        np.savetxt(os.path.join(out_dir, f"{seq.name}_confidence.txt"),
                   scores, fmt="%.4f")
        fps = len(boxes) / max(times.sum(), 1e-9)
        fps_all.append(fps)
        logger.info("%s: %d frames, %.1f fps", seq.name, len(boxes), fps)
    return {"mean_fps": float(np.mean(fps_all)) if fps_all else 0.0}


def frame_overlap(tracker, box, gt_box, img_hw):
    """The restart test's overlap: polygon against the gt rectangle
    through the host library's VOT region overlap when the tracker emits
    polygons (SiamMask), else axis-aligned IoU."""
    poly = getattr(tracker, "last_polygon", None)
    if poly is not None:
        x, y, w, h = map(float, gt_box)
        gt_poly = [x, y, x + w, y, x + w, y + h, x, y + h]
        return float(native_lib().polygon_overlap(
            np.asarray(poly, np.float64), gt_poly,
            bounds=(img_hw[1], img_hw[0])))
    return float(overlap_ratio(np.asarray([gt_box]), np.asarray([box]))[0])


def run_vot_protocol(tracker, dataset, result_dir, tracker_name="tracker",
                     burnin=5, skip_after_failure=5, fail_overlap=0.0):
    """VOT restart protocol: compare each frame to its gt; on a failure
    (overlap at most ``fail_overlap``) record a failure marker and
    re-initialize ``skip_after_failure`` frames later.

    Writes VOT-style trajectories (``[1]`` init marker, boxes, ``[2]``
    failure markers, ``[0]`` skipped frames) to
    ``<result_dir>/<tracker>/baseline/<seq>_001.txt``; returns accuracy
    and failures a sequence.
    """
    out_dir = os.path.join(result_dir, tracker_name, "baseline")
    os.makedirs(out_dir, exist_ok=True)
    summary = {}
    for seq in dataset:
        traj = []
        f = 0
        T = len(seq.frames)
        while f < T:
            tracker.init(read_rgb(seq.frames[f]), seq.gt_boxes[f])
            traj.append([1.0])
            f += 1
            while f < T:
                img = read_rgb(seq.frames[f])
                box, score = tracker.update(img)
                ov = frame_overlap(tracker, box, seq.gt_boxes[f],
                                   img.shape[:2])
                if ov <= fail_overlap:
                    traj.append([2.0])
                    for _ in range(skip_after_failure - 1):
                        f += 1
                        if f < T:
                            traj.append([0.0])
                    f += 1
                    break
                traj.append(list(map(float, box)))
                f += 1
        acc, n = calculate_accuracy(traj, seq.gt_boxes, burnin=burnin)
        fails, _ = calculate_failures(traj)
        summary[seq.name] = {"accuracy": acc, "failures": fails}
        with open(os.path.join(out_dir, f"{seq.name}_001.txt"), "w") as fh:
            for entry in traj:
                fh.write(",".join(f"{v:.4f}" for v in entry) + "\n")
        logger.info("%s: acc %.3f, %d failures", seq.name, acc, fails)
    return summary


def track_video(tracker, video_path, init_box, output_path=None):
    """Track one video file (reference ``pytracking/evaluation/
    tracker.py::run_video``): frames read with ``cv2.VideoCapture``, the
    box drawn on each into ``output_path`` (a video or a frame directory,
    :func:`~tao_amodal_torch.utils.video.video_writer`); returns the boxes
    ``[T, 4]``."""
    import cv2

    from tao_amodal_torch.utils.video import video_writer
    from tao_amodal_torch.utils.vis import vis_bbox

    boxes, writer = [], None
    with contextlib.ExitStack() as stack:
        cap = cv2.VideoCapture(video_path)
        stack.callback(cap.release)
        while True:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            frame = frame_bgr[:, :, ::-1]
            if not boxes:
                tracker.init(frame, init_box)
                box = np.asarray(init_box, float)
            else:
                box, _ = tracker.update(frame)
            boxes.append(np.asarray(box))
            if output_path:
                if writer is None:
                    writer = stack.enter_context(video_writer(
                        output_path, fps=cap.get(cv2.CAP_PROP_FPS) or 30,
                        size_wh=(frame.shape[1], frame.shape[0])))
                writer.write_frame(vis_bbox(frame.copy(), box))
    return np.stack(boxes) if boxes else np.zeros((0, 4))


def load_results(dataset, result_dir, tracker_names):
    """Pack written trajectories into the OPE benchmark's input."""
    packed = {}
    for seq in dataset:
        entry = {"gt_traj": np.asarray(seq.gt_boxes),
                 "pred_trajs": {}, "pred_scores": {}}
        for name in tracker_names:
            path = os.path.join(result_dir, name, f"{seq.name}.txt")
            if not os.path.exists(path):
                continue
            entry["pred_trajs"][name] = np.loadtxt(path, delimiter=",",
                                                   ndmin=2)
            cpath = os.path.join(result_dir, name,
                                 f"{seq.name}_confidence.txt")
            if os.path.exists(cpath):
                entry["pred_scores"][name] = np.loadtxt(cpath)
        packed[seq.name] = entry
    return packed


def evaluate(dataset, result_dir, tracker_names, plots=False):
    """OPE success and precision of written trajectories; prints the
    table and returns each tracker's mean success AUC.  ``plots`` writes
    ``<result_dir>/ope_success.png`` and ``ope_precision.png``."""
    packed = load_results(dataset, result_dir, tracker_names)
    bench = OPEBenchmark(packed)
    success = bench.eval_success(tracker_names)
    precision = bench.eval_precision(tracker_names)
    print(bench.show_result(success, precision))
    if plots:
        from tao_amodal_torch.evaluation.sot_plots import (
            draw_success_precision)

        paths = draw_success_precision(
            success, name=os.path.basename(result_dir) or "benchmark",
            precision_ret=precision,
            out_prefix=os.path.join(result_dir, "ope"))
        for path in paths:
            logger.info("wrote %s", path)
    return {
        name: float(np.mean([v.mean() for v in seqs.values()]))
        for name, seqs in success.items()
    }


def load_vot_results(dataset, result_dir, tracker_names):
    """Pack restart-protocol trajectories (``baseline/<seq>_*.txt``, as
    :func:`run_vot_protocol` writes them) into :class:`EAOBenchmark`'s
    input."""
    from PIL import Image

    packed = {}
    for seq in dataset:
        w = h = None
        if seq.frames:
            with Image.open(seq.frames[0]) as im:
                w, h = im.size
        entry = {"gt_traj": [list(map(float, b))
                             for b in np.asarray(seq.gt_boxes)],
                 "pred_trajs": {}}
        if w is not None:
            entry["width"], entry["height"] = w, h
        tags = {k: v for k, v in seq.attributes.items()
                if isinstance(v, (list, np.ndarray))
                and len(v) == len(seq.gt_boxes)
                and k != "polygon"}
        if tags:
            entry["tags"] = tags
        for name in tracker_names:
            runs = []
            for path in sorted(glob(os.path.join(
                    result_dir, name, "baseline", f"{seq.name}_*.txt"))):
                with open(path) as fh:
                    runs.append([[float(v) for v in ln.split(",")]
                                 for ln in fh if ln.strip()])
            if runs:
                entry["pred_trajs"][name] = runs
        packed[seq.name] = entry
    return packed


def evaluate_vot(dataset, result_dir, tracker_names, plots=False,
                 dataset_name="VOT2018"):
    """VOT evaluation of restart-protocol results: the fragment EAO
    (``plots``: the radar, ``<result_dir>/eao.png``)."""
    packed = load_vot_results(dataset, result_dir, tracker_names)
    bench = EAOBenchmark(packed, name=dataset_name)
    result = bench.eval(tracker_names)
    print(bench.show_result(result))
    if plots:
        from tao_amodal_torch.evaluation.sot_plots import draw_eao

        path = draw_eao(result,
                        out_path=os.path.join(result_dir, "eao.png"))
        if path:
            logger.info("wrote %s", path)
    return result


def hp_search(build_tracker_fn, dataset, result_dir, grid):
    """A grid of full tracker runs (``grid``: parameter name -> its
    candidates); returns (best parameters, their AUC).  The batched sweep
    is ``tools/hp_search_torch.py``."""
    keys = sorted(grid)
    best = (None, -1.0)
    for values in itertools.product(*(grid[k] for k in keys)):
        hp = dict(zip(keys, values))
        name = "hp_" + "_".join(f"{k}{v}" for k, v in hp.items())
        tracker = build_tracker_fn(**hp)
        run_dataset(tracker, dataset, result_dir, tracker_name=name)
        auc = evaluate(dataset, result_dir, [name])[name]
        logger.info("%s -> AUC %.4f", hp, auc)
        if auc > best[1]:
            best = (hp, auc)
    return best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tracker", default="siamrpn",
                   help="siamrpn | siamrpn_lt | siammask | eco | atom | dimp "
                        "| atom_deep | eco_deep | dimp_deep")
    p.add_argument("--dataset", required=True,
                   help="otb | vot | lasot | got10k | trackingnet | nfs "
                        "| uav123 | tpl")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--result_dir", default="./sot_results")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="npz of the JAX SiameseTracker's variables (the "
                        "Siamese trackers)")
    p.add_argument("--plots", action="store_true",
                   help="write success/precision (and EAO, for VOT "
                        "restart results) figures into --result_dir "
                        "(needs matplotlib)")
    p.add_argument("--vot_protocol", action="store_true",
                   help="run/evaluate the VOT restart protocol "
                        "(fragment EAO) instead of OPE")
    p.add_argument("--cpu", action="store_true",
                   help="track on the CPU (default: the card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from tao_amodal_torch.data.sot_datasets import load_sot_dataset

    dataset = load_sot_dataset(args.dataset, args.dataset_root)
    if len(dataset) == 0:
        raise SystemExit(f"no sequences found under {args.dataset_root}")
    if not args.eval_only:
        from tao_amodal_torch.trackers.factory import build_tracker
        from tao_amodal_torch.utils.weights import load_flat

        kwargs = {"device": "cpu" if args.cpu else "cuda"}
        if args.checkpoint:
            kwargs["params"] = load_flat(args.checkpoint)
        tracker = build_tracker(args.tracker, **kwargs)
        if args.vot_protocol:
            run_vot_protocol(tracker, dataset, args.result_dir,
                             args.tracker)
        else:
            run_dataset(tracker, dataset, args.result_dir, args.tracker)
    if args.vot_protocol:
        return evaluate_vot(dataset, args.result_dir, [args.tracker],
                            plots=args.plots)
    return evaluate(dataset, args.result_dir, [args.tracker],
                    plots=args.plots)


def parse_grid(penalty_k, window_influence, lr):
    """Comma-separated candidates of each hyperparameter -> the grid
    ``[N, 3]`` f32 (penalty_k, window_influence, lr), penalty_k slowest."""
    axes = [[float(v) for v in a.split(",")]
            for a in (penalty_k, window_influence, lr)]
    return np.asarray(list(itertools.product(*axes)), np.float32)


def sweep_main(argv=None):
    """The batched sweep's CLI (JAX's ``tools/hp_search.py``): the grid
    of (penalty_k, window_influence, lr) tracks every sequence as one
    batch on the card (``--cpu``: the CPU); prints the best cells by
    mean success AUC and returns ``{"best", "auc"}``."""
    p = argparse.ArgumentParser(description=sweep_main.__doc__)
    p.add_argument("--dataset", default="otb")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--penalty_k", default="0.02,0.04,0.08,0.16")
    p.add_argument("--window_influence", default="0.30,0.44,0.60")
    p.add_argument("--lr", default="0.25,0.40,0.55")
    p.add_argument("--checkpoint", default=None,
                   help="npz of the JAX SiameseTracker's variables (the "
                        "Siamese trackers)")
    p.add_argument("--output", default=None,
                   help="write the full per-cell table as JSON")
    p.add_argument("--max_frames", type=int, default=0,
                   help="cap frames per sequence (0 = all)")
    p.add_argument("--cpu", action="store_true",
                   help="sweep on the CPU (default: the card)")
    args = p.parse_args(argv)

    import json

    import torch

    from tao_amodal_torch.data.sot_datasets import load_sot_dataset
    from tao_amodal_torch.evaluation.sot_benchmarks import success_overlap
    from tao_amodal_torch.trackers.factory import build_tracker
    from tao_amodal_torch.trackers.siamrpn import make_siamrpn_hp_sweep
    from tao_amodal_torch.utils.weights import load_flat

    grid = parse_grid(args.penalty_k, args.window_influence, args.lr)
    dataset = load_sot_dataset(args.dataset, args.dataset_root)
    if len(dataset) == 0:
        raise SystemExit(f"no sequences under {args.dataset_root}")
    kwargs = {"device": "cpu" if args.cpu else "cuda"}
    if args.checkpoint:
        kwargs["params"] = load_flat(args.checkpoint)
    tracker = build_tracker("siamrpn", **kwargs)
    sweep = make_siamrpn_hp_sweep(tracker.model, tracker.cfg)

    N = len(grid)
    aucs = np.zeros((N,))
    for seq in dataset:
        paths = (seq.frames[:args.max_frames] if args.max_frames
                 else seq.frames)
        frames = torch.from_numpy(np.stack([read_rgb(f) for f in paths]))
        gt = np.asarray(seq.gt_boxes)[:len(frames)]
        boxes, _ = sweep(frames.to(tracker.model.device),
                         np.asarray(seq.init_box, np.float32), grid)
        boxes = boxes.cpu().numpy()                     # [N, T, 4]
        for i in range(N):
            aucs[i] += success_overlap(gt, boxes[i][:len(gt)]).mean()
        print(f"{seq.name}: {len(frames)} frames x {N} cells swept")
    aucs /= len(dataset)

    order = np.argsort(-aucs)
    print(f"\n{'penalty_k':>10} {'win_infl':>10} {'lr':>8} {'AUC':>8}")
    for i in order[:10]:
        pk, wi, lr = grid[i]
        print(f"{pk:>10.3f} {wi:>10.3f} {lr:>8.3f} {aucs[i]:>8.4f}")
    best = grid[order[0]]
    print(f"\nbest: penalty_k={best[0]:.3f} "
          f"window_influence={best[1]:.3f} lr={best[2]:.3f} "
          f"AUC={aucs[order[0]]:.4f}")
    if args.output:
        with open(args.output, "w") as fh:
            json.dump({"grid": grid.tolist(), "auc": aucs.tolist(),
                       "best": best.tolist()}, fh, indent=2)
    return {"best": best.tolist(), "auc": float(aucs[order[0]])}


if __name__ == "__main__":
    main()
