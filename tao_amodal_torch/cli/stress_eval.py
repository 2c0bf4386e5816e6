"""Evaluator stress test at the reference's scale: parity and wall clock.

Port of ``tools/stress_eval.py``: generates a synthetic TAO-Amodal fixture
(``tests/fixture_gen.py``, numpy only: hundreds of videos, about 100
categories, about 100k annotations), then runs

  1. the host evaluators (``TrackMapEvaluator``,
     ``AmodalDetectionEvaluator``; float64 numpy),
  2. with ``--device_eval``, the device evaluators (``DeviceTrackEval``,
     ``DeviceDetectionEval``) on the card, or on the CPU with ``--cpu``,
     held to the host's metrics within 2e-3 (f32 IoUs on the device),

and prints the wall seconds and peak RSS of each, then a JSON summary.
The JAX tool's ``--with_reference`` arm is not here: it imports the
reference evaluators from a checkout of the reference repository, which
the port does not carry.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import resource
import sys
import time

# Device against host: f32 IoUs can flip a match whose IoU lies on a
# threshold (tests/test_device_tolerance.py).
DEVICE_ATOL = 2e-3
TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests")


def rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num_videos", type=int, default=500)
    p.add_argument("--frames_per_video", type=int, default=48)
    p.add_argument("--num_cats", type=int, default=100)
    p.add_argument("--tracks_per_video", type=int, default=12)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device_eval", action="store_true",
                   help="also run the device evaluators and hold them to "
                        "the host's")
    p.add_argument("--out", default=None,
                   help="write the JSON summary here too")
    p.add_argument("--cpu", action="store_true",
                   help="run the device evaluators on the CPU; the default "
                        "is the card")
    args = p.parse_args(argv)

    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    from fixture_gen import make_fixture

    from tao_amodal_torch.data.results import make_track_ids_unique
    from tao_amodal_torch.evaluation import (
        AmodalDetectionEvaluator,
        DeviceDetectionEval,
        DeviceTrackEval,
        TrackMapEvaluator,
    )

    device = "cpu" if args.cpu else "cuda"
    t0 = time.perf_counter()
    gt, preds = make_fixture(
        seed=args.seed, num_videos=args.num_videos,
        frames_per_video=args.frames_per_video, num_cats=args.num_cats,
        tracks_per_video=args.tracks_per_video)
    make_track_ids_unique(preds)
    print(f"fixture: {len(gt['videos'])} videos, "
          f"{len(gt['annotations'])} gt anns, {len(preds)} preds, "
          f"{len(gt['categories'])} cats "
          f"({time.perf_counter() - t0:.1f}s)")
    summary = {"videos": len(gt["videos"]),
               "gt_anns": len(gt["annotations"]),
               "preds": len(preds), "cats": len(gt["categories"])}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t
        summary[name + "_s"] = round(dt, 2)
        print(f"{name:24s}: {dt:8.2f}s  (peak RSS {rss_mb():.0f} MB)")
        return out

    def run(cls, *extra, **kwargs):
        def go():
            ev = cls(copy.deepcopy(gt), copy.deepcopy(preds), *extra,
                     **kwargs)
            ev.run()
            return ev.get_results()
        return go

    host_track = timed("host_track", run(TrackMapEvaluator))
    host_det = timed("host_detection", run(AmodalDetectionEvaluator, "bbox"))

    if args.device_eval:
        dev_track = timed("device_track", run(DeviceTrackEval, device=device))
        dev_det = timed("device_detection", run(
            DeviceDetectionEval, "bbox", device=device))
        for what, host, dev in (("track", host_track, dev_track),
                                ("det", host_det, dev_det)):
            for k in host:
                if not abs(host[k] - dev[k]) < DEVICE_ATOL:
                    raise AssertionError(f"device {what} mismatch: {k} "
                                         f"host {host[k]} device {dev[k]}")
        print(f"device == host: OK (atol {DEVICE_ATOL}; float32 IoU flips)")

    summary["peak_rss_mb"] = round(rss_mb(), 1)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
