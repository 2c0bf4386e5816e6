#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tao_amodal_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure exits non-zero:

1. build the CUDA kernels of ``tao_amodal_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version at the serving
   path's shapes (TF32 off), and time both with CUDA events;
3. drive the serving pipeline at full width -- ResNet-50 (3,4,6,3) +
   FPN-256, 512^2 letterbox, T=8, 64 detections, 96 proposals,
   pre-NMS top-k 100, greedy SORT over 128 slots on the visible boxes,
   seeded random weights -- over two clips of seeded random 480x640
   frames with the SORT state threaded.  Every kernel must launch and
   tracks must be born.  Then time further clips after that warm-up;
4. run a small pipeline on the card and on the CPU (where the kernel
   wrappers take their plain versions, which the CPU tests hold against
   the JAX package) on the same weights and frames, and compare;
5. run the inference CLI at its defaults on a tiny annotation whose
   frames are missing (gray fallback) and check the prediction JSON.

The last three lines of standard output are the kernel table (JSON),
the card's name and power limit, and ``{"ok": true, "device": ...}``.
With no CUDA device, or without the package beside it, the script
exits non-zero and prints no result.  It imports neither jax nor the
JAX package.
"""

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The serving path's shapes: the CLI defaults on 480x640 video.
T, H, W, S = 8, 480, 640, 512
NUM_DETS = 64
# Small pipeline of phase 4 (the CPU tests' architecture).
TINY = dict(num_classes=8, num_dets=8, num_proposals=16,
            backbone_stages=(1, 1, 1, 1))
TINY_T, TINY_H, TINY_W, TINY_S = 4, 48, 64, 64

# Tolerances, with their reasons:
#  B1: outputs |x| <= ~3 (uint8 / std); the kernel sums the same 2x2
#      taps as the dense matmuls in another order.
PREPROC_ATOL = 1e-3
#  B2: N(0,1) canvas, bin means O(1); identical hat weights, f32 sums
#      in another order.
PRROI_ATOL = 1e-4
#  Phase 4: f32 trunk on cuDNN vs the CPU in other summation orders;
#  boxes reach ~100 px through exp-decoded deltas.  Integer outputs
#  (classes, track ids, valid) must be equal.
BOX_RTOL, BOX_ATOL, SCORE_ATOL = 1e-4, 1e-3, 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back launches
    (CUDA events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_wrappers():
    """name -> (wrapper, source, TPU kernel it replaces)."""
    from tao_amodal_torch.ops import preproc, prroi

    return {
        "preprocess_frames": (
            preproc.preprocess_frames, "tao_amodal_torch/csrc/preproc.cu",
            "tao_amodal_tpu/ops/pallas/preproc.py:91"),
        "prroi_packed": (
            prroi.prroi_packed, "tao_amodal_torch/csrc/prroi.cu",
            "tao_amodal_tpu/ops/pallas/prroi.py:276"),
    }


def phase_build():
    from tao_amodal_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"built {os.path.relpath(path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")


def serving_rois(torch, dev, seed):
    """``[T, 96, 4]`` image-space proposals on the 512^2 letterbox, sides
    8..400 px, so every FPN level gets RoIs."""
    rs = np.random.RandomState(seed)
    side = np.exp(rs.uniform(np.log(8), np.log(400), (T, 96, 2)))
    xy = rs.uniform(0, S, (T, 96, 2)) - side / 2
    boxes = np.concatenate([xy, xy + side], -1).clip(0, S)
    return torch.from_numpy(boxes.astype(np.float32)).to(dev)


def phase_kernels(torch, dev):
    """Each kernel against its plain version at the path's shapes."""
    from tao_amodal_torch.ops import preproc, prroi, roi

    rows = {}
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (T, H, W, 3), dtype=np.uint8)).to(dev)
    got = preproc.preprocess_frames(frames, S)
    want = preproc.preprocess_frames_torch(frames, S)
    check(got.shape == (T, S, S, 3) and bool(torch.isfinite(got).all()),
          f"preprocess_frames: bad output {tuple(got.shape)}")
    err = float((got - want).abs().max())
    log(f"B1 preprocess_frames [{T},{H},{W},3] u8 -> [{T},{S},{S},3]: "
        f"max|d| {err:.3e} (atol {PREPROC_ATOL})")
    check(err <= PREPROC_ATOL, f"preprocess_frames disagrees: {err}")
    rows["preprocess_frames"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: preproc.preprocess_frames(frames, S), 50),
        plain_ms=cuda_ms(
            torch, lambda: preproc.preprocess_frames_torch(frames, S), 50))

    g = torch.Generator(device=dev).manual_seed(1)
    pyramid = [torch.randn((T, n, n, 256), generator=g, device=dev)
               for n in (64, 32, 16, 8)]
    canvas, rois_p = roi.pack_levels(pyramid, serving_rois(torch, dev, 2),
                                     canonical_level=1,
                                     strides=(8, 16, 32, 64))
    got = prroi.prroi_packed(canvas, rois_p)
    want = prroi.prroi_packed_torch(canvas, rois_p)
    check(got.shape == (T, 96, 7, 7, 256)
          and bool(torch.isfinite(got).all()),
          f"prroi_packed: bad output {tuple(got.shape)}")
    err = float((got - want).abs().max())
    log(f"B2 prroi_packed canvas {list(canvas.shape)} rois "
        f"{list(rois_p.shape)}: max|d| {err:.3e} (atol {PRROI_ATOL})")
    check(err <= PRROI_ATOL, f"prroi_packed disagrees: {err}")
    rows["prroi_packed"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: prroi.prroi_packed(canvas, rois_p), 50),
        plain_ms=cuda_ms(
            torch, lambda: prroi.prroi_packed_torch(canvas, rois_p), 20))
    for name, r in rows.items():
        log(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms")
    return rows


def check_outputs(torch, out, t, d):
    shapes = {"boxes": (t, d, 4), "visible_boxes": (t, d, 4),
              "scores": (t, d), "classes": (t, d), "track_ids": (t, d),
              "valid": (t, d)}
    for k, shape in shapes.items():
        check(tuple(out[k].shape) == shape,
              f"output {k}: shape {tuple(out[k].shape)}, want {shape}")
    for k in ("boxes", "visible_boxes", "scores"):
        check(bool(torch.isfinite(out[k]).all()), f"output {k}: not finite")
    check(bool(out["valid"].any()), "no valid detection")


def phase_pipeline(torch, dev, wrappers):
    """The main path at full width; returns the kernels' launch counts."""
    from tao_amodal_torch.pipeline import AmodalPipeline

    pipe = AmodalPipeline.create(device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    rs = np.random.RandomState(3)
    clips = [rs.randint(0, 256, (T, H, W, 3), dtype=np.uint8)
             for _ in range(2)]

    def run_clip(raw, state):
        clip, scale = pipe.preprocess(torch.from_numpy(raw).to(dev),
                                      out_size=S)
        # Random weights put class scores near 1/81, under the serving
        # threshold of 0.05: keep every detection so tracks are born.
        out, state = pipe.streaming(clip, state, score_thr=0.0)
        return out, state, scale

    for fn, _, _ in wrappers.values():
        fn.launches = 0
    state = pipe.init_tracker_state()
    outs = []
    for raw in clips:
        out, state, scale = run_clip(raw, state)
        outs.append(out)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, _, _) in wrappers.items()}
    log(f"main path over 2 clips: launches {launches}, "
        f"next_id {int(state.next_id)}, scale {scale}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    for out in outs:
        check_outputs(torch, out, T, NUM_DETS)
    check(int(state.next_id) > 1, "no track was born")

    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        out, state, _ = run_clip(clips[i % 2], state)
        host = {k: v.cpu() for k, v in out.items()}
    torch.cuda.synchronize()
    clip_ms = (time.perf_counter() - t0) * 1e3 / reps
    check(bool(torch.isfinite(host["boxes"]).all()), "timed clip: NaN")
    log(f"clip wall time after warm-up (uint8 host frames -> host "
        f"outputs, {reps} clips): {clip_ms:.2f} ms/clip = "
        f"{T * 1e3 / clip_ms:.1f} frames/s at {S}^2, T={T}, f32")
    return launches


def perturb(torch, module, rs):
    """Seeded noise on every tensor the random init leaves constant
    (BatchNorm statistics and affines, biases, the zero-initialised
    expander deltas), so the comparison does not pass on identities."""
    def noise(t, scale, base=0.0):
        t.copy_(torch.from_numpy(base + scale * rs.randn(*t.shape)))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                noise(m.running_mean, 0.1)
                m.running_var.copy_(torch.from_numpy(
                    rs.uniform(0.5, 1.5, m.running_var.shape)))
                noise(m.weight, 0.1, 1.0)
                noise(m.bias, 0.05)
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                if getattr(m, "zero_init", False):
                    noise(m.weight, 0.02)
                if m.bias is not None:
                    noise(m.bias, 0.05)


def phase_small_reference(torch, dev):
    """The same small pipeline on the card (kernels) and on the CPU
    (plain versions), on the same weights and coherent frames."""
    from tao_amodal_torch.pipeline import AmodalPipeline

    cpu = AmodalPipeline.create(**TINY).init(
        torch.Generator().manual_seed(4))
    perturb(torch, cpu, np.random.RandomState(5))
    gpu = copy.deepcopy(cpu).to(dev)
    rs = np.random.RandomState(6)
    base = rs.randint(0, 256, (1, TINY_H, TINY_W, 3))
    clips = [np.clip(base + rs.randint(-2, 3, (TINY_T, TINY_H, TINY_W, 3)),
                     0, 255).astype(np.uint8) for _ in range(2)]
    states = [cpu.init_tracker_state(), gpu.init_tracker_state()]
    worst = {"boxes": 0.0, "scores": 0.0}
    for raw in clips:
        outs = []
        for i, pipe in enumerate((cpu, gpu)):
            clip, _ = pipe.preprocess(
                torch.from_numpy(raw).to(pipe.device), out_size=TINY_S)
            out, states[i] = pipe.streaming(clip, states[i], score_thr=0.0)
            outs.append({k: v.cpu() for k, v in out.items()})
        want, got = outs
        check_outputs(torch, got, TINY_T, TINY["num_dets"])
        for k in ("classes", "track_ids", "valid"):
            check(torch.equal(got[k], want[k]),
                  f"small pipeline: {k} differ between card and CPU")
        for k in ("boxes", "visible_boxes"):
            check(torch.allclose(got[k], want[k], rtol=BOX_RTOL,
                                 atol=BOX_ATOL),
                  f"small pipeline: {k} differ between card and CPU")
            worst["boxes"] = max(worst["boxes"],
                                 float((got[k] - want[k]).abs().max()))
        worst["scores"] = max(worst["scores"], float(
            (got["scores"] - want["scores"]).abs().max()))
        check(worst["scores"] <= SCORE_ATOL,
              f"small pipeline: scores differ by {worst['scores']}")
    next_ids = [int(s.next_id) for s in states]
    check(next_ids[0] == next_ids[1] > 1,
          f"small pipeline: next_id {next_ids} (cpu, card)")
    log(f"small pipeline card vs CPU over 2 clips: integer outputs equal, "
        f"max|d| boxes {worst['boxes']:.3e} px, scores "
        f"{worst['scores']:.3e}, next_id {next_ids[1]}")


def phase_cli(torch, wrappers):
    """The inference CLI at its defaults (ResNet-50, 512^2, T=8) on one
    video of 10 frames at 480x640 (two clips, the last padded)."""
    from tao_amodal_torch.cli.infer_cli import main as infer_main

    vid, n_frames, n_cats = 7, 10, 80
    ann = {
        "videos": [{"id": vid, "name": "smoke/v7", "width": W,
                    "height": H}],
        "images": [{"id": 100 + i, "video_id": vid, "frame_index": i,
                    "file_name": f"smoke/v7/{i:05d}.jpg", "width": W,
                    "height": H} for i in range(n_frames)],
        "categories": [{"id": c + 1, "name": f"class{c + 1}"}
                       for c in range(n_cats)],
        "annotations": [], "tracks": [],
    }
    with tempfile.TemporaryDirectory() as tmp:
        ann_path = os.path.join(tmp, "annotation.json")
        out_path = os.path.join(tmp, "predictions.json")
        with open(ann_path, "w") as f:
            json.dump(ann, f)
        for fn, _, _ in wrappers.values():
            fn.launches = 0
        records = infer_main([
            "--annotation", ann_path, "--images_dir",
            os.path.join(tmp, "frames"), "--output", out_path,
            "--score_threshold", "0.0", "--device", "cuda"])
        torch.cuda.synchronize()
        with open(out_path) as f:
            written = json.load(f)
    launches = {name: fn.launches for name, (fn, _, _) in wrappers.items()}
    check(all(n > 0 for n in launches.values()),
          f"CLI did not launch every kernel: {launches}")
    check(written == records and len(records) > 0,
          "CLI wrote no records, or other records than it returned")
    image_ids = {im["id"] for im in ann["images"]}
    keys = {"image_id", "category_id", "bbox", "score", "track_id",
            "video_id"}
    for r in records:
        check(set(r) == keys, f"record keys {sorted(r)}")
        check(r["image_id"] in image_ids and r["video_id"] == vid,
              f"record ids {r}")
        check(1 <= r["category_id"] <= n_cats, f"category {r}")
        x, y, w, h = r["bbox"]
        check(all(math.isfinite(v) for v in r["bbox"]) and w > 0 and h > 0,
              f"bbox {r['bbox']}")
        check(0.0 <= r["score"] <= 1.0, f"score {r['score']}")
        check(r["track_id"] // 10 ** 6 == vid, f"track id {r['track_id']}")
    log(f"CLI: {len(records)} records over "
        f"{len({r['image_id'] for r in records})} frames, "
        f"{len({r['track_id'] for r in records})} tracks, launches "
        f"{launches}")


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = proc.stdout.strip().splitlines()[0] if proc.stdout else ""
    check(proc.returncode == 0 and line,
          f"nvidia-smi failed: {proc.stderr.strip()}")
    return line


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import tao_amodal_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tao_amodal_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # Parity phases compare in full f32: cuDNN convolutions default to
    # TF32 in PyTorch.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    wrappers = kernel_wrappers()
    try:
        phase_build()
        rows = phase_kernels(torch, dev)
        launches = phase_pipeline(torch, dev, wrappers)
        phase_small_reference(torch, dev)
        phase_cli(torch, wrappers)
        card = card_line()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches[name],
                    **rows[name])
               for name, (_, source, replaces) in wrappers.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
