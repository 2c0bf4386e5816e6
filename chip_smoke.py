#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tao_amodal_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure exits non-zero:

1. build the CUDA kernels of ``tao_amodal_torch/csrc`` with nvcc (one
   process per source, all started together), print ptxas's registers,
   shared memory and spills of every kernel (B1, B2, B3, B4, B7/B8, the
   wgmma convs of B4 bf16 and the int8 trunk, the int8 quantizer, the
   fixpoints and the auction), and fail on a spill; build the host RLE
   codec (``tao_amodal_torch/native``) with g++;
2. hold each kernel against its plain PyTorch version at the serving
   path's shapes (TF32 off), and time both with CUDA events (``ms``;
   ``device_ms``: the device time of the kernel's own launches in one
   call, from ``torch.profiler``), beside the kernel's bound (the larger of its bytes over the HBM rate and its
   operations over the peak rate of their type, from this run's inputs)
   and, where one PyTorch call computes the same function, that call
   (cuDNN f32 for B4, cuBLASLt's int8 GEMM ``torch._int_mm`` for B7
   and the int8 trunk conv,
   cuDNN bf16 convolutions for B8): B1
   preprocessing, B2 PrRoI pooling, B5 PrRoI over the canvas padded to
   112 columns (equal to B2 bit for bit), B6 per-level PrRoI on P3..P6,
   B4 the fused bottleneck chain at the four ResNet-50 stage shapes, B7
   and B8 the int8 and bf16 identity-bottleneck stacks at the same
   stages (each stage's ms and TOP/s beside its bound and yardstick, the
   device time by kernel instance and the SM clock), B1 also on odd
   geometries (portrait, a width not a multiple of 4, T=1, S=320 and
   640, an 8K frame, 65,537 frames), B3 the whole-clip SORT scan over 6 threaded clips of a
   coherent 40-object scene (K=128, D=64, T=8) beside the greedy rounds
   per frame of its plain loop, ungated and gated at the IoU threshold,
   and its latency bound (the dependent block-wide phases of its frames
   times one phase's latency, measured by a clock64 probe); B2's
   gradients on the card (f32 and bf16, pyramid and RoIs) against the
   plain route's autograd, and B5, B6 and B8 refusing grad;
3. drive the serving pipeline at full width -- ResNet-50 (3,4,6,3) +
   FPN-256, 512^2 letterbox, T=8, 64 detections, 96 proposals,
   pre-NMS top-k 100, greedy SORT over 128 slots on the visible boxes,
   seeded random weights -- over two clips of seeded random 480x640
   frames with the SORT state threaded: unfused (the default), with
   ``fused_stages=(1, 2, 3, 4)`` and with ``pallas_pooling=True`` (B5,
   whose integer outputs must equal the default's); pool that run's
   own pyramids and proposals again through
   ``multilevel_roi_align(method="prroi_pallas")`` (B6); feed the fused
   run's visible boxes to ``sort_scan(impl="pallas")`` (its track ids
   must equal the plain loop's; its rounds and time are printed); and
   run the identity stacks of the four stages of a seeded full-width
   ResNet-50 on its own block-0 outputs through B7 (scales calibrated
   from the f32 run) and B8.  Every kernel of each path must launch and
   tracks must be born.  Then time further clips of the unfused and
   fused configurations, in turns, and of their trunks alone.
   Multi-video serving at the same width: ``AmodalPipeline.batched``
   over BATCH = 4 videos (32 frames a batch), two clip batches with the
   states threaded, unfused and fused (B1 per video's clip, B2 once and
   B4 four times per batch); its SORT must equal four
   ``sort_scan(impl="auto")`` runs of its own detections in every
   integer, and its detections are compared with four ``streaming``
   calls (printed: cuDNN may pick other algorithms at 32 frames); B2
   and B4 at 32 frames against their plain versions; a clip batch timed
   against four streaming clips, in turns.  The auctions
   (``"gated_auction"``, ``"auction"``) through
   ``sort_scan(impl="auto")`` on the unfused run's detections, on the
   card (``csrc/auction.cu``, one launch a frame) and on the CPU: every
   integer equal, no host sync on the card; the kernel against its plain
   version on every frame's benefit, bit for bit in the assignment and
   the rounds (equal to the numpy count), its device ms a frame and a
   clip beside its bounds (bytes, operations of the active rows' bids,
   and the latency of its rounds' dependent chains from a probe of a
   warp's step latencies), the histogram of active rows a round; the
   kernel on SORT-like frames past a block's shared memory ([192, 384],
   [256, 512]) and on eviction chains of single-row rounds, each run
   out and cut by ``max_iters`` inside the chain, bit for bit; SORT's
   ms a clip through the kernel and through the plain eager rounds, in
   turns.
   The JAX bench's serving configuration (``bench.py:91-118``): bf16,
   the ``s2d_pre`` stem, 480x640 frames letterboxed to 384x512, the
   same width and heads, over two clips unfused, with
   ``fused_stages=(1, 2, 3, 4)`` and with ``pallas_pooling=True``: the
   bf16 forms of B2, B4 and B5 must launch and no f32 kernel nor B1 may;
   B6's bf16 route on that run's pyramids against the same route on the
   CPU; the bf16 forms of B2, B5, B6 and B4 alone at that
   configuration's shapes against their plain versions (rows of their
   own in the kernels line), B2, B5 and B6 also on edge RoIs (outside
   the map, of zero size, spanning every column); ms a clip and the
   card's idle share.
   The int8 trunk (``create(int8_backbone=True)``, ``phase_int8``) at
   the CLI defaults' width and frames: three clips, each with its wall
   ms, the card's busy ms, idle share and device events, and the
   launches of B1, B2, the trunk conv and the two together (53 each a
   clip) and its quantizer (49: a bottleneck's first conv and its
   projection share one); the same clips on the eager quantization;
   every conv of one clip (the whole, the quantizer, the conv alone)
   against its plain version, bit for bit, and timed beside its bound
   and ``torch._int_mm`` (im2col, cuBLASLt int8), the quantizer also by
   activation size (its form, the share it holds on chip between its
   passes, device ms against its bound); the bf16 ``s2d_pre`` int8 pipeline over one
   clip at 384x512; the CPU tests' architecture with the int8 trunk card
   vs CPU (pyramid within half the f32 trunk's difference, detections no
   further than the f32 trunk's); the packed RPN and RoIAlign card vs
   CPU; a GTR-named checkpoint built from a seed at full width, loaded
   with ``load_gtr_checkpoint``, serving one clip.
   The captured serving programs (``phase_captured``): the kernels of
   ``csrc/fixpoint.cu`` against their plain versions bit for bit: NMS
   from the boxes (``nms_keep_mask``) on the f32 pipeline's own calls
   (boxes, scores, valid, threshold), on box chains that need N rounds
   and on adversarial scenes (NaN and +-inf coordinates, zero-area and
   identical boxes, IoUs at the threshold), ``nms_fixpoint`` on
   suppression chains, the greedy assignment on the pipeline's own
   benefit matrices, chains and tie-rich scenes; NMS timed on the RPN's,
   the detector's and 32 frames' calls against the eager construction of
   the suppression matrix plus ``nms_fixpoint``, the greedy kernel on
   every frame of each clip (device ms summed a clip, its own rounds
   beside the plain loop's), each beside its bounds; then
   ``make_streaming_fn`` (f32 unfused, fused, pallas_pooling, the bf16
   ``s2d_pre`` bench configuration at 384x512, the int8 trunk, the
   gated and the full auction, the auction at ``--num_dets 192
   --num_proposals 192``) and
   ``make_batched_fn`` (BATCH videos, greedy and the auction) at full
   width, the whole clip one graph
   whatever the assignment, three clips twice
   over with the state threaded, eager and captured in turns: integers
   equal, boxes and scores within their bounds, no host sync inside a
   replay; wall ms a clip, busy ms, idle share, device events, capture
   ms and peak memory of both; the replay's launches counted by kernel
   name (torch.profiler), equal to the eager clip's;
4. run small pipelines on the card and on the CPU (where the kernel
   wrappers take their plain versions, which the CPU tests hold against
   the JAX package) on the same weights and frames, and compare: the
   CPU tests' architecture, a (2,3,3,3) trunk with every stage fused,
   ``batched`` over 3 videos on the card against 3 ``streaming`` runs on
   the CPU, and the CPU tests' architecture with the ``s2d`` and
   ``s2d_pre`` stems in f32 and bf16 at a 4:3 frame (``streaming`` and a
   2-video ``batched``; bf16 compared by matched detections);
5. run the inference CLI at its defaults on a tiny annotation whose
   frames are missing (gray fallback) and check the prediction JSON
   (its clips replay a CUDA graph each: the kernels are counted by name
   under torch.profiler, one graph launch a clip) against the records
   of the same CLI on eager ``streaming``; then again with
   ``--fused_stages 1,2,3,4`` and with ``--assignment gated_auction``
   (its replays launch the auction kernel);
6. evaluate on the card: ``DeviceTrackEval`` and ``DeviceDetectionEval``
   at ``tools/stress_eval.py``'s reference scale (``fixture_gen``, 500
   videos of 48 frames, 100 categories, 12 tracks a video, seed 7: about
   95k gt annotations, 66k predictions) against the float64 host
   evaluators on the CPU, every metric within 2e-3; each one's wall s,
   peak device memory and the share of its greedy loop (synchronized
   around each chunk's call; the largest chunk profiled again for its
   device-busy time); no kernel may launch on this path.  segm at the
   same scale: every gt annotation and prediction given the triangle of
   its box, rasterized by the port's RLE codec (``native/rle.cc``, built
   with g++ in phase 1); Track-mAP and detection AP with ``"segm"`` on
   the host and on the card (mask IoU on the host through the codec,
   the matching cells on the card), within 2e-3; wall s and the host
   share of each card run.  The
   f32-threshold fixture of ``tests/test_device_tolerance.py``: drift
   in (0.05, 0.30] with every IoU on a threshold, < 1e-9 off them.  Then
   the eval CLI on the first CLI run's own predictions, host and
   ``--device_eval``: the two logs must be identical.

The last three lines of standard output are the kernel table (JSON),
the card's name and power limit, and ``{"ok": true, "device": ...}``.
With no CUDA device, or without the package beside it, the script
exits non-zero and prints no result.  It imports neither jax nor the
JAX package.
"""

import copy
import inspect
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
FUSED = (1, 2, 3, 4)
# B4: the stride-1 chains of ResNet-50's stages at 512^2, T=8:
# (input [T, H, W, Cin], bottleneck width M, blocks, block-0 projection).
STAGES = (((T, 128, 128, 64), 64, 3, True),
          ((T, 64, 64, 512), 128, 3, False),
          ((T, 32, 32, 1024), 256, 5, False),
          ((T, 16, 16, 2048), 512, 2, False))
# B3: slots, detections per frame, clips of the coherent scene.
SORT_K, SORT_CLIPS, SORT_OBJECTS = 2 * NUM_DETS, 6, 40
# B3's dependent block-wide phases (csrc/sort_scan.cu, one __syncthreads
# each): per frame, the frame's start, predict, benefit, argmaxes, the
# last round's check, update and two for the births' ranks; per greedy
# round two more; one at the clip's end.
B3_PHASES_PER_FRAME, B3_PHASES_PER_ROUND = 8, 2
# phase_int8: clips of the int8 main path.
INT8_CLIPS = 3
# Small pipelines of phase 4: the CPU tests' architecture, and a trunk
# whose every stage has a stride-1 chain of >= 2 blocks, fused.
TINY = dict(num_classes=8, num_dets=8, num_proposals=16,
            backbone_stages=(1, 1, 1, 1))
TINY_FUSED = dict(TINY, backbone_stages=(2, 3, 3, 3), fused_stages=FUSED)
TINY_T, TINY_H, TINY_W, TINY_S = 4, 48, 64, 64
# P3..P6, the pooled levels.
LEVEL_STRIDES = (8, 16, 32, 64)
# Videos a clip batch of AmodalPipeline.batched: full width, and the
# small pipelines of phase 4.
BATCH, TINY_BATCH = 4, 3

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
#  B4: f32 FMAs against cuDNN's f32 (TF32 off), sums of up to 9*512
#      products in another order; the error scales with the output, so
#      the bound is relative to the stage output's largest magnitude.
FUSED_RTOL = 1e-4
#  B3: integers exact; Kalman state as in the CPU tests (covariances
#      reach ~1e4, f32 in another order).
SORT_RTOL, SORT_ATOL = 1e-4, 1e-3
#  B5, B6: as B2 against their plain versions.  B6's multilevel route
#      against the pipeline's B5 pooling: the same integral from RoI
#      coordinates rounded on other grids (canvas offsets), so the bound
#      is relative to the pooled features' largest magnitude.
POOL_ROUTE_RTOL = 1e-4
#  B7: int8 outputs exactly equal (exact integer dots on both sides, the
#      same f32 requantization).  B8: f32 sums in another order can flip
#      a bf16 rounding by one ulp, and a flip propagates through the
#      later blocks: max |d| <= 1e-2 max|ref|, mean |d| <= 1e-3 mean|ref|,
#      or, where the plain version run in another f32 order (on the
#      CPU) is itself further from the card's plain version, at most
#      twice that spread.  Each flip reaches about sqrt(9 M) outputs of
#      the next conv, so over the 15 convs of stage 3 the spread settles
#      near 1e-3 of mean|ref| whatever the order.
BF16_MAX_RTOL, BF16_MEAN_RTOL, BF16_SPREAD = 1e-2, 1e-3, 2.0
# B7/B8: the identity stacks of ResNet-50's stages at 512^2, T=8
# (experiments/fused_stage_bench.py): (input [T, H, W, C], width M,
# blocks).
STACKS = (((T, 128, 128, 256), 64, 2), ((T, 64, 64, 512), 128, 3),
          ((T, 32, 32, 1024), 256, 5), ((T, 16, 16, 2048), 512, 2))
# The bf16 serving configuration of the JAX bench (bench.py:91-118): 4:3
# frames letterboxed to 384x512, the s2d_pre stem; its P3..P6 levels and
# B4's stride-1 chains at that size, T=8.
BF16_OUT = (384, 512)
BF16_LEVELS = ((48, 64), (24, 32), (12, 16), (6, 8))
BF16_STAGES = (((T, 96, 128, 64), 64, 3, True),
               ((T, 48, 64, 512), 128, 3, False),
               ((T, 24, 32, 1024), 256, 5, False),
               ((T, 12, 16, 2048), 512, 2, False))
#  Small bf16 pipeline, card vs CPU: at least this share of detections
#  matched (a few of near-equal score swap), and matched boxes within a
#  pixel (a one-ulp flip of a bf16 box delta of magnitude <= 1 moves a
#  64 px side by 2**-8 * 64 = 0.25 px; two such flips and the decode's
#  f32 order stay under 1 px).
MATCHED_SHARE, BF16_BOX_ATOL = 0.75, 1.0
#  A detection pairs with one of the other run when their boxes overlap
#  at IoU >= MATCH_IOU within a class: the same detection moves by well
#  under a pixel, and 0.9 keeps two neighbouring detections of a class
#  from pairing.
MATCH_IOU = 0.9
# The evaluation phase's fixture: tools/stress_eval.py's defaults, the
# reference-scale sweep (about 95k gt annotations, 66k predictions).
EVAL_FIXTURE = dict(seed=7, num_videos=500, frames_per_video=48,
                    num_cats=100, tracks_per_video=12)
#  Device evaluators (f32 IoU) against the float64 host oracle on
#  fixture_gen's jittered gt: tests/test_device_eval.py:41.
EVAL_ATOL = 2e-3
# Roofline of one H100 SXM at 700 W (NVIDIA's data sheet, dense rates):
# HBM bytes/s, and peak operations/s by type (f32 on the CUDA cores,
# bf16 and int8 on the tensor cores).
HBM_RATE = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


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


def device_ms(torch, fn, kernel, reps, per_call=False):
    """Mean device time of one launch (``per_call``: of all launches of
    one call) of the kernels whose names hold ``kernel`` (or any of a
    tuple of names) over ``reps`` calls of ``fn`` (``torch.profiler``),
    or None when three traces in a row hold none (the profiler now and
    then returns no kernel).  Where the host takes longer to enqueue a
    call than the card to run it, :func:`cuda_ms` of back-to-back calls
    measures the host; this measures the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_time_total > 0
                  and any(name in e.key for name in names)]
        n = sum(e.count for e in events)
        if n:
            return sum(e.device_time_total for e in events) / 1e3 / (
                reps if per_call else n)
    return None


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops, kind):
    """(bound_ms, bound_by): the least time for ``n_bytes`` moved once
    and ``ops`` operations of type ``kind``, whichever is larger."""
    t_bytes = n_bytes / HBM_RATE * 1e3
    t_ops = ops / PEAK[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row(err, ms, plain_ms, bound_ms_by, library_ms=None, dev_ms=None):
    """A kernel's entry of the kernels line (launches are added later).
    ``ms``, ``plain_ms`` and ``library_ms`` are CUDA-event times of back-
    to-back calls (:func:`cuda_ms`) for every kernel; ``device_ms`` is the
    device time of the kernel's own launches in one call
    (``torch.profiler``, without the PyTorch ops around them), None where
    the profiler lost them."""
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1],
                library_ms=library_ms, device_ms=dev_ms)


def roofline_note(r):
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    dev = ("not measured" if r["device_ms"] is None
           else f"{r['device_ms']:.4f} ms, "
                f"{100 * r['bound_ms'] / r['device_ms']:.1f} % of the bound")
    return (f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f} % of "
            f"the bound reached, plain {r['plain_ms']:.4f} ms, one PyTorch "
            f"call {lib}; device time {dev}")


def own_device_ms(by_kernel, own):
    """The device time of one call's own kernels from a breakdown
    ``{label: [ms, ...]}`` (labels starting with one of ``own``), or
    None where the profiler lost kernels."""
    if by_kernel is None:
        return None
    return sum(r[0] for label, r in by_kernel.items()
               if label.startswith(own))


def prroi_work(rois, Hc, Wc, out_size=7):
    """What PrRoI pooling of ``rois [T, R, 4]`` (numpy, map coordinates)
    needs on a ``[T, Hc, Wc, C]`` map, per channel: the map pixels under
    any RoI's hat support (each read once) and the multiply-adds of the
    per-bin sums sum_y wy * sum_x wx * f."""
    r = rois.astype(np.float32)
    b = np.arange(out_size, dtype=np.float32)

    def axis(lo0, hi0, n):
        step = np.maximum((hi0 - lo0) / np.float32(out_size),
                          np.float32(1e-8)).astype(np.float32)
        lo = lo0[..., None] + b * step[..., None]
        first = np.clip(np.floor(lo), 0, n - 1).astype(np.int64)
        last = np.clip(np.ceil(lo + step[..., None]), 0, n - 1).astype(
            np.int64)
        return first, last                          # [T, R, S]

    xs, xe = axis(r[..., 0], r[..., 2], Wc)
    ys, ye = axis(r[..., 1], r[..., 3], Hc)
    nx, ny = (xe - xs + 1).sum(-1), (ye - ys + 1).sum(-1)
    mac = int((ny * nx + ny * out_size).sum())
    mask = np.zeros((r.shape[0], Hc, Wc), bool)
    for t in range(r.shape[0]):
        for i in range(r.shape[1]):
            mask[t, ys[t, i, 0]:ye[t, i, -1] + 1,
                 xs[t, i, 0]:xe[t, i, -1] + 1] = True
    return int(mask.sum()), mac


def prroi_bound(rois, out, Hc, Wc, esize=4):
    """B2/B5/B6's (bytes, operations) on one map of ``esize``-byte
    values: the RoIs' supports read once, the RoIs read and the output
    ``out`` written once; two operations per multiply-add."""
    C = out.shape[-1]
    pixels, mac = prroi_work(rois.cpu().numpy(), Hc, Wc, out.shape[-2])
    return pixels * C * esize + nbytes(rois, out), 2 * mac * C


def kernel_wrappers():
    """name -> (wrapper, source, TPU kernel it replaces)."""
    from tao_amodal_torch.ops import (
        fused_stage,
        hungarian,
        int8_conv,
        nms,
        preproc,
        prroi,
        resnet_blocks,
        sort_scan,
    )

    return {
        "preprocess_frames": (
            preproc.preprocess_frames, "tao_amodal_torch/csrc/preproc.cu",
            "tao_amodal_tpu/ops/pallas/preproc.py:91"),
        "prroi_packed": (
            prroi.prroi_packed, "tao_amodal_torch/csrc/prroi.cu",
            "tao_amodal_tpu/ops/pallas/prroi.py:276"),
        "sort_scan_pallas": (
            sort_scan.sort_scan_pallas, "tao_amodal_torch/csrc/sort_scan.cu",
            "tao_amodal_tpu/ops/pallas/sort_scan.py:357"),
        "fused_bottleneck_chain": (
            fused_stage.fused_bottleneck_chain,
            "tao_amodal_torch/csrc/fused_stage.cu",
            "tao_amodal_tpu/ops/pallas/fused_stage.py:310"),
        "prroi_packed_pallas": (
            prroi.prroi_packed_pallas, "tao_amodal_torch/csrc/prroi.cu",
            "tao_amodal_tpu/ops/pallas/prroi.py:151"),
        "prroi_pool_pallas": (
            prroi.prroi_pool_pallas, "tao_amodal_torch/csrc/prroi.cu",
            "tao_amodal_tpu/ops/pallas/prroi.py:418"),
        "identity_blocks_pallas": (
            resnet_blocks.identity_blocks_pallas,
            "tao_amodal_torch/csrc/resnet_blocks.cu",
            "tao_amodal_tpu/ops/pallas/resnet_blocks.py:154"),
        "identity_blocks_bf16_pallas": (
            resnet_blocks.identity_blocks_bf16_pallas,
            "tao_amodal_torch/csrc/resnet_blocks.cu",
            "tao_amodal_tpu/ops/pallas/resnet_blocks.py:268"),
        # The bf16 forms, counted apart from the f32 ones.
        "prroi_packed_bf16": (
            prroi.prroi_packed.bf16, "tao_amodal_torch/csrc/prroi.cu",
            "tao_amodal_tpu/ops/pallas/prroi.py:276"),
        "fused_bottleneck_chain_bf16": (
            fused_stage.fused_bottleneck_chain.bf16,
            "tao_amodal_torch/csrc/conv_sm90.cu",
            "tao_amodal_tpu/ops/pallas/fused_stage.py:310"),
        "prroi_packed_pallas_bf16": (
            prroi.prroi_packed_pallas.bf16, "tao_amodal_torch/csrc/prroi.cu",
            "tao_amodal_tpu/ops/pallas/prroi.py:151"),
        "prroi_pool_pallas_bf16": (
            prroi.prroi_pool_pallas.bf16, "tao_amodal_torch/csrc/prroi.cu",
            "tao_amodal_tpu/ops/pallas/prroi.py:418"),
        # The int8 trunk (csrc/conv_sm90.cu): its conv, its activation
        # quantization and the two together, the whole of _int8_conv;
        # they replace XLA code, no Pallas kernel.
        "int8_conv": (
            int8_conv.int8_conv, "tao_amodal_torch/csrc/conv_sm90.cu",
            "tao_amodal_tpu/models/backbones.py:77"),
        "quantize_activation_s8": (
            int8_conv.quantize_activation_s8,
            "tao_amodal_torch/csrc/conv_sm90.cu",
            "tao_amodal_tpu/models/backbones.py:72"),
        "quantized_conv": (
            int8_conv.quantized_conv, "tao_amodal_torch/csrc/conv_sm90.cu",
            "tao_amodal_tpu/models/backbones.py:58"),
        # No Pallas kernel: the whole of JAX's nms_keep_mask (its IoU
        # matrix and its lax.while_loop), and the greedy assignment's
        # lax.while_loop.
        "nms_keep_mask": (
            nms.nms_keep_mask, "tao_amodal_torch/csrc/fixpoint.cu",
            "tao_amodal_tpu/ops/nms.py:41"),
        "greedy_fixpoint": (
            hungarian.greedy_fixpoint, "tao_amodal_torch/csrc/fixpoint.cu",
            "tao_amodal_tpu/ops/hungarian.py:153"),
        # No Pallas kernel: the auction's lax.while_loop.
        "auction_assign": (
            hungarian.auction_assign, "tao_amodal_torch/csrc/auction.cu",
            "tao_amodal_tpu/ops/hungarian.py:96"),
    }


# Each wrapper's kernels as torch.profiler (and cu++filt) names them: a
# captured path launches its kernels from a CUDA graph's replay, which
# the wrappers' Python counts do not see, so its launches are counted by
# these names among the graph's kernel nodes (phase_captured) or in a
# profile of the replay (phase_cli).  B2, B5 and B6 share one kernel (f32 and
# bf16 forms), B4 bf16 and the int8 conv one template (its first
# argument: int8).  NMS's one C call launches the bits kernel and the
# rounds kernel; the bits kernel counts it.
KERNEL_NAMES = {
    "preprocess_frames": ("preproc_kernel",),
    "prroi_packed": ("prroi_kernel",),
    "sort_scan_pallas": ("sort_scan_kernel",),
    "fused_bottleneck_chain": ("conv_nhwc_kernel",),
    "prroi_packed_pallas": ("prroi_kernel",),
    "prroi_pool_pallas": ("prroi_kernel",),
    "identity_blocks_pallas": ("conv_q_mma_kernel<true",),
    "identity_blocks_bf16_pallas": ("conv_q_mma_kernel<false",),
    "prroi_packed_bf16": ("prroi_bf16_kernel",),
    "fused_bottleneck_chain_bf16": ("conv_wgmma_kernel<false",),
    "prroi_packed_pallas_bf16": ("prroi_bf16_kernel",),
    "prroi_pool_pallas_bf16": ("prroi_bf16_kernel",),
    "int8_conv": ("conv_wgmma_kernel<true",),
    "quantize_activation_s8": ("quantize_flat_kernel",
                               "quantize_pixel_kernel"),
    "quantized_conv": ("conv_wgmma_kernel<true",),
    "nms_keep_mask": ("nms_bits_kernel",),
    "greedy_fixpoint": ("greedy_fixpoint_kernel",),
    "auction_assign": ("auction_rounds_kernel",),
}


def fixpoint_launches(clips, frames=T, assignment="greedy"):
    """The fixpoint kernels' launches over ``clips`` clips (or clip
    batches) of ``frames`` frames of a serving path with SORT's
    ``assignment``: NMS twice a clip (the RPN's and the detector's), the
    greedy assignment or the auction once a frame."""
    auction = assignment != "greedy"
    return dict(nms_keep_mask=2 * clips,
                greedy_fixpoint=0 if auction else frames * clips,
                auction_assign=frames * clips if auction else 0)


def counted(torch, wrappers, run):
    """Run ``run()`` with every launch count set to 0 just before it;
    returns (its result, name -> launches during it).  The counts are
    the wrappers' Python counts, which see eager launches only; a path
    that replays a CUDA graph is counted from torch.profiler's kernel
    names (:func:`profile_run`, :data:`KERNEL_NAMES`)."""
    for fn, _, _ in wrappers.values():
        fn.launches = 0
    result = run()
    torch.cuda.synchronize()
    return result, {name: fn.launches
                    for name, (fn, _, _) in wrappers.items()}


def phase_build():
    """Build the kernels; print ptxas's report of every kernel (B7/B8:
    the conv instances and B7's weight transposition; the wgmma conv's
    instances, bf16 and int8, and the int8 trunk's quantization kernels;
    static shared memory only: the conv kernels' rings, B1's rows, B2's
    weights and B3's state are dynamic, set at launch) and fail on a
    spill."""
    import re

    from tao_amodal_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"built {os.path.relpath(path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    seen, spills = set(), []
    for name, k in sorted(_build.ptxas_report().items()):
        base = re.search(r"(conv_nhwc_kernel|splitk_epilogue|prroi_kernel|"
                         r"prroi_bf16_kernel|conv_q_mma_kernel|"
                         r"transpose_s8_kernel|conv_wgmma_kernel|"
                         r"quantize_flat_kernel|quantize_pixel_kernel|"
                         r"preproc_kernel|sort_scan_kernel|"
                         r"nms_bits_kernel|nms_pack_kernel|"
                         r"nms_rounds_kernel|greedy_fixpoint_kernel|"
                         r"auction_rounds_kernel|phase_probe_kernel)", name)
        if base is None:
            continue
        # Template arguments: ints, and the bools of B7 (1) and B8 (0).
        args = re.findall(r"L[ib](\d+)E", name)
        label = base.group(1) + (f"<{','.join(args)}>" if args else "")
        seen.add(base.group(1))
        log(f"ptxas {label}: {k['registers']} registers, {k['smem']} bytes "
            f"static smem, spill stores {k['spill_stores']} bytes, spill "
            f"loads {k['spill_loads']} bytes")
        if k["spill_stores"] or k["spill_loads"]:
            spills.append(label)
    check(len(seen) == 17,
          f"ptxas report lacks a kernel: {sorted(seen)}")
    check(not spills, f"registers spill in {spills}")
    # The host RLE codec of segm evaluation (g++, no CUDA).
    from tao_amodal_torch.native import lib as native_lib

    t0 = time.perf_counter()
    path = native_lib.load().path
    log(f"built the RLE codec {os.path.relpath(path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")


def serving_rois(torch, dev, seed, hw=(S, S)):
    """``[T, 96, 4]`` image-space proposals on the ``hw`` letterbox,
    sides 8..400 px, so every FPN level gets RoIs."""
    rs = np.random.RandomState(seed)
    wh = np.array([hw[1], hw[0]], np.float64)
    side = np.exp(rs.uniform(np.log(8), np.log(400), (T, 96, 2)))
    xy = rs.uniform(0, 1, (T, 96, 2)) * wh - side / 2
    boxes = np.clip(np.concatenate([xy, xy + side], -1),
                    0, np.concatenate([wh, wh]))
    return torch.from_numpy(boxes.astype(np.float32)).to(dev)


def chain_flop(shape, M, blocks, projection):
    """Multiply-adds x 2 of a stride-1 chain, from its shapes."""
    pixels = shape[0] * shape[1] * shape[2]
    flop, cin = 0, shape[-1]
    for b in range(blocks):
        mac = cin * M + 9 * M * M + M * 4 * M
        if b == 0 and projection:
            mac += cin * 4 * M
        flop += 2 * pixels * mac
        cin = 4 * M
    return flop


def chain_breakdown(torch, x, params, attempts=3):
    """Device time of one B4 call by kernel (``torch.profiler``), and the
    FLOP each conv kernel instance (tile width, filter size) computes:
    ``{label: [ms, launches, flop]}``.  A trace that lost kernels (its
    conv launches fall short of the chain's convs) is taken again; after
    ``attempts`` such traces this returns None."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from tao_amodal_torch.ops import fused_stage

    P = x.shape[0] * x.shape[1] * x.shape[2]
    flop, convs = {}, 0
    for p in params:
        for w in (p[k] for k in p if k[0] == "w"):
            cout, cin, ks = w.shape[0], w.shape[1], w.shape[-1]
            bn = fused_stage.conv_plan(P, cin, cout, ks).bn
            label = f"conv<{bn},{ks}>"
            flop[label] = flop.get(label, 0) + 2 * P * cin * cout * ks * ks
            convs += 1
    for _ in range(attempts):
        rows = {label: [0.0, 0, f] for label, f in flop.items()}
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA],
                                      acc_events=True) as prof:
            fused_stage.fused_bottleneck_chain(x, params)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total <= 0:
                continue
            m = re.search(r"conv_nhwc_kernel<(\d+), (\d)>", e.key)
            label = (f"conv<{m.group(1)},{m.group(2)}>" if m else
                     "splitk_epilogue" if "splitk_epilogue" in e.key else
                     "other (weight re-layout copies)")
            r = rows.setdefault(label, [0.0, 0, 0])
            r[0] += e.device_time_total / 1e3
            r[1] += e.count
        if sum(r[1] for label, r in rows.items() if label in flop) == convs:
            return rows
    return None


def stack_breakdown(torch, fn, x, p, attempts=3):
    """Device time of one B7 or B8 call ``fn(x, p)`` by kernel
    (``torch.profiler``), beside the operations and the bytes (inputs
    read once, outputs written once) of each conv kernel instance (tile
    width, filter size): ``{label: [ms, launches, ops, bytes]}``.  A
    trace that lost kernels is taken again; after ``attempts`` such
    traces this returns None."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from tao_amodal_torch.ops import resnet_blocks as rb

    T, H, W, C = x.shape
    P, (N, _, M), size = T * H * W, p.w1.shape, x.element_size()
    work, convs = {}, 0
    for cin, cout, ks, res in ((C, M, 1, 0), (M, M, 3, 0), (M, C, 1, 1)):
        label = f"conv<{rb.conv_plan(P, cin, cout, ks, size).bn},{ks}>"
        w = work.setdefault(label, [0, 0])
        w[0] += N * 2 * P * cin * cout * ks * ks
        w[1] += N * size * (P * (cin + cout * (1 + res)) + ks * ks * cin
                            * cout)
        convs += N
    for _ in range(attempts):
        rows = {label: [0.0, 0, o, b] for label, (o, b) in work.items()}
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn(x, p)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total <= 0:
                continue
            m = re.search(r"conv_q_mma_kernel<(?:true|false), (\d+), (\d)>",
                          e.key)
            label = (f"conv<{m.group(1)},{m.group(2)}>" if m else
                     "transpose_s8_kernel" if "transpose_s8_kernel" in e.key
                     else "other (split counters' fill)")
            r = rows.setdefault(label, [0.0, 0, 0, 0])
            r[0] += e.device_time_total / 1e3
            r[1] += e.count
        if sum(r[1] for label, r in rows.items() if label in work) == convs:
            return rows
    return None


def breakdown_note(by_kernel):
    """A log line of :func:`stack_breakdown` rows summed over stages."""
    if by_kernel is None:
        return "not measured: the profiler lost kernels in every trace"
    return "; ".join(
        f"{label} {t:.4f} ms x{n}"
        + (f" ({o / t / 1e9:.1f} TOP/s, {b / t / 1e6:.0f} GB/s)"
           if o and t else "")
        for label, (t, n, o, b) in sorted(by_kernel.items()))


def sm_clock_during(torch, fn, seconds=1.0):
    """Run ``fn`` back to back for about ``seconds`` while nvidia-smi
    samples the SM clock every 100 ms; returns the samples (MHz)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    return [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]


def gemm_yardstick(torch, dev):
    """cuBLAS's f32 GEMM (TF32 off) on B4's 40 products at the stage
    shapes, M = pixels, K = taps x Cin, N = Cout, without the gather of
    the taps: how far the card's own f32 matrix product gets on these
    shapes.  Returns (ms, TFLOP/s) summed over the 40."""
    from torch_port_fixtures import resnet50_chain_convs

    g = torch.Generator(device=dev).manual_seed(12)
    total_ms = total_flop = 0.0
    shapes = {}
    for _, P, cin, cout, ks in resnet50_chain_convs(T, S):
        key = (P, ks * ks * cin, cout)
        shapes[key] = shapes.get(key, 0) + 1
    for (M, K, N), n in shapes.items():
        a = torch.randn((M, K), generator=g, device=dev)
        b = torch.randn((K, N), generator=g, device=dev)
        total_ms += n * cuda_ms(torch, lambda: torch.matmul(a, b), 5)
        total_flop += n * 2 * M * K * N
        del a, b
    return total_ms, total_flop / total_ms / 1e9


def check_fused_chain(torch, dev, frames=T):
    """B4 at the four stage shapes of ``frames`` frames (T: one clip's
    trunk chains; BATCH * T: a clip batch of ``batched``): agreement and
    times, summed over the stages.  The plain version is cuDNN's f32
    convolutions with TF32 off, so it is also ``library_ms``."""
    from tao_amodal_torch.ops import fused_stage
    from torch_port_fixtures import chain_inputs

    err = ms = plain_ms = work_bytes = work_ops = 0.0
    by_kernel, mhz = {}, []
    for i, (shape, M, blocks, projection) in enumerate(STAGES):
        shape = (frames,) + shape[1:]
        x, params = chain_inputs(dev, shape, M, blocks, projection,
                                 seed=10 + i)
        with torch.no_grad():
            got = fused_stage.fused_bottleneck_chain(x, params)
            want = fused_stage.bottleneck_chain_torch(x, params)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"fused_bottleneck_chain: bad output {tuple(got.shape)}")
        e = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(e <= FUSED_RTOL * max(scale, 1.0),
              f"fused_bottleneck_chain stage {i + 1} disagrees: max|d| "
              f"{e} at max|out| {scale}")
        k_ms = cuda_ms(
            torch, lambda: fused_stage.fused_bottleneck_chain(x, params), 5)
        p_ms = cuda_ms(
            torch, lambda: fused_stage.bottleneck_chain_torch(x, params), 5)
        flop = chain_flop(shape, M, blocks, projection)
        gflop = flop / 1e9
        n_bytes = nbytes(x, got, *(t for p in params for t in p.values()))
        P = shape[0] * shape[1] * shape[2]
        plans = sorted({fused_stage.conv_plan(
            P, p[w].shape[1], p[w].shape[0], p[w].shape[-1])[:2]
            for p in params for w in p if w[0] == "w"})
        stage = row(e, k_ms, p_ms, bound(n_bytes, flop, "f32"), p_ms)
        log(f"B4 stage {i + 1} {list(shape)} M={M} x{blocks}"
            f"{' +proj' if projection else ''}: max|d| {e:.3e} at max|out| "
            f"{scale:.3e} (rtol {FUSED_RTOL}); {gflop:.1f} GFLOP, "
            f"{roofline_note(stage)}; kernel {gflop / k_ms:.2f} TFLOP/s, "
            f"cuDNN f32 {gflop / p_ms:.2f} TFLOP/s; plans (tile width, "
            f"splits) {plans}")
        err, ms, plain_ms = max(err, e), ms + k_ms, plain_ms + p_ms
        work_bytes, work_ops = work_bytes + n_bytes, work_ops + flop
        traced = chain_breakdown(torch, x, params)
        if traced is None or by_kernel is None:
            by_kernel = None
        else:
            for label, (t, n, f) in traced.items():
                acc = by_kernel.setdefault(label, [0.0, 0, 0])
                acc[0], acc[1], acc[2] = acc[0] + t, acc[1] + n, acc[2] + f
        if i == 2:  # the largest stage: the clock the card holds under B4
            mhz = sorted(sm_clock_during(torch, lambda: (
                fused_stage.fused_bottleneck_chain(x, params))))
        del x, params, got, want
    r = row(err, ms, plain_ms, bound(work_bytes, work_ops, "f32"), plain_ms,
            own_device_ms(by_kernel, ("conv<", "splitk_epilogue")))
    log(f"B4 fused_bottleneck_chain, four stages of {frames} frames: "
        f"{roofline_note(r)}; {work_ops / 1e9 / ms:.2f} TFLOP/s")
    if by_kernel is None:
        note = "not measured: the profiler lost kernels in every trace"
    else:
        note = "; ".join(
            f"{label} {t:.4f} ms x{n}"
            + (f" ({f / t / 1e9:.2f} TFLOP/s)" if f and t else "")
            for label, (t, n, f) in sorted(by_kernel.items()))
    log(f"B4 device time by kernel over the four stages of {frames} "
        f"frames (torch.profiler, one call each): {note}")
    if mhz:
        clock = mhz[len(mhz) // 2]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        log(f"SM clock under B4 (stage 3, nvidia-smi every 100 ms, "
            f"{len(mhz)} samples): median {clock:.0f} MHz, range "
            f"{mhz[0]:.0f}-{mhz[-1]:.0f}; the f32 FMA peak at the median "
            f"clock is {sms * 128 * 2 * clock / 1e6:.2f} TFLOP/s ({sms} SMs "
            f"x 128 FMA lanes)")
    return r


SORT_INT_FIELDS = ("alive", "track_id", "hits", "hit_streak", "age",
                   "time_since_update", "next_id", "frame_count")


def phase_latency(torch, dev, phases=20000):
    """(ns, SM cycles) of one dependent block-wide phase as B3's block of
    512 threads runs them: the mean over ``phases`` of a probe in which
    every thread reads a word another wrote in the previous phase, writes
    its own and meets the block at ``__syncthreads`` (clock64 and the
    global timer, in ``csrc/sort_scan.cu``)."""
    from tao_amodal_torch import _build

    buf = torch.zeros(3, dtype=torch.int64, device=dev)
    for _ in range(2):  # the first launch warms the probe up
        _build.check("tao_sort_scan_phase_probe",
                     _build.library().tao_sort_scan_phase_probe(
                         buf.data_ptr(), phases,
                         torch.cuda.current_stream(dev).cuda_stream))
    torch.cuda.synchronize()
    cycles, ns, _ = buf.tolist()
    return ns / phases, cycles


def rounds_note(rounds):
    """min / median / max / total greedy rounds a frame, ungated and
    gated, from :func:`torch_port_fixtures.sort_rounds` output."""
    r = np.asarray(rounds).reshape(-1, 2)
    return "; ".join(
        f"{label} min {a.min()}, median {np.median(a):g}, max {a.max()}, "
        f"total {a.sum()}"
        for label, a in (("ungated", r[:, 0]), ("gated", r[:, 1])))


def b3_latency_bound(rounds, phase_ns):
    """B3's latency bound in ms on a clip whose frames take ``rounds``
    ([(ungated, gated)]) greedy rounds: its dependent block-wide phases,
    each at least one phase's latency.  The kernel runs the gated
    rounds."""
    phases = (B3_PHASES_PER_FRAME * len(rounds) + 1
              + B3_PHASES_PER_ROUND * sum(g for _, g in rounds))
    return phases, phases * phase_ns / 1e6


def check_sort_scan(torch, dev):
    """B3 against the per-frame loop over SORT_CLIPS threaded clips of
    a coherent scene: integers exact; the greedy rounds of each frame;
    times and the latency bound on the fourth clip."""
    from tao_amodal_torch.ops import sort_scan
    from tao_amodal_torch.trackers.sort import init_sort
    from torch_port_fixtures import coherent_scene, sort_rounds

    boxes, valid = coherent_scene(7, frames=SORT_CLIPS * T,
                                  objects=SORT_OBJECTS, D=NUM_DETS,
                                  extent=600)
    clips = [(torch.from_numpy(boxes[i:i + T]).to(dev),
              torch.from_numpy(valid[i:i + T]).to(dev))
             for i in range(0, SORT_CLIPS * T, T)]
    kw = dict(max_age=5, min_hits=1)  # the pipeline's lifecycle
    got_s = want_s = init_sort(SORT_K, device=dev)
    states, err = [], 0.0
    for b, v in clips:
        states.append(want_s)
        got_s, got = sort_scan.sort_scan(got_s, b, v, assignment="greedy",
                                         impl="pallas", **kw)
        want_s, want = sort_scan.sort_scan(want_s, b, v,
                                           assignment="greedy", **kw)
        for g, w, name in zip(got, want, ("det_track_id", "det_report")):
            check(torch.equal(g, w), f"sort_scan_pallas: {name} differ")
        for f in SORT_INT_FIELDS:
            check(torch.equal(getattr(got_s, f), getattr(want_s, f)),
                  f"sort_scan_pallas: state {f} differs")
        for f in ("x", "P"):
            g, w = getattr(got_s, f), getattr(want_s, f)
            check(torch.allclose(g, w, rtol=SORT_RTOL, atol=SORT_ATOL),
                  f"sort_scan_pallas: state {f} differs")
            err = max(err, float((g - w).abs().max()))
    born, alive = int(got_s.next_id) - 1, int(got_s.alive.sum())
    check(born > alive > 0 and born >= SORT_OBJECTS // 2,
          f"sort scene: {born} born, {alive} alive; want births and deaths")
    log(f"B3 sort_scan_pallas K={SORT_K} D={NUM_DETS} T={T} over "
        f"{SORT_CLIPS} threaded clips: integers equal, {born} tracks born, "
        f"{alive} alive at the end, state max|d| {err:.3e} (rtol "
        f"{SORT_RTOL}, atol {SORT_ATOL})")
    rounds = sort_rounds(init_sort(SORT_K, device="cpu"), clips, **kw)
    log(f"B3 greedy rounds a frame of the coherent scene's plain loop "
        f"({len(rounds)} frames): {rounds_note(rounds)}")
    phase_ns, phase_cycles = phase_latency(torch, dev)
    log(f"B3 one dependent block-wide phase (__syncthreads and a shared-"
        f"memory round trip, 512 threads, clock64 probe): {phase_ns:.1f} "
        f"ns, {phase_cycles} SM cycles")

    state, (b, v) = states[3], clips[3]
    ms = cuda_ms(torch, lambda: sort_scan.sort_scan_pallas(
        state, b, v, **kw), 20)
    dev_ms = device_ms(torch, lambda: sort_scan.sort_scan_pallas(
        state, b, v, **kw), "sort_scan_kernel", 20)
    plain_ms = cuda_ms(torch, lambda: sort_scan.sort_scan_torch(state, b, v,
                                                                **kw), 3)
    walls = {}
    for name, fn, reps in (("kernel", sort_scan.sort_scan_pallas, 20),
                           ("plain", sort_scan.sort_scan_torch, 3)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(state, b, v, **kw)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3 / reps
    log(f"B3 one clip: kernel {ms:.4f} ms (a call back to back, CUDA "
        f"events; host wall {walls['kernel']:.4f} ms), plain "
        f"{plain_ms:.3f} ms (host wall {walls['plain']:.3f} ms)")
    # A lower bound of the work: per frame and slot the Kalman predict
    # (F P F^T and F x: 2 * 7^3 + 7^2 multiply-adds) and update (about
    # 616), about 10 operations per IoU of D x K; the state in and out,
    # the boxes and the ids and report moved once.  The kernel's real
    # limit, its serial chain of frames and greedy rounds, is latency,
    # which this bound does not see.
    ops = T * (2 * SORT_K * (2 * 343 + 49 + 616) + 10 * NUM_DETS * SORT_K)
    r = row(err, ms, plain_ms, bound(2 * nbytes(*state) + nbytes(b, v)
                                     + 5 * b.shape[0] * b.shape[1], ops,
                                     "f32"), dev_ms=dev_ms)
    log(f"B3 sort_scan_pallas: {roofline_note(r)}")
    phases, lat_ms = b3_latency_bound(rounds[3 * T:4 * T], phase_ns)
    log(f"B3 latency bound of the timed clip: {phases} dependent phases x "
        f"{phase_ns:.1f} ns = {lat_ms:.4f} ms; the kernel at "
        f"{100 * lat_ms / ms:.1f} % of it (CUDA events)"
        + ("" if dev_ms is None else
           f", {100 * lat_ms / dev_ms:.1f} % (device time)"))
    return r


def check_prroi_variants(torch, dev, pyramid, rois, b2):
    """B5 on the serving canvas padded to 112 columns (bit for bit B2's
    output ``b2`` on the unpadded canvas, and within PRROI_ATOL of its
    plain version), and B6 on each level of the P3..P6 ``pyramid``
    (times summed over the four levels: the multilevel route's cost)."""
    from tao_amodal_torch.ops import prroi, roi

    canvas, rois_p = roi.pack_levels(pyramid, rois, canonical_level=1,
                                     strides=LEVEL_STRIDES,
                                     width_multiple=16)
    got = prroi.prroi_packed_pallas(canvas, rois_p)
    want = prroi.prroi_packed_pallas_torch(canvas, rois_p)
    check(canvas.shape[2] == 112 and got.shape == b2.shape,
          f"prroi_packed_pallas: canvas {list(canvas.shape)}, output "
          f"{list(got.shape)}")
    err = float((got - want).abs().max())
    log(f"B5 prroi_packed_pallas canvas {list(canvas.shape)} rois "
        f"{list(rois_p.shape)}: max|d| {err:.3e} (atol {PRROI_ATOL}); "
        f"equal to B2 on the 98-wide canvas: {torch.equal(got, b2)}")
    check(err <= PRROI_ATOL, f"prroi_packed_pallas disagrees: {err}")
    check(torch.equal(got, b2), "prroi_packed_pallas differs from "
          "prroi_packed: the zero columns must add nothing")
    rows = {"prroi_packed_pallas": row(
        err,
        cuda_ms(torch, lambda: prroi.prroi_packed_pallas(canvas, rois_p),
                50),
        cuda_ms(torch, lambda: prroi.prroi_packed_pallas_torch(canvas,
                                                               rois_p), 20),
        bound(*prroi_bound(rois_p, got, *canvas.shape[1:3]), "f32"),
        dev_ms=device_ms(torch, lambda: prroi.prroi_packed_pallas(
            canvas, rois_p), "prroi_kernel", 50))}
    log(f"B5 prroi_packed_pallas: "
        f"{roofline_note(rows['prroi_packed_pallas'])}")
    err = ms = plain_ms = work_bytes = work_ops = dev_ms = 0.0
    for level, stride in zip(pyramid, LEVEL_STRIDES):
        got = prroi.prroi_pool_pallas(level, rois, 7, 1.0 / stride)
        want = prroi.prroi_pool_pallas_torch(level, rois, 7, 1.0 / stride)
        e = float((got - want).abs().max())
        k_ms = cuda_ms(torch, lambda: prroi.prroi_pool_pallas(
            level, rois, 7, 1.0 / stride), 20)
        p_ms = cuda_ms(torch, lambda: prroi.prroi_pool_pallas_torch(
            level, rois, 7, 1.0 / stride), 10)
        d_ms = device_ms(torch, lambda: prroi.prroi_pool_pallas(
            level, rois, 7, 1.0 / stride), "prroi_kernel", 20)
        dev_ms = None if d_ms is None or dev_ms is None else dev_ms + d_ms
        # The kernel pools the RoIs scaled by 1/stride in f32.
        b, o = prroi_bound(rois * (1.0 / stride), got, *level.shape[1:3])
        log(f"B6 prroi_pool_pallas level {list(level.shape)} scale "
            f"1/{stride}: max|d| {e:.3e} (atol {PRROI_ATOL}); kernel "
            f"{k_ms:.4f} ms, bound {bound(b, o, 'f32')[0]:.4f} ms, plain "
            f"{p_ms:.4f} ms")
        check(e <= PRROI_ATOL, f"prroi_pool_pallas disagrees: {e}")
        err, ms, plain_ms = max(err, e), ms + k_ms, plain_ms + p_ms
        work_bytes, work_ops = work_bytes + b, work_ops + o
    rows["prroi_pool_pallas"] = row(err, ms, plain_ms,
                                    bound(work_bytes, work_ops, "f32"),
                                    dev_ms=dev_ms)
    log(f"B6 prroi_pool_pallas, four levels: "
        f"{roofline_note(rows['prroi_pool_pallas'])}")
    return rows


def stack_mac(shape, M, blocks):
    """Multiply-adds of an identity stack, from its shapes."""
    return shape[0] * shape[1] * shape[2] * blocks * (
        2 * shape[-1] * M + 9 * M * M)


def bf16_close(torch, got, want, what, other=None):
    """B8's rule for a bf16 result ``got`` against its plain version
    ``want`` (max |d| <= 1e-2 max|ref|, mean |d| <= 1e-3 mean|ref|), or,
    given ``other`` (the plain version in another f32 order, on the
    CPU), twice its spread where that is larger.  Returns (max |d|, a
    log note)."""
    got, want = got.float(), want.to(got.device).float()
    d = (got - want).abs()
    e, mean = float(d.max()), float(d.mean())
    ref_max, ref_mean = float(want.abs().max()), float(want.abs().mean())
    max_b, mean_b = BF16_MAX_RTOL * ref_max, BF16_MEAN_RTOL * ref_mean
    note = ""
    if other is not None:
        spread = (other.to(want.device).float() - want).abs()
        max_b = max(max_b, BF16_SPREAD * float(spread.max()))
        mean_b = max(mean_b, BF16_SPREAD * float(spread.mean()))
        note = (f"; plain on the CPU vs the card: max|d| "
                f"{float(spread.max()):.3e}, mean|d| "
                f"{float(spread.mean()) / ref_mean:.2e} of mean|ref|")
    check(bool(torch.isfinite(got).all()) and e <= max_b and mean <= mean_b,
          f"{what} disagrees: max|d| {e} (bound {max_b}), mean|d| {mean} "
          f"(bound {mean_b})")
    return e, (f"max|d| {e:.3e} at max|ref| {ref_max:.3e}, mean|d| "
               f"{mean / ref_mean:.2e} of mean|ref|, "
               f"{float((d == 0).float().mean()):.4f} equal{note}")


def bf16_agreement(torch, got, want, x, p, what):
    """B8's output ``got`` against the plain version's ``want`` on the
    card, by :func:`bf16_close` beside the spread of the plain version
    itself: the same stack ``(x, p)`` through the plain version on the
    CPU (f32 sums in another order).  Returns (max |d|, a log note)."""
    from tao_amodal_torch.ops.resnet_blocks import (
        identity_blocks_bf16_reference,
    )

    alt = identity_blocks_bf16_reference(
        x.cpu(), type(p)(*(t.cpu() for t in p)))
    return bf16_close(torch, got, want, what, other=alt)


def bf16_stack_cudnn(torch, p):
    """B8's function through cuDNN, the yardstick of its ``library_ms``:
    each conv one bf16 ``F.conv2d`` (channels last), the BN scale and
    bias, the residual and the ReLU in eager f32, rounded to bf16 after
    each conv as B8 rounds.  (cuDNN rounds each conv's sums to bf16
    before the epilogue: one rounding more than B8.)  Returns the stack
    as a function of ``x [T, H, W, C]`` bf16."""
    F, bf16 = torch.nn.functional, torch.bfloat16
    cl = torch.channels_last
    N = p.w1.shape[0]
    w1 = [p.w1[i].t()[..., None, None].contiguous(memory_format=cl)
          for i in range(N)]
    w2 = [p.w2[i].permute(3, 2, 0, 1).contiguous(memory_format=cl)
          for i in range(N)]
    w3 = [p.w3[i].t()[..., None, None].contiguous(memory_format=cl)
          for i in range(N)]
    g1, b1, g2, b2, g3, b3 = ([v[:, None, None] for v in t]
                              for t in (p.g1, p.b1, p.g2, p.b2, p.g3, p.b3))

    def run(x):
        cur = x.permute(0, 3, 1, 2)
        for i in range(N):
            y1 = (F.conv2d(cur, w1[i]).float() * g1[i] + b1[i]).clamp_min(
                0.0).to(bf16)
            y2 = (F.conv2d(y1, w2[i], padding=1).float() * g2[i]
                  + b2[i]).clamp_min(0.0).to(bf16)
            cur = (F.conv2d(y2, w3[i]).float() * g3[i] + b3[i]
                   + cur.float()).clamp_min(0.0).to(bf16)
        return cur.permute(0, 2, 3, 1)

    return run


def int8_stack_int_mm(torch, p):
    """B7's function through cuBLASLt's int8 GEMM on the tensor cores
    (``torch._int_mm``), the yardstick of its ``library_ms``: each 1x1
    conv one ``[P, Cin] x [Cin, Cout]`` product, the 3x3 nine shifted
    products summed in int32, the requantization in eager torch as the
    plain version computes it, so the output equals the plain version's.
    Returns the stack as a function of ``x [T, H, W, C]`` int8."""
    from tao_amodal_torch.ops.resnet_blocks import _rq

    F, f32 = torch.nn.functional, torch.float32
    N, _, M = p.w1.shape
    w2 = [[p.w2[i, dy, dx].contiguous() for dy in range(3)
           for dx in range(3)] for i in range(N)]

    def run(x):
        T, H, W, C = x.shape
        P = T * H * W
        x = x.reshape(P, C)
        for i in range(N):
            y1 = _rq(torch._int_mm(x, p.w1[i]).to(f32), p.s1[i], p.b1[i])
            yp = F.pad(y1.reshape(T, H, W, M), (0, 0, 1, 1, 1, 1))
            acc = None
            for t in range(9):
                d = torch._int_mm(yp[:, t // 3:t // 3 + H, t % 3:t % 3 + W]
                                  .reshape(P, M), w2[i][t])
                acc = d if acc is None else acc + d
            y2 = _rq(acc.to(f32), p.s2[i], p.b2[i])
            acc3 = torch._int_mm(y2, p.w3[i]).to(f32)
            y3 = acc3 * p.s3[i] + p.b3[i] + x.to(f32) * p.res_scale[i]
            x = torch.round(y3.clamp_min(0.0)).clamp(0, 127).to(torch.int8)
        return x.reshape(T, H, W, C)

    return run


def check_stacks(torch, dev):
    """B7 and B8 at the four stage shapes on seeded random stacks:
    agreement and times (summed over the stages: one clip's stacks),
    each stage beside its bound and both yardsticks: B7's through
    :func:`int8_stack_int_mm` (its output must equal the plain
    version's), B8's through :func:`bf16_stack_cudnn`.  The plain int8
    version runs float64 dots, so it is timed over few repetitions."""
    from tao_amodal_torch.ops import resnet_blocks as rb
    from torch_port_fixtures import stack_arrays, torch_stack

    rows = {}
    for kind, fn, ref in (
            ("int8", rb.identity_blocks_pallas, rb.identity_blocks_reference),
            ("bf16", rb.identity_blocks_bf16_pallas,
             rb.identity_blocks_bf16_reference)):
        err = ms = plain_ms = lib_ms = work_bytes = work_ops = 0.0
        by_kernel, mhz = {}, []
        for i, (shape, M, blocks) in enumerate(STACKS):
            x, p = torch_stack(dev, *stack_arrays(shape, M, blocks, kind,
                                                  seed=20 + i), kind)
            got, want = fn(x, p), ref(x, p)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{fn.__name__}: bad output {tuple(got.shape)} "
                  f"{got.dtype}")
            if kind == "int8":
                e = float((got.int() - want.int()).abs().max())
                check(e == 0, f"identity_blocks_pallas stage {i + 1} "
                      f"differs from the plain version by up to {e}")
                note = (f"int8 outputs equal, "
                        f"{float((want > 0).float().mean()):.3f} nonzero")
            else:
                e, note = bf16_agreement(
                    torch, got, want, x, p,
                    f"identity_blocks_bf16_pallas stage {i + 1}")
            k_ms = cuda_ms(torch, lambda: fn(x, p), 5)
            p_ms = cuda_ms(torch, lambda: ref(x, p),
                           2 if kind == "int8" else 3)
            ops = 2 * stack_mac(shape, M, blocks)
            gop = ops / 1e9
            n_bytes = nbytes(x, got, *p)
            lib = None
            if kind == "bf16":
                cudnn = bf16_stack_cudnn(torch, p)
                alt = cudnn(x).float()
                cos = float((alt * want.float()).sum() / (
                    alt.norm() * want.float().norm() + 1e-9))
                check(cos > 0.999, f"cuDNN bf16 stack stage {i + 1}: "
                      f"cosine {cos} to the plain version")
                lib = cuda_ms(torch, lambda: cudnn(x), 5)
                note += (f"; cuDNN bf16 stack cosine {cos:.6f} to plain, "
                         f"{lib:.4f} ms, {gop / lib:.2f} TOP/s")
            elif lib_ms is not None:
                int_mm = int8_stack_int_mm(torch, p)
                try:
                    alt = int_mm(x)
                except RuntimeError as exc:
                    lib_ms = None
                    note += f"; torch._int_mm refused stage {i + 1}: {exc}"
                else:
                    check(torch.equal(alt, want),
                          f"torch._int_mm stack stage {i + 1} differs from "
                          f"the plain version")
                    lib = cuda_ms(torch, lambda: int_mm(x), 5)
                    note += (f"; torch._int_mm stack equal to plain, "
                             f"{lib:.4f} ms, {gop / lib:.2f} TOP/s")
            stage = row(e, k_ms, p_ms, bound(n_bytes, ops, kind), lib)
            log(f"{'B7' if kind == 'int8' else 'B8'} {fn.__name__} stage "
                f"{i + 1} {list(shape)} M={M} x{blocks}: {note}; "
                f"{gop:.1f} G ops, {roofline_note(stage)}; kernel "
                f"{gop / k_ms:.2f} TOP/s, plain {gop / p_ms:.2f} TOP/s")
            err, ms, plain_ms = max(err, e), ms + k_ms, plain_ms + p_ms
            if lib is not None and lib_ms is not None:
                lib_ms += lib
            work_bytes, work_ops = work_bytes + n_bytes, work_ops + ops
            traced = stack_breakdown(torch, fn, x, p)
            if traced is None or by_kernel is None:
                by_kernel = None
            else:
                for label, r in traced.items():
                    acc = by_kernel.setdefault(label, [0.0, 0, 0, 0])
                    for j in range(4):
                        acc[j] += r[j]
            if i == 0:  # the stage whose convs move the most bytes
                mhz = sorted(sm_clock_during(torch, lambda: fn(x, p)))
            del x, p, got, want
        rows[fn.__name__] = row(
            err, ms, plain_ms, bound(work_bytes, work_ops, kind), lib_ms,
            own_device_ms(by_kernel, ("conv<", "transpose_s8_kernel")))
        log(f"{fn.__name__}, four stages: {roofline_note(rows[fn.__name__])}"
            f"; {work_ops / 1e9 / ms:.2f} TOP/s")
        log(f"{fn.__name__} device time by kernel over the four stages "
            f"(torch.profiler, one call each): {breakdown_note(by_kernel)}")
        if mhz:
            log(f"SM clock under {fn.__name__} (stage 1, nvidia-smi every "
                f"100 ms, {len(mhz)} samples): median "
                f"{mhz[len(mhz) // 2]:.0f} MHz, range {mhz[0]:.0f}-"
                f"{mhz[-1]:.0f}")
    return rows


def phase_kernels(torch, dev):
    """Each kernel against its plain version at the path's shapes."""
    from tao_amodal_torch.ops import preproc, prroi, roi
    from torch_port_fixtures import PREPROC_ODD

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
    # Two 2-tap multiply-adds and the normalization per output value.
    rows["preprocess_frames"] = row(
        err, cuda_ms(torch, lambda: preproc.preprocess_frames(frames, S), 50),
        cuda_ms(torch, lambda: preproc.preprocess_frames_torch(frames, S),
                50),
        bound(nbytes(frames, got), 10 * got.numel(), "f32"),
        dev_ms=device_ms(torch, lambda: preproc.preprocess_frames(frames, S),
                         "preproc_kernel", 50))
    log(f"B1 preprocess_frames: {roofline_note(rows['preprocess_frames'])}")
    for t_, h_, w_, s_ in PREPROC_ODD:
        odd = torch.from_numpy(np.random.RandomState(h_).randint(
            0, 256, (t_, h_, w_, 3), dtype=np.uint8)).to(dev)
        got = preproc.preprocess_frames(odd, s_)
        want = preproc.preprocess_frames_torch(odd, s_)
        e = float((got - want).abs().max())
        log(f"B1 preprocess_frames [{t_},{h_},{w_},3] -> {s_}^2: max|d| "
            f"{e:.3e}, {float((got == want).float().mean()):.6f} equal")
        check(got.shape == want.shape and e <= PREPROC_ATOL,
              f"preprocess_frames [{t_},{h_},{w_},3] -> {s_}^2 disagrees: "
              f"{e}")

    g = torch.Generator(device=dev).manual_seed(1)
    pyramid = [torch.randn((T, n, n, 256), generator=g, device=dev)
               for n in (64, 32, 16, 8)]
    rois = serving_rois(torch, dev, 2)
    canvas, rois_p = roi.pack_levels(pyramid, rois, canonical_level=1,
                                     strides=LEVEL_STRIDES)
    got = prroi.prroi_packed(canvas, rois_p)
    want = prroi.prroi_packed_torch(canvas, rois_p)
    check(got.shape == (T, 96, 7, 7, 256)
          and bool(torch.isfinite(got).all()),
          f"prroi_packed: bad output {tuple(got.shape)}")
    err = float((got - want).abs().max())
    log(f"B2 prroi_packed canvas {list(canvas.shape)} rois "
        f"{list(rois_p.shape)}: max|d| {err:.3e} (atol {PRROI_ATOL})")
    check(err <= PRROI_ATOL, f"prroi_packed disagrees: {err}")
    rows["prroi_packed"] = row(
        err, cuda_ms(torch, lambda: prroi.prroi_packed(canvas, rois_p), 50),
        cuda_ms(torch, lambda: prroi.prroi_packed_torch(canvas, rois_p), 20),
        bound(*prroi_bound(rois_p, got, *canvas.shape[1:3]), "f32"),
        dev_ms=device_ms(torch, lambda: prroi.prroi_packed(canvas, rois_p),
                         "prroi_kernel", 50))
    log(f"B2 prroi_packed: {roofline_note(rows['prroi_packed'])} (bound: "
        f"the RoIs' supports of the canvas, not the whole canvas)")
    b2 = got
    rows.update(check_prroi_variants(torch, dev, pyramid, rois, b2))
    del frames, pyramid, canvas, rois_p, got, want, b2
    rows["sort_scan_pallas"] = check_sort_scan(torch, dev)
    rows["fused_bottleneck_chain"] = check_fused_chain(torch, dev)
    g_ms, g_tflops = gemm_yardstick(torch, dev)
    log(f"cuBLAS f32 GEMM (TF32 off) on B4's 40 products, taps gathered "
        f"beforehand (not a port path): {g_ms:.4f} ms, {g_tflops:.2f} "
        f"TFLOP/s")
    rows.update(check_stacks(torch, dev))
    for name, r in rows.items():
        log(f"{name}: {roofline_note(r)}")
    return rows


# B2's gradients on the card against the plain route's autograd: the same
# autograd graph (B2's backward recomputes the plain forward), equal up to
# the order cuBLAS sums in.
GRAD_RTOL = 1e-5


def phase_gradients(torch, dev):
    """B2's autograd on the card, f32 and bf16, at the serving shapes (a
    P3..P6 pyramid of a clip at 512^2, C=256, 96 RoIs a frame): the
    gradients of ``multilevel_roi_align``'s B2 route (the ``"auto"``
    pooling) with respect to the pyramid and the RoIs against those of
    the plain route (``prroi_pool`` cast to the output's dtype, JAX's
    ``_prroi_autodiff_bwd``), within GRAD_RTOL of the largest gradient;
    then B5, B6 and B8, which have no backward, raise under grad."""
    from tao_amodal_torch.ops import prroi, resnet_blocks, roi
    from torch_port_fixtures import stack_arrays, torch_stack

    g = torch.Generator(device=dev).manual_seed(60)
    kw = dict(canonical_level=1, strides=LEVEL_STRIDES)
    rois = serving_rois(torch, dev, 61)
    for dtype in (torch.float32, torch.bfloat16):
        pyramid = [torch.randn((T, n, n, 256), generator=g, device=dev).to(
            dtype) for n in (64, 32, 16, 8)]
        cot = torch.randn((T, 96, 7, 7, 256), generator=g, device=dev).to(
            dtype)

        def grads(pool):
            pyr = [p.clone().requires_grad_() for p in pyramid]
            boxes = rois.clone().requires_grad_()
            canvas, rois_p = roi.pack_levels(pyr, boxes, **kw)
            pool(canvas, rois_p).backward(cot)
            return [p.grad for p in pyr] + [boxes.grad]

        counter = (prroi.prroi_packed.bf16 if dtype == torch.bfloat16
                   else prroi.prroi_packed)
        n = counter.launches
        got = grads(prroi.prroi_packed)
        check(counter.launches == n + 1, "B2's forward under autograd did "
              "not launch its kernel")
        want = grads(lambda c, r: roi.prroi_pool(c, r, 7, 1.0).to(dtype))
        worst, reached = 0.0, []
        for name, a, b in zip(("P3", "P4", "P5", "P6", "rois"), got, want):
            scale = float(b.float().abs().max())
            e = float((a.float() - b.float()).abs().max())
            check(e <= GRAD_RTOL * scale, f"B2 {dtype} gradient of {name}: "
                  f"max|d| {e} at max|grad| {scale}")
            if scale > 0:  # a level no RoI is assigned to gets none
                worst = max(worst, e / scale)
                reached.append(name)
        check("rois" in reached and len(reached) > 1, f"B2 {dtype}: "
              f"gradients reach only {reached}")
        log(f"B2 {str(dtype)[6:]} gradients ({', '.join(reached)}; {T} "
            f"frames, 96 RoIs, C=256) equal to the plain route's autograd: "
            f"max|d| {worst:.3e} of the largest gradient (bound "
            f"{GRAD_RTOL})")
    canvas, rois_p = roi.pack_levels(pyramid, rois, **kw)
    leaf = canvas.float().requires_grad_()
    x, p = torch_stack(dev, *stack_arrays((2, 16, 16, 64), 16, 2, "bf16"),
                       "bf16")
    for name, call in (
            ("B5", lambda: prroi.prroi_packed_pallas(leaf, rois_p)),
            ("B6", lambda: prroi.prroi_pool_pallas(leaf, rois_p, 7, 0.5)),
            ("B8", lambda: resnet_blocks.identity_blocks_bf16_pallas(
                x.clone().requires_grad_(), p))):
        try:
            call()
        except ValueError as exc:
            check("forward only" in str(exc), f"{name}: {exc}")
        else:
            raise SmokeFailure(f"{name} ran under grad without a backward")
    log("B5, B6 and B8 raise under grad (no backward, as in JAX)")


def check_outputs(torch, out, t, d, lead=()):
    """Shapes (``lead`` leading axes, then ``[t, d]``), finite floats,
    some valid detection."""
    lead = tuple(lead)
    shapes = {"boxes": (*lead, t, d, 4), "visible_boxes": (*lead, t, d, 4),
              "scores": (*lead, t, d), "classes": (*lead, t, d),
              "track_ids": (*lead, t, d), "valid": (*lead, t, d)}
    for k, shape in shapes.items():
        check(tuple(out[k].shape) == shape,
              f"output {k}: shape {tuple(out[k].shape)}, want {shape}")
    for k in ("boxes", "visible_boxes", "scores"):
        check(bool(torch.isfinite(out[k]).all()), f"output {k}: not finite")
    check(bool(out["valid"].any()), "no valid detection")


def phase_pipeline(torch, dev, wrappers):
    """The main paths at full width: the default (unfused) pipeline, the
    fused-trunk pipeline, the pallas_pooling pipeline and the B6 route
    on its pyramids, and the clip-level SORT scan on the fused run's
    boxes.  Returns each kernel's launch count from the path that runs
    it, and (the unfused pipeline, the fused one, the unfused run's
    outputs of its two clips) for the later phases."""
    from tao_amodal_torch.ops import sort_scan
    from tao_amodal_torch.pipeline import AmodalPipeline
    from torch_port_fixtures import sort_rounds

    pipe = AmodalPipeline.create(device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    fused = AmodalPipeline.create(device=dev, fused_stages=FUSED)
    fused.load_state_dict(pipe.state_dict())
    pallas = AmodalPipeline.create(device=dev, pallas_pooling=True)
    pallas.load_state_dict(pipe.state_dict())
    # Keep the pallas_pooling run's pyramids, proposals and pooled
    # features for the B6 route below.
    pooled_by_b5 = []
    pool_b5 = pallas.detector.pool_rois

    def keep_pool(pyramid, rois):
        out = pool_b5(pyramid, rois)
        pooled_by_b5.append((pyramid, rois, out))
        return out

    pallas.detector.pool_rois = keep_pool
    rs = np.random.RandomState(3)
    clips = [rs.randint(0, 256, (T, H, W, 3), dtype=np.uint8)
             for _ in range(2)]
    score_thr = 0.0

    def run_clip(p, raw, state):
        clip, scale = p.preprocess(torch.from_numpy(raw).to(dev),
                                   out_size=S)
        # Random weights put class scores near 1/81, under the serving
        # threshold of 0.05: keep every detection so tracks are born.
        out, state = p.streaming(clip, state, score_thr=score_thr)
        return out, state, scale

    def run_path(p):
        state, outs = p.init_tracker_state(), []
        for raw in clips:
            out, state, scale = run_clip(p, raw, state)
            outs.append(out)
        return outs, state, scale

    launches, outs = {}, {}
    for label, p, kernels in (
            ("unfused", pipe, ("preprocess_frames", "prroi_packed")),
            ("fused", fused, ("preprocess_frames", "prroi_packed",
                              "fused_bottleneck_chain")),
            ("pallas_pooling", pallas, ("preprocess_frames",
                                        "prroi_packed_pallas"))):
        (outs[label], state, scale), n = counted(torch, wrappers,
                                                 lambda: run_path(p))
        log(f"{label} main path over {len(clips)} clips: launches {n}, "
            f"next_id {int(state.next_id)}, scale {scale}")
        for k in kernels:
            check(n[k] > 0, f"{k} was not launched on the {label} path")
            launches.setdefault(k, n[k])
        for k, want in (("fused_bottleneck_chain",
                         4 * len(clips) if p is fused else 0),
                        ("prroi_packed", 0 if p is pallas else len(clips)),
                        ("prroi_packed_pallas",
                         len(clips) if p is pallas else 0)):
            check(n[k] == want, f"{label} path: {k} launched {n[k]} times, "
                  f"want {want}")
        for out in outs[label]:
            check_outputs(torch, out, T, NUM_DETS)
        check(int(state.next_id) > 1, f"{label} path: no track was born")
    for label in ("fused", "pallas_pooling"):
        pairs = list(zip(outs["unfused"], outs[label]))
        d_box = max(float((a["visible_boxes"] - b["visible_boxes"]).abs()
                          .max()) for a, b in pairs)
        d_cls = sum(int((a["classes"] != b["classes"]).sum())
                    for a, b in pairs)
        log(f"{label} vs unfused at full width: visible boxes max|d| "
            f"{d_box:.3e} px, {d_cls} of {2 * T * NUM_DETS} classes differ")
    for a, b in zip(outs["unfused"], outs["pallas_pooling"]):
        for k in ("classes", "track_ids", "valid"):
            check(torch.equal(a[k], b[k]),
                  f"pallas_pooling path: {k} differ from the default path")
    launches["prroi_pool_pallas"] = check_b6_route(torch, wrappers,
                                                   pooled_by_b5)

    # The clip-level SORT scan on the fused run's own detections.
    dets = [(o["visible_boxes"], o["scores"] > score_thr)
            for o in outs["fused"]]

    kw = dict(max_age=fused.sort_max_age, min_hits=fused.sort_min_hits)

    def scan(impl):
        state, ids, starts = fused.init_tracker_state(), [], []
        for boxes, valid in dets:
            starts.append(state)
            state, (i, _) = sort_scan.sort_scan(
                state, boxes, valid, assignment="greedy",
                impl=impl, **kw)
            ids.append(i)
        return torch.stack(ids), state, starts

    (k_ids, k_state, _), n = counted(torch, wrappers,
                                     lambda: scan("pallas"))
    check(n["sort_scan_pallas"] == len(clips),
          f"sort_scan(impl='pallas') launched {n['sort_scan_pallas']} "
          f"times over {len(clips)} clips")
    launches["sort_scan_pallas"] = n["sort_scan_pallas"]
    p_ids, p_state, starts = scan("auto")
    check(torch.equal(p_ids, torch.stack([o["track_ids"]
                                          for o in outs["fused"]])),
          "sort_scan(impl='auto') differs from the pipeline's own SORT")
    check(int(k_state.next_id) > 1, "sort_scan_pallas: no track was born")
    log(f"B3 on the fused pipeline's boxes over {len(clips)} clips: "
        f"launches {n['sort_scan_pallas']}, {int((k_ids != p_ids).sum())} "
        f"of {k_ids.numel()} ids differ from the plain loop; next_id "
        f"kernel {int(k_state.next_id)}, plain {int(p_state.next_id)}")
    check(torch.equal(k_ids, p_ids), "sort_scan_pallas: track ids on the "
          "pipeline's boxes differ from the plain loop's")
    rounds = sort_rounds(starts[0], dets, **kw)
    log(f"B3 greedy rounds a frame of the plain loop on the fused "
        f"pipeline's boxes ({len(rounds)} frames, "
        f"{int(sum(int(v.sum()) for _, v in dets))} valid detections): "
        f"{rounds_note(rounds)}")
    ms = [cuda_ms(torch, lambda: sort_scan.sort_scan_pallas(
        st, boxes, valid, **kw), 20)
        for st, (boxes, valid) in zip(starts, dets)]
    dev_ms = [device_ms(torch, lambda: sort_scan.sort_scan_pallas(
        st, boxes, valid, **kw), "sort_scan_kernel", 20)
        for st, (boxes, valid) in zip(starts, dets)]
    plain = [cuda_ms(torch, lambda: sort_scan.sort_scan_torch(
        st, boxes, valid, **kw), 2) for st, (boxes, valid) in zip(starts,
                                                                   dets)]
    phase_ns, _ = phase_latency(torch, dev)
    bounds = [b3_latency_bound(rounds[i * T:(i + 1) * T], phase_ns)[1]
              for i in range(len(dets))]
    log(f"B3 one clip of the fused pipeline's boxes (mean of {len(dets)} "
        f"clips): kernel {sum(ms) / len(ms):.4f} ms (CUDA events; clips "
        f"{', '.join(f'{m:.4f}' for m in ms)}), device time "
        + ("not measured" if None in dev_ms else
           f"{sum(dev_ms) / len(dev_ms):.4f} ms (torch.profiler; clips "
           f"{', '.join(f'{m:.4f}' for m in dev_ms)})")
        + f", plain {sum(plain) / len(plain):.3f} ms, latency bound "
        f"{sum(bounds) / len(bounds):.4f} ms at {phase_ns:.1f} ns a phase")

    def clip_ms(p, reps=4):
        state = p.init_tracker_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            out, state, _ = run_clip(p, clips[i % 2], state)
            host = {k: v.cpu() for k, v in out.items()}
        torch.cuda.synchronize()
        check(bool(torch.isfinite(host["boxes"]).all()), "timed clip: NaN")
        return (time.perf_counter() - t0) * 1e3 / reps

    times = {"unfused": [], "fused": []}
    for label, p in (("unfused", pipe), ("fused", fused), ("fused", fused),
                     ("unfused", pipe)):
        times[label].append(clip_ms(p))
    for label, ts in times.items():
        mean = sum(ts) / len(ts)
        log(f"{label} clip wall time after warm-up (uint8 host frames -> "
            f"host outputs, 2 x 4 clips in turns {ts[0]:.2f}, {ts[1]:.2f}):"
            f" {mean:.2f} ms/clip = {T * 1e3 / mean:.1f} frames/s at {S}^2,"
            f" T={T}, f32")

    clip, _ = pipe.preprocess(torch.from_numpy(clips[0]).to(dev),
                              out_size=S)
    images = clip.permute(0, 3, 1, 2)

    def trunk_ms(p, reps=5):
        with torch.no_grad():
            p.detector.backbone(images)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                p.detector.backbone(images)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    trunks = {"unfused": [], "fused": []}
    for label, p in (("unfused", pipe), ("fused", fused), ("fused", fused),
                     ("unfused", pipe)):
        trunks[label].append(trunk_ms(p))
    log(f"trunk alone (ResNet-50, one preprocessed clip, synchronized host "
        f"clock, 2 x 5 runs in turns): unfused {trunks['unfused'][0]:.2f}, "
        f"{trunks['unfused'][1]:.2f} ms; fused {trunks['fused'][0]:.2f}, "
        f"{trunks['fused'][1]:.2f} ms")
    return launches, (pipe, fused, outs["unfused"])


def check_b6_route(torch, wrappers, pooled_by_b5):
    """``multilevel_roi_align(method="prroi_pallas")`` on the pyramids
    and proposals of the pallas_pooling run: every RoI at every level
    through B6, then the one-hot level select.  Compared with that run's
    B5 pooling; returns B6's launches."""
    from tao_amodal_torch.ops.roi import multilevel_roi_align

    def route():
        return [multilevel_roi_align(
            [f.permute(0, 2, 3, 1) for f in pyramid[:4]], rois,
            canonical_level=1, strides=LEVEL_STRIDES, method="prroi_pallas")
            for pyramid, rois, _ in pooled_by_b5]

    pooled, n = counted(torch, wrappers, route)
    check(n["prroi_pool_pallas"] == 4 * len(pooled_by_b5),
          f"B6 route: prroi_pool_pallas launched {n['prroi_pool_pallas']} "
          f"times, want {4 * len(pooled_by_b5)}")
    err = scale = 0.0
    for got, (_, _, want) in zip(pooled, pooled_by_b5):
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"B6 route: bad output {tuple(got.shape)}")
        err = max(err, float((got - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
    log(f"B6 route on the pallas_pooling run's pyramids over "
        f"{len(pooled)} clips: launches {n['prroi_pool_pallas']}, max|d| "
        f"{err:.3e} against its B5 pooling at max|pooled| {scale:.3e} "
        f"(rtol {POOL_ROUTE_RTOL})")
    check(err <= POOL_ROUTE_RTOL * max(scale, 1.0),
          f"B6 route disagrees with B5: {err}")
    return n["prroi_pool_pallas"]


def clip_batch(torch, p, raws, size):
    """The preprocessed clips ``[B, T, size, size, 3]`` of ``raws`` (one
    uint8 ``[T, H, W, 3]`` clip a video), each through ``p.preprocess``
    (B1 on the card) as a video's clip is."""
    return torch.stack([p.preprocess(torch.from_numpy(r).to(p.device),
                                     out_size=size)[0] for r in raws])


def check_batched_kernels(torch, dev, pyramid, rois):
    """B2 and B4 at the shapes ``batched`` gives them (B*T = 32 frames):
    B2 on the batched run's own pyramid and proposals, B4 on the four
    ResNet-50 chains at 32 frames, each against its plain version and
    timed beside its bound (logged only: the kernels line keeps the
    single-stream shapes)."""
    from tao_amodal_torch.ops import prroi, roi

    frames = BATCH * T
    canvas, rois_p = roi.pack_levels(
        [f.permute(0, 2, 3, 1) for f in pyramid[:4]], rois,
        canonical_level=1, strides=LEVEL_STRIDES)
    got = prroi.prroi_packed(canvas, rois_p)
    want = prroi.prroi_packed_torch(canvas, rois_p)
    check(got.shape == (frames, rois.shape[1], 7, 7, pyramid[0].shape[1])
          and bool(torch.isfinite(got).all()),
          f"prroi_packed at {frames} frames: bad output {tuple(got.shape)}")
    err = float((got - want).abs().max())
    check(err <= PRROI_ATOL, f"prroi_packed at {frames} frames disagrees: "
          f"{err}")
    r = row(
        err, cuda_ms(torch, lambda: prroi.prroi_packed(canvas, rois_p), 20),
        cuda_ms(torch, lambda: prroi.prroi_packed_torch(canvas, rois_p), 5),
        bound(*prroi_bound(rois_p, got, *canvas.shape[1:3]), "f32"),
        dev_ms=device_ms(torch, lambda: prroi.prroi_packed(canvas, rois_p),
                         "prroi_kernel", 20))
    log(f"B2 prroi_packed at {frames} frames (the batched run's canvas "
        f"{list(canvas.shape)}, rois {list(rois_p.shape)}): max|d| "
        f"{err:.3e} (atol {PRROI_ATOL}); {roofline_note(r)}")
    del canvas, rois_p, got, want

    check_fused_chain(torch, dev, frames)


def phase_batched(torch, dev, wrappers, pipe, fused):
    """Multi-video serving at full width: BATCH videos' clips through
    ``AmodalPipeline.batched`` (``[BATCH*T]`` frames a batch), two clip
    batches with the states threaded, unfused and fused.  Tracking
    half: SORT on batched's own detections equals BATCH
    ``sort_scan(impl="auto")`` runs of them, integer for integer.
    Detector half: batched against BATCH ``streaming`` calls on the same
    frames, printed (cuDNN may pick other algorithms at another batch
    size).  Then B2 and B4 at 32 frames, and one clip batch timed
    against BATCH streaming clips in turns."""
    from tao_amodal_torch.ops import sort_scan

    rs = np.random.RandomState(12)
    batches = [[rs.randint(0, 256, (T, H, W, 3), dtype=np.uint8)
                for _ in range(BATCH)] for _ in range(2)]
    score_thr = 0.0
    kept = []
    pool = pipe.detector.pool_rois

    def keep_pool(pyramid, rois):
        kept.append((pyramid, rois))
        return pool(pyramid, rois)

    def run_batches(p):
        states, outs = None, []
        for raws in batches:
            out, states = p.batched(clip_batch(torch, p, raws, S), states,
                                    score_thr=score_thr)
            outs.append(out)
        return outs, states

    runs = {}
    pipe.detector.pool_rois = keep_pool
    try:
        for label, p in (("unfused", pipe), ("fused", fused)):
            (outs, states), n = counted(torch, wrappers,
                                        lambda: run_batches(p))
            want = {"preprocess_frames": BATCH * len(batches),
                    "prroi_packed": len(batches),
                    "fused_bottleneck_chain":
                        4 * len(batches) if p is fused else 0}
            for k, w in want.items():
                check(n[k] == w, f"batched {label}: {k} launched {n[k]} "
                      f"times, want {w}")
            for out in outs:
                check_outputs(torch, out, T, NUM_DETS, (BATCH,))
            check(tuple(states.next_id.shape) == (BATCH,)
                  and bool((states.next_id > 1).all()),
                  f"batched {label}: states {states.next_id.tolist()}")
            log(f"batched {label}, {BATCH} videos x {len(batches)} clip "
                f"batches of {BATCH * T} frames: launches {n}, next_id "
                f"{states.next_id.tolist()}")
            runs[label] = (p, outs, states)
    finally:
        del pipe.detector.pool_rois

    for label, (p, outs, states) in runs.items():
        kw = dict(max_age=p.sort_max_age, min_hits=p.sort_min_hits,
                  assignment=p.sort_assignment)
        for b in range(BATCH):
            state = p.init_tracker_state()
            for out in outs:
                valid = out["scores"][b] > score_thr
                state, (ids, rep) = sort_scan.sort_scan(
                    state, out["visible_boxes"][b], valid, **kw)
                check(torch.equal(ids, out["track_ids"][b])
                      and torch.equal(valid & rep, out["valid"][b]),
                      f"batched {label}: video {b}'s ids or valid differ "
                      f"from sort_scan on its own detections")
            for f in SORT_INT_FIELDS:
                check(torch.equal(getattr(state, f), getattr(states, f)[b]),
                      f"batched {label}: video {b}'s state {f} differs")
        log(f"batched {label}: SORT on its own detections equals {BATCH} "
            f"sort_scan(impl='auto') runs, every integer")

    _, outs, _ = runs["unfused"]
    worst = {"boxes": 0.0, "visible_boxes": 0.0, "scores": 0.0}
    differ = {"classes": 0, "track_ids": 0, "valid": 0}
    for b in range(BATCH):
        state = pipe.init_tracker_state()
        for raws, out in zip(batches, outs):
            clip, _ = pipe.preprocess(torch.from_numpy(raws[b]).to(dev),
                                      out_size=S)
            solo, state = pipe.streaming(clip, state, score_thr=score_thr)
            for k in worst:
                worst[k] = max(worst[k], float(
                    (solo[k] - out[k][b]).abs().max()))
            for k in differ:
                differ[k] += int((solo[k] != out[k][b]).sum())
    log(f"batched vs {BATCH} streaming calls, unfused (the detector at "
        f"{BATCH * T} frames against {T}): max|d| boxes "
        f"{worst['boxes']:.3e} px, visible boxes "
        f"{worst['visible_boxes']:.3e} px, scores {worst['scores']:.3e}; "
        f"of {BATCH * len(batches) * T * NUM_DETS} detections "
        f"{differ['classes']} classes, {differ['track_ids']} track ids and "
        f"{differ['valid']} valid flags differ")

    check_batched_kernels(torch, dev, *kept[0])
    del kept

    def batch_ms(reps=2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            out, _ = pipe.batched(clip_batch(torch, pipe, batches[i % 2], S),
                                  score_thr=score_thr)
            host = {k: v.cpu() for k, v in out.items()}
        torch.cuda.synchronize()
        check(bool(torch.isfinite(host["boxes"]).all()), "timed batch: NaN")
        return (time.perf_counter() - t0) * 1e3 / reps

    def streaming_ms(reps=2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            for raw in batches[i % 2]:
                clip, _ = pipe.preprocess(torch.from_numpy(raw).to(dev),
                                          out_size=S)
                out, _ = pipe.streaming(clip, pipe.init_tracker_state(),
                                        score_thr=score_thr)
                host = {k: v.cpu() for k, v in out.items()}
        torch.cuda.synchronize()
        check(bool(torch.isfinite(host["boxes"]).all()), "timed clip: NaN")
        return (time.perf_counter() - t0) * 1e3 / reps

    flat = clip_batch(torch, pipe, batches[0], S).reshape(
        BATCH * T, S, S, 3)

    def detector_ms(chunks, reps=3):
        with torch.no_grad():
            pipe.detector(chunks[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                for c in chunks:
                    pipe.detector(c)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    times = {"batched": [], "streaming": [], "detector at once": [],
             "detector per clip": []}
    for label in ("batched", "streaming", "streaming", "batched"):
        times[label].append((batch_ms if label == "batched"
                             else streaming_ms)())
        at_once = label == "batched"
        times["detector " + ("at once" if at_once else "per clip")].append(
            detector_ms([flat] if at_once else list(flat.split(T))))
    frames = BATCH * T
    for label, ts in times.items():
        mean = sum(ts) / len(ts)
        if label in ("batched", "streaming"):
            what = (f"{BATCH} videos' clips, uint8 host frames -> host "
                    f"outputs, unfused, 2 x 2 runs")
        else:
            calls = ("one call" if label.endswith("once")
                     else f"{BATCH} calls of {T}")
            what = (f"ClipDetector alone on {frames} preprocessed frames, "
                    f"{calls}, synchronized, 2 x 3 runs")
        log(f"{label} ({what} in turns: {ts[0]:.2f}, {ts[1]:.2f} ms): "
            f"{mean:.2f} ms = {mean / frames:.3f} ms/frame = "
            f"{frames * 1e3 / mean:.1f} frames/s at {S}^2, T={T}, f32")


def count_syncs(torch, fn):
    """``(fn(), host syncs during it)``: the synchronizing CUDA calls
    that ``torch.cuda.set_sync_debug_mode("warn")`` reports."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


# SORT's two auctions (trackers/sort.py::sort_step at the gate 0.3).
AUCTION_SETTINGS = {"gated_auction": dict(eps=1e-3, floor=0.8 * 0.3),
                    "auction": dict(eps=5e-5, floor=-1e-3)}
# The first auction kernel's latency bound, kept for continuity: its
# block-wide barriers, four before the rounds and two a round.
AUCTION_SETUP_BARRIERS, AUCTION_ROUND_BARRIERS = 4, 2
# Benefits the auction kernel reads where they lie (past a block's shared
# memory): SORT's [D, 2D] at these detection counts.
AUCTION_WIDE_D = (192, 256)
# Eviction chains (torch_port_fixtures.auction_chain): one round of
# every row, then single-row rounds, in shared memory and past it.
AUCTION_CHAINS = (48, 300)


def auction_step_ns(torch, dev, steps=1 << 16):
    """ns per step of one warp's dependent chains, from
    ``csrc/auction.cu``'s probe: a shared-memory load ("lds"), a
    shuffle ("shfl"), an f32 subtract-and-max ("alu"), a warp reduction
    ("redux"); and SM cycles a step of each (clock64, beside the global
    timer)."""
    from tao_amodal_torch import _build

    buf = torch.zeros(12, dtype=torch.int64, device=dev)
    for _ in range(2):  # the first launch warms the probe up
        _build.check("tao_auction_step_probe",
                     _build.library().tao_auction_step_probe(
                         buf.data_ptr(), steps,
                         torch.cuda.current_stream(dev).cuda_stream))
    torch.cuda.synchronize()
    v = buf.tolist()
    names = ("lds", "shfl", "alu", "redux")
    return ({k: v[3 * i + 1] / steps for i, k in enumerate(names)},
            {k: v[3 * i] / steps for i, k in enumerate(names)})


def auction_round_ns(m, step_ns):
    """The dependent chain one auction round must pay whatever kernel
    runs it, in ns: b and the prices in (a shared load), a lane's
    ceil(m / 32) value-and-compare steps, five butterfly levels (a
    shuffle and a merge step each), the bid (two steps), and the winning
    column's price update (a shared load and an add)."""
    return (2 * step_ns["lds"] + 5 * step_ns["shfl"]
            + (-(-m // 32) + 5 + 2 + 1) * step_ns["alu"])


def active_histogram(per_round):
    """``{active rows: rounds}`` over every frame's rounds, 1-4 apart and
    the rest binned as 5-8, 9-32 and >32."""
    bins = {"1": 0, "2": 0, "3": 0, "4": 0, "5-8": 0, "9-32": 0, ">32": 0}
    for a in per_round:
        key = (str(a) if a <= 4 else "5-8" if a <= 8 else "9-32" if a <= 32
               else ">32")
        bins[key] += 1
    return bins


def phase_auction(torch, dev, pipe, dets):
    """SORT with each assignment over the unfused run's detections
    (``dets``: its two clips, all 64 valid a frame), through
    ``sort_scan(impl="auto")`` on the card (an auction is one launch of
    ``tao_auction_rounds`` a frame) and on the CPU: every integer equal,
    no host sync on the card.  The auction kernel against its plain
    version (``auction_assign_torch`` on the card) on every frame's own
    benefit, bit for bit in ``row_to_col`` and in the rounds (which
    also equal the numpy count); its device ms a frame and a clip
    (``torch.profiler``), its rounds a frame, the histogram of active
    rows a round (the numpy count), and its latency bound: rounds x one
    round's dependent chain (:func:`auction_round_ns`, per-step
    latencies from :func:`auction_step_ns`), beside the first kernel's
    (rounds x its barriers x one phase's latency).  Then the kernel, bit
    for bit against its plain version and the numpy rounds, on SORT-like
    frames past a block's shared memory (``AUCTION_WIDE_D``, read where
    they lie) and on eviction chains whose rounds after the first have
    one active row (``AUCTION_CHAINS``, warp 0 alone), each cut by
    ``max_iters`` inside the chain too; their device ms and bounds.
    SORT's ms a clip through the kernel and through the plain eager
    rounds, in turns.  Returns the kernels-line row of
    ``auction_assign`` (the ``"auction"`` setting's frame with the most
    rounds)."""
    from tao_amodal_torch import _build
    from tao_amodal_torch.ops import hungarian, sort_scan
    from tao_amodal_torch.trackers import sort
    from tao_amodal_torch.trackers.sort import init_sort
    from torch_port_fixtures import (
        auction_chain,
        auction_fixpoint,
        sort_benefits,
        sort_rounds,
    )

    kw = dict(max_age=pipe.sort_max_age, min_hits=pipe.sort_min_hits)
    cpu_dets = [(b.cpu(), v.cpu()) for b, v in dets]
    frames = sum(int(b.shape[0]) for b, _ in dets)

    def run(assignment, clips, device):
        """(final state, [(ids, report)], host ms of each clip)."""
        state, outs, ms = init_sort(SORT_K, device=device), [], []
        for boxes, valid in clips:
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = sort_scan.sort_scan(state, boxes, valid,
                                             assignment=assignment, **kw)
            if device != "cpu":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        return state, outs, ms

    phase_ns, _ = phase_latency(torch, dev)
    step_ns, step_cycles = auction_step_ns(torch, dev)
    log("auction step probe (one warp's dependent chains, csrc/auction.cu):"
        " ns a step " + ", ".join(f"{k} {v:.2f}" for k, v in step_ns.items())
        + "; SM cycles a step " + ", ".join(
            f"{k} {v:.1f}" for k, v in step_cycles.items()))
    rounds = {"greedy": [g for g, _ in sort_rounds(
        init_sort(SORT_K, device="cpu"), cpu_dets, **kw)]}
    row_out = None
    for assignment in ("greedy", "gated_auction", "auction"):
        seen, real = [], sort.auction_assign

        def record(benefit, *args, **kwargs):
            seen.append(benefit.clone())
            return real(benefit, *args, **kwargs)

        sort.auction_assign = record
        t0 = time.perf_counter()
        try:
            (card_s, card_outs, _), syncs = count_syncs(
                torch, lambda: run(assignment, dets, dev))
        finally:
            sort.auction_assign = real
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_s, cpu_outs, cpu_ms = run(assignment, cpu_dets, "cpu")
        t_cpu = time.perf_counter() - t0
        for (g_ids, g_rep), (w_ids, w_rep) in zip(card_outs, cpu_outs):
            check(torch.equal(g_ids.cpu(), w_ids)
                  and torch.equal(g_rep.cpu(), w_rep),
                  f"{assignment}: ids or report differ between card and CPU")
        for f in SORT_INT_FIELDS:
            check(torch.equal(getattr(card_s, f).cpu(), getattr(cpu_s, f)),
                  f"{assignment}: state {f} differs between card and CPU")
        check(torch.allclose(card_s.x.cpu(), cpu_s.x, rtol=SORT_RTOL,
                             atol=SORT_ATOL),
              f"{assignment}: Kalman state differs between card and CPU")
        # Greedy runs first and meets the lazily built constants (the
        # Kalman matrices' one copy from the host); the auctions after it
        # must make no host sync.
        check(assignment == "greedy" or syncs == 0,
              f"{assignment}: {syncs} host syncs on the card")
        if assignment != "greedy":
            setting = AUCTION_SETTINGS[assignment]
            check(len(seen) == frames, f"{assignment}: {len(seen)} "
                  f"auctions for {frames} frames")
            got_r = torch.zeros(1, dtype=torch.int32, device=dev)
            want_r = torch.zeros(1, dtype=torch.int32, device=dev)
            own, active, per_round = [], [], []
            for b in seen:
                got = hungarian.auction_assign(b, **setting, rounds=got_r)
                want = hungarian.auction_assign_torch(b, **setting,
                                                      rounds=want_r)
                stats = {}
                host = auction_fixpoint(b.cpu().numpy(), **setting,
                                        stats=stats)
                check(torch.equal(got, want) and int(got_r) == int(want_r)
                      == host[1] and np.array_equal(got.cpu().numpy(),
                                                    host[0]),
                      f"{assignment}: the kernel differs from its plain "
                      f"version on a frame's benefit: rounds "
                      f"{int(got_r)} / {int(want_r)} / {host[1]}")
                own.append(int(got_r))
                active.append(stats.get("active", 0))
                per_round += stats.get("per_round", [])
            rounds[assignment] = own
            k = int(np.argmax(own))
            b = seen[k]
            n, m = b.shape

            def kernel(b=b):
                return hungarian.auction_assign(b, **setting)

            r = row(0.0, cuda_ms(torch, kernel, 50),
                    cuda_ms(torch, lambda: hungarian.auction_assign_torch(
                        b, **setting), 3),
                    bound(nbytes(b) + 8 * n, 3 * m * active[k], "f32"),
                    dev_ms=device_ms(torch, kernel, "auction_rounds_kernel",
                                     20))
            lat = (AUCTION_SETUP_BARRIERS + AUCTION_ROUND_BARRIERS
                   * own[k]) * phase_ns / 1e6
            chain = own[k] * auction_round_ns(m, step_ns) / 1e6
            clip_dev = []
            for c in range(len(dets)):
                frame_bs = seen[T * c:T * (c + 1)]

                def clip(frame_bs=frame_bs):
                    for f in frame_bs:
                        hungarian.auction_assign(f, **setting)

                clip_dev.append(device_ms(torch, clip,
                                          "auction_rounds_kernel", 10,
                                          per_call=True))
            log(f"{assignment}: tao_auction_rounds equals its plain version "
                f"bit for bit (row_to_col and rounds; rounds equal the numpy "
                f"count) on the {len(seen)} frames' own [{n}, {m}] "
                f"benefits; rounds a frame (the kernel's) {own}; the frame "
                f"with the most ({own[k]} rounds, {active[k]} active rows "
                f"summed): {roofline_note(r)}; latency bound {own[k]} "
                f"rounds x {auction_round_ns(m, step_ns):.1f} ns (one "
                f"round's chain at m = {m}) = {chain:.4f} ms"
                + ("" if r["device_ms"] is None else
                   f", {100 * chain / r['device_ms']:.1f} % of it reached")
                + f"; the first kernel's latency bound "
                f"({AUCTION_SETUP_BARRIERS} + "
                f"{AUCTION_ROUND_BARRIERS} x {own[k]} barriers) x "
                f"{phase_ns:.1f} ns = {lat:.4f} ms; active rows a round "
                f"over the {len(seen)} frames (rounds): "
                f"{active_histogram(per_round)}; device ms a clip ({T} "
                f"launches): "
                + ", ".join("not measured" if d is None else f"{d:.4f}"
                            for d in clip_dev))
            if assignment == "auction":
                row_out = r
        r = np.asarray(rounds[assignment])
        log(f"{assignment} over the unfused run's {len(dets)} clips "
            f"({frames} frames, all {NUM_DETS} detections valid): card "
            f"equals CPU in every integer, next_id {int(card_s.next_id)}; "
            f"rounds a frame min {r.min()}, median {np.median(r):g}, max "
            f"{r.max()}, total {r.sum()}; host syncs {syncs} "
            f"(torch.cuda.set_sync_debug_mode); ms a clip on the CPU "
            f"{', '.join(f'{m:.2f}' for m in cpu_ms)}; phase seconds: card "
            f"{t_card:.1f}, CPU {t_cpu:.1f}")

    # Past shared memory and single-row chains, against the plain
    # version and the numpy rounds.
    lib = _build.library()
    for assignment, setting in AUCTION_SETTINGS.items():
        scenes = [(f"SORT-like [{D}, {2 * D}]", b) for D in AUCTION_WIDE_D
                  for b in sort_benefits(D, n=D, m=2 * D, frames=2)]
        scenes += [(f"eviction chain [{n}, {n}]", auction_chain(n))
                   for n in AUCTION_CHAINS]
        notes = []
        for what, b_np in scenes:
            n, m = b_np.shape
            b = torch.from_numpy(b_np).to(dev)
            stats = {}
            host, rounds = auction_fixpoint(b_np, **setting, stats=stats)
            per = stats.get("per_round", [])
            first = per.index(1) if 1 in per else rounds
            for cap in sorted({200_000, first + 1,
                               first + (rounds - first) // 2}):
                got_r = torch.zeros(1, dtype=torch.int32, device=dev)
                want_r = torch.zeros(1, dtype=torch.int32, device=dev)
                got = hungarian.auction_assign(b, **setting, max_iters=cap,
                                               rounds=got_r)
                want = hungarian.auction_assign_torch(
                    b, **setting, max_iters=cap, rounds=want_r)
                check(torch.equal(got, want)
                      and int(got_r) == int(want_r) == min(cap, rounds),
                      f"{assignment}: the kernel differs from its plain "
                      f"version on the {what} benefit at max_iters {cap}: "
                      f"rounds {int(got_r)} / {int(want_r)} / {rounds}")
            check(np.array_equal(got.cpu().numpy(), host),
                  f"{assignment}: the kernel differs from the numpy "
                  f"rounds on the {what} benefit")
            form = ("in shared memory" if lib.tao_auction_rounds_smem(
                n, m, 1) >= 0 else "read where it lies")
            dev_ms = device_ms(torch, lambda: hungarian.auction_assign(
                b, **setting), "auction_rounds_kernel", 20)
            chain = rounds * auction_round_ns(m, step_ns) / 1e6
            notes.append(
                f"{what} ({form}, {rounds} rounds, {rounds - first} of "
                f"them single-row): " + (
                    "device ms not measured" if dev_ms is None
                    else f"device {dev_ms:.4f} ms")
                + f", latency bound {chain:.4f} ms")
        log(f"{assignment}: tao_auction_rounds equals its plain version "
            f"bit for bit (row_to_col and rounds, run out and cut by "
            f"max_iters at the first single-row round and inside the "
            f"chain) and the numpy rounds on: " + "; ".join(notes))

    # SORT's ms a clip through the kernel and through the plain rounds
    # (the eager path before the kernel: a host check every
    # AUCTION_BLOCK rounds), in turns.
    times = {}
    for assignment, path in (
            ("greedy", "kernel"), ("gated_auction", "kernel"),
            ("auction", "kernel"), ("gated_auction", "plain"),
            ("auction", "plain"), ("auction", "plain"),
            ("gated_auction", "plain"), ("auction", "kernel"),
            ("gated_auction", "kernel"), ("greedy", "kernel")):
        if path == "plain":
            sort.auction_assign = hungarian.auction_assign_torch
        try:
            ms = run(assignment, dets, dev)[2]
        finally:
            sort.auction_assign = hungarian.auction_assign
        times.setdefault((assignment, path), []).extend(ms)
    for (assignment, path), ms in times.items():
        log(f"{assignment} on the card through the {path} rounds, SORT's ms "
            f"a clip (host clock, synchronized, 2 x {len(dets)} clips in "
            f"turns): {', '.join(f'{m:.2f}' for m in ms)}, mean "
            f"{np.mean(ms):.2f}")
    return row_out


def phase_stage_stacks(torch, dev, wrappers):
    """The identity stacks of the four stages of a seeded full-width
    ResNet-50 (BN perturbed so that the fold is not an identity), each
    fed with the trunk's own block-0 output of one preprocessed 512^2
    clip: B8 on it in bf16, B7 on it quantized at the scales calibrated
    from the f32 run.  Then each against its plain version, and the
    cosine of each against the f32 stage output.  Returns the launches
    of B7 and B8."""
    from tao_amodal_torch.models.backbones import ResNet
    from tao_amodal_torch.ops import preproc
    from tao_amodal_torch.ops import resnet_blocks as rb
    from tao_amodal_torch.utils import weights
    from torch_port_fixtures import perturb_module, stage_stacks

    net = ResNet().to(dev).eval()
    weights.random_init_(net, torch.Generator(device=dev).manual_seed(7))
    perturb_module(net, np.random.RandomState(8))
    frames = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, (T, H, W, 3), dtype=np.uint8)).to(dev)
    clip, _ = preproc.preprocess_clip(frames, out_size=S)
    stages = stage_stacks(net, clip.permute(0, 3, 1, 2))

    def on_card(params):
        return type(params)(*(t.to(dev) for t in params))

    work = []
    for st in stages:
        sc = st["act_scales"]
        xq = torch.round(st["x"] / sc[0]["in"]).clamp(0, 127).to(torch.int8)
        qp = rb.quantize_bottleneck_params(st["block_vars"], sc, sc[0]["in"],
                                           sc[-1]["out"])
        bp = rb.bf16_params_from_bottlenecks(st["block_vars"])
        work.append((st, xq, on_card(qp), st["x"].to(torch.bfloat16),
                     on_card(bp)))

    def run():
        return [(rb.identity_blocks_pallas(xq, qp),
                 rb.identity_blocks_bf16_pallas(xb, bp))
                for _, xq, qp, xb, bp in work]

    outs, n = counted(torch, wrappers, run)
    for k in ("identity_blocks_pallas", "identity_blocks_bf16_pallas"):
        check(n[k] == len(stages), f"stage stacks: {k} launched {n[k]} "
              f"times, want {len(stages)}")
    for (st, xq, qp, xb, bp), (q, b) in zip(work, outs):
        check(torch.equal(q, rb.identity_blocks_reference(xq, qp)),
              f"stage {st['stage']} int8 stack differs from the plain "
              f"version")
        _, note = bf16_agreement(
            torch, b, rb.identity_blocks_bf16_reference(xb, bp), xb, bp,
            f"stage {st['stage']} bf16 stack")
        ref = st["ref"]
        cos = {}
        for name, got in (("int8", q.float() * st["act_scales"][-1]["out"]),
                          ("bf16", b.float())):
            cos[name] = float((got * ref).sum()
                              / (got.norm() * ref.norm() + 1e-9))
            check(math.isfinite(cos[name]), f"stage stack {name}: NaN")
        log(f"stage {st['stage']} stacks on the trunk's block-0 output "
            f"{list(st['x'].shape)} x{len(st['block_vars'])}: int8 equal to "
            f"plain; bf16 {note}; cosine to the f32 stage int8 "
            f"{cos['int8']:.5f}, bf16 {cos['bf16']:.5f}")
    return {k: n[k] for k in ("identity_blocks_pallas",
                              "identity_blocks_bf16_pallas")}


# ---------------------------------------------------------------------
# The JAX bench's serving configuration (bench.py:91-118): bf16, the
# s2d_pre stem, 480x640 frames letterboxed to 384x512.
# ---------------------------------------------------------------------


def check_prroi_bf16(torch, dev):
    """The bf16 forms of B2, B5 and B6 at the 384x512 serving shapes: a
    random bf16 P3..P6 pyramid (48x64 .. 6x8, C=256) and 96 RoIs a frame;
    B2 on its 48x98 canvas, B5 on the canvas padded to 112 columns, B6 on
    each level (times summed over the four).  Each against its plain
    version by B8's rule; the bound counts the supports at 2 bytes a
    channel."""
    from tao_amodal_torch.ops import prroi, roi

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(21)
    pyramid = [torch.randn((T, h, w, 256), generator=g, device=dev).to(bf16)
               for h, w in BF16_LEVELS]
    rois = serving_rois(torch, dev, 22, BF16_OUT)
    rows = {}
    for name, fn, ref, width in (
            ("prroi_packed_bf16", prroi.prroi_packed,
             prroi.prroi_packed_torch, 1),
            ("prroi_packed_pallas_bf16", prroi.prroi_packed_pallas,
             prroi.prroi_packed_pallas_torch, 16)):
        canvas, rois_p = roi.pack_levels(pyramid, rois, canonical_level=1,
                                         strides=LEVEL_STRIDES,
                                         width_multiple=width)
        got, want = fn(canvas, rois_p), ref(canvas, rois_p)
        check(got.dtype == bf16 and got.shape == (T, 96, 7, 7, 256),
              f"{name}: {got.dtype} {tuple(got.shape)}")
        err, note = bf16_close(torch, got, want, name)
        rows[name] = row(
            err, cuda_ms(torch, lambda: fn(canvas, rois_p), 50),
            cuda_ms(torch, lambda: ref(canvas, rois_p), 20),
            bound(*prroi_bound(rois_p, got, *canvas.shape[1:3], esize=2),
                  "f32"),
            dev_ms=device_ms(torch, lambda: fn(canvas, rois_p),
                             "prroi_bf16_kernel", 50))
        log(f"{name} canvas {list(canvas.shape)} bf16, rois "
            f"{list(rois_p.shape)}: {note}; {roofline_note(rows[name])}")
    err = ms = plain_ms = work_bytes = work_ops = dev_ms = 0.0
    for level, stride in zip(pyramid, LEVEL_STRIDES):
        args = (level, rois, 7, 1.0 / stride)
        got = prroi.prroi_pool_pallas(*args)
        want = prroi.prroi_pool_pallas_torch(*args)
        check(got.dtype == torch.float32, f"B6 bf16 returns {got.dtype}")
        e, note = bf16_close(torch, got, want, "prroi_pool_pallas_bf16")
        d_ms = device_ms(torch, lambda: prroi.prroi_pool_pallas(*args),
                         "prroi_bf16_kernel", 20)
        dev_ms = None if d_ms is None or dev_ms is None else dev_ms + d_ms
        b, o = prroi_bound(rois * (1.0 / stride), got, *level.shape[1:3],
                           esize=2)
        err = max(err, e)
        ms += cuda_ms(torch, lambda: prroi.prroi_pool_pallas(*args), 20)
        plain_ms += cuda_ms(torch, lambda: prroi.prroi_pool_pallas_torch(
            *args), 10)
        work_bytes, work_ops = work_bytes + b, work_ops + o
        log(f"B6 bf16 level {list(level.shape)} scale 1/{stride}: {note}")
    rows["prroi_pool_pallas_bf16"] = row(
        err, ms, plain_ms, bound(work_bytes, work_ops, "f32"), dev_ms=dev_ms)
    log(f"B6 bf16, four levels: "
        f"{roofline_note(rows['prroi_pool_pallas_bf16'])}")
    # Edge RoIs (outside the map, of zero size, crossing its edges,
    # spanning every column and more) on each form's map: B2's 98-column
    # canvas, B5's padded to 112, B6's P3.
    from torch_port_fixtures import prroi_edge_rois

    for name, fn, ref, feats in (
            ("prroi_packed_bf16", prroi.prroi_packed,
             prroi.prroi_packed_torch, roi.pack_levels(
                 pyramid, rois, canonical_level=1,
                 strides=LEVEL_STRIDES)[0]),
            ("prroi_packed_pallas_bf16", prroi.prroi_packed_pallas,
             prroi.prroi_packed_pallas_torch, roi.pack_levels(
                 pyramid, rois, canonical_level=1, strides=LEVEL_STRIDES,
                 width_multiple=16)[0]),
            ("prroi_pool_pallas_bf16", prroi.prroi_pool_pallas,
             prroi.prroi_pool_pallas_torch, pyramid[0])):
        edge = torch.tensor([prroi_edge_rois(*feats.shape[1:3])] * T,
                            device=dev)
        edge[1::2] += 0.37
        _, note = bf16_close(torch, fn(feats, edge), ref(feats, edge),
                             f"{name} on edge RoIs")
        log(f"{name} on {edge.shape[1]} edge RoIs a frame, map "
            f"{list(feats.shape)}: {note}")
    return rows


def chain_bf16_cudnn(torch, params):
    """B4's bf16 function through cuDNN, the yardstick of its
    ``library_ms``: each conv one bf16 ``F.conv2d`` (channels last) on
    the folded weights rounded once, the f32 bias, residual and ReLU in
    eager torch, ``a``, ``h`` and the block output rounded to bf16 as B4
    rounds them (cuDNN rounds each conv's sums to bf16 first: one
    rounding more than B4).  Returns the chain as a function of ``x [T,
    H, W, C]`` bf16."""
    F, bf16, cl = torch.nn.functional, torch.bfloat16, torch.channels_last
    blocks = [{k: (v.to(bf16).contiguous(memory_format=cl) if v.dim() == 4
                   else v[:, None, None]) for k, v in p.items()}
              for p in params]

    def run(x):
        cur = x.permute(0, 3, 1, 2)
        for p in blocks:
            a = (F.conv2d(cur, p["wa"]).float() + p["ba"]).clamp_min(
                0.0).to(bf16)
            h = (F.conv2d(a, p["w3"], padding=1).float()
                 + p["b3"]).clamp_min(0.0).to(bf16)
            res = (F.conv2d(cur, p["wd"]).float() + p["bd"] if "wd" in p
                   else cur.float())
            cur = (F.conv2d(h, p["wb"]).float() + p["bb"] + res).clamp_min(
                0.0).to(bf16)
        return cur.permute(0, 2, 3, 1)

    return run


def chain_bytes_as_built(shape, M, blocks, projection):
    """The bytes B4's bf16 form moves through device memory as built, each
    conv's operands read once and its output written once: per block the
    input (read by the 1x1a, and again as the residual or by the
    projection), a and h (bf16, written and read), the f32 projection
    (written and read), the output, and the bf16 weights and f32
    biases."""
    P, cin, n = shape[0] * shape[1] * shape[2], shape[-1], 0
    for b in range(blocks):
        proj = b == 0 and projection
        n += 2 * P * cin * 2 + 2 * 2 * P * M * 2 + P * 4 * M * 2
        n += 2 * P * 4 * M * 4 if proj else 0
        n += 2 * (cin * M + 9 * M * M + M * 4 * M + (cin * 4 * M if proj
                                                      else 0))
        n += 4 * (2 * M + 4 * M * (2 if proj else 1))
        cin = 4 * M
    return n


def wgmma_breakdown(torch, fn, launches, attempts=3):
    """Device time of one call ``fn()`` by wgmma conv instance (bf16 or
    int8, tile width, filter size, epilogue) from ``torch.profiler``:
    ``{label: [ms, launches]}``.  The trace opens with a few small kernels
    of its own (a trace can lose its first launches); one that lost
    kernels of ``fn`` all the same (fewer than ``launches``) is taken
    again, and after ``attempts`` such traces this returns None."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    warm = torch.zeros(1, device="cuda")
    for _ in range(attempts):
        rows = {}
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(4):
                warm.add_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            m = re.search(r"conv_wgmma_kernel<(\w+), (\d+), (\d), (\d)>",
                          e.key)
            if m is None or e.device_time_total <= 0:
                continue
            label = (f"{'int8' if m.group(1) == 'true' else 'bf16'} bn"
                     f"{m.group(2)} k{m.group(3)} epi{m.group(4)}")
            r = rows.setdefault(label, [0.0, 0])
            r[0] += e.device_time_total / 1e3
            r[1] += e.count
        if sum(n for _, n in rows.values()) == launches:
            return rows
    return None


def check_fused_chain_bf16(torch, dev):
    """B4's bf16 form at the four stage shapes of the 384x512 trunk, T=8,
    against its plain version on the card (TF32 off) within B8's rule or
    twice the plain version's own spread on the CPU; times summed over
    the stages beside cuDNN bf16 (:func:`chain_bf16_cudnn`), the chains'
    FLOPs over the bf16 tensor-core peak and the bytes of the design as
    built (:func:`chain_bytes_as_built`) over the HBM rate, with each
    stage's time by conv instance."""
    from tao_amodal_torch.ops import conv_sm90, fused_stage
    from torch_port_fixtures import chain_inputs

    fn = fused_stage.fused_bottleneck_chain
    plain = fused_stage.bottleneck_chain_torch
    err = ms = plain_ms = lib_ms = work_bytes = work_ops = dev_ms = 0.0
    built = 0
    log(f"B4 bf16 form: wgmma conv, rounding groups of "
        f"{16 * conv_sm90.BF16_KGROUP} of k")
    for i, (shape, M, blocks, projection) in enumerate(BF16_STAGES):
        x, params = chain_inputs(dev, shape, M, blocks, projection,
                                 seed=30 + i)
        x = x.to(torch.bfloat16)
        with torch.no_grad():
            got, want = fn(x, params), plain(x, params)
            other = plain(x.cpu(), [{k: v.cpu() for k, v in p.items()}
                                    for p in params])
            lib = chain_bf16_cudnn(torch, params)
            k_ms = cuda_ms(torch, lambda: fn(x, params), 5)
            p_ms = cuda_ms(torch, lambda: plain(x, params), 3)
            l_ms = cuda_ms(torch, lambda: lib(x), 5)
            d_ms = device_ms(torch, lambda: fn(x, params),
                             "conv_wgmma_kernel", 5, per_call=True)
            by_conv = wgmma_breakdown(torch, lambda: fn(x, params),
                                      3 * blocks + projection)
        check(got.dtype == torch.bfloat16 and got.shape == want.shape,
              f"B4 bf16 stage {i + 1}: {got.dtype} {tuple(got.shape)}")
        e, note = bf16_close(torch, got, want, f"B4 bf16 stage {i + 1}",
                             other)
        flop = chain_flop(shape, M, blocks, projection)
        n_bytes = nbytes(x, got) + sum(t.numel() * 2 if t.dim() == 4
                                       else t.numel() * 4
                                       for p in params for t in p.values())
        stage = row(e, k_ms, p_ms, bound(n_bytes, flop, "bf16"), l_ms,
                    d_ms)
        b_built = chain_bytes_as_built(shape, M, blocks, projection)
        built += b_built
        log(f"B4 bf16 stage {i + 1} {list(shape)} M={M} x{blocks}"
            f"{' +proj' if projection else ''}: {note}; "
            f"{flop / 1e9:.1f} GFLOP, {roofline_note(stage)}; kernel "
            f"{flop / 1e9 / k_ms:.2f} TFLOP/s, cuDNN bf16 "
            f"{flop / 1e9 / l_ms:.2f} TFLOP/s; bytes as built "
            f"{b_built / 1e9:.3f} GB ({b_built / HBM_RATE * 1e3:.4f} ms); by "
            f"conv: " + ("not measured (the profiler lost kernels)"
                         if by_conv is None else
                         "; ".join(f"{k} {v[0]:.4f} ms x{v[1]}"
                                   for k, v in sorted(by_conv.items()))))
        err, ms, plain_ms, lib_ms = (max(err, e), ms + k_ms,
                                     plain_ms + p_ms, lib_ms + l_ms)
        dev_ms = None if d_ms is None or dev_ms is None else dev_ms + d_ms
        work_bytes, work_ops = work_bytes + n_bytes, work_ops + flop
        del x, params, got, want, other
    r = row(err, ms, plain_ms, bound(work_bytes, work_ops, "bf16"), lib_ms,
            dev_ms)
    log(f"B4 bf16, four stages at 384x512, T={T}: {roofline_note(r)}; "
        f"{work_ops / 1e9 / ms:.2f} TFLOP/s; bounds: operations "
        f"{work_ops / PEAK['bf16'] * 1e3:.4f} ms ({work_ops / 1e9:.1f} "
        f"GFLOP), bytes of the function {work_bytes / HBM_RATE * 1e3:.4f} "
        f"ms, bytes as built {built / 1e9:.3f} GB = "
        f"{built / HBM_RATE * 1e3:.4f} ms")
    return r


def idle_share(torch, fn, events=False):
    """(wall ms, device busy ms) of one synchronized ``fn()`` under
    ``torch.profiler``, after one unprofiled call (:func:`profile_run`).
    None for busy where the trace holds no device event.  With
    ``events``, also the number of device events (kernels, copies and
    fills) in the trace."""
    fn()
    _, wall, busy, n_events, _, _, _, _ = profile_run(torch, fn)
    return (wall, busy, n_events) if events else (wall, busy)


def phase_bf16_serving(torch, dev, wrappers):
    """The JAX bench's serving configuration at full width: ResNet-50 +
    FPN-256, bf16, the s2d_pre stem, 480x640 uint8 frames letterboxed to
    384x512, T=8, 64 detections, 96 proposals, pre-NMS top-k 100, greedy
    SORT, seeded random weights: two clips with the SORT state threaded,
    unfused, with ``fused_stages=(1, 2, 3, 4)`` and with
    ``pallas_pooling=True`` (B5), then B6's route on that run's pyramids
    against the same route on the CPU.  Returns (the bf16 kernels' rows,
    their launches on these paths)."""
    from tao_amodal_torch.ops.roi import multilevel_roi_align
    from tao_amodal_torch.pipeline import AmodalPipeline

    rows = check_prroi_bf16(torch, dev)
    rows["fused_bottleneck_chain_bf16"] = check_fused_chain_bf16(torch, dev)
    kw = dict(dtype=torch.bfloat16, stem="s2d_pre", device=dev)
    pipe = AmodalPipeline.create(**kw).init(
        torch.Generator(device=dev).manual_seed(40))
    fused = AmodalPipeline.create(**kw, fused_stages=FUSED)
    fused.load_state_dict(pipe.state_dict())
    pallas = AmodalPipeline.create(**kw, pallas_pooling=True)
    pallas.load_state_dict(pipe.state_dict())
    kept = []
    pool_b5 = pallas.detector.pool_rois

    def keep_pool(pyramid, rois):
        kept.append((pyramid, rois))
        return pool_b5(pyramid, rois)

    pallas.detector.pool_rois = keep_pool
    rs = np.random.RandomState(41)
    clips = [rs.randint(0, 256, (T, H, W, 3), dtype=np.uint8)
             for _ in range(2)]

    def run_clip(p, raw, state):
        clip, _ = p.preprocess(torch.from_numpy(raw).to(dev),
                               out_size=BF16_OUT)
        check(clip.dtype == torch.bfloat16
              and clip.shape == (T, BF16_OUT[0] // 4, BF16_OUT[1] // 4, 48),
              f"bf16 preprocess: {clip.dtype} {tuple(clip.shape)}")
        return p.streaming(clip, state, score_thr=0.0)

    def run_path(p):
        state, outs = p.init_tracker_state(), []
        for raw in clips:
            out, state = run_clip(p, raw, state)
            outs.append(out)
        return outs, state

    launches = {}
    n_clips = len(clips)
    fix = fixpoint_launches(n_clips)
    for label, p, want in (
            ("bf16 unfused", pipe, dict(prroi_packed_bf16=n_clips, **fix)),
            ("bf16 fused", fused, dict(prroi_packed_bf16=n_clips,
                                       fused_bottleneck_chain_bf16=4
                                       * n_clips, **fix)),
            ("bf16 pallas_pooling", pallas,
             dict(prroi_packed_pallas_bf16=n_clips, **fix))):
        (outs, state), n = counted(torch, wrappers, lambda: run_path(p))
        log(f"{label} main path (s2d_pre, {BF16_OUT[0]}x{BF16_OUT[1]}) over "
            f"{n_clips} clips: launches {n}, next_id {int(state.next_id)}")
        for k in wrappers:  # the f32 kernels and B1 launch no time
            check(n[k] == want.get(k, 0), f"{label} path: {k} launched "
                  f"{n[k]} times, want {want.get(k, 0)}")
        launches.update(want)
        for out in outs:
            check_outputs(torch, out, T, NUM_DETS)
            check(out["scores"].dtype == torch.bfloat16
                  and out["boxes"].dtype == torch.float32,
                  f"{label}: scores {out['scores'].dtype}, boxes "
                  f"{out['boxes'].dtype}")
        check(int(state.next_id) > 1, f"{label} path: no track was born")

    # B6 on the pallas_pooling run's bf16 pyramids and proposals, against
    # the same route through the plain versions on the CPU.
    def route(device):
        return [multilevel_roi_align(
            [f.permute(0, 2, 3, 1).to(device) for f in pyramid[:4]],
            rois.to(device), canonical_level=1, strides=LEVEL_STRIDES,
            method="prroi_pallas") for pyramid, rois in kept]

    pooled, n = counted(torch, wrappers, lambda: route(dev))
    check(n["prroi_pool_pallas_bf16"] == 4 * len(kept),
          f"B6 bf16 route launched {n['prroi_pool_pallas_bf16']} times, "
          f"want {4 * len(kept)}")
    launches["prroi_pool_pallas_bf16"] = n["prroi_pool_pallas_bf16"]
    for got, want in zip(pooled, route("cpu")):
        _, note = bf16_close(torch, got, want, "B6 bf16 route")
    log(f"B6 bf16 route on the pallas_pooling run's pyramids over "
        f"{len(kept)} clips: launches {n['prroi_pool_pallas_bf16']}, "
        f"card vs CPU {note}")
    del kept, pooled

    def clip_ms(p, reps=4):
        state = p.init_tracker_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            out, state = run_clip(p, clips[i % 2], state)
            host = {k: v.cpu() for k, v in out.items()}
        torch.cuda.synchronize()
        check(bool(torch.isfinite(host["boxes"]).all()), "timed clip: NaN")
        return (time.perf_counter() - t0) * 1e3 / reps

    times = {"unfused": [], "fused": []}
    for label, p in (("unfused", pipe), ("fused", fused), ("fused", fused),
                     ("unfused", pipe)):
        times[label].append(clip_ms(p))
    for label, p in (("unfused", pipe), ("fused", fused)):
        ts = times[label]
        mean = sum(ts) / len(ts)
        state = p.init_tracker_state()
        wall, busy = idle_share(torch, lambda: run_clip(p, clips[0], state))
        idle = ("not measured" if busy is None else
                f"{100 * (1 - busy / wall):.1f} % idle ({busy:.2f} ms busy "
                f"of {wall:.2f} ms, one profiled clip)")
        log(f"bf16 s2d_pre {label} clip wall time after warm-up (uint8 host "
            f"frames -> host outputs, 2 x 4 clips in turns {ts[0]:.2f}, "
            f"{ts[1]:.2f}): {mean:.2f} ms/clip = {T * 1e3 / mean:.1f} "
            f"frames/s at {BF16_OUT[0]}x{BF16_OUT[1]}, T={T}; device {idle}")
    return rows, launches


def det_ulp(s):
    """One bf16 ulp at each score of ``s`` (numpy)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(s), 1e-30))) - 7)


def matched_detections(a, b):
    """Detections of two outputs of one clip (host numpy dicts) matched
    per frame, greedily by IoU >= MATCH_IOU within a class: (pairs (t,
    i, j), count of ``a``'s valid detections)."""
    pairs, total = [], 0
    for t in range(a["valid"].shape[0]):
        ia, ib = np.nonzero(a["valid"][t])[0], np.nonzero(b["valid"][t])[0]
        total += len(ia)
        cand = []
        for i in ia:
            for j in ib:
                if a["classes"][t, i] != b["classes"][t, j]:
                    continue
                p, q = a["visible_boxes"][t, i], b["visible_boxes"][t, j]
                inter = (max(min(p[2], q[2]) - max(p[0], q[0]), 0)
                         * max(min(p[3], q[3]) - max(p[1], q[1]), 0))
                union = ((p[2] - p[0]) * (p[3] - p[1])
                         + (q[2] - q[0]) * (q[3] - q[1]) - inter)
                # Two equal boxes pair even where they have no area.
                cand.append((inter / union if union > 0
                             else float(np.array_equal(p, q)), i, j))
        used_i, used_j = set(), set()
        for v, i, j in sorted(cand, reverse=True):
            if v >= MATCH_IOU and i not in used_i and j not in used_j:
                used_i.add(i)
                used_j.add(j)
                pairs.append((t, i, j))
    return pairs, total


def phase_small_s2d(torch, dev, wrappers):
    """The small pipeline (the CPU tests' architecture) with the s2d
    stems, f32 and bf16, at a 4:3 frame (60x80 letterboxed to 48x64) on
    the card and on the CPU, on the same weights and coherent frames:
    ``streaming`` over two clips (state threaded), then ``batched`` over
    the two clips as two videos against two fresh CPU ``streaming`` runs.
    f32: integers equal, floats within phase 4's tolerances.  bf16:
    cuDNN and cuBLAS sum bf16 products in other orders than the CPU, so
    at random weights a few detections of near-equal score swap (the CPU
    tests count 1-4 of 128 against JAX): ``valid`` equal slot by slot, at
    least MATCHED_SHARE of the detections matched (per frame, IoU >=
    MATCH_IOU within a class), and on matched pairs scores within two
    bf16 ulps and boxes within BF16_BOX_ATOL."""
    from tao_amodal_torch.pipeline import AmodalPipeline
    from torch_port_fixtures import perturb_module

    rs = np.random.RandomState(46)
    base = rs.randint(0, 256, (1, 60, 80, 3))
    clips = [np.clip(base + rs.randint(-3, 4, (TINY_T, 60, 80, 3)), 0,
                     255).astype(np.uint8) for _ in range(2)]

    def host(out):
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu()
                .numpy() for k, v in out.items()}

    for seed, (dtype, stem) in enumerate(
            ((torch.bfloat16, "s2d_pre"), (torch.bfloat16, "s2d"),
             (torch.float32, "s2d_pre"), (torch.float32, "s2d"))):
        what = f"small {str(dtype)[6:]} {stem}"
        cpu = AmodalPipeline.create(**TINY, dtype=dtype, stem=stem,
                                    device="cpu").init(
            torch.Generator().manual_seed(44 + seed))
        perturb_module(cpu, np.random.RandomState(45 + seed))
        gpu = copy.deepcopy(cpu).to(dev)

        def prep(p, raw):
            return p.preprocess(torch.from_numpy(raw).to(p.device),
                                out_size=(48, 64))[0]

        def run():
            states = [cpu.init_tracker_state(), gpu.init_tracker_state()]
            pairs = []
            for raw in clips:  # streaming, states threaded
                outs = []
                for i, p in enumerate((cpu, gpu)):
                    out, states[i] = p.streaming(prep(p, raw), states[i],
                                                 score_thr=0.0)
                    outs.append(host(out))
                pairs.append(outs)
            both, _ = gpu.batched(torch.stack([prep(gpu, r) for r in clips]),
                                  score_thr=0.0)
            both = host(both)
            for v, raw in enumerate(clips):  # batched vs fresh streaming
                want, _ = cpu.streaming(prep(cpu, raw),
                                        cpu.init_tracker_state(),
                                        score_thr=0.0)
                pairs.append((host(want), {k: x[v] for k, x in both.items()}))
            return pairs, states

        (pairs, states), n = counted(torch, wrappers, run)
        b2 = "prroi_packed_bf16" if dtype == torch.bfloat16 else "prroi_packed"
        # s2d letterboxes through B1 (each card clip), s2d_pre folds in
        # two plain einsums.
        b1 = 2 * len(clips) if stem == "s2d" else 0
        check(n[b2] == len(clips) + 1 and n["preprocess_frames"] == b1,
              f"{what}: launches {n}")
        matched = total = 0
        worst_box = worst_score = 0.0
        for want, have in pairs:
            check(np.array_equal(want["valid"], have["valid"])
                  and all(np.isfinite(have[k]).all()
                          for k in ("boxes", "scores")),
                  f"{what}: valid differs or outputs not finite")
            if dtype == torch.float32:
                for k in ("classes", "track_ids"):
                    check(np.array_equal(want[k], have[k]),
                          f"{what}: {k} differ between card and CPU")
                worst_box = max(worst_box, float(np.abs(
                    have["visible_boxes"] - want["visible_boxes"]).max()))
                worst_score = max(worst_score, float(np.abs(
                    have["scores"] - want["scores"]).max()))
                check(np.allclose(have["visible_boxes"],
                                  want["visible_boxes"], rtol=BOX_RTOL,
                                  atol=BOX_ATOL)
                      and worst_score <= SCORE_ATOL,
                      f"{what}: floats differ between card and CPU")
                continue
            found, count = matched_detections(have, want)
            matched, total = matched + len(found), total + count
            for t, i, j in found:
                worst_box = max(worst_box, float(np.abs(
                    have["visible_boxes"][t, i]
                    - want["visible_boxes"][t, j]).max()))
                worst_score = max(worst_score, float(
                    abs(have["scores"][t, i] - want["scores"][t, j])
                    / det_ulp(want["scores"][t, j])))
        if dtype == torch.float32:
            log(f"{what} card vs CPU (2 streaming clips, a 2-video batched):"
                f" integer outputs equal, max|d| boxes {worst_box:.3e} px, "
                f"scores {worst_score:.3e}; launches {b2} {n[b2]}")
            continue
        log(f"{what} card vs CPU (2 streaming clips, a 2-video batched): "
            f"{matched} of {total} detections matched, on them max|d| boxes "
            f"{worst_box:.3e} px, scores {worst_score:.0f} bf16 ulps; "
            f"next_id card {int(states[1].next_id)}, CPU "
            f"{int(states[0].next_id)}; launches {b2} {n[b2]}")
        check(total > 0 and matched >= MATCHED_SHARE * total,
              f"{what}: {matched} of {total} detections matched")
        check(worst_box <= BF16_BOX_ATOL and worst_score <= 2,
              f"{what}: matched boxes differ by {worst_box} px, scores by "
              f"{worst_score} ulps")


def phase_small_reference(torch, dev, wrappers, config):
    """The same small pipeline on the card (kernels) and on the CPU
    (plain versions), on the same weights and coherent frames."""
    from tao_amodal_torch.pipeline import AmodalPipeline
    from torch_port_fixtures import perturb_module

    cpu = AmodalPipeline.create(**config, device="cpu").init(
        torch.Generator().manual_seed(4))
    perturb_module(cpu, np.random.RandomState(5))
    gpu = copy.deepcopy(cpu).to(dev)
    rs = np.random.RandomState(6)
    base = rs.randint(0, 256, (1, TINY_H, TINY_W, 3))
    clips = [np.clip(base + rs.randint(-2, 3, (TINY_T, TINY_H, TINY_W, 3)),
                     0, 255).astype(np.uint8) for _ in range(2)]
    states = [cpu.init_tracker_state(), gpu.init_tracker_state()]
    worst = {"boxes": 0.0, "scores": 0.0}
    for fn, _, _ in wrappers.values():
        fn.launches = 0
    for raw in clips:
        outs = []
        for i, pipe in enumerate((cpu, gpu)):
            clip, _ = pipe.preprocess(
                torch.from_numpy(raw).to(pipe.device), out_size=TINY_S)
            out, states[i] = pipe.streaming(clip, states[i], score_thr=0.0)
            outs.append({k: v.cpu() for k, v in out.items()})
        want, got = outs
        check_outputs(torch, got, TINY_T, config["num_dets"])
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
    torch.cuda.synchronize()
    fused = wrappers["fused_bottleneck_chain"][0].launches
    want_fused = (4 * len(clips) if config.get("fused_stages") else 0)
    check(fused == want_fused, f"small pipeline: fused_bottleneck_chain "
          f"launched {fused} times, want {want_fused}")
    next_ids = [int(s.next_id) for s in states]
    check(next_ids[0] == next_ids[1] > 1,
          f"small pipeline: next_id {next_ids} (cpu, card)")
    log(f"small pipeline {config['backbone_stages']} fused "
        f"{config.get('fused_stages', ())} card vs CPU over 2 clips: "
        f"integer outputs equal, max|d| boxes {worst['boxes']:.3e} px, "
        f"scores {worst['scores']:.3e}, next_id {next_ids[1]}, B4 "
        f"launches {fused}")


def phase_small_batched(torch, dev, wrappers):
    """A small ``batched`` on the card (TINY_BATCH videos, two clip
    batches, states threaded) against TINY_BATCH ``streaming`` runs of
    the same frames on the CPU: integer outputs and SORT state
    counters equal, floats within the phase's tolerances."""
    from tao_amodal_torch.pipeline import AmodalPipeline
    from torch_port_fixtures import perturb_module

    cpu = AmodalPipeline.create(**TINY, device="cpu").init(
        torch.Generator().manual_seed(14))
    perturb_module(cpu, np.random.RandomState(15))
    gpu = copy.deepcopy(cpu).to(dev)
    rs = np.random.RandomState(16)
    bases = rs.randint(0, 256, (TINY_BATCH, 1, TINY_H, TINY_W, 3))
    batches = [[np.clip(base + rs.randint(-2, 3, (TINY_T, TINY_H, TINY_W,
                                                  3)), 0, 255).astype(
        np.uint8) for base in bases] for _ in range(2)]
    states, cpu_states = None, [cpu.init_tracker_state()
                                for _ in range(TINY_BATCH)]
    worst = {"boxes": 0.0, "scores": 0.0}
    for fn, _, _ in wrappers.values():
        fn.launches = 0
    for raws in batches:
        got, states = gpu.batched(clip_batch(torch, gpu, raws, TINY_S),
                                  states, score_thr=0.0)
        got = {k: v.cpu() for k, v in got.items()}
        check_outputs(torch, got, TINY_T, TINY["num_dets"], (TINY_BATCH,))
        for v, raw in enumerate(raws):
            clip, _ = cpu.preprocess(torch.from_numpy(raw), out_size=TINY_S)
            want, cpu_states[v] = cpu.streaming(clip, cpu_states[v],
                                                score_thr=0.0)
            for k in ("classes", "track_ids", "valid"):
                check(torch.equal(got[k][v], want[k]),
                      f"small batched: video {v}'s {k} differ from CPU "
                      f"streaming")
            for k in ("boxes", "visible_boxes"):
                check(torch.allclose(got[k][v], want[k], rtol=BOX_RTOL,
                                     atol=BOX_ATOL),
                      f"small batched: video {v}'s {k} differ")
                worst["boxes"] = max(worst["boxes"], float(
                    (got[k][v] - want[k]).abs().max()))
            worst["scores"] = max(worst["scores"], float(
                (got["scores"][v] - want["scores"]).abs().max()))
    check(worst["scores"] <= SCORE_ATOL,
          f"small batched: scores differ by {worst['scores']}")
    for f in SORT_INT_FIELDS:
        want = torch.stack([getattr(s, f) for s in cpu_states])
        check(torch.equal(getattr(states, f).cpu(), want),
              f"small batched: state {f} differs from CPU streaming")
    torch.cuda.synchronize()
    b2 = wrappers["prroi_packed"][0].launches
    check(b2 == len(batches), f"small batched: prroi_packed launched {b2} "
          f"times, want {len(batches)}")
    log(f"small batched {TINY['backbone_stages']} on the card, "
        f"{TINY_BATCH} videos x 2 clip batches, against {TINY_BATCH} "
        f"streaming runs on the CPU: integer outputs and SORT counters "
        f"equal, max|d| boxes {worst['boxes']:.3e} px, scores "
        f"{worst['scores']:.3e}, next_id {states.next_id.tolist()}, B2 "
        f"launches {b2}")


# The int8 trunk: ResNet-50's convs a clip (1 stem, 16 blocks of 3, 4
# projections), and its quantizations: a projection shares its block's
# first conv's, so 4 fewer.
INT8_CONVS = 53
INT8_QUANTIZATIONS = 49
#  phase_int8's small pipelines, card vs CPU, by the rule of
#  tests/test_torch_port_int8_pipeline.py: the pyramid's mean |d| at most
#  half that of the f32 trunk on the same weights, unmatched detections
#  at most the f32 trunk's.  RPN (packed) and RoIAlign card vs CPU: f32
#  sums in another order on O(1) values, PRROI_ATOL's and FUSED_RTOL's.
INT8_PYRAMID_SHARE = 0.5


def int8_int_mm(torch, x8, w8, scale, stride, pad, out_dtype):
    """The trunk conv through cuBLASLt's int8 GEMM (``torch._int_mm``),
    the yardstick of its ``library_ms``: the input's channels zero-padded
    to 16 (``_int_mm`` takes K in multiples of 8), im2col in (ky, kx, c)
    order, one ``[P, K] x [K, Cout]`` product, then the plain version's
    dequantization."""
    from tao_amodal_torch.ops.int8_conv import dequant

    F = torch.nn.functional
    T_, Hi, Wi, cin = x8.shape
    ks, cout = w8.shape[0], w8.shape[3]
    cp = -(-cin // 16) * 16
    x = F.pad(x8, (0, cp - cin, pad, pad, pad, pad))
    w = F.pad(w8, (0, 0, 0, cp - cin)).reshape(-1, cout).contiguous()
    Ho = (Hi + 2 * pad - ks) // stride + 1
    Wo = (Wi + 2 * pad - ks) // stride + 1
    cols = torch.cat([x[:, ky:ky + stride * (Ho - 1) + 1:stride,
                        kx:kx + stride * (Wo - 1) + 1:stride]
                      for ky in range(ks) for kx in range(ks)], dim=-1)
    acc = torch._int_mm(cols.reshape(-1, ks * ks * cp), w)
    return dequant(acc, scale, out_dtype).reshape(T_, Ho, Wo, cout)


def record_int8_convs(run):
    """Run ``run()`` with every call of the int8 trunk's conv
    (``quantized_conv``, the body of each int8 ``ConvBN``) recorded: its
    operands (``xq``, the quantized activation a bottleneck's first conv
    and projection share, or None) and its output, in call order."""
    from tao_amodal_torch.ops import int8_conv

    real, calls = int8_conv.quantized_conv, []

    def record(x, w8, s_w, stride=1, pad=0, out_dtype=None, act_scale=None,
               xq=None):
        out = real(x, w8, s_w, stride, pad, out_dtype, act_scale, xq)
        calls.append((x, w8, s_w, stride, pad, out_dtype, act_scale, xq,
                      out))
        return out

    # The wrapper counts its launches on the module's name for it, which
    # is the recorder while this runs (a run no count is read from).
    record.launches = 0
    int8_conv.quantized_conv = record
    try:
        result = run()
    finally:
        int8_conv.quantized_conv = real
    return result, calls


def eager_quantize_activation_s8(x, act_scale=None, channels=16):
    """The quantizer's plain version (eager PyTorch, about ten launches):
    what the eager path of ``phase_int8`` quantizes a shared input
    with."""
    from tao_amodal_torch.ops import int8_conv as q

    return q.quantize_activation_s8_torch(x, act_scale, channels)


def eager_quantized_conv(x, w8, s_w, stride=1, pad=0, out_dtype=None,
                         act_scale=None, xq=None):
    """The int8 trunk conv with its activation quantized by eager PyTorch
    (``quantize_activation``: about ten launches, the NHWC copy, the
    scale product), then the conv kernel alone (``int8_conv``); a shared
    ``xq`` (:func:`eager_quantize_activation_s8`'s) is used as it is.
    The plain path that ``phase_int8`` times the fused one against."""
    from tao_amodal_torch.ops import int8_conv as q

    if xq is None:
        x8, s_x = q.quantize_activation(x.permute(0, 2, 3, 1), act_scale)
    else:
        x8, s_x = xq[0][..., :x.shape[1]], xq[1]
    return q.int8_conv(x8, w8, s_x * s_w, stride, pad,
                       out_dtype).permute(0, 3, 1, 2)


def quantizer_form(x, cp):
    """Which form of ``tao_quantize_s8`` takes NCHW ``x`` padded to
    ``cp`` channels (csrc/conv_sm90.cu's dispatch): ``flat`` (dense NHWC,
    no channels to pad, 16-byte aligned) or ``pixel``."""
    T_, C, H, W = x.shape
    sT, sC, sH, sW = x.stride()
    flat = (cp == C and sC == 1 and sW == C and sH == W * C
            and sT == H * W * C and x.numel() * x.element_size() % 16 == 0
            and x.data_ptr() % 16 == 0)
    return "flat" if flat else "pixel"


def check_int8_convs(torch, calls):
    """Each recorded trunk conv against its plain version on the card, on
    the same operands: ``quantized_conv`` (the activation quantized on the
    card, or the quantization its block's first conv shares with the
    projection, then the conv) bit for bit against
    ``quantized_conv_reference``, its quantizer (``quantize_activation_s8``)
    against its plain version, scale included, a shared one against a
    fresh one, and the conv alone (``int8_conv``) on those int8 operands
    against ``int8_conv_reference``.  Then the 53 convs and their 49
    quantizations timed (sums over the clip): each kernel by CUDA events
    of back-to-back calls and by its own device time (``torch.profiler``),
    the eager path (:func:`eager_quantized_conv`) the same way, the plain
    versions, and im2col + ``torch._int_mm`` for the conv, each beside
    its bound from these operands (``quantized_conv`` reads each
    quantized f32 or bf16 activation once).  The quantizer by activation
    size too: its form, the share of the activation that fits the flat
    form's room on chip between its two passes (derived from the
    library's ``tao_quantize_s8_kept_bytes``; the rest is reread), device
    ms and bound; and bit for bit on the tests' other layouts
    (``torch_port_fixtures.quantizer_cases``).  Returns the kernels
    line's rows."""
    from tao_amodal_torch import _build
    from tao_amodal_torch.ops import int8_conv as q

    check(len(calls) == INT8_CONVS, f"int8 trunk: {len(calls)} convs, want "
          f"{INT8_CONVS}")
    # The clip's quantizations: a call handed its block's shared xq
    # quantizes nothing of its own; the pair counts one.
    quants, first_of = [], set()
    for x, *_, act, xq, _ in calls:
        if xq is None or id(xq) not in first_of:
            quants.append((x, act))
            if xq is not None:
                first_of.add(id(xq))
    check(len(quants) == INT8_QUANTIZATIONS, f"int8 trunk: {len(quants)} "
          f"quantizations, want {INT8_QUANTIZATIONS}")
    t = dict(conv=0.0, quant=0.0, fused=0.0, eager=0.0, plain=0.0,
             conv_plain=0.0, quant_plain=0.0, lib=0.0)
    n_bytes = dict(conv=0, quant=0, fused=0)
    ops, stem_ms, refused, alone = 0, None, None, []
    for i, (x, w8, s_w, stride, pad, dt, act, xq, out) in enumerate(calls):
        what = f"int8 conv {i} {list(x.shape)} k{w8.shape[0]}/{stride}"
        want = q.quantized_conv_reference(x, w8, s_w, stride, pad, dt, act)
        check(out.dtype == want.dtype and out.shape == want.shape
              and torch.equal(out, want),
              f"{what} differs from its plain version by up to "
              f"{float((out.float() - want.float()).abs().max())}")
        x8p, s_x = q.quantize_activation_s8(x, act)
        w8p, w_sx = q.quantize_activation_s8_torch(x, act)
        check(torch.equal(x8p, w8p) and torch.equal(s_x, w_sx),
              f"{what}: the quantizer differs from its plain version (s_x "
              f"{float(s_x)} against {float(w_sx)})")
        check(xq is None or (torch.equal(xq[0], x8p)
                             and torch.equal(xq[1], s_x)),
              f"{what}: the shared quantization differs from a fresh one")
        cin = x.shape[1]
        x8 = x8p[..., :cin].contiguous()
        scale = s_x * s_w
        got = q.int8_conv(x8, w8, scale, stride, pad, dt)
        check(torch.equal(got, q.int8_conv_reference(x8, w8, scale, stride,
                                                     pad, dt)),
              f"{what}: the conv alone differs from its plain version")
        alone.append((x8, w8, scale, stride, pad, dt))
        if i == 0:
            stem_ms = cuda_ms(torch, lambda: q.quantized_conv(
                x, w8, s_w, stride, pad, dt, act), 5)
        t["conv"] += cuda_ms(torch, lambda: q.int8_conv(
            x8, w8, scale, stride, pad, dt), 5)
        t["conv_plain"] += cuda_ms(torch, lambda: q.int8_conv_reference(
            x8, w8, scale, stride, pad, dt), 1)
        if refused is None:
            try:
                lib = int8_int_mm(torch, x8, w8, scale, stride, pad, dt)
            except RuntimeError as exc:
                refused = f"torch._int_mm refused conv {i}: {exc}"
            else:
                check(torch.equal(lib, got), f"torch._int_mm conv {i} "
                      f"differs from the plain version")
                t["lib"] += cuda_ms(torch, lambda: int8_int_mm(
                    torch, x8, w8, scale, stride, pad, dt), 3)
        ks = w8.shape[0]
        ops += 2 * out[:, 0].numel() * w8.shape[3] * ks * ks * cin
        n_bytes["conv"] += nbytes(x8, w8, scale, out)
        n_bytes["fused"] += nbytes(w8, s_w, out)
        del want, got
    sizes = {}
    for x, act in quants:
        x8p, _ = q.quantize_activation_s8(x, act)
        n_bytes["quant"] += nbytes(x, x8p)
        n_bytes["fused"] += nbytes(x)
        t["quant"] += cuda_ms(torch, lambda: q.quantize_activation_s8(x, act),
                              5)
        t["quant_plain"] += cuda_ms(
            torch, lambda: q.quantize_activation_s8_torch(x, act), 3)
        sizes.setdefault((tuple(x.shape), x.dtype, act), []).append(
            (x, nbytes(x, x8p), quantizer_form(x, x8p.shape[-1])))

    def as_clip(quantize, conv):
        """The clip's convs in order, each shared quantization once."""
        def run():
            shared = {}
            for x, w8, s_w, stride, pad, dt, act, xq, _ in calls:
                mine = None
                if xq is not None:
                    if id(xq) not in shared:
                        shared[id(xq)] = quantize(x, act)
                    mine = shared[id(xq)]
                conv(x, w8, s_w, stride, pad, dt, act, mine)
        return run

    def plain_conv(x, w8, s_w, stride, pad, dt, act, xq):
        if xq is None:
            return q.quantized_conv_reference(x, w8, s_w, stride, pad, dt,
                                              act)
        return q.int8_conv_reference(xq[0][..., :x.shape[1]], w8,
                                     xq[1] * s_w, stride, pad, dt)

    def run_quant():
        for x, act in quants:
            q.quantize_activation_s8(x, act)

    def run_alone():
        for x8, w8, scale, stride, pad, dt in alone:
            q.int8_conv(x8, w8, scale, stride, pad, dt)

    fused = as_clip(q.quantize_activation_s8, q.quantized_conv)
    eager = as_clip(eager_quantize_activation_s8, eager_quantized_conv)
    t["fused"] = cuda_ms(torch, fused, 3)
    t["eager"] = cuda_ms(torch, eager, 3)
    t["plain"] = cuda_ms(torch, as_clip(q.quantize_activation_s8_torch,
                                        plain_conv), 1)
    # The quantizer's device work: its kernel and the memset that zeroes
    # its barrier's state before a dynamic launch.
    quant_names = KERNEL_NAMES["quantize_activation_s8"] + ("Memset",)
    dev = dict(
        conv=device_ms(torch, run_alone, "conv_wgmma_kernel", 3,
                       per_call=True),
        quant=device_ms(torch, run_quant, quant_names, 3, per_call=True),
        fused=device_ms(torch, fused, quant_names + ("conv_wgmma_kernel",),
                        3, per_call=True),
        eager=device_ms(torch, eager, "", 3, per_call=True))
    numel = sum(x.numel() for x, _ in quants)
    rows = dict(
        int8_conv=row(0.0, t["conv"], t["conv_plain"],
                      bound(n_bytes["conv"], ops, "int8"),
                      None if refused else t["lib"], dev["conv"]),
        quantize_activation_s8=row(0.0, t["quant"], t["quant_plain"],
                                   bound(n_bytes["quant"], 5 * numel,
                                         "f32"), None, dev["quant"]),
        quantized_conv=row(0.0, t["fused"], t["plain"],
                           bound(n_bytes["fused"], ops, "int8"), None,
                           dev["fused"]))
    log(f"int8 trunk, the {len(calls)} convs of one clip and their "
        f"{len(quants)} quantizations: every one equal to its plain version "
        f"(the whole, its quantizer and the conv alone); {ops / 1e9:.1f} G "
        f"ops; the stem (7x7/2, Cin 3 padded to 16) {stem_ms:.4f} ms by "
        f"events = {100 * stem_ms / t['fused']:.1f} % of the fused clip's "
        f"convs"
        + (f"; {refused}" if refused else "; torch._int_mm equal to plain"))
    for name, r in rows.items():
        log(f"int8 {name}: {roofline_note(r)}")
    from torch_port_fixtures import quantizer_cases

    cases = quantizer_cases(calls[0][0].device)
    for x, act in cases:
        got8, got_s = q.quantize_activation_s8(x, act)
        want8, want_s = q.quantize_activation_s8_torch(x, act)
        check(torch.equal(got8, want8) and torch.equal(got_s, want_s),
              f"the quantizer differs from its plain version on a "
              f"{x.dtype} {list(x.shape)} of strides {x.stride()}, static "
              f"scale {act}")
    log(f"int8 quantizer: bit-equal to its plain version on the tests' "
        f"{len(cases)} other layouts (NCHW and non-dense views, unaligned "
        f"and ragged channels-last, f32 and bf16, static scales, zeros)")
    # The flat form's room on chip, as the library sizes it (resident
    # blocks times a block's shared memory); the share held is derived
    # from it, not measured.
    kept = _build.library().tao_quantize_s8_kept_bytes(0)
    check(kept > 0, f"tao_quantize_s8_kept_bytes: CUDA error {-kept}")
    total_dev = 0.0
    for (shape, dtype, act), group in sorted(
            sizes.items(), key=lambda kv: -kv[1][0][1]):
        x, n_b, form = group[0]
        d = device_ms(torch, lambda: q.quantize_activation_s8(x, act),
                      quant_names, 5, per_call=True)
        total_dev += (d or 0.0) * len(group)
        held = min(1.0, kept / (x.numel() * x.element_size()))
        b_ms = bound(n_b, 5 * x.numel(), "f32")[0]
        log(f"int8 quantizer {list(shape)} {str(dtype)[6:]} "
            f"({x.numel() * x.element_size() / 1e6:.1f} MB, x{len(group)}, "
            f"{form} form): "
            + (f"{100 * held:.0f} % fits the on-chip room, "
               f"{100 * (1 - held):.0f} % reread (derived)"
               if form == "flat" else "reread whole (L2)")
            + "; device " + ("not measured" if d is None else
                             f"{d:.4f} ms, {100 * b_ms / d:.0f} % of "
                             f"its bound {b_ms:.4f} ms"))
    log(f"int8 quantizer by size: {total_dev:.4f} ms device over the "
        f"{len(quants)} quantizations (on-chip room {kept / 1e6:.1f} MB)")
    eager_dev = ("not measured" if dev["eager"] is None
                 else f"{dev['eager']:.4f} ms")
    log(f"int8 trunk, the eager path (eager quantization + the conv "
        f"alone) on the same {len(calls)} convs: {t['eager']:.4f} ms by "
        f"events, device {eager_dev}; the fused path {t['fused']:.4f} ms "
        f"by events; bytes: conv {n_bytes['conv'] / 1e9:.3f} GB, quantizer "
        f"{n_bytes['quant'] / 1e9:.3f} GB, the fused function "
        f"{n_bytes['fused'] / 1e9:.3f} GB")
    return rows


def int8_small_reference(torch, dev, wrappers):
    """The CPU tests' architecture with the int8 trunk on the card and on
    the CPU, on the same weights and coherent 4:3 frames, and the f32
    trunk on the CPU on those weights (each ``qkernel`` as ``Conv_0``):
    the card's pyramid within half the f32 trunk's mean |d| of the CPU's,
    level by level, and its detections no further from the CPU's than
    the f32 trunk's are (unmatched detections of either side)."""
    from tao_amodal_torch.pipeline import AmodalPipeline
    from torch_port_fixtures import perturb_module

    cpu = AmodalPipeline.create(**TINY, int8_backbone=True,
                                device="cpu").init(
        torch.Generator().manual_seed(52))
    perturb_module(cpu, np.random.RandomState(53))
    gpu = copy.deepcopy(cpu).to(dev)
    f32 = AmodalPipeline.create(**TINY, device="cpu")
    f32.load_state_dict({
        (k[:-len("qkernel")] + "Conv_0.weight" if k.endswith("qkernel")
         else k): (v.permute(3, 2, 0, 1).contiguous()
                   if k.endswith("qkernel") else v)
        for k, v in cpu.state_dict().items()})
    rs = np.random.RandomState(54)
    base = rs.randint(0, 256, (1, TINY_H, TINY_W, 3))
    clips = [np.clip(base + rs.randint(-2, 3, (TINY_T, TINY_H, TINY_W, 3)),
                     0, 255).astype(np.uint8) for _ in range(2)]
    pipes = {"card": gpu, "cpu": cpu, "f32": f32}
    states = {k: p.init_tracker_state() for k, p in pipes.items()}
    unmatched = {"card": 0, "f32": 0}
    for fn, _, _ in wrappers.values():
        fn.launches = 0
    for c, raw in enumerate(clips):
        outs, pyramids = {}, {}
        for k, p in pipes.items():
            clip, _ = p.preprocess(torch.from_numpy(raw).to(p.device),
                                   out_size=TINY_S)
            if c == 0:
                with torch.no_grad():
                    pyramids[k] = [f.cpu() for f in
                                   p.detector.features_for(clip)]
            out, states[k] = p.streaming(clip, states[k], score_thr=0.0)
            outs[k] = {n: v.cpu().numpy() for n, v in out.items()}
        check_outputs(torch, {k: torch.from_numpy(v) for k, v in
                              outs["card"].items()}, TINY_T,
                      TINY["num_dets"])
        for k in ("card", "f32"):
            pairs, total = matched_detections(outs[k], outs["cpu"])
            unmatched[k] += (total - len(pairs)
                             + int(outs["cpu"]["valid"].sum()) - len(pairs))
        for lvl, (g, w, f) in enumerate(zip(pyramids.get("card", []),
                                            pyramids.get("cpu", []),
                                            pyramids.get("f32", []))):
            d, d32 = float((g - w).abs().mean()), float((f - w).abs().mean())
            log(f"int8 small pipeline P{lvl + 3}: card vs CPU mean |d| "
                f"{d:.3e}, f32 trunk vs int8 on the CPU {d32:.3e}")
            check(d <= INT8_PYRAMID_SHARE * d32, f"int8 small pipeline P"
                  f"{lvl + 3}: card vs CPU {d}, f32 trunk {d32}")
    torch.cuda.synchronize()
    # 17 convs a trunk: the first clip's pyramid, then each clip.
    n, want = wrappers["int8_conv"][0].launches, 17 * (len(clips) + 1)
    check(n == want, f"int8 small pipeline: int8_conv launched {n} "
          f"times, want {want}")
    log(f"int8 small pipeline {TINY['backbone_stages']} card vs CPU over "
        f"{len(clips)} clips: {unmatched['card']} unmatched detections "
        f"(either side), the f32 trunk {unmatched['f32']}; int8_conv "
        f"launches {n}")
    check(unmatched["card"] <= unmatched["f32"],
          f"int8 small pipeline: card vs CPU {unmatched['card']} unmatched "
          f"detections, f32 trunk {unmatched['f32']}")


def rpn_align_card_vs_cpu(torch, dev, pipe):
    """``RPNHead(packed=True)`` (full-width weights, a P3-P7 pyramid of
    2 frames at 512^2) on the card against the CPU and against its own
    per-level mode, and ``multilevel_roi_align(method="align")`` on a
    P3-P6 pyramid with the serving RoIs, card against CPU."""
    from tao_amodal_torch.ops.roi import multilevel_roi_align

    g = torch.Generator(device=dev).manual_seed(55)
    feats = [torch.randn((2, 256, n, n), generator=g, device=dev)
             for n in (64, 32, 16, 8, 4)]
    rpn = pipe.detector.rpn
    cpu_rpn = copy.deepcopy(rpn).cpu()
    with torch.no_grad():
        got = rpn(feats, packed=True)
        per_level = rpn(feats)
        want = cpu_rpn([f.cpu() for f in feats], packed=True)
    worst = 0.0
    for a, b, c in zip((*got[0], *got[1]), (*per_level[0], *per_level[1]),
                       (*want[0], *want[1])):
        scale = float(c.abs().max())
        for other in (b.cpu(), c):
            e = float((a.cpu() - other).abs().max())
            worst = max(worst, e / scale)
            check(e <= FUSED_RTOL * scale, f"packed RPN differs by {e} "
                  f"(scale {scale})")
    pyramid = [torch.randn((2, n, n, 256), generator=g, device=dev)
               for n in (64, 32, 16, 8)]
    rois = serving_rois(torch, dev, 56)[:2]
    kw = dict(canonical_level=1, strides=LEVEL_STRIDES, method="align")
    got = multilevel_roi_align(pyramid, rois, **kw)
    want = multilevel_roi_align([p.cpu() for p in pyramid], rois.cpu(), **kw)
    err = float((got.cpu() - want).abs().max())
    check(got.shape == (2, 96, 7, 7, 256) and err <= PRROI_ATOL,
          f"RoIAlign card vs CPU: {tuple(got.shape)}, max|d| {err}")
    log(f"packed RPN (P3-P7 of 2 frames at 512^2, C=256) card vs CPU and "
        f"vs per-level: max|d| {worst:.3e} of the largest output; "
        f"RoIAlign (method='align', 2 x 96 serving RoIs) card vs CPU "
        f"max|d| {err:.3e}")


def phase_int8(torch, dev, wrappers):
    """The int8 trunk (``create(int8_backbone=True)``) at full width:
    ResNet-50 + FPN-256, f32, the classic stem, 480x640 uint8 frames
    letterboxed to 512^2, T=8, the CLI's defaults, greedy SORT, seeded
    random weights.  ``streaming`` over INT8_CLIPS clips, the state
    threaded: per clip the wall ms (host clock), the card's busy ms, idle
    share and device events (``torch.profiler``, the clip again from the
    same state), and each kernel's launches (B1, B2, and 53 of the trunk
    conv, its quantizer and the two together).  The same clips again on
    the eager quantization (:func:`eager_quantized_conv`), the plain
    path, in the same call: wall, busy, idle share and device events
    per conv.  Every conv of one clip against its plain version, bit for
    bit, and timed.  Then the bf16 ``s2d_pre`` int8 pipeline over one
    clip at 384x512, the small int8 pipeline card vs CPU, the packed RPN
    and RoIAlign card vs CPU, and a GTR-named checkpoint at full width
    loaded with ``load_gtr_checkpoint`` serving one clip.  Returns (the
    int8 kernels' rows, their launches on the main path)."""
    from tao_amodal_torch.pipeline import AmodalPipeline
    from tao_amodal_torch.utils.torch_convert import load_gtr_checkpoint
    from torch_port_fixtures import gtr_state_dict

    pipe = AmodalPipeline.create(int8_backbone=True, device=dev).init(
        torch.Generator(device=dev).manual_seed(50))
    rs = np.random.RandomState(51)
    clips = [rs.randint(0, 256, (T, H, W, 3), dtype=np.uint8)
             for _ in range(INT8_CLIPS)]

    def run_clip(p, raw, state, size=S):
        clip, _ = p.preprocess(torch.from_numpy(raw).to(dev), out_size=size)
        return p.streaming(clip, state, score_thr=0.0)

    from tao_amodal_torch.ops import int8_conv

    run_clip(pipe, clips[0], pipe.init_tracker_state())  # warm-up
    int8_rows = ("int8_conv", "quantize_activation_s8", "quantized_conv")
    launches = dict.fromkeys(int8_rows, 0)
    want = dict(preprocess_frames=1, prroi_packed=1, **fixpoint_launches(1),
                **dict.fromkeys(int8_rows, INT8_CONVS))
    want["quantize_activation_s8"] = INT8_QUANTIZATIONS
    events = {}
    for path in ("fused", "eager"):
        fused = int8_conv.quantized_conv
        fused_q = int8_conv.quantize_activation_s8
        if path == "eager":
            int8_conv.quantized_conv = eager_quantized_conv
            int8_conv.quantize_activation_s8 = eager_quantize_activation_s8
        try:
            state = pipe.init_tracker_state()
            for c, raw in enumerate(clips):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (out, new_state), n = counted(
                    torch, wrappers, lambda: run_clip(pipe, raw, state))
                wall = (time.perf_counter() - t0) * 1e3
                for k in wrappers:
                    if path == "fused":
                        check(n[k] == want.get(k, 0), f"int8 path clip {c}:"
                              f" {k} launched {n[k]} times, want "
                              f"{want.get(k, 0)}")
                check_outputs(torch, out, T, NUM_DETS)
                prof_wall, busy, n_ev = idle_share(
                    torch, lambda: run_clip(pipe, raw, state), events=True)
                events.setdefault(path, []).append(n_ev)
                idle = ("not measured" if busy is None else
                        f"{busy:.2f} ms busy of {prof_wall:.2f} ms, "
                        f"{100 * (1 - busy / prof_wall):.1f} % idle, "
                        f"{n_ev} device events")
                log(f"int8 {path} path clip {c} (f32, classic stem, {S}^2, "
                    f"T={T}): {wall:.2f} ms wall (host clock, "
                    f"synchronized); device {idle} (the clip again under "
                    f"torch.profiler); launches "
                    f"{ {k: v for k, v in n.items() if v} }")
                state = new_state
                if path == "fused":
                    for k in int8_rows:
                        launches[k] += n[k]
        finally:
            int8_conv.quantized_conv = fused
            int8_conv.quantize_activation_s8 = fused_q
        check(int(state.next_id) > 1, f"int8 {path} path: no track was born")
    fewer = [(e - f) / INT8_CONVS
             for f, e in zip(events["fused"], events["eager"])]
    log(f"int8 trunk: the fused quantization leaves "
        f"{min(fewer):.2f}-{max(fewer):.2f} fewer device events a conv, "
        f"clip for clip ({min(events['fused'])}-{max(events['fused'])} a "
        f"clip fused, {min(events['eager'])}-{max(events['eager'])} eager)")
    (_, _), calls = record_int8_convs(lambda: run_clip(
        pipe, clips[0], pipe.init_tracker_state()))
    rows = check_int8_convs(torch, calls)
    del calls
    rpn_align_card_vs_cpu(torch, dev, pipe)
    del pipe

    bf = AmodalPipeline.create(int8_backbone=True, dtype=torch.bfloat16,
                               stem="s2d_pre", device=dev).init(
        torch.Generator(device=dev).manual_seed(57))
    run_clip(bf, clips[0], bf.init_tracker_state(), BF16_OUT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (out, _), n = counted(torch, wrappers, lambda: run_clip(
        bf, clips[1], bf.init_tracker_state(), BF16_OUT))
    wall = (time.perf_counter() - t0) * 1e3
    want = dict(prroi_packed_bf16=1, **fixpoint_launches(1),
                **dict.fromkeys(int8_rows, INT8_CONVS))
    want["quantize_activation_s8"] = INT8_QUANTIZATIONS
    for k in wrappers:
        check(n[k] == want.get(k, 0), f"int8 bf16 s2d_pre: {k} launched "
              f"{n[k]} times, want {want.get(k, 0)}")
    check_outputs(torch, out, T, NUM_DETS)
    check(out["scores"].dtype == torch.bfloat16, "int8 bf16: scores dtype")
    _, busy = idle_share(torch, lambda: run_clip(
        bf, clips[1], bf.init_tracker_state(), BF16_OUT))
    log(f"int8 bf16 s2d_pre clip ({BF16_OUT[0]}x{BF16_OUT[1]}, T={T}): "
        f"{wall:.2f} ms wall; device busy "
        + ("not measured" if busy is None else f"{busy:.2f} ms")
        + f"; launches { {k: v for k, v in n.items() if v} }")
    del bf

    int8_small_reference(torch, dev, wrappers)

    t0 = time.perf_counter()
    gtr = AmodalPipeline.create(device=dev)
    load_gtr_checkpoint(gtr, gtr_state_dict(58, (3, 4, 6, 3), 80))
    (out, state), n = counted(torch, wrappers, lambda: run_clip(
        gtr, clips[0], gtr.init_tracker_state()))
    check_outputs(torch, out, T, NUM_DETS)
    check(n["preprocess_frames"] == 1 and n["prroi_packed"] == 1,
          f"GTR-loaded pipeline: launches {n}")
    log(f"GTR-named checkpoint at full width (ResNet-50, FPN 256, 80 "
        f"classes; built from a seed) loaded with load_gtr_checkpoint and "
        f"served one clip in {time.perf_counter() - t0:.1f} s (build and "
        f"load included): {int(out['valid'].sum())} valid detections, "
        f"next_id {int(state.next_id)}")
    return rows, launches


def profile_run(torch, fn):
    """``fn()`` once, synchronized, under torch.profiler (CPU and CUDA
    activities): (its result, wall ms, device busy ms or None, device
    events, a Counter of the device events' names, their device ms by
    name, CUDA graph launches, a Counter of the names of device records
    that came with no duration).  Busy is the union of the card's kernel
    and copy intervals; the graph launches are the trace's
    ``cudaGraphLaunch`` runtime calls."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    every = [e for e in events if e.device_type == DeviceType.CUDA]
    device = [e for e in every if e.time_range.end > e.time_range.start]
    blank = Counter(e.name for e in every
                    if e.time_range.end <= e.time_range.start)
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy = None
    if spans:
        busy, (lo, hi) = 0.0, spans[0]
        for a, b in spans[1:]:
            if a > hi:
                busy, lo, hi = busy + hi - lo, a, b
            else:
                hi = max(hi, b)
        busy = (busy + hi - lo) / 1e3
    graphs = sum(1 for e in events if e.device_type == DeviceType.CPU
                 and "cudaGraphLaunch" in e.name)
    times = Counter()
    for e in device:
        times[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    return (result, wall, busy, len(spans), Counter(e.name for e in device),
            times, graphs, blank)


def kernel_launches(kernels, names):
    """The device events of a profile (:func:`profile_run`'s Counter)
    whose names hold one of ``names``."""
    return sum(n for k, n in kernels.items() if any(p in k for p in names))


def sync_free(label, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any
    host sync inside it fails the smoke."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        raise SmokeFailure(f"{label} failed under set_sync_debug_mode("
                           f"'error'), a host sync: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)


def outputs_agree(torch, got, want, what):
    """Captured against eager outputs: every integer equal, boxes and
    scores within the card-vs-CPU bounds (BOX_RTOL + BOX_ATOL px,
    SCORE_ATOL; bf16 scores within one bf16 rounding, 2**-8 relative).
    Returns the largest |d| of boxes, visible boxes and scores."""
    for k in ("classes", "track_ids", "valid"):
        check(torch.equal(got[k], want[k]), f"{what}: {k} differ")
    worst = {}
    for k in ("boxes", "visible_boxes", "scores"):
        g, w = got[k].float(), want[k].float()
        if k == "scores":
            rtol = 2.0 ** -8 if got[k].dtype == torch.bfloat16 else 0.0
            ok = torch.allclose(g, w, rtol=rtol, atol=SCORE_ATOL)
        else:
            ok = torch.allclose(g, w, rtol=BOX_RTOL, atol=BOX_ATOL)
        worst[k] = float((g - w).abs().max())
        check(ok, f"{what}: {k} beyond the bound, max|d| {worst[k]:.3e}")
    return worst


def states_agree(torch, got, want, what):
    """Two SORT states: integer fields equal, the Kalman state within the
    SORT bounds; returns its largest |d|."""
    for f in SORT_INT_FIELDS:
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"{what}: state {f} differs")
    err = 0.0
    for f in ("x", "P"):
        g, w = getattr(got, f), getattr(want, f)
        check(torch.allclose(g, w, rtol=SORT_RTOL, atol=SORT_ATOL),
              f"{what}: state {f} differs")
        err = max(err, float((g - w).abs().max()))
    return err


def spread(ms):
    return (f"median {np.median(ms):.2f} ({min(ms):.2f}-{max(ms):.2f}, "
            f"{len(ms)} clips)")


def nms_rounds(sup, valid):
    """Rounds of NMS's rounds kernel for each leading row of ``sup`` (a
    host count on the CPU): rounds until one changes nothing, that one
    included, at most N."""
    import torch

    sup, keep = sup.cpu(), valid.cpu()
    rounds = torch.zeros(keep.shape[:-1], dtype=torch.int64)
    done = torch.zeros(keep.shape[:-1], dtype=torch.bool)
    for _ in range(sup.shape[-1]):
        new = valid.cpu() & ~(sup & keep[..., :, None]).any(-2)
        rounds += ~done
        done |= ~(new != keep).any(-1)
        keep = new
        if bool(done.all()):
            break
    return rounds


# NMS's kernels on the card: the boxes' call (bits and rounds) and the
# sup entry's (pack and rounds).
NMS_KERNELS = ("nms_bits_kernel", "nms_rounds_kernel")
SUP_KERNELS = ("nms_pack_kernel", "nms_rounds_kernel")


def nms_bound(torch, boxes, scores, valid, rounds):
    """(bytes, operations) of one NMS call: boxes, scores and valid read
    once and keep written once; 13 f32 operations an IoU of a pair whose
    first box ranks above the second (four max/min, two differences, two
    clamps, the product, the union's sum and difference, the quotient,
    the comparison) and a word AND a round for each column's word."""
    B, n = scores.shape
    idx = torch.arange(n, device=scores.device)
    s_i, s_j = scores[..., :, None], scores[..., None, :]
    pairs = int(((s_i > s_j) | ((s_i == s_j) & (idx[:, None] < idx[None, :])))
                .sum())
    n_bytes = nbytes(boxes, scores) + B * n + (0 if valid is None
                                               else nbytes(valid))
    return n_bytes, 13 * pairs + int(rounds.sum()) * n * -(-n // 32)


def check_fixpoints(torch, dev, pipe, clips):
    """The fixpoint kernels against their plain versions, bit for bit:
    ``nms_keep_mask`` (``tao_nms_keep``: the suppression bits built from
    the boxes, then the rounds) on every NMS call of ``pipe``'s eager
    streaming over ``clips`` (its own boxes, scores, valid and
    threshold), on boxes in chains that need N rounds at the RPN's and
    the detector's shapes and on the adversarial scenes of
    ``torch_port_fixtures.nms_adversarial`` (NaN and +-inf coordinates,
    zero-area boxes, tied identical boxes, IoUs at the threshold);
    ``nms_fixpoint`` (a given suppression matrix) on N-round chains; the
    greedy assignment on every call (its own benefit matrices), on
    chains and tie-rich scenes.  NMS timed on the pipeline's own calls
    (the RPN's, the detector's, and the RPN's of two clips tiled to the
    32 frames of ``batched``): the device ms of its kernels a call
    (``torch.profiler``) against the eager construction of the
    suppression matrix plus ``nms_fixpoint`` (the path before the bits
    kernel), beside its bound and the latency bound of its (1 + rounds)
    barriers, a barrier one phase's latency (the clock64 probe of
    csrc/sort_scan.cu, a block of 512 threads like theirs).  The greedy
    kernel at SORT's [64, 128] frame with the most rounds and on every
    frame of each clip.  Returns their rows."""
    from tao_amodal_torch.ops import hungarian, nms
    from torch_port_fixtures import NMS_SCENES, nms_adversarial
    from torch_port_fixtures import greedy_fixpoint as greedy_host

    seen = {"nms": [], "greedy": []}
    real_nms, real_greedy = nms.nms_keep_mask, hungarian.greedy_fixpoint

    def rec_nms(boxes, scores, iou_thr, valid=None, *args):
        seen["nms"].append((boxes.clone(), scores.clone(), iou_thr,
                            None if valid is None else valid.clone()))
        return real_nms(boxes, scores, iou_thr, valid, *args)

    def rec_greedy(b, *args):
        seen["greedy"].append(b.clone())
        return real_greedy(b, *args)

    # The wrappers count on their module's name, which the recorders
    # take over while they record.
    rec_nms.launches = rec_greedy.launches = 0
    nms.nms_keep_mask, hungarian.greedy_fixpoint = rec_nms, rec_greedy
    try:
        state = pipe.init_tracker_state()
        for x in clips:
            _, state = pipe.streaming(x, state, score_thr=0.0)
    finally:
        nms.nms_keep_mask, hungarian.greedy_fixpoint = real_nms, real_greedy
    torch.cuda.synchronize()
    shapes = sorted({tuple(c[1].shape) for c in seen["nms"]})
    check(len(seen["nms"]) == 2 * len(clips) and len(shapes) == 2
          and len(seen["greedy"]) == T * len(clips),
          f"fixpoint calls: {len(seen['nms'])} NMS of shapes {shapes}, "
          f"{len(seen['greedy'])} greedy")
    for call in seen["nms"]:
        check(torch.equal(real_nms(*call), nms.nms_keep_mask_torch(*call)),
              f"nms_keep_mask differs from its plain version on the "
              f"pipeline's {tuple(call[1].shape)} at {call[2]}")
    for b in seen["greedy"]:
        check(torch.equal(real_greedy(b), hungarian.greedy_fixpoint_torch(b)),
              "greedy_fixpoint differs from its plain version on the "
              "pipeline's benefit")
    # Chains: box i overlaps box i + 1 at IoU 1/3 and no other, scores
    # falling, so at 0.3 keep alternates and rank r settles in round r
    # (a suppression matrix with i -> i + 1 only, for nms_fixpoint);
    # benefit 1 - (i + j) / 1000, so each round matches one pair (row r,
    # column r).
    for B, n in shapes:
        x = torch.arange(n, dtype=torch.float32, device=dev) * 10.0
        boxes = torch.stack([x, 0 * x, x + 20.0, 0 * x + 10.0], -1)
        boxes = boxes.expand(B, n, 4).contiguous()
        scores = torch.linspace(0.9, 0.1, n, device=dev).expand(B, n)
        got = real_nms(boxes, scores, 0.3)
        want = nms.nms_keep_mask_torch(boxes, scores, 0.3)
        r = int(nms_rounds(*nms.suppression_torch(boxes, scores, 0.3))
                .max())
        check(torch.equal(got, want) and r >= n - 1,
              f"nms_keep_mask on a chain [{B}, {n}]: equal "
              f"{torch.equal(got, want)}, {r} rounds")
        chain = torch.zeros((B, n, n), dtype=torch.bool, device=dev)
        idx = torch.arange(n - 1, device=dev)
        chain[:, idx, idx + 1] = True
        ones = torch.ones((B, n), dtype=torch.bool, device=dev)
        check(torch.equal(nms.nms_fixpoint(chain, ones),
                          nms.nms_fixpoint_torch(chain, ones)),
              f"nms_fixpoint differs from its plain version on a chain "
              f"[{B}, {n}, {n}]")
    for name in NMS_SCENES:
        boxes, scores, valid, thr = nms_adversarial(name)
        call = (torch.from_numpy(boxes).to(dev),
                torch.from_numpy(scores).to(dev), thr,
                None if valid is None else torch.from_numpy(valid).to(dev))
        check(torch.equal(real_nms(*call), nms.nms_keep_mask_torch(*call)),
              f"nms_keep_mask differs from its plain version on the "
              f"{name} scene {boxes.shape}")
    nb, mb = seen["greedy"][0].shape
    i, j = np.meshgrid(np.arange(nb), np.arange(mb), indexing="ij")
    chain_b = torch.from_numpy(
        (1 - (i + j) * 1e-3).astype(np.float32)).to(dev)
    got, want = real_greedy(chain_b), hungarian.greedy_fixpoint_torch(chain_b)
    chain_rounds = greedy_host(chain_b.cpu().numpy())[1]
    check(torch.equal(got, want) and chain_rounds == nb,
          f"greedy_fixpoint on a chain [{nb}, {mb}]: equal "
          f"{torch.equal(got, want)}, {chain_rounds} rounds")
    from torch_port_fixtures import greedy_adversarial, sort_benefits

    scenes = list(greedy_adversarial(0)) + list(sort_benefits(2))
    for a in scenes:
        at = torch.from_numpy(a).to(dev)
        check(torch.equal(real_greedy(at), hungarian.greedy_fixpoint_torch(at)),
              f"greedy_fixpoint differs from its plain version on an "
              f"adversarial {a.shape}")
    log(f"fixpoints: kernels equal plain bit for bit on the pipeline's "
        f"{len(seen['nms'])} NMS calls {shapes} and {len(seen['greedy'])} "
        f"greedy calls [{nb}, {mb}], on chains needing N rounds (NMS from "
        f"boxes and from a suppression matrix at "
        f"{', '.join(str(s) for s in shapes)}; greedy [{nb}, {mb}], "
        f"{chain_rounds} rounds), on the NMS scenes {NMS_SCENES} and on "
        f"{len(scenes)} tie-rich greedy scenes (plateaus of equal values "
        f"and zeros, NEG rows and columns, 1x1 to 256x128 and past shared "
        f"memory, SORT-like [64, 128])")

    phase_ns, _ = phase_latency(torch, dev)
    rows = {}
    rpn = next(c for c in seen["nms"] if c[1].shape == shapes[-1])
    det = next(c for c in seen["nms"] if c[1].shape == shapes[0])
    rpn32 = [c for c in seen["nms"] if c[1].shape == shapes[-1]]
    rpn32 = (torch.cat([c[0] for c in rpn32] * 2),
             torch.cat([c[1] for c in rpn32] * 2), rpn32[0][2], None)
    for label, call in (("RPN's", rpn), ("detector's", det),
                        ("RPN's at 32 frames", rpn32)):
        boxes, scores, thr, valid = call
        sup, v = nms.suppression_torch(*call)
        rounds = nms_rounds(sup, v)
        B, n = scores.shape

        def eager(call=call):  # the construction PRs 12-13 ran
            return nms.nms_fixpoint(*nms.suppression_torch(*call))

        check(torch.equal(eager(), real_nms(*call)),
              f"the eager construction differs on the {label} call")
        r = row(0.0, cuda_ms(torch, lambda: real_nms(*call), 50),
                cuda_ms(torch, lambda: nms.nms_keep_mask_torch(*call), 5),
                bound(*nms_bound(torch, boxes, scores, valid, rounds), "f32"),
                dev_ms=device_ms(torch, lambda: real_nms(*call), NMS_KERNELS,
                                 20, per_call=True))
        e_dev = device_ms(torch, eager, ("",), 20, per_call=True)
        e_sup = device_ms(torch, eager, SUP_KERNELS, 20, per_call=True)
        lat = (1 + int(rounds.max())) * phase_ns / 1e6
        log(f"nms_keep_mask on the pipeline's {label} [{B}, {n}] at {thr} "
            f"(rounds a frame {rounds.tolist()}): {roofline_note(r)}; "
            f"latency bound (1 + {int(rounds.max())} rounds) x "
            f"{phase_ns:.1f} ns = {lat:.4f} ms; the eager construction and "
            f"nms_fixpoint: "
            + ("not measured" if e_dev is None else f"{e_dev:.4f} ms device")
            + " a call, of which nms_fixpoint's pack and rounds "
            + ("not measured" if e_sup is None else f"{e_sup:.4f} ms")
            + f", {cuda_ms(torch, eager, 20):.4f} ms CUDA events")
        if label == "RPN's":
            rows["nms_keep_mask"] = r
    counts = [greedy_host(b.cpu().numpy())[1] for b in seen["greedy"]]
    rounds_out = torch.zeros(1, dtype=torch.int32, device=dev)

    def kernel_rounds(b):
        real_greedy(b, rounds=rounds_out)
        return int(rounds_out)

    own = [kernel_rounds(b) for b in seen["greedy"]]
    b = seen["greedy"][int(np.argmax(counts))]
    k = max(counts)
    r = row(0.0, cuda_ms(torch, lambda: real_greedy(b), 50),
            cuda_ms(torch, lambda: hungarian.greedy_fixpoint_torch(b), 5),
            bound(nbytes(b) + 8 * nb, 3 * nb * mb * (k + 1), "f32"),
            dev_ms=device_ms(torch, lambda: real_greedy(b),
                             "greedy_fixpoint_kernel", 20))
    lat = (2 + 3 * k) * phase_ns / 1e6
    k_own = own[int(np.argmax(counts))]
    log(f"greedy_fixpoint on SORT's own [{nb}, {mb}] frame with the most "
        f"rounds (plain rounds a frame {counts}; the kernel's own rounds "
        f"{own}): {roofline_note(r)}; latency bound of the plain rounds "
        f"(2 + 3 x {k} phases) x {phase_ns:.1f} ns = {lat:.4f} ms; of the "
        f"kernel's (3 + 2 x {k_own} barriers) = "
        f"{(3 + 2 * k_own) * phase_ns / 1e6:.4f} ms")
    # A clip's eight frames, one launch each: device time summed a clip.
    sums = []
    for c in range(len(clips)):
        frames = seen["greedy"][T * c:T * (c + 1)]
        ms = [device_ms(torch, lambda: real_greedy(f),
                        "greedy_fixpoint_kernel", 20) for f in frames]
        if any(m is None for m in ms):
            log(f"greedy_fixpoint clip {c}: device time not measured")
            continue
        sums.append(sum(ms))
        log(f"greedy_fixpoint clip {c}, its {T} frames: {sum(ms):.4f} ms "
            f"device summed ({', '.join(f'{m:.4f}' for m in ms)}); plain "
            f"rounds {counts[T * c:T * (c + 1)]}, the kernel's "
            f"{own[T * c:T * (c + 1)]}")
    if sums:
        log(f"greedy_fixpoint a clip ({T} launches): {min(sums):.4f}-"
            f"{max(sums):.4f} ms device over {len(sums)} clips")
    rows["greedy_fixpoint"] = r
    return rows


# phase_captured: each configuration (label, create() arguments, letterbox
# size, batched), eager and captured clips in turns.
CAPTURED_CLIPS = 3
# The CLI's --num_dets and --num_proposals of the captured clip whose
# SORT benefit [D, 2D] the auction kernel reads where it lies (past a
# block's shared memory; D is at most the proposals).
WIDE_DETS = 192


def graph_kernels(graph):
    """A captured CUDA graph's kernel nodes: a Counter of their function
    names, demangled.  The graph's template (which
    ``utils/graphs.capture`` keeps) is written as DOT by
    ``CUDAGraph.debug_dump`` (``cudaGraphDebugDotPrint``); each node's
    statement holds its kernel's mangled name, which the toolkit's
    ``cu++filt`` demangles as the profiler does."""
    import re
    from collections import Counter

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    nodes = re.split(r"\n(?=\"?graph_\d+_node_\d+\"?\s*\[)", text)
    mangled = [m.group(0) for m in (re.search(r"_Z\w+", n) for n in nodes)
               if m]
    check(mangled, f"no kernel node in the graph's DOT dump: "
          f"{text[:600]!r}")
    filt = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cu++filt")
    names = subprocess.run([filt], input="\n".join(mangled),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    check(len(names) == len(mangled), f"cu++filt returned {len(names)} "
          f"names for {len(mangled)}")
    # cu++filt writes a bool template argument as (bool)1, the profiler
    # as true.
    return Counter(re.sub(r"\(bool\)([01])",
                          lambda m: ("false", "true")[int(m.group(1))], n)
                   for n in names)


def captured_configs(torch):
    return (("f32", {}, S, False),
            ("fused", dict(fused_stages=FUSED), S, False),
            ("pallas_pooling", dict(pallas_pooling=True), S, False),
            ("bf16 s2d_pre", dict(dtype=torch.bfloat16, stem="s2d_pre"),
             BF16_OUT, False),
            ("int8", dict(int8_backbone=True), S, False),
            (f"batched B={BATCH}", {}, S, True),
            ("gated_auction", dict(sort_assignment="gated_auction"), S,
             False),
            ("auction", dict(sort_assignment="auction"), S, False),
            (f"batched B={BATCH} auction", dict(sort_assignment="auction"),
             S, True),
            (f"auction num_dets={WIDE_DETS}",
             dict(sort_assignment="auction", num_dets=WIDE_DETS,
                  num_proposals=WIDE_DETS), S, False))


def phase_captured(torch, dev, wrappers):
    """The captured serving programs at full width (ResNet-50, FPN 256,
    480x640 frames, T=8, 64 detections, 96 proposals, pre-NMS top-k 100,
    SORT over 128 slots, score threshold 0, seeded random weights):
    ``make_streaming_fn`` for f32 unfused, fused (B4), pallas_pooling
    (B5), the bench's bf16 s2d_pre at 384x512, the int8 trunk, and the
    gated and the full auction (``csrc/auction.cu``, greedy elsewhere),
    the auction at ``--num_dets`` and ``--num_proposals`` WIDE_DETS (its
    benefits past a block's shared memory), ``make_batched_fn`` for BATCH videos with greedy SORT
    and with the auction.  Per configuration,
    CAPTURED_CLIPS preprocessed clips twice over with the state threaded,
    eager and captured in turns from the same inputs: integers equal,
    boxes and scores within their bounds, the SORT states equal; no host
    sync inside a replay (``set_sync_debug_mode("error")``).  Printed:
    the capture's ms (warm-up included), program wall ms a clip (median
    and range), one profiled clip of each (busy ms, idle share, device
    events, graph launches; their outputs must agree too), peak device
    memory, the eager path's host syncs a clip, and the graph's kernel
    nodes by name (:func:`graph_kernels`), which must equal the eager
    clip's kernels.  The fixpoint kernels are checked on the
    f32 configuration (:func:`check_fixpoints`).  Returns (their rows,
    their launches on the captured f32 clip)."""
    from tao_amodal_torch import _build
    from tao_amodal_torch.pipeline import (
        AmodalPipeline,
        make_batched_fn,
        make_streaming_fn,
    )

    rows, launches = {}, {}
    mib = 2.0 ** 20
    for c, (label, kw, size, batched) in enumerate(captured_configs(torch)):
        pipe = AmodalPipeline.create(device=dev, **kw).init(
            torch.Generator(device=dev).manual_seed(70 + c))
        rs = np.random.RandomState(70 + c)
        torch.cuda.empty_cache()
        if batched:
            clips = [clip_batch(torch, pipe, [
                rs.randint(0, 256, (T, H, W, 3), dtype=np.uint8)
                for _ in range(BATCH)], size) for _ in range(CAPTURED_CLIPS)]
            run = make_batched_fn(pipe, score_thr=0.0)

            def eager(x, st):
                return pipe.batched(x, st, score_thr=0.0)

            def fresh():
                return pipe._fresh_states(BATCH)

            lead, want = (BATCH,), fixpoint_launches(
                1, BATCH * T, pipe.sort_assignment)
        else:
            clips = [pipe.preprocess(torch.from_numpy(rs.randint(
                0, 256, (T, H, W, 3), dtype=np.uint8)).to(dev),
                out_size=size)[0] for _ in range(CAPTURED_CLIPS)]
            run = make_streaming_fn(pipe, score_thr=0.0)

            def eager(x, st):
                return pipe.streaming(x, st, score_thr=0.0)

            fresh = pipe.init_tracker_state
            lead, want = (), fixpoint_launches(1, T, pipe.sort_assignment)
        if c == 0:
            rows = check_fixpoints(torch, dev, pipe, clips[:2])
        dets = min(pipe.detector.num_dets, pipe.detector.num_proposals)
        if pipe.sort_assignment != "greedy":
            form = ("in shared memory" if _build.library()
                    .tao_auction_rounds_smem(dets, 2 * dets, 1) >= 0
                    else "read where it lies")
            log(f"captured {label}: SORT's benefit [{dets}, {2 * dets}], "
                f"the auction kernel's benefit {form}")
        eager(clips[0], fresh())  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        eager(clips[0], fresh())
        torch.cuda.synchronize()
        peak_eager = torch.cuda.max_memory_allocated(dev) / mib
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run(clips[0], fresh())
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        capture = run.captured.capture_ms[-1]
        walls = {"eager": [], "captured": []}
        worst = dict.fromkeys(("boxes", "visible_boxes", "scores"), 0.0)
        state_err = 0.0
        for _ in range(2):
            se = sc = fresh()
            for i, x in enumerate(clips):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                oe, se = eager(x, se)
                torch.cuda.synchronize()
                walls["eager"].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                oc, sc = sync_free(f"captured {label} replay",
                                   lambda: run(x, sc))
                torch.cuda.synchronize()
                walls["captured"].append((time.perf_counter() - t0) * 1e3)
                check_outputs(torch, oc, T, dets, lead)
                agree = outputs_agree(torch, oc, oe,
                                      f"captured {label} clip {i}")
                for k, v in agree.items():
                    worst[k] = max(worst[k], v)
            state_err = max(state_err, states_agree(
                torch, sc, se, f"captured {label}"))
        check(bool((sc.next_id > 1).all()), f"captured {label}: no track")
        peak_captured = torch.cuda.max_memory_allocated(dev) / mib
        reserved = torch.cuda.max_memory_reserved(dev) / mib
        check(len(run.captured.graphs) == 1,
              f"captured {label}: {len(run.captured.graphs)} graphs")

        # The replay's kernels from the graph's own nodes, against the
        # eager clip's kernels by name in its profile.  A profile can lose
        # records but never adds one, and each Python launch is at least
        # one kernel (wrappers that share a kernel nest or exclude each
        # other on these paths, so the largest count is the kernel's):
        # the eager count is the larger of the two.  The profiled clips'
        # outputs must agree too.
        for fn, _, _ in wrappers.values():
            fn.launches = 0
        (e_out, e_wall, e_busy, e_events, e_kernels, e_times, _,
         e_blank) = profile_run(torch, lambda: eager(clips[1], fresh()))
        py = {name: fn.launches for name, (fn, _, _) in wrappers.items()}
        (c_out, c_wall, c_busy, c_events, c_kernels, c_times,
         graph_launches, c_blank) = profile_run(
             torch, lambda: run(clips[1], fresh()))
        outputs_agree(torch, c_out[0], e_out[0],
                      f"captured {label}, the profiled clip")
        states_agree(torch, c_out[1], e_out[1],
                     f"captured {label}, the profiled clip")
        nodes = graph_kernels(next(iter(run.captured.graphs.values())).graph)
        by_name, profiled = {}, {}
        for k, names in KERNEL_NAMES.items():
            profiled[k] = (kernel_launches(e_kernels, names),
                           kernel_launches(c_kernels, names))
            launched = max(py[j] for j, other in KERNEL_NAMES.items()
                           if other == names)
            by_name[k] = (max(profiled[k][0], launched),
                          kernel_launches(nodes, names))
        check(all(e == cap for e, cap in by_name.values()),
              f"captured {label}: the graph's kernel nodes by name differ "
              f"from the eager clip's kernels (eager, graph): {by_name}")
        lost = {k: (e, cap, by_name[k][1]) for k, (e, cap) in
                profiled.items() if not e == cap == by_name[k][1]}
        if lost:
            blank = {k[:60]: (e_blank[k], c_blank[k])
                     for k in set(e_blank) | set(c_blank)
                     if any(p in k for names in KERNEL_NAMES.values()
                            for p in names)}
            log(f"captured {label}: the profiles' kernel records by name "
                f"(eager, captured, graph nodes) differ: {lost}; records "
                f"with no duration of these kernels (eager, captured): "
                f"{blank}")
        check(graph_launches == 1, f"captured {label}: {graph_launches} "
              f"cudaGraphLaunch calls in one clip, want 1")
        for k, w in want.items():
            check(py[k] == w and by_name[k][1] == w,
                  f"captured {label}: {k} launched {py[k]} times eager, "
                  f"{by_name[k][1]} in the graph, want {w}")
        path = {k: v for k, v in py.items() if v}
        check(path and all(by_name[k][1] > 0 for k in path),
              f"captured {label}: a kernel of the path is missing from the "
              f"replay: {path}, {by_name}")
        if c == 0:
            launches = {k: by_name[k][1] for k in want}
        if label == "auction":
            launches["auction_assign"] = by_name["auction_assign"][1]
        _, syncs = count_syncs(torch, lambda: eager(clips[2], fresh()))

        def device(wall, busy, events):
            return ("not measured" if busy is None else
                    f"busy {busy:.2f} ms of {wall:.2f} ms, "
                    f"{100 * (1 - busy / wall):.1f} % idle, {events} device "
                    f"events")

        log(f"captured {label} ({size if isinstance(size, int) else size}"
            f"{'^2' if isinstance(size, int) else ''}, T={T}"
            f"{f', {BATCH} videos' if batched else ''}): capture "
            f"{capture:.1f} ms (2 warm-up calls on a side stream and the "
            f"capture), first call {first:.1f} ms; program wall ms a clip "
            f"(preprocessed clip in, outputs on the card; synchronized host "
            f"clock, 2 x {CAPTURED_CLIPS} clips in turns) eager "
            f"{spread(walls['eager'])}, captured {spread(walls['captured'])}"
            f"; one profiled clip (torch.profiler): eager "
            f"{device(e_wall, e_busy, e_events)}, captured "
            f"{device(c_wall, c_busy, c_events)}, {graph_launches} graph "
            f"launch; peak device memory (max_memory_allocated) eager "
            f"{peak_eager:.0f} MiB, captured {peak_captured:.0f} MiB "
            f"(reserved {reserved:.0f} MiB); host syncs a clip eager "
            f"{syncs}, captured 0 (set_sync_debug_mode('error') around "
            f"every replay); outputs of {2 * CAPTURED_CLIPS} clips: "
            f"integers equal, max|d| boxes {worst['boxes']:.3e} px, visible "
            f"{worst['visible_boxes']:.3e} px, scores {worst['scores']:.3e} "
            f"(bounds rtol {BOX_RTOL} + {BOX_ATOL} px, {SCORE_ATOL}), SORT "
            f"state max|d| {state_err:.3e}; the graph's kernel nodes by "
            f"name (equal to the eager clip's kernels) "
            f"{ {k: cap for k, (_, cap) in by_name.items() if cap} }")
        moved = sorted(set(e_times) | set(c_times),
                       key=lambda k: -abs(c_times[k] - e_times[k]))[:4]
        log(f"captured {label}: device ms by kernel name, captured against "
            f"eager, the four that moved most: " + "; ".join(
                f"{k[:70]} {c_times[k]:.3f} ms x{c_kernels[k]} against "
                f"{e_times[k]:.3f} ms x{e_kernels[k]}" for k in moved))
        del pipe, run, clips, eager, fresh
        torch.cuda.empty_cache()
    return rows, launches


def cli_annotation(vid=7, n_frames=10, n_cats=80):
    """One video of ``n_frames`` frames at 480x640 (files missing: the
    CLI's gray fallback) with three ground-truth tracks, in the schema
    both the serving CLI and the evaluators read."""
    neg, nel = [4, 5], [6]
    images = [{"id": 100 + i, "video_id": vid, "frame_index": i,
               "file_name": f"smoke/v7/{i:05d}.jpg", "width": W,
               "height": H, "neg_category_ids": neg,
               "not_exhaustive_category_ids": nel} for i in range(n_frames)]
    tracks, anns = [], []
    for t in range(3):
        tracks.append({"id": t + 1, "category_id": t + 1, "video_id": vid})
        for i, im in enumerate(images):
            box = [40.0 + 150 * t + 6 * i, 60.0 + 4 * i, 120.0, 90.0]
            anns.append({"id": len(anns) + 1, "image_id": im["id"],
                         "video_id": vid, "track_id": t + 1,
                         "category_id": t + 1, "bbox": box,
                         "area": box[2] * box[3], "iscrowd": 0,
                         "visibility": 0.3 * t + 0.05 * i,
                         "out_of_frame": i % 4 == 0})
    return {
        "info": {"description": "chip_smoke CLI annotation"},
        "videos": [{"id": vid, "name": "smoke/v7", "width": W,
                    "height": H, "neg_category_ids": neg,
                    "not_exhaustive_category_ids": nel}],
        "images": images,
        "categories": [{"id": c + 1, "name": f"class{c + 1}",
                        "frequency": "rcf"[c % 3]} for c in range(n_cats)],
        "annotations": anns, "tracks": tracks,
    }


def phase_cli(torch, wrappers, extra_args, kernels):
    """The inference CLI at its defaults (ResNet-50, 512^2, T=8) plus
    ``extra_args``, on one video of 10 frames at 480x640 (two clips, the
    last padded), under torch.profiler: each of ``kernels`` must launch
    (counted by kernel name, :data:`KERNEL_NAMES`: the CLI replays one
    CUDA graph a clip, which the Python counts do not see) and the trace
    must hold one graph launch a clip.  Then the same CLI with its
    captured function replaced by eager ``streaming``: the records must
    agree (integers equal, boxes and scores within the bounds of
    :func:`outputs_agree`).  Returns the annotation and the records the
    CLI wrote."""
    import tao_amodal_torch.pipeline as pipeline_mod
    from tao_amodal_torch.cli.infer_cli import main as infer_main

    ann = cli_annotation()
    vid, n_cats = ann["videos"][0]["id"], len(ann["categories"])
    clips = -(-len(ann["images"]) // T)
    with tempfile.TemporaryDirectory() as tmp:
        ann_path = os.path.join(tmp, "annotation.json")
        with open(ann_path, "w") as f:
            json.dump(ann, f)

        def cli(name):
            out_path = os.path.join(tmp, name)
            records = infer_main([
                "--annotation", ann_path, "--images_dir",
                os.path.join(tmp, "frames"), "--output", out_path,
                "--score_threshold", "0.0", "--device", "cuda",
                *extra_args])
            with open(out_path) as f:
                check(json.load(f) == records,
                      "CLI wrote other records than it returned")
            return records

        records, _, _, _, kernels_seen, _, graph_launches, _ = profile_run(
            torch, lambda: cli("predictions.json"))
        real = pipeline_mod.make_streaming_fn
        pipeline_mod.make_streaming_fn = lambda p, score_thr: (
            lambda clip, state: p.streaming(clip, state,
                                            score_thr=score_thr))
        try:
            eager = cli("eager.json")
        finally:
            pipeline_mod.make_streaming_fn = real
    launches = {k: kernel_launches(kernels_seen, KERNEL_NAMES[k])
                for k in kernels}
    check(all(launches.values()),
          f"CLI {extra_args} did not launch every kernel of its path: "
          f"{launches}")
    check(graph_launches == clips, f"CLI {extra_args}: {graph_launches} "
          f"graph launches for {clips} clips")
    check(len(records) > 0, "CLI wrote no records")
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
    check(len(eager) == len(records)
          and all(a[k] == b[k] for a, b in zip(records, eager)
                  for k in ("image_id", "category_id", "track_id",
                            "video_id")),
          f"CLI {extra_args}: records differ in an integer from eager "
          f"streaming's")
    # Record boxes are in source pixels (divided by the letterbox scale,
    # 0.8) and give w and h as differences: twice the pixel bound.
    d_box = max(abs(u - v) - BOX_RTOL * abs(v) for a, b in zip(records, eager)
                for u, v in zip(a["bbox"], b["bbox"]))
    d_score = max(abs(a["score"] - b["score"])
                  for a, b in zip(records, eager))
    check(d_box <= 2 * BOX_ATOL and d_score <= SCORE_ATOL,
          f"CLI {extra_args}: records beyond the bounds of eager "
          f"streaming's: bbox {d_box:.3e}, score {d_score:.3e}")
    log(f"CLI {extra_args}: {len(records)} records over "
        f"{len({r['image_id'] for r in records})} frames, "
        f"{len({r['track_id'] for r in records})} tracks, "
        + ("identical to" if records == eager else
           f"bbox within {d_box:.3e} px + rtol {BOX_RTOL}, scores within "
           f"{d_score:.3e} of")
        + f" the records of eager streaming; {graph_launches} graph "
        f"launches; launches by kernel name (warm-up and replays) "
        f"{launches}")
    return ann, records


class LoopTimer:
    """Stands in for ``greedy_match_torch`` in an evaluator module:
    synchronizes around each call and sums its wall time, and keeps the
    largest call's arguments (on the host) to profile it again."""

    def __init__(self, torch, fn):
        self.torch, self.fn = torch, fn
        self.seconds, self.calls, self.slots = 0.0, 0, 0
        self.largest = None

    def __call__(self, *args, **kwargs):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.slots += args[0].shape[-2]
        size = out[0].numel()
        if self.largest is None or size > self.largest[0]:
            host = lambda x: x.cpu() if torch.is_tensor(x) else x  # noqa
            self.largest = (size, [host(a) for a in args],
                            {k: host(v) for k, v in kwargs.items()})
        return out

    def profile(self, dev):
        """(wall ms, device busy ms, shape) of the largest call rerun
        under ``torch.profiler``."""
        torch = self.torch
        _, args, kwargs = self.largest
        dev_of = lambda x: x.to(dev) if torch.is_tensor(x) else x  # noqa
        args = [dev_of(a) for a in args]
        kwargs = {k: dev_of(v) for k, v in kwargs.items()}
        wall, busy = idle_share(torch, lambda: self.fn(*args, **kwargs))
        return wall, busy, tuple(args[0].shape)


def eval_metrics_agree(host, dev, what, atol):
    check(list(host) == list(dev), f"{what}: metric keys differ")
    worst = max(abs(host[k] - dev[k]) for k in host)
    bad = {k: (host[k], dev[k]) for k in host
           if not abs(host[k] - dev[k]) < atol}
    check(not bad, f"{what}: card vs host beyond {atol}: {bad}")
    return worst


def phase_eval(torch, dev, wrappers, cli_run, card):
    """The evaluation path: the device evaluators on the card against
    the float64 host evaluators, at reference scale, then the eval CLI
    on the inference CLI's own predictions.  Returns nothing; fails on
    any disagreement."""
    import tao_amodal_torch.evaluation.batched as batched_mod
    import tao_amodal_torch.evaluation.device_detection as det_mod
    from fixture_gen import make_fixture
    from torch_port_eval_fixtures import threshold_fixture
    from tao_amodal_torch.cli.eval_cli import main as eval_main
    from tao_amodal_torch.data.results import make_track_ids_unique
    from tao_amodal_torch.evaluation import (
        AmodalDetectionEvaluator,
        DeviceDetectionEval,
        DeviceTrackEval,
        TrackMapEvaluator,
    )

    t0 = time.perf_counter()
    gt, preds = make_fixture(**EVAL_FIXTURE)
    make_track_ids_unique(preds)
    log(f"eval fixture {EVAL_FIXTURE}: {len(gt['videos'])} videos, "
        f"{len(gt['annotations'])} gt annotations, {len(preds)} "
        f"predictions, {len(gt['categories'])} categories "
        f"({time.perf_counter() - t0:.1f} s to make)")

    def run(cls, *args, **kw):
        ev = cls(copy.deepcopy(gt), copy.deepcopy(preds), *args, **kw)
        t = time.perf_counter()
        ev.run()
        return ev.get_results(), time.perf_counter() - t

    for name, dev_cls, host_cls, args, mod in (
            ("Track-mAP", DeviceTrackEval, TrackMapEvaluator, (),
             batched_mod),
            ("detection AP", DeviceDetectionEval, AmodalDetectionEvaluator,
             ("bbox",), det_mod)):
        host, host_s = run(host_cls, *args)
        timer = LoopTimer(torch, mod.greedy_match_torch)
        mod.greedy_match_torch = timer
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            (got, dev_s), launches = counted(
                torch, wrappers, lambda: run(dev_cls, *args, device=dev))
        finally:
            mod.greedy_match_torch = timer.fn
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        check(not any(launches.values()),
              f"{name}: the evaluation path launched a kernel: {launches}")
        worst = eval_metrics_agree(host, got, name, EVAL_ATOL)
        check(host["AP50"] > 0.05, f"{name}: AP50 {host['AP50']} on "
              f"jittered gt is too low to show a flipped match")
        wall, busy, shape = timer.profile(dev)
        log(f"eval {name} ({card}): card {dev_s:.2f} s, host (float64, "
            f"CPU) {host_s:.2f} s; peak device memory {peak:.1f} MiB; "
            f"greedy loop {timer.seconds:.2f} s = "
            f"{100 * timer.seconds / dev_s:.1f} % of the card run over "
            f"{timer.calls} chunks, {timer.slots} detection slots; its "
            f"largest "
            f"chunk {shape}: {wall:.2f} ms wall, "
            + (f"{busy:.2f} ms device busy ({100 * (1 - busy / wall):.1f}"
               f" % idle)" if busy is not None else "no device events")
            + f"; AP {got['AP']:.6f} AP50 {got['AP50']:.6f}, max "
            f"|card - host| {worst:.3e} over {len(host)} metrics")

    phase_eval_segm(torch, dev, wrappers, gt, preds, card)

    # tests/test_device_tolerance.py's contract on the card.
    with tempfile.TemporaryDirectory() as tmp:
        for on in (True, False):
            g, d = threshold_fixture(on)
            make_track_ids_unique(d)
            paths = [os.path.join(tmp, f"{n}{on}.json") for n in "gd"]
            for path, obj in zip(paths, (g, d)):
                with open(path, "w") as f:
                    json.dump(obj, f)
            h = TrackMapEvaluator(*paths)
            h.run()
            c = DeviceTrackEval(*paths, device=dev)
            c.run()
            h, c = h.get_results(), c.get_results()
            drift = max(abs(h[k] - c[k]) for k in h)
            check(0.05 < drift <= 0.30 if on else drift < 1e-9,
                  f"threshold fixture (on={on}): drift {drift}")
            log(f"eval threshold fixture, IoUs {'on' if on else 'off'} "
                f"the thresholds: max |card - host| {drift:.3e}")

        # The inference CLI's own predictions through the eval CLI.
        ann, records = cli_run
        gt_path = os.path.join(tmp, "annotation.json")
        pred_path = os.path.join(tmp, "predictions.json")
        with open(gt_path, "w") as f:
            json.dump(ann, f)
        with open(pred_path, "w") as f:
            json.dump(records, f)
        logs = []
        for extra in ([], ["--device_eval", "--device", str(dev)]):
            out = os.path.join(tmp, f"eval{len(logs)}.log")
            eval_main(["--track_result", pred_path, "--output_log", out,
                       "--annotation", gt_path, *extra])
            with open(out) as f:
                logs.append(f.read())
    check(logs[0] == logs[1],
          "eval CLI: the --device_eval log differs from the host log")
    copypaste = [ln for ln in logs[0].splitlines() if "copypaste:" in ln]
    check(len(copypaste) == 4, f"eval CLI log: {copypaste}")
    log(f"eval CLI on the inference CLI's {len(records)} records: host and "
        f"--device_eval logs identical; {copypaste[1]}; {copypaste[3]}")


def phase_eval_segm(torch, dev, wrappers, gt, preds, card):
    """segm evaluation at the bbox phase's scale: every gt annotation and
    prediction of the fixture given the triangle of its box as its
    segmentation (``tests/test_device_eval.py:102-107``), rasterized by
    the port's RLE codec; Track-mAP and detection AP with ``"segm"`` on
    the host (float64, CPU) and with the device evaluators on the card
    (mask IoU on the host through the codec, the matching cells on the
    card), every metric within EVAL_ATOL of the host's.  Printed: each
    one's wall s and the host share of the card run (its mask IoU,
    timed around ``_segm_ious``)."""
    from tao_amodal_torch.evaluation import (
        AmodalDetectionEvaluator,
        DeviceDetectionEval,
        DeviceTrackEval,
        TrackMapEvaluator,
    )

    gt, preds = copy.deepcopy(gt), copy.deepcopy(preds)
    for ann in gt["annotations"] + preds:
        x, y, w, h = ann["bbox"]
        ann["segmentation"] = [[x, y, x, y + h, x + w, y + h]]

    def run(cls, *args, **kw):
        ev = cls(copy.deepcopy(gt), copy.deepcopy(preds), *args, **kw)
        t = time.perf_counter()
        ev.run()
        return ev.get_results(), time.perf_counter() - t

    for name, dev_cls, host_cls, args, kw in (
            ("Track-mAP", DeviceTrackEval, TrackMapEvaluator, (),
             dict(iou_type="segm")),
            ("detection AP", DeviceDetectionEval, AmodalDetectionEvaluator,
             ("segm",), {})):
        host, host_s = run(host_cls, *args, **kw)
        # The mask IoU's wall time, summed around the method (static on
        # one evaluator, bound on the other).
        original = inspect.getattr_static(dev_cls, "_segm_ious")
        fn, spent = dev_cls._segm_ious, [0.0]

        def timed(*a, fn=fn, spent=spent):
            t0 = time.perf_counter()
            out = fn(*a)
            spent[0] += time.perf_counter() - t0
            return out

        dev_cls._segm_ious = (staticmethod(timed)
                              if isinstance(original, staticmethod)
                              else timed)
        try:
            (got, dev_s), launches = counted(
                torch, wrappers, lambda: run(dev_cls, *args, device=dev,
                                             **kw))
        finally:
            dev_cls._segm_ious = original
        check(not any(launches.values()),
              f"segm {name}: the evaluation path launched a kernel: "
              f"{launches}")
        worst = eval_metrics_agree(host, got, f"segm {name}", EVAL_ATOL)
        check(host["AP50"] > 0.05, f"segm {name}: AP50 {host['AP50']}")
        log(f"eval segm {name} ({card}): card {dev_s:.2f} s, of which the "
            f"mask IoU on the host {spent[0]:.2f} s "
            f"({100 * spent[0] / dev_s:.1f} %); host (float64, CPU) "
            f"{host_s:.2f} s; AP {got['AP']:.6f} AP50 {got['AP50']:.6f}, "
            f"max |card - host| {worst:.3e} over {len(host)} metrics")


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
    # The seeded scene and chain inputs come from the tests' fixtures.
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
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
    base = ("preprocess_frames", "prroi_packed", "nms_keep_mask")
    try:
        phase_build()
        rows = phase_kernels(torch, dev)
        phase_gradients(torch, dev)
        launches, (pipe, fused, unfused_outs) = phase_pipeline(
            torch, dev, wrappers)
        phase_batched(torch, dev, wrappers, pipe, fused)
        rows["auction_assign"] = phase_auction(torch, dev, pipe, [
            (o["visible_boxes"], o["scores"] > 0.0) for o in unfused_outs])
        del pipe, fused, unfused_outs
        launches.update(phase_stage_stacks(torch, dev, wrappers))
        bf16_rows, bf16_launches = phase_bf16_serving(torch, dev, wrappers)
        rows.update(bf16_rows)
        launches.update(bf16_launches)
        int8_rows, int8_launches = phase_int8(torch, dev, wrappers)
        rows.update(int8_rows)
        launches.update(int8_launches)
        captured_rows, captured_launches = phase_captured(torch, dev,
                                                          wrappers)
        rows.update(captured_rows)
        launches.update(captured_launches)
        phase_small_reference(torch, dev, wrappers, TINY)
        phase_small_reference(torch, dev, wrappers, TINY_FUSED)
        phase_small_batched(torch, dev, wrappers)
        phase_small_s2d(torch, dev, wrappers)
        cli_run = phase_cli(torch, wrappers, [], base + ("greedy_fixpoint",))
        phase_cli(torch, wrappers, ["--fused_stages", "1,2,3,4"],
                  base + ("fused_bottleneck_chain", "greedy_fixpoint"))
        phase_cli(torch, wrappers, ["--assignment", "gated_auction"],
                  base + ("auction_assign",))
        card = card_line()
        phase_eval(torch, dev, wrappers, cli_run, card)
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
