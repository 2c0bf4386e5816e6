"""Clip-level SORT association: the per-frame loop, or kernel B3.

Port of :mod:`tao_amodal_tpu.ops.pallas.sort_scan` (``sort_scan``,
``sort_scan_pallas``).  ``impl="auto"`` is the plain version, the loop
of :func:`tao_amodal_torch.trackers.sort.sort_step` over the clip's
frames (what ``AmodalPipeline.streaming`` runs).  ``impl="pallas"``
keeps the JAX name so that a call site ports verbatim: a CPU state takes
the plain version, a CUDA state launches the kernel (or this raises).

Kernel: ``csrc/sort_scan.cu`` replaces the TPU kernel
``sort_scan_pallas`` (``_sort_scan_kernel``): the whole clip's
association in one launch with no host sync, one block of 512 threads
per SORT state.  It gates the benefits at ``iou_threshold`` before the
greedy rounds, which leaves every integer output unchanged (the kernel
source says why) and cuts the rounds to the longest chain of competing
overlaps.  It reads and writes the ``SortState`` tensors directly; the
TPU kernel's lane-packed layout does not carry over.

``sort_scan`` defaults to greedy association, as the JAX ``sort_scan``
does.  ``impl="auto"`` runs any of ``sort_step``'s three assignments;
``impl="pallas"`` computes greedy only and raises ValueError for an
auction (the JAX kernel runs greedy whatever it is asked for), so the
port never runs an association other than the one asked for.
"""

from __future__ import annotations

import torch

from tao_amodal_torch import _build
from tao_amodal_torch.trackers.sort import (
    SortState,
    check_assignment,
    sort_step,
)


def sort_scan_torch(state: SortState, boxes, valid, *, max_age=1,
                    min_hits=3, iou_threshold=0.3, assignment="greedy"):
    """Plain version: :func:`sort_step` frame by frame.

    Args:
      state: :class:`SortState` (K slots).
      boxes: ``[T, D, 4]`` xyxy per-frame detections (padded).
      valid: ``[T, D]`` bool.

    Returns ``(new_state, (det_track_id [T, D] int32, det_report
    [T, D] bool))``.
    """
    ids, report = [], []
    for t in range(boxes.shape[0]):
        state, out = sort_step(state, boxes[t], valid[t], max_age=max_age,
                               min_hits=min_hits,
                               iou_threshold=iou_threshold,
                               assignment=assignment)
        ids.append(out["det_track_id"])
        report.append(out["det_report"])
    return state, (torch.stack(ids), torch.stack(report))


def _want(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"sort_scan_pallas: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def sort_scan_pallas(state: SortState, boxes, valid, *, max_age=1,
                     min_hits=3, iou_threshold=0.3):
    """Kernel wrapper (same contract as :func:`sort_scan_torch`)."""
    dev = state.x.device
    if dev.type == "cpu":
        return sort_scan_torch(state, boxes, valid, max_age=max_age,
                               min_hits=min_hits,
                               iou_threshold=iou_threshold)
    if dev.type != "cuda":
        raise ValueError(f"sort_scan_pallas: unsupported device {dev}")
    K = state.x.shape[0]
    T, D = boxes.shape[:2]
    if any(t.device != dev for t in (*state, boxes, valid)):
        raise ValueError(f"sort_scan_pallas: state, boxes and valid must "
                         f"all be on {dev}")
    # The state, the benefit and the per-slot and per-detection arrays
    # live in one block's shared memory (227 KB).
    lib = _build.library()
    smem = lib.tao_sort_scan_smem(D, K)
    if not 0 <= smem <= 227 * 1024:
        raise ValueError(f"sort_scan_pallas: K={K}, D={D} exceed the "
                         f"kernel's bounds (K, D <= its 512 threads, "
                         f"shared memory <= 227 KB)")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    fields = (
        _want("x", state.x, f32, (K, 7)),
        _want("P", state.P, f32, (K, 7, 7)),
        _want("alive", state.alive, b8, (K,)),
        _want("track_id", state.track_id, i32, (K,)),
        _want("hits", state.hits, i32, (K,)),
        _want("hit_streak", state.hit_streak, i32, (K,)),
        _want("age", state.age, i32, (K,)),
        _want("time_since_update", state.time_since_update, i32, (K,)),
        _want("next_id", state.next_id, i32, ()),
        _want("frame_count", state.frame_count, i32, ()),
    )
    boxes = _want("boxes", boxes, f32, (T, D, 4))
    valid = _want("valid", valid, b8, (T, D))
    new = [torch.empty_like(f) for f in fields]
    ids = torch.empty((T, D), dtype=i32, device=dev)
    report = torch.empty((T, D), dtype=b8, device=dev)
    err = lib.tao_sort_scan_f32(
        boxes.data_ptr(), valid.data_ptr(),
        *[f.data_ptr() for f in fields], *[f.data_ptr() for f in new],
        ids.data_ptr(), report.data_ptr(), T, D, K, int(max_age),
        int(min_hits), float(iou_threshold),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("tao_sort_scan_f32", err)
    sort_scan_pallas.launches += 1
    return SortState(*new), (ids, report)


sort_scan_pallas.launches = 0


def sort_scan(state: SortState, boxes, valid, *, max_age=1, min_hits=3,
              iou_threshold=0.3, assignment="greedy", impl="auto"):
    """Clip-level SORT association: ``impl="auto"`` runs the per-frame
    loop (:func:`sort_scan_torch`) with ``assignment``,
    ``impl="pallas"`` the whole-clip kernel (:func:`sort_scan_pallas`),
    which is greedy only."""
    if impl not in ("auto", "pallas"):
        raise ValueError(f"sort_scan: impl must be 'auto' or 'pallas', "
                         f"got {impl!r}")
    check_assignment(assignment)
    if impl == "pallas" and assignment != "greedy":
        raise ValueError(f"sort_scan: impl='pallas' (kernel B3) computes "
                         f"greedy association only, got "
                         f"assignment={assignment!r}; use impl='auto'")
    kw = dict(max_age=max_age, min_hits=min_hits,
              iou_threshold=iou_threshold)
    if impl == "auto":
        return sort_scan_torch(state, boxes, valid, assignment=assignment,
                               **kw)
    return sort_scan_pallas(state, boxes, valid, **kw)
