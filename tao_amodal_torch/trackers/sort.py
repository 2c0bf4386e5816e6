"""SORT over a fixed bank of track slots, on device.

Port of :mod:`tao_amodal_tpu.trackers.sort`: Kalman predict/update
batched over ``K`` slots, IoU cost, assignment (greedy, the flagship
pipeline's; the auction, ``sort_step``'s default as in JAX; or the
auction gated at the IoU threshold), max_age / min_hits lifecycle as
masked integer updates, births claiming free slots in rank order, and
the stateful :class:`Sort` wrapper of the reference's host API.

JAX's ``.at[idx].set(..., mode="drop")`` drops writes to an
out-of-range index ``K``; here every such scatter writes into a scratch
row ``K`` that is sliced away afterwards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tao_amodal_torch.ops import kalman
from tao_amodal_torch.ops.boxes import box_iou_xyxy
from tao_amodal_torch.ops.hungarian import (
    NEG,
    auction_assign,
    greedy_assign,
)


class SortState(NamedTuple):
    x: torch.Tensor            # [K, 7] Kalman means
    P: torch.Tensor            # [K, 7, 7] covariances
    alive: torch.Tensor        # [K] bool
    track_id: torch.Tensor     # [K] int32 (global ids, 1-based)
    hits: torch.Tensor         # [K] int32
    hit_streak: torch.Tensor   # [K] int32
    age: torch.Tensor          # [K] int32
    time_since_update: torch.Tensor  # [K] int32
    next_id: torch.Tensor      # [] int32
    frame_count: torch.Tensor  # [] int32


def init_sort(max_tracks=128, device="cuda"):
    """Empty state of ``max_tracks`` slots on ``device`` (the card by
    default: without one this raises unless ``device="cpu"``)."""
    K = max_tracks

    def zeros_i():
        return torch.zeros((K,), dtype=torch.int32, device=device)

    return SortState(
        x=torch.zeros((K, kalman.DIM_X), dtype=torch.float32,
                      device=device),
        P=torch.zeros((K, kalman.DIM_X, kalman.DIM_X), dtype=torch.float32,
                      device=device),
        alive=torch.zeros((K,), dtype=torch.bool, device=device),
        track_id=zeros_i(), hits=zeros_i(), hit_streak=zeros_i(),
        age=zeros_i(), time_since_update=zeros_i(),
        next_id=torch.ones((), dtype=torch.int32, device=device),
        frame_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _scatter(dst, idx, src):
    """``dst.at[idx].set(src, mode="drop")`` for ``idx`` in ``[0, K]``:
    index ``K`` lands in a scratch row that is dropped."""
    buf = torch.cat([dst, dst[:1]])
    buf[idx] = src.to(dst.dtype)
    return buf[:-1]


ASSIGNMENTS = ("auction", "gated_auction", "greedy")


def check_assignment(assignment):
    """Raise ValueError unless ``assignment`` is one of ``ASSIGNMENTS``."""
    if assignment not in ASSIGNMENTS:
        raise ValueError(f"assignment must be one of {ASSIGNMENTS}, got "
                         f"{assignment!r}")


def sort_step(state: SortState, det_boxes, det_valid, max_age=1,
              min_hits=3, iou_threshold=0.3, assignment="auction"):
    """One frame of SORT.

    Args:
      det_boxes: ``[D, 4]`` xyxy detections (padded).
      det_valid: ``[D]`` bool.
      assignment: ``"auction"`` (Hungarian-optimal within ``n *
        eps``, eps 5e-5, the reference's optimal-assignment semantics),
        ``"gated_auction"`` (the auction with eps 1e-3 whose rows retire
        once their best net value falls under ``0.8 * iou_threshold``:
        matches below the gate are dropped anyway, so this takes a
        handful of rounds instead of a price war) or ``"greedy"``
        (parallel mutual-best rounds, the pipeline's default).

    Returns ``(new_state, out)``; ``out`` holds per-detection track ids
    (``[D]`` int32, 0 where no track) and report masks, and per-slot
    boxes, report masks and ids.
    """
    check_assignment(assignment)
    K = state.x.shape[0]
    D = det_boxes.shape[0]
    dev = det_boxes.device
    i32 = torch.int32
    frame_count = state.frame_count + 1

    x_pred, P_pred = kalman.predict(state.x, state.P)
    x_pred = torch.where(state.alive[:, None], x_pred, state.x)
    P_pred = torch.where(state.alive[:, None, None], P_pred, state.P)
    trk_boxes = kalman.state_to_bbox(x_pred)
    age = torch.where(state.alive, state.age + 1, state.age)
    tsu = torch.where(state.alive, state.time_since_update + 1,
                      state.time_since_update)
    hit_streak = torch.where(state.time_since_update > 0, 0,
                             state.hit_streak)

    iou = box_iou_xyxy(det_boxes, trk_boxes)
    benefit = torch.where(det_valid[:, None] & state.alive[None, :], iou,
                          NEG)
    if assignment == "greedy":
        row_to_col = greedy_assign(benefit)
    elif assignment == "gated_auction":
        row_to_col = auction_assign(benefit, eps=1e-3,
                                    floor=0.8 * iou_threshold)
    else:
        row_to_col = auction_assign(benefit)
    matched_det = row_to_col >= 0
    col = row_to_col.clamp_min(0)
    det_ids = torch.arange(D, device=dev)
    good = matched_det & (iou[det_ids, col] >= iou_threshold)

    # Matched measurements into slot order.
    det_for_slot = _scatter(
        torch.full((K,), -1, dtype=torch.long, device=dev),
        torch.where(good, col, K), torch.where(good, det_ids, -1))
    slot_matched = det_for_slot >= 0
    z = kalman.bbox_to_z(det_boxes[det_for_slot.clamp_min(0)])
    x_new, P_new = kalman.update(x_pred, P_pred, z, gate=slot_matched)

    hits = torch.where(slot_matched, state.hits + 1, state.hits)
    hit_streak = torch.where(slot_matched, hit_streak + 1, hit_streak)
    tsu = torch.where(slot_matched, 0, tsu)

    # Death: too long without update.
    alive = state.alive & (tsu <= max_age)

    # Birth: unmatched valid detections claim free slots in rank order.
    unmatched = det_valid & ~good
    free = ~alive
    free_rank = torch.cumsum(free, 0) - 1
    det_rank = torch.cumsum(unmatched, 0) - 1
    n_free = free.sum()
    can_spawn = unmatched & (det_rank < n_free)
    slot_of_rank = _scatter(
        torch.full((K,), K, dtype=torch.long, device=dev),
        torch.where(free, free_rank, K), torch.arange(K, device=dev))
    spawn_slot = slot_of_rank[det_rank.clamp(0, K - 1)]
    spawn_slot = torch.where(can_spawn, spawn_slot, K)

    x_init, P_init = kalman.init_state(det_boxes)
    x_new = _scatter(x_new, spawn_slot,
                     torch.where(can_spawn[:, None], x_init, 0.0))
    P_new = _scatter(P_new, spawn_slot,
                     torch.where(can_spawn[:, None, None], P_init, 0.0))
    new_ids = state.next_id + det_rank.to(i32)
    track_id = _scatter(state.track_id, spawn_slot,
                        torch.where(can_spawn, new_ids, 0))
    ones = can_spawn.to(i32)
    hits = _scatter(hits, spawn_slot, ones)
    hit_streak = _scatter(hit_streak, spawn_slot, ones)
    age = _scatter(age, spawn_slot, torch.zeros_like(ones))
    tsu = _scatter(tsu, spawn_slot, torch.zeros_like(ones))
    alive = _scatter(alive, spawn_slot, can_spawn)
    next_id = state.next_id + can_spawn.sum().to(i32)

    # Reporting rule (reference sort.py:245-248).
    report = alive & (tsu < 1) & ((hit_streak >= min_hits)
                                  | (frame_count <= min_hits))

    det_slot = torch.where(good, col, 0)
    spawn_safe = spawn_slot.clamp_max(K - 1)
    det_track_id = torch.where(good, track_id[det_slot], 0)
    det_track_id = torch.where(can_spawn, track_id[spawn_safe],
                               det_track_id)
    det_report = torch.where(good, report[det_slot], False)
    det_report = torch.where(can_spawn, report[spawn_safe], det_report)

    new_state = SortState(x=x_new, P=P_new, alive=alive,
                          track_id=track_id, hits=hits,
                          hit_streak=hit_streak, age=age,
                          time_since_update=tsu, next_id=next_id,
                          frame_count=frame_count)
    out = {
        "slot_boxes": kalman.state_to_bbox(x_new),
        "slot_report": report,
        "slot_track_id": track_id,
        "det_track_id": det_track_id,
        "det_report": det_report,
    }
    return new_state, out


class Sort:
    """Stateful wrapper with the reference ``Sort``'s host API (numpy in
    and out), on ``device`` (the card by default: without one this
    raises unless ``device="cpu"``).  ``update`` runs :func:`sort_step`
    with its default assignment, the auction."""

    def __init__(self, max_age=1, min_hits=3, iou_threshold=0.3,
                 max_tracks=128, max_dets=64, device="cuda"):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.max_dets = max_dets
        self.state = init_sort(max_tracks, device=device)

    def update(self, dets):
        """dets: ``[N, 5]`` (x1, y1, x2, y2, score) numpy; the first
        ``max_dets`` are used.

        Returns ``[M, 5]`` (x1, y1, x2, y2, track_id) float64 of the
        reporting tracks, like the reference ``Sort.update``.
        """
        dets = np.asarray(dets, np.float32).reshape(-1, 5)
        D = self.max_dets
        boxes = np.zeros((D, 4), np.float32)
        valid = np.zeros((D,), bool)
        n = min(len(dets), D)
        boxes[:n] = dets[:n, :4]
        valid[:n] = True
        dev = self.state.x.device
        self.state, out = sort_step(
            self.state, torch.from_numpy(boxes).to(dev),
            torch.from_numpy(valid).to(dev), max_age=self.max_age,
            min_hits=self.min_hits, iou_threshold=self.iou_threshold)
        rep = out["slot_report"].cpu().numpy()
        bx = out["slot_boxes"].cpu().numpy()[rep]
        ids = out["slot_track_id"].cpu().numpy()[rep]
        if len(bx) == 0:
            return np.empty((0, 5))
        return np.concatenate([bx, ids[:, None].astype(np.float64)],
                              axis=1)
