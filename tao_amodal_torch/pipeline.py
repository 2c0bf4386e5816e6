"""Flagship pipeline: detect -> amodal-expand -> associate, on device.

Port of :mod:`tao_amodal_tpu.pipeline` (single-stream and multi-video
serving): a clip ``[T, H, W, 3]`` runs through the :class:`ClipDetector`
with the T frames as one batch, the :class:`AmodalExpander` widens
visible boxes to amodal ones (``use_expander=False`` reports the visible
boxes instead), and SORT associates frame by frame
(``ops/sort_scan.py::sort_scan`` with ``impl="auto"``, the per-frame
loop, with the pipeline's ``sort_assignment``) on the visible boxes
(``sort_on='visible'``) while the amodal boxes are reported.
:meth:`AmodalPipeline.batched` folds B videos' clips into one ``[B*T]``
frame batch and runs SORT per video.  ``fused_stages`` routes trunk
stages through the fused bottleneck chain (kernel B4);
``pallas_pooling`` pools RoIs through kernel B5 instead of B2.  Outputs
serialize with the prediction-JSON functions at the bottom.

Numerics: the serving default is full float32.  cuDNN convolutions
default to TF32 in PyTorch (``torch.backends.cudnn.allow_tf32``), which
keeps ~3 decimal digits; :meth:`AmodalPipeline.preprocess`,
:meth:`AmodalPipeline.streaming`, :meth:`AmodalPipeline.batched` and
:meth:`ClipDetector.forward` turn TF32 off for convolutions and matmuls
while they run (``ALLOW_TF32``), so the port computes what the f32 JAX
reference computes.  ``dtype=torch.bfloat16`` computes the JAX
package's bf16 pipeline (the configuration its benchmark serves, with
``stem="s2d_pre"``): the detector and the expander at the JAX modules'
rounding points, SORT in f32 on the f32 visible boxes; the scores and
the expander's deltas come out bf16, boxes f32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tao_amodal_torch.models.amodal_expander import AmodalExpander
from tao_amodal_torch.models.detector import ALLOW_TF32, ClipDetector, _tf32
from tao_amodal_torch.ops.preproc import preprocess_clip, preprocess_clip_s2d
from tao_amodal_torch.ops.sort_scan import sort_scan
from tao_amodal_torch.trackers.sort import (
    SortState,
    check_assignment,
    init_sort,
)
from tao_amodal_torch.utils import weights


class AmodalPipeline(nn.Module):
    """Detector + expander (the weights) and the SORT settings.

    Submodules are named ``detector`` and ``expander``, the top-level
    keys of the JAX pipeline's variables, so a ``save_pytree`` checkpoint
    of those variables loads with :meth:`load`, whatever
    ``use_expander`` says (the expander's weights exist either way).

    SORT: ``sort_max_age`` / ``sort_min_hits`` are the track lifecycle
    (the JAX pipeline's defaults 5 and 1 keep tracks through short
    misses and report from the first hit); ``sort_assignment`` is
    ``"greedy"`` (the default), ``"gated_auction"`` or ``"auction"``
    (``trackers/sort.py::sort_step``); ``sort_on`` picks the boxes SORT
    associates (``"visible"``: the detector's; ``"amodal"``: the
    reported ones).
    """

    def __init__(self, detector, expander, sort_max_age=5, sort_min_hits=1,
                 sort_assignment="greedy", use_expander=True,
                 sort_on="visible"):
        super().__init__()
        if sort_on not in ("visible", "amodal"):
            raise ValueError(f"sort_on must be 'visible' or 'amodal', "
                             f"got {sort_on!r}")
        check_assignment(sort_assignment)
        self.detector = detector
        self.expander = expander
        self.sort_max_age = sort_max_age
        self.sort_min_hits = sort_min_hits
        self.sort_assignment = sort_assignment
        self.use_expander = use_expander
        self.sort_on = sort_on

    @staticmethod
    def create(num_classes=80, num_dets=64, dtype=torch.float32,
               backbone_stages=(3, 4, 6, 3), num_proposals=96,
               pallas_pooling=False, int8_backbone=False,
               stem="classic", exact_topk=False,
               sort_max_age=5, sort_min_hits=1,
               sort_assignment="greedy", pre_nms_topk=100,
               pooling="auto", fused_stages=(), use_expander=True,
               sort_on="visible", device="cuda"):
        """Build the pipeline (uninitialised weights) on ``device``; call
        :meth:`init` or :meth:`load` next.  The JAX ``create``'s
        arguments, in its order, plus ``device``: the card by default
        (without one this raises unless ``device="cpu"``).  ``dtype``,
        ``int8_backbone``, ``stem``, ``pooling`` and ``exact_topk`` are
        :class:`ClipDetector`'s (what each computes, and which raise,
        is documented there)."""
        pipe = AmodalPipeline(
            ClipDetector(num_classes=num_classes, num_dets=num_dets,
                         num_proposals=num_proposals,
                         pre_nms_topk=pre_nms_topk,
                         backbone_stages=backbone_stages,
                         fused_stages=fused_stages,
                         pallas_pooling=pallas_pooling, pooling=pooling,
                         exact_topk=exact_topk, dtype=dtype,
                         int8_backbone=int8_backbone, stem=stem),
            AmodalExpander(dtype=dtype), sort_max_age=sort_max_age,
            sort_min_hits=sort_min_hits, sort_assignment=sort_assignment,
            use_expander=use_expander, sort_on=sort_on)
        return pipe.to(device).eval()

    @property
    def device(self):
        return next(self.parameters()).device

    def init(self, generator):
        """Seeded random weights (Flax's default initialisers)."""
        weights.random_init_(self, generator)
        return self

    def load(self, path):
        """Weights from a ``save_pytree`` npz of the JAX pipeline's
        variables (``{"detector": ..., "expander": ...}``)."""
        weights.load_into(self, weights.load_flat(path))
        return self

    def preprocess(self, frames, out_size=512):
        """uint8 frames ``[T, H, W, 3]`` (tensor) -> (clip, scale): the
        letterboxed ``[T, Sh, Sw, 3]`` f32 clip (``out_size`` an int or
        ``(Sh, Sw)``), or for the ``s2d_pre`` stem its space-to-depth
        fold ``[T, Sh/4, Sw/4, 48]`` in the detector's dtype."""
        if self.detector.stem == "s2d_pre":
            with _tf32(ALLOW_TF32):
                return preprocess_clip_s2d(frames, out_size=out_size,
                                           dtype=self.detector.dtype)
        return preprocess_clip(frames, out_size=out_size)

    def init_tracker_state(self):
        """Fresh SORT state (reset at every video boundary)."""
        return init_sort(max_tracks=2 * self.detector.num_dets,
                         device=self.device)

    def _detect(self, clip, score_thr):
        """Detector and expander over the frames of ``clip``: (the
        outputs without track ids, the boxes SORT associates)."""
        det = self.detector(clip)
        if self.use_expander:
            amodal, _ = self.expander(det["roi_features"], det["boxes"],
                                      self.detector.image_hw_of(clip))
        else:
            amodal = det["boxes"]
        out = {
            "boxes": amodal,                      # [N, D, 4] xyxy amodal
            "visible_boxes": det["boxes"],        # [N, D, 4]
            "scores": det["scores"],              # [N, D]
            "classes": det["classes"],            # [N, D]
            "valid": det["scores"] > score_thr,
        }
        return out, det["boxes"] if self.sort_on == "visible" else amodal

    def _associate(self, sort_state, boxes, valid):
        return sort_scan(sort_state, boxes, valid,
                         max_age=self.sort_max_age,
                         min_hits=self.sort_min_hits,
                         assignment=self.sort_assignment)

    @torch.no_grad()
    def streaming(self, clip, sort_state, score_thr=0.05):
        """Clip -> (tracked amodal detections, updated SORT state).

        Thread ``sort_state`` across the clips of one video to keep track
        ids continuous past clip boundaries.  Outputs are ``[T, D]``
        (boxes ``[T, D, 4]`` xyxy) tensors on the pipeline's device.
        """
        with _tf32(ALLOW_TF32):
            out, assoc_boxes = self._detect(clip, score_thr)
            sort_state, (track_ids, reported) = self._associate(
                sort_state, assoc_boxes, out["valid"])
        out["track_ids"] = track_ids                # [T, D]
        out["valid"] = out["valid"] & reported
        return out, sort_state

    def forward(self, clip, score_thr=0.05):
        """Full clip -> tracked amodal detections, fresh tracker."""
        out, _ = self.streaming(clip, self.init_tracker_state(),
                                score_thr=score_thr)
        return out

    @torch.no_grad()
    def batched(self, clips, sort_states=None, score_thr=0.05):
        """B videos' preprocessed clips ``[B, T, S, S, 3]`` at once.

        The detector and the expander are per frame, so the B and T axes
        fold into one ``[B*T]`` frame batch; SORT, which is sequential
        in frames, runs per video (``sort_scan(impl="auto")`` with the
        pipeline's assignment on each video's ``[T, D]`` slice).

        Returns (outputs with a leading B axis, the SORT states as one
        :class:`SortState` whose every field has a leading B axis, the
        layout of the JAX package's vmapped states).  ``sort_states=None``
        starts every video fresh; thread the returned states across
        consecutive clip batches of the same videos, as in
        :meth:`streaming`: this equals B :meth:`streaming` calls.
        """
        B, T = clips.shape[:2]
        if sort_states is None:
            fresh = [self.init_tracker_state() for _ in range(B)]
            sort_states = SortState(*map(torch.stack, zip(*fresh)))
        with _tf32(ALLOW_TF32):
            out, assoc_boxes = self._detect(
                clips.reshape(B * T, *clips.shape[2:]), score_thr)
            out = {k: v.reshape(B, T, *v.shape[1:]) for k, v in out.items()}
            assoc_boxes = assoc_boxes.reshape(B, T, *assoc_boxes.shape[1:])
            states, ids, reported = [], [], []
            for b in range(B):
                state, (i, r) = self._associate(
                    SortState(*(f[b] for f in sort_states)),
                    assoc_boxes[b], out["valid"][b])
                states.append(state)
                ids.append(i)
                reported.append(r)
        out["track_ids"] = torch.stack(ids)          # [B, T, D]
        out["valid"] = out["valid"] & torch.stack(reported)
        return out, SortState(*map(torch.stack, zip(*states)))


def _host(outputs, keys):
    """numpy copies of ``outputs[k]`` (bf16 tensors as f32, which holds
    them exactly)."""
    def host(v):
        if not torch.is_tensor(v):
            return np.asarray(v)
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return np.asarray(v.cpu())
    return [host(outputs[k]) for k in keys]


def detections_to_json(outputs, image_ids, video_id, class_id_map=None,
                       track_id_base=0, track_key_map=None):
    """Clip outputs -> prediction-JSON records, one eval track per
    (SORT track, class) when ``track_key_map`` is given (see
    ``tao_amodal_tpu/pipeline.py::detections_to_json``)."""
    boxes, scores, classes, tracks, valid = _host(
        outputs, ("boxes", "scores", "classes", "track_ids", "valid"))
    records = []
    for t, img_id in enumerate(image_ids):
        for d in np.nonzero(valid[t])[0]:
            x0, y0, x1, y1 = boxes[t, d]
            cat = int(classes[t, d])
            if class_id_map is not None:
                cat = class_id_map.get(cat, cat)
            if track_key_map is None:
                local = int(tracks[t, d])
            else:
                key = (int(tracks[t, d]), cat)
                local = track_key_map.setdefault(key, len(track_key_map))
            records.append({
                "image_id": int(img_id),
                "category_id": cat,
                "bbox": [float(x0), float(y0), float(x1 - x0),
                         float(y1 - y0)],
                "score": float(scores[t, d]),
                "track_id": local + track_id_base,
                "video_id": int(video_id),
            })
    return records


def video_detections_to_json(clips, video_id, class_id_map=None,
                             track_id_base=0):
    """Whole-video emission with one score-weighted majority class per
    SORT track (the GTR output contract).

    Args:
      clips: list of ``(outputs, image_ids)`` pairs, every clip of one
        video in order, SORT state threaded; ``image_ids`` of -1 mark
        padded frames.
    """
    host = [(_host(o, ("boxes", "scores", "classes", "track_ids",
                       "valid")), ids) for o, ids in clips]
    votes = {}
    for (_, scores, classes, tracks, valid), image_ids in host:
        for t in range(len(image_ids)):
            if image_ids[t] == -1:
                continue
            for d in np.nonzero(valid[t])[0]:
                v = votes.setdefault(int(tracks[t, d]), {})
                cat = int(classes[t, d])
                v[cat] = v.get(cat, 0.0) + float(scores[t, d])
    track_class = {k: max(v.items(), key=lambda kv: kv[1])[0]
                   for k, v in votes.items()}

    records = []
    for (boxes, scores, _, tracks, valid), image_ids in host:
        for t, img_id in enumerate(image_ids):
            if img_id == -1:
                continue
            for d in np.nonzero(valid[t])[0]:
                x0, y0, x1, y1 = boxes[t, d]
                cat = track_class[int(tracks[t, d])]
                if class_id_map is not None:
                    cat = class_id_map.get(cat, cat)
                records.append({
                    "image_id": int(img_id),
                    "category_id": cat,
                    "bbox": [float(x0), float(y0), float(x1 - x0),
                             float(y1 - y0)],
                    "score": float(scores[t, d]),
                    "track_id": int(tracks[t, d]) + track_id_base,
                    "video_id": int(video_id),
                })
    return records
