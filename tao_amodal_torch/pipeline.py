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
``pallas_pooling`` pools RoIs through kernel B5 instead of B2;
``int8_backbone`` runs the int8 trunk (its convs through the int8 conv
kernel of ``ops/int8_conv.py``).  Outputs
serialize with the prediction-JSON functions at the bottom.

Serving on the card: :func:`make_inference_fn`, :func:`make_streaming_fn`
and :func:`make_batched_fn` are the counterparts of the JAX package's
jitted clip programs: each captures the clip's device work once per
input geometry as a CUDA graph (``utils/graphs.py``) and replays it per
clip; the inference CLI serves through :func:`make_streaming_fn`.
:func:`make_sharded_inference` and :func:`make_sharded_streaming` spread
videos over the ranks of a :mod:`tao_amodal_torch.parallel` mesh, one
lane a data rank, each through its own :func:`make_batched_fn` graph
(the CLI's ``--data_parallel`` gives each rank the single stream over
its share of the videos instead: no rank waits for another, so it needs
no lockstep lanes).

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
from tao_amodal_torch.utils import graphs, weights


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
        :class:`ClipDetector`'s (what each computes is documented
        there)."""
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

    def _track(self, out, assoc_boxes, sort_state):
        """SORT over the clip's frames: ``out`` gains the track ids and
        keeps the reported detections valid."""
        sort_state, (track_ids, reported) = self._associate(
            sort_state, assoc_boxes, out["valid"])
        out["track_ids"] = track_ids                # [T, D]
        out["valid"] = out["valid"] & reported
        return out, sort_state

    @torch.no_grad()
    def streaming(self, clip, sort_state, score_thr=0.05):
        """Clip -> (tracked amodal detections, updated SORT state).

        Thread ``sort_state`` across the clips of one video to keep track
        ids continuous past clip boundaries.  Outputs are ``[T, D]``
        (boxes ``[T, D, 4]`` xyxy) tensors on the pipeline's device.
        :func:`make_streaming_fn` serves the same function from a CUDA
        graph.
        """
        with _tf32(ALLOW_TF32):
            return self._track(*self._detect(clip, score_thr), sort_state)

    def forward(self, clip, score_thr=0.05):
        """Full clip -> tracked amodal detections, fresh tracker."""
        out, _ = self.streaming(clip, self.init_tracker_state(),
                                score_thr=score_thr)
        return out

    def _fresh_states(self, videos):
        """Fresh SORT states of ``videos`` videos as one
        :class:`SortState` with a leading axis (what :meth:`batched`
        starts from when given none)."""
        fresh = [self.init_tracker_state() for _ in range(videos)]
        return SortState(*map(torch.stack, zip(*fresh)))

    def _detect_batch(self, clips, score_thr):
        """:meth:`_detect` over B videos' clips folded into one ``[B*T]``
        frame batch, outputs unfolded to ``[B, T, ...]``."""
        B, T = clips.shape[:2]
        out, assoc_boxes = self._detect(
            clips.reshape(B * T, *clips.shape[2:]), score_thr)
        out = {k: v.reshape(B, T, *v.shape[1:]) for k, v in out.items()}
        return out, assoc_boxes.reshape(B, T, *assoc_boxes.shape[1:])

    def _track_batch(self, out, assoc_boxes, sort_states):
        """:meth:`_track` per video of a clip batch."""
        states, ids, reported = [], [], []
        for b in range(assoc_boxes.shape[0]):
            state, (i, r) = self._associate(
                SortState(*(f[b] for f in sort_states)),
                assoc_boxes[b], out["valid"][b])
            states.append(state)
            ids.append(i)
            reported.append(r)
        out["track_ids"] = torch.stack(ids)          # [B, T, D]
        out["valid"] = out["valid"] & torch.stack(reported)
        return out, SortState(*map(torch.stack, zip(*states)))

    @torch.no_grad()
    def batched(self, clips, sort_states=None, score_thr=0.05):
        """B videos' preprocessed clips ``[B, T, S, S, 3]`` at once.

        The detector and the expander are per frame, so the B and T axes
        fold into one ``[B*T]`` frame batch; SORT, which is sequential
        in frames, runs per video (``sort_scan(impl="auto")`` with the
        pipeline's assignment on each video's ``[T, D]`` slice).  The
        int8 trunk quantizes the folded ``[B*T]`` batch with one scale
        per conv, as JAX's ``batched`` does.

        Returns (outputs with a leading B axis, the SORT states as one
        :class:`SortState` whose every field has a leading B axis, the
        layout of the JAX package's vmapped states).  ``sort_states=None``
        starts every video fresh (:meth:`_fresh_states`); thread the
        returned states across consecutive clip batches of the same
        videos, as in :meth:`streaming`: but for the int8 trunk this
        equals B :meth:`streaming` calls.  :func:`make_batched_fn`
        serves the same function from a CUDA graph.
        """
        if sort_states is None:
            sort_states = self._fresh_states(clips.shape[0])
        with _tf32(ALLOW_TF32):
            return self._track_batch(
                *self._detect_batch(clips, score_thr), sort_states)


def _serve(detect, track, score_thr):
    """``serve(clips, states) -> (outputs, states)`` = ``track(*detect(
    clips, score_thr), states)`` under ``torch.no_grad()`` with TF32
    off, the whole step served from CUDA graphs whatever the assignment
    (NMS's, the greedy assignment's and the auction's rounds all loop on
    the card).  ``serve.captured`` is the :class:`graphs.CapturedFn` (its
    graphs and capture times)."""
    def step(clips, states):
        with torch.no_grad(), _tf32(ALLOW_TF32):
            return track(*detect(clips, score_thr), states)

    captured = graphs.capture(step)

    def serve(clips, states):
        return captured(clips, states)

    serve.captured = captured
    return serve


def make_streaming_fn(pipeline, score_thr=0.05):
    """:meth:`AmodalPipeline.streaming` as one program per clip geometry,
    the counterpart of the JAX CLI's ``jax.jit`` of ``streaming``:
    ``run(clip, sort_state) -> (outputs, sort_state)``, equal to
    ``pipeline.streaming(clip, sort_state, score_thr)``.

    On the card the first call at a clip geometry warms the clip up and
    captures it as a CUDA graph (seconds at full width); every later
    call copies the clip and the state into the graph's static buffers
    and replays it.  The graph holds the whole clip, whatever
    ``sort_assignment``: the detector, the expander and SORT's frames,
    whose NMS and greedy rounds (``csrc/fixpoint.cu``) or auction rounds
    (``csrc/auction.cu``) loop on the card.  The graphs hold the
    pipeline's weights as they were at capture: make a new function after
    loading others.  A CPU pipeline runs eagerly.
    """
    return _serve(pipeline._detect, pipeline._track, score_thr)


def make_batched_fn(pipeline, score_thr=0.05):
    """:meth:`AmodalPipeline.batched` as one program per clip-batch
    geometry (the program JAX's ``bench.py`` jits for ``--videos > 1``):
    ``run(clips, sort_states=None) -> (outputs, sort_states)``, served as
    :func:`make_streaming_fn` serves ``streaming``; ``sort_states=None``
    starts every video fresh (made eagerly, then copied in)."""
    run = _serve(pipeline._detect_batch, pipeline._track_batch, score_thr)

    def batched(clips, sort_states=None):
        if sort_states is None:
            sort_states = pipeline._fresh_states(clips.shape[0])
        return run(clips, sort_states)

    batched.captured = run.captured
    return batched


def make_inference_fn(pipeline):
    """The counterpart of JAX's ``make_inference_fn(pipeline,
    variables)``: ``run(clip) -> outputs``, ``pipeline(clip)`` with a
    fresh tracker and the default score threshold, one CUDA graph per
    clip geometry (:func:`make_streaming_fn`).  ``clip`` is preprocessed
    (:meth:`AmodalPipeline.preprocess` stays outside the graph, as JAX's
    CLI preprocesses outside its jit)."""
    run = make_streaming_fn(pipeline)

    def infer(clip):
        return run(clip, pipeline.init_tracker_state())[0]

    infer.captured = run.captured
    return infer


def _check_lane_device(pipeline, mesh):
    if pipeline.device != mesh.device:
        raise ValueError(f"the pipeline lies on {pipeline.device}, this "
                         f"rank's lanes on {mesh.device}")


def make_sharded_inference(pipeline, mesh):
    """Serving spread over the ranks of ``mesh``, stateless: this rank
    serves its lane ``clips [1, T, S, S, 3]`` (preprocessed; JAX's ``[B,
    ...]`` batch is every data rank's lane, ``mesh.shape['data']`` = B)
    through its own :func:`make_batched_fn` graph on its device, a fresh
    tracker a call (JAX's ``vmap`` of ``pipeline(variables, c)``), with
    no collective: videos are independent.  ``run(clips) -> outputs``,
    each with the leading lane axis.  Make ``pipeline`` on
    ``mesh.device``."""
    _check_lane_device(pipeline, mesh)
    batched = make_batched_fn(pipeline)

    def run(clips):
        return batched(clips)[0]

    run.captured = batched.captured
    return run


def make_sharded_streaming(pipeline, mesh, score_thr=0.05):
    """Serving spread over the ranks of ``mesh`` with state: one lane a
    data rank, the lane's SORT state threaded across its video's clips
    (JAX's ``make_sharded_streaming``).  Each rank serves its lane
    through its own :func:`make_batched_fn` graph (one CUDA graph a clip
    geometry on its card), with no collective.

    Returns ``(init_states, run)``:
      - ``init_states() -> states``: a fresh lane state (a
        :class:`SortState` with a leading lane axis of 1); make one a
        group of videos, as the single stream resets at every video;
      - ``run(clips, states) -> (outputs, states)``: this rank's lane
        ``clips [1, T, S, S, 3]`` (preprocessed); every output carries
        the leading lane axis.
    """
    _check_lane_device(pipeline, mesh)
    batched = make_batched_fn(pipeline, score_thr)

    def init_states():
        return pipeline._fresh_states(1)

    def run(clips, states):
        if clips.shape[0] != 1:
            raise ValueError(f"a rank serves one lane, got "
                             f"{clips.shape[0]} clips")
        return batched(clips, states)

    run.captured = batched.captured
    return init_states, run


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
