"""GTR-style clip detector: ResNet + FPN + RPN + RoI box head.

Port of :mod:`tao_amodal_tpu.models.detector`, in f32 or bf16, with the
``classic``, ``s2d`` and ``s2d_pre`` stems.  ``int8_backbone=True``
raises NotImplementedError (ROADMAP.md, Queue A #5) rather than compute
something else.  The JAX version ``vmap``s a per-frame function over the
clip; here the T frames ride the batch axis of every op, with no Python
loop over frames: per-frame top-k, NMS and gathers are batched along
dim 0.

Layouts at the boundary follow the JAX module: the clip is NHWC
``[T, H, W, 3]`` (``[T, H/4, W/4, 48]`` for ``s2d_pre``); pooled RoI
features are NHWC ``[T*R, 7, 7, C]`` and flatten in (y, x, c) order,
exactly as Flax's ``Dense_0`` expects, so its kernel needs no row
permutation in the weight bridge.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from tao_amodal_torch.models import layers
from tao_amodal_torch.models.backbones import STEMS, ResNet
from tao_amodal_torch.models.fpn import FPN
from tao_amodal_torch.models.rpn import (
    RPNHead,
    decode_deltas,
    level_anchors,
    select_proposals,
)
from tao_amodal_torch.ops.nms import class_aware_nms
from tao_amodal_torch.ops.roi import multilevel_roi_align

# cuDNN convolutions default to TF32 in PyTorch; the detector computes
# the f32 function of the JAX reference (``ClipDetector.apply``).
ALLOW_TF32 = False

POOLINGS = ("auto", "packed", "fused")
DTYPES = (torch.float32, torch.bfloat16)


@contextlib.contextmanager
def _tf32(allow):
    """TF32 of cuDNN convolutions and of matmuls set to ``allow`` inside,
    the caller's settings restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class RoIBoxHead(nn.Module):
    """2-fc box head: class logits + class-agnostic box deltas, computed
    in ``dtype`` (all three outputs in it)."""

    def __init__(self, in_features, num_classes, features=1024,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(in_features, features)
        self.Dense_1 = nn.Linear(features, features)
        self.Dense_2 = nn.Linear(features, num_classes + 1)
        self.Dense_3 = nn.Linear(features, 4)

    def forward(self, pooled):  # [R, s, s, C]
        dt = self.dtype
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(layers.dense(x, self.Dense_0, dt))
        x = F.relu(layers.dense(x, self.Dense_1, dt))
        return (layers.dense(x, self.Dense_2, dt),
                layers.dense(x, self.Dense_3, dt), x)


class ClipDetector(nn.Module):
    """Per-frame detector applied to a clip.

    ``forward`` returns fixed-size tensors per frame: ``boxes [T, D, 4]``
    (xyxy), ``scores [T, D]``, ``classes [T, D]`` (-1 where empty),
    ``roi_features [T, D, 1024]``.

    Options of the JAX module:

    - ``dtype`` (``torch.float32`` or ``torch.bfloat16``): the trunk,
      FPN, RPN and box head compute at the JAX modules' rounding points
      (:mod:`tao_amodal_torch.models.layers`); proposals, their scores
      and the decoded boxes are f32, the detection scores and RoI
      features bf16, as in JAX.
    - ``stem``: ``"classic"`` (7x7/2 conv and max-pool), ``"s2d"`` (the
      4x4 space-to-depth fold and a 3x3 conv) or ``"s2d_pre"`` (the clip
      comes folded, ``[T, H/4, W/4, 48]``, from
      ``AmodalPipeline.preprocess``; boxes and proposal clipping use the
      unfolded image size, :meth:`image_hw_of`).
    - ``pooling`` (``"auto"``, ``"packed"`` or ``"fused"``) picks the
      JAX module's RoI pooling route.  In f32 the routes compute one
      function, through kernel B2 on a CUDA tensor and its plain version
      on a CPU tensor.  In bf16 they are different functions, as in JAX:
      ``"fused"`` is B2's (the x weights rounded to bf16, the sum in f32,
      a bf16 output) and ``"packed"`` the XLA ``prroi_pool``'s (both
      weights and the first contraction rounded, an f32 output), which
      the port computes in plain PyTorch on either device.  ``"auto"`` is
      B2's route on both devices: on the card that is what JAX's
      ``"auto"`` picks on its accelerator, while JAX on the CPU picks
      ``"packed"``.  ``pallas_pooling`` pools through kernel B5 instead
      (JAX's round-2 kernel: in bf16 both weights and each column's y-sum
      rounded).  The port has no backward yet (ROADMAP.md, Queue B #6).
    - ``exact_topk``: the port's proposal top-k (``torch.topk``) is
      exact either way; the JAX ``approx_max_k`` is approximate only on
      a TPU.
    - ``int8_backbone=True`` raises NotImplementedError (Queue A #5).
    """

    anchor_scales = (32, 64, 128, 256, 512)
    anchor_ratios = (0.5, 1.0, 2.0)
    strides = (8, 16, 32, 64, 128)

    def __init__(self, num_classes=80, features=256, num_dets=64,
                 num_proposals=96, pre_nms_topk=100,
                 backbone_stages=(3, 4, 6, 3), out_size=7,
                 fused_stages=(), pallas_pooling=False, pooling="auto",
                 exact_topk=False, dtype=torch.float32,
                 int8_backbone=False, stem="classic"):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"pooling must be one of {POOLINGS}, got "
                             f"{pooling!r}")
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
        if int8_backbone:
            raise NotImplementedError(
                "int8_backbone=True: the int8 trunk is not ported "
                "(ROADMAP.md, Queue A #5)")
        if stem not in STEMS:
            raise ValueError(f"unknown stem: {stem!r}")
        self.dtype = dtype
        self.stem = stem
        self.pooling = pooling
        self.exact_topk = exact_topk
        self.num_classes = num_classes
        self.num_dets = num_dets
        self.num_proposals = num_proposals
        self.pre_nms_topk = pre_nms_topk
        self.out_size = out_size
        # pallas_pooling: pool through kernel B5 (the JAX detector's
        # round-2 Pallas kernel) instead of B2; the same function.
        self.pallas_pooling = pallas_pooling
        # fused_stages: trunk stages run through the fused bottleneck
        # chain (kernel B4) at inference; () = plain convolutions.
        self.backbone = ResNet(stage_sizes=tuple(backbone_stages),
                               out_stages=(2, 3, 4),
                               fused_stages=tuple(fused_stages),
                               stem=stem, dtype=dtype)
        self.fpn = FPN(self.backbone.out_channels(), features,
                       num_extra_levels=2, dtype=dtype)
        self.rpn = RPNHead(num_anchors=len(self.anchor_ratios),
                           features=features, dtype=dtype)
        self.box_head = RoIBoxHead(out_size * out_size * features,
                                   num_classes, dtype=dtype)
        self._anchors = {}

    def anchors(self, level_hw, device):
        """Per-level anchors for one pyramid geometry (cached: every
        clip of a video shares it)."""
        key = (tuple(level_hw), str(device))
        if key not in self._anchors:
            self._anchors[key] = [
                level_anchors(h, w, s, [sc], self.anchor_ratios, device)
                for (h, w), s, sc in zip(level_hw, self.strides,
                                         self.anchor_scales)]
        return self._anchors[key]

    def image_hw_of(self, clip):
        """The image size of ``clip`` (``s2d_pre`` clips are 4x
        folded)."""
        h, w = clip.shape[1:3]
        return (h * 4, w * 4) if self.stem == "s2d_pre" else (h, w)

    def pool_rois(self, pyramid, rois):
        """P3-P6 packed-canvas PrRoI pooling with the canonical 224^2
        RoI at P4 (index 1), by the route ``pooling`` and
        ``pallas_pooling`` pick (kernel B5, B2, or JAX's ``prroi_pool``
        in bf16 for ``"packed"``).  ``pyramid`` levels are NCHW; the
        canvas is built from their NHWC views."""
        if self.pallas_pooling:
            method = "prroi_packed_pallas"
        elif self.pooling == "packed":
            method = "prroi_packed"
        else:
            method = "prroi_packed_fused"
        return multilevel_roi_align(
            [p.permute(0, 2, 3, 1) for p in pyramid[:4]], rois,
            out_size=self.out_size, canonical_level=1,
            strides=self.strides[:4], method=method)

    def forward(self, clip):
        with _tf32(ALLOW_TF32):
            return self._forward(clip)

    def features_for(self, clip):
        """The P3..P7 pyramid (NCHW levels) of an NHWC ``clip``."""
        return self.fpn(self.backbone(clip.permute(0, 3, 1, 2)))

    def _forward(self, clip):
        return self.detect(self.features_for(clip), self.image_hw_of(clip))

    def detect(self, pyramid, image_hw):
        """Proposals, pooling, box head and NMS on a pyramid (JAX's
        ``_frame_detect``, batched over the frames)."""
        T = pyramid[0].shape[0]
        objs, deltas = self.rpn(pyramid)
        anchors = self.anchors([o.shape[1:3] for o in objs],
                               pyramid[0].device)
        props, prop_scores = select_proposals(
            objs, deltas, anchors, image_hw,
            pre_nms_topk=self.pre_nms_topk,
            post_nms_topk=self.num_proposals)          # [T, R, 4], [T, R]

        pooled = self.pool_rois(pyramid, props)       # [T, R, 7, 7, C]
        R = props.shape[1]
        logits, box_deltas, feats = self.box_head(
            pooled.reshape(T * R, *pooled.shape[2:]))
        probs = layers.softmax(logits)[:, 1:].reshape(T, R, -1)
        boxes = decode_deltas(props, box_deltas.reshape(T, R, 4))
        feats = feats.reshape(T, R, -1)

        scores = probs * (prop_scores > 0)[..., None]
        best_scores, cls_ids = scores.max(dim=-1)
        keep = class_aware_nms(boxes, best_scores, cls_ids, 0.5,
                               self.num_dets)          # [T, D]
        valid = keep >= 0
        safe = keep.clamp_min(0)

        def take(x):
            idx = safe.reshape(T, -1, *([1] * (x.dim() - 2)))
            return torch.gather(x, 1, idx.expand(T, -1, *x.shape[2:]))

        return {
            "boxes": take(boxes) * valid[..., None],
            "scores": torch.where(valid, take(best_scores), 0.0),
            "classes": torch.where(valid, take(cls_ids), -1),
            "roi_features": take(feats) * valid[..., None],
        }
