"""Detector + expander training loss (the detector's train step).

Port of :mod:`tao_amodal_tpu.train.detector_loss`: sigmoid-BCE
objectness and smooth-L1 deltas for the RPN against per-anchor matched
gt (IoU matching, each valid gt's best anchor forced positive); softmax
CE and smooth-L1 box refinement for the RoI head on teacher-forced
proposals (the gt boxes, two jittered copies, one random box per gt
slot); L1 between the Amodal Expander's box and the gt amodal box on the
box head's fc features, the tensor inference hands the expander.

JAX ``vmap``s a per-frame loss over the batch; here the frames ride
dim 0 of every op and each term keeps JAX's means: per frame first (with
``n_pos`` and ``n_neg`` clamped at 1), then over the frames.  The
jitter is an argument (:func:`roi_noise` draws it), so a caller can feed
JAX's own draws.  The trunk runs in f32 with TF32 off, as inference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from tao_amodal_torch.models.detector import ALLOW_TF32, _tf32
from tao_amodal_torch.models.rpn import encode_deltas

TERMS = ("rpn_obj", "rpn_reg", "roi_cls", "roi_box", "expander_l1")
# The profiler range of the trunk's forward.
TRUNK_RANGE = "train:trunk_forward"


def _iou_xyxy(a, b):
    """IoU of xyxy ``a [..., N, 4]`` with ``b [..., G, 4]`` -> ``[..., N,
    G]`` (leading axes broadcast); 0 where the union is empty."""
    x0 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y0 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x1 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y1 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x1 - x0).clamp_min(0) * (y1 - y0).clamp_min(0)
    aa = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    bb = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    union = aa + bb - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-9), 0.0)


def smooth_l1(x, beta=1.0 / 9):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax ** 2 / beta, ax - 0.5 * beta)


def _take(x, idx):
    """``x [B, G, ...]`` gathered along dim 1 at ``idx [B, N]`` ->
    ``[B, N, ...]``."""
    shape = idx.shape + x.shape[2:]
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(shape))


def force_best_anchors(pos, best_anchor, gt_valid):
    """JAX's ``pos.at[best_anchor].set(where(gt_valid, True,
    pos[best_anchor]))`` per frame: ``pos [B, N]``, ``best_anchor [B, G]``.

    Several gts can name one anchor (an invalid gt's row is all -1, so
    its best anchor is anchor 0); the scatter on JAX's CPU applies the
    updates in gt order, so the last gt to name an anchor decides it:
    an invalid gt after a valid one writes the old ``pos`` back."""
    G = best_anchor.shape[1]
    value = gt_valid | torch.gather(pos, 1, best_anchor)          # [B, G]
    same = best_anchor[:, :, None] == best_anchor[:, None, :]     # [B, G, G]
    later = torch.ones(G, G, dtype=torch.bool,
                       device=pos.device).triu(diagonal=1)
    last = ~(same & later).any(-1)                                # [B, G]
    anchor = torch.arange(pos.shape[1], device=pos.device)
    hit = (anchor[None, :, None] == best_anchor[:, None, :]) & last[:, None]
    return torch.where(hit.any(-1), (hit & value[:, None]).any(-1), pos)


def rpn_loss(objs, deltas, anchors_per_level, gt_boxes, gt_valid,
             pos_thr=0.7, neg_thr=0.3):
    """RPN losses of each frame over all levels.

    Args:
      objs, deltas: per level ``[B, H, W, A]`` and ``[B, H, W, 4A]``
        (NHWC, the order of the anchors).
      anchors_per_level: per level ``[H*W*A, 4]``.
      gt_boxes ``[B, G, 4]``, gt_valid ``[B, G]``.

    Returns ``(obj_loss [B], reg_loss [B])``.
    """
    B = gt_boxes.shape[0]
    anchors = torch.cat(list(anchors_per_level))
    obj = torch.cat([o.reshape(B, -1) for o in objs], 1)
    delta = torch.cat([d.reshape(B, -1, 4) for d in deltas], 1)

    iou = _iou_xyxy(anchors, gt_boxes)                  # [B, N, G]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_iou, best_gt = iou.max(dim=2)
    pos = force_best_anchors(best_iou >= pos_thr, iou.argmax(dim=1),
                             gt_valid)
    neg = (best_iou < neg_thr) & ~pos

    target = pos.to(obj.dtype)
    bce = (obj.clamp_min(0) - obj * target
           + torch.log1p(torch.exp(-obj.abs())))
    n_pos = pos.sum(1).clamp_min(1)
    n_neg = neg.sum(1).clamp_min(1)
    obj_loss = (bce * pos).sum(1) / n_pos + (bce * neg).sum(1) / n_neg

    target_deltas = encode_deltas(anchors, _take(gt_boxes, best_gt))
    reg = smooth_l1(delta - target_deltas).sum(-1)
    return obj_loss, (reg * pos).sum(1) / n_pos


def roi_noise(B, G, image_hw, generator):
    """The loss's random draws for ``B`` frames of ``G`` gt slots, on the
    generator's device: ``jit_a``, ``jit_b`` (standard normal ``[B, G,
    4]``, the two jittered copies' noise), ``rand_xy`` (uniform in
    ``[0, 0.8 W) x [0, 0.8 H)``) and ``rand_wh`` (uniform in ``[8, 0.2 W)
    x [8, 0.2 H)``), ``[B, G, 2]`` each, the random boxes' corners and
    sizes."""
    H, W = image_hw
    dev = generator.device

    def uniform(lo, hi_w, hi_h):
        u = torch.rand((B, G, 2), generator=generator, device=dev)
        return torch.stack([u[..., 0] * (hi_w - lo) + lo,
                            u[..., 1] * (hi_h - lo) + lo], dim=-1)

    return {
        "jit_a": torch.randn((B, G, 4), generator=generator, device=dev),
        "jit_b": torch.randn((B, G, 4), generator=generator, device=dev),
        "rand_xy": uniform(0.0, W * 0.8, H * 0.8),
        "rand_wh": uniform(8.0, W * 0.2, H * 0.2),
    }


def roi_proposals(gt, noise, image_hw):
    """The teacher-forced proposals ``[B, 4G, 4]``: the gt boxes, two
    jittered copies (0.10 and 0.25 of the box size) and one random box a
    gt slot, clipped to the image."""
    H, W = image_hw
    wh = torch.cat([gt[..., 2:] - gt[..., :2]] * 2, dim=-1)
    jit_a = gt + 0.10 * noise["jit_a"] * wh
    jit_b = gt + 0.25 * noise["jit_b"] * wh
    xy = noise["rand_xy"]
    rand_box = torch.cat([xy, xy + noise["rand_wh"]], dim=-1)
    props = torch.cat([gt, jit_a, jit_b, rand_box], dim=1)
    return torch.stack([props[..., 0].clamp(0, W), props[..., 1].clamp(0, H),
                        props[..., 2].clamp(0, W), props[..., 3].clamp(0, H)],
                       dim=-1)


def detector_train_loss(detector, expander, batch, noise):
    """Composite loss over a batch of frames.

    Args:
      detector: a :class:`~tao_amodal_torch.models.detector.ClipDetector`.
      expander: an :class:`~tao_amodal_torch.models.amodal_expander.
        AmodalExpander`.
      batch: tensors on the model's device: ``images [B, H, W, 3]``,
        ``gt_boxes [B, G, 4]`` (xyxy visible), ``gt_amodal [B, G, 4]``,
        ``gt_classes [B, G]``, ``gt_valid [B, G]``.
      noise: :func:`roi_noise` of ``(B, G, (H, W))``.

    Returns ``(total, {"rpn_obj", "rpn_reg", "roi_cls", "roi_box",
    "expander_l1"})``, 0-d tensors.
    """
    images = batch["images"]
    gt, gt_valid = batch["gt_boxes"], batch["gt_valid"]
    B, H, W = images.shape[:3]
    with _tf32(ALLOW_TF32):
        with record_function(TRUNK_RANGE):
            feats = detector.backbone(images.permute(0, 3, 1, 2))
        pyramid = detector.fpn(feats)
        objs, deltas = detector.rpn(pyramid)
        anchors = detector.anchors([o.shape[1:3] for o in objs],
                                   images.device)
        obj_losses, reg_losses = rpn_loss(objs, deltas, anchors, gt,
                                          gt_valid)

        # RoI box head + expander on the teacher-forced proposals, labels
        # by IoU >= 0.5 (class 0 = background), pooled by the inference
        # method (ClipDetector.pool_rois).
        props = roi_proposals(gt, noise, (H, W))
        R = props.shape[1]
        iou = _iou_xyxy(props, gt)
        iou = torch.where(gt_valid[:, None, :], iou, -1.0)
        best_iou, best_gt = iou.max(dim=2)
        pos = best_iou >= 0.5
        labels = torch.where(pos, _take(batch["gt_classes"], best_gt), 0)

        pooled = detector.pool_rois(pyramid, props)
        logits, bdeltas, fc = detector.box_head(
            pooled.reshape(B * R, *pooled.shape[2:]))
        logp = F.log_softmax(logits.to(torch.float32), dim=-1)
        ce = -torch.gather(logp, 1, labels.reshape(-1, 1).long())
        cls_losses = ce.reshape(B, R).mean(1)

        tgt = encode_deltas(props, _take(gt, best_gt))
        box_l1 = smooth_l1(bdeltas.to(torch.float32).reshape(B, R, 4)
                           - tgt).sum(-1)
        n_pos = pos.sum(1).clamp_min(1)
        box_losses = (box_l1 * pos).sum(1) / n_pos

        amodal, _ = expander(fc.reshape(B, R, -1), props, (H, W))
        l1 = (amodal - _take(batch["gt_amodal"], best_gt)).abs().sum(-1)
        exp_losses = (l1 * pos).sum(1) / n_pos

    terms = [t.mean() for t in (obj_losses, reg_losses, cls_losses,
                                box_losses, exp_losses)]
    obj_loss, reg_loss, cls_loss, box_loss, exp_loss = terms
    total = obj_loss + reg_loss + cls_loss + box_loss + 0.1 * exp_loss
    return total, dict(zip(TERMS, terms))
