"""Region Proposal Network head + anchor/proposal machinery.

Port of :mod:`tao_amodal_tpu.models.rpn` (per-level head mode),
batched over the frames of a clip: a shared 3x3 tower per pyramid
level, 1x1 objectness and delta heads, then per-frame top-k per level,
delta decode, clip to the image, and fixpoint NMS down to a fixed
proposal budget.  Every shape is static.

Score order: ``obj.reshape(-1)`` in the JAX version runs over NHWC
``[H, W, A]``, the order of :func:`level_anchors`; the head's NCHW
outputs are permuted to NHWC before flattening.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tao_amodal_torch.models import layers
from tao_amodal_torch.ops.nms import batched_nms, topk_stable


def level_anchors(h, w, stride, scales, ratios, device="cuda"):
    """Anchor grid for one level -> ``[h*w*A, 4]`` xyxy, (y, x, anchor)
    order, on ``device`` (the card by default)."""
    f32 = torch.float32
    scales = torch.as_tensor(scales, dtype=f32, device=device)
    ratios = torch.as_tensor(ratios, dtype=f32, device=device)
    ws = (scales[None, :] * torch.sqrt(1.0 / ratios)[:, None]).reshape(-1)
    hs = (scales[None, :] * torch.sqrt(ratios)[:, None]).reshape(-1)
    cx = (torch.arange(w, dtype=f32, device=device) + 0.5) * stride
    cy = (torch.arange(h, dtype=f32, device=device) + 0.5) * stride
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")  # [h, w]
    boxes = torch.stack([
        cxg[:, :, None] - ws / 2, cyg[:, :, None] - hs / 2,
        cxg[:, :, None] + ws / 2, cyg[:, :, None] + hs / 2,
    ], dim=-1)  # [h, w, A, 4]
    return boxes.reshape(-1, 4)


def decode_deltas(anchors, deltas, clip=4.135):
    """(dx, dy, dw, dh) deltas -> xyxy boxes (Faster R-CNN convention,
    log-scale clamp 4.135)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    dx, dy, dw, dh = deltas.unbind(-1)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw.clamp_max(clip))
    h = ah * torch.exp(dh.clamp_max(clip))
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


class RPNHead(nn.Module):
    """Shared objectness/delta tower applied per pyramid level, computed
    in ``dtype``."""

    def __init__(self, num_anchors=3, features=256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.tower = nn.Conv2d(features, features, 3, padding=1)
        self.obj = nn.Conv2d(features, num_anchors, 1)
        self.delta = nn.Conv2d(features, num_anchors * 4, 1)

    def forward(self, feats):
        """NCHW levels -> (objs ``[B, H, W, A]``, deltas ``[B, H, W,
        4A]``) per level, NHWC."""
        objs, deltas = [], []
        dt = self.dtype
        for x in feats:
            t = F.relu(layers.conv(x, self.tower, dt))
            objs.append(layers.conv(t, self.obj, dt).permute(0, 2, 3, 1))
            deltas.append(layers.conv(t, self.delta, dt).permute(0, 2, 3, 1))
        return objs, deltas


def select_proposals(objs, deltas, anchors_per_level, image_hw,
                     pre_nms_topk=150, post_nms_topk=256, nms_thr=0.7):
    """Batched proposal selection, static shapes.

    Args:
      objs: list of ``[T, H, W, A]`` objectness maps.
      deltas: list of ``[T, H, W, A*4]`` delta maps.
      anchors_per_level: list of ``[H*W*A, 4]`` anchors.

    Returns ``(boxes [T, post_nms_topk, 4], scores [T, post_nms_topk])``
    f32, padded with zero scores (a ``-1`` keep slot takes the last
    candidate's box, as JAX's ``boxes[-1]`` does).  Maps in bf16 keep
    the JAX dtypes: the top-k runs on the bf16 scores (equal values in
    index order, as ``jax.lax.top_k`` breaks the many bf16 ties), the
    bf16 deltas decode against the f32 anchors into f32 boxes, and the
    sigmoid and the NMS run in f32.
    """
    h, w = image_hw
    all_boxes, all_scores = [], []
    for obj, delta, anchors in zip(objs, deltas, anchors_per_level):
        T = obj.shape[0]
        scores = obj.reshape(T, -1)
        k = min(pre_nms_topk, scores.shape[1])
        top_scores, idx = topk_stable(scores, k)      # [T, k]
        d = torch.gather(delta.reshape(T, -1, 4), 1,
                         idx[..., None].expand(T, k, 4))
        boxes = decode_deltas(anchors[idx], d)
        boxes = torch.stack([
            boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
            boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h),
        ], dim=-1)
        all_boxes.append(boxes)
        all_scores.append(top_scores)
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.sigmoid(torch.cat(all_scores, dim=1).to(torch.float32))
    keep = batched_nms(boxes.to(torch.float32), scores, nms_thr,
                       post_nms_topk)
    safe = torch.where(keep >= 0, keep, boxes.shape[1] - 1)
    sel_boxes = torch.gather(boxes, 1, safe[..., None].expand(
        *safe.shape, 4))
    sel_scores = torch.where(keep >= 0, torch.gather(scores, 1, safe), 0.0)
    return sel_boxes, sel_scores
