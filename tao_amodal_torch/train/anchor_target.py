"""Anchor target assignment for Siamese training, batched on the device.

Port of :mod:`tao_amodal_tpu.train.anchor_target` (the reference's
``AnchorTarget``, ``pysot/datasets/anchor_target.py:15-76``): label the
anchors by IoU against each pair's gt box (positive above ``thr_high``,
negative below ``thr_low``, the rest ignored), keep a random subset of at
most ``num_pos`` positives and ``num_total`` samples in all, and emit the
regression deltas and normalized per-anchor weights.

JAX vmaps one pair's function over the batch and draws its subsampling
noise with ``jax.random`` inside it.  Here one call takes the whole batch
``[B]`` and the draws (:func:`anchor_draws`, two uniforms an anchor and
pair) as an argument, so it is a pure function of them and makes no host
sync: the sort and the cutoffs stay tensors.  The tests pass the uniforms
JAX draws from its keys.
"""

from __future__ import annotations

import torch


def anchor_draws(batch_size, num_anchors, generator=None, device="cuda"):
    """The subsampling noise of :func:`assign_anchor_targets`: ``{"pos",
    "neg"}``, each ``[B, N]`` uniform on [0, 1), drawn from ``generator``
    (on ``device``)."""
    if generator is not None:
        device = generator.device
    shape = (batch_size, num_anchors)
    return {k: torch.rand(shape, generator=generator, device=device)
            for k in ("pos", "neg")}


def iou_cxcywh(anchors, boxes):
    """IoU ``[B, N]`` of ``[N, 4]`` (cx, cy, w, h) anchors against one
    (cx, cy, w, h) box a row of ``boxes [B, 4]``."""
    ax0 = anchors[:, 0] - anchors[:, 2] / 2
    ay0 = anchors[:, 1] - anchors[:, 3] / 2
    ax1 = anchors[:, 0] + anchors[:, 2] / 2
    ay1 = anchors[:, 1] + anchors[:, 3] / 2
    b = boxes[:, :, None]
    bx0, by0 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx1, by1 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp_min(0)
    ih = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp_min(0)
    inter = iw * ih
    union = anchors[:, 2] * anchors[:, 3] + b[:, 2] * b[:, 3] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-9), 0.0)


def _cutoff(score, index):
    """The ``index``-th largest of each row of ``score`` (``index [B]``)."""
    ranked = torch.sort(score, dim=-1, descending=True).values
    return torch.gather(ranked, 1, index[:, None])


def subsample(mask, budget, noise):
    """Keep at most ``budget`` (an int or ``[B]``) of each row's True
    entries, those with the largest ``noise``."""
    score = torch.where(mask, noise, -1.0)
    thresh = torch.clamp(mask.sum(-1), max=budget) - 1
    cut = _cutoff(score, thresh.clamp_min(0))
    return mask & (score >= cut) & (thresh >= 0)[:, None]


def assign_anchor_targets(anchors, gt_boxes, draws, thr_high=0.6,
                          thr_low=0.3, num_pos=16, num_total=64):
    """Targets for a batch of training pairs.

    Args:
      anchors: ``[N, 4]`` (cx, cy, w, h) tensor.
      gt_boxes: ``[B, 4]`` (cx, cy, w, h).
      draws: :func:`anchor_draws`'s ``{"pos", "neg"}`` noise ``[B, N]``.

    Returns a dict of ``[B, N]`` tensors (``delta [B, N, 4]``): ``label``
    (+1 positive, 0 negative, -1 ignored), ``delta`` the regression
    targets, ``pos_weight`` and ``neg_weight`` the normalized sample
    weights, and ``iou``.
    """
    iou = iou_cxcywh(anchors, gt_boxes)
    pos = iou > thr_high
    neg = iou < thr_low

    pos_keep = subsample(pos, num_pos, draws["pos"])
    n_pos = pos_keep.sum(-1)
    neg_budget = num_total - torch.clamp(n_pos, max=num_pos)
    neg_score = torch.where(neg, draws["neg"], -1.0)
    cut_idx = (torch.minimum(neg_budget, neg.sum(-1)) - 1).clamp_min(0)
    neg_keep = (neg & (neg_score >= _cutoff(neg_score, cut_idx))
                & (neg_budget > 0)[:, None])

    label = torch.where(pos_keep, 1, torch.where(neg_keep, 0, -1))

    g = gt_boxes[:, None, :]
    aw = anchors[:, 2].clamp_min(1e-6)
    ah = anchors[:, 3].clamp_min(1e-6)
    delta = torch.stack([
        (g[..., 0] - anchors[:, 0]) / aw,
        (g[..., 1] - anchors[:, 1]) / ah,
        torch.log(g[..., 2].clamp_min(1e-6) / aw),
        torch.log(g[..., 3].clamp_min(1e-6) / ah),
    ], dim=-1)

    pos_weight = pos_keep / n_pos.clamp_min(1)[:, None]
    neg_weight = neg_keep / neg_keep.sum(-1).clamp_min(1)[:, None]
    return {"label": label, "delta": delta, "pos_weight": pos_weight,
            "neg_weight": neg_weight, "iou": iou}
