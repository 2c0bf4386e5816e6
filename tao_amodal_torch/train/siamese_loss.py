"""Siamese RPN training losses.

Port of :mod:`tao_amodal_tpu.train.siamese_loss` (the reference's
``pysot/models/loss.py``: ``select_cross_entropy_loss``, cross-entropy
averaged separately over the sampled positives and negatives, and
``weight_l1_loss``, composed as ``cls + lambda * loc``,
``model_builder.py:77-115``; and the SiamMask paper's mask loss, which the
reference leaves as a TODO).  Masked arithmetic over the fixed anchor
grid, one batched op where JAX vmaps a pair's function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def select_cross_entropy(cls_logits, label, pos_weight, neg_weight):
    """Cross-entropy over the sampled anchors, a value a pair ``[B]``.

    ``cls_logits [B, N, 2]`` (bg, fg), ``label [B, N]`` (+1/0/-1; the
    weights carry the sampling), ``pos_weight``/``neg_weight [B, N]``."""
    logp = torch.log_softmax(cls_logits, dim=-1)
    pos_loss = -torch.sum(logp[..., 1] * pos_weight, dim=-1)
    neg_loss = -torch.sum(logp[..., 0] * neg_weight, dim=-1)
    return 0.5 * pos_loss + 0.5 * neg_loss


def weighted_l1(pred_delta, target_delta, pos_weight):
    """L1 on the regression deltas ``[B, N, 4]`` of the positives, a value
    a pair ``[B]``."""
    diff = torch.abs(pred_delta - target_delta)
    return torch.sum(diff.sum(dim=-1) * pos_weight, dim=-1)


def _resize_nearest(x, size):
    """``jax.image.resize(x, (B, size, size), "nearest")`` on ``[B, H,
    W]``: the source index of output ``i`` is ``floor((i + 0.5) * in /
    out)`` in f32, JAX's arithmetic (PyTorch's ``"nearest-exact"``
    rounds the scale first)."""
    def index(n_in):
        i = torch.arange(size, dtype=torch.float32, device=x.device)
        return torch.floor((i + 0.5) * n_in / size).long()

    return x[:, index(x.shape[1])][:, :, index(x.shape[2])]


def select_mask_logistic_loss(mask_logits, gt_mask, pos_weight, stride=8,
                              patch=127, down=2):
    """SiamMask's mask loss: the logistic loss of each response location's
    ``P x P`` mask (``P = (patch + 1) // down``) against the window of the
    downsampled gt mask centred on the location's receptive field,
    averaged over the patch, weighted by ``pos_weight`` and normalized.

    ``mask_logits [B, S, S, P*P]``, ``gt_mask [B, Hs, Ws]`` (binary, in
    search-image coordinates), ``pos_weight [B, S, S]``; a scalar."""
    B, S, _, PP = mask_logits.shape
    P = int(round(PP ** 0.5))
    Hd = gt_mask.shape[1] // down
    g = _resize_nearest(gt_mask.to(mask_logits.dtype), Hd)
    eff_stride = stride // down
    base = int(round(Hd / 2 - (S - 1) / 2 * eff_stride - P / 2))
    span = (S - 1) * eff_stride + P
    pad_lo = max(0, -base)
    pad_hi = max(0, base + span - Hd)
    g = F.pad(g, (pad_lo, pad_hi, pad_lo, pad_hi))
    off = base + pad_lo
    g = g[:, off:off + span, off:off + span]
    # [B, P*P, S*S] -> [B, S, S, P*P] (JAX's patch order: row, column).
    patches = F.unfold(g[:, None], P, stride=eff_stride)
    patches = patches.transpose(1, 2).reshape(B, S, S, PP)
    sign = 2.0 * patches - 1.0
    zero = mask_logits.new_zeros(())
    per_loc = torch.mean(torch.logaddexp(-sign * mask_logits, zero), dim=-1)
    return (torch.sum(per_loc * pos_weight)
            / torch.sum(pos_weight).clamp_min(1e-6))


def siamese_loss(outputs, targets, cls_weight=1.0, loc_weight=1.2,
                 mask_weight=36.0):
    """``(total, {"cls_loss", "loc_loss"[, "mask_loss"]})`` for a batch.

    ``outputs``: the model's ``cls [B, S, S, 2A]`` and ``loc [B, S, S,
    4A]`` (and ``mask``); ``targets``: :func:`~tao_amodal_torch.train.
    anchor_target.assign_anchor_targets`'s ``[B, N]`` tensors in the
    tracker's ``(A, S*S)`` anchor-major order (and ``mask_label [B, Hs,
    Ws]`` for the mask loss)."""
    B, S = outputs["cls"].shape[:2]
    A = outputs["cls"].shape[-1] // 2
    cls = outputs["cls"].reshape(B, S * S, A, 2)
    cls = cls.transpose(1, 2).reshape(B, -1, 2)
    loc = outputs["loc"].reshape(B, S * S, A, 4)
    loc = loc.transpose(1, 2).reshape(B, -1, 4)

    cls_loss = torch.mean(select_cross_entropy(
        cls, targets["label"], targets["pos_weight"], targets["neg_weight"]))
    loc_loss = torch.mean(weighted_l1(loc, targets["delta"],
                                      targets["pos_weight"]))
    total = cls_weight * cls_loss + loc_weight * loc_loss
    stats = {"cls_loss": cls_loss, "loc_loss": loc_loss}

    if "mask" in outputs and "mask_label" in targets:
        # A location's weight: its anchors' largest positive weight.
        pw = targets["pos_weight"].reshape(B, A, S, S).amax(dim=1)
        mask_loss = select_mask_logistic_loss(outputs["mask"],
                                              targets["mask_label"], pw)
        total = total + mask_weight * mask_loss
        stats["mask_loss"] = mask_loss
    return total, stats
