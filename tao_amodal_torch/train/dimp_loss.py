"""DiMP offline meta-training actor.

Port of :mod:`tao_amodal_tpu.train.dimp_loss` (the capability of the
reference's ``DiMPActor``, ``pytracking/ltr/actors/tracking.py``): for
each training sequence the target filter is optimized on the *train*
frames by Gauss-Newton/CG (:func:`~tao_amodal_torch.models.dimp.
train_filter`) and scored on the *test* frames; the outer loss adds the
response error and the IoUNet's error on jittered test boxes.  The
solver builds its products with ``torch.func.vjp``/``jvp``, which
PyTorch's autograd differentiates, so an outer ``torch.autograd.grad``
of the loss reaches the extractor's and the IoUNet's weights through the
filter optimization, as JAX's meta-gradients do.

JAX vmaps a sequence's loss over the batch; here the extractor runs once
on every train frame and once on every test frame of the batch, and the
solves and IoU terms loop over the sequences.
"""

from __future__ import annotations

import torch

from tao_amodal_torch.models.dimp import classify, train_filter
from tao_amodal_torch.ops.boxes import box_iou_matrix

# The test boxes' jitter (xyxy pixels) whose IoU the IoUNet predicts.
JITTER = ((0.0, 0.0, 0.0, 0.0), (4.0, 4.0, 0.0, 0.0),
          (-6.0, 0.0, 6.0, 0.0), (0.0, -8.0, 0.0, 8.0))


def response_targets(boxes_xyxy, feat_hw, out_hw, image_hw, sigma=2.0):
    """Gaussian response targets ``[N, out_hw, out_hw]`` centred on each
    box of ``boxes_xyxy [N, 4]`` (image coordinates of an ``image_hw``
    image, mapped onto the ``out_hw`` grid).  ``feat_hw`` is unused, as
    in JAX."""
    ih, iw = image_hw
    cx = (boxes_xyxy[:, 0] + boxes_xyxy[:, 2]) / 2 / iw * out_hw
    cy = (boxes_xyxy[:, 1] + boxes_xyxy[:, 3]) / 2 / ih * out_hw
    dev = boxes_xyxy.device
    ys = torch.arange(out_hw, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(out_hw, dtype=torch.float32, device=dev)[None, :]
    return torch.exp(-((ys - cy[:, None, None]) ** 2
                       + (xs - cx[:, None, None]) ** 2) / (2 * sigma ** 2))


def _xywh(b):
    return torch.cat([b[..., :2], b[..., 2:] - b[..., :2]], dim=-1)


def dimp_actor_loss(extractor_fn, iou_net, batch, filter_size=4,
                    num_gn_iters=3, num_cg_iters=5, iou_weight=1.0):
    """Meta-training loss of a batch of sequences.

    Args:
      extractor_fn: ``images [N, S, S, 3] -> feats [N, h, w, C]`` (NHWC),
        differentiable in its weights (e.g. ``make_dimp_extractor(...)[0]
        .with_grad``).
      iou_net: a :class:`~tao_amodal_torch.models.dimp.IoUNet`.
      batch: ``train_images [B, Ntr, S, S, 3]``, ``train_boxes [B, Ntr,
        4]`` (xyxy, image coordinates), ``test_images [B, Nte, S, S, 3]``,
        ``test_boxes [B, Nte, 4]``, tensors on the models' device.

    Returns ``(loss, {"dimp_cls", "dimp_iou"})``, 0-d tensors.
    """
    tr_imgs, te_imgs = batch["train_images"], batch["test_images"]
    B, n_tr, S = tr_imgs.shape[:3]
    n_te = te_imgs.shape[1]
    tr_all = extractor_fn(tr_imgs.reshape(B * n_tr, *tr_imgs.shape[2:]))
    te_all = extractor_fn(te_imgs.reshape(B * n_te, *te_imgs.shape[2:]))
    h, C = tr_all.shape[1], tr_all.shape[-1]
    out_hw = h - filter_size + 1
    scale = h / S
    jitter = torch.tensor(JITTER, device=tr_all.device)

    cls_losses, iou_losses = [], []
    for i in range(B):
        tr_feats = tr_all[i * n_tr:(i + 1) * n_tr]
        te_feats = te_all[i * n_te:(i + 1) * n_te]
        tr_boxes = batch["train_boxes"][i]
        te_boxes = batch["test_boxes"][i]
        tr_labels = response_targets(tr_boxes, h, out_hw, (S, S))
        te_labels = response_targets(te_boxes, h, out_hw, (S, S))
        filt, _ = train_filter(tr_feats, tr_labels,
                               (filter_size, filter_size, C),
                               num_gn_iters=num_gn_iters,
                               num_cg_iters=num_cg_iters)
        resp = classify(te_feats, filt)
        cls_losses.append(torch.mean((resp - te_labels) ** 2))

        # IoUNet: predict the IoU of jittered test boxes with the box.
        mod_vec = iou_net.modulation(tr_feats[0], tr_boxes[0] * scale,
                                     spatial_scale=1.0)
        frames = []
        for feat, box in zip(te_feats, te_boxes):
            cands = box[None] + jitter
            pred = iou_net(feat, mod_vec, cands * scale, spatial_scale=1.0)
            true = box_iou_matrix(_xywh(cands), _xywh(box[None]))[:, 0]
            frames.append(torch.mean((pred - true) ** 2))
        iou_losses.append(torch.mean(torch.stack(frames)))

    cls_loss = torch.mean(torch.stack(cls_losses))
    iou_loss = torch.mean(torch.stack(iou_losses))
    total = cls_loss + iou_weight * iou_loss
    return total, {"dimp_cls": cls_loss, "dimp_iou": iou_loss}


def build_dimp_actor(search_size=288, feat_stride=16,
                     stage_sizes=(3, 4, 6, 3), seed=0, device="cuda"):
    """The meta-trained models on ``device``, seeded: DiMP's extractor
    (:func:`~tao_amodal_torch.trackers.deep_features.make_dimp_extractor`,
    ResNet-50 to layer3 at 288^2 by default) and an IoUNet at its
    defaults over its channels.  Returns ``(extractor_fn, resnet,
    iou_net)``: ``extractor_fn`` differentiates in the ResNet's weights,
    which it runs in inference mode (its BatchNorm on the running
    statistics, as JAX's extractor runs)."""
    from tao_amodal_torch.trackers.deep_features import (
        make_dimp_extractor,
        seeded_iou_net,
    )

    fn, model = make_dimp_extractor(search_size, feat_stride,
                                    stage_sizes=stage_sizes, seed=seed,
                                    device=device)
    iou_net = seeded_iou_net(model.out_channels()[0], seed + 1, device)
    return fn.with_grad, model, iou_net
