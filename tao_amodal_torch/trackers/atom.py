"""ATOM: an online CG/GD-trained classifier and IoUNet box refinement.

Port of ``tao_amodal_tpu/trackers/atom.py`` (the reference's
``pytracking/tracker/atom/atom.py``):

  * at the first frame, the joint factorized optimization of the filter
    and a channel projection (``FactorizedConvProblem``), PCA-seeded,
    by Gauss-Newton/CG (``optimizer='cg'``) or gradient descent
    (``'gd'``, ``GradientDescentL2``);
  * the classifier trained from the sample memory alone (raw windowed
    samples; the projection fixed after the first frame);
  * the three-scale search as one batch: one crop gather and one feature
    pass for the three crops;
  * localization with hard-negative, not-found and uncertain flags:
    hard negatives get a boosted learning rate and more CG iterations,
    otherwise the filter is re-trained every ``train_skipping`` frames;
  * optional IoUNet gradient-ascent refinement (shared with DiMP).

A frame makes one host sync (JAX's ``update`` makes one, ``float(score)``):
the box, score and flag come back in one copy, and the flag then picks
the memory and filter updates on the host, as JAX's ``lax.cond`` picks
them on the device.  The frame counter is a Python int.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tao_amodal_torch.models.dimp import refine_box_ascent
from tao_amodal_torch.ops.optimization import (
    gauss_newton_cg,
    gradient_descent_l2,
    tree_leaves,
)
from tao_amodal_torch.trackers import discriminative as disc
from tao_amodal_torch.trackers.base import Tracker
from tao_amodal_torch.trackers.siamrpn import crop_subwindow

f32 = torch.float32


class AtomState(NamedTuple):
    proj: torch.Tensor        # [C, Cc] projection matrix
    filt: torch.Tensor        # [fh, fw, Cc]
    memory: disc.SampleMemory
    labels: torch.Tensor      # [K, S, S] desired responses per sample
    center: torch.Tensor      # [2] (cx, cy) image coords
    size: torch.Tensor        # [2] (w, h)
    avg: torch.Tensor         # [3] channel means for the border fill
    frame: int
    mod_vec: torch.Tensor     # IoUNet modulation vector (or a dummy)


class AtomTracker(Tracker):
    """ATOM over ``feature_fn``: ``crops [B, P, P, 3] -> feats [B, S, S,
    C]`` with ``P = sample_size`` (default ``search_size``: the stride-1
    pixel features, :func:`~tao_amodal_torch.trackers.discriminative.
    pixel_features`).  Deep features set ``sample_size = S * stride``
    (:mod:`~tao_amodal_torch.trackers.deep_features`).

    ``iou_net``: an optional :class:`~tao_amodal_torch.models.dimp.
    IoUNet` for box refinement (``iou_variables``, JAX's flat variables,
    loaded into it where given).  ``optimizer``: ``'cg'`` or ``'gd'``.
    Everything runs on ``device``, the card unless the caller asks for
    the CPU.  JAX's keyword names and defaults.
    """

    def __init__(self, feature_fn=None, iou_net=None, iou_variables=None,
                 search_size=96, sample_size=None, filter_size=15,
                 compressed_dim=8, memory_size=16, search_area_scale=4.0,
                 learning_rate=0.02, hard_negative_learning_rate=0.1,
                 train_skipping=4, cg_iter=4, hard_negative_cg_iter=8,
                 init_gn_iter=4, init_cg_iter=6,
                 scale_factors=(0.97, 1.0, 1.03), optimizer="cg",
                 filter_reg=1e-2, proj_reg=1e-4, target_not_found=0.25,
                 distractor_threshold=0.8, hard_negative_threshold=0.5,
                 device="cuda"):
        if optimizer not in ("cg", "gd"):
            raise ValueError(f"unknown optimizer: {optimizer!r}")
        self.device = torch.device(device)
        self.feature_fn = feature_fn or disc.pixel_features
        if iou_net is not None and iou_variables is not None:
            from tao_amodal_torch.utils.weights import load_variables

            load_variables(iou_net, iou_variables)
        self.iou_net = iou_net
        self.S = search_size
        self.P = sample_size or search_size
        self.fsz = filter_size
        self.cdim = compressed_dim
        self.K = memory_size
        self.area_scale = search_area_scale
        self.lr = learning_rate
        self.hn_lr = hard_negative_learning_rate
        self.train_skipping = train_skipping
        self.cg_iter = cg_iter
        self.hn_cg_iter = hard_negative_cg_iter
        self.init_gn_iter = init_gn_iter
        self.init_cg_iter = init_cg_iter
        self.scales = torch.tensor(scale_factors, dtype=f32).to(self.device)
        self.optimizer = optimizer
        self.filter_reg = filter_reg
        self.proj_reg = proj_reg
        self.target_not_found = target_not_found
        self.distractor_threshold = distractor_threshold
        self.hard_negative_threshold = hard_negative_threshold
        self.window = disc.hann2d((self.S, self.S), self.device)[:, :, None]
        self.state = None
        self.last_flag = None

    # -- model pieces ----------------------------------------------

    def _response(self, feats_win, proj, filt):
        """Windowed feats ``[B, S, S, C]`` -> responses ``[B, S, S]``."""
        return disc.correlate(feats_win @ proj, filt)

    def _label_sigma(self, size_px, crop_sz):
        # sigma proportional to the target size in sample pixels (the
        # reference's output_sigma_factor).
        return 0.25 * torch.sqrt(torch.prod(size_px)) * (self.S / crop_sz)

    def extract(self, image, center, crop_sz, avg):
        """The windowed features of the crops of side ``crop_sz [B]``
        about ``center [2]`` -> ``[B, S, S, C]``."""
        crops = crop_subwindow(image, center.expand(crop_sz.shape[0], 2),
                               crop_sz, self.P, avg)
        return self.feature_fn(crops) * self.window

    # -- init and step ---------------------------------------------

    @torch.no_grad()
    def init_fn(self, image, box_xywh):
        S = self.S
        image = disc.upload(image, self.device)
        box = torch.as_tensor(np.asarray(box_xywh, np.float32)).to(
            self.device)
        center = torch.stack([box[0] + box[2] / 2, box[1] + box[3] / 2])
        size = box[2:4]
        avg = image.to(f32).mean(dim=(0, 1))
        crop_sz = torch.sqrt(torch.prod(size)) * self.area_scale

        crop = crop_subwindow(image, center, crop_sz, self.P, avg)
        aug = disc.augment_init_samples(crop)               # [A, P, P, 3]
        feats = self.feature_fn(aug) * self.window
        A, C = feats.shape[0], feats.shape[-1]

        # PCA-seeded projection (reference init_projection_matrix).
        proj0 = disc.pca_projection(feats, self.cdim)
        sigma = self._label_sigma(size, crop_sz)
        y = disc.gaussian_label(
            (S, S), torch.full((2,), (S - 1) / 2.0, device=self.device),
            sigma)
        labels0 = y.expand(A, S, S)

        # Joint factorized optimization over {filter, projection}.
        filt0 = torch.zeros(self.fsz, self.fsz, self.cdim,
                            device=self.device)
        rf, rp = math.sqrt(self.filter_reg), math.sqrt(self.proj_reg)
        norm = math.sqrt(1.0 * A)

        def residual(p):
            resp = self._response(feats, p["proj"], p["filt"])
            return {"data": (resp - labels0) / norm,
                    "reg_f": rf * p["filt"],
                    "reg_p": rp * (p["proj"] - proj0)}

        params = {"proj": proj0, "filt": filt0}
        if self.optimizer == "gd":
            def loss(p):
                return sum(torch.sum(v ** 2)
                           for v in tree_leaves(residual(p)))

            params = gradient_descent_l2(
                loss, params, num_iters=self.init_gn_iter * self.init_cg_iter,
                step_length=0.1, momentum=0.9)
        else:
            params, _ = gauss_newton_cg(
                residual, params, num_gn_iters=self.init_gn_iter,
                num_cg_iters=self.init_cg_iter)
        proj, filt = params["proj"], params["filt"]

        # The memory holds RAW windowed features; the projection stays
        # fixed after the first frame.
        mem = disc.init_memory(self.K, (S, S, C), feats)
        labels = torch.zeros(self.K, S, S, device=self.device)
        labels[:A] = labels0

        if self.iou_net is not None:
            scale = S / crop_sz
            c = (S - 1) / 2
            box_crop = torch.stack([c - size[0] * scale / 2,
                                    c - size[1] * scale / 2,
                                    c + size[0] * scale / 2,
                                    c + size[1] * scale / 2])
            mod = self.iou_net.modulation(feats[0], box_crop,
                                          spatial_scale=1.0)
        else:
            mod = torch.zeros(1, device=self.device)
        return AtomState(proj, filt, mem, labels, center, size, avg, 1, mod)

    @torch.no_grad()
    def locate(self, state, image):
        """Classify, localize and refine on one frame: ``(the chosen
        scale's windowed features [S, S, C], center, size, box xywh,
        score, flag, label)``, all on the device, no host sync."""
        S = self.S
        crop_sz = torch.sqrt(torch.prod(state.size)) * self.area_scale
        feats3 = self.extract(image, state.center, crop_sz * self.scales,
                              state.avg)                     # [3, S, S, C]
        resps = self._response(feats3, state.proj, state.filt)
        peaks = resps.reshape(len(self.scales), -1).amax(1)
        k = torch.argmax(peaks)
        resp = disc.take(resps, k)
        scale_k = disc.take(self.scales, k)
        feat_k = disc.take(feats3, k)

        # The target size in score cells at the chosen scale.
        cells = state.size * (S / (crop_sz * scale_k))
        disp, max_score, flag = disc.localize_advanced(
            resp, cells.flip(0), target_not_found=self.target_not_found,
            distractor_threshold=self.distractor_threshold,
            hard_negative_threshold=self.hard_negative_threshold)

        px = crop_sz * scale_k / S
        not_found = flag == disc.FLAG_NOT_FOUND
        center = torch.where(not_found, state.center,
                             state.center + disp.flip(0) * px)
        size = state.size * torch.where(not_found, 1.0, scale_k)

        if self.iou_net is not None:
            scale = S / (crop_sz * scale_k)
            w = size[0] * scale
            h = size[1] * scale
            cx = (S - 1) / 2 + disp[1]
            cy = (S - 1) / 2 + disp[0]
            box0 = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                cy + h / 2])
            refined, _ = refine_box_ascent(
                self.iou_net, feat_k, state.mod_vec, box0, steps=3,
                step_size=0.25, spatial_scale=1.0)
            new_c = state.center + torch.stack([
                (refined[0] + refined[2]) / 2 - (S - 1) / 2,
                (refined[1] + refined[3]) / 2 - (S - 1) / 2]) / scale
            new_s = torch.stack([refined[2] - refined[0],
                                 refined[3] - refined[1]]) / scale
            center = torch.where(not_found, center, new_c)
            size = torch.where(not_found, size, 0.6 * size + 0.4 * new_s)

        sigma = self._label_sigma(size, crop_sz * scale_k)
        label = disc.gaussian_label(
            (S, S), torch.stack([(S - 1) / 2.0 + disp[0],
                                 (S - 1) / 2.0 + disp[1]]), sigma)
        box = torch.cat([center - size / 2, size])
        return feat_k, center, size, box, max_score, flag, label

    @torch.no_grad()
    def learn(self, state, flag, feat, label):
        """The memory and filter updates for a frame whose flag (a
        Python int) is known: the memory only on a normal or
        hard-negative frame (the hard negative at the boosted rate); the
        filter at once with more CG iterations on a hard negative, else
        every ``train_skipping`` frames.  Returns ``(memory, labels,
        filter)``."""
        mem, labels = state.memory, state.labels
        if flag in (disc.FLAG_NORMAL, disc.FLAG_HARD_NEGATIVE):
            lr = self.hn_lr if flag == disc.FLAG_HARD_NEGATIVE else self.lr
            mem, r_ind = disc.update_memory(mem, feat, lr)
            labels = labels.index_copy(0, r_ind[None], label[None])
        if flag == disc.FLAG_HARD_NEGATIVE:
            n_cg = self.hn_cg_iter
        elif state.frame % self.train_skipping == 0:
            n_cg = self.cg_iter
        else:
            return mem, labels, state.filt
        # Linear in the filter: one Gauss-Newton step is the reference's
        # ConjugateGradient on the normal equations.
        w_s = torch.sqrt(mem.weights)[:, None, None]
        proj_mem = mem.samples @ state.proj     # project once
        rf = math.sqrt(self.filter_reg)

        def residual(f):
            return {"data": (disc.correlate(proj_mem, f) - labels) * w_s,
                    "reg": rf * f}

        filt, _ = gauss_newton_cg(residual, state.filt, num_gn_iters=1,
                                  num_cg_iters=n_cg)
        return mem, labels, filt

    # -- Tracker interface ------------------------------------------

    def init(self, image, box):
        self.state = self.init_fn(image, box)

    def update(self, image):
        state = self.state
        image = disc.upload(image, self.device)
        feat, center, size, box, score, flag, label = self.locate(state,
                                                                  image)
        out = disc.read_back(box, score, flag)
        self.last_flag = int(out[5])
        mem, labels, filt = self.learn(state, self.last_flag, feat, label)
        self.state = state._replace(filt=filt, memory=mem, labels=labels,
                                    center=center, size=size,
                                    frame=state.frame + 1)
        return out[:4].copy(), float(out[4])
