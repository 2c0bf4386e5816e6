"""ECO: factorized convolution, a sample memory and CG filter updates.

Port of ``tao_amodal_tpu/trackers/eco.py`` (the reference's
``pytracking/tracker/eco/eco.py``):

  * the factorized convolution: a channel projection compresses the
    features before the correlation; PCA-seeded and optimized jointly
    with the filter at the first frame by Gauss-Newton/CG;
  * the sample memory holds projected samples, weighted by the learning
    rate, the min-weight slot replaced;
  * a CG filter update on the weighted memory every ``train_skipping``
    frames;
  * three-scale localization as one batch, Hann window, Gaussian labels,
    augmented first-frame samples.

Filter, memory and CG work on spatial maps (the convolution of
:func:`~tao_amodal_torch.trackers.discriminative.correlate`), as JAX's
do; the Fourier DCF primitives are in :mod:`tao_amodal_torch.ops.
fourier`.  A frame makes one host sync, the box and score's copy, as
JAX's ``update`` makes one; the frame counter is a Python int.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tao_amodal_torch.ops.optimization import gauss_newton_cg
from tao_amodal_torch.trackers import discriminative as disc
from tao_amodal_torch.trackers.base import Tracker
from tao_amodal_torch.trackers.siamrpn import crop_subwindow

f32 = torch.float32


class EcoState(NamedTuple):
    proj: torch.Tensor       # [C, Cc] projection (factorized conv)
    filt: torch.Tensor       # [fh, fw, Cc]
    memory: disc.SampleMemory  # samples [K, S, S, Cc] (projected)
    center: torch.Tensor     # [2] (cx, cy)
    size: torch.Tensor       # [2] (w, h)
    avg: torch.Tensor        # [3]
    frame: int


class EcoTracker(Tracker):
    """ECO over ``feature_fn``: ``crops [B, P, P, 3] -> feats [B, S, S,
    C]`` with ``P = sample_size`` (default ``search_size``: the stride-1
    pixel features).  Deep features set ``sample_size = S * stride``
    (:mod:`~tao_amodal_torch.trackers.deep_features`).  JAX's keyword
    names and defaults; everything on ``device``, the card unless the
    caller asks for the CPU."""

    def __init__(self, feature_fn=None, search_size=96, sample_size=None,
                 filter_size=15, compressed_dim=8, memory_size=16,
                 search_area_scale=4.0, learning_rate=0.01,
                 train_skipping=5, cg_iter=5, init_gn_iter=4,
                 init_cg_iter=6, filter_reg=1e-2, proj_reg=1e-4,
                 scale_factors=(0.97, 1.0, 1.03), device="cuda"):
        self.device = torch.device(device)
        self.S = search_size
        self.P = sample_size or search_size
        self.fsz = filter_size
        self.cdim = compressed_dim
        self.K = memory_size
        self.area_scale = search_area_scale
        self.lr = learning_rate
        self.train_skipping = train_skipping
        self.cg_iter = cg_iter
        self.init_gn_iter = init_gn_iter
        self.init_cg_iter = init_cg_iter
        self.filter_reg = filter_reg
        self.proj_reg = proj_reg
        self.scales = torch.tensor(scale_factors, dtype=f32).to(self.device)
        self.feature_fn = feature_fn or disc.pixel_features
        self.window = disc.hann2d((self.S, self.S), self.device)[:, :, None]
        # The label is recentred on the located target each frame, so
        # every memory sample shares one centred label (the reference
        # shifts the samples instead, eco.py:224-225).
        self.y_center = torch.full((2,), (self.S - 1) / 2.0,
                                   device=self.device)
        self.state = None

    def features(self, image, center, crop_sz, avg):
        """Windowed features of the crops of side ``crop_sz [B]`` about
        ``center [2]`` -> ``[B, S, S, C]``."""
        crops = crop_subwindow(image, center.expand(crop_sz.shape[0], 2),
                               crop_sz, self.P, avg)
        return self.feature_fn(crops) * self.window

    def label_sigma(self, size_px, crop_sz):
        return 0.25 * torch.sqrt(torch.prod(size_px)) * (self.S / crop_sz)

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
        aug = disc.augment_init_samples(crop)
        feats = self.feature_fn(aug) * self.window          # [A, S, S, C]
        A = feats.shape[0]

        proj0 = disc.pca_projection(feats, self.cdim)
        y = disc.gaussian_label((S, S), self.y_center,
                                self.label_sigma(size, crop_sz))
        labels0 = y.expand(A, S, S)

        # Joint factorized optimization {filter, projection}
        # (reference eco.py:150-156).
        filt0 = torch.zeros(self.fsz, self.fsz, self.cdim,
                            device=self.device)
        rf, rp = math.sqrt(self.filter_reg), math.sqrt(self.proj_reg)
        norm = math.sqrt(1.0 * A)

        def residual(p):
            resp = disc.correlate(feats @ p["proj"], p["filt"])
            return {"data": (resp - labels0) / norm,
                    "reg_f": rf * p["filt"],
                    "reg_p": rp * (p["proj"] - proj0)}

        params, _ = gauss_newton_cg(
            residual, {"proj": proj0, "filt": filt0},
            num_gn_iters=self.init_gn_iter, num_cg_iters=self.init_cg_iter)
        proj, filt = params["proj"], params["filt"]

        # The memory stores PROJECTED samples (the reference re-projects
        # the init samples after the joint optimization, eco.py:158-161);
        # the projection is fixed afterwards.
        mem = disc.init_memory(self.K, (S, S, self.cdim), feats @ proj)
        return EcoState(proj, filt, mem, center, size, avg, 1)

    @torch.no_grad()
    def step_fn(self, state, image):
        """One frame: ``(new state, (box xywh [4], score))`` on the
        device, no host sync."""
        S = self.S
        crop_sz = torch.sqrt(torch.prod(state.size)) * self.area_scale
        feats3 = self.features(image, state.center, crop_sz * self.scales,
                               state.avg)
        resps = disc.correlate(feats3 @ state.proj, state.filt)
        peaks = resps.reshape(len(self.scales), -1).amax(1)
        k = torch.argmax(peaks)
        idx = torch.argmax(disc.take(resps, k).reshape(-1))
        disp = torch.stack([(idx // S).to(f32), (idx % S).to(f32)]) - (
            (S - 1) / 2.0)
        scale_k = disc.take(self.scales, k)
        px = crop_sz * scale_k / S
        center = state.center + disp.flip(0) * px
        size = state.size * scale_k

        # The training sample at the NEW centre, so that the target sits
        # at the canonical label position.
        feat_new = self.features(image, center, (crop_sz * scale_k)[None],
                                 state.avg)[0] @ state.proj
        mem, _ = disc.update_memory(state.memory, feat_new, self.lr)

        filt = state.filt
        if state.frame % self.train_skipping == 0:
            # CG filter update on the weighted memory (reference
            # FilterOptim).
            label = disc.gaussian_label(
                (S, S), self.y_center,
                self.label_sigma(size, crop_sz * scale_k))
            labels = label.expand(self.K, S, S)
            w_s = torch.sqrt(mem.weights)[:, None, None]
            rf = math.sqrt(self.filter_reg)

            def residual(f):
                return {"data": (disc.correlate(mem.samples, f) - labels)
                        * w_s, "reg": rf * f}

            filt, _ = gauss_newton_cg(residual, filt, num_gn_iters=1,
                                      num_cg_iters=self.cg_iter)

        new_state = EcoState(state.proj, filt, mem, center, size, state.avg,
                             state.frame + 1)
        box = torch.cat([center - size / 2, size])
        return new_state, (box, disc.take(peaks, k))

    def init(self, image, box):
        self.state = self.init_fn(image, box)

    def update(self, image):
        self.state, (box, score) = self.step_fn(
            self.state, disc.upload(image, self.device))
        out = disc.read_back(box, score)
        return out[:4].copy(), float(out[4])
