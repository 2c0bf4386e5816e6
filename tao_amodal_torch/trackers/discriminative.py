"""Shared machinery of the online discriminative trackers (ATOM, ECO).

Port of ``tao_amodal_tpu/trackers/discriminative.py`` (the reference's
``pytracking/tracker/{atom,eco}`` pieces): the first-frame augmentation
stack, the PCA seed of the factorized convolution's projection, the
sample memory with learning-rate weights and min-weight replacement, the
Hann window and Gaussian labels, the 'same' correlation of compressed
features with a filter, and the localization with hard-negative and
target-lost flags.

Everything stays on the tensors' device: the memory's first-insert
branch is a ``torch.where``, its slot written with ``index_copy_`` at a
device index, and the flags are integer codes from ``torch.where``, so
none of these makes a host sync.  Maps are NHWC (``[..., H, W, C]``), as
JAX holds them; the convolutions permute to NCHW.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

f32 = torch.float32

# Localization flag codes (the reference's strings 'normal',
# 'not_found', 'uncertain', 'hard_negative').
FLAG_NORMAL = 0
FLAG_NOT_FOUND = 1
FLAG_UNCERTAIN = 2
FLAG_HARD_NEGATIVE = 3


def upload(image, device):
    """A host frame (RGB uint8 ``[H, W, 3]``) on ``device``: on a card
    through pinned memory and a non-blocking copy, which makes no host
    sync (a pageable copy waits for the card)."""
    if isinstance(image, torch.Tensor):
        return image.to(device)
    t = torch.from_numpy(np.ascontiguousarray(image))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def read_back(*values):
    """The 0-d and 1-d tensors ``values`` as one f32 numpy vector: one
    device-to-host copy, a frame's one host sync."""
    return torch.cat([v.reshape(-1).to(f32) for v in values]).cpu().numpy()


def pixel_features(crops):
    """Dense features when no backbone is plugged in: normalized pixels
    (less each crop's mean) and forward differences along W and H, 9
    channels: ``[..., P, P, 3] -> [..., P, P, 9]``."""
    x = crops.to(f32) / 255.0
    gx = torch.diff(x, dim=-2, append=x[..., -1:, :])
    gy = torch.diff(x, dim=-3, append=x[..., -1:, :, :])
    mean = x.mean(dim=(-3, -2, -1), keepdim=True)
    return torch.cat([x - mean, gx, gy], dim=-1)


def gaussian_blur(x, sigma=1.0, radius=2):
    """Separable Gaussian blur of ``[H, W, C]``: a 'same' convolution
    with zero padding along H, then along W (JAX's ``jnp.convolve``)."""
    offs = torch.arange(-radius, radius + 1, dtype=f32, device=x.device)
    k = torch.exp(-0.5 * (offs / sigma) ** 2)
    k = (k / k.sum()).flip(0)[None, None]             # convolve, not correlate
    H, W, C = x.shape
    cols = x.permute(2, 1, 0).reshape(C * W, 1, H)    # [C*W, 1, H]
    cols = F.conv1d(cols, k, padding=radius).reshape(C, W, H)
    rows = cols.transpose(1, 2).reshape(C * H, 1, W)  # [C*H, 1, W]
    rows = F.conv1d(rows, k, padding=radius).reshape(C, H, W)
    return rows.permute(1, 2, 0)


def augment_init_samples(crop, shifts=(8, -8)):
    """The first-frame augmentation stack (reference
    ``generate_init_samples``): identity, horizontal flip, four axis
    rolls and a blur -> ``[7, P, P, 3]``."""
    rolls = [torch.roll(crop, s, dims=ax) for s in shifts for ax in (0, 1)]
    stack = [crop, crop.flip(1)] + rolls + [gaussian_blur(crop)]
    return torch.stack(stack)


def pca_projection(feats, cdim):
    """PCA seed of the projection (reference ``eco.py:107-111``): the
    ``cdim`` leading eigenvectors of the channel covariance of ``feats
    [..., C]`` -> ``P [C, cdim]``, orthonormal columns.  An eigenvector's
    sign is the solver's (LAPACK and cuSOLVER may differ)."""
    x = feats.reshape(-1, feats.shape[-1])
    x = x - x.mean(dim=0, keepdim=True)
    cov = x.T @ x
    _, vecs = torch.linalg.eigh(cov)         # ascending eigenvalues
    return vecs.flip(1)[:, :cdim]


class SampleMemory(NamedTuple):
    """Fixed-capacity sample memory with the reference's weights
    (``eco.py:344-368``)."""

    samples: torch.Tensor    # [K, ...]
    weights: torch.Tensor    # [K]
    prev_ind: torch.Tensor   # [] int64, -1 = none yet
    num_stored: torch.Tensor  # [] int64


def init_memory(capacity, sample_shape, init_samples=None, dtype=f32,
                device="cpu"):
    """A memory, optionally holding the augmented first-frame samples at
    uniform weight (reference ``init_sample_weights = 1/num``)."""
    if init_samples is not None:
        device = init_samples.device
    samples = torch.zeros((capacity,) + tuple(sample_shape), dtype=dtype,
                          device=device)
    weights = torch.zeros(capacity, dtype=f32, device=device)
    n = 0
    if init_samples is not None:
        n = init_samples.shape[0]
        samples[:n] = init_samples.to(dtype)
        weights[:n].fill_(1.0 / n)
    long = dict(dtype=torch.long, device=device)
    return SampleMemory(samples, weights, torch.full((), -1, **long),
                        torch.full((), n, **long))


def update_memory(mem: SampleMemory, sample, learning_rate=0.01):
    """Insert ``sample`` with the reference's weight update
    (``update_sample_weights``): replace the min-weight slot (an unfilled
    slot, weight 0, first), renormalize with the learning rate.  Writes
    ``mem.samples`` in place.  Returns ``(memory, r_ind)``, ``r_ind`` the
    slot, a 0-d tensor."""
    K = mem.weights.shape[0]
    w = mem.weights
    r_ind = torch.argmin(w)
    at_r = torch.arange(K, device=w.device) == r_ind
    first = at_r.to(w.dtype)
    w_no = torch.where(at_r, learning_rate, w / (1.0 - learning_rate))
    prev = w.gather(0, mem.prev_ind.clamp_min(0)[None])
    w_yes = torch.where(at_r, prev / (1.0 - learning_rate), w)
    later = torch.where(mem.prev_ind < 0, w_no, w_yes)
    weights = torch.where(mem.num_stored == 0, first, later)
    weights = weights / weights.sum()
    samples = mem.samples.index_copy_(
        0, r_ind[None], sample[None].to(mem.samples.dtype))
    return SampleMemory(samples, weights, r_ind,
                        (mem.num_stored + 1).clamp_max(K)), r_ind


def take(t, i):
    """``t[i]`` along dim 0 for a 0-d index tensor ``i``, by
    ``index_select`` (indexing with a 0-d tensor may read it on the
    host)."""
    return t.index_select(0, i.reshape(1))[0]


def hann2d(shape, device="cpu"):
    """Hann window ``[h, w]`` sampled at pixel centres (``(i + 0.5) /
    h``: no zero row), unlike :func:`tao_amodal_torch.ops.fourier.
    hann2d`."""
    h, w = shape
    wy = 0.5 - 0.5 * torch.cos(
        2 * math.pi * (torch.arange(h, dtype=f32, device=device) + 0.5) / h)
    wx = 0.5 - 0.5 * torch.cos(
        2 * math.pi * (torch.arange(w, dtype=f32, device=device) + 0.5) / w)
    return wy[:, None] * wx[None, :]


def gaussian_label(shape, center_rc, sigma):
    """Desired response ``[h, w]``: a Gaussian peak at ``center_rc``
    (row, col; a tensor ``[2]``)."""
    h, w = shape
    dev = center_rc.device
    ys = torch.arange(h, dtype=f32, device=dev)[:, None]
    xs = torch.arange(w, dtype=f32, device=dev)[None, :]
    return torch.exp(-((ys - center_rc[0]) ** 2 + (xs - center_rc[1]) ** 2)
                     / (2 * sigma ** 2))


def correlate(feats, filt):
    """'Same' correlation ``[B, H, W, Cc]`` (or ``[H, W, Cc]``) x
    ``[fh, fw, Cc]`` -> ``[B, H, W]`` summed over channels (the
    factorized convolution's response).  XLA's 'SAME' pads ``(fh - 1) //
    2`` before and ``fh // 2`` after, asymmetric for an even filter, so
    the pad comes before the convolution."""
    batched = feats.ndim == 4
    x = (feats if batched else feats[None]).permute(0, 3, 1, 2)
    fh, fw, _ = filt.shape
    x = F.pad(x, ((fw - 1) // 2, fw // 2, (fh - 1) // 2, fh // 2))
    out = F.conv2d(x, filt.permute(2, 0, 1)[None].contiguous())[:, 0]
    return out if batched else out[0]


def localize_advanced(scores, target_sz_cells, target_not_found=0.25,
                      distractor_threshold=0.8, hard_negative_threshold=0.5,
                      displacement_scale=0.8, target_neighborhood_scale=2.2):
    """Hard-negative-aware localization (reference ``atom.py
    localize_advanced``): the main peak, the runner-up outside its
    neighbourhood, and a flag code.

    ``scores [H, W]``, ``target_sz_cells [2]`` (h, w) in score cells.
    Returns (displacement ``[2]`` (row, col) from the centre, the peak
    score, the flag, an int64 0-d tensor).  ``argmax`` takes the first
    maximum, as JAX's does.
    """
    h, w = scores.shape
    dev = scores.device
    flat = scores.reshape(-1)
    i1 = torch.argmax(flat)
    r1, c1 = i1 // w, i1 % w
    max1 = take(flat, i1)
    nbh = target_neighborhood_scale * target_sz_cells / 2.0
    ys = torch.arange(h, dtype=f32, device=dev)[:, None]
    xs = torch.arange(w, dtype=f32, device=dev)[None, :]
    in_nbh = ((ys - r1).abs() <= nbh[0]) & ((xs - c1).abs() <= nbh[1])
    masked = torch.where(in_nbh, -torch.inf, scores).reshape(-1)
    i2 = torch.argmax(masked)
    max2 = take(masked, i2)

    def disp(r, c):
        return torch.stack([r.to(f32) - (h - 1) / 2.0,
                            c.to(f32) - (w - 1) / 2.0])

    disp1 = disp(r1, c1)
    disp2 = disp(i2 // w, i2 % w)
    d1 = torch.sqrt(torch.sum(disp1 ** 2))
    d2 = torch.sqrt(torch.sum(disp2 ** 2))
    prev_sz = torch.sqrt(torch.prod(target_sz_cells))

    not_found = max1 < target_not_found
    distractor = max2 > distractor_threshold * max1
    proximity_ok = d2 > displacement_scale * prev_sz * 0.5
    hard_neg = (max2 > hard_negative_threshold * max1) & ~distractor

    def code(c):
        return torch.full((), c, dtype=torch.long, device=dev)

    flag = torch.where(
        not_found, code(FLAG_NOT_FOUND),
        torch.where(distractor,
                    torch.where(proximity_ok & (d1 < d2),
                                code(FLAG_HARD_NEGATIVE),
                                code(FLAG_UNCERTAIN)),
                    torch.where(hard_neg, code(FLAG_HARD_NEGATIVE),
                                code(FLAG_NORMAL))))
    return disp1, max1, flag
