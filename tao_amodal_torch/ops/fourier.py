"""Fourier-domain correlation filters (ECO's DCF primitives).

Port of ``tao_amodal_tpu/ops/fourier.py`` (the reference's
``pytracking/libs/{dcf,fourier,complex}.py``): the Hann window, the
centred Gaussian response (ifftshifted, its peak at the origin), and the
closed-form ridge filter, its response and its running-average update,
on ``torch.fft`` over the spatial axes of ``[H, W, C]`` maps in
complex64.
"""

from __future__ import annotations

import math

import torch

f32 = torch.float32


def hann2d(shape, device="cpu"):
    """Separable 2-D Hann window ``[h, w]`` (the ``h - 1`` denominator:
    zero at both ends)."""
    h, w = shape
    wy = 0.5 - 0.5 * torch.cos(
        2 * math.pi * torch.arange(h, dtype=f32, device=device) / (h - 1))
    wx = 0.5 - 0.5 * torch.cos(
        2 * math.pi * torch.arange(w, dtype=f32, device=device) / (w - 1))
    return wy[:, None] * wx[None, :]


def gaussian_response(shape, sigma, device="cpu"):
    """Centred 2-D Gaussian ``[h, w]``, ifftshifted so the peak is at
    (0, 0)."""
    h, w = shape
    ys = torch.arange(h, dtype=f32, device=device) - h // 2
    xs = torch.arange(w, dtype=f32, device=device) - w // 2
    g = torch.exp(-(ys[:, None] ** 2 + xs[None, :] ** 2) / (2 * sigma ** 2))
    return torch.fft.ifftshift(g)


def train_dcf(feats, response, reg=1e-2):
    """Closed-form ridge correlation filter in the Fourier domain:
    ``feats [H, W, C]`` windowed features, ``response [H, W]`` the
    desired response (peak at the origin) -> the filter's transform
    ``[H, W, C]`` (complex64)."""
    F = torch.fft.fft2(feats, dim=(0, 1))
    Y = torch.fft.fft2(response)
    num = torch.conj(F) * Y[:, :, None]
    den = torch.sum(F * torch.conj(F), dim=-1, keepdim=True) + reg
    return num / den


def apply_dcf(feats, filt_hat):
    """Correlate ``feats [H, W, C]`` with a Fourier filter -> the
    response ``[H, W]``."""
    F = torch.fft.fft2(feats, dim=(0, 1))
    R = torch.sum(F * filt_hat, dim=-1)
    return torch.real(torch.fft.ifft2(R))


def update_dcf(filt_hat, feats, response, lr=0.02, reg=1e-2):
    """Running-average model update (ECO-style online adaptation)."""
    new = train_dcf(feats, response, reg)
    return (1 - lr) * filt_hat + lr * new
