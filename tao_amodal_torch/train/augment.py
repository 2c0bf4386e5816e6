"""Training augmentations as batched tensor ops on the device.

Port of :mod:`tao_amodal_tpu.train.augment` (the capability of the
reference's ``Augmentation``, ``pysot/datasets/augmentation.py:15-100``:
shift, scale, color jitter, grayscale, horizontal flip, blur).  JAX
writes one sample's functions and draws inside them with ``jax.random``;
here each function takes a batch ``[B, H, W, C]`` (NHWC, f32) and its
draws, one row a sample, so it is a pure function of them, and
:func:`augment_draws` draws them for :func:`augment_pair` on the
device.  The tests pass the values JAX draws from its keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GRAY = (0.299, 0.587, 0.114)


def _uniform(shape, lo, hi, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return lo + u * (hi - lo)


def augment_draws(batch_size, generator=None, device="cuda", max_shift=64,
                  scale_jitter=0.18, strength=0.1):
    """The draws of :func:`augment_pair` for ``batch_size`` samples, from
    ``generator`` (on ``device``): ``shift [B, 2]`` (x, y) pixels,
    ``scale [B, 2]`` factors, ``flip``, ``gray`` and ``blur`` uniforms
    ``[B]`` (each op applies where its uniform is below its
    probability), ``color``/``template_color [B, 3]`` factors."""
    if generator is not None:
        device = generator.device
    B = batch_size

    def u(shape, lo=0.0, hi=1.0):
        return _uniform(shape, lo, hi, generator, device)

    return {"shift": u((B, 2), -max_shift, max_shift),
            "scale": 1.0 + u((B, 2), -scale_jitter, scale_jitter),
            "flip": u((B,)), "color": 1.0 + u((B, 3), -strength, strength),
            "gray": u((B,)), "blur": u((B,)),
            "template_color": 1.0 + u((B, 3), -strength, strength)}


def _where(cond, a, b):
    """``cond [B]`` selects ``a`` or ``b`` a sample."""
    return torch.where(cond.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def shift_scale(image, box_cxcywh, shift, scale, pad_value=0.0):
    """Shift by ``shift [B, 2]`` pixels and scale by ``scale [B, 2]``
    about the image centre (bilinear, ``pad_value`` outside), and map the
    (cx, cy, w, h) boxes ``[B, 4]`` alike.  Returns ``(image, box)``."""
    B, H, W, _ = image.shape
    dev = image.device
    ys = ((torch.arange(H, dtype=torch.float32, device=dev) - H / 2)
          / scale[:, 1:2] + H / 2 - shift[:, 1:2])            # [B, H]
    xs = ((torch.arange(W, dtype=torch.float32, device=dev) - W / 2)
          / scale[:, 0:1] + W / 2 - shift[:, 0:1])            # [B, W]
    Y = ys[:, :, None].expand(B, H, W)
    X = xs[:, None, :].expand(B, H, W)
    x0 = torch.floor(X)
    y0 = torch.floor(Y)
    wx = (X - x0)[..., None]
    wy = (Y - y0)[..., None]
    b = torch.arange(B, device=dev)[:, None, None]

    def fetch(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        return torch.where(inb[..., None], image[b, yc, xc].float(),
                           pad_value)

    out = ((1 - wy) * ((1 - wx) * fetch(y0, x0) + wx * fetch(y0, x0 + 1))
           + wy * ((1 - wx) * fetch(y0 + 1, x0)
                   + wx * fetch(y0 + 1, x0 + 1)))

    cx = (box_cxcywh[:, 0] - W / 2 + shift[:, 0] * 1.0) * scale[:, 0] + W / 2
    cy = (box_cxcywh[:, 1] - H / 2 + shift[:, 1] * 1.0) * scale[:, 1] + H / 2
    box = torch.stack([cx, cy, box_cxcywh[:, 2] * scale[:, 0],
                       box_cxcywh[:, 3] * scale[:, 1]], dim=-1)
    return out, box


def color_jitter(image, factors):
    """Per-channel multiplicative jitter by ``factors [B, 3]`` (the
    reference uses an RGB covariance; a diagonal keeps the capability)."""
    return image * factors[:, None, None, :]


def grayscale(image, u, prob=0.05):
    """The luma in every channel where ``u [B] < prob``."""
    w = torch.tensor(GRAY, dtype=image.dtype, device=image.device)
    g = torch.sum(image * w, dim=-1, keepdim=True)
    return _where(u < prob, g.expand_as(image), image)


def hflip(image, box_cxcywh, u, prob=0.5):
    """Mirror image and box where ``u [B] < prob``."""
    W = image.shape[2]
    do = u < prob
    fbox = torch.cat([(W - 1 - box_cxcywh[:, 0])[:, None],
                      box_cxcywh[:, 1:]], dim=-1)
    return (_where(do, torch.flip(image, [2]), image),
            _where(do, fbox, box_cxcywh))


def blur(image, u, prob=0.18):
    """A 3x3 box blur, zero-padded at the border (JAX's ``"SAME"``), where
    ``u [B] < prob``."""
    C = image.shape[-1]
    k = torch.full((C, 1, 3, 3), 1.0 / 9.0, dtype=image.dtype,
                   device=image.device)
    x = image.permute(0, 3, 1, 2)
    blurred = F.conv2d(x, k, padding=1, groups=C).permute(0, 2, 3, 1)
    return _where(u < prob, blurred, image)


def augment_pair(template, search, search_box, draws):
    """The full augmentation of a batch of (template, search, box)
    samples, JAX's order: the search crop shifted and scaled, flipped,
    color jittered, grayed and blurred; the template color jittered."""
    search, search_box = shift_scale(search, search_box, draws["shift"],
                                     draws["scale"])
    search, search_box = hflip(search, search_box, draws["flip"])
    search = color_jitter(search, draws["color"])
    search = grayscale(search, draws["gray"])
    search = blur(search, draws["blur"])
    template = color_jitter(template, draws["template_color"])
    return template, search, search_box
