"""``jax.image.resize(method="linear")`` as a weight matrix per axis.

JAX's linear resize is antialiased by default: when it downsamples, its
triangle kernel is widened by the downscale factor, so a plain bilinear
interpolation does not reproduce it.  Each axis of the resize is a
matrix product with the weights :func:`linear_resize_weights` builds, in
f32 as JAX computes them (``jax/_src/image/scale.py``'s
``compute_weight_mat``).
"""

from __future__ import annotations

import numpy as np


def linear_resize_weights(n_in, n_out):
    """``[n_in, n_out]`` f32 weights of ``jax.image.resize(method=
    "linear")`` along one axis of ``n_in`` samples resized to ``n_out``."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(x / kernel_scale))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)
