"""Batched constant-velocity Kalman filter for box tracking.

Port of :mod:`tao_amodal_tpu.ops.kalman`: state ``[K, 7]`` = (cx, cy,
s=area, r=aspect, vcx, vcy, vs), covariance ``[K, 7, 7]``, predict and
update as einsums over the whole slot bank, filterpy-style constants of
the reference SORT.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DIM_X, DIM_Z = 7, 4


@functools.cache
def _constants(device, dtype=torch.float32):
    """(F, H, R, P0, Q) on ``device``; cached so that a step issues no
    host-to-device copies (the tensors are never written)."""
    F = np.eye(DIM_X)
    for i in range(3):
        F[i, i + 4] = 1.0  # constant velocity on cx, cy, s
    H = np.zeros((DIM_Z, DIM_X))
    H[:4, :4] = np.eye(4)
    R = np.eye(DIM_Z)
    R[2:, 2:] *= 10.0
    P0 = np.eye(DIM_X)
    P0[4:, 4:] *= 1000.0
    P0 *= 10.0
    Q = np.eye(DIM_X)
    Q[-1, -1] *= 0.01
    Q[4:, 4:] *= 0.01
    return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                 for m in (F, H, R, P0, Q))


def bbox_to_z(boxes):
    """xyxy -> (cx, cy, area, aspect) measurement."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + w / 2
    cy = boxes[..., 1] + h / 2
    return torch.stack([cx, cy, w * h, w / h.clamp_min(1e-6)], dim=-1)


def z_to_bbox(z):
    """(cx, cy, area, aspect) -> xyxy."""
    w = torch.sqrt((z[..., 2] * z[..., 3]).clamp_min(0.0))
    h = z[..., 2] / w.clamp_min(1e-6)
    return torch.stack([z[..., 0] - w / 2, z[..., 1] - h / 2,
                        z[..., 0] + w / 2, z[..., 1] + h / 2], dim=-1)


def init_state(boxes):
    """New-track states from detections: ``[..., 7]`` mean and
    ``[..., 7, 7]`` covariance."""
    P0 = _constants(boxes.device, boxes.dtype)[3]
    z = bbox_to_z(boxes)
    x = torch.cat([z, z.new_zeros(z.shape[:-1] + (3,))], dim=-1)
    P = P0.expand(z.shape[:-1] + (DIM_X, DIM_X))
    return x, P


def predict(x, P):
    """Advance the whole bank one step, zeroing the area velocity where
    the predicted area would go non-positive (reference guard)."""
    F, _, _, _, Q = _constants(x.device, x.dtype)
    vs_bad = (x[..., 6] + x[..., 2]) <= 0
    x = torch.cat([x[..., :6],
                   torch.where(vs_bad, 0.0, x[..., 6])[..., None]], dim=-1)
    x = torch.einsum("ij,...j->...i", F, x)
    P = torch.einsum("ij,...jk,lk->...il", F, P, F) + Q
    return x, P


def _inv4x4(m):
    """Closed-form batched 4x4 inverse (pair-of-2x2-subdeterminants
    expansion), the formula of the JAX version."""
    (a, b, c, d), (e, f, g, h), (i, j, k, l), (mm, n, o, p) = (  # noqa: E741
        m[..., r, :].unbind(-1) for r in range(4))
    s0 = a * f - e * b
    s1 = a * g - e * c
    s2 = a * h - e * d
    s3 = b * g - f * c
    s4 = b * h - f * d
    s5 = c * h - g * d
    c5 = k * p - o * l
    c4 = j * p - n * l
    c3 = j * o - n * k
    c2 = i * p - mm * l
    c1 = i * o - mm * k
    c0 = i * n - mm * j

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, 1.0)
    rows = [
        [f * c5 - g * c4 + h * c3, -b * c5 + c * c4 - d * c3,
         n * s5 - o * s4 + p * s3, -j * s5 + k * s4 - l * s3],
        [-e * c5 + g * c2 - h * c1, a * c5 - c * c2 + d * c1,
         -mm * s5 + o * s2 - p * s1, i * s5 - k * s2 + l * s1],
        [e * c4 - f * c2 + h * c0, -a * c4 + b * c2 - d * c0,
         mm * s4 - n * s2 + p * s0, -i * s4 + j * s2 - l * s0],
        [-e * c3 + f * c1 - g * c0, a * c3 - b * c1 + c * c0,
         -mm * s3 + n * s1 - o * s0, i * s3 - j * s1 + k * s0],
    ]
    inv = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return inv * inv_det[..., None, None]


def update(x, P, z, gate=None):
    """Measurement update; ``gate[K]`` False freezes a slot (no det)."""
    _, H, R, _, _ = _constants(x.device, x.dtype)
    y = z - torch.einsum("ij,...j->...i", H, x)
    S = torch.einsum("ij,...jk,lk->...il", H, P, H) + R
    K = torch.einsum("...ij,kj,...kl->...il", P, H, _inv4x4(S))
    x_new = x + torch.einsum("...ij,...j->...i", K, y)
    I_KH = (torch.eye(DIM_X, dtype=x.dtype, device=x.device)
            - torch.einsum("...ij,jk->...ik", K, H))
    P_new = torch.einsum("...ij,...jk->...ik", I_KH, P)
    if gate is not None:
        x_new = torch.where(gate[..., None], x_new, x)
        P_new = torch.where(gate[..., None, None], P_new, P)
    return x_new, P_new


def state_to_bbox(x):
    return z_to_bbox(x[..., :4])
