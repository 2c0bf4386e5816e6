"""Kernel B2 (PrRoI pooling over the packed multilevel canvas) of the
port held against the JAX package on the CPU: ``prroi_pool`` against
the JAX einsum form, ``multilevel_roi_align`` against the JAX fused
Pallas path in interpret mode, and the CUDA kernel's sparse per-bin
support loop (emulated in numpy) against the dense integral."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tao_amodal_tpu.ops import roi as jroi
from tao_amodal_torch.ops import roi as troi

# atol 1e-4 on features in [0, 1): the same hat-integral weights summed
# in another order (f32).
ATOL = 1e-4


def _rois(rs, n, span, lo=5.0, hi=50.0):
    r = np.zeros((n, 4), np.float32)
    r[:, :2] = rs.rand(n, 2) * span
    r[:, 2:] = r[:, :2] + lo + rs.rand(n, 2) * (hi - lo)
    return r


@pytest.mark.parametrize("hw", [(16, 20), (20, 12)])
def test_prroi_pool_matches_jax(hw):
    """Both contraction orders (W >= H and W < H), RoIs that overhang
    the map edge (zero-pad semantics) and a degenerate one."""
    rs = np.random.RandomState(0)
    feat = rs.rand(*hw, 32).astype(np.float32)
    rois = _rois(rs, 8, max(hw) - 4, lo=1.0, hi=10.0)
    rois[0] = [-3.0, -2.0, 4.0, 5.0]
    rois[1] = [3.0, 3.0, 3.5, 3.25]
    want = np.asarray(jroi.prroi_pool(jnp.asarray(feat), jnp.asarray(rois),
                                      out_size=7, spatial_scale=0.5))
    got = troi.prroi_pool(torch.from_numpy(feat), torch.from_numpy(rois),
                          out_size=7, spatial_scale=0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


def test_multilevel_matches_jax_fused_interpret(monkeypatch):
    """The port's canvas path (batched over frames) == the JAX
    ``method='prroi_packed_fused'`` path per frame, with the Pallas
    kernel forced to interpret mode as tests/test_roi.py runs it."""
    import tao_amodal_tpu.ops.pallas.prroi as P

    orig = P.prroi_packed_fused
    monkeypatch.setattr(
        P, "prroi_packed_fused",
        lambda f, r, out_size=7, wmaj=True, interpret=False,
        pre_transposed=False:
        orig(f, r, out_size=out_size, wmaj=wmaj, interpret=True,
             pre_transposed=pre_transposed))

    rs = np.random.RandomState(5)
    T, R = 2, 8
    pyramid = [rs.rand(T, s, s, 128).astype(np.float32)
               for s in (32, 16, 8, 4)]
    rois = np.stack([_rois(rs, R, 200.0, hi=200.0) for _ in range(T)])
    got = troi.multilevel_roi_align(
        [torch.from_numpy(p) for p in pyramid], torch.from_numpy(rois),
        canonical_level=1, strides=(8, 16, 32, 64)).numpy()
    assert got.shape == (T, R, 7, 7, 128)
    for t in range(T):
        want = jroi.multilevel_roi_align(
            [jnp.asarray(p[t]) for p in pyramid], jnp.asarray(rois[t]),
            canonical_level=1, strides=(8, 16, 32, 64),
            method="prroi_packed_fused")
        np.testing.assert_allclose(got[t], np.asarray(want), atol=ATOL)


def test_canvas_layout_at_serving_shape():
    """At 512^2 the P3..P6 canvas is the 64x98 shelf of the JAX code
    (roi.py:203-222): P3 fills column 0, P4/P5/P6 stack in column 1."""
    (H, W), offs = troi.canvas_layout([(64, 64), (32, 32), (16, 16),
                                       (8, 8)])
    assert (H, W) == (64, 98)
    assert offs == [(0, 0), (0, 66), (34, 66), (52, 66)]


def _hat(u):
    u = np.clip(u, -1.0, 1.0)
    return np.where(u <= 0, 0.5 * (u + 1) ** 2, 0.5 + u - 0.5 * u ** 2)


def test_kernel_support_loop_matches_dense_integral():
    """What the CUDA kernel computes, emulated in numpy: per bin, the sum
    over pixels floor(lo)..ceil(hi) (clamped to the canvas) of the
    separable hat weights equals the dense integral over every pixel --
    for bins inside, overhanging and outside the canvas."""
    rs = np.random.RandomState(7)
    Hc, Wc, C, S = 12, 18, 4, 7
    canvas = rs.rand(1, Hc, Wc, C).astype(np.float32)
    rois = _rois(rs, 6, 14.0, lo=0.5, hi=12.0)
    rois[0] = [-5.0, -4.0, 2.0, 3.0]
    rois[1] = [16.0, 10.0, 25.0, 20.0]
    rois[2] = [30.0, 30.0, 40.0, 40.0]
    want = troi.prroi_pool(torch.from_numpy(canvas),
                           torch.from_numpy(rois[None]), S).numpy()[0]
    got = np.zeros_like(want)
    for r, (x0, y0, x1, y1) in enumerate(rois.astype(np.float64)):
        bw, bh = max((x1 - x0) / S, 1e-8), max((y1 - y0) / S, 1e-8)
        for by in range(S):
            for bx in range(S):
                lox, loy = x0 + bx * bw, y0 + by * bh
                hix, hiy = lox + bw, loy + bh
                xs = int(min(max(np.floor(lox), 0), Wc - 1))
                xe = int(min(max(np.ceil(hix), 0), Wc - 1))
                ys = int(min(max(np.floor(loy), 0), Hc - 1))
                ye = int(min(max(np.ceil(hiy), 0), Hc - 1))
                acc = np.zeros(C)
                for y in range(ys, ye + 1):
                    wy = _hat(hiy - y) - _hat(loy - y)
                    for x in range(xs, xe + 1):
                        wx = _hat(hix - x) - _hat(lox - x)
                        acc += wy * wx * canvas[0, y, x]
                got[r, by, bx] = acc / (bw * bh)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
