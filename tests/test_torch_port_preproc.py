"""Kernel B1 (letterbox preprocessing) of the port held against the JAX
package on the CPU: the plain version against ``preprocess_frames_xla``
and against the Pallas kernel in interpret mode, and the (index, weight)
taps the CUDA kernel gathers against the dense weight matrices."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tao_amodal_tpu.ops.pallas import preproc as jpre
from tao_amodal_torch.ops import preproc as tpre

# Tolerance for every f32 comparison below: atol 1e-3 on outputs of
# magnitude <= ~130 (uint8 / std); the two sides sum the same products
# in another order.
ATOL = 1e-3


@pytest.mark.parametrize("src_hw,dst", [((64, 96), 128), ((48, 64), 64),
                                        ((45, 61), (48, 64))])
def test_letterbox_weights_match_jax(src_hw, dst):
    wy, wx, scale = tpre.make_letterbox_weights(src_hw, dst)
    jwy, jwx, jscale = jpre.make_letterbox_weights(src_hw, dst)
    np.testing.assert_array_equal(wy, np.asarray(jwy))
    np.testing.assert_array_equal(wx, np.asarray(jwx))
    assert scale == jscale


def test_plain_matches_xla_and_interpret_pallas():
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 255, (2, 64, 96, 3), np.uint8)
    wy, wx, _ = tpre.make_letterbox_weights((64, 96), 128)
    mean, std = [10.0, 20.0, 30.0], [2.0, 3.0, 4.0]
    args = (jnp.asarray(frames), jnp.asarray(wy), jnp.asarray(wx),
            jnp.asarray(mean), jnp.asarray(std))
    want_xla = np.asarray(jpre.preprocess_frames_xla(*args))

    from jax.experimental import pallas as pl

    orig_call = pl.pallas_call

    def interp_call(*a, **kw):
        kw["interpret"] = True
        return orig_call(*a, **kw)

    with mock.patch.object(pl, "pallas_call", interp_call):
        want_pallas = np.asarray(
            jpre.preprocess_frames_pallas(*args, out_size=128))

    got = tpre.preprocess_frames(torch.from_numpy(frames), 128, mean,
                                 std).numpy()
    np.testing.assert_allclose(got, want_xla, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, atol=ATOL)


def test_preprocess_clip_matches_jax_letterbox_pad():
    """The CLI entry point, imagenet mean/std, 4:3 source: rows past
    the letterbox come out as -mean/std, as in the JAX version."""
    frames = np.random.RandomState(2).randint(0, 255, (3, 48, 64, 3),
                                              np.uint8)
    got, scale = tpre.preprocess_clip(torch.from_numpy(frames),
                                      out_size=64)
    want, jscale = jpre.preprocess_clip(frames, out_size=64,
                                        use_pallas=False)
    assert scale == jscale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    pad = -np.asarray(tpre.IMAGENET_MEAN) / np.asarray(tpre.IMAGENET_STD)
    np.testing.assert_allclose(got.numpy()[:, -1, 0], np.tile(pad, (3, 1)),
                               atol=1e-5)


@pytest.mark.parametrize("src_hw,dst", [((480, 640), 512), ((64, 96), 128),
                                        ((100, 160), 128), ((45, 61), 64)])
def test_kernel_taps_reproduce_weight_matrices(src_hw, dst):
    """What the CUDA kernel computes, emulated in numpy: gathering the
    2x2 (index, weight) taps of ``resize_taps`` equals the dense
    ``Wy . X . Wx^T`` -- row normalization, edge clamping and the
    all-zero letterbox rows included."""
    wy, wx, _ = tpre.make_letterbox_weights(src_hw, dst)
    for w in (wy, wx):
        idx, wt = tpre.resize_taps(w)
        dense = np.zeros_like(w)
        rows = np.arange(w.shape[0])
        np.add.at(dense, (rows, idx[:, 0]), wt[:, 0])
        np.add.at(dense, (rows, idx[:, 1]), wt[:, 1])
        np.testing.assert_array_equal(dense, w)
    frames = np.random.RandomState(3).randint(
        0, 255, (1, *src_hw, 3)).astype(np.float32)
    yi, yw = tpre.resize_taps(wy)
    xi, xw = tpre.resize_taps(wx)
    f = frames[0]
    a = (yw[:, 0, None, None] * f[yi[:, 0]][:, xi[:, 0]]
         + yw[:, 1, None, None] * f[yi[:, 1]][:, xi[:, 0]])
    b = (yw[:, 0, None, None] * f[yi[:, 0]][:, xi[:, 1]]
         + yw[:, 1, None, None] * f[yi[:, 1]][:, xi[:, 1]])
    emulated = xw[None, :, 0, None] * a + xw[None, :, 1, None] * b
    dense = np.einsum("oh,hwc,pw->opc", wy, f, wx, optimize=True)
    np.testing.assert_allclose(emulated, dense, atol=ATOL)


def test_resize_taps_rejects_dense_rows():
    with pytest.raises(ValueError, match="two nonzeros"):
        tpre.resize_taps(np.full((2, 5), 0.2, np.float32))
