"""The port's PrRoI entry points B5 (``prroi_packed_pallas``) and B6
(``prroi_pool_pallas``), every ``multilevel_roi_align`` method, and the
``pallas_pooling=True`` detector and pipeline, held against the JAX
package on the CPU.  The wrappers take their plain versions here; the
JAX kernels run in interpret mode, as the JAX package's own tests run
them.  The CUDA kernel is held against the plain versions on the card
by ``test_torch_port_isolation.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tao_amodal_tpu.ops.pallas.prroi as jpallas
from tao_amodal_tpu.ops import roi as jroi
from tao_amodal_torch.ops import prroi as tprroi
from tao_amodal_torch.ops import roi as troi
from torch_port_fixtures import (
    jax_pipeline,
    random_clip,
    save_npz,
    torch_pipeline,
)

# atol 1e-4 on features in [0, 1): the same hat-integral weights summed
# in another order (f32), as for B2.
ATOL = 1e-4


def _rois(rs, n, span, lo, hi):
    xy = rs.uniform(0, span, (n, 2))
    return np.concatenate([xy, xy + rs.uniform(lo, hi, (n, 2))],
                          -1).astype(np.float32)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX Pallas PrRoI kernels forced into interpret mode."""
    for name in ("prroi_packed_pallas", "prroi_pool_pallas",
                 "prroi_packed_fused"):
        orig = getattr(jpallas, name)
        monkeypatch.setattr(
            jpallas, name,
            lambda *a, _orig=orig, **k: _orig(*a, **{**k,
                                                     "interpret": True}))


def test_prroi_packed_pallas_matches_jax_interpret(interpret):
    """B5 on one canvas ``[H, W, C]`` (W a multiple of 16, as the JAX
    method pads it) with RoIs inside it, one crossing its right and
    bottom edges and one crossing its top-left corner; and the batched
    ``[T, H, W, C]`` form equal to the frames one by one."""
    rs = np.random.RandomState(0)
    feat = rs.rand(2, 20, 32, 16).astype(np.float32)
    rois = np.stack([_rois(rs, 8, 18, 1.0, 12.0) for _ in range(2)])
    rois[0, 0] = [26.0, 15.0, 36.5, 23.0]
    rois[0, 1] = [-3.0, -2.5, 4.0, 5.0]
    got = tprroi.prroi_packed_pallas(torch.from_numpy(feat),
                                     torch.from_numpy(rois)).numpy()
    assert got.shape == (2, 8, 7, 7, 16) and got.dtype == np.float32
    for t in range(2):
        want = np.asarray(jpallas.prroi_packed_pallas(
            jnp.asarray(feat[t]), jnp.asarray(rois[t])))
        one = tprroi.prroi_packed_pallas(torch.from_numpy(feat[t]),
                                         torch.from_numpy(rois[t])).numpy()
        np.testing.assert_allclose(got[t], want, rtol=1e-5, atol=ATOL)
        np.testing.assert_array_equal(one, got[t])


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_prroi_pool_pallas_matches_jax_interpret(interpret, scale):
    """B6 on one level: RoIs in image coordinates scaled by
    ``spatial_scale`` in f32; one crosses the map's right and bottom
    edges, where the integral takes zeros outside the map (per-level
    maps have no zero gap)."""
    rs = np.random.RandomState(1)
    feat = rs.rand(16, 20, 16).astype(np.float32)
    rois = _rois(rs, 8, 14 / scale, 1.0 / scale, 10.0 / scale)
    rois[0] = np.array([15.0, 11.0, 26.0, 19.0], np.float32) / scale
    want = np.asarray(jpallas.prroi_pool_pallas(
        jnp.asarray(feat), jnp.asarray(rois), spatial_scale=scale))
    got = tprroi.prroi_pool_pallas(torch.from_numpy(feat),
                                   torch.from_numpy(rois),
                                   spatial_scale=scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    # The edge RoI really reaches past the map.
    assert rois[0, 2] * scale > feat.shape[1]


@pytest.mark.parametrize("method", troi.METHODS)
def test_multilevel_methods_match_jax(interpret, method):
    """Each method of the port's ``multilevel_roi_align`` (batched over
    frames) against the JAX function of the same method per frame, on a
    P3..P6 pyramid of a 256^2 image with a canonical size of 28 px, so
    that the RoIs land on every level."""
    rs = np.random.RandomState(5)
    T, R, S = 2, 16, 256
    pyramid = [rs.rand(T, s, s, 16).astype(np.float32)
               for s in (32, 16, 8, 4)]
    side = np.exp(rs.uniform(np.log(8), np.log(250), (T, R, 2)))
    xy = rs.uniform(0, S, (T, R, 2)) - side / 2
    rois = np.concatenate([xy, xy + side], -1).clip(0, S).astype(
        np.float32)
    kw = dict(canonical_level=1, canonical_size=28.0,
              strides=(8, 16, 32, 64), method=method)
    got = troi.multilevel_roi_align(
        [torch.from_numpy(p) for p in pyramid], torch.from_numpy(rois),
        **kw).numpy()
    assert got.shape == (T, R, 7, 7, 16)
    levels = troi.level_targets(torch.from_numpy(rois), 4, 1, 28.0)
    assert len(set(levels.flatten().tolist())) == 4
    for t in range(T):
        want = jroi.multilevel_roi_align(
            [jnp.asarray(p[t]) for p in pyramid], jnp.asarray(rois[t]),
            **kw)
        np.testing.assert_allclose(got[t], np.asarray(want), rtol=1e-5,
                                   atol=ATOL)


def test_multilevel_rejects_other_methods():
    pyramid = [torch.zeros(1, s, s, 8) for s in (8, 4)]
    with pytest.raises(ValueError, match="method"):
        troi.multilevel_roi_align(pyramid, torch.zeros(1, 2, 4),
                                  strides=(8, 16), method="align")


def test_b5_canvas_is_the_b2_canvas_padded_to_16():
    """At 512^2 the B5 canvas is B2's 64x98 shelf with 14 zero columns
    (112 wide, ``tao_amodal_tpu/ops/roi.py:223-224``), and the RoIs land
    on the same canvas coordinates."""
    rs = np.random.RandomState(2)
    pyramid = [torch.from_numpy(rs.rand(1, s, s, 4).astype(np.float32))
               for s in (64, 32, 16, 8)]
    rois = torch.from_numpy(_rois(rs, 6, 400, 8, 100)[None])
    kw = dict(canonical_level=1, strides=(8, 16, 32, 64))
    c2, r2 = troi.pack_levels(pyramid, rois, **kw)
    c5, r5 = troi.pack_levels(pyramid, rois, width_multiple=16, **kw)
    assert c2.shape == (1, 64, 98, 4) and c5.shape == (1, 64, 112, 4)
    assert torch.equal(c5[:, :, :98], c2) and not c5[:, :, 98:].any()
    assert torch.equal(r5, r2)


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """The JAX pipeline on its plain route (``pallas_pooling=False``,
    ``pooling="packed"``) and the port's with ``pallas_pooling=True`` on
    the same (bridged, perturbed) weights."""
    pipe, variables = jax_pipeline(seed=2, pooling="packed")
    npz = save_npz(tmp_path_factory.mktemp("w"), variables)
    return pipe, variables, torch_pipeline(npz, pallas_pooling=True)


def test_detector_pallas_pooling_matches_jax(bridged, monkeypatch):
    """The whole ``ClipDetector`` output dict with ``pallas_pooling=True``
    (RoIs pooled through B5's wrapper, its plain version here) against
    the JAX detector's plain route, at the tolerances of
    ``test_torch_port_detector.py``: integers exact, boxes rtol 1e-4 +
    atol 1e-3 px, scores atol 1e-5, features rtol/atol 1e-4."""
    pipe, variables, tp = bridged
    assert tp.detector.pallas_pooling
    calls = []
    orig = tprroi.prroi_packed_pallas_torch
    monkeypatch.setattr(tprroi, "prroi_packed_pallas_torch",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    clip = random_clip(4)
    want = jax.jit(pipe.detector.apply)(variables["detector"],
                                        jnp.asarray(clip))
    with torch.no_grad():
        got = tp.detector(torch.from_numpy(clip))
    # One B5 pooling per clip, on a canvas padded to a multiple of 16.
    assert len(calls) == 1 and calls[0][2] % 16 == 0, calls
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-5)
    np.testing.assert_allclose(got["roi_features"].numpy(),
                               np.asarray(want["roi_features"]),
                               rtol=1e-4, atol=1e-4)
    assert (got["classes"] >= 0).any()


def test_pipeline_pallas_pooling_matches_jax(bridged):
    """``AmodalPipeline.create(pallas_pooling=True).streaming`` over two
    clips of one scene with the SORT state threaded, against the JAX
    pipeline's plain route: integers exact, boxes rtol 1e-4 + atol 1e-3
    px, scores atol 1e-5 (as ``test_torch_port_pipeline.py``)."""
    pipe, variables, tp = bridged
    run = jax.jit(lambda c, s: pipe.streaming(variables, c, s,
                                              score_thr=0.0))
    rs = np.random.RandomState(6)
    base = random_clip(7)[:1]
    js, ts = pipe.init_tracker_state(), tp.init_tracker_state()
    for _ in range(2):
        clip = base + 0.01 * rs.randn(*random_clip(0).shape).astype(
            np.float32)
        want, js = run(jnp.asarray(clip), js)
        got, ts = tp.streaming(torch.from_numpy(clip), ts, score_thr=0.0)
        for k in ("classes", "track_ids", "valid"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        for k in ("boxes", "visible_boxes"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(got["scores"].numpy(),
                                   np.asarray(want["scores"]), atol=1e-5)
    assert int(ts.next_id) == int(js.next_id) > 1
