"""The last options of the JAX detector in the port, held against the JAX
package on the CPU: ``RPNHead``'s packed mode, RoIAlign
(``roi_align`` and ``multilevel_roi_align(method="align")``),
``prroi_pool_batched``, and the GTR checkpoint loader.

Tolerances, and why.  f32: rtol 1e-5 + atol 1e-5 on N(0, 1) maps (the
same taps and products in another summation order, XLA fusing some into
FMAs); the packed RPN against the port's per-level heads 1e-5 too (the
CPU's convolution may pick another algorithm for the canvas's shape).
bf16: B8's rule (``tests/test_torch_port_bf16_modules.py``: max |d| <=
1e-2 max|ref|, mean |d| <= 1e-3 mean|ref|) against JAX jitted with XLA's
excess precision off, and the packed RPN equal to the per-level one
exactly (the CPU rounds each bf16 product from its float64 sum, whatever
the canvas).  The GTR loader: the converted tree equal to JAX's array
for array, and the detectors' outputs by the f32 rule of
``tests/test_torch_port_detector.py`` (integers exact; boxes rtol 1e-4 +
atol 1e-3 px, scores atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_bf16_modules import assert_close, bridge
from torch_port_fixtures import (
    TINY,
    gtr_state_dict,
    jax_pipeline,
    one_torch_thread,
    random_clip,
)

NO_EXCESS = {"xla_allow_excess_precision": False}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LEVELS = (16, 8, 4, 2, 1)  # P3..P7 of a 128^2 frame

_one_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def f32(a):
    return np.array(jnp.asarray(a, jnp.float32))


def close(got, want, dt, what=""):
    if dt == "f32":
        np.testing.assert_allclose(f32(got) if not torch.is_tensor(got)
                                   else got.float().numpy(), f32(want),
                                   rtol=1e-5, atol=1e-5, err_msg=what)
    else:
        assert_close(got, want, what)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rpn_packed_matches_jax_and_per_level(dt):
    """``RPNHead(packed=True)`` against JAX's packed mode on a P3-P7
    pyramid of 2 frames, and against the port's per-level mode."""
    from tao_amodal_tpu.models.rpn import RPNHead as JaxRPN
    from tao_amodal_torch.models.rpn import RPNHead

    jdt, tdt = DTYPES[dt]
    rs = np.random.RandomState(3)
    feats = [rs.randn(2, n, n, 32).astype(np.float32) for n in LEVELS]
    head = JaxRPN(num_anchors=3, features=32, dtype=jdt)
    variables = head.init(jax.random.PRNGKey(0), [jnp.asarray(f)
                                                  for f in feats])
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32)
        if a.ndim == 1 else a, variables)
    want = jax.jit(lambda v, f: head.apply(v, f, packed=True),
                   compiler_options=NO_EXCESS)(
        variables, [jnp.asarray(f).astype(jdt) for f in feats])
    port = bridge(RPNHead(3, 32, dtype=tdt), variables)
    x = [torch.from_numpy(f).to(tdt).permute(0, 3, 1, 2) for f in feats]
    with torch.no_grad():
        got = port(x, packed=True)
        per_level = port(x)
    for i, n in enumerate(LEVELS):
        for g, w, p, what in ((got[0][i], want[0][i], per_level[0][i], "obj"),
                              (got[1][i], want[1][i], per_level[1][i],
                               "delta")):
            assert g.shape == (2, n, n, 3 if what == "obj" else 12)
            close(g, w, dt, f"{what} P{i + 3}")
            if dt == "bf16":
                assert torch.equal(g, p), (what, i)
            else:
                torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-5)


def _rois(rs, n, span):
    xy = rs.uniform(-8, span, (n, 2))
    r = np.concatenate([xy, xy + rs.uniform(2, span / 2, (n, 2))], -1)
    r[0] = [-20.0, -20.0, 5.0, 5.0]          # past the top-left corner
    r[1] = [span - 3, span - 3, span + 40, span + 40]
    r[2] = [10.0, 10.0, 10.0, 10.0]          # zero area
    return r.astype(np.float32)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_roi_align_matches_jax(dt):
    """``roi_align`` (batched over 2 frames) against JAX's per frame, at
    two spatial scales, with RoIs past the map's edges and of zero area;
    output in the map's dtype."""
    from tao_amodal_tpu.ops.roi import roi_align as jax_align
    from tao_amodal_torch.ops.roi import roi_align

    jdt, tdt = DTYPES[dt]
    rs = np.random.RandomState(4)
    feat = rs.randn(2, 12, 17, 16).astype(np.float32)
    rois = np.stack([_rois(rs, 9, 60.0) for _ in range(2)])
    for scale in (0.25, 0.125):
        got = roi_align(torch.from_numpy(feat).to(tdt),
                        torch.from_numpy(rois), 7, scale)
        assert got.dtype == tdt and got.shape == (2, 9, 7, 7, 16)
        for t in range(2):
            want = jax.jit(lambda f, r: jax_align(f, r, 7, scale),
                           compiler_options=NO_EXCESS)(
                jnp.asarray(feat[t]).astype(jdt), jnp.asarray(rois[t]))
            close(got[t], want, dt, f"frame {t} scale {scale}")


@pytest.mark.parametrize("dt", list(DTYPES))
def test_multilevel_align_and_prroi_batched_match_jax(dt):
    """``multilevel_roi_align(method="align")`` on a P3-P6 pyramid of 2
    frames against JAX's per frame (its one-hot level select included),
    and ``prroi_pool_batched`` (RoIs of several images) against JAX's."""
    from tao_amodal_tpu.ops import roi as jroi
    from tao_amodal_torch.ops import roi as troi

    jdt, tdt = DTYPES[dt]
    rs = np.random.RandomState(5)
    pyramid = [rs.randn(2, n, n, 16).astype(np.float32)
               for n in (16, 8, 4, 2)]
    rois = np.stack([_rois(rs, 12, 120.0) for _ in range(2)])
    kw = dict(canonical_level=1, strides=(8, 16, 32, 64))
    got = troi.multilevel_roi_align(
        [torch.from_numpy(p).to(tdt) for p in pyramid],
        torch.from_numpy(rois), method="align", **kw)
    assert got.dtype == tdt
    for t in range(2):
        want = jax.jit(lambda p, r: jroi.multilevel_roi_align(
            p, r, method="align", **kw), compiler_options=NO_EXCESS)(
            [jnp.asarray(p[t]).astype(jdt) for p in pyramid],
            jnp.asarray(rois[t]))
        close(got[t], want, dt, f"align frame {t}")

    feats = rs.randn(3, 10, 14, 16).astype(np.float32)
    boxes = _rois(rs, 7, 40.0)
    batch = np.array([2, 0, 1, 1, 0, 2, 2])
    got = troi.prroi_pool_batched(torch.from_numpy(feats).to(tdt),
                                  torch.from_numpy(boxes),
                                  torch.from_numpy(batch), 7, 0.25)
    want = jax.jit(lambda f, r, b: jroi.prroi_pool_batched(
        f, r, b, 7, 0.25), compiler_options=NO_EXCESS)(
        jnp.asarray(feats).astype(jdt), jnp.asarray(boxes),
        jnp.asarray(batch))
    assert got.dtype == torch.float32 and got.shape == (7, 7, 7, 16)
    close(got, want, dt, "prroi_pool_batched")


@pytest.fixture(scope="module")
def gtr(tmp_path_factory):
    """A GTR-named checkpoint at TINY's depth saved with ``torch.save``,
    and its state_dict."""
    sd = gtr_state_dict(7, TINY["backbone_stages"], TINY["num_classes"])
    path = tmp_path_factory.mktemp("gtr") / "gtr.pth"
    torch.save(sd, path)
    return path, sd


def test_gtr_conversion_equals_jax_array_for_array(gtr):
    """The port's ``convert_detector_checkpoint`` (from the file, through
    ``torch.load(weights_only=True)``) against JAX's (from the mapping):
    the same keys, every array equal; with ``seed_variables`` the same
    grafted tree and report as JAX's ``load_pretrain``."""
    from tao_amodal_tpu.utils import torch_convert as jtc
    from tao_amodal_tpu.utils.checkpoint import flatten as jflat
    from tao_amodal_torch.utils import torch_convert as ttc

    path, sd = gtr
    kw = dict(num_classes=TINY["num_classes"],
              stage_sizes=TINY["backbone_stages"])
    got = ttc.flatten(ttc.convert_detector_checkpoint(str(path), **kw))
    want = jflat(jtc.convert_detector_checkpoint(sd, **kw))
    assert set(got) == set(want) and len(got) > 100
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    _, variables = jax_pipeline(seed=2)
    seed = jax.tree_util.tree_map(np.asarray, variables["detector"])
    seed["params"]["extra"] = {"w": np.zeros(3, np.float32)}
    g_tree, g_report = ttc.convert_detector_checkpoint(
        sd, **kw, seed_variables=seed)
    w_tree, w_report = jtc.convert_detector_checkpoint(
        sd, **kw, seed_variables=seed)
    g_flat, w_flat = ttc.flatten(g_tree), jflat(w_tree)
    assert set(g_flat) == set(w_flat)
    for k in w_flat:
        np.testing.assert_array_equal(g_flat[k], np.asarray(w_flat[k]))
    assert g_report == w_report and g_report["missing"] == [
        "params/extra/w"]


def test_gtr_loaded_detectors_match_jax(gtr):
    """``load_gtr_checkpoint`` into the port's pipeline, and JAX's
    ``ClipDetector`` on JAX's converted variables: the detector outputs
    by the f32 rule.  Into an int8 trunk each conv's kernel becomes its
    ``qkernel``."""
    from tao_amodal_tpu.utils import torch_convert as jtc
    from tao_amodal_torch.pipeline import AmodalPipeline
    from tao_amodal_torch.utils.torch_convert import load_gtr_checkpoint

    path, sd = gtr
    pipe, _ = jax_pipeline(seed=2)
    jvars = jtc.convert_detector_checkpoint(
        sd, TINY["num_classes"], stage_sizes=TINY["backbone_stages"])
    tp = AmodalPipeline.create(**TINY, device="cpu")
    expander = {k: v.clone() for k, v in tp.expander.state_dict().items()}
    assert load_gtr_checkpoint(tp, str(path)) is tp.detector
    for k, v in tp.expander.state_dict().items():  # GTR has no expander
        assert torch.equal(v, expander[k])
    clip = random_clip(3)
    want = jax.jit(pipe.detector.apply)(jvars, jnp.asarray(clip))
    with torch.no_grad():
        got = tp.detector(torch.from_numpy(clip))
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(want["classes"]))
    assert (got["classes"] >= 0).any()
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-5)

    q8 = AmodalPipeline.create(**TINY, int8_backbone=True, device="cpu")
    load_gtr_checkpoint(q8.detector, sd)
    np.testing.assert_array_equal(
        q8.detector.backbone.Bottleneck_1.ConvBN_1.qkernel.detach().numpy(),
        jvars["params"]["backbone"]["Bottleneck_1"]["ConvBN_1"]["Conv_0"][
            "kernel"])
    s2d = AmodalPipeline.create(**TINY, stem="s2d", device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_gtr_checkpoint(s2d, sd)  # GTR's stem is the classic 7x7
