"""The bf16 forms of the port's modules held against the JAX package's
on the CPU, module by module, each on the same inputs.

Every module runs in bf16 at JAX's rounding points
(``tao_amodal_torch/models/layers.py``): the s2d preprocessing, the
stem, one Bottleneck, the unfused trunk, B4's plain version (against
``bottleneck_chain_reference`` and the TPU kernel in interpret mode),
the FPN, the RPN head, each PrRoI route (B2, B5 and B6 through their
TPU kernels in interpret mode, and JAX's XLA ``prroi_pool``), the box
head and the expander.  Weights come from the JAX modules' own init,
with BatchNorm statistics, biases and zero-initialised layers perturbed
(``torch_port_fixtures.perturb``), bridged through the npz reader.

Tolerance (B8's rule, ``tests/test_torch_port_isolation.py``): max |d|
<= 1e-2 max|ref| and mean |d| <= 1e-3 mean|ref|.  Both sides sum each
product in f32 on the same bf16 operands, in other orders, so a result
near a bf16 rounding boundary lands one ulp apart now and then, and
deeper layers carry such flips on.  The unfused trunk stacks 17 convs:
there the bound is the rule or, where JAX's own two compilations of the
trunk (op by op, and jitted with XLA's excess precision off, so that
both keep every bf16 rounding) disagree by more, twice their
disagreement.  Output dtypes are asserted to be JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from torch_port_fixtures import jax_pipeline, save_npz, torch_pipeline

BF16 = dict(dtype=jnp.bfloat16, stem="s2d_pre")
NO_EXCESS = {"xla_allow_excess_precision": False}


def f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def t_of(a, dtype=torch.bfloat16):
    """A JAX or numpy array as a torch tensor of ``dtype``."""
    return torch.from_numpy(f32(a).copy()).to(dtype)


def assert_close(got, want, what="", spread=None):
    """B8's rule (or twice ``spread``, a (max, mean) disagreement, where
    that is larger); ``got`` must have ``want``'s dtype."""
    want_dtype = {jnp.bfloat16: torch.bfloat16,
                  jnp.float32: torch.float32}[jnp.asarray(want).dtype.type]
    assert got.dtype == want_dtype, (what, got.dtype, want_dtype)
    g, w = got.float().numpy(), f32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    d = np.abs(g - w)
    max_b = 1e-2 * np.abs(w).max()
    mean_b = 1e-3 * np.abs(w).mean()
    if spread is not None:
        max_b, mean_b = max(max_b, 2 * spread[0]), max(mean_b,
                                                       2 * spread[1])
    assert d.max() <= max_b, (what, d.max(), max_b)
    assert d.mean() <= mean_b, (what, d.mean(), mean_b)


def bridge(module, variables):
    """Load a JAX module's variables into the port's ``module``."""
    from tao_amodal_torch.utils import weights

    flat = {}
    for col, tree in variables.items():
        for path, leaf in traverse_util.flatten_dict(dict(tree)).items():
            flat["/".join(("m", col, *path))] = np.asarray(leaf, np.float32)
    holder = torch.nn.Module()
    holder.m = module
    weights.load_into(holder, flat)
    return module.eval()


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """The bf16 s2d_pre pipeline on both sides, one set of weights."""
    pipe, variables = jax_pipeline(seed=4, **BF16)
    npz = save_npz(tmp_path_factory.mktemp("bf16"), variables)
    return pipe, variables, torch_pipeline(npz, dtype=torch.bfloat16,
                                           stem="s2d_pre")


def sub(variables, name):
    """The detector's ``name`` submodule variables."""
    d = variables["detector"]
    return {c: d[c][name] for c in d if name in d[c]}


def test_space_to_depth_is_exact():
    from tao_amodal_tpu.ops.pallas.preproc import space_to_depth as jfold
    from tao_amodal_torch.ops.preproc import space_to_depth

    x = np.random.RandomState(0).randn(2, 8, 12, 3).astype(np.float32)
    got = space_to_depth(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfold(jnp.asarray(x), 4)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hw,out", [((60, 80), (48, 64)),
                                    ((45, 61), (32, 48))])
def test_preprocess_s2d_matches_jax(dtype, hw, out):
    """``preprocess_clip_s2d`` against JAX's on uint8 frames, 4:3 and a
    ragged source: f32 atol 1e-5 (same matrices, f32 einsums), bf16 by
    B8's rule, in the dtype asked for."""
    from tao_amodal_tpu.ops.pallas.preproc import preprocess_clip_s2d as jpp
    from tao_amodal_torch.ops.preproc import preprocess_clip_s2d

    frames = np.random.RandomState(1).randint(0, 256, (3, *hw, 3),
                                              np.uint8)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want, wscale = jpp(jnp.asarray(frames), out_size=out, compute_dtype=jdt)
    got, scale = preprocess_clip_s2d(torch.from_numpy(frames), out_size=out,
                                     dtype=tdt)
    assert scale == wscale and got.shape == (3, out[0] // 4, out[1] // 4, 48)
    if dtype == "f32":
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), f32(want), atol=1e-5)
    else:
        assert_close(got, want, "preproc")


@pytest.mark.parametrize("cin,k,stride", [(48, 3, 1), (3, 7, 2),
                                          (64, 1, 1)])
def test_convbn_matches_jax(cin, k, stride):
    """``ConvBN`` in bf16: the s2d stems' 3x3 from 48 channels, the
    classic 7x7/2 and a 1x1; bf16 output."""
    from tao_amodal_tpu.models.backbones import ConvBN as JConvBN
    from tao_amodal_torch.models.backbones import ConvBN
    from torch_port_fixtures import perturb

    rs = np.random.RandomState(k)
    x = jnp.asarray(rs.randn(2, 12, 16, cin).astype(np.float32),
                    jnp.bfloat16)
    jm = JConvBN(64, (k, k), strides=stride, dtype=jnp.bfloat16)
    v = perturb(jm.init(jax.random.PRNGKey(k), x), rs)
    m = bridge(ConvBN(cin, 64, k, strides=stride, dtype=torch.bfloat16), v)
    with torch.no_grad():
        got = m(t_of(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, jm.apply(v, x), "convbn")


def test_bottleneck_matches_jax():
    """A strided Bottleneck with its projection, in bf16."""
    from tao_amodal_tpu.models.backbones import Bottleneck as JB
    from tao_amodal_torch.models.backbones import Bottleneck
    from torch_port_fixtures import perturb

    rs = np.random.RandomState(2)
    x = jnp.asarray(np.maximum(rs.randn(2, 12, 16, 64), 0).astype(
        np.float32), jnp.bfloat16)
    jm = JB(32, strides=2, downsample=True, dtype=jnp.bfloat16)
    v = perturb(jm.init(jax.random.PRNGKey(2), x), rs)
    m = bridge(Bottleneck(64, 32, strides=2, downsample=True,
                          dtype=torch.bfloat16), v)
    with torch.no_grad():
        got = m(t_of(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, jm.apply(v, x), "bottleneck")


@pytest.mark.parametrize("stem", ["s2d_pre", "s2d", "classic"])
def test_unfused_trunk_matches_jax(stem):
    """The (1, 1, 1, 1) trunk of the CPU tests in bf16 with each stem,
    every stage output against JAX's, within the rule or twice JAX's own
    op-by-op vs jitted spread (module docstring)."""
    from tao_amodal_tpu.models.backbones import ResNet as JResNet
    from tao_amodal_torch.models.backbones import ResNet
    from torch_port_fixtures import perturb

    rs = np.random.RandomState(3)
    shape = (2, 12, 16, 48) if stem == "s2d_pre" else (2, 48, 64, 3)
    x = jnp.asarray(rs.randn(*shape).astype(np.float32))
    kw = dict(stage_sizes=(1, 1, 1, 1), out_stages=(2, 3, 4))
    jm = JResNet(dtype=jnp.bfloat16, stem=stem, **kw)
    v = perturb(jm.init(jax.random.PRNGKey(3), x), rs)
    want = jm.apply(v, x)
    other = jax.jit(jm.apply, compiler_options=NO_EXCESS)(v, x)
    m = bridge(ResNet(dtype=torch.bfloat16, stem=stem, **kw), v)
    with torch.no_grad():
        got = m(torch.from_numpy(f32(x).copy()).permute(0, 3, 1, 2))
    for i, (g, w, o) in enumerate(zip(got, want, other)):
        d = np.abs(f32(o) - f32(w))
        assert_close(g.permute(0, 2, 3, 1), w, f"stage {i + 2}",
                     spread=(d.max(), d.mean()))


def _chain_params(rs, cin, m, blocks):
    """JAX folded block params (HWIO), the first with a projection."""
    params = []
    for b in range(blocks):
        c = cin if b == 0 else 4 * m
        p = dict(wa=rs.randn(1, 1, c, m) * c ** -0.5,
                 w3=rs.randn(3, 3, m, m) * (9 * m) ** -0.5,
                 wb=rs.randn(1, 1, m, 4 * m) * m ** -0.5)
        if b == 0:
            p["wd"] = rs.randn(1, 1, c, 4 * m) * c ** -0.5
        for w in list(p):
            p["b" + w[1:]] = 0.1 * rs.randn(p[w].shape[-1])
        params.append({k: v.astype(np.float32) for k, v in p.items()})
    return params


def test_chain_plain_matches_jax_reference_and_kernel():
    """B4's plain version in bf16 (``bottleneck_chain_torch`` on a bf16
    ``x``) against JAX's ``bottleneck_chain_reference`` on a bf16 ``x``
    and against the TPU kernel run as ``tests/test_fused_stage.py:46``
    runs it (interpret mode): 2 blocks, the first with the projection
    from 32 channels, M = 8; bf16 output."""
    import tao_amodal_tpu.ops.pallas.fused_stage as F
    from tao_amodal_torch.ops.fused_stage import bottleneck_chain_torch

    rs = np.random.RandomState(6)
    params = _chain_params(rs, 32, 8, 2)
    x = jnp.asarray(np.maximum(rs.randn(2, 16, 12, 32), 0).astype(
        np.float32), jnp.bfloat16)
    ref = F.bottleneck_chain_reference(x, params)
    layout = [(("wd" in p), 8 + 2 * ("wd" in p)) for p in params]
    flat = []
    for p in params:
        flat += F._block_param_arrays(p, x.dtype)
    kernel = F._fused_chain_forward(x, flat, layout, 8, interpret=True)
    tparams = [{k: torch.from_numpy(v).permute(3, 2, 0, 1)
                if v.ndim == 4 else torch.from_numpy(v)
                for k, v in p.items()} for p in params]
    got = bottleneck_chain_torch(t_of(x), tparams)
    assert_close(got, ref, "chain vs reference")
    assert_close(got, kernel, "chain vs kernel")


def test_fpn_matches_jax(bridged):
    """The FPN in bf16 on bf16 trunk outputs: laterals, upsample-adds,
    posts and the two extra levels, each level bf16."""
    from tao_amodal_tpu.models.fpn import FPN as JFPN

    pipe, variables, tp = bridged
    rs = np.random.RandomState(7)
    feats = [jnp.asarray(np.maximum(rs.randn(2, h, w, c), 0).astype(
        np.float32), jnp.bfloat16)
        for h, w, c in ((6, 8, 512), (3, 4, 1024), (2, 2, 2048))]
    want = JFPN(256, num_extra_levels=2, dtype=jnp.bfloat16).apply(
        sub(variables, "fpn"), feats)
    with torch.no_grad():
        got = tp.detector.fpn([t_of(f).permute(0, 3, 1, 2) for f in feats])
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g.permute(0, 2, 3, 1), w, f"P{i + 3}")


def test_rpn_head_matches_jax(bridged):
    """The RPN tower and heads in bf16 per level (bf16 outputs), and
    ``select_proposals`` on them: f32 boxes and scores, proposals equal
    where the bf16 objectness ties break in index order (boxes atol
    1e-3 px, scores 1e-6)."""
    from tao_amodal_tpu.models.rpn import RPNHead as JRPN
    from tao_amodal_tpu.models.rpn import level_anchors as jla
    from tao_amodal_tpu.models.rpn import select_proposals as jsel
    from tao_amodal_torch.models.rpn import select_proposals

    pipe, variables, tp = bridged
    rs = np.random.RandomState(8)
    feats = [jnp.asarray(rs.randn(2, h, w, 256).astype(np.float32),
                         jnp.bfloat16)
             for h, w in ((6, 8), (3, 4), (2, 2), (1, 1), (1, 1))]
    jobjs, jdeltas = JRPN(num_anchors=3, dtype=jnp.bfloat16).apply(
        sub(variables, "rpn"), feats)
    with torch.no_grad():
        objs, deltas = tp.detector.rpn([t_of(f).permute(0, 3, 1, 2)
                                        for f in feats])
    for g, w in zip(objs + deltas, list(jobjs) + list(jdeltas)):
        assert_close(g, w, "rpn")
    det = tp.detector
    anchors = det.anchors([o.shape[1:3] for o in objs], "cpu")
    props, scores = select_proposals(objs, deltas, anchors, (48, 64),
                                     pre_nms_topk=20, post_nms_topk=16)
    assert props.dtype == scores.dtype == torch.float32
    for t in range(2):
        janchors = [jla(o.shape[1], o.shape[2], s, [sc], (0.5, 1.0, 2.0))
                    for o, s, sc in zip(jobjs, det.strides,
                                        det.anchor_scales)]
        wp, ws = jsel([jnp.asarray(o[t].float().numpy(), jnp.bfloat16)
                       for o in objs],
                      [jnp.asarray(d[t].float().numpy(), jnp.bfloat16)
                       for d in deltas],
                      janchors, (48, 64), pre_nms_topk=20, post_nms_topk=16,
                      exact_topk=True)
        np.testing.assert_allclose(props[t].numpy(), f32(wp), atol=1e-3)
        np.testing.assert_allclose(scores[t].numpy(), f32(ws), atol=1e-6)


@pytest.mark.parametrize("route", ["prroi_pool", "fused", "packed_pallas",
                                   "pool_pallas"])
def test_prroi_routes_match_jax_in_bf16(route):
    """Each PrRoI route on a bf16 map against its JAX counterpart (the
    TPU kernels in interpret mode), RoIs crossing the edges and one of
    zero area: JAX's ``prroi_pool`` (f32 out) and ``prroi_packed_fused``
    (B2, bf16 out; on the w-major canvas the JAX route builds) against
    ``prroi_pool`` and ``prroi_packed_torch``, ``prroi_packed_pallas``
    (B5, bf16) and ``prroi_pool_pallas`` (B6, f32) against theirs."""
    from tao_amodal_tpu.ops import roi as jroi
    from tao_amodal_tpu.ops.pallas import prroi as jp
    from tao_amodal_torch.ops import prroi, roi

    rs = np.random.RandomState(9)
    H, W, C, R = 12, 26, 16, 8
    feat = jnp.asarray(rs.randn(H, W, C).astype(np.float32), jnp.bfloat16)
    xy = rs.uniform(-2, 20, (R, 2))
    rois = np.concatenate([xy, xy + rs.uniform(0.5, 9, (R, 2))], 1)
    rois[0] = [3.0, 4.0, 3.0, 4.0]
    rois = rois.astype(np.float32)
    tf, tr = t_of(feat), torch.from_numpy(rois)
    if route == "prroi_pool":
        want = jroi.prroi_pool(feat, jnp.asarray(rois), 7, 1.0)
        got = roi.prroi_pool(tf, tr, 7, 1.0)
    elif route == "fused":
        Wpad = -(-W // 16) * 16
        canvas_t = jnp.zeros((Wpad, H, C), jnp.bfloat16).at[:W].set(
            feat.transpose(1, 0, 2))
        want = jp.prroi_packed_fused(canvas_t, jnp.asarray(rois), 7,
                                     pre_transposed=True, interpret=True)
        got = prroi.prroi_packed_torch(tf[None], tr[None])[0]
    elif route == "packed_pallas":
        want = jp.prroi_packed_pallas(feat, jnp.asarray(rois), 7,
                                      interpret=True)
        got = prroi.prroi_packed_pallas(tf, tr)
    else:
        want = jp.prroi_pool_pallas(feat, jnp.asarray(rois * 2), 7, 0.5,
                                    interpret=True)
        got = prroi.prroi_pool_pallas(tf, tr * 2, 7, 0.5)
    assert_close(got, want, route)


@pytest.mark.parametrize("method", ["prroi_packed", "prroi_packed_fused"])
def test_multilevel_roi_align_matches_jax_in_bf16(method, monkeypatch):
    """``multilevel_roi_align`` on a bf16 4:3 pyramid (P3..P6 at
    384x512 / 8: the 48x98 shelf): ``"prroi_packed"`` is JAX's XLA
    function (f32 out) and ``"prroi_packed_fused"`` B2's (bf16 out),
    each against JAX's route (B2 in interpret mode, monkeypatched as in
    ``tests/test_torch_port_roi.py``)."""
    import tao_amodal_tpu.ops.pallas.prroi as P
    from tao_amodal_tpu.ops import roi as jroi
    from tao_amodal_torch.ops import roi

    orig = P.prroi_packed_fused
    monkeypatch.setattr(
        P, "prroi_packed_fused",
        lambda f, r, out_size=7, wmaj=True, interpret=False,
        pre_transposed=False: orig(f, r, out_size=out_size, wmaj=wmaj,
                                   interpret=True,
                                   pre_transposed=pre_transposed))
    rs = np.random.RandomState(10)
    pyramid = [jnp.asarray(rs.randn(h, w, 16).astype(np.float32),
                           jnp.bfloat16)
               for h, w in ((48, 64), (24, 32), (12, 16), (6, 8))]
    xy = rs.uniform(0, 400, (12, 2))
    rois = np.concatenate([xy, xy + rs.uniform(8, 300, (12, 2))],
                          1).astype(np.float32)
    kw = dict(canonical_level=1, strides=(8, 16, 32, 64))
    want = jroi.multilevel_roi_align(pyramid, jnp.asarray(rois),
                                     method=method, **kw)
    got = roi.multilevel_roi_align([t_of(p)[None] for p in pyramid],
                                   torch.from_numpy(rois)[None],
                                   method=method, **kw)[0]
    assert_close(got, want, method)


def test_box_head_and_softmax_match_jax(bridged):
    """The box head in bf16 (logits, deltas and features bf16) and the
    detector's softmax at JAX's rounding points."""
    from tao_amodal_tpu.models.detector import RoIBoxHead as JHead
    from tao_amodal_torch.models import layers

    pipe, variables, tp = bridged
    rs = np.random.RandomState(11)
    pooled = jnp.asarray(rs.randn(10, 7, 7, 256).astype(np.float32),
                         jnp.bfloat16)
    want = JHead(tp.detector.num_classes, dtype=jnp.bfloat16).apply(
        sub(variables, "box_head"), pooled)
    with torch.no_grad():
        got = tp.detector.box_head(t_of(pooled))
    for g, w, what in zip(got, want, ("logits", "deltas", "features")):
        assert_close(g, w, what)
    probs = layers.softmax(t_of(want[0]))
    assert_close(probs, jax.nn.softmax(want[0], axis=-1), "softmax")


def test_expander_matches_jax(bridged):
    """The expander in bf16: bf16 features and f32 boxes in, f32 amodal
    boxes and bf16 deltas out, as JAX promotes them."""
    from tao_amodal_tpu.models.amodal_expander import AmodalExpander

    pipe, variables, tp = bridged
    rs = np.random.RandomState(12)
    feats = jnp.asarray(np.maximum(rs.randn(4, 8, 1024), 0).astype(
        np.float32), jnp.bfloat16)
    xy = rs.uniform(0, 40, (4, 8, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(2, 30, (4, 8, 2))],
                           -1).astype(np.float32)
    want = AmodalExpander(dtype=jnp.bfloat16).apply(
        variables["expander"], feats, jnp.asarray(boxes), image_hw=(48, 64))
    with torch.no_grad():
        got = tp.expander(t_of(feats), torch.from_numpy(boxes), (48, 64))
    assert want[0].dtype == jnp.float32 and want[1].dtype == jnp.bfloat16
    assert_close(got[0], want[0], "amodal")
    assert_close(got[1], want[1], "deltas")
