"""The port's DiMP/ATOM models and its deep-feature trackers held against
the JAX package on the CPU: the weight bridge for the IoUNet, the
``FilterClassifier`` and the feature ResNet (both ways); the IoUNet's
forward and modulation, DiMP's ``train_filter`` and ``classify``, the
IoUNet box ascent and its box gradient; the ResNet feature closures;
and whole tracks of ``atom_deep``, ``eco_deep``, ``dimp_deep`` and of
ATOM with IoUNet refinement.

Both packages run the same weights: the port's seeded modules, every
bias and BatchNorm statistic perturbed (``torch_port_fixtures.
perturb_module``), written out as JAX variable trees
(``weights.flat_variables``).  Sizes are small (a ``(1, 1, 1, 1)``
ResNet, search grids of 8 and 64 px); the JAX package's own tests of
these trackers are slow-marked, so this file runs the JAX side itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import (
    one_torch_thread,
    perturb_module,
    textured_target_frames,
)

pytestmark = pytest.mark.usefixtures("single_thread")

STAGES = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def single_thread():
    yield from one_torch_thread()


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jax_vars(module):
    from tao_amodal_torch.utils.torch_convert import unflatten
    from tao_amodal_torch.utils.weights import flat_variables

    return jax.tree_util.tree_map(jnp.asarray,
                                  unflatten(flat_variables(module)))


def _seeded(module, seed):
    from tao_amodal_torch.utils.weights import random_init_

    random_init_(module, torch.Generator().manual_seed(seed))
    return perturb_module(module, np.random.RandomState(seed)).eval()


def _iou_pair(channels=8, seed=0):
    """(port IoUNet, its JAX variables, the JAX module)."""
    from tao_amodal_torch.models.dimp import IoUNet as PIoU
    from tao_amodal_tpu.models.dimp import IoUNet as JIoU

    net = _seeded(PIoU(channels, device="cpu"), seed)
    return net, _jax_vars(net), JIoU()


def _feat(seed, h=9, w=11, c=8):
    return np.random.RandomState(seed).randn(h, w, c).astype(np.float32)


# --------------------------------------------------------------- bridge

def _jax_init_shapes(which):
    from tao_amodal_torch.utils.torch_convert import flatten
    from tao_amodal_tpu.models.backbones import ResNet
    from tao_amodal_tpu.models.dimp import FilterClassifier, IoUNet

    key = jax.random.PRNGKey(0)
    if which == "iou_net":
        init = lambda: IoUNet().init(  # noqa: E731
            key, jnp.zeros((9, 11, 8)), jnp.zeros(200),
            jnp.asarray([[0.0, 0.0, 4.0, 4.0]]))
    elif which == "filter_classifier":
        init = lambda: FilterClassifier(features=16).init(  # noqa: E731
            key, jnp.zeros((1, 6, 6, 8)))
    else:
        net = ResNet(stage_sizes=STAGES, out_stages=(2,))
        init = lambda: net.init(key, jnp.zeros((1, 32, 32, 3)))  # noqa: E731
    return {k: tuple(v.shape) for k, v in
            flatten(jax.eval_shape(init)).items()}


def _port_module(which):
    from tao_amodal_torch.models.backbones import ResNet
    from tao_amodal_torch.models.dimp import FilterClassifier, IoUNet

    if which == "iou_net":
        return IoUNet(8, device="cpu")
    if which == "filter_classifier":
        return FilterClassifier(8, features=16, device="cpu")
    return ResNet(stage_sizes=STAGES, out_stages=(2,))


@pytest.mark.parametrize("which", ["iou_net", "filter_classifier",
                                   "resnet"])
def test_weight_bridge_maps_every_leaf_both_ways(which):
    """The port's variables are JAX's init tree leaf for leaf (Flax's
    names, ``mod_proj`` among them; Dense kernels ``[in, out]`` against
    ``Linear``'s ``[out, in]``), and JAX-layout arrays loaded into the
    port come back out unchanged."""
    from tao_amodal_torch.utils.weights import flat_variables, load_variables

    want = _jax_init_shapes(which)
    module = _port_module(which)
    flat = flat_variables(module)
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    rs = np.random.RandomState(1)
    fresh = {k: rs.randn(*v).astype(np.float32) for k, v in want.items()}
    load_variables(module, fresh)
    back = flat_variables(module)
    assert set(back) == set(fresh)
    for k in fresh:
        np.testing.assert_array_equal(back[k], fresh[k], err_msg=k)
    if which == "iou_net":
        from tao_amodal_torch.models.dimp import IoUNet

        again = IoUNet.from_variables(fresh, device="cpu")
        assert torch.equal(again.Dense_0.weight, module.Dense_0.weight)
        assert torch.equal(again.mod_proj.weight.T,
                           _t(fresh["params/mod_proj/kernel"]))


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("train", [False, True])
def test_filter_classifier_matches_jax(train):
    """``FilterClassifier`` on bridged weights, with the running
    statistics and (``train=True``) with the batch's: within 1e-4 of the
    largest."""
    from tao_amodal_torch.models.dimp import FilterClassifier as P
    from tao_amodal_tpu.models.dimp import FilterClassifier as J

    net = _seeded(P(8, features=16, device="cpu"), 2)
    x = np.random.RandomState(3).randn(2, 7, 9, 8).astype(np.float32)
    with torch.no_grad():
        got = net(_t(x), train=train)
    if train:
        want, _ = J(features=16).apply(_jax_vars(net), jnp.asarray(x),
                                       train=True, mutable=["batch_stats"])
    else:
        want = J(features=16).apply(_jax_vars(net), jnp.asarray(x))
    assert _rel(got, want) < 1e-4


def test_iou_net_matches_jax():
    """The IoUNet's forward on 5 boxes (one past the map's edge) at a
    spatial scale of 1/4, and its modulation vector: within 1e-4 of each
    output's largest."""
    net, jv, jm = _iou_pair()
    feat = _feat(4)
    boxes = np.array([[2, 3, 20, 30], [0, 0, 44, 36], [10.5, 7.25, 18, 16],
                      [30, 20, 52, 50], [4, 4, 9, 40]], np.float32)
    ref = np.array([6.0, 5.0, 30.0, 26.0], np.float32)
    with torch.no_grad():
        mod = net.modulation(_t(feat), _t(ref), spatial_scale=0.25)
        got = net(_t(feat), mod, _t(boxes), spatial_scale=0.25)
    jmod = jm.apply(jv, jnp.asarray(feat), jnp.asarray(ref),
                    spatial_scale=0.25, method="modulation")
    want = jm.apply(jv, jnp.asarray(feat), jmod, jnp.asarray(boxes),
                    spatial_scale=0.25)
    assert mod.shape == (200,)
    assert _rel(mod, jmod) < 1e-4
    assert _rel(got, want) < 1e-4


# DiMP's filter solve (5 x 8 Gauss-Newton/CG over a 4 x 4 x 8 filter on
# 3 samples) is linear in the filter and well conditioned: against a
# float64 run of the same solver on these inputs
# (``experiments/discriminative_solves.py bounds``) JAX lands within 3.4e-7
# of the largest entry and the port within 2.0e-7 (each other 3.7e-7),
# so GN_RTOL = 1e-5 holds them with a margin near 30.
GN_RTOL = 1e-5


def test_train_filter_and_classify_match_jax():
    """``train_filter`` (the solution and its 6 losses) and ``classify``
    on 3 samples of ``[10, 10, 8]`` with Gaussian labels: the filter
    within GN_RTOL of its largest, the losses within 1e-5, the responses
    within 1e-4."""
    from tao_amodal_torch.models import dimp as pd
    from tao_amodal_tpu.models import dimp as jd

    rs = np.random.RandomState(5)
    feats = rs.randn(3, 10, 10, 8).astype(np.float32)
    yy, xx = np.mgrid[:7, :7]
    labels = np.stack([np.exp(-((yy - r) ** 2 + (xx - c) ** 2) / 8.0)
                       for r, c in ((3, 3), (2, 4), (4, 3))]).astype(
                           np.float32)
    filt, losses = pd.train_filter(_t(feats), _t(labels), (4, 4, 8))
    jfilt, jlosses = jd.train_filter(jnp.asarray(feats), jnp.asarray(labels),
                                     (4, 4, 8))
    assert losses.shape == jlosses.shape == (6,)
    assert _rel(losses, jlosses) < 1e-5
    assert float(losses[-1]) < float(losses[0])
    assert _rel(filt, jfilt) < GN_RTOL
    got = pd.classify(_t(feats), _t(np.asarray(jfilt)))
    want = jd.classify(jnp.asarray(feats), jfilt)
    assert got.shape == want.shape == (3, 7, 7)
    assert _rel(got, want) < 1e-4


def test_refine_box_ascent_matches_jax():
    """The IoU's gradient in ``(cx, cy, log w, log h)`` at a box (the
    ascent's step direction) within 1e-4 of its largest, and 5 ascent
    steps of 0.5 at a spatial scale of 1/4 (the refined box within
    1e-4 of its largest coordinate, its IoU within 1e-4 of itself); the
    ascent runs under ``torch.no_grad`` as the trackers call it."""
    from tao_amodal_torch.models import dimp as pd
    from tao_amodal_tpu.models import dimp as jd

    net, jv, jm = _iou_pair(seed=6)
    feat = _feat(7)
    box = np.array([8.0, 6.0, 30.0, 28.0], np.float32)
    with torch.no_grad():
        mod = net.modulation(_t(feat), _t(box), spatial_scale=0.25)
    jmod = jnp.asarray(mod.numpy())
    p = pd._to_param(_t(box)).requires_grad_(True)
    iou = net(_t(feat), mod, pd._to_box(p)[None], spatial_scale=0.25)[0]
    (g,) = torch.autograd.grad(iou, p)

    def jiou(q):
        w, h = jnp.exp(q[2]), jnp.exp(q[3])
        b = jnp.array([q[0] - w / 2, q[1] - h / 2, q[0] + w / 2,
                       q[1] + h / 2])
        return jm.apply(jv, jnp.asarray(feat), jmod, b[None],
                        spatial_scale=0.25)[0]

    jg = jax.grad(jiou)(jnp.asarray(p.detach().numpy()))
    assert np.abs(np.asarray(jg)).max() > 0
    assert _rel(g, jg) < 1e-4
    with torch.no_grad():
        got, got_iou = pd.refine_box_ascent(net, _t(feat), mod, _t(box),
                                            steps=5, step_size=0.5,
                                            spatial_scale=0.25)
    want, want_iou = jd.refine_box_ascent(jm, jv, jnp.asarray(feat), jmod,
                                          jnp.asarray(box), steps=5,
                                          step_size=0.5, spatial_scale=0.25)
    assert not np.allclose(np.asarray(want), box)
    assert _rel(got, want) < 1e-4
    assert _rel(got_iou, want_iou) < 1e-4


# ------------------------------------------------------------- features

def test_resnet_feature_fns_match_jax():
    """``make_resnet_feature_fn`` (stride 8, a batch of 3 crops of 64 px
    -> ``[3, 8, 8, 512]``) and ``make_dimp_extractor`` (stride 16, one
    crop -> ``[4, 4, 1024]``) on the bridged trunk: within 1e-4 of the
    largest."""
    from tao_amodal_torch.trackers import deep_features as pd
    from tao_amodal_tpu.trackers import deep_features as jd

    crops = np.random.RandomState(8).uniform(0, 255, (3, 64, 64, 3)).astype(
        np.float32)
    fn, model, sample = pd.make_resnet_feature_fn(
        8, out_stage=2, stage_sizes=STAGES, device="cpu")
    perturb_module(model, np.random.RandomState(8))
    jfn, _, jsample = jd.make_resnet_feature_fn(
        8, out_stage=2, variables=_jax_vars(model), stage_sizes=STAGES)
    assert sample == jsample == 64
    got = fn(_t(crops))
    assert tuple(got.shape) == (3, 8, 8, 512)
    for i in range(3):
        assert _rel(got[i], jfn(jnp.asarray(crops[i]))) < 1e-4
    ext, model = pd.make_dimp_extractor(64, stage_sizes=STAGES, seed=1,
                                        device="cpu")
    jext, _ = jd.make_dimp_extractor(64, variables=_jax_vars(model),
                                     stage_sizes=STAGES)
    got = ext(_t(crops[0]))
    assert tuple(got.shape) == (4, 4, 1024)
    assert _rel(got, jext(jnp.asarray(crops[0]))) < 1e-4


# --------------------------------------------------------- whole tracks

# Held as the pixel trackers' tracks (tests/test_torch_port_
# discriminative.py): boxes within 2e-3 of the box's size + 0.1 px,
# scores within 2e-3 + 2e-3 of the largest.
def _tracks_agree(pb, ps, jb, js):
    jb, js = np.asarray(jb), np.asarray(js)
    assert pb.shape == jb.shape and np.isfinite(pb).all()
    size = np.abs(jb[:, 2:]).max(1, keepdims=True)
    assert (np.abs(pb - jb) <= 0.1 + 2e-3 * size).all(), np.abs(pb - jb).max()
    assert (np.abs(ps - js) <= 2e-3 + 2e-3 * np.abs(js).max()).all(), (ps, js)


def _frames(T=6):
    frames, boxes = textured_target_frames(T, 120, 160, 3, size=(34, 30),
                                           speed=(7, 3))
    return list(frames), boxes


@pytest.mark.parametrize("name,kw", [
    ("atom_deep", dict(search_size=8)),
    ("eco_deep", dict(search_size=8)),
    ("dimp_deep", dict(search_size=64)),
])
def test_deep_tracks_match_jax(name, kw):
    """``build_tracker(name, stage_sizes=(1, 1, 1, 1), device="cpu")``
    over 6 frames against JAX's ``build_tracker`` given the port's trunk (and
    DiMP's IoUNet) as ``variables`` (``iou_variables``)."""
    from tao_amodal_torch.trackers.factory import build_tracker as pb
    from tao_amodal_tpu.trackers.factory import build_tracker as jb

    frames, gt = _frames()
    pt = pb(name, stage_sizes=STAGES, device="cpu", **kw)
    if name == "dimp_deep":
        perturb_module(pt.extract.model, np.random.RandomState(9))
        jkw = dict(variables=_jax_vars(pt.extract.model),
                   iou_variables=_jax_vars(pt.iou_net))
    else:
        perturb_module(pt.feature_fn.model, np.random.RandomState(9))
        jkw = dict(variables=_jax_vars(pt.feature_fn.model))
    boxes, scores, _ = pt.track(frames, gt[0])
    jboxes, jscores, _ = jb(name, stage_sizes=STAGES, **kw, **jkw).track(
        frames, gt[0])
    _tracks_agree(boxes, scores, jboxes, jscores)


def test_atom_with_iou_refinement_matches_jax():
    """ATOM's optional IoUNet refinement (3 ascent steps of 0.25 on the
    chosen scale's pixel features, 9 channels) over 6 frames against
    JAX's ``AtomTracker`` with the same IoUNet; the flags equal."""
    from tao_amodal_torch.models.dimp import IoUNet as PIoU
    from tao_amodal_torch.trackers.atom import AtomTracker as PA
    from tao_amodal_tpu.models.dimp import IoUNet as JIoU
    from tao_amodal_tpu.trackers.atom import AtomTracker as JA

    net = _seeded(PIoU(9, device="cpu"), 10)
    kw = dict(search_size=32, filter_size=5, train_skipping=2)
    pt = PA(iou_net=net, device="cpu", **kw)
    jt = JA(iou_net=JIoU(), iou_variables=_jax_vars(net), **kw)
    frames, gt = _frames()
    boxes, scores, _ = pt.track(frames, gt[0])
    jboxes, jscores, _ = jt.track(frames, gt[0])
    _tracks_agree(boxes, scores, jboxes, jscores)
    assert pt.last_flag == jt.last_flag
