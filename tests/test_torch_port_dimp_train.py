"""The port's DiMP meta-training actor held against the JAX package on the
CPU: ``response_targets``, and ``dimp_actor_loss`` with its meta-
gradients through the Gauss-Newton/CG filter solve, at the size of
``tests/test_optimization.py::test_dimp_actor_meta_gradients`` (a
stride-4 conv extractor of 16 channels on 32^2 images, a 3 x 3 filter,
an IoUNet of 16 features over 3 x 3 bins, 2 sequences of 2 + 2 frames),
on shared weights.  Also the seeded actor (``build_dimp_actor``) at a
small size: its meta-gradient reaches every leaf its forward runs."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tao_amodal_tpu.models.dimp import IoUNet as JaxIoUNet
from tao_amodal_tpu.train.dimp_loss import dimp_actor_loss as jax_actor_loss
from tao_amodal_tpu.train.dimp_loss import (
    response_targets as jax_response_targets,
)
from tao_amodal_tpu.utils.checkpoint import flatten
from tao_amodal_torch.models.dimp import IoUNet
from tao_amodal_torch.train.dimp_loss import (
    build_dimp_actor,
    dimp_actor_loss,
    response_targets,
)
from tao_amodal_torch.utils.weights import load_variables
from torch_port_fixtures import one_torch_thread

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

S = 32
# Loss terms: the same f32 ops in another order.
LOSS_RTOL = 1e-5
# A meta-gradient within 1e-4 of its leaf's largest |gradient|.
GRAD_TOL = 1e-4


def test_response_targets_match_jax():
    """Gaussian targets on boxes inside and across the image, at two grid
    sizes and sigmas, within 1e-6."""
    rs = np.random.RandomState(0)
    xy = rs.uniform(-10, 60, (5, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(4, 30, (5, 2))],
                           1).astype(np.float32)
    for out_hw, sigma in ((6, 2.0), (15, 1.5)):
        want = jax_response_targets(jnp.asarray(boxes), 18, out_hw,
                                    (64, 48), sigma=sigma)
        got = response_targets(torch.from_numpy(boxes), 18, out_hw,
                               (64, 48), sigma=sigma)
        assert tuple(got.shape) == want.shape == (5, out_hw, out_hw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


class _JaxExtractor(fnn.Module):
    """``tests/test_optimization.py``'s tiny extractor."""

    @fnn.compact
    def __call__(self, imgs):
        x = fnn.Conv(16, (3, 3), strides=4, padding="SAME")(imgs)
        return fnn.relu(x)


def _batch():
    """``tests/test_optimization.py``'s batch."""
    rng = np.random.RandomState(0)
    return {
        "train_images": rng.rand(2, 2, S, S, 3).astype(np.float32),
        "train_boxes": np.tile(np.float32([8, 8, 24, 24]), (2, 2, 1)),
        "test_images": rng.rand(2, 2, S, S, 3).astype(np.float32),
        "test_boxes": np.tile(np.float32([10, 8, 26, 24]), (2, 2, 1)),
    }


# A one-ulp change of the train images (times 1 +- 2^-23).
ULP_SCALES = (1.0, 1.0 + 2.0 ** -23, 1.0 - 2.0 ** -23)


def _scaled(batch, scale):
    return dict(batch, train_images=batch["train_images"] * scale)


@pytest.fixture(scope="module")
def jax_actor():
    """JAX's loss and meta-gradients (jitted, flat) on its test's
    variables, at the batch and at its one-ulp changes (ULP_SCALES)."""
    extractor = _JaxExtractor()
    ex_vars = extractor.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    iou_net = JaxIoUNet(features=16, pool_size=3)
    h = S // 4
    iou_vars = iou_net.init(jax.random.PRNGKey(1), jnp.zeros((h, h, 16)),
                            jnp.zeros((3 * 3 * 16,)), jnp.zeros((1, 4)),
                            spatial_scale=1.0)
    variables = {"extractor": ex_vars, "iou": iou_vars}

    def loss_fn(v, batch):
        return jax_actor_loss(lambda vv, im: extractor.apply(vv, im),
                              iou_net, v, batch, filter_size=3,
                              num_gn_iters=2, num_cg_iters=3)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    runs = []
    for scale in ULP_SCALES:
        (loss, terms), grads = fn(variables, _scaled(batch, scale))
        runs.append(_flat_run(loss, terms, {
            k: np.asarray(v) for k, v in flatten(grads).items()}))
    return variables, runs


def _flat_run(loss, terms, grads):
    return {"loss": float(loss), **{k: float(v) for k, v in terms.items()},
            "grads": grads}


def _port_actor(variables):
    """The port's extractor (a conv + ReLU on NHWC images, Flax's SAME
    padding at stride 4 on 32^2 is none) and IoUNet on JAX's variables."""
    p = variables["extractor"]["params"]["Conv_0"]
    conv = nn.Conv2d(3, 16, 3, stride=4)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(
            p["kernel"]).transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(np.array(p["bias"])))

    def extractor(imgs):
        return torch.relu(conv(imgs.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)

    iou = IoUNet(16, features=16, pool_size=3, device="cpu")
    load_variables(iou, {k: np.asarray(v) for k, v in
                         flatten(variables["iou"]).items()})
    return conv, extractor, iou


def _port_run(variables, scale):
    """The port's loss, terms and meta-gradients (JAX names, layouts)."""
    conv, extractor, iou = _port_actor(variables)
    batch = _scaled({k: torch.from_numpy(v) for k, v in _batch().items()},
                    scale)
    loss, terms = dimp_actor_loss(extractor, iou, batch, filter_size=3,
                                  num_gn_iters=2, num_cg_iters=3)
    leaves = {"extractor/params/Conv_0/kernel": conv.weight,
              "extractor/params/Conv_0/bias": conv.bias}
    for name, t in iou.named_parameters():
        mod, leaf = name.split(".")
        leaves[f"iou/params/{mod}/{'kernel' if leaf == 'weight' else leaf}"
               ] = t
    grads = {}
    for name, g in zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))):
        a = g.numpy()
        if name.endswith("kernel"):
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        grads[name] = a
    return _flat_run(loss.detach(), terms, grads)


def _spread(runs, key, name=None):
    """How far a one-ulp change of the images moves a value (a loss term,
    or a leaf's gradient)."""
    def get(r):
        return r[key] if name is None else r[key][name]

    return max(np.abs(np.asarray(get(r)) - np.asarray(get(runs[0]))).max()
               for r in runs[1:])


def test_dimp_actor_loss_and_meta_gradients_match_jax(jax_actor):
    """The actor's total and both terms, and every leaf's meta-gradient
    through the filter's Gauss-Newton/CG solve (``torch.func`` products
    under an outer ``torch.autograd.grad``) and the IoUNet, against
    JAX's.  At this size the 2 x 3 solve is ill-conditioned: a one-ulp
    change of the train images moves the response term by about 7e-5 and
    the extractor's gradient by about 1.2e-2 of its largest, in either
    package.  So each value is held within LOSS_RTOL (terms) or GRAD_TOL
    of its largest (gradients), or, where larger, within the sum of the
    two packages' own moves under that change (ULP_SCALES); the IoUNet's
    leaves, off the solve, meet GRAD_TOL.  The extractor's gradient is
    nonzero."""
    variables, jruns = jax_actor
    pruns = [_port_run(variables, s) for s in ULP_SCALES]
    got, want = pruns[0], jruns[0]
    for k in ("loss", "dimp_cls", "dimp_iou"):
        bound = max(LOSS_RTOL * abs(want[k]),
                    _spread(jruns, k) + _spread(pruns, k))
        assert abs(got[k] - want[k]) <= bound, (k, got[k], want[k], bound)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, w in want["grads"].items():
        a = got["grads"][name]
        assert a.shape == w.shape and np.isfinite(a).all(), name
        scale = np.abs(w).max()
        own = _spread(jruns, "grads", name) + _spread(pruns, "grads", name)
        err = np.abs(a - w).max()
        assert err <= max(GRAD_TOL * scale, own), (name, err, scale, own)
        if name.startswith("iou/"):
            assert err <= GRAD_TOL * scale, name
    assert np.abs(got["grads"]["extractor/params/Conv_0/kernel"]).max() > 0


def test_seeded_actor_meta_gradient_reaches_every_leaf_it_runs():
    """``build_dimp_actor`` on the CPU at a small size (a (1,1,1,1)
    ResNet to layer3, 64^2 crops, a 4 x 4 filter): one actor step's loss
    is finite, and its meta-gradient is finite on every leaf and nonzero
    on every ResNet leaf of the stem and stages 1-3 (the stages the
    extractor runs; its BatchNorm statistics too) and every IoUNet
    leaf."""
    from tao_amodal_torch.train.step import trainable_leaves

    fn, resnet, iou = build_dimp_actor(search_size=64, stage_sizes=(1, 1, 1,
                                                                    1),
                                       device="cpu")
    rs = np.random.RandomState(1)

    def frames(n):
        return torch.from_numpy(rs.uniform(0, 255, (2, n, 64, 64, 3)
                                           ).astype(np.float32))

    box = torch.tensor([16.0, 20.0, 44.0, 48.0])
    batch = {"train_images": frames(2), "test_images": frames(2),
             "train_boxes": box.expand(2, 2, 4),
             "test_boxes": (box + 3).expand(2, 2, 4)}
    names, leaves = trainable_leaves(resnet)
    inames, ileaves = trainable_leaves(iou)
    loss, terms = dimp_actor_loss(fn, iou, batch, filter_size=4,
                                  num_gn_iters=2, num_cg_iters=3)
    assert np.isfinite(float(loss))
    grads = torch.autograd.grad(loss, leaves + ileaves, allow_unused=True)
    # Stage 4 is built but never run (the extractor stops at layer3).
    last = tuple(f"Bottleneck_{i}." for i in range(
        sum(resnet.stage_sizes[:3]), sum(resnet.stage_sizes)))
    ran = [n for n in names if not n.startswith(last)]
    by_name = dict(zip(names + [f"iou.{n}" for n in inames], grads))
    assert len(ran) < len(names)
    for n in ran + [f"iou.{n}" for n in inames]:
        g = by_name[n]
        assert g is not None and bool(torch.isfinite(g).all()), n
        assert float(g.abs().max()) > 0, n
