"""The port's detector training held against the JAX package on the CPU,
at the JAX train CLI's ``--smoke`` size (a (1,1,1,1) trunk, 8 classes,
8 detections, 16 proposals, 64^2 frames, B = 2 frames of G = 4 gt
slots): the loss terms, the gradient of every leaf (BatchNorm
statistics included, as JAX differentiates ``batch_stats``), the
optimizers fed the same gradients as optax, and whole SGD steps.  The
port's loss takes JAX's own random draws (``roi_noise``'s arguments,
computed with ``jax.random`` on JAX's keys).  Also the repairs the
training path needed: BatchNorm in running-statistics mode whatever
``module.training`` says and differentiable in its statistics, and the
bf16 weight cast differentiable under grad."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tao_amodal_tpu.cli.train_detector_cli import (
    synthetic_detection_batch as jax_batch,
)
from tao_amodal_tpu.models.rpn import encode_deltas as jax_encode_deltas
from tao_amodal_tpu.models.rpn import level_anchors as jax_level_anchors
from tao_amodal_tpu.train import optim as joptim
from tao_amodal_tpu.train.detector_loss import (
    detector_train_loss as jax_loss,
)
from tao_amodal_tpu.train.detector_loss import rpn_loss as jax_rpn_loss
from tao_amodal_tpu.utils.checkpoint import flatten
from tao_amodal_torch.models import layers
from tao_amodal_torch.models.backbones import ConvBN
from tao_amodal_torch.models.rpn import encode_deltas, level_anchors
from tao_amodal_torch.train import optim as toptim
from tao_amodal_torch.train.detector_loss import (
    TERMS,
    force_best_anchors,
    rpn_loss,
)
from tao_amodal_torch.train.step import make_train_step
from tao_amodal_torch.utils.weights import cast, flax_layout
from torch_port_fixtures import (
    jax_pipeline,
    one_torch_thread,
    save_npz,
    torch_pipeline,
)

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

B, G, HW = 2, 4, 64
# Loss terms: the same f32 ops in another summation order (the
# terms are O(10-1000)).
LOSS_RTOL = 1e-5
# A gradient within 1e-4 of its leaf's largest |gradient|.
GRAD_TOL = 1e-4
# Optimizer updates fed equal gradients: within 1e-6 of the leaf's
# largest value (one or two f32 roundings apart).
OPT_TOL = 1e-6


def jax_noise(rng, batch):
    """JAX's draws inside ``detector_train_loss`` for ``rng`` (its
    ``keys`` split per frame; ``k1`` draws ``jit_a`` and ``rand_wh``,
    ``k2`` draws ``jit_b`` and ``rand_xy``), as the port's ``noise``."""
    b, g = batch["gt_boxes"].shape[:2]
    H, W = batch["images"].shape[1:3]
    out = {"jit_a": [], "jit_b": [], "rand_xy": [], "rand_wh": []}
    for key in jax.random.split(rng, b):
        k1, k2 = jax.random.split(key)
        out["jit_a"].append(jax.random.normal(k1, (g, 4)))
        out["jit_b"].append(jax.random.normal(k2, (g, 4)))
        out["rand_xy"].append(jax.random.uniform(
            k2, (g, 2), minval=0.0,
            maxval=jnp.asarray([W * 0.8, H * 0.8])))
        out["rand_wh"].append(jax.random.uniform(
            k1, (g, 2), minval=8.0,
            maxval=jnp.asarray([W * 0.2, H * 0.2])))
    return {k: torch.from_numpy(np.stack([np.asarray(a) for a in v]))
            for k, v in out.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's pipeline, its (perturbed) variables, the bridged port
    pipeline, a ``--smoke`` batch and JAX's jitted ``value_and_grad``
    (compiled once for the module)."""
    pipe, variables = jax_pipeline(seed=0)
    npz = save_npz(tmp_path_factory.mktemp("w"), variables)
    batch = jax_batch(np.random.RandomState(0), B, hw=HW)

    def loss_fn(v, b, r):
        return jax_loss(pipe.detector, pipe.expander, v, b, r)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return pipe, variables, npz, batch, value_and_grad


def port_step(npz, optimizer):
    return make_train_step(torch_pipeline(npz), optimizer)


def assert_leaves_close(names, got, want, tol, what):
    """Each port tensor within ``tol`` of its JAX leaf's largest |value|
    (JAX layouts)."""
    assert sorted(names) == sorted(want)
    for name, t in zip(names, got):
        a, w = flax_layout(name, t), np.asarray(want[name])
        assert a.shape == w.shape, name
        err = np.abs(a - w).max()
        assert err <= tol * np.abs(w).max(), (what, name, err,
                                              np.abs(w).max())


def test_loss_terms_and_gradients_match_jax(setup):
    """Every loss term at rtol 1e-5 and every leaf's gradient, the
    BatchNorm statistics' included, within 1e-4 of its largest; the
    gradients reach the statistics (JAX trains them)."""
    _, variables, npz, batch, value_and_grad = setup
    rng = jax.random.PRNGKey(3)
    (loss, aux), grads = value_and_grad(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    step = port_step(npz, toptim.make_adamw(toptim.log_schedule(
        1e-3, 1e-5, 100)))
    got, terms, g = step.loss_and_grads(batch, jax_noise(rng, batch))
    np.testing.assert_allclose(float(got), float(loss), rtol=LOSS_RTOL)
    assert set(terms) == set(TERMS) == set(aux)
    for k in TERMS:
        np.testing.assert_allclose(float(terms[k]), float(aux[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want = flatten(grads)
    names = step.flax_names()
    assert_leaves_close(names, g, want, GRAD_TOL, "gradient")
    stats = [n for n in names if "/batch_stats/" in n]
    assert len(stats) == len([k for k in flatten(variables)
                              if "/batch_stats/" in k]) > 0
    assert all(np.abs(np.asarray(want[n])).max() > 0 for n in stats)


def _updates(opt, params, grads_seq, torch_side):
    """Three updates of ``opt`` fed ``grads_seq``: the params after
    each, as numpy dicts."""
    names = sorted(params)
    if torch_side:
        leaves = [torch.from_numpy(params[n].copy()) for n in names]
        state = opt.init(leaves)
        out = []
        for grads in grads_seq:
            u, state = opt.update([torch.from_numpy(grads[n])
                                   for n in names], state, leaves)
            toptim.apply_updates(leaves, u)
            out.append({n: t.numpy().copy() for n, t in zip(names, leaves)})
        return out
    p = {n: jnp.asarray(params[n]) for n in names}
    state = opt.init(p)
    update = jitted_update(opt)
    out = []
    for grads in grads_seq:
        p, state = update({n: jnp.asarray(grads[n]) for n in names},
                          state, p)
        out.append({n: np.asarray(v) for n, v in p.items()})
    return out


def jitted_update(opt):
    """optax's update and ``apply_updates`` as one jitted function
    ``(grads, state, params) -> (params, state)``."""
    def update(grads, state, params):
        u, state = opt.update(grads, state, params)
        return optax.apply_updates(params, u), state

    return jax.jit(update)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_optimizers_match_optax(kind):
    """AdamW and SGD+momentum (each after the global-norm clip) over 3
    updates fed the same gradients as optax: the clip taken on the 2nd
    update only, leaves whose gradients span 1e-9 to 1e3, a leaf whose
    gradient is 0; the schedule read at counts 0, 1, 2."""
    rs = np.random.RandomState(0)
    shapes = {"a": (3, 5, 7, 2), "b": (11,), "c": (4, 9), "zero": (6,)}
    params = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads_seq = []
    for scale in (0.3, 40.0, 1e-3):
        g = {n: (scale * rs.randn(*s) * 10.0 ** rs.randint(-6, 3, s))
             .astype(np.float32) for n, s in shapes.items()}
        g["zero"][:] = 0
        grads_seq.append(g)
    sched = (1e-3, 1e-5, 5)
    if kind == "adamw":
        want = _updates(joptim.make_adamw(joptim.log_schedule(*sched)),
                        params, grads_seq, False)
        got = _updates(toptim.make_adamw(toptim.log_schedule(*sched)),
                       params, grads_seq, True)
    else:
        want = _updates(joptim.make_optimizer(joptim.log_schedule(*sched)),
                        params, grads_seq, False)
        got = _updates(toptim.make_optimizer(toptim.log_schedule(*sched)),
                       params, grads_seq, True)
    for i, (a, w) in enumerate(zip(got, want)):
        for n in shapes:
            step = np.abs(w[n] - params[n]).max()
            err = np.abs(a[n] - w[n]).max()
            assert err <= OPT_TOL * np.abs(w[n]).max(), (kind, i, n, err)
            assert n == "zero" or step > 0


def test_sgd_steps_match_jax(setup):
    """Three whole steps (loss, gradients, clip, decayed weights, SGD
    with momentum, in place) on JAX's draws: the loss and metrics of
    each step, and every leaf after them (BatchNorm statistics
    included)."""
    _, variables, npz, batch, value_and_grad = setup
    sched = (1e-3, 1e-5, 10)
    opt = joptim.make_optimizer(joptim.log_schedule(*sched))
    step = port_step(npz, toptim.make_optimizer(toptim.log_schedule(*sched)))
    state = step.init_state()
    v, opt_state = variables, opt.init(variables)
    update = jitted_update(opt)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    for i in range(3):
        rng = jax.random.PRNGKey(10 + i)
        (loss, aux), grads = value_and_grad(v, jbatch, rng)
        v, opt_state = update(grads, opt_state, v)
        state, metrics = step.run(state, batch, jax_noise(rng, batch))
        np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                                   rtol=LOSS_RTOL)
        # A function of the gradients: held to their bound.
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(optax.global_norm(grads)),
                                   rtol=GRAD_TOL)
        for k in TERMS:
            np.testing.assert_allclose(float(metrics[k]), float(aux[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    want = flatten(v)
    got = [t.detach() for t in step.leaves]
    # Each leaf within 1e-6 of its largest |value| (lr 1e-3 steps of
    # gradients equal to 1e-4 of their largest).
    assert_leaves_close(step.flax_names(), got, want, OPT_TOL, "leaf")
    moved = [n for n, t in zip(step.flax_names(), got)
             if "/batch_stats/" in n
             and not np.array_equal(flax_layout(n, t),
                                    np.asarray(flatten(variables)[n]))]
    assert moved, "the optimizer did not move the BatchNorm statistics"


def test_schedules_and_unfreeze_mask_match_jax(setup):
    """The log and warm-up schedules at every count (f32 values), and
    ``staged_unfreeze_mask`` on the pipeline's leaf names before and
    after the unfreeze step."""
    _, variables, npz, _, _ = setup
    pairs = [(joptim.log_schedule(1e-2, 1e-4, 7),
              toptim.log_schedule(1e-2, 1e-4, 7)),
             (joptim.warmup_log_schedule(1e-4, 1e-2, 3, 1e-2, 1e-4, 9),
              toptim.warmup_log_schedule(1e-4, 1e-2, 3, 1e-2, 1e-4, 9))]
    for j, t in pairs:
        for c in range(12):
            assert np.float32(j(jnp.int32(c))) == np.float32(t(c)), c
    names = port_step(npz, toptim.make_adamw(1e-3)).flax_names()
    for step in (0, 5):
        want = _flat_mask(joptim.staged_unfreeze_mask(
            variables, ["backbone"], step, 5))
        got = toptim.staged_unfreeze_mask(names, ["backbone"], step, 5)
        assert got == want
        assert any(not v for v in got.values()) == (step < 5)


def _flat_mask(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_mask(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = bool(v)
    return out


def _rpn_scene(rs, gt_rows):
    """Random objectness and delta maps of a 64^2 frame's P3..P7 levels
    (B = len(gt_rows) frames), the anchors, and the given gt rows
    (``None`` marks an invalid slot)."""
    levels = [(8, 8, 8, 32), (4, 4, 16, 64), (2, 2, 32, 128),
              (1, 1, 64, 256), (1, 1, 128, 512)]
    n = len(gt_rows)
    objs = [rs.randn(n, h, w, 3).astype(np.float32) for h, w, _, _ in levels]
    deltas = [0.1 * rs.randn(n, h, w, 12).astype(np.float32)
              for h, w, _, _ in levels]
    anchors = [np.asarray(jax_level_anchors(h, w, s, [sc], (0.5, 1.0, 2.0)))
               for h, w, s, sc in levels]
    boxes = np.zeros((n, len(gt_rows[0]), 4), np.float32)
    valid = np.zeros((n, len(gt_rows[0])), bool)
    for b, row in enumerate(gt_rows):
        for g, box in enumerate(row):
            if box is not None:
                boxes[b, g], valid[b, g] = box, True
    return objs, deltas, anchors, boxes, valid


def test_rpn_loss_matches_jax_where_gts_share_a_best_anchor():
    """JAX forces each gt's best anchor positive with a scatter whose
    duplicate indices the last gt decides: two valid gts sharing a best
    anchor (both force it); a valid gt whose best anchor is anchor 0
    (IoU below the positive threshold) followed by invalid slots, whose
    all -1 rows name anchor 0 too and write its old value back; and the
    same gt after invalid slots, which forces anchor 0."""
    rs = np.random.RandomState(0)
    corner = np.array([0.0, 0.0, 14.0, 9.0], np.float32)  # best: anchor 0
    twin = np.array([20.0, 21.0, 41.0, 39.0], np.float32)
    rows = [[twin, twin + 0.5, None, None],
            [corner, None, None, None],
            [None, twin, None, corner]]
    objs, deltas, anchors, boxes, valid = _rpn_scene(rs, rows)
    obj_t, reg_t = rpn_loss([torch.from_numpy(o) for o in objs],
                            [torch.from_numpy(d) for d in deltas],
                            [torch.tensor(a) for a in anchors],
                            torch.from_numpy(boxes), torch.from_numpy(valid))
    jax_rpn = jax.jit(jax_rpn_loss)
    for b in range(len(rows)):
        obj_j, reg_j = jax_rpn([o[b] for o in objs],
                                    [d[b] for d in deltas], anchors,
                                    boxes[b], valid[b])
        np.testing.assert_allclose(float(obj_t[b]), float(obj_j), rtol=1e-6)
        np.testing.assert_allclose(float(reg_t[b]), float(reg_j), rtol=1e-6)
    # The overwrite is real: anchor 0 stays negative for frame 1 (the
    # invalid slots come last) and is forced for frame 2 (a valid gt
    # names it last among its duplicates).
    pos = torch.zeros(3, 5, dtype=torch.bool)
    best = torch.tensor([[2, 2, 0, 0], [0, 0, 0, 0], [0, 3, 0, 0]])
    got = force_best_anchors(pos, best, torch.from_numpy(valid))
    assert got[0, 2] and not got[0, 0]
    assert not got[1, 0]
    assert got[2, 3] and got[2, 0]


def test_encode_deltas_matches_jax():
    rs = np.random.RandomState(1)
    a = np.concatenate([rs.uniform(0, 50, (40, 2)),
                        rs.uniform(60, 120, (40, 2))], -1).astype(np.float32)
    b = np.concatenate([rs.uniform(0, 50, (40, 2)),
                        rs.uniform(50, 120, (40, 2))], -1).astype(np.float32)
    b[0] = [3.0, 3.0, 3.0, 9.0]  # zero width: floored at 1e-6
    np.testing.assert_allclose(
        encode_deltas(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_encode_deltas(a, b)), rtol=1e-6, atol=1e-6)
    anchors = level_anchors(4, 4, 16, [64], (0.5, 1.0, 2.0), device="cpu")
    np.testing.assert_array_equal(
        anchors.numpy(), np.asarray(jax_level_anchors(4, 4, 16, [64],
                                                      (0.5, 1.0, 2.0))))


def test_batch_norm_keeps_running_statistics_in_train_mode():
    """A ``ConvBN`` in ``train()`` mode normalizes with its running
    statistics and leaves them as they were, as JAX's loss runs
    ``use_running_average=True``; under grad the BatchNorm is
    differentiable in both statistics (analytic gradients), and without
    grad it is PyTorch's inference kernel, equal to the eval-mode
    layer."""
    torch.manual_seed(0)
    m = ConvBN(4, 6, 3)
    bn = m.BatchNorm_0
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(6))
        bn.running_var.copy_(torch.rand(6) + 0.5)
        bn.weight.copy_(torch.randn(6))
    x = torch.randn(2, 4, 5, 5)
    with torch.no_grad():
        want = torch.nn.functional.relu(bn.eval()(m.Conv_0(x)))
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    m.train()
    with torch.no_grad():
        np.testing.assert_array_equal(m(x).numpy(), want.numpy())
    got = m(x)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(bn.running_mean, mean0)
    assert torch.equal(bn.running_var, var0)

    y = m.Conv_0(x).detach()
    mean = bn.running_mean.clone().requires_grad_()
    var = bn.running_var.clone().requires_grad_()
    bn.running_mean, bn.running_var = mean, var
    out = layers.batch_norm(y, bn)
    g = torch.randn_like(out)
    out.backward(g)
    inv = torch.rsqrt(var.detach() + bn.eps)
    w = bn.weight.detach()
    np.testing.assert_allclose(mean.grad.numpy(),
                               (-g.sum((0, 2, 3)) * inv * w).numpy(),
                               rtol=1e-5, atol=1e-5)
    dvar = (g * (y - mean.detach()[:, None, None])).sum((0, 2, 3)) * w * (
        -0.5) * inv ** 3
    np.testing.assert_allclose(var.grad.numpy(), dvar.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_bf16_cast_is_differentiable_under_grad():
    """A bf16 Dense under grad sends its gradient to the f32 master
    weight (JAX differentiates through its cast); without grad the
    rounded copy is made once and reused."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 5)
    x = torch.randn(3, 8)
    out = layers.dense(x, lin, torch.bfloat16)
    out.float().sum().backward()
    assert lin.weight.grad is not None and lin.bias.grad is not None
    want = torch.ones(3, 5).T @ x.to(torch.bfloat16).float()
    np.testing.assert_allclose(lin.weight.grad.numpy(), want.numpy(),
                               rtol=1e-2, atol=1e-2)
    with torch.no_grad():
        assert cast(lin.weight, torch.bfloat16) is cast(lin.weight,
                                                       torch.bfloat16)


def test_detector_pooling_differentiates_as_jax(setup):
    """The detector's RoI pooling (B2's route; the docstring no longer
    says the port has no backward): its gradient in the pyramid equals
    ``jax.grad`` of ``ClipDetector.pool_rois`` within 1e-5 of the
    largest."""
    from tao_amodal_torch.models.detector import ClipDetector

    pipe, variables, npz, _, _ = setup
    assert "no backward yet" not in ClipDetector.__doc__
    assert "forward only, as in JAX" in ClipDetector.__doc__
    rs = np.random.RandomState(5)
    pyramid = [rs.randn(n, n, 16).astype(np.float32) for n in (8, 4, 2, 1)]
    rois = np.concatenate([rs.uniform(0, 40, (6, 2)),
                           rs.uniform(45, 64, (6, 2))], -1).astype(np.float32)
    cot = rs.randn(6, 7, 7, 16).astype(np.float32)

    def jax_pool(p):
        return jnp.sum(pipe.detector.pool_rois(p, jnp.asarray(rois)) * cot)

    want = jax.grad(jax_pool)([jnp.asarray(p) for p in pyramid])
    tp = torch_pipeline(npz)
    levels = [torch.from_numpy(p).permute(2, 0, 1)[None].requires_grad_()
              for p in pyramid]
    out = tp.detector.pool_rois(levels, torch.from_numpy(rois)[None])
    (out[0] * torch.from_numpy(cot)).sum().backward()
    for lvl, w in zip(levels, want):
        g = lvl.grad[0].permute(1, 2, 0).numpy()
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-6)
