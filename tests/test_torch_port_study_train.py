"""The port's accuracy-study training loop held against the JAX tool's on
the CPU: ``tao_amodal_torch.cli.accuracy_study.train`` against
``tools/accuracy_study.py::train`` for two steps at a tiny size (64^2
synthetic videos, a (1,1,1,1) trunk, batch 2), with and without
PasteNOcclude, from JAX's own init (carried across with the weight
bridge) and on JAX's draws (the RoI jitter of ``PRNGKey(i)``,
PasteNOcclude's of ``PRNGKey(7_000_000 + i)``)."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tao_amodal_tpu.data.synth_video import make_synth_videos
from tao_amodal_tpu.pipeline import AmodalPipeline as JaxPipeline
from tao_amodal_tpu.utils.checkpoint import flatten
from tao_amodal_torch.cli import accuracy_study as study
from tao_amodal_torch.pipeline import AmodalPipeline
from tao_amodal_torch.utils.weights import load_into
from test_torch_port_train import jax_noise
from test_torch_port_train_data import jax_pno_draws
from tools import accuracy_study as jax_study
from torch_port_fixtures import one_torch_thread

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

ARCH = dict(num_classes=3, num_dets=8, num_proposals=16,
            backbone_stages=(1, 1, 1, 1))
HW, STEPS, BATCH, LR = 64, 2, 2, 1e-3
# The loss of the first step (equal weights, batch and draws).
LOSS_RTOL = 1e-5
# The loss after one update: Adam normalizes each gradient element, so
# an element whose gradient lies at f32 noise in both packages (within
# 1e-4 of its leaf's largest, the step tests' bound) moves by +-LR in
# either, whatever its size; the few such sign flips of the expander's
# deltas move its L1 term (without PasteNOcclude 1.35e-3 relative; with
# it 9e-7).
LOSS_AFTER_RTOL = 2e-3
# After one update, an element within 1e-4 of max(its leaf's largest
# |value|, LR) of JAX's, but for such flips: at most FLIPS of a leaf
# (without PasteNOcclude 2.2 % of the deltas kernel), each within 2 LR.
UPDATE_TOL = 1e-4
FLIPS = 0.03
# After two updates the flips have moved the second gradients: each
# element within 2 LR a step, each leaf's median within 1e-2 of
# max(|leaf|, LR) (measured 6.7e-3 without PasteNOcclude, 7.3e-7 with).
MEDIAN_TOL = 1e-2


@pytest.fixture(scope="module")
def setup():
    gt, frames = make_synth_videos(seed=0, num_videos=2, frames_per_video=4,
                                   hw=HW, tracks_per_video=2)
    pipe = JaxPipeline.create(**ARCH)
    init = jax.jit(pipe.init)(jax.random.PRNGKey(0),
                              jnp.zeros((2, HW, HW, 3)))
    return gt, frames, pipe, {k: np.asarray(v)
                              for k, v in flatten(init).items()}


class _Losses(logging.Handler):
    """The JAX loop's logged steps: ``(step, loss)``."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def emit(self, record):
        if record.getMessage().startswith("step "):
            self.steps.append((record.args[0], record.args[1]))


@pytest.mark.parametrize("paste_n_occlude", [False, True])
def test_study_train_matches_jax(setup, paste_n_occlude):
    """Two steps with a snapshot after the first: the logged losses, and
    every leaf of both snapshots (BatchNorm statistics included), against
    JAX's (bounds above)."""
    gt, frames, jpipe, init = setup
    logs = _Losses()
    logger = logging.getLogger("accuracy_study")
    logger.addHandler(logs)
    logger.setLevel(logging.INFO)
    try:
        want = jax_study.train(jpipe, gt, frames, STEPS, BATCH, seed=0,
                               lr=LR, snapshot_steps=(1,), max_gt=8,
                               paste_n_occlude=paste_n_occlude)
    finally:
        logger.removeHandler(logs)
    pipe = AmodalPipeline.create(**ARCH, device="cpu")
    load_into(pipe, init)
    history = []
    got = study.train(
        pipe, gt, frames, STEPS, BATCH, seed=0, lr=LR, snapshot_steps=(1,),
        max_gt=8, paste_n_occlude=paste_n_occlude, init=False,
        noise_fn=lambda i, b: jax_noise(jax.random.PRNGKey(i), b),
        pno_fn=lambda i, b: jax_pno_draws(
            jax.random.PRNGKey(study.PNO_SEED + i), b["gt_valid"], 16),
        history=history)

    assert [s for s, _ in logs.steps] == [s for s, _, _ in history] == [0, 1]
    for (step, loss), (_, m, _) in zip(logs.steps, history):
        rtol = LOSS_RTOL if step == 0 else LOSS_AFTER_RTOL
        np.testing.assert_allclose(m["loss"], loss, rtol=rtol,
                                   err_msg=f"step {step}")
    assert sorted(got) == sorted(want) == [1, 2]
    for step in (1, 2):
        w = flatten(want[step])
        assert sorted(got[step]) == sorted(w)
        for key, b in w.items():
            a, b = got[step][key], np.asarray(b)
            assert a.shape == b.shape and np.isfinite(a).all(), key
            d = np.abs(a - b)
            scale = max(np.abs(b).max(), LR)
            assert d.max() <= 2 * LR * step * (1 + 1e-3), (step, key)
            if step == 1:
                far = (d > UPDATE_TOL * scale).mean()
                assert far <= FLIPS, (key, far)
            else:
                assert np.median(d) <= MEDIAN_TOL * scale, key
    moved = [k for k, v in got[STEPS].items()
             if "/batch_stats/" in k and not np.array_equal(v, init[k])]
    assert moved, "the BatchNorm statistics did not move"
