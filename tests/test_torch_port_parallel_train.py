"""The port's data- and tensor-parallel training held against the JAX
package on the CPU, and the two scale-out tools.

* The data-parallel step (``parallel.dp.make_train_step``, 2 gloo ranks,
  one shard of a 4-frame ``--smoke`` batch each) over two steps against
  JAX's ``parallel.dp.make_train_step`` on a 2-device mesh, the port fed
  JAX's own draws of the global batch: loss within 1e-5 relative of
  JAX's and grad norm within 3e-5 (``JAX_GRAD_NORM_RTOL``: the packages'
  one-device steps already part by 1.45e-5), loss and grad norm within
  1e-5 of the port's one-process step, every leaf after the steps
  (BatchNorm statistics included)
  within 1e-6 of its largest value (JAX's ``test_parallel.py:43-73``),
  and the ranks' replicas equal bit for bit.
* The hybrid step (``place_tp`` then ``make_train_step(param_sharding=
  ...)``, 4 ranks as ``(2, 2)``) against JAX's TP+DP step on a ``(2, 2)``
  mesh at the same bounds, the head shards assembled over the model
  ranks (``test_tp.py:88``).
* The tensor-parallel forward (2 ranks, ``model=2``): boxes within 1e-4
  px + 1e-6 relative of the port's unsplit forward (the JAX dryrun's
  bound between its TP and replicated forwards, 64 px boxes, plus a few
  f32 ulps of boxes up to 344 px) and within the port's box bound of JAX's
  ``place_tp`` forward (rtol 1e-4 + 1e-3 px: the boxes reach 240 px,
  where the packages' f32 trunks part by up to 1.7e-3 px), the integers
  equal.
* The eval step's metrics, averaged over the data ranks, against JAX's.
* ``tp_param_shardings``: the six split tensors and their dims, and a
  width that ``model`` does not divide staying replicated.
* ``tools/dryrun_multichip_torch.py`` (2 ranks, flagship shape, its own
  bounds) and ``tools/multiprocess_smoke_torch.py`` run to their OK
  lines.
"""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_parallel_ranks as ranks
from test_torch_port_train import jax_noise
from torch_port_fixtures import jax_pipeline, one_torch_thread, save_npz

from tao_amodal_torch.parallel.tp import tp_param_shardings
from tao_amodal_torch.utils.weights import flax_layout
from tao_amodal_tpu.cli.train_detector_cli import (
    synthetic_detection_batch as jax_batch,
)
from tao_amodal_tpu.parallel.dp import make_train_step as jax_train_step
from tao_amodal_tpu.parallel.mesh import make_mesh, shard_batch
from tao_amodal_tpu.parallel.tp import place_tp
from tao_amodal_tpu.parallel.tp import (
    tp_param_shardings as jax_tp_shardings,
)
from tao_amodal_tpu.train import optim as joptim
from tao_amodal_tpu.train.detector_loss import (
    detector_train_loss as jax_loss,
)
from tao_amodal_tpu.utils.checkpoint import flatten

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, HW, STEPS = 4, 64, 2
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-5
# The grad norm against JAX's: the port's one-process step already parts
# from JAX's step on the global batch by 1.45e-5 of the 5.3e4 norm at
# the first step (the packages' f32 convolutions sum in other orders),
# and the port's ranks from its one-process step by 8.1e-7 at most; the
# ranks' norm measured 1.40e-5 (DP) and 1.37e-5 (TP+DP) from JAX's.
JAX_GRAD_NORM_RTOL = 3e-5
LEAF_TOL = 1e-6
TP_BOX_TOL = 1e-4
# Boxes reach 344 px here, where an f32 ulp is 3.1e-5: a few ulps of the
# row-parallel sum's other order.
TP_BOX_RTOL = 1e-6


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    pipe, variables = jax_pipeline(seed=0)
    npz = save_npz(tmp_path_factory.mktemp("w"), variables)
    batch = jax_batch(np.random.RandomState(0), B, hw=HW)
    return pipe, variables, npz, batch


def jax_steps(setup, data, model):
    """JAX's ``make_train_step`` over a ``(data, model)`` mesh (the heads
    placed by ``place_tp`` where ``model > 1``), STEPS steps: (metrics a
    step, the variables after them, the global draws a step)."""
    pipe, variables, _, batch = setup
    mesh = make_mesh(data=data, model=model,
                     devices=jax.devices()[:data * model])
    opt = joptim.make_optimizer(joptim.log_schedule(1e-3, 1e-5, 10))

    def loss_fn(v, b, r):
        return jax_loss(pipe.detector, pipe.expander, v, b, r)

    if model > 1:
        params = place_tp(variables, mesh)
        state = (params, jax.jit(opt.init)(params))
        step = jax_train_step(loss_fn, opt, mesh, donate=False,
                              param_sharding=jax_tp_shardings(variables,
                                                              mesh))
    else:
        state = (variables, opt.init(variables))
        step = jax_train_step(loss_fn, opt, mesh, donate=False)
    metrics, draws = [], []
    for i in range(STEPS):
        rng = jax.random.PRNGKey(10 + i)
        state, m = step(state, shard_batch(mesh, batch), rng)
        metrics.append({k: float(v) for k, v in m.items()})
        draws.append({k: v.numpy() for k, v in jax_noise(
            rng, {k: jnp.asarray(x) for k, x in batch.items()}).items()})
    return metrics, flatten(jax.device_get(state[0])), draws


def assert_steps_close(got, one, want):
    """Each step's loss within 1e-5 relative of JAX's and its grad norm
    within JAX_GRAD_NORM_RTOL of JAX's; both within 1e-5 relative of the
    port's one-process step (``one``, JAX's own data-parallel
    contract)."""
    for g, o, w in zip(got, one, want):
        assert set(g) == set(w) == set(o)
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=JAX_GRAD_NORM_RTOL)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], o[k], rtol=GRAD_NORM_RTOL,
                                       err_msg=k)


def assert_leaves_close(names, leaves, want):
    assert sorted(names) == sorted(want)
    for name, leaf in zip(names, leaves):
        a = flax_layout(name, torch.from_numpy(leaf))
        w = np.asarray(want[name])
        assert a.shape == w.shape, name
        err = np.abs(a - w).max()
        assert err <= LEAF_TOL * np.abs(w).max(), (name, err)


def test_dp_step_matches_jax(setup):
    _, _, npz, batch = setup
    want, leaves_want, draws = jax_steps(setup, data=2, model=1)
    one = ranks.dp_step(0, npz, batch, draws, 1, False)[0]
    got = ranks.start(ranks.dp_step, 2, npz, batch, draws, 1, False)
    metrics, names, _, leaves, dims = got[0]
    assert all(d is None for d in dims)
    assert_steps_close(metrics, one, want)
    assert_leaves_close(names, leaves, leaves_want)
    assert metrics == got[1][0]
    for a, b in zip(leaves, got[1][3]):
        np.testing.assert_array_equal(a, b)


def test_tp_dp_step_matches_jax(setup):
    """Ranks 0 and 1 hold data shard 0's two halves of each head, ranks 2
    and 3 data shard 1's; the halves, joined along their split dim, are
    JAX's updated leaves, and the two data shards hold equal copies."""
    _, _, npz, batch = setup
    want, leaves_want, draws = jax_steps(setup, data=2, model=2)
    one = ranks.dp_step(0, npz, batch, draws, 1, False)[0]
    got = ranks.start(ranks.dp_step, 4, npz, batch, draws, 2, True)
    metrics, names, torch_names, _, dims = got[0]
    split = [n for n, d in zip(torch_names, dims) if d is not None]
    assert len(split) == 6, split
    for r in range(4):
        assert_steps_close(got[r][0], one, want)
    joined = []
    for i, dim in enumerate(dims):
        parts = [got[r][3][i] for r in (0, 1)]
        if dim is None:
            np.testing.assert_array_equal(parts[0], parts[1])
            joined.append(parts[0])
        else:
            joined.append(np.concatenate(parts, axis=dim))
        for r in (2, 3):
            np.testing.assert_array_equal(got[r][3][i], got[r - 2][3][i])
    assert_leaves_close(names, joined, leaves_want)


def test_eval_step_matches_jax():
    """``make_eval_step`` over 2 ranks, a metric dict of means on each
    rank's shard of 8 rows, against JAX's ``make_eval_step`` on a 2-device
    mesh (its cross-device means), within 1e-6 relative."""
    from tao_amodal_tpu.parallel.dp import make_eval_step

    x = np.random.RandomState(3).randn(8, 5).astype(np.float32)
    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    want = make_eval_step(lambda p, b: {"mean": jnp.mean(b),
                                        "square": jnp.mean(b * b)},
                          mesh)(None, shard_batch(mesh, x))
    for got in ranks.start(ranks.eval_step, 2, x):
        assert set(got) == {"mean", "square"}
        for k, v in got.items():
            np.testing.assert_allclose(v, float(want[k]), rtol=1e-6)


def test_tp_forward_matches_jax(setup):
    pipe, variables, npz, _ = setup
    clip = np.random.RandomState(7).randn(4, HW, HW, 3).astype(np.float32)
    mesh = make_mesh(data=1, model=2, devices=jax.devices()[:2])
    vt = place_tp(variables, mesh)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda c: pipe(vt, c, score_thr=0.0))(clip))
    for out, whole, shardings in ranks.start(ranks.tp_forward, 2, npz,
                                             clip, 2):
        assert sum(d is not None for d in shardings.values()) == 6
        np.testing.assert_allclose(out["boxes"], whole["boxes"],
                                   rtol=TP_BOX_RTOL, atol=TP_BOX_TOL)
        np.testing.assert_allclose(out["boxes"], want["boxes"], rtol=1e-4,
                                   atol=1e-3)
        for k in ("classes", "track_ids", "valid"):
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)
            np.testing.assert_array_equal(out[k], whole[k], err_msg=k)


def test_tp_param_shardings(setup):
    """The split dims are the transposes of JAX's specs; ``model=3``,
    which divides neither 1024 nor 512, leaves every tensor whole."""
    from torch_port_fixtures import torch_pipeline

    pipe = torch_pipeline(setup[2])
    sh = tp_param_shardings(pipe, types.SimpleNamespace(
        shape={"data": 1, "model": 2}))
    assert {n: d for n, d in sh.items() if d is not None} == {
        "detector.box_head.Dense_0.weight": 0,
        "detector.box_head.Dense_0.bias": 0,
        "detector.box_head.Dense_1.weight": 1,
        "expander.fc0.weight": 0, "expander.fc0.bias": 0,
        "expander.fc1.weight": 1}
    assert "detector.backbone.ConvBN_0.Conv_0.weight" in sh
    odd = tp_param_shardings(pipe, types.SimpleNamespace(
        shape={"data": 2, "model": 3}))
    assert all(d is None for d in odd.values())


def test_dryrun_multichip_runs_to_its_line(capsys):
    sys.path.insert(0, REPO)
    from tools.dryrun_multichip_torch import dryrun_multichip

    r = dryrun_multichip(2, device="cpu", threads=1,
                         timeout=ranks.RANK_TIMEOUT)
    line = capsys.readouterr().out
    assert line.startswith("dryrun_multichip(2): loss=")
    assert r["sharded_infer_boxes"] == (2, 2, 64, 4)
    assert np.isfinite(r["tp_delta"])


def test_multiprocess_smoke_runs_to_its_ok_lines():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "multiprocess_smoke_torch.py"),
         "--cpu"],
        capture_output=True, text=True, timeout=ranks.RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2/2 workers OK" in proc.stdout
    assert "TRAIN PARITY OK" in proc.stdout
    assert proc.stdout.count("MULTIPROCESS OK") == 2

