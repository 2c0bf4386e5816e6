"""The port's clip-level SORT scan held against the JAX package on the
CPU: ``sort_scan`` with ``impl="auto"`` (the per-frame loop) and
``impl="pallas"`` (on a CPU state the kernel wrapper takes the same
plain version) against JAX ``sort_scan(impl="auto")``, the XLA scan of
``sort_step``.

Integers (track ids, report masks, lifecycle counters, next_id) exact on
coherent-motion scenes (f32 near-ties on random scenes may flip an
argmax between frameworks); float state at rtol 1e-4 / atol 1e-3
(Kalman covariances reach ~1e4; f32 in another summation order).  The
kernel itself (B3) is held against the plain loop on the card by
``test_torch_port_isolation.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tao_amodal_tpu.ops.pallas import sort_scan as jscan
from tao_amodal_tpu.trackers import sort as jsort
from tao_amodal_torch.ops import sort_scan as tscan
from tao_amodal_torch.trackers import sort as tsort
from torch_port_fixtures import coherent_scene

K = 16
INTS = ("alive", "track_id", "hits", "hit_streak", "age",
        "time_since_update", "next_id", "frame_count")


def _assert_same(ts, js, tout, jout):
    for got, want, name in zip(tout, jout, ("det_track_id", "det_report")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    for f in INTS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f)
    for f in ("x", "P"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   rtol=1e-4, atol=1e-3, err_msg=f)


def _both(boxes, valid, states, impl, **kw):
    ts, js = states
    tout = tscan.sort_scan(ts, torch.from_numpy(boxes),
                           torch.from_numpy(valid), impl=impl, **kw)
    jout = jscan.sort_scan(js, jnp.asarray(boxes), jnp.asarray(valid),
                           impl="auto", **kw)
    return tout, jout


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("seed,max_age,min_hits", [(0, 5, 1), (1, 1, 3)])
def test_sort_scan_matches_jax(seed, max_age, min_hits, impl):
    """(5, 1) is the pipeline's lifecycle, (1, 3) classic SORT's; the
    clip has births, matches and deaths."""
    boxes, valid = coherent_scene(seed, frames=16, D=12)
    before = tscan.sort_scan_pallas.launches
    (ts, tout), (js, jout) = _both(
        boxes, valid, (tsort.init_sort(K, "cpu"), jsort.init_sort(K)), impl,
        max_age=max_age, min_hits=min_hits)
    assert tscan.sort_scan_pallas.launches == before
    _assert_same(ts, js, tout, jout)
    assert tout[0].shape == (16, 12) and tout[0].dtype == torch.int32
    assert tout[1].dtype == torch.bool
    assert int(ts.next_id) - 1 >= 6
    assert int(ts.alive.sum()) < int(ts.next_id) - 1


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_sort_scan_threads_state_like_jax(impl):
    """Two calls with the state threaded keep ids continuous, as in
    JAX, and equal one call over the whole scene."""
    boxes, valid = coherent_scene(2, frames=16, D=12)
    states = (tsort.init_sort(K, "cpu"), jsort.init_sort(K))
    kw = dict(max_age=5, min_hits=1)
    for sl in (slice(0, 8), slice(8, 16)):
        (ts, tout), (js, jout) = _both(boxes[sl], valid[sl], states, impl,
                                       **kw)
        _assert_same(ts, js, tout, jout)
        states = (ts, js)
    whole, _ = tscan.sort_scan(tsort.init_sort(K, "cpu"),
                               torch.from_numpy(boxes),
                               torch.from_numpy(valid), impl=impl, **kw)
    assert torch.equal(whole.track_id, ts.track_id)
    assert int(whole.next_id) == int(ts.next_id)
    # The second clip reuses ids born in the first.
    ids = tout[0][tout[0] > 0]
    assert ids.numel() and int(ids.min()) < 8


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_sort_scan_empty_and_full_frames(impl):
    """No detections at all, then full-D bursts (spawn pressure: more
    unmatched detections than free slots on the last frame)."""
    T, D = 4, 12
    rs = np.random.RandomState(0)
    xy = rs.uniform(0, 200, (T, D, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + 20.0], -1)
    valid = np.zeros((T, D), bool)
    valid[2:] = True
    (ts, tout), (js, jout) = _both(
        boxes, valid, (tsort.init_sort(K, "cpu"), jsort.init_sort(K)), impl,
        max_age=1, min_hits=1)
    _assert_same(ts, js, tout, jout)
    assert (tout[0][:2] == 0).all() and not tout[1][:2].any()
    assert int(ts.alive.sum()) == K


def test_jax_kernel_interpret_matches_port():
    """The JAX whole-clip kernel itself, in interpret mode (T=4, D=8,
    K=16), against the port's scan: exact integers."""
    boxes, valid = coherent_scene(4, frames=4, objects=5, D=8)
    js, (jids, jrep) = jscan.sort_scan_pallas(
        jsort.init_sort(K), jnp.asarray(boxes), jnp.asarray(valid),
        max_age=5, min_hits=1, interpret=True)
    ts, (tids, trep) = tscan.sort_scan(
        tsort.init_sort(K, "cpu"), torch.from_numpy(boxes),
        torch.from_numpy(valid), max_age=5, min_hits=1, impl="pallas")
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    assert int(ts.next_id) == int(js.next_id) > 1


def test_sort_scan_rejects_unknown_impl():
    boxes, valid = coherent_scene(0, frames=3, objects=2, D=4)
    with pytest.raises(ValueError, match="impl"):
        tscan.sort_scan(tsort.init_sort(K, "cpu"), torch.from_numpy(boxes),
                        torch.from_numpy(valid), impl="xla")
