"""SORT of the port held against the JAX package on the CPU: greedy
assignment, the Kalman filter, and ``sort_step`` over whole scenes.

SORT ties: integer outputs (track ids, report masks, next_id) must match
exactly, so the scenes have coherent motion -- f32 near-ties on random
scenes may flip an argmax between the two frameworks.  Float state is
compared at rtol 1e-4 / atol 1e-3 (Kalman covariances reach ~1e4;
f32 in another summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tao_amodal_tpu.ops import hungarian as jhun
from tao_amodal_tpu.ops import kalman as jkal
from tao_amodal_tpu.trackers import sort as jsort
from tao_amodal_torch.ops import hungarian as thun
from tao_amodal_torch.ops import kalman as tkal
from tao_amodal_torch.trackers import sort as tsort
from torch_port_fixtures import coherent_scene, tie_scene


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_assign_matches_jax(seed):
    """Distinct IoU-like payoffs with forbidden entries, and a chain
    longer than the 6 unrolled rounds."""
    rs = np.random.RandomState(seed)
    b = rs.permutation(24 * 40).reshape(24, 40).astype(np.float32) / 1e3
    b[rs.rand(24, 40) < 0.3] = thun.NEG
    got = thun.greedy_assign(torch.from_numpy(b)).numpy()
    want = np.asarray(jhun.greedy_assign(jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)

    n = 12  # row i prefers col i, col i prefers row i+1: a long chain
    chain = np.full((n, n), thun.NEG, np.float32)
    for i in range(n):
        chain[i, i] = 1.0 + i
        if i + 1 < n:
            chain[i + 1, i] = 1.5 + i
    np.testing.assert_array_equal(
        thun.greedy_assign(torch.from_numpy(chain)).numpy(),
        np.asarray(jhun.greedy_assign(jnp.asarray(chain))))


def test_kalman_matches_jax():
    rs = np.random.RandomState(2)
    boxes = np.concatenate([rs.rand(5, 2) * 100,
                            rs.rand(5, 2) * 100 + 110], 1).astype(
        np.float32)
    x, P = tkal.init_state(torch.from_numpy(boxes))
    jx, jP = jkal.init_state(jnp.asarray(boxes))
    z = tkal.bbox_to_z(torch.from_numpy(boxes + 3))
    gate = torch.tensor([True, False, True, True, False])
    for _ in range(3):
        x, P = tkal.predict(x, P)
        jx, jP = jkal.predict(jx, jP)
        x, P = tkal.update(x, P, z, gate=gate)
        jx, jP = jkal.update(jx, jP, jnp.asarray(z.numpy()),
                             gate=jnp.asarray(gate.numpy()))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(tkal.state_to_bbox(x).numpy(),
                               np.asarray(jkal.state_to_bbox(jx)),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("seed,max_age,min_hits",
                         [(0, 5, 1), (1, 5, 1), (2, 1, 3)])
def test_sort_step_matches_jax_on_coherent_scenes(seed, max_age,
                                                  min_hits):
    """(5, 1) is the pipeline's lifecycle, (1, 3) classic SORT's."""
    boxes, valid = coherent_scene(seed)
    K = 12
    js = jsort.init_sort(K)
    ts = tsort.init_sort(K, device="cpu")
    step = jax.jit(jsort.sort_step, static_argnames=(
        "max_age", "min_hits", "assignment"))
    born = 0
    for t in range(len(boxes)):
        js, jout = step(js, jnp.asarray(boxes[t]), jnp.asarray(valid[t]),
                        max_age=max_age, min_hits=min_hits,
                        assignment="greedy")
        ts, tout = tsort.sort_step(ts, torch.from_numpy(boxes[t]),
                                   torch.from_numpy(valid[t]),
                                   max_age=max_age, min_hits=min_hits,
                                   assignment="greedy")
        for k in ("det_track_id", "det_report", "slot_report",
                  "slot_track_id"):
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k]), err_msg=k)
        for f in ("alive", "hits", "hit_streak", "age",
                  "time_since_update", "next_id", "frame_count"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.P),
                                   rtol=1e-4, atol=1e-3)
        born = int(ts.next_id) - 1
    # The scene exercised births, matches and deaths.
    assert born >= 6
    assert int(ts.alive.sum()) < born


@pytest.mark.parametrize("max_age,min_hits", [(5, 1), (1, 3)])
def test_sort_step_matches_jax_on_a_tie_rich_scene(max_age, min_hits):
    """The scene B3's IoU gate is tested on (``tie_scene``: 64 valid
    detections a frame, IoUs exactly at the 0.3 gate, rows that tie
    exactly, slots that fill up), 3 clips of 8 frames over 128 slots:
    the port's greedy ``sort_step``, the plain version B3 is held to,
    gives every integer output of the JAX greedy ``sort_step``."""
    K = 128
    js = jsort.init_sort(K)
    ts = tsort.init_sort(K, device="cpu")
    step = jax.jit(jsort.sort_step, static_argnames=(
        "max_age", "min_hits", "assignment"))
    at_gate = 0
    for boxes, valid in tie_scene(0):
        for t in range(len(boxes)):
            js, jout = step(js, jnp.asarray(boxes[t]),
                            jnp.asarray(valid[t]), max_age=max_age,
                            min_hits=min_hits, assignment="greedy")
            iou = tsort.box_iou_xyxy(
                torch.from_numpy(boxes[t]),
                tkal.state_to_bbox(tkal.predict(ts.x, ts.P)[0]),
            ).numpy()[:, ts.alive.numpy()]
            at_gate += int((iou == np.float32(0.3)).sum())
            ts, tout = tsort.sort_step(ts, torch.from_numpy(boxes[t]),
                                       torch.from_numpy(valid[t]),
                                       max_age=max_age, min_hits=min_hits,
                                       assignment="greedy")
            for k in ("det_track_id", "det_report", "slot_report",
                      "slot_track_id"):
                np.testing.assert_array_equal(tout[k].numpy(),
                                              np.asarray(jout[k]),
                                              err_msg=k)
            for f in ("alive", "track_id", "hits", "hit_streak", "age",
                      "time_since_update", "next_id", "frame_count"):
                np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                              np.asarray(getattr(js, f)),
                                              err_msg=f)
            np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                                       rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.P),
                                       rtol=1e-4, atol=1e-3)
    # The ties reached the association: IoUs exactly at the gate.
    assert at_gate >= 100


def _assignment_default(fn):
    import inspect

    return inspect.signature(fn).parameters["assignment"].default


def test_assignment_defaults_are_jax_defaults():
    """``sort_step`` defaults to the auction and ``sort_scan`` to greedy,
    in the port as in the JAX package."""
    from tao_amodal_tpu.ops.pallas import sort_scan as jscan
    from tao_amodal_torch.ops import sort_scan as tscan

    assert _assignment_default(tsort.sort_step) == "auction"
    assert _assignment_default(jsort.sort_step) == "auction"
    assert _assignment_default(tscan.sort_scan) == "greedy"
    assert _assignment_default(jscan.sort_scan) == "greedy"
    assert _assignment_default(tscan.sort_scan_torch) == "greedy"


@pytest.mark.parametrize("assignment", ["auction", "gated_auction"])
def test_auction_assignments_raise_instead_of_running_greedy(assignment):
    """No entry point runs greedy when an auction is asked for:
    ``sort_step`` (also at its default, the auction) and
    ``sort_scan(impl="auto")`` run the auction, equal to the JAX
    ``sort_scan`` with that assignment in every integer (float state
    rtol 1e-4 + atol 1e-3), and ``sort_scan(impl="pallas")``, kernel
    B3, which is greedy only, raises ValueError."""
    from tao_amodal_tpu.ops.pallas import sort_scan as jscan
    from tao_amodal_torch.ops import sort_scan as tscan

    boxes, valid = coherent_scene(0, frames=6)
    state = tsort.init_sort(12, device="cpu")
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    _, default = tsort.sort_step(state, b[0], v[0])
    _, asked = tsort.sort_step(state, b[0], v[0], assignment="auction")
    for k in default:
        assert torch.equal(default[k], asked[k]), k
    got_s, (got_ids, got_rep) = tscan.sort_scan(state, b, v,
                                                assignment=assignment)
    want_s, (want_ids, want_rep) = jax.jit(
        jscan.sort_scan, static_argnames=("assignment",))(
        jsort.init_sort(12), jnp.asarray(boxes), jnp.asarray(valid),
        assignment=assignment)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_rep.numpy(), np.asarray(want_rep))
    for f in ("alive", "track_id", "hits", "hit_streak", "age",
              "time_since_update", "next_id", "frame_count"):
        np.testing.assert_array_equal(getattr(got_s, f).numpy(),
                                      np.asarray(getattr(want_s, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got_s.x.numpy(), np.asarray(want_s.x),
                               rtol=1e-4, atol=1e-3)
    assert int(got_s.next_id) > 1
    with pytest.raises(ValueError, match="greedy"):
        tscan.sort_scan(state, b, v, assignment=assignment, impl="pallas")


def test_unknown_assignment_raises_value_error():
    from tao_amodal_torch.ops import sort_scan as tscan

    boxes, valid = coherent_scene(0, frames=6)
    state = tsort.init_sort(12, device="cpu")
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    with pytest.raises(ValueError, match="assignment"):
        tsort.sort_step(state, b[0], v[0], assignment="hungarian")
    for impl in ("auto", "pallas"):
        with pytest.raises(ValueError, match="assignment"):
            tscan.sort_scan(state, b, v, assignment="hungarian", impl=impl)
