"""The port's auction association held against the JAX package on the
CPU: ``auction_assign`` at both of ``sort_step``'s (eps, floor)
settings, against JAX's and against the scipy Hungarian oracle;
``sort_step(assignment="auction"|"gated_auction")`` over coherent
scenes; and the stateful ``Sort`` wrapper.

Tolerances: integers (assignments, track ids, report masks, counters)
exact -- the auction is elementwise f32 plus first-index max/argmax on
both sides; SORT's float state rtol 1e-4 + atol 1e-3 (Kalman covariances
reach ~1e4, f32 in another summation order); the wrapper's boxes the
same.  Coherent scenes keep the integers away from f32 near-ties, as in
``test_torch_port_sort.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tao_amodal_tpu.ops import hungarian as jhun
from tao_amodal_tpu.trackers import sort as jsort
from tao_amodal_torch.ops import hungarian as thun
from tao_amodal_torch.trackers import sort as tsort
from torch_port_fixtures import auction_fixpoint, coherent_scene

# sort_step's two auctions: "auction" and "gated_auction" at the SORT
# gate 0.3.
SETTINGS = {"auction": (5e-5, -1e-3), "gated_auction": (1e-3, 0.8 * 0.3)}
SHAPES = {"square": (12, 12), "tall": (16, 7), "wide": (6, 20),
          "empty_rows": (0, 9), "empty_cols": (5, 0)}


def _benefit(rs, n, m, forbidden=0.3):
    """IoU-like payoffs in [0, 1), ``forbidden`` of them NEG, one row
    with no option at all where there are rows."""
    b = rs.rand(n, m).astype(np.float32)
    b[rs.rand(n, m) < forbidden] = thun.NEG
    if n > 1:
        b[n // 2] = thun.NEG
    return b


def _jax_auction(b, eps, floor, max_iters=200_000):
    return np.asarray(jhun.auction_assign(jnp.asarray(b), eps, floor,
                                          max_iters=max_iters))


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_auction_assign_matches_jax(setting, shape):
    """Random payoffs with forbidden entries, five draws a shape; the
    port's assignment equals JAX's index for index, and the numpy
    transcription of the rounds (the host round count of the smoke)
    agrees with both."""
    eps, floor = SETTINGS[setting]
    rs = np.random.RandomState(sorted(SHAPES).index(shape))
    for _ in range(5):
        b = _benefit(rs, *SHAPES[shape])
        got = thun.auction_assign(torch.from_numpy(b), eps, floor).numpy()
        want = _jax_auction(b, eps, floor)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(auction_fixpoint(b, eps, floor)[0],
                                      want)
        taken = got[got >= 0]
        assert len(taken) == len(set(taken.tolist()))
        assert (b[np.nonzero(got >= 0)[0], taken] > thun.NEG / 2).all()


def _price_war(n=10, m=6):
    """Rows with nearly equal payoffs on few columns: hundreds of
    rounds at eps 5e-5 before the losers retire."""
    rs = np.random.RandomState(5)
    return (0.5 + 1e-3 * rs.rand(n, m)).astype(np.float32)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_auction_max_iters_binds_mid_block(setting):
    """A cap that is not a multiple of the host-check block stops the
    port where it stops JAX (the rows still open stay -1); without a
    cap both run to the same end."""
    eps, floor = SETTINGS[setting]
    b = _price_war()
    rounds = auction_fixpoint(b, eps, floor)[1]
    assert rounds > 2 * thun.AUCTION_BLOCK
    for cap in (1, thun.AUCTION_BLOCK + 3, rounds - 1,
                2 * thun.AUCTION_BLOCK + 5):
        assert cap % thun.AUCTION_BLOCK
        got = thun.auction_assign(torch.from_numpy(b), eps, floor,
                                  max_iters=cap).numpy()
        np.testing.assert_array_equal(got, _jax_auction(b, eps, floor,
                                                        max_iters=cap))
        np.testing.assert_array_equal(
            got, auction_fixpoint(b, eps, floor, max_iters=cap)[0])
    full = thun.auction_assign(torch.from_numpy(b), eps, floor).numpy()
    np.testing.assert_array_equal(full, _jax_auction(b, eps, floor))
    assert (full >= 0).sum() == b.shape[1]


def test_auction_matches_hungarian_oracle():
    """Payoffs quantized to 1e-3 (coarser than eps), padded to 8x8 with
    forbidden entries as ``tests/test_sort.py`` pads them: the auction's
    total equals the scipy Hungarian optimum within 5e-4, one to one.
    The port's ``linear_assignment_host`` is JAX's."""
    rng = np.random.RandomState(0)
    for _ in range(20):
        n, m = rng.randint(1, 9), rng.randint(1, 9)
        benefit = np.round(rng.rand(n, m), 3)
        padded = np.full((8, 8), thun.NEG, np.float32)
        padded[:n, :m] = benefit
        got = thun.auction_assign(torch.from_numpy(padded)).numpy()[:n]
        pairs = thun.linear_assignment_host(-benefit)
        np.testing.assert_array_equal(
            pairs, jhun.linear_assignment_host(-benefit))
        best = sum(benefit[r, c] for r, c in pairs)
        total = sum(benefit[i, c] for i, c in enumerate(got) if c >= 0)
        assert abs(total - best) < 5e-4, (benefit, got, pairs)
        assigned = [c for c in got if c >= 0]
        assert len(assigned) == len(set(assigned))


def test_auction_respects_forbidden_entries():
    b = np.full((2, 2), thun.NEG, np.float32)
    b[0, 1] = 0.9
    got = thun.auction_assign(torch.from_numpy(b)).numpy()
    assert got.tolist() == [1, -1]
    assert (thun.auction_assign(torch.full((3, 4), thun.NEG)).numpy()
            == -1).all()


@pytest.mark.parametrize("assignment", ["auction", "gated_auction"])
@pytest.mark.parametrize("seed,max_age,min_hits",
                         [(0, 5, 1), (1, 5, 1), (2, 1, 3)])
def test_sort_step_auctions_match_jax_on_coherent_scenes(
        assignment, seed, max_age, min_hits):
    """The scenes of ``test_sort_step_matches_jax_on_coherent_scenes``
    (births, matches and deaths), under the pipeline's lifecycle (5, 1)
    and classic SORT's (1, 3)."""
    boxes, valid = coherent_scene(seed)
    K = 12
    js = jsort.init_sort(K)
    ts = tsort.init_sort(K, device="cpu")
    step = jax.jit(jsort.sort_step, static_argnames=(
        "max_age", "min_hits", "assignment"))
    for t in range(len(boxes)):
        js, jout = step(js, jnp.asarray(boxes[t]), jnp.asarray(valid[t]),
                        max_age=max_age, min_hits=min_hits,
                        assignment=assignment)
        ts, tout = tsort.sort_step(ts, torch.from_numpy(boxes[t]),
                                   torch.from_numpy(valid[t]),
                                   max_age=max_age, min_hits=min_hits,
                                   assignment=assignment)
        for k in ("det_track_id", "det_report", "slot_report",
                  "slot_track_id"):
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k]), err_msg=k)
        for f in ("alive", "track_id", "hits", "hit_streak", "age",
                  "time_since_update", "next_id", "frame_count"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.P),
                                   rtol=1e-4, atol=1e-3)
    born = int(ts.next_id) - 1
    assert born >= 6 and int(ts.alive.sum()) < born


@pytest.mark.parametrize("kw", [
    dict(max_age=2, min_hits=2, max_tracks=16, max_dets=8),
    dict(max_age=1, min_hits=3, max_tracks=12, max_dets=16),
])
def test_sort_wrapper_matches_jax(kw):
    """``Sort.update`` (auction, the default) frame by frame on a
    coherent scene given as ``[N, 5]`` numpy rows (more rows than
    ``max_dets`` on some frames): the reported rows equal JAX's, ids
    exact, boxes rtol 1e-4 + atol 1e-3 px."""
    boxes, valid = coherent_scene(3, frames=20, objects=10, D=16)
    tracker = tsort.Sort(**kw, device="cpu")
    jtracker = jsort.Sort(**kw)
    assert tracker.max_age == jtracker.max_age == kw["max_age"]
    reported = 0
    for t in range(len(boxes)):
        dets = np.concatenate(
            [boxes[t][valid[t]], np.full((valid[t].sum(), 1), 0.9)], 1)
        got, want = tracker.update(dets), jtracker.update(dets)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got[:, 4], want[:, 4])
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-4,
                                   atol=1e-3)
        reported += len(got)
    assert reported > 0
    assert tracker.update(np.zeros((0, 5))).shape == (0, 5)
