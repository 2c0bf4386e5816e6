"""``sort_step(assignment="auction"|"gated_auction")`` over coherent
scenes and the stateful ``Sort`` wrapper held against the JAX package
on the CPU (split from ``test_torch_port_auction.py``, whose docstring
states the tolerances)."""

import numpy as np
import pytest

from tao_amodal_torch.trackers import sort as tsort
from torch_port_auction_cases import sort_matches_jax
from torch_port_fixtures import (
    coherent_scene,
    one_torch_thread,
)

# One PyTorch thread: the plain auction runs thousands of rounds of small
# ops, which a thread pool per process starves beside the other test
# workers (about 5 s alone, 600 s under the test runner's six workers).
module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


@pytest.mark.parametrize("assignment", ["auction", "gated_auction"])
@pytest.mark.parametrize("seed,max_age,min_hits",
                         [(0, 5, 1), (1, 5, 1), (2, 1, 3)])
def test_sort_step_auctions_match_jax_on_coherent_scenes(
        assignment, seed, max_age, min_hits):
    """The scenes of ``test_sort_step_matches_jax_on_coherent_scenes``
    (births, matches and deaths), under the pipeline's lifecycle (5, 1)
    and classic SORT's (1, 3)."""
    boxes, valid = coherent_scene(seed)
    ts = sort_matches_jax(boxes, valid, 12, max_age, min_hits, assignment)
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
    pytest.importorskip("jax")
    from tao_amodal_tpu.trackers import sort as jsort

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
