"""SORT's auctions at D = 192 and 256 (K = 2D), the widths whose benefit
the kernel reads where it lies, held against the JAX package on the
CPU: ``auction_assign`` on SORT-like benefits and ``sort_step`` over
coherent scenes (split from ``test_torch_port_auction.py``, whose
docstring states the tolerances)."""

import numpy as np
import pytest

from torch_port_auction_cases import (
    SETTINGS,
    WIDE_D,
    jax_auction,
    port_auction,
    sort_matches_jax,
)
from torch_port_fixtures import (
    auction_fixpoint,
    coherent_scene,
    one_torch_thread,
    sort_benefits,
)

# One PyTorch thread: the plain auction runs thousands of rounds of small
# ops, which a thread pool per process starves beside the other test
# workers (about 5 s alone, 600 s under the test runner's six workers).
module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("D", WIDE_D)
def test_auction_assign_matches_jax_at_wide_sort_shapes(setting, D):
    """SORT-like benefits ``[D, 2D]`` (a zero plateau of detections that
    overlap no track, exact ties, dead slots) at the widths the kernel
    reads where they lie: the port equals JAX and the numpy rounds,
    assignment and round count."""
    eps, floor = SETTINGS[setting]
    for b in sort_benefits(D, n=D, m=2 * D, frames=2):
        got, rounds = port_auction(b, eps, floor)
        np.testing.assert_array_equal(got, jax_auction(b, eps, floor))
        host, host_rounds = auction_fixpoint(b, eps, floor)
        np.testing.assert_array_equal(got, host)
        assert rounds == host_rounds > 0


@pytest.mark.parametrize("assignment", ["auction", "gated_auction"])
@pytest.mark.parametrize("D", WIDE_D)
def test_sort_step_auctions_match_jax_at_wide_shapes(assignment, D):
    """``sort_step`` with D detection slots and the pipeline's K = 2D
    track slots (``init_tracker_state``), the shapes whose benefit the
    kernel reads where it lies: a coherent scene of 3D/4 objects on a
    wide canvas, under the pipeline's lifecycle (5, 1)."""
    boxes, valid = coherent_scene(D, frames=8, objects=3 * D // 4, D=D,
                                  extent=2500)
    ts = sort_matches_jax(boxes, valid, 2 * D, 5, 1, assignment)
    assert int(ts.next_id) - 1 >= D // 2
