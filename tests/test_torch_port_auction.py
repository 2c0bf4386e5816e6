"""The port's auction association held against the JAX package on the
CPU: ``auction_assign`` at both of ``sort_step``'s (eps, floor)
settings, against JAX's and against the scipy Hungarian oracle, its
round count against the numpy transcription of JAX's rounds, also at
SORT's D = 192 and 256 (K = 2D) and on an eviction chain;
``sort_step(assignment="auction"|"gated_auction")`` over coherent
scenes, also at D = 192 and 256; the never-rising count of active rows
that the kernel's warp-only rounds rest on; and the stateful ``Sort``
wrapper.  The cases are split over four files, so that parallel test
workers share them: this one (the CPU auctions against JAX and the
scipy oracle), ``..._auction_wide.py`` (SORT's auctions at D = 192 and
256), ``..._auction_sort.py`` (``sort_step`` on coherent scenes and the
``Sort`` wrapper) and ``..._auction_cuda.py`` (the ``cuda`` tests, which
hold the kernel, ``csrc/auction.cu::tao_auction_rounds``, to the plain
version on the card, bit for bit: its benefit in shared memory and read
where it lies, its single-row rounds, a shape it refuses; they skip
without a card).  Their shared helpers are
``tests/torch_port_auction_cases.py``.

Tolerances: integers (assignments, round counts, track ids, report
masks, counters) exact -- the auction is elementwise f32 plus
first-index max/argmax on both sides; SORT's float state rtol 1e-4 +
atol 1e-3 (Kalman covariances reach ~1e4, f32 in another summation
order); the wrapper's boxes the same.  Coherent scenes keep the integers
away from f32 near-ties, as in ``test_torch_port_sort.py``.

jax is imported inside the tests that hold the port to the JAX package,
so that on the card's machine, which has no flax, the ``cuda`` tests run
with ``python -m pytest --noconftest tests/test_torch_port_auction_cuda.py
-m cuda``."""

import numpy as np
import pytest
import torch

from tao_amodal_torch.ops import hungarian as thun
from torch_port_auction_cases import (
    SETTINGS,
    SHAPES,
    benefit,
    jax_auction,
    port_auction,
    price_war,
)
from torch_port_fixtures import (
    auction_adversarial,
    auction_chain,
    auction_fixpoint,
    one_torch_thread,
    sort_benefits,
)

# One PyTorch thread: the plain auction runs thousands of rounds of small
# ops, which a thread pool per process starves beside the other test
# workers (about 5 s alone, 600 s under the test runner's six workers).
module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_auction_assign_matches_jax(setting, shape):
    """Random payoffs with forbidden entries, five draws a shape; the
    port's assignment equals JAX's index for index, and the numpy
    transcription of the rounds (the host round count of the smoke)
    agrees with both, in the assignment and in the rounds."""
    eps, floor = SETTINGS[setting]
    rs = np.random.RandomState(sorted(SHAPES).index(shape))
    for _ in range(5):
        b = benefit(rs, *SHAPES[shape])
        got, rounds = port_auction(b, eps, floor)
        want = jax_auction(b, eps, floor)
        np.testing.assert_array_equal(got, want)
        host, host_rounds = auction_fixpoint(b, eps, floor)
        np.testing.assert_array_equal(host, want)
        assert rounds == host_rounds
        taken = got[got >= 0]
        assert len(taken) == len(set(taken.tolist()))
        assert (b[np.nonzero(got >= 0)[0], taken] > thun.NEG / 2).all()


# auction_adversarial's scenes small enough for the plain loop on the CPU.
CPU_SCENES = [i for i, b in enumerate(auction_adversarial(0))
              if b.size <= 33 * 33]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("scene", CPU_SCENES)
def test_auction_assign_matches_jax_on_adversarial_scenes(setting, scene):
    """Tie-rich payoffs (four levels, -0, NEG rows and columns), price
    wars of hundreds of rounds and the degenerate shapes (m = 1, where
    the second value is the floor): the port equals JAX and the numpy
    rounds, assignment and round count."""
    eps, floor = SETTINGS[setting]
    b = list(auction_adversarial(0))[scene]
    got, rounds = port_auction(b, eps, floor)
    np.testing.assert_array_equal(got, jax_auction(b, eps, floor))
    host, host_rounds = auction_fixpoint(b, eps, floor)
    np.testing.assert_array_equal(got, host)
    assert rounds == host_rounds


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_auction_max_iters_binds_mid_block(setting):
    """A cap that is not a multiple of the host-check block stops the
    port where it stops JAX (the rows still open stay -1); without a
    cap both run to the same end."""
    eps, floor = SETTINGS[setting]
    b = price_war()
    rounds = auction_fixpoint(b, eps, floor)[1]
    assert rounds > 2 * thun.AUCTION_BLOCK
    for cap in (1, thun.AUCTION_BLOCK + 3, rounds - 1,
                2 * thun.AUCTION_BLOCK + 5):
        assert cap % thun.AUCTION_BLOCK
        got, ran = port_auction(b, eps, floor, max_iters=cap)
        np.testing.assert_array_equal(got, jax_auction(b, eps, floor,
                                                        max_iters=cap))
        np.testing.assert_array_equal(
            got, auction_fixpoint(b, eps, floor, max_iters=cap)[0])
        assert ran == cap
    full, ran = port_auction(b, eps, floor)
    np.testing.assert_array_equal(full, jax_auction(b, eps, floor))
    assert (full >= 0).sum() == b.shape[1] and ran == rounds


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_auction_active_rows_never_rise(setting):
    """What the kernel's warp-only rounds rest on: the active rows of a
    round never outnumber the previous round's (each evicted owner
    stands for a distinct winning bidder), on the tie-rich, price-war
    and degenerate scenes, SORT-like frames at D = 192 and the eviction
    chain, whose rounds after the first have one active row each."""
    eps, floor = SETTINGS[setting]
    scenes = (list(auction_adversarial(0)) + [price_war()]
              + list(sort_benefits(4, n=192, m=384, frames=2))
              + [auction_chain(48)])
    singles = 0
    for b in scenes:
        stats = {}
        rounds = auction_fixpoint(b, eps, floor, stats=stats)[1]
        per = stats.get("per_round", [])
        assert len(per) == rounds and sum(per) == stats.get("active", 0)
        assert all(a >= c for a, c in zip(per, per[1:])), per
        singles += per.count(1)
    assert per == [48] + [1] * 47
    assert singles > 47  # the other scenes end in single-row rounds too


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_auction_chain_matches_jax(setting):
    """The eviction chain (one round of every row, then single-row
    rounds), run out and cut by ``max_iters`` inside the chain: the port
    equals JAX and the numpy rounds."""
    eps, floor = SETTINGS[setting]
    b = auction_chain(24)
    for cap in (200_000, 2, 13):
        got, rounds = port_auction(b, eps, floor, max_iters=cap)
        np.testing.assert_array_equal(
            got, jax_auction(b, eps, floor, max_iters=cap))
        host, host_rounds = auction_fixpoint(b, eps, floor, max_iters=cap)
        np.testing.assert_array_equal(got, host)
        assert rounds == host_rounds == min(cap, 24)


def test_auction_matches_hungarian_oracle():
    """Payoffs quantized to 1e-3 (coarser than eps), padded to 8x8 with
    forbidden entries as ``tests/test_sort.py`` pads them: the auction's
    total equals the scipy Hungarian optimum within 5e-4, one to one.
    The port's ``linear_assignment_host`` is JAX's."""
    pytest.importorskip("jax")
    from tao_amodal_tpu.ops import hungarian as jhun

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


def test_auction_assign_on_the_cpu_takes_the_plain_version():
    """A CPU tensor runs :func:`auction_assign_torch` (no launch counted);
    empty shapes report 0 rounds."""
    b = benefit(np.random.RandomState(9), 12, 12)
    before = thun.auction_assign.launches
    rounds = torch.zeros(1, dtype=torch.int32)
    got = thun.auction_assign(torch.from_numpy(b), rounds=rounds)
    want = thun.auction_assign_torch(torch.from_numpy(b))
    assert torch.equal(got, want) and int(rounds) > 0
    assert thun.auction_assign.launches == before
    for shape in ((0, 4), (4, 0)):
        rounds.fill_(7)
        got = thun.auction_assign(torch.zeros(shape), rounds=rounds)
        assert got.shape == (shape[0],) and int(rounds) == 0
