"""Linear assignment on device: greedy rounds and the auction.

Port of :mod:`tao_amodal_tpu.ops.hungarian`.  ``greedy_assign`` is the
flagship pipeline's SORT association (its rounds one launch of
``csrc/fixpoint.cu::tao_greedy_fixpoint`` on the card, no host sync);
``auction_assign`` is the Bertsekas auction behind ``sort_step``'s
default ``"auction"`` and its ``"gated_auction"``: Hungarian-optimal
within ``n * eps``, its rounds one launch of
``csrc/auction.cu::tao_auction_rounds`` on the card, no host sync.
``linear_assignment_host`` (scipy) is the exact host oracle of the
tests.
"""

from __future__ import annotations

import numpy as np
import torch

from tao_amodal_torch import _build

NEG = -1e9

# The plain auction's rounds between two host checks for an active row
# (a round is ~20 eager ops; a short block wastes few no-op rounds at the
# end of a frame).
AUCTION_BLOCK = 4


def greedy_assign(benefit, unrolled_rounds=6):
    """Sequential-greedy matching (global max first), computed in
    parallel rounds of mutual-best pairing: each round matches every
    (row, col) pair that are each other's argmax among the unmatched, a
    set that always holds the current global maximum, so the fixpoint is
    the sequential greedy matching.

    The benefit is masked first (entries at or below ``NEG/2``, NaN and
    -inf become ``NEG``), then :func:`greedy_fixpoint` runs the rounds:
    one kernel launch on the card, the plain loop on the CPU.

    Returns ``row_to_col [n]`` int64, -1 unassigned.
    """
    n, m = benefit.shape
    if n == 0 or m == 0:
        return torch.full((n,), -1, dtype=torch.long,
                          device=benefit.device)
    b = torch.where(benefit > NEG / 2, benefit.to(torch.float32), NEG)
    return greedy_fixpoint(b, unrolled_rounds)


def greedy_fixpoint_torch(b, unrolled_rounds=6):
    """Plain version of :func:`greedy_fixpoint`: the first
    ``unrolled_rounds`` rounds run without a host check; then the host
    checks for open rows after each further block of rounds (one sync
    per call in the usual case), bounded by ``n`` rounds."""
    n, m = b.shape
    dev = b.device
    r2c = torch.full((n,), -1, dtype=torch.long, device=dev)
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)

    rounds = 0
    while rounds < n:
        for _ in range(min(unrolled_rounds, n - rounds)):
            best_val, best_col = b.max(dim=1)
            best_row = b.argmax(dim=0)
            mutual = (best_row[best_col] == rows) & (best_val > NEG / 2)
            r2c = torch.where(mutual, best_col, r2c)
            # Columns taken this round, as a dense [n, m] test rather
            # than a scatter of True, which on a CUDA tensor copies the
            # scalar from the host and syncs every round.
            taken = (mutual[:, None] & (best_col[:, None] == cols)).any(0)
            b = torch.where(mutual[:, None] | taken[None, :], NEG, b)
            rounds += 1
        if not bool((b.max(dim=1).values > NEG / 2).any()):  # host sync
            break
    return r2c


def greedy_fixpoint(b, unrolled_rounds=6, rounds=None):
    """The greedy mutual-best fixpoint of the masked benefit ``b [n, m]``
    (f32, every entry ``NEG`` or above ``NEG/2``, no NaN: what
    :func:`greedy_assign` passes) -> ``row_to_col [n]`` int64.

    A CPU ``b`` takes the plain version; a CUDA ``b`` launches
    ``tao_greedy_fixpoint`` once (``csrc/fixpoint.cu``: one block, every
    round on the card, first-index ties as ``torch.max``), or this
    raises.  ``rounds``, one int32 beside ``b``, receives the kernel's
    rounds (a plateau of equal values is one of them); the plain version
    ignores it.
    ``launches`` counts the launches.
    """
    if b.device.type == "cpu":
        return greedy_fixpoint_torch(b, unrolled_rounds)
    if b.device.type != "cuda":
        raise ValueError(f"greedy_fixpoint: unsupported device {b.device}")
    if b.dtype != torch.float32 or b.dim() != 2:
        raise ValueError(f"greedy_fixpoint: want f32 b [n, m], got "
                         f"{b.dtype} {tuple(b.shape)}")
    if rounds is not None and (rounds.dtype != torch.int32
                               or rounds.numel() != 1
                               or rounds.device != b.device):
        raise ValueError("greedy_fixpoint: rounds must be one int32 "
                         "beside b")
    n, m = b.shape
    r2c = torch.full((n,), -1, dtype=torch.long, device=b.device)
    if n == 0 or m == 0:
        return r2c
    lib = _build.library()
    if lib.tao_greedy_fixpoint_smem(n, m, 0) < 0:
        raise ValueError(f"greedy_fixpoint: n={n}, m={m} exceed the "
                         f"kernel's shared memory")
    b = b.contiguous()
    err = lib.tao_greedy_fixpoint(
        b.data_ptr(), r2c.data_ptr(),
        None if rounds is None else rounds.data_ptr(), n, m,
        torch.cuda.current_stream(b.device).cuda_stream)
    _build.check("tao_greedy_fixpoint", err)
    greedy_fixpoint.launches += 1
    return r2c


greedy_fixpoint.launches = 0


def _f32(x):
    """A constant as its f32 value, so every comparison and sum is f32
    whatever precision an op computes a Python scalar in."""
    return float(np.float32(x))


def auction_assign_torch(benefit, eps=5e-5, floor=-1e-3, max_iters=200_000,
                         rounds=None):
    """Plain version of :func:`auction_assign`, on any device.

    The JAX ``while_loop`` checks for an active row before every round;
    here the host checks once per block of ``AUCTION_BLOCK`` rounds (a
    block never runs past ``max_iters``).  Once no row is active a
    round is a no-op -- nothing bids, no column is contested, prices and
    owners stay -- so the rest of the last block changes nothing, and
    this stops exactly where JAX stops, also when ``max_iters`` binds.
    ``rounds`` (one int32 beside ``benefit``) receives the rounds that
    had an active row: JAX's count.
    """
    n, m = benefit.shape
    dev = benefit.device
    f32 = torch.float32
    if n == 0 or m == 0:
        if rounds is not None:
            rounds.zero_()
        return torch.full((n,), -1, dtype=torch.long, device=dev)
    eps, floor = _f32(eps), _f32(floor)
    # JAX's shift: feasible entries less their minimum (if below 0).
    benefit = benefit.to(f32)
    feasible = benefit > NEG / 2
    has_option = feasible.any(1)
    minb = torch.where(feasible, benefit, float("inf")).min()
    minb = torch.where(minb.isfinite(), minb.clamp_max(0.0), 0.0)
    b = torch.where(feasible, benefit - minb, NEG)

    cols = torch.arange(m, device=dev)
    price = torch.zeros((m,), dtype=f32, device=dev)
    retired = torch.zeros((n,), dtype=torch.bool, device=dev)
    ran = torch.zeros((), dtype=torch.int32, device=dev)
    # row_to_col with a scratch entry n for the winners' scatter, which
    # JAX drops (``mode="drop"``): every uncontested column writes there.
    # Each row bids on one column, so the kept writes never collide.
    r2c = torch.full((n + 1,), -1, dtype=torch.long, device=dev)

    it = 0
    while it < max_iters:
        for _ in range(min(AUCTION_BLOCK, max_iters - it)):
            owner = r2c[:n]
            value = b - price
            best_val, best_col = value.max(dim=1)
            is_best = best_col[:, None] == cols
            second_val = torch.where(is_best, NEG, value).max(
                dim=1).values.clamp_min(floor)
            bid = best_val - second_val + eps

            active = (owner < 0) & has_option & ~retired
            ran = ran + active.any()
            retire_now = active & (best_val < floor)
            retired = retired | retire_now
            bidding = active & ~retire_now

            bids = torch.where(bidding[:, None] & is_best, bid[:, None],
                               float("-inf"))
            win_bid, win_row = bids.max(dim=0)
            contested = win_bid > float("-inf")
            evicted = (owner >= 0) & contested[owner.clamp_min(0)]
            r2c = torch.cat([torch.where(evicted, -1, owner), r2c[n:]])
            r2c[torch.where(contested, win_row, n)] = torch.where(
                contested, cols, -1)
            price = torch.where(contested, price + win_bid, price)
            it += 1
        active = (r2c[:n] < 0) & has_option & ~retired
        if not bool(active.any()):  # host sync
            break
    if rounds is not None:
        rounds.copy_(ran)
    return r2c[:n]


def auction_assign(benefit, eps=5e-5, floor=-1e-3, max_iters=200_000,
                   rounds=None):
    """Maximize the sum of ``benefit[i, row_to_col[i]]`` over one-to-one
    matches (entries <= ``NEG/2`` forbidden), by the JAX package's
    auction: benefits shifted so the feasible minimum is 0, rounds of
    bids ``best - second + eps`` (second at least ``floor``), the highest
    bid on a column wins it and evicts its owner (a tie to the lowest
    row), and a row whose best net value falls below ``floor`` retires
    for good (prices never fall).  Ties go to the first index, f32
    throughout; the rounds stop when no row is active or at
    ``max_iters``.

    A CPU ``benefit`` takes the plain version
    (:func:`auction_assign_torch`); a CUDA one launches
    ``tao_auction_rounds`` once (``csrc/auction.cu``: one block, the
    shift and every round on the card, no host sync), or this raises.
    The benefit lies in the block's shared memory where it fits (4 n m
    bytes beside the state) and is read where it lies past that; the
    state alone, 16 m + 12 n + 136 bytes, must fit in the 227 KB of a
    block (SORT's [D, 2D] up to D = 5279), else this raises a
    ``ValueError`` naming shared memory.  ``rounds``, one int32 beside
    ``benefit``, receives the rounds run.  ``launches`` counts the
    launches.

    Returns ``row_to_col [n]`` int64, -1 unassigned.
    """
    if benefit.device.type == "cpu":
        return auction_assign_torch(benefit, eps, floor, max_iters, rounds)
    if benefit.device.type != "cuda":
        raise ValueError(f"auction_assign: unsupported device "
                         f"{benefit.device}")
    if benefit.dim() != 2:
        raise ValueError(f"auction_assign: want benefit [n, m], got "
                         f"{tuple(benefit.shape)}")
    if rounds is not None and (rounds.dtype != torch.int32
                               or rounds.numel() != 1
                               or rounds.device != benefit.device):
        raise ValueError("auction_assign: rounds must be one int32 beside "
                         "benefit")
    n, m = benefit.shape
    r2c = torch.full((n,), -1, dtype=torch.long, device=benefit.device)
    if n == 0 or m == 0:
        if rounds is not None:
            rounds.zero_()
        return r2c
    lib = _build.library()
    if lib.tao_auction_rounds_smem(n, m, 0) < 0:
        raise ValueError(f"auction_assign: n={n}, m={m} exceed the "
                         f"kernel's shared memory")
    b = benefit.to(torch.float32).contiguous()
    err = lib.tao_auction_rounds(
        b.data_ptr(), r2c.data_ptr(),
        None if rounds is None else rounds.data_ptr(), n, m, _f32(eps),
        _f32(floor), max(0, min(int(max_iters), 2 ** 31 - 1)),
        torch.cuda.current_stream(benefit.device).cuda_stream)
    _build.check("tao_auction_rounds", err)
    auction_assign.launches += 1
    return r2c


auction_assign.launches = 0


def linear_assignment_host(cost):
    """Exact Hungarian via scipy (host), minimizing ``cost``.

    Returns ``[K, 2]`` (row, col) pairs, the reference's
    ``linear_assignment`` contract; the tests' oracle for
    :func:`auction_assign`.
    """
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(np.asarray(cost))
    return np.stack([rows, cols], axis=1)
