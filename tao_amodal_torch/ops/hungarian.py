"""Greedy linear assignment on device (parallel mutual-best rounds).

Port of ``tao_amodal_tpu/ops/hungarian.py::greedy_assign``, the
flagship pipeline's SORT association.  The auction variants wait for a
later slice.
"""

from __future__ import annotations

import torch

NEG = -1e9


def greedy_assign(benefit, unrolled_rounds=6):
    """Sequential-greedy matching (global max first), computed in
    parallel rounds of mutual-best pairing: each round matches every
    (row, col) pair that are each other's argmax among the unmatched, a
    set that always holds the current global maximum, so the fixpoint is
    the sequential greedy matching.

    The first ``unrolled_rounds`` rounds run without a host check; then
    the host checks for open rows after each further block of rounds
    (one sync per call in the usual case), bounded by ``n`` rounds.

    Returns ``row_to_col [n]`` int64, -1 unassigned.
    """
    n, m = benefit.shape
    dev = benefit.device
    r2c = torch.full((n,), -1, dtype=torch.long, device=dev)
    if n == 0 or m == 0:
        return r2c
    b = torch.where(benefit > NEG / 2, benefit.to(torch.float32), NEG)
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
