"""Active rows a round of the auction, counted on the host (the numpy
rounds of ``tests/torch_port_fixtures.py::auction_fixpoint``, whose
round count equals the plain version's and the kernel's), for both of
``sort_step``'s auctions over

- the price-war and adversarial scenes of
  ``tests/test_torch_port_auction.py`` (``_price_war``,
  ``auction_adversarial(0)``, ``auction_chain(48)``);
- SORT-like frames (``sort_benefits``) at [64, 128], [192, 384] and
  [256, 512];
- optionally the frames that ``experiments/auction_paired.py`` records
  from the full-width pipeline (its ``build/auction_benefits.npz``).

    python experiments/auction_histogram.py [RECORDED.npz]

Runs on the CPU; prints one line per group: rounds, and rounds by their
count of active rows (1-4 apart, then 5-8, 9-32, >32); and each recorded
frame's rounds and single-row rounds.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from chip_smoke import AUCTION_SETTINGS, active_histogram  # noqa: E402
from test_torch_port_auction import _price_war  # noqa: E402
from torch_port_fixtures import (  # noqa: E402
    auction_adversarial,
    auction_chain,
    auction_fixpoint,
    sort_benefits,
)


def histogram(frames, setting):
    per = []
    for b in frames:
        stats = {}
        auction_fixpoint(b, **setting, stats=stats)
        per += stats.get("per_round", [])
    return len(per), active_histogram(per)


def main():
    groups = {
        "test price war [10, 6]": [_price_war()],
        "auction_adversarial(0)": list(auction_adversarial(0)),
        "auction_chain(48)": [auction_chain(48)],
    }
    for n, m in ((64, 128), (192, 384), (256, 512)):
        groups[f"sort_benefits [{n}, {m}] x4"] = list(
            sort_benefits(n, n=n, m=m, frames=4))
    recorded = np.load(sys.argv[1]) if len(sys.argv) > 1 else {}
    for name, setting in AUCTION_SETTINGS.items():
        frames = dict(groups)
        if name in recorded:
            frames[f"recorded pipeline frames ({len(recorded[name])})"] = list(
                recorded[name])
        for group, bs in frames.items():
            rounds, hist = histogram(bs, setting)
            print(f"{name} {group}: {rounds} rounds; by active rows {hist}")
        if name in recorded:
            per = [histogram([b], setting) for b in recorded[name]]
            print(f"{name} recorded frames one by one (rounds, single-row "
                  f"rounds): {[(r, h['1']) for r, h in per]}")


if __name__ == "__main__":
    main()
