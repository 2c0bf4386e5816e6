"""The auction kernel (``csrc/auction.cu::tao_auction_rounds``) held to
its plain version on the card, bit for bit: its benefit in shared
memory and read where it lies, its single-row rounds, a shape it
refuses (split from ``test_torch_port_auction.py``).  The tests skip
without a card; on the card's machine, which has no flax, run them with
``python -m pytest --noconftest tests/test_torch_port_auction_cuda.py -m
cuda``."""

import numpy as np
import pytest
import torch

from tao_amodal_torch.ops import hungarian as thun
from torch_port_auction_cases import (
    SETTINGS,
    SHAPES,
    benefit,
    kernel_matches_plain,
)
from torch_port_fixtures import (
    auction_adversarial,
    auction_chain,
    auction_fixpoint,
    sort_benefits,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_auction_kernel_matches_plain_on_cuda(cuda, setting):
    """``tao_auction_rounds`` against ``auction_assign_torch`` on the same
    card tensors, bit for bit in ``row_to_col`` and in the rounds: the
    adversarial scenes, the random shapes above and a price war cut
    short by ``max_iters``; one launch a call, no host sync."""
    eps, floor = SETTINGS[setting]
    rs = np.random.RandomState(3)
    scenes = list(auction_adversarial(1)) + [
        benefit(rs, *shape) for shape in SHAPES.values()]
    got_r = torch.zeros(1, dtype=torch.int32, device=cuda)
    want_r = torch.zeros(1, dtype=torch.int32, device=cuda)
    for b in scenes:
        bt = torch.from_numpy(b).to(cuda)
        for cap in (200_000, 3):
            before = thun.auction_assign.launches
            got = thun.auction_assign(bt, eps, floor, max_iters=cap,
                                      rounds=got_r)
            want = thun.auction_assign_torch(bt, eps, floor, max_iters=cap,
                                             rounds=want_r)
            assert torch.equal(got, want), (b.shape, cap)
            assert int(got_r) == int(want_r), (b.shape, cap)
            assert thun.auction_assign.launches == before + (b.size > 0)
    bt = torch.from_numpy(list(auction_adversarial(1))[-3]).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        thun.auction_assign(bt, eps, floor, rounds=got_r)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("shape", [(192, 384), (256, 512), (300, 300)])
def test_auction_kernel_global_form_matches_plain_on_cuda(cuda, setting,
                                                         shape):
    """Benefits past the block's shared memory, read where they lie:
    SORT-like frames, random payoffs and a price war, run out and cut
    short by ``max_iters``, bit-equal to the plain version with no host
    sync."""
    from tao_amodal_torch import _build

    eps, floor = SETTINGS[setting]
    n, m = shape
    lib = _build.library()
    assert lib.tao_auction_rounds_smem(n, m, 1) < 0
    assert lib.tao_auction_rounds_smem(n, m, 0) > 0
    rs = np.random.RandomState(n)
    scenes = list(sort_benefits(n, n=n, m=m, frames=2)) + [
        rs.rand(n, m).astype(np.float32),
        (0.5 + 1e-3 * rs.rand(n, m)).astype(np.float32)]
    for b in scenes:
        ran = kernel_matches_plain(torch.from_numpy(b).to(cuda), eps, floor,
                                    (200_000, 3))
        assert ran[0] == auction_fixpoint(b, eps, floor)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_auction_kernel_single_row_rounds_match_plain_on_cuda(cuda, setting):
    """Auctions that end in a chain of single-row rounds, which warp 0
    runs alone: the eviction chain in shared memory (48) and read where
    it lies (300), square price wars and a SORT-like frame; each run out
    and cut by ``max_iters`` at the switch, inside the chain and one
    round before its end, bit-equal to the plain version with no host
    sync."""
    eps, floor = SETTINGS[setting]
    rs = np.random.RandomState(11)
    scenes = [auction_chain(48), auction_chain(300)] + [
        (0.5 + 1e-3 * rs.rand(k, k)).astype(np.float32) for k in (16, 32)
    ] + list(sort_benefits(6, frames=1))
    chains = 0
    for b in scenes:
        stats = {}
        rounds = auction_fixpoint(b, eps, floor, stats=stats)[1]
        per = stats["per_round"]
        first = per.index(1) if 1 in per else rounds
        chains += rounds - first >= 10
        caps = sorted({200_000, first + 1, first + (rounds - first) // 2,
                       max(rounds - 1, 1)})
        ran = kernel_matches_plain(torch.from_numpy(b).to(cuda), eps, floor,
                                    caps)
        assert ran == [min(c, rounds) for c in caps]
    assert chains >= 2


@pytest.mark.cuda
def test_auction_kernel_refuses_oversized_shapes_on_cuda(cuda):
    """A benefit whose state (16 bytes a column, 12 a row) does not fit
    in the block's shared memory raises; it never runs elsewhere."""
    from tao_amodal_torch import _build

    assert _build.library().tao_auction_rounds_smem(8, 16000, 0) < 0
    before = thun.auction_assign.launches
    with pytest.raises(ValueError, match="shared memory"):
        thun.auction_assign(torch.rand(8, 16000, device=cuda))
    assert thun.auction_assign.launches == before
