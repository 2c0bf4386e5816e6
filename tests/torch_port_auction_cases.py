"""What the split auction tests (``tests/test_torch_port_auction*.py``)
share: ``sort_step``'s two (eps, floor) settings, payoff shapes, the
port's and JAX's auctions on a numpy benefit, a price war, SORT step by
step against JAX's, and the kernel against its plain version on the
card.  jax is imported inside the functions that need it, so that the
``cuda`` tests run on the card's machine, which has no flax."""

import numpy as np
import pytest
import torch

from tao_amodal_torch.ops import hungarian as thun
from tao_amodal_torch.trackers import sort as tsort

# sort_step's two auctions: "auction" and "gated_auction" at the SORT
# gate 0.3.
SETTINGS = {"auction": (5e-5, -1e-3), "gated_auction": (1e-3, 0.8 * 0.3)}
SHAPES = {"square": (12, 12), "tall": (16, 7), "wide": (6, 20),
          "empty_rows": (0, 9), "empty_cols": (5, 0)}
# SORT's detection counts whose benefit [D, 2D] no longer fits in the
# kernel's shared memory beside its state (the kernel reads it where it
# lies).
WIDE_D = (192, 256)


def benefit(rs, n, m, forbidden=0.3):
    """IoU-like payoffs in [0, 1), ``forbidden`` of them NEG, one row
    with no option at all where there are rows."""
    b = rs.rand(n, m).astype(np.float32)
    b[rs.rand(n, m) < forbidden] = thun.NEG
    if n > 1:
        b[n // 2] = thun.NEG
    return b


def jax_auction(b, eps, floor, max_iters=200_000):
    jnp = pytest.importorskip("jax.numpy")
    from tao_amodal_tpu.ops import hungarian as jhun

    return np.asarray(jhun.auction_assign(jnp.asarray(b), eps, floor,
                                          max_iters=max_iters))


def port_auction(b, eps, floor, max_iters=200_000):
    """The port's assignment and round count on a CPU tensor."""
    rounds = torch.full((1,), -1, dtype=torch.int32)
    got = thun.auction_assign(torch.from_numpy(b), eps, floor,
                              max_iters=max_iters, rounds=rounds)
    return got.numpy(), int(rounds)


def price_war(n=10, m=6):
    """Rows with nearly equal payoffs on few columns: hundreds of
    rounds at eps 5e-5 before the losers retire."""
    rs = np.random.RandomState(5)
    return (0.5 + 1e-3 * rs.rand(n, m)).astype(np.float32)


def sort_matches_jax(boxes, valid, K, max_age, min_hits, assignment):
    """``sort_step`` frame by frame against JAX's jitted one from fresh
    states of ``K`` slots: integers exact, the Kalman state within
    rtol 1e-4 + atol 1e-3.  Returns the port's final state."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from tao_amodal_tpu.trackers import sort as jsort

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
    return ts


def kernel_matches_plain(bt, eps, floor, caps):
    """The kernel against ``auction_assign_torch`` on the card tensor
    ``bt`` under each ``max_iters`` of ``caps``: ``row_to_col`` and the
    rounds bit-equal, one launch a call; then one kernel call with no
    host sync.  Returns the plain rounds of each cap."""
    got_r = torch.zeros(1, dtype=torch.int32, device=bt.device)
    want_r = torch.zeros(1, dtype=torch.int32, device=bt.device)
    ran = []
    for cap in caps:
        before = thun.auction_assign.launches
        got = thun.auction_assign(bt, eps, floor, max_iters=cap,
                                  rounds=got_r)
        want = thun.auction_assign_torch(bt, eps, floor, max_iters=cap,
                                         rounds=want_r)
        assert torch.equal(got, want), (tuple(bt.shape), cap)
        assert int(got_r) == int(want_r), (tuple(bt.shape), cap)
        assert thun.auction_assign.launches == before + 1
        ran.append(int(want_r))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        thun.auction_assign(bt, eps, floor, rounds=got_r)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return ran
