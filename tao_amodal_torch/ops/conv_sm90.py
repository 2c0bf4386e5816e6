"""Plans and scratch of the Hopper convolutions in ``csrc/conv_sm90.cu``.

Two wrappers launch them: B4's bf16 chain
(:func:`~tao_amodal_torch.ops.fused_stage.fused_bottleneck_chain` on a
bf16 ``x``, ``tao_chain_bf16_sm90``) and the int8 trunk conv
(:mod:`~tao_amodal_torch.ops.int8_conv`, ``tao_conv_s8_sm90``).  Both run
one kernel template: an implicit GEMM on ``wgmma`` over 128-pixel output
tiles (two warpgroups of 64 rows), ``bn`` = 64 or 128 output channels a
tile, and K in slices of 128 bytes (64 bf16 or 128 int8 values, one
128-byte swizzle row), TMA-fed weights and an epilogue through shared
memory.  This module holds what the Python side decides for them: each
conv's plan (tile width and K split), the per-device buffer of split-K
tile counters, and the bf16 chain's rounding group.
"""

from __future__ import annotations

import torch

from tao_amodal_torch.ops import fused_stage

SLICE_BYTES = 128  # bytes of k a slice: one 128-byte swizzle row
# By operand itemsize (2 bf16, 1 int8), csrc/conv_sm90.cu's Shape: output
# pixels a tile (two consumer warpgroups of 64 for bf16, one for int8)
# and blocks an SM (bf16: 384 threads, an f32 sum and a k-group's
# products a thread, a 4-stage ring; int8: 256 threads in <= 128
# registers and a 3-stage ring, two blocks).
BM = {2: 128, 1: 64}
BLOCKS_PER_SM = {2: 1, 1: 2}
# A K range of a split keeps at least this many slices (2 KB of k a row,
# as B7/B8's MIN_SPLIT_SLICES of 64-byte slices).
MIN_SPLIT_SLICES = 16
# The bf16 form's rounding group: the k16-steps the tensor core chains
# from zero before the sum adds them with a round-to-nearest add (1, 2 or
# 4: 16, 32 or 64 of k).  64, one add a 128-byte slice: every depth held
# chip_smoke.py's bf16 rule at the four 384x512 stages, 64 the fastest
# (experiments/conv_sm90_profile.py; PERF.md).
BF16_KGROUP = 4


def conv_plan(P, Cin, Cout, ks, itemsize, sms=fused_stage.H100_SMS):
    """Tile width and K split of one conv with ``P`` output pixels and
    ``itemsize``-byte operands (2 bf16, 1 int8), in tiles of
    ``BM[itemsize]`` pixels.

    128-wide tiles, or 64-wide where ``Cout <= 64``.  Where the output
    tiles fill less than 90 % of the blocks the card holds at once
    (``BLOCKS_PER_SM * sms``), K is split in 2, 4, ... while each range
    keeps at least ``MIN_SPLIT_SLICES`` 128-byte slices.
    """
    bn = 64 if Cout <= 64 else 128
    slots = BLOCKS_PER_SM[itemsize] * sms
    bk = SLICE_BYTES // itemsize
    nk = -(-ks * ks * Cin // bk)
    splits = 1
    while (10 * tiles(P, Cout, bn, itemsize) * splits < 9 * slots
           and nk >= 2 * splits * MIN_SPLIT_SLICES):
        splits *= 2
    return fused_stage.make_plan(P, Cin, Cout, ks, bn, splits, bk)


def tiles(P, Cout, bn, itemsize):
    """Output tiles of a conv: one split-K counter each."""
    return -(-P // BM[itemsize]) * -(-Cout // bn)


_COUNTERS = {}


def counters(device, n):
    """A zeroed int32 buffer of at least ``n`` split-K tile counters on
    ``device``, one per device: every kernel leaves the counters it used
    at zero, so no conv zeroes them first, and a CUDA graph's replay
    leaves them at zero as the eager launches do.  Convs on one device
    run in stream order, never two at once on it (the port launches on
    the current stream, and a graph replays on it)."""
    key = (device.type, device.index)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        # A buffer made during a CUDA graph's capture would live in the
        # graph's pool and be zeroed only when the graph replays; the
        # capture's warm-up (utils/graphs.py) sizes it first.
        if (device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("conv_sm90.counters: the split-K counters "
                               "must be sized before a CUDA graph capture "
                               "(warm the function up first)")
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf
