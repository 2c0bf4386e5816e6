"""Fused stride-1 bottleneck chain, BatchNorm folded: kernel B4 and its
plain version.

Port of :mod:`tao_amodal_tpu.ops.pallas.fused_stage` (``fold_convbn``,
``bottleneck_chain_reference``, ``fused_bottleneck_chain``).  Weights
are PyTorch's OIHW (``Conv2d.weight``), folded in f32; activations are
NHWC ``[T, H, W, C]`` f32 or bf16, as in the JAX package.  In bf16 the
chain computes what ``bottleneck_chain_reference`` computes on a bf16
``x`` (``_block_param_arrays``' operands): the folded weights round to
bf16 once and the biases stay f32, each conv sums in f32 on bf16
operands, ``a`` and ``h`` round to bf16, the residual (the bf16 input,
or the f32 projection) adds in f32, and the block output rounds to bf16.
The unfused bf16 trunk rounds elsewhere (after each conv and each BN),
so the two are different functions, in JAX too.

Kernel: ``csrc/fused_stage.cu`` replaces the TPU kernel
``fused_bottleneck_chain`` (``_chain_kernel``).  The TPU kernel keeps a
row tile of the whole chain in VMEM and falls back to the XLA chain when
no row tile fits its 16 MB scoped-VMEM budget (``_chain_tile_rows``).
Neither carries over: the CUDA kernel is an implicit-GEMM convolution
with a fused bias / residual / ReLU epilogue, launched once per conv of
the chain, and a fused stage on the card launches it or raises.  True
f32 (FMAs on the CUDA cores, no TF32).  Forward only: the port serves,
it does not train.  :func:`conv_plan` picks each conv's tile width and
K split from its shape.

The bf16 form runs on ``csrc/resnet_blocks.cu``'s bf16 tensor-core conv
(kernel B8's ``mma.sync`` implicit GEMM), one library call per chain
(``tao_chain_bf16``, which launches every conv of the chain), on
weights rounded and laid out once per set of folded params
(:func:`_bf16_operands`).
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tao_amodal_torch import _build

# csrc/fused_stage.cu: tile height, slice depth, and the 256-thread
# blocks that share one SM (<= 128 registers each).
BM, BK, BLOCKS_PER_SM = 128, 32, 2
# A K range of a split is at least this many slices: its 3-stage copy
# ring needs a few slices to fill.
MIN_SLICES = 8
H100_SMS = 132


class ConvPlan(NamedTuple):
    """How one conv runs: tile width ``bn`` (128: 8x8 per thread, 64:
    8x4), ``splits`` contiguous ranges of ``slices`` BK-deep K slices
    (the last may be shorter, none is empty), and the f32 ``workspace``
    elements of the partial sums ``[splits, P, Cout]`` (0 unsplit)."""

    bn: int
    splits: int
    slices: int
    workspace: int


def make_plan(P, Cin, Cout, ks, bn, splits, bk=BK):
    """The plan of tile width ``bn`` and at most ``splits`` K ranges of
    ``bk``-deep slices (fewer where K has too few slices for that
    many)."""
    nk = -(-ks * ks * Cin // bk)
    slices = -(-nk // max(1, min(splits, nk)))
    splits = -(-nk // slices)
    return ConvPlan(bn, splits, slices, splits * P * Cout if splits > 1
                    else 0)


def conv_plan(P, Cin, Cout, ks, sms=H100_SMS, bk=BK, min_slices=MIN_SLICES):
    """Tile and K split of a conv with ``P`` output pixels and K in
    ``bk``-deep slices (B4's ``BK``; B7 and B8 pass theirs, with the same
    128-pixel tiles and two blocks an SM).

    128-wide tiles, or 64-wide where ``Cout <= 64``.  Where the output
    tiles fill less than 90 % of the blocks the card holds at once
    (``BLOCKS_PER_SM * sms``), K is split in 2, 4, ... while each range
    keeps at least ``min_slices`` slices.  At ResNet-50's 512^2, T=8
    shapes and B4's slices that splits stage 3's 1x1a and 3x3 in 2,
    stage 4's in 4.
    """
    bn = 64 if Cout <= 64 else 128
    tiles = -(-P // BM) * -(-Cout // bn)
    nk = -(-ks * ks * Cin // bk)
    splits = 1
    while (10 * tiles * splits < 9 * BLOCKS_PER_SM * sms
           and nk >= 2 * splits * min_slices):
        splits *= 2
    return make_plan(P, Cin, Cout, ks, bn, splits, bk)


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def fold_convbn(kernel, scale, bias, mean, var, eps=1e-5):
    """Fold inference BatchNorm into the preceding conv.

    ``kernel`` is the OIHW ``Conv2d.weight``; ``scale``/``bias``/
    ``mean``/``var`` are the ``BatchNorm2d`` weight, bias and running
    statistics.  Returns ``(folded_kernel OIHW, folded_bias [Cout])``,
    f32: ``s = scale / sqrt(var + eps)``, ``kernel * s``,
    ``bias - mean * s``.
    """
    s = (scale / torch.sqrt(var + eps)).to(torch.float32)
    w = kernel.to(torch.float32) * s.reshape(-1, 1, 1, 1)
    b = bias.to(torch.float32) - mean.to(torch.float32) * s
    return w, b


def _conv(x, w, b):
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def _conv_rounded(x, w, b, dtype):
    """f32 conv of the ``dtype``-rounded operands, plus the f32 bias."""
    f32 = torch.float32
    return (F.conv2d(x.to(f32), w.to(dtype).to(f32),
                     padding=w.shape[-1] // 2)
            + b.to(f32)[:, None, None])


def bottleneck_chain_torch(x, params):
    """Plain version: ``x [T, H, W, Cin]`` NHWC f32 or bf16 through the
    chain (bf16: at the rounding points of the module docstring; keep
    TF32 off on the card).

    ``params`` is a list of folded block dicts ``wa [M, Cin, 1, 1]``,
    ``ba``, ``w3 [M, M, 3, 3]``, ``b3``, ``wb [4M, M, 1, 1]``, ``bb``,
    and optionally the projection ``wd [4M, Cin, 1, 1]``, ``bd``.  Each
    block: ``relu(relu(3x3(relu(1x1(x) + ba)) + b3) @ wb + bb + res)``
    with ``res`` the projection where the block has one, else ``x``.
    Returns ``[T, H, W, 4M]`` in the dtype of ``x``.
    """
    cur = x.permute(0, 3, 1, 2)
    if x.dtype != torch.float32:
        dt = x.dtype
        for p in params:
            a = F.relu(_conv_rounded(cur, p["wa"], p["ba"], dt)).to(dt)
            h = F.relu(_conv_rounded(a, p["w3"], p["b3"], dt)).to(dt)
            res = (_conv_rounded(cur, p["wd"], p["bd"], dt) if "wd" in p
                   else cur.to(torch.float32))
            cur = F.relu(_conv_rounded(h, p["wb"], p["bb"], dt)
                         + res).to(dt)
        return cur.permute(0, 2, 3, 1)
    for p in params:
        a = F.relu(_conv(cur, p["wa"], p["ba"]))
        h = F.relu(_conv(a, p["w3"], p["b3"]))
        res = _conv(cur, p["wd"], p["bd"]) if "wd" in p else cur
        cur = F.relu(_conv(h, p["wb"], p["bb"]) + res)
    return cur.permute(0, 2, 3, 1)


def _gemm_weight(w):
    """OIHW -> ``[kh*kw*Cin, Cout]`` (HWIO flattened), the kernel's B."""
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bf16_operands(params):
    """The bf16 chain's operands for folded ``params``, made once per
    set of folded tensors (the trunk folds once per load): per block the
    four ``[K, Cout]`` bf16 weights (the projection's or None) and f32
    biases, and a ones vector of 4M (the conv's scale).  They are kept on
    the first folded tensor, with the ids of all of them."""
    key = tuple(id(t) for p in params for t in p.values())
    hit = getattr(params[0]["wa"], "_bf16_operands", None)
    if hit is None or hit[0] != key:
        blocks = []
        for p in params:
            blocks.append([
                (_aligned(_gemm_weight(p[w]).to(torch.bfloat16)),
                 _aligned(p["b" + w[1:]].to(torch.float32)))
                if w in p else (None, None)
                for w in ("wa", "w3", "wb", "wd")])
        M = params[0]["w3"].shape[0]
        ones = torch.ones(4 * M, dtype=torch.float32,
                          device=params[0]["wa"].device)
        hit = (key, (blocks, ones))
        params[0]["wa"]._bf16_operands = hit
    return hit[1]


def _chain_bf16(x, params):
    """One ``tao_chain_bf16`` call for a bf16 CUDA ``x`` (checked by the
    caller): every conv of the chain on B8's bf16 conv, planned by
    ``ops/resnet_blocks.py::conv_plan``."""
    from tao_amodal_torch.ops import resnet_blocks

    T, H, W, Cin = x.shape
    M = params[0]["w3"].shape[0]
    P, dev = T * H * W, x.device
    for i, p in enumerate(params):
        cin = Cin if i == 0 else 4 * M
        shapes = dict(wa=(M, cin, 1), w3=(M, M, 3), wb=(4 * M, M, 1),
                      wd=(4 * M, cin, 1))
        for w, (cout, c, k) in shapes.items():
            if w not in p:
                if w != "wd":
                    raise ValueError(f"fused_bottleneck_chain: block {i} "
                                     f"has no {w}")
                continue
            if (tuple(p[w].shape) != (cout, c, k, k)
                    or p[w].device != dev
                    or tuple(p["b" + w[1:]].shape) != (cout,)):
                raise ValueError(
                    f"fused_bottleneck_chain: block {i} {w} is "
                    f"{tuple(p[w].shape)} on {p[w].device}, want "
                    f"{(cout, c, k, k)} on {dev}")
        if "wd" not in p and cin != 4 * M:
            raise ValueError(f"fused_bottleneck_chain: block {i} maps {cin}"
                             f" to {4 * M} channels without a projection")
    if Cin % 8 or M % 8:
        raise ValueError(f"fused_bottleneck_chain: bf16 wants Cin and M "
                         f"multiples of 8, got Cin={Cin}, M={M}")
    blocks, ones = _bf16_operands(params)
    sms = _sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    plans, work, tiles = [], 0, 0
    for i, p in enumerate(params):
        cin = Cin if i == 0 else 4 * M
        for j, (c, cout, ks) in enumerate(((cin, M, 1), (M, M, 3),
                                           (M, 4 * M, 1), (cin, 4 * M, 1))):
            pl = resnet_blocks.conv_plan(P, c, cout, ks, 2, sms)
            plans += pl[:3]
            if pl.splits > 1 and (j < 3 or "wd" in p):
                work = max(work, pl.workspace)
                tiles = max(tiles, -(-P // BM) * -(-cout // 64))
    bf16, f32 = torch.bfloat16, torch.float32
    a = torch.empty((P, M), dtype=bf16, device=dev)
    h = torch.empty((P, M), dtype=bf16, device=dev)
    res = (torch.empty((P, 4 * M), dtype=f32, device=dev)
           if "wd" in params[0] else None)
    out = torch.empty((T, H, W, 4 * M), dtype=bf16, device=dev)
    mid = (torch.empty((P, 4 * M), dtype=bf16, device=dev)
           if len(params) > 1 else None)
    outs = [mid, mid]
    outs[(len(params) - 1) % 2] = out
    ws = torch.empty(work, dtype=f32, device=dev) if work else None
    counters = (torch.empty(tiles, dtype=torch.int32, device=dev)
                if tiles else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    w_ptrs = (ctypes.c_void_p * (4 * len(blocks)))(
        *(ptr(w) for blk in blocks for w, _ in blk))
    b_ptrs = (ctypes.c_void_p * (4 * len(blocks)))(
        *(ptr(b) for blk in blocks for _, b in blk))
    plan_ints = (ctypes.c_int * len(plans))(*plans)
    x = _aligned(x)
    err = _build.library().tao_chain_bf16(
        x.data_ptr(), ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
        ones.data_ptr(), a.data_ptr(), h.data_ptr(), ptr(res),
        ptr(outs[0]), ptr(outs[1]), ptr(ws), ptr(counters),
        ctypes.addressof(plan_ints), len(params), T, H, W, Cin, M, tiles,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("tao_chain_bf16", err)
    return out


def fused_bottleneck_chain(x, params):
    """Kernel wrapper (same contract as :func:`bottleneck_chain_torch`).

    A CPU ``x`` takes the plain version; a CUDA ``x`` launches the
    kernel (or this raises).  f32: one call launches the f32 kernel once
    per conv of the chain (twice where :func:`conv_plan` splits K: the
    partial sums, then their epilogue) and counts one launch in
    ``launches``.  bf16: one library call launches the bf16 conv once
    per conv of the chain and counts one launch in ``bf16.launches``.  A
    contiguous NHWC ``x`` (the NHWC view of a channels-last NCHW tensor)
    is read in place.
    """
    if x.device.type == "cpu":
        return bottleneck_chain_torch(x, params)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck_chain: unsupported device "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(f"fused_bottleneck_chain: want f32 or bf16 "
                         f"[T, H, W, C], got {x.dtype} {tuple(x.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            v.requires_grad for p in params for v in p.values())):
        raise ValueError("fused_bottleneck_chain: the kernel is forward "
                         "only; run it under torch.no_grad()")
    T, H, W, _ = x.shape
    if max(H, W) >= 1 << 15:  # the kernel packs (y, x) in 16 bits each
        raise ValueError(f"fused_bottleneck_chain: frames up to 32767 "
                         f"pixels a side, got {H}x{W}")
    if x.dtype == torch.bfloat16:
        out = _chain_bf16(x, params)
        fused_bottleneck_chain.bf16.launches += 1
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = _sm_count(x.device.index if x.device.index is not None
                    else torch.cuda.current_device())
    lib = _build.library()

    def conv(inp, w, b, res=None, relu=True):
        Cout, Cin, k = w.shape[0], w.shape[1], w.shape[-1]
        if (inp.shape[-1] != Cin or Cin % 8 or Cout % 4 or k not in (1, 3)
                or w.device != x.device or b.shape != (Cout,)
                or (res is not None and res.shape[-1] != Cout)):
            raise ValueError(f"fused_bottleneck_chain: conv {tuple(w.shape)}"
                             f" on {inp.shape[-1]} channels unsupported "
                             f"(want Cin % 8 == 0, Cout % 4 == 0, 1x1 or "
                             f"3x3, on {x.device})")
        p = conv_plan(T * H * W, Cin, Cout, k, sms)
        out = torch.empty((T, H, W, Cout), dtype=torch.float32,
                          device=x.device)
        ws = (torch.empty(p.workspace, dtype=torch.float32, device=x.device)
              if p.splits > 1 else None)
        gw = _gemm_weight(w.to(torch.float32))
        gb = _aligned(b.to(torch.float32))
        err = lib.tao_conv_nhwc_f32(
            inp.data_ptr(), gw.data_ptr(), gb.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), T, H, W, Cin, Cout, k,
            int(relu), p.bn, p.splits, p.slices, stream)
        _build.check("tao_conv_nhwc_f32", err)
        return out

    cur = _aligned(x)
    for p in params:
        a = conv(cur, p["wa"], p["ba"])
        h = conv(a, p["w3"], p["b3"])
        res = (conv(cur, p["wd"], p["bd"], relu=False) if "wd" in p
               else cur)
        cur = conv(h, p["wb"], p["bb"], res=res)
    fused_bottleneck_chain.launches += 1
    return cur


fused_bottleneck_chain.launches = 0
fused_bottleneck_chain.bf16 = types.SimpleNamespace(launches=0)
