"""Where the time of the Hopper convolutions (``csrc/conv_sm90.cu``)
goes, on one CUDA card: B4's bf16 chains at the 384x512 trunk's four
stages (T=8) and the int8 trunk conv at five of ResNet-50's shapes
(512^2, T=8).

    python experiments/conv_sm90_profile.py

It builds the kernel library once more with ``-DTAO_PROFILE``: each
block's producer and consumer lead threads add ``clock64`` cycles to
device counters (the producer waiting for a free stage and issuing a
slice's loads; the consumers waiting for a full stage and in wgmma; an
item's epilogue), and prints them per slice and per work item.  Then,
for the bf16 chains, each rounding-group depth (16, 32, 64 of k:
``conv_sm90.BF16_KGROUP`` 1, 2, 4) held to ``chip_smoke.py``'s rule
(``bf16_close``, with the plain version's spread on the CPU) beside the
chains' device time (``torch.profiler``).  Seeded inputs as
``chip_smoke.py`` makes them; the card's name and power limit last.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from tao_amodal_torch import _build  # noqa: E402
from tao_amodal_torch.ops import conv_sm90, fused_stage  # noqa: E402
from tao_amodal_torch.ops import int8_conv as q  # noqa: E402
from torch_port_fixtures import chain_inputs  # noqa: E402

STAGES = (((8, 96, 128, 64), 64, 3, True), ((8, 48, 64, 512), 128, 3, False),
          ((8, 24, 32, 1024), 256, 5, False),
          ((8, 12, 16, 2048), 512, 2, False))
INT8 = ((8, 128, 128, 64, 64, 3, 1), (8, 64, 64, 128, 128, 3, 1),
        (8, 32, 32, 256, 256, 3, 1), (8, 128, 128, 256, 64, 1, 1),
        (8, 512, 512, 3, 64, 7, 2))


def build_profiled():
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DTAO_PROFILE",)
    lib = _build.library()
    lib.tao_prof_read.argtypes = [ctypes.c_void_p]
    return lib


def profile(lib, fn, label):
    buf = (ctypes.c_ulonglong * 8)()
    fn()
    torch.cuda.synchronize()
    lib.tao_prof_read(ctypes.addressof(buf))  # and reset
    fn()
    torch.cuda.synchronize()
    lib.tao_prof_read(ctypes.addressof(buf))
    v = list(buf)
    sl, it = max(v[5], 1), max(v[6], 1)
    print(f"{label}: {v[5]} slices, {v[6]} items; cycles a slice: producer "
          f"waits {v[0] / sl:.0f}, issues {v[1] / sl:.0f}; consumers wait "
          f"{v[2] / sl:.0f}, wgmma {v[3] / sl:.0f}; cycles an item: the "
          f"consumers' epilogue {v[4] / it:.0f}, the producer's row setup "
          f"{v[7] / it:.0f}", flush=True)


def device_ms(fn, reps=5):
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in p.key_averages()
               if "conv_wgmma_kernel" in e.key) / 1e3 / reps


def bf16_rule(got, want, other):
    """chip_smoke.py's bf16_close: max |d| <= 1e-2 max|ref|, mean |d| <=
    1e-3 mean|ref|, or twice the plain version's CPU spread."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    s = (other.to(want.device).float() - want).abs()
    max_b = max(1e-2 * float(want.abs().max()), 2 * float(s.max()))
    mean_b = max(1e-3 * float(want.abs().mean()), 2 * float(s.mean()))
    ref = float(want.abs().mean())
    return (float(d.max()) <= max_b and float(d.mean()) <= mean_b,
            f"mean|d| {float(d.mean()) / ref:.3e} of mean|ref| (bound "
            f"{mean_b / ref:.3e}), max|d| {float(d.max()):.3e} (bound "
            f"{max_b:.3e})")


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = build_profiled()
    fn = fused_stage.fused_bottleneck_chain
    kgroup = conv_sm90.BF16_KGROUP
    with torch.no_grad():
        for i, (shape, M, blocks, proj) in enumerate(STAGES):
            x, params = chain_inputs(dev, shape, M, blocks, proj, seed=30 + i)
            x = x.to(torch.bfloat16)
            profile(lib, lambda: fn(x, params), f"bf16 stage {i + 1}")
            want = fused_stage.bottleneck_chain_torch(x, params)
            other = fused_stage.bottleneck_chain_torch(
                x.cpu(), [{k: v.cpu() for k, v in p.items()}
                          for p in params])
            for kg in (1, 2, 4):
                conv_sm90.BF16_KGROUP = kg
                ok, note = bf16_rule(fn(x, params), want, other)
                print(f"  rounding groups of {16 * kg} of k: "
                      f"{'within' if ok else 'OUTSIDE'} the rule, {note}; "
                      f"device {device_ms(lambda: fn(x, params)):.4f} ms",
                      flush=True)
            conv_sm90.BF16_KGROUP = kgroup
    rs = np.random.RandomState(0)
    for T, H, W, cin, cout, ks, stride in INT8:
        x8 = torch.from_numpy(rs.randint(-127, 128, (T, H, W, cin)).astype(
            np.int8)).to(dev)
        w8 = torch.from_numpy(rs.randint(-127, 128, (ks, ks, cin, cout))
                              .astype(np.int8)).to(dev)
        sc = torch.from_numpy(rs.uniform(1e-6, 1e-4, cout).astype(
            np.float32)).to(dev)
        profile(lib, lambda: q.int8_conv(x8, w8, sc, stride, (ks - 1) // 2),
                f"int8 {T}x{H}x{W} {cin}->{cout} k{ks}/{stride}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
