"""Per-conv device times of kernels B7 and B8 (the int8 and bf16
identity-bottleneck stacks of ``tao_amodal_torch/ops/resnet_blocks.py``)
at ResNet-50's four stages (512^2, T=8) on one CUDA card.

    python experiments/identity_stack_profile.py            # default plans
    python experiments/identity_stack_profile.py --plans    # and forced ones

For each kind, stage and conv (1x1 C->M, 3x3 M->M, 1x1 M->C with the
residual) it prints the kernel's mean device time over the stack's blocks
(``torch.profiler``, one traced call after a warm-up), its TOP/s and its
GB/s (input, residual and weights read once, output written once), under
the plan ``ops/resnet_blocks.py::conv_plan`` picks (tile width, K
splits).  With ``--plans`` it repeats the stack under every forced plan
(tile width 64 or 128, 1, 2 or 4 splits) and prints each conv's time
under each.  Then the time of the other kernels of a call (B7's weight
re-layout, the split counters' fill) and the card's name and power
limit.  Also the host time to enqueue one call (host clock over a few
back-to-back calls, before synchronizing).  Seeded random stacks as
``chip_smoke.py`` makes them.
"""

import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from tao_amodal_torch.ops import fused_stage  # noqa: E402
from tao_amodal_torch.ops import resnet_blocks as rb  # noqa: E402
from torch_port_fixtures import stack_arrays, torch_stack  # noqa: E402

STACKS = (((8, 128, 128, 256), 64, 2), ((8, 64, 64, 512), 128, 3),
          ((8, 32, 32, 1024), 256, 5), ((8, 16, 16, 2048), 512, 2))
ROLES = ("1x1 C->M", "3x3 M->M", "1x1 M->C +res")
HOST_REPS = 10


def trace(fn, x, p):
    """Device time (us) of each kernel of one ``fn(x, p)`` call, in
    launch order: ``[(name, us)]``."""
    from torch.profiler import ProfilerActivity, profile

    fn(x, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(x, p)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in kernels]


def per_conv(events, blocks):
    """Mean time (us) of each conv role over the blocks, and the other
    kernels: ``{short name: us}``."""
    convs = [us for name, us in events if "conv_q_mma_kernel" in name]
    other = {}
    for name, us in events:
        if "conv_q_mma_kernel" not in name:
            key = name.replace("(anonymous namespace)::", "")
            key = key.split("(")[0].split("<")[0][-40:]
            other[key] = other.get(key, 0.0) + us
    if len(convs) != 3 * blocks:
        return None, other
    return [sum(convs[r::3]) / blocks for r in range(3)], other


def work(shape, M, kind):
    """(operations, bytes) of each conv role of one block."""
    T, H, W, C = shape
    P, size = T * H * W, 1 if kind == "int8" else 2
    out = []
    for cin, cout, ks, res in ((C, M, 1, 0), (M, M, 3, 0), (M, C, 1, 1)):
        out.append((2 * P * cin * cout * ks * ks,
                    size * (P * (cin + cout * (1 + res))
                            + ks * ks * cin * cout)))
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    forced = "--plans" in sys.argv
    plans = [(bn, s) for bn in (64, 128) for s in (1, 2, 4)] if forced else []
    default_plan = rb.conv_plan
    for kind, fn in (("int8", rb.identity_blocks_pallas),
                     ("bf16", rb.identity_blocks_bf16_pallas)):
        for i, (shape, M, blocks) in enumerate(STACKS):
            x, p = torch_stack(dev, *stack_arrays(shape, M, blocks, kind,
                                                  seed=20 + i), kind)
            P, C = shape[0] * shape[1] * shape[2], shape[-1]
            size = x.element_size()
            chosen = [default_plan(P, cin, cout, ks, size)[:2]
                      for cin, cout, ks in ((C, M, 1), (M, M, 3), (M, C, 1))]
            times, other = per_conv(trace(fn, x, p), blocks)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_REPS):
                fn(x, p)
            host_us = (time.perf_counter() - t0) * 1e6 / HOST_REPS
            torch.cuda.synchronize()
            if times is None:
                print(f"{kind} stage {i + 1}: not measured, the trace lost "
                      f"kernels", flush=True)
            for role, (ops, nbytes), plan, us in zip(
                    ROLES, work(shape, M, kind), chosen, times or []):
                print(f"{kind} stage {i + 1} {role}: {us:.1f} us, "
                      f"{ops / us / 1e6:.1f} TOP/s, {nbytes / us / 1e3:.0f} "
                      f"GB/s, plan (tile width, splits) {plan}", flush=True)
            other = ", ".join(f"{k} {us:.1f} us" for k, us in other.items())
            print(f"{kind} stage {i + 1} other kernels: {other or 'none'}; "
                  f"host time to enqueue one call: {host_us:.1f} us",
                  flush=True)
            for bn, splits in plans:
                def plan(P, cin, cout, ks, itemsize, sms=None):
                    return fused_stage.make_plan(
                        P, cin, cout, ks, bn, splits,
                        rb.SLICE_BYTES // itemsize)

                rb.conv_plan = plan
                try:
                    times, _ = per_conv(trace(fn, x, p), blocks)
                finally:
                    rb.conv_plan = default_plan
                print(f"{kind} stage {i + 1} forced ({bn}, {splits}): "
                      + (", ".join(f"{role} {us:.1f} us" for role, us in
                                   zip(ROLES, times)) if times else
                         "not measured, the trace lost kernels"), flush=True)
            del x, p
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
