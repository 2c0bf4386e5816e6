"""Variants of the bf16 PrRoI kernel (``csrc/prroi.cu::tao_prroi_bf16``)
timed on one card at the JAX bench's 384x512 serving shapes.

Each variant is the committed source with one of its constants changed
(``CHUNK``, the columns of a bin row's y-sums a block keeps at once;
``BATCH``, the pixel loads a lane keeps in flight), the blocks an SM
that its launch bounds size the registers for (``blocks``), or its pixel
loads made with another cache hint (``__ldcg``: L2 only;
``no_allocate``: the L1 gets no line), compiled by ``nvcc`` into its own
library under ``build/prroi_variants/``; its registers and spilled
bytes by form (ptxas) are printed first.  The inputs are
``chip_smoke.py``'s: a seeded bf16 P3..P6 pyramid (C = 256), 96 RoIs a
frame, B2's form 0 on the 48x98 canvas and B5's form 1 on it padded to
112 columns.  The first variant is the source as committed.

    python experiments/prroi_bf16_variants.py

Prints, per variant and twice in turn, each form's device ms per call
(``torch.profiler``, mean of 20 calls) and whether its output equals the
first variant's bit for bit; then the card's name and power limit.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "prroi_variants")
NO_ALLOCATE = """
__device__ __forceinline__ uint4 no_allocate(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
"""
VARIANTS = (dict(CHUNK=32, BATCH=2), dict(CHUNK=32, BATCH=3),
            dict(CHUNK=32, BATCH=4), dict(CHUNK=32, BATCH=8),
            dict(CHUNK=16, BATCH=2), dict(CHUNK=8, BATCH=2),
            dict(CHUNK=64, BATCH=2), dict(CHUNK=32, BATCH=2, blocks=3),
            dict(CHUNK=32, BATCH=2, blocks=1),
            dict(CHUNK=32, BATCH=2, load="__ldcg"),
            dict(CHUNK=32, BATCH=2, load="no_allocate"))


def variant_source(base, v):
    src = base
    if "blocks" in v:  # blocks an SM that ptxas sizes the registers for
        bounds = next(ln for ln in src.splitlines()
                      if ln.startswith("__global__ void __launch_bounds__("
                                       "BF16_WARPS"))
        src = src.replace(bounds, "__global__ void __launch_bounds__("
                          f"BF16_WARPS * 32, {v['blocks']})")
    for name in ("CHUNK", "BATCH"):
        line = next(ln for ln in src.splitlines()
                    if ln.startswith(f"constexpr int {name} = "))
        src = src.replace(line, f"constexpr int {name} = {v[name]};")
    if "load" in v:
        if "u[k] = __ldg(col" not in src:
            raise RuntimeError("csrc/prroi.cu no longer loads pixels "
                               "with u[k] = __ldg(col ...)")
        src = src.replace("u[k] = __ldg(col", f"u[k] = {v['load']}(col")
        if v["load"] == "no_allocate":
            src = src.replace("namespace {", "namespace {" + NO_ALLOCATE, 1)
    return src


def build(base):
    """Compile every variant in parallel; returns their libraries."""
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for i, v in enumerate(VARIANTS):
        src = os.path.join(OUT, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(variant_source(base, v))
        cmd = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc"),
               "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o",
               os.path.join(OUT, f"v{i}.so"), src]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    libs = []
    sys.path[:0] = [REPO]
    from tao_amodal_torch._build import parse_ptxas

    for i, p in enumerate(procs):
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"variant {VARIANTS[i]} failed to build:\n{log}")
        regs = {re.search(r"ILi(\d)E", k).group(1): (
                    r["registers"], r["spill_stores"] + r["spill_loads"])
                for k, r in parse_ptxas(log).items() if "prroi_bf16" in k}
        print(json.dumps(dict(variant=VARIANTS[i],
                              form_registers_spill_bytes=regs)), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"v{i}.so"))
        lib.tao_prroi_bf16.argtypes = ([ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
        libs.append(lib)
    return libs


def device_ms(torch, fn, reps=20):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_time_total > 0]
        if ev:
            return sum(e.device_time_total for e in ev) / 1e3 / reps
    return None


def main():
    import torch

    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import chip_smoke as c
    from tao_amodal_torch.ops import roi

    with open(os.path.join(REPO, "tao_amodal_torch", "csrc",
                           "prroi.cu")) as f:
        libs = build(f.read())
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(21)
    pyramid = [torch.randn((c.T, h, w, 256), generator=g, device=dev).to(
        torch.bfloat16) for h, w in c.BF16_LEVELS]
    rois = c.serving_rois(torch, dev, 22, c.BF16_OUT)
    cases = []
    for form, width in ((0, 1), (1, 16)):
        canvas, rp = roi.pack_levels(pyramid, rois, canonical_level=1,
                                     strides=c.LEVEL_STRIDES,
                                     width_multiple=width)
        cases.append((form, canvas.contiguous(), rp.contiguous()))
    stream = torch.cuda.current_stream().cuda_stream
    first = {}
    for _ in range(2):
        for v, lib in zip(VARIANTS, libs):
            res = {}
            for form, canvas, rp in cases:
                T, Hc, Wc, C = canvas.shape
                R = rp.shape[1]
                out = torch.empty((T, R, 7, 7, C), dtype=torch.bfloat16,
                                  device=dev)

                def call():
                    err = lib.tao_prroi_bf16(
                        canvas.data_ptr(), rp.data_ptr(), out.data_ptr(), T,
                        Hc, Wc, C, R, 7, form, stream)
                    if err:
                        raise RuntimeError(f"tao_prroi_bf16: CUDA error "
                                           f"{err}")

                call()
                torch.cuda.synchronize()
                same = torch.equal(out, first.setdefault(form, out.clone()))
                res[f"form {form}"] = dict(ms=device_ms(torch, call),
                                           equal=same)
            print(json.dumps(dict(variant=v, **res)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
