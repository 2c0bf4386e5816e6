"""Per-block timeline of the bf16 PrRoI kernel (``csrc/prroi.cu::
tao_prroi_bf16``, form 0) at the JAX bench's 384x512 serving shapes.

A copy of the committed source, with each block writing its start and
end (``%globaltimer``, ns) and its SM (``%smid``) to a device array, is
compiled by ``nvcc`` into ``build/prroi_timeline/`` and launched on
``chip_smoke.py``'s inputs (a seeded bf16 P3..P6 pyramid, C = 256, 96
RoIs a frame on the 48x98 canvas), then on the same RoIs shrunk to 1
pixel, which leaves each block its fixed work (the RoI's load, the
weights, one column sum, the barriers, the stores).

    python experiments/prroi_bf16_timeline.py

Prints the bytes of support pixels the kernel reads (each pixel once a
bin row whose support holds it) beside those of each pixel once a RoI
and once a frame; then, for both runs, the grid's span, the blocks'
durations (mean, deciles), their start times, and the RoIs whose blocks
took longest.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "prroi_timeline")
STAMP = """
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t_end;
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_end));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    const size_t b = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) *
                     gridDim.x + blockIdx.x;
    g_stamps[3 * b] = t_start;
    g_stamps[3 * b + 1] = t_end;
    g_stamps[3 * b + 2] = sm;
  }
}

template <int FORM>
cudaError_t launch_bf16("""


def instrumented(src):
    head = "  extern __shared__ float4 sm4[];\n"
    end = "\n}\n\ntemplate <int FORM>\ncudaError_t launch_bf16("
    if head not in src or end not in src:
        raise RuntimeError("csrc/prroi.cu's bf16 kernel no longer starts "
                           "or ends where the timeline stamps it")
    src = src.replace("namespace {", "__device__ unsigned long long "
                      "g_stamps[3 << 20];\nnamespace {", 1)
    src = src.replace(head, head + "  unsigned long long t_start;\n  asm "
                      "volatile(\"mov.u64 %0, %%globaltimer;\" : "
                      "\"=l\"(t_start));\n")
    src = src.replace(end, STAMP)
    return src + ("\nextern \"C\" int timeline_read(void* dst, int n) {\n"
                  "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, 8ull * "
                  "n);\n}\n")


def support_bytes(rois, Hc, Wc, S, C, esize=2):
    """Bytes of support pixels read (a) once a bin row whose y support
    holds them, over the row's columns, (b) once a RoI, (c) once a
    frame, for ``rois [T, R, 4]`` (numpy, map coordinates)."""
    r = rois.astype(np.float32)
    b = np.arange(S, dtype=np.float32)

    def axis(lo0, hi0, n):
        step = np.maximum((hi0 - lo0) / np.float32(S),
                          np.float32(1e-8)).astype(np.float32)
        lo = lo0[..., None] + b * step[..., None]
        return (np.clip(np.floor(lo), 0, n - 1).astype(np.int64),
                np.clip(np.ceil(lo + step[..., None]), 0, n - 1).astype(
                    np.int64))

    xs, xe = axis(r[..., 0], r[..., 2], Wc)
    ys, ye = axis(r[..., 1], r[..., 3], Hc)
    span = xe[..., -1] - xs[..., 0] + 1
    rows = int((span[..., None] * (ye - ys + 1)).sum())
    per_roi = int((span * (ye[..., -1] - ys[..., 0] + 1)).sum())
    mask = np.zeros((r.shape[0], Hc, Wc), bool)
    for t in range(r.shape[0]):
        for i in range(r.shape[1]):
            mask[t, ys[t, i, 0]:ye[t, i, -1] + 1,
                 xs[t, i, 0]:xe[t, i, -1] + 1] = True
    return [n * C * esize for n in (rows, per_roi, int(mask.sum()))]


def main():
    import torch

    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import chip_smoke as c
    from tao_amodal_torch.ops import roi

    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(REPO, "tao_amodal_torch", "csrc",
                           "prroi.cu")) as f:
        src = instrumented(f.read())
    cu, so = os.path.join(OUT, "timeline.cu"), os.path.join(OUT, "lib.so")
    with open(cu, "w") as f:
        f.write(src)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    lib.tao_prroi_bf16.argtypes = ([ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.timeline_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(21)
    pyramid = [torch.randn((c.T, h, w, 256), generator=g, device=dev).to(
        torch.bfloat16) for h, w in c.BF16_LEVELS]
    rois = c.serving_rois(torch, dev, 22, c.BF16_OUT)
    canvas, rp = roi.pack_levels(pyramid, rois, canonical_level=1,
                                 strides=c.LEVEL_STRIDES)
    canvas, rp = canvas.contiguous(), rp.contiguous()
    T, Hc, Wc, C = canvas.shape
    R, S = rp.shape[1], 7
    out = torch.empty((T, R, S, S, C), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    read = support_bytes(rp.cpu().numpy(), Hc, Wc, S, C)
    print("support bytes read, MB: once a bin row (the kernel) "
          f"{read[0] / 1e6:.1f}, once a RoI {read[1] / 1e6:.1f}, once a "
          f"frame {read[2] / 1e6:.1f}", flush=True)

    def timeline(boxes, label):
        for _ in range(3):  # the last launch's stamps are read
            err = lib.tao_prroi_bf16(
                canvas.data_ptr(), boxes.data_ptr(), out.data_ptr(), T, Hc,
                Wc, C, R, S, 0, stream)
            if err:
                raise RuntimeError(f"tao_prroi_bf16: CUDA error {err}")
        torch.cuda.synchronize()
        n = T * R * S  # grid (S, R, T) at C = 256
        stamps = np.zeros(3 * n, np.uint64)
        if lib.timeline_read(stamps.ctypes.data, 3 * n):
            raise RuntimeError("reading the block stamps failed")
        stamps = stamps.reshape(n, 3).astype(np.int64)
        start = stamps[:, 0] - stamps[:, 0].min()
        dur = (stamps[:, 1] - stamps[:, 0]) / 1e3
        span = (stamps[:, 1].max() - stamps[:, 0].min()) / 1e3
        deciles = np.round(np.percentile(dur, range(0, 101, 10)), 2)
        sms = len(set(stamps[:, 2]))
        print(f"{label}: grid span {span:.1f} us over {n} blocks on {sms} "
              f"SMs; block us mean {dur.mean():.2f}, deciles "
              f"{deciles.tolist()}; block starts us median "
              f"{np.median(start) / 1e3:.1f}, last {start.max() / 1e3:.1f}",
              flush=True)
        return dur.reshape(T * R, S).max(1)

    per_roi = timeline(rp, "serving RoIs")
    r = rp.reshape(-1, 4).cpu().numpy()
    worst = np.argsort(-per_roi)[:6]
    print("slowest RoIs (their longest block us, w x h canvas px): "
          + "; ".join(f"{per_roi[i]:.1f}, {r[i, 2] - r[i, 0]:.1f} x "
                      f"{r[i, 3] - r[i, 1]:.1f}" for i in worst))
    tiny = rp.clone()
    tiny[..., 2:] = tiny[..., :2] + 1.0
    timeline(tiny, "the same RoIs shrunk to 1 px")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
