// Precise RoI pooling over a packed multilevel canvas or one level.
//
// canvas f32 [T, Hc, Wc, C] (h-major, channels last), rois f32 [T, R, 4]
// xyxy in canvas coordinates -> out f32 [T, R, S, S, C].  Each output
// bin is the exact integral of the bilinearly interpolated feature
// surface over the bin, divided by the bin area; the integral factors
// into per-axis hat-antiderivative weights (ops/roi.py).
//
// Replaces three TPU kernels of tao_amodal_tpu/ops/pallas/prroi.py,
// which pool the same function on their own layouts; one entry point of
// ops/prroi.py answers for each:
//   prroi_packed_fused  (_fused_kernel, B2, the serving path, w-major
//                        packed canvas)       -> prroi.prroi_packed;
//   prroi_packed_pallas (_packed_kernel, B5, h-major packed canvas, width
//                        padded to 16)        -> prroi.prroi_packed_pallas;
//   prroi_pool_pallas   (_kernel, B6, one pyramid level, RoIs scaled by
//                        1/stride)            -> prroi.prroi_pool_pallas.
// Each map here is h-major [T, H, W, C]; B5's zero padding columns and
// B6's per-level edges need nothing of their own, since the support is
// clamped to the map (pixels outside it add zeros in the integral).
// The TPU kernels keep the whole map in VMEM and run dense contractions
// against it; the H100's 227 KB of shared memory per block cannot hold
// a 6.4 MB canvas, and the dense form spends its work on weights that
// are zero outside a bin's +-1 pixel support.
//
// Here the op is bound by canvas reads (mostly from L2: one frame's
// canvas is 6.4 MB at 512^2).  One block per (frame, roi, bin); its
// threads run over the channels, so each support pixel is one coalesced
// C-wide read, and each thread loops over the <= (ceil(bin)+2)^2
// support pixels, computing the separable weights in registers.  The
// weight arithmetic uses round-to-nearest intrinsics that are never
// fused into FMAs, so the weights equal the plain PyTorch version's
// bit for bit and only the summation order differs.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float hat_antideriv(float u) {
  u = fminf(fmaxf(u, -1.0f), 1.0f);
  if (u <= 0.0f) {
    const float v = __fadd_rn(u, 1.0f);
    return __fmul_rn(0.5f, __fmul_rn(v, v));
  }
  return __fsub_rn(__fadd_rn(0.5f, u), __fmul_rn(0.5f, __fmul_rn(u, u)));
}

__device__ __forceinline__ float hat_weight(float lo, float hi, int i) {
  const float fi = (float)i;
  return __fsub_rn(hat_antideriv(__fsub_rn(hi, fi)),
                   hat_antideriv(__fsub_rn(lo, fi)));
}

// First and last pixel whose hat (support (i-1, i+1)) overlaps
// [lo, hi], clamped to the canvas; clamped in float so that a wild
// coordinate never overflows the int conversion.
__device__ __forceinline__ void support(float lo, float hi, int n,
                                        int* first, int* last) {
  const float top = (float)(n - 1);
  *first = (int)fminf(fmaxf(floorf(lo), 0.0f), top);
  *last = (int)fminf(fmaxf(ceilf(hi), 0.0f), top);
}

__global__ void prroi_kernel(const float* __restrict__ canvas,
                             const float* __restrict__ rois,
                             float* __restrict__ out, int Hc, int Wc, int C,
                             int R, int S) {
  const int bin = blockIdx.x;
  const int r = blockIdx.y;
  const int t = blockIdx.z;
  const int by = bin / S, bx = bin % S;

  const float* roi = rois + ((size_t)t * R + r) * 4;
  const float x0 = roi[0], y0 = roi[1];
  const float bw = fmaxf(__fdiv_rn(__fsub_rn(roi[2], x0), (float)S), 1e-8f);
  const float bh = fmaxf(__fdiv_rn(__fsub_rn(roi[3], y0), (float)S), 1e-8f);
  const float lox = __fadd_rn(x0, __fmul_rn((float)bx, bw));
  const float hix = __fadd_rn(lox, bw);
  const float loy = __fadd_rn(y0, __fmul_rn((float)by, bh));
  const float hiy = __fadd_rn(loy, bh);
  const float area = __fmul_rn(bw, bh);

  int xs, xe, ys, ye;
  support(lox, hix, Wc, &xs, &xe);
  support(loy, hiy, Hc, &ys, &ye);

  const float* f = canvas + (size_t)t * Hc * Wc * C;
  float* o = out + (((size_t)t * R + r) * S * S + bin) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.0f;
    for (int y = ys; y <= ye; ++y) {
      const float wy = hat_weight(loy, hiy, y);
      const float* frow = f + (size_t)y * Wc * C + c;
      float row = 0.0f;
      for (int x = xs; x <= xe; ++x) {
        row += hat_weight(lox, hix, x) * frow[(size_t)x * C];
      }
      acc += wy * row;
    }
    o[c] = __fdiv_rn(acc, area);
  }
}

}  // namespace

extern "C" int tao_prroi_f32(const void* canvas, const void* rois, void* out,
                             int T, int Hc, int Wc, int C, int R, int S,
                             void* stream) {
  if (T > 0 && R > 0) {
    const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
    const dim3 grid(S * S, R, T);
    prroi_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)canvas, (const float*)rois, (float*)out, Hc, Wc, C, R,
        S);
  }
  return (int)cudaGetLastError();
}
