// Precise RoI pooling over a packed multilevel canvas or one level.
//
// canvas f32 [T, Hc, Wc, C] (h-major, channels last, C % 4 == 0), rois
// f32 [T, R, 4] xyxy in canvas coordinates -> out f32 [T, R, S, S, C].
// Each output bin is the exact integral of the bilinearly interpolated
// feature surface over the bin, divided by the bin area; the integral
// factors into per-axis hat-antiderivative weights (ops/roi.py).
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
// Bound: bytes (the RoIs' supports of the canvas, mostly from L2, and
// the output).  One block per (frame, RoI, bin row, group of up to 8
// bins of the row).  The block first computes the group's x weights
// once into shared memory, [column of the row's support][bin] with
// zeros outside each bin's own support; then each thread takes 4
// channels (float4) and walks the bin row's support once: every canvas
// pixel is read once, and its weights are two broadcast float4 reads,
// into 8 float4 row sums.  Each bin keeps the per-bin order
// sum_y wy * (sum_x wx * f), y and x increasing: a zero weight adds an
// exact zero, so a pixel outside a bin's support changes nothing, and a
// canvas padded with zero columns (B5) pools bit for bit as the
// unpadded one (B2).  The weight arithmetic uses round-to-nearest
// intrinsics that are never fused into FMAs, so the weights equal the
// plain PyTorch version's bit for bit and only the summation order
// differs.
//
// bf16 maps (tao_prroi_bf16): the TPU kernels take bf16 features and each
// rounds at its own points, so the three entry points compute three
// functions there; `form` selects one:
//   0, B2 (_fused_kernel): the x weights (the long axis of its w-major
//      canvas) rounded to bf16, the y weights and every sum f32, times
//      the f32 reciprocal of the bin area, output rounded to bf16;
//   1, B5 (_packed_kernel): both weights rounded, y contracted first and
//      each column's y-sum rounded to bf16, divided by the area, output
//      rounded to bf16;
//   2, B6 (_kernel): both weights rounded, every sum f32, divided by the
//      area, f32 output.
// The bf16 kernel keeps the block-per-bin-row structure and its x
// weights in shared memory (rounded where the form rounds them), and
// the row's y weights beside them.  Each thread takes 8 channels, one
// 16-byte load a pixel, and walks the row's support column by column:
// per column the y-sum of its support pixels, rounded for B5, then that
// sum times each bin's x weight into 8 x 8 f32 accumulators.  Every
// pixel is still read once; bound: half the f32 form's bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int G = 8;  // bins of a row per block: two float4s of weights

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

// Bin b's edges along one axis: lo = x0 + b * step, hi = lo + step.
__device__ __forceinline__ void bin_edges(float x0, float step, int b,
                                          float* lo, float* hi) {
  *lo = __fadd_rn(x0, __fmul_rn((float)b, step));
  *hi = __fadd_rn(*lo, step);
}

__device__ __forceinline__ void fma4(float4& acc, float w, float4 v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__global__ void __launch_bounds__(256)
prroi_kernel(const float4* __restrict__ canvas,
             const float* __restrict__ rois, float4* __restrict__ out,
             int Hc, int Wc, int C4, int R, int S) {
  extern __shared__ float4 wx4[];  // [span][G / 4]: column x's G weights
  const int groups = (S + G - 1) / G;
  const int by = blockIdx.x / groups;
  const int bx0 = (blockIdx.x % groups) * G;
  const int nb = min(G, S - bx0);
  const int r = blockIdx.y, t = blockIdx.z;

  const float* roi = rois + ((size_t)t * R + r) * 4;
  const float x0 = roi[0], y0 = roi[1];
  const float bw = fmaxf(__fdiv_rn(__fsub_rn(roi[2], x0), (float)S), 1e-8f);
  const float bh = fmaxf(__fdiv_rn(__fsub_rn(roi[3], y0), (float)S), 1e-8f);
  const float area = __fmul_rn(bw, bh);
  float loy, hiy;
  bin_edges(y0, bh, by, &loy, &hiy);
  int ys, ye;
  support(loy, hiy, Hc, &ys, &ye);

  // The group's x supports grow with the bin, so their union is the
  // first bin's first column to the last bin's last column.
  float lo, hi;
  int xu0, xu1, unused;
  bin_edges(x0, bw, bx0, &lo, &hi);
  support(lo, hi, Wc, &xu0, &unused);
  bin_edges(x0, bw, bx0 + nb - 1, &lo, &hi);
  support(lo, hi, Wc, &unused, &xu1);
  const int span = xu1 - xu0 + 1;

  float* wx = reinterpret_cast<float*>(wx4);
  for (int e = threadIdx.x; e < span * G; e += blockDim.x) {
    const int col = xu0 + e / G, b = e % G;
    float v = 0.0f;
    if (b < nb) {
      bin_edges(x0, bw, bx0 + b, &lo, &hi);
      int xs, xe;
      support(lo, hi, Wc, &xs, &xe);
      if (col >= xs && col <= xe) v = hat_weight(lo, hi, col);
    }
    wx[e] = v;
  }
  __syncthreads();

  const float4* f = canvas + (size_t)t * Hc * Wc * C4;
  float4* o = out + (((size_t)t * R + r) * S * S + by * S + bx0) * C4;
  for (int c = threadIdx.x; c < C4; c += blockDim.x) {
    float4 acc[G];
#pragma unroll
    for (int b = 0; b < G; ++b) acc[b] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int y = ys; y <= ye; ++y) {
      const float wy = hat_weight(loy, hiy, y);
      const float4* row = f + ((size_t)y * Wc + xu0) * C4 + c;
      float4 rs[G];
#pragma unroll
      for (int b = 0; b < G; ++b) rs[b] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = 0; i < span; ++i) {
        const float4 v = __ldg(row + (size_t)i * C4);
        const float4 w0 = wx4[2 * i], w1 = wx4[2 * i + 1];
        fma4(rs[0], w0.x, v);
        fma4(rs[1], w0.y, v);
        fma4(rs[2], w0.z, v);
        fma4(rs[3], w0.w, v);
        fma4(rs[4], w1.x, v);
        fma4(rs[5], w1.y, v);
        fma4(rs[6], w1.z, v);
        fma4(rs[7], w1.w, v);
      }
#pragma unroll
      for (int b = 0; b < G; ++b) {
        acc[b].x = fmaf(wy, rs[b].x, acc[b].x);
        acc[b].y = fmaf(wy, rs[b].y, acc[b].y);
        acc[b].z = fmaf(wy, rs[b].z, acc[b].z);
        acc[b].w = fmaf(wy, rs[b].w, acc[b].w);
      }
    }
#pragma unroll
    for (int b = 0; b < G; ++b) {
      if (b < nb) {
        o[(size_t)b * C4 + c] = make_float4(
            __fdiv_rn(acc[b].x, area), __fdiv_rn(acc[b].y, area),
            __fdiv_rn(acc[b].z, area), __fdiv_rn(acc[b].w, area));
      }
    }
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Eight bf16 channels of a 16-byte load as f32.
__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <int FORM>
__global__ void __launch_bounds__(256)
prroi_bf16_kernel(const uint4* __restrict__ canvas,
                  const float* __restrict__ rois, void* __restrict__ out,
                  int Hc, int Wc, int C8, int R, int S) {
  constexpr bool ROUND_Y = FORM != 0, ROUND_MID = FORM == 1;
  extern __shared__ float4 wx4[];  // [span][G / 4], then the row's wy
  const int groups = (S + G - 1) / G;
  const int by = blockIdx.x / groups;
  const int bx0 = (blockIdx.x % groups) * G;
  const int nb = min(G, S - bx0);
  const int r = blockIdx.y, t = blockIdx.z;

  const float* roi = rois + ((size_t)t * R + r) * 4;
  const float x0 = roi[0], y0 = roi[1];
  const float bw = fmaxf(__fdiv_rn(__fsub_rn(roi[2], x0), (float)S), 1e-8f);
  const float bh = fmaxf(__fdiv_rn(__fsub_rn(roi[3], y0), (float)S), 1e-8f);
  const float area = __fmul_rn(bw, bh);
  const float inv_area = __fdiv_rn(1.0f, area);
  float loy, hiy;
  bin_edges(y0, bh, by, &loy, &hiy);
  int ys, ye;
  support(loy, hiy, Hc, &ys, &ye);

  float lo, hi;
  int xu0, xu1, unused;
  bin_edges(x0, bw, bx0, &lo, &hi);
  support(lo, hi, Wc, &xu0, &unused);
  bin_edges(x0, bw, bx0 + nb - 1, &lo, &hi);
  support(lo, hi, Wc, &unused, &xu1);
  const int span = xu1 - xu0 + 1;

  float* wx = reinterpret_cast<float*>(wx4);
  float* wy = wx + span * G;
  for (int e = threadIdx.x; e < span * G; e += blockDim.x) {
    const int col = xu0 + e / G, b = e % G;
    float v = 0.0f;
    if (b < nb) {
      bin_edges(x0, bw, bx0 + b, &lo, &hi);
      int xs, xe;
      support(lo, hi, Wc, &xs, &xe);
      if (col >= xs && col <= xe) v = round_bf16(hat_weight(lo, hi, col));
    }
    wx[e] = v;
  }
  for (int y = ys + (int)threadIdx.x; y <= ye; y += blockDim.x) {
    const float v = hat_weight(loy, hiy, y);
    wy[y - ys] = ROUND_Y ? round_bf16(v) : v;
  }
  __syncthreads();

  const uint4* f = canvas + (size_t)t * Hc * Wc * C8;
  const size_t o0 = (((size_t)t * R + r) * S * S + by * S + bx0) * C8;
  for (int c = threadIdx.x; c < C8; c += blockDim.x) {
    float acc[G][8];
#pragma unroll
    for (int b = 0; b < G; ++b)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[b][k] = 0.f;
    for (int i = 0; i < span; ++i) {
      const uint4* col = f + (size_t)(xu0 + i) * C8 + c;
      float m[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) m[k] = 0.f;
      for (int y = ys; y <= ye; ++y) {
        float v[8];
        unpack8(__ldg(col + (size_t)y * Wc * C8), v);
        const float w = wy[y - ys];
#pragma unroll
        for (int k = 0; k < 8; ++k) m[k] = fmaf(w, v[k], m[k]);
      }
      if (ROUND_MID) {
#pragma unroll
        for (int k = 0; k < 8; ++k) m[k] = round_bf16(m[k]);
      }
      const float4 w0 = wx4[2 * i], w1 = wx4[2 * i + 1];
      const float wb[G] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int b = 0; b < G; ++b)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[b][k] = fmaf(wb[b], m[k], acc[b][k]);
    }
#pragma unroll
    for (int b = 0; b < G; ++b) {
      if (b >= nb) continue;
      float y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        y[k] = FORM == 0 ? __fmul_rn(acc[b][k], inv_area)
                         : __fdiv_rn(acc[b][k], area);
      const size_t o = o0 + (size_t)b * C8 + c;
      if (FORM == 2) {
        float4* dst = reinterpret_cast<float4*>(out) + 2 * o;
        dst[0] = make_float4(y[0], y[1], y[2], y[3]);
        dst[1] = make_float4(y[4], y[5], y[6], y[7]);
      } else {
        __nv_bfloat162 h[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          h[k] = __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
        reinterpret_cast<uint4*>(out)[o] =
            *reinterpret_cast<const uint4*>(h);
      }
    }
  }
}

template <int FORM>
cudaError_t launch_bf16(const void* canvas, const void* rois, void* out,
                        int T, int Hc, int Wc, int C, int R, int S,
                        cudaStream_t stream) {
  const int C8 = C / 8;
  const int threads = C8 >= 256 ? 256 : ((C8 + 31) / 32) * 32;
  const int smem = (Wc * G + Hc) * (int)sizeof(float);
  auto kernel = prroi_bf16_kernel<FORM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(S * ((S + G - 1) / G), R, T);
  kernel<<<grid, threads, smem, stream>>>((const uint4*)canvas,
                                          (const float*)rois, out, Hc, Wc,
                                          C8, R, S);
  return cudaGetLastError();
}

}  // namespace

// The wrapper guarantees C % 4 == 0, 16-byte-aligned contiguous tensors,
// S >= 1 and Wc * G * 4 bytes of shared memory within the card's limit.
extern "C" int tao_prroi_f32(const void* canvas, const void* rois, void* out,
                             int T, int Hc, int Wc, int C, int R, int S,
                             void* stream) {
  if (T > 0 && R > 0 && S > 0 && C > 0) {
    const int C4 = C / 4;
    const int threads = C4 >= 256 ? 256 : ((C4 + 31) / 32) * 32;
    const int smem = Wc * G * (int)sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          prroi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(S * ((S + G - 1) / G), R, T);
    prroi_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const float4*)canvas, (const float*)rois, (float4*)out, Hc, Wc, C4,
        R, S);
  }
  return (int)cudaGetLastError();
}

// The wrapper guarantees a bf16 canvas with C % 8 == 0, 16-byte-aligned
// contiguous tensors, S >= 1, (Wc * G + Hc) * 4 bytes of shared memory
// within the card's limit and `form` 0 (B2), 1 (B5) or 2 (B6); out is
// bf16 for forms 0 and 1, f32 for form 2.
extern "C" int tao_prroi_bf16(const void* canvas, const void* rois, void* out,
                              int T, int Hc, int Wc, int C, int R, int S,
                              int form, void* stream) {
  if (form < 0 || form > 2 || C % 8) return (int)cudaErrorInvalidValue;
  if (T > 0 && R > 0 && S > 0 && C > 0) {
    auto s = (cudaStream_t)stream;
    const cudaError_t e =
        form == 0 ? launch_bf16<0>(canvas, rois, out, T, Hc, Wc, C, R, S, s)
        : form == 1
            ? launch_bf16<1>(canvas, rois, out, T, Hc, Wc, C, R, S, s)
            : launch_bf16<2>(canvas, rois, out, T, Hc, Wc, C, R, S, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
