// Fused letterbox preprocessing: uint8 [T,H,W,3] -> f32 [T,Sh,Sw,3].
//
// Replaces the TPU kernel tao_amodal_tpu/ops/pallas/preproc.py
// preprocess_frames_pallas (_preproc_kernel), which runs the bilinear
// resize as two MXU matmuls per plane, out = Wy . X . Wx^T.
//
// On the H100 the op is bound by device-memory bytes: 12 bytes of f32
// written per output pixel, a few bytes of uint8 read, and ~20 flops.
// A dense matmul would spend nearly all its work on zeros, because each
// row of the resize matrices has at most two nonzeros (hat weights, no
// antialias).  So the host turns Wy and Wx into (index, weight) pairs
// per output row / column, keeping the row normalization, and finds the
// content extent: the output rows and columns with a nonzero weight.
//
// One block per (output row, frame), frames in launches of at most
// 65,535 (a grid's rows).  A content row's block copies its
// two source rows into shared memory (16-byte loads where the rows are
// 16-byte aligned), then each thread gathers the 2x2 taps of 4
// consecutive output pixels from there and puts their 12 floats into
// the block's copy of the output row in shared memory (three float4
// stores, free of bank conflicts), which the block then writes out in
// coalesced 16-byte stores.  Letterbox pad rows and columns read
// nothing: their weights are all zero, so they are (0 - mean) / std,
// written directly.  The contraction order follows the reference (rows
// first, then columns), and the normalization is a true division by
// std.  A width that is not a multiple of 4, or unaligned rows, take
// scalar paths.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS_MAX = 256;

__global__ void __launch_bounds__(THREADS_MAX)
    preproc_kernel(const uint8_t* __restrict__ frames,
                   const int2* __restrict__ ytap,
                   const float2* __restrict__ ywt,
                   const int2* __restrict__ xtap,
                   const float2* __restrict__ xwt,
                   const float* __restrict__ norm, float* __restrict__ out,
                   int H, int W, int Sh, int Sw, int y_lo, int y_hi,
                   int x_lo, int x_hi) {
  // The output row (Sw * 3 floats), then two source rows (W * 3 bytes
  // each), each 16-byte aligned.
  extern __shared__ uint4 smem4[];
  const int out4 = (Sw * 3 + 3) / 4;
  float* stage = reinterpret_cast<float*>(smem4);
  uint4* rows4 = smem4 + out4;
  uint8_t* rows = reinterpret_cast<uint8_t*>(rows4);
  const int oy = blockIdx.x, t = blockIdx.y;
  const int row_bytes = W * 3;
  float* orow = out + ((size_t)t * Sh + oy) * Sw * 3;

  float pad[3], mean[3], sd[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mean[c] = norm[c];
    sd[c] = norm[3 + c];
    pad[c] = (0.0f - mean[c]) / sd[c];
  }

  const bool content = oy >= y_lo && oy < y_hi;
  int2 yi = make_int2(0, 0);
  float2 yw = make_float2(0.0f, 0.0f);
  if (content) {
    yi = ytap[oy];
    yw = ywt[oy];
    const uint8_t* f = frames + (size_t)t * H * row_bytes;
    const uint8_t* src0 = f + (size_t)yi.x * row_bytes;
    const uint8_t* src1 = f + (size_t)yi.y * row_bytes;
    if (row_bytes % 16 == 0 && ((uintptr_t)frames & 15) == 0) {
      const int n16 = row_bytes / 16;
      for (int i = threadIdx.x; i < 2 * n16; i += blockDim.x) {
        const bool second = i >= n16;
        const int j = second ? i - n16 : i;
        rows4[i] = reinterpret_cast<const uint4*>(second ? src1 : src0)[j];
      }
    } else {
      for (int i = threadIdx.x; i < 2 * row_bytes; i += blockDim.x) {
        const bool second = i >= row_bytes;
        rows[i] = second ? src1[i - row_bytes] : src0[i];
      }
    }
    __syncthreads();
  }
  const uint8_t* row0 = rows;
  const uint8_t* row1 = rows + row_bytes;
  const bool vec = Sw % 4 == 0;

  for (int g = threadIdx.x; 4 * g < Sw; g += blockDim.x) {
    float v[12];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int ox = 4 * g + p;
      if (content && ox >= x_lo && ox < x_hi) {
        const int2 xi = xtap[ox];
        const float2 xw = xwt[ox];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float a = yw.x * (float)row0[xi.x * 3 + c]
                        + yw.y * (float)row1[xi.x * 3 + c];
          const float b = yw.x * (float)row0[xi.y * 3 + c]
                        + yw.y * (float)row1[xi.y * 3 + c];
          const float s = xw.x * a + xw.y * b;
          v[3 * p + c] = (s - mean[c]) / sd[c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) v[3 * p + c] = pad[c];
      }
    }
    float* o = stage + 12 * g;
    if (vec) {
      float4* o4 = reinterpret_cast<float4*>(o);
      o4[0] = make_float4(v[0], v[1], v[2], v[3]);
      o4[1] = make_float4(v[4], v[5], v[6], v[7]);
      o4[2] = make_float4(v[8], v[9], v[10], v[11]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (4 * g + p < Sw) {
#pragma unroll
          for (int c = 0; c < 3; ++c) o[3 * p + c] = v[3 * p + c];
        }
      }
    }
  }
  __syncthreads();
  if (vec) {  // the row starts 16-byte aligned: Sw * 12 bytes a row
    const float4* s4 = reinterpret_cast<const float4*>(stage);
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int i = threadIdx.x; i < out4; i += blockDim.x) o4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < Sw * 3; i += blockDim.x) orow[i] = stage[i];
  }
}

}  // namespace

// Shared memory of one block: the output row and two source rows.
extern "C" long long tao_preproc_smem(int W, int Sw) {
  return 16LL * ((3LL * Sw + 3) / 4) + (6LL * W + 15) / 16 * 16;
}

// The wrapper guarantees a contiguous uint8 [T, H, W, 3] input, a
// contiguous f32 [T, Sh, Sw, 3] output (256-byte aligned, as PyTorch
// allocates it), and shared memory within a block's 227 KB.  Wide frames
// (more than 48 KB: 6 W + 12 Sw bytes) raise the kernel's limit first.
extern "C" int tao_preproc_f32(const void* frames, const void* ytap,
                               const void* ywt, const void* xtap,
                               const void* xwt, const void* norm, void* out,
                               int T, int H, int W, int Sh, int Sw, int y_lo,
                               int y_hi, int x_lo, int x_hi, void* stream) {
  if (T <= 0 || Sh <= 0 || Sw <= 0) return (int)cudaGetLastError();
  const long long smem = tao_preproc_smem(W, Sw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        preproc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (Sw + 3) / 4;
  int threads = (groups + 31) / 32 * 32;
  if (threads > THREADS_MAX) threads = THREADS_MAX;
  // A frame's offsets keep the 16-byte alignment the kernel tests for.
  for (int t0 = 0; t0 < T; t0 += 65535) {
    const int n = T - t0 < 65535 ? T - t0 : 65535;
    preproc_kernel<<<dim3((unsigned)Sh, (unsigned)n), threads, (size_t)smem,
                     (cudaStream_t)stream>>>(
        (const uint8_t*)frames + (size_t)t0 * H * W * 3, (const int2*)ytap,
        (const float2*)ywt, (const int2*)xtap, (const float2*)xwt,
        (const float*)norm, (float*)out + (size_t)t0 * Sh * Sw * 3, H, W, Sh,
        Sw, y_lo, y_hi, x_lo, x_hi);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
