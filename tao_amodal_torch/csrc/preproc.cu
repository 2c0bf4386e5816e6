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
// per output row / column -- keeping the row normalization and the
// all-zero letterbox rows, which come out as -mean/std -- and one
// thread per output pixel gathers its 2x2 taps for all three channels.
// The contraction order follows the reference (rows first, then
// columns).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void preproc_kernel(const uint8_t* __restrict__ frames,
                               const int2* __restrict__ ytap,
                               const float2* __restrict__ ywt,
                               const int2* __restrict__ xtap,
                               const float2* __restrict__ xwt,
                               const float* __restrict__ norm,
                               float* __restrict__ out,
                               int T, int H, int W, int Sh, int Sw) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)T * Sh * Sw) return;
  const int ox = (int)(i % Sw);
  const long long r = i / Sw;
  const int oy = (int)(r % Sh);
  const int t = (int)(r / Sh);

  const int2 yi = ytap[oy];
  const float2 yw = ywt[oy];
  const int2 xi = xtap[ox];
  const float2 xw = xwt[ox];
  const uint8_t* f = frames + (size_t)t * H * W * 3;
  const uint8_t* row0 = f + (size_t)yi.x * W * 3;
  const uint8_t* row1 = f + (size_t)yi.y * W * 3;
  float* o = out + i * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = yw.x * (float)row0[xi.x * 3 + c]
                  + yw.y * (float)row1[xi.x * 3 + c];
    const float b = yw.x * (float)row0[xi.y * 3 + c]
                  + yw.y * (float)row1[xi.y * 3 + c];
    const float v = xw.x * a + xw.y * b;
    o[c] = (v - norm[c]) / norm[3 + c];
  }
}

}  // namespace

extern "C" int tao_preproc_f32(const void* frames, const void* ytap,
                               const void* ywt, const void* xtap,
                               const void* xwt, const void* norm, void* out,
                               int T, int H, int W, int Sh, int Sw,
                               void* stream) {
  const long long n = (long long)T * Sh * Sw;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (n > 0) {
    preproc_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frames, (const int2*)ytap, (const float2*)ywt,
        (const int2*)xtap, (const float2*)xwt, (const float*)norm,
        (float*)out, T, H, W, Sh, Sw);
  }
  return (int)cudaGetLastError();
}
