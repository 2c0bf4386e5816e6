// One convolution of a stride-1 bottleneck chain, with BatchNorm folded:
// out = act(conv(x, w) + bias [+ res]), NHWC f32, SAME zero padding.
//
// x f32 [T, H, W, Cin], w f32 [KS*KS*Cin, Cout] (HWIO flattened: row
// (ky*KS + kx)*Cin + c), bias f32 [Cout], res f32 [T, H, W, Cout] or
// null, out f32 [T, H, W, Cout]; KS is 1 or 3, stride 1, dilation 1.
//
// Replaces the TPU kernel tao_amodal_tpu/ops/pallas/fused_stage.py
// fused_bottleneck_chain (_chain_kernel), which runs a whole chain of
// bottlenecks per (frame, row tile) in VMEM.  The Python wrapper
// (ops/fused_stage.py) launches this kernel once per conv of the chain:
// relu(1x1 + ba), relu(3x3 + b3), the optional projection 1x1 + bd, and
// relu(1x1 + bb + residual), each epilogue fused into its conv.  The
// halo trap of the TPU kernel (relu(conv(0) + bias) != 0 on rows outside
// the frame, which it re-zeroes between blocks) does not arise here:
// every conv reads its input from device memory and loads zeros for
// taps outside the frame, so each 3x3 sees exact SAME padding of its
// own input.
//
// Bound: f32 FMAs.  The chain of the four ResNet-50 stages at 512^2,
// T=8 is about 238 GFLOP per clip; true f32 (no TF32, no tensor cores:
// the f32 reference must hold) runs on the CUDA cores at 67 TFLOP/s
// peak.  Design: implicit GEMM, M = T*H*W pixels by N = Cout, depth
// K = KS*KS*Cin.  A block computes a BM x BN tile; BK = 8 deep slices
// of the pixel rows (one tap, 8 channels, so Cin % 8 == 0) and of the
// weights are staged in shared memory, double-buffered through
// registers, and each thread accumulates a TM x TN register tile with
// FMAs.  Keeping the chain's intermediates on chip and tensor-core
// (wgmma) paths are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 8;

template <int BM, int BN, int TM, int TN, int KS>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ res, float* __restrict__ out,
                 int T, int H, int W, int Cin, int Cout, int relu) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int A_VEC = BM * BK / 4;  // float4s of one A slice
  constexpr int B_VEC = BK * BN / 4;  // float4s of one B slice
  constexpr int A_PER = (A_VEC + NT - 1) / NT;
  constexpr int B_PER = (B_VEC + NT - 1) / NT;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 register tiles");

  __shared__ __align__(16) float As[2][BK][BM];  // As[k][m]
  __shared__ __align__(16) float Bs[2][BK][BN];  // Bs[k][n]

  const int tid = threadIdx.x;
  const int P = T * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = KS * KS * Cin / BK;

  // The A rows this thread loads are the same for every slice: keep
  // their pixel index and (y, x) for the 3x3 taps' frame test.
  int a_m[A_PER], a_y[A_PER], a_x[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int v = tid + i * NT;
    const int m = m0 + (v >> 1);
    a_m[i] = (v < A_VEC && m < P) ? m : -1;
    const int hw = m % (H * W);
    a_y[i] = hw / W;
    a_x[i] = hw % W;
  }

  float4 ra[A_PER], rb[B_PER];
  auto load = [&](int kt) {
    const int k0 = kt * BK;
    const int tap = k0 / Cin;
    const int c0 = k0 - tap * Cin;
    const int dy = KS == 3 ? tap / 3 - 1 : 0;
    const int dx = KS == 3 ? tap % 3 - 1 : 0;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int v = tid + i * NT;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a_m[i] >= 0) {
        const int sy = a_y[i] + dy, sx = a_x[i] + dx;
        if (sy >= 0 && sy < H && sx >= 0 && sx < W) {
          const size_t pix = (size_t)a_m[i] + dy * W + dx;
          val = *reinterpret_cast<const float4*>(
              x + pix * Cin + c0 + (v & 1) * 4);
        }
      }
      ra[i] = val;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < B_VEC && n0 + c < Cout) {
        val = *reinterpret_cast<const float4*>(
            w + (size_t)(k0 + r) * Cout + n0 + c);
      }
      rb[i] = val;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int v = tid + i * NT;
      if (v < A_VEC) {
        const int m = v >> 1, k = (v & 1) * 4;
        As[buf][k + 0][m] = ra[i].x;
        As[buf][k + 1][m] = ra[i].y;
        As[buf][k + 2][m] = ra[i].z;
        As[buf][k + 3][m] = ra[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * NT;
      if (v < B_VEC) {
        const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
        *reinterpret_cast<float4*>(&Bs[buf][r][c]) = rb[i];
      }
    }
  };

  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load(kt + 1);  // global loads in flight
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[buf][k][ty * TM + i]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[buf][k][tx * TN + j]);
        b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: + bias, + residual, ReLU; float4 stores (Cout % 4 == 0).
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= P) continue;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int n = n0 + tx * TN + j;
      if (n >= Cout) continue;
      const float4 bv = *reinterpret_cast<const float4*>(bias + n);
      float4 v = make_float4(acc[i][j] + bv.x, acc[i][j + 1] + bv.y,
                             acc[i][j + 2] + bv.z, acc[i][j + 3] + bv.w);
      const size_t o = (size_t)m * Cout + n;
      if (res != nullptr) {
        const float4 r = *reinterpret_cast<const float4*>(res + o);
        v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
      }
      if (relu) {
        v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
      }
      *reinterpret_cast<float4*>(out + o) = v;
    }
  }
}

template <int BM, int BN, int TM, int TN>
void launch(const float* x, const float* w, const float* bias,
            const float* res, float* out, int T, int H, int W, int Cin,
            int Cout, int ks, int relu, cudaStream_t stream) {
  const int P = T * H * W;
  const dim3 grid((P + BM - 1) / BM, (Cout + BN - 1) / BN);
  const int threads = (BM / TM) * (BN / TN);
  if (ks == 1) {
    conv_nhwc_kernel<BM, BN, TM, TN, 1><<<grid, threads, 0, stream>>>(
        x, w, bias, res, out, T, H, W, Cin, Cout, relu);
  } else {
    conv_nhwc_kernel<BM, BN, TM, TN, 3><<<grid, threads, 0, stream>>>(
        x, w, bias, res, out, T, H, W, Cin, Cout, relu);
  }
}

}  // namespace

// The wrapper guarantees Cin % 8 == 0, Cout % 4 == 0, contiguous
// 16-byte-aligned tensors and ks in {1, 3}.
extern "C" int tao_conv_nhwc_f32(const void* x, const void* w,
                                 const void* bias, const void* res,
                                 void* out, int T, int H, int W, int Cin,
                                 int Cout, int ks, int relu, void* stream) {
  if (ks != 1 && ks != 3) return (int)cudaErrorInvalidValue;
  const int P = T * H * W;
  if (P == 0 || Cout == 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto xf = (const float*)x;
  auto wf = (const float*)w;
  auto bf = (const float*)bias;
  auto rf = (const float*)res;
  auto of = (float*)out;
  // 128x128 tiles where they make at least two waves over the 132 SMs,
  // 128x64 for the 64-wide convs, 64x64 tiles otherwise.
  const long big = (long)((P + 127) / 128) * ((Cout + 127) / 128);
  if (Cout <= 64) {
    launch<128, 64, 8, 4>(xf, wf, bf, rf, of, T, H, W, Cin, Cout, ks, relu,
                          s);
  } else if (big >= 264) {
    launch<128, 128, 8, 8>(xf, wf, bf, rf, of, T, H, W, Cin, Cout, ks, relu,
                           s);
  } else {
    launch<64, 64, 4, 4>(xf, wf, bf, rf, of, T, H, W, Cin, Cout, ks, relu,
                         s);
  }
  return (int)cudaGetLastError();
}
