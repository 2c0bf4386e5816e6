// One convolution of an identity-bottleneck stack in int8 or bf16, with
// BatchNorm folded into its epilogue; NHWC, stride 1, SAME zero padding.
//
//   int8 (tao_conv_nhwc_s8): x int8 [T, H, W, Cin], w int32 [KS*KS*Cin/4,
//     Cout] (each word four consecutive k of HWIO-flattened int8 weights,
//     k = (ky*KS + kx)*Cin + c), scale/bias f32 [Cout], res int8 [T, H,
//     W, Cout] and res_scale f32 [1], or both null -> out int8:
//       y = acc*scale + bias (+ res*res_scale); q = clip(rint(relu(y)),
//       0, 127)
//   bf16 (tao_conv_nhwc_bf16): x bf16, w f32 [KS*KS*Cin, Cout] (bf16
//     values), scale/bias f32 [Cout], res bf16 or null -> out bf16:
//       y = acc*scale + bias (+ res); out = bf16_rn(relu(y))
//
// Replaces the TPU kernels tao_amodal_tpu/ops/pallas/resnet_blocks.py
// identity_blocks_pallas (_stack_kernel, B7) and
// identity_blocks_bf16_pallas (_bf16_stack_kernel, B8), which run a
// frame's whole stack in VMEM.  The Python wrappers
// (ops/resnet_blocks.py) launch this kernel three times per block:
// 1x1 C -> M, 3x3 M -> M, 1x1 M -> C with the residual.  The
// intermediates go through device memory in int8 or bf16, rounded where
// the reference rounds them, so the numbers match its own.
//
// Bound: operations on the CUDA cores.  The four ResNet-50 stage stacks
// at 512^2, T=8 are 109.5 G multiply-adds per clip, while this design
// moves about 0.67 GB of int8 activations (1.3 GB in bf16), 0.2-0.4 ms
// at 3.35 TB/s; without tensor cores the multiply-adds take longer than
// the bytes.  Design:
// implicit GEMM as in fused_stage.cu (M = T*H*W pixels by N = Cout,
// K = KS*KS*Cin; BM x BN tiles, TM x TN per thread, 8-row K slices of
// pixels and weights in shared memory, double-buffered through
// registers).  int8: a shared-memory row is one 32-bit word of 4
// channels, so a slice is 32 channels of one tap (Cin % 32 == 0), and
// each product is a __dp4a into an int32 accumulator, exact.  bf16: a
// row is one channel converted to f32 (exact), each product an f32 FMA
// whose product is exact, so only the summation order differs from the
// reference; tensor cores (mma/wgmma) and holding the block on chip are
// later work.  Epilogues use round-to-nearest intrinsics never fused
// into FMAs, in the reference's order: ((acc*s) + b) + x*rs for int8,
// ((acc*g) + b) + x for bf16; __int2float_rn for accumulators above
// 2^24, rintf (half to even, as jnp.round) and __float2bfloat16_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BKR = 8;  // 32-bit shared-memory rows per K slice

template <bool INT8>
struct Traits;
template <>
struct Traits<true> {
  using In = int8_t;
  using Word = int;
  static constexpr int CH_PER_ROW = 4;
};
template <>
struct Traits<false> {
  using In = __nv_bfloat16;
  using Word = float;
  static constexpr int CH_PER_ROW = 1;
};

__device__ __forceinline__ void ld4(const int* p, int* d) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
__device__ __forceinline__ void ld4(const float* p, float* d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
__device__ __forceinline__ void mac(int a, int b, int& acc) {
  acc = __dp4a(a, b, acc);
}
__device__ __forceinline__ void mac(float a, float b, float& acc) {
  acc = fmaf(a, b, acc);  // a*b is exact for bf16 operands
}
__device__ __forceinline__ float acc_f32(int acc) { return __int2float_rn(acc); }
__device__ __forceinline__ float acc_f32(float acc) { return acc; }
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <bool INT8, int BM, int BN, int TM, int TN, int KS>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv_q_kernel(const typename Traits<INT8>::In* __restrict__ x,
              const typename Traits<INT8>::Word* __restrict__ w,
              const float* __restrict__ scale,
              const float* __restrict__ bias,
              const typename Traits<INT8>::In* __restrict__ res,
              const float* __restrict__ res_scale,
              typename Traits<INT8>::In* __restrict__ out, int T, int H,
              int W, int Cin, int Cout) {
  using Tr = Traits<INT8>;
  using In = typename Tr::In;
  using Word = typename Tr::Word;
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int SLICE = BKR * Tr::CH_PER_ROW;  // channels per K slice
  constexpr int VEC_CH = 16 / (int)sizeof(In);  // channels per 16 bytes
  constexpr int VPP = SLICE / VEC_CH;           // vectors per pixel
  constexpr int A_VEC = BM * VPP;
  constexpr int B_VEC = BKR * BN / 4;
  constexpr int A_PER = (A_VEC + NT - 1) / NT;
  constexpr int B_PER = (B_VEC + NT - 1) / NT;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "4-wide register tiles");

  __shared__ __align__(16) Word As[2][BKR][BM];  // As[k][m]
  __shared__ __align__(16) Word Bs[2][BKR][BN];  // Bs[k][n]

  const int tid = threadIdx.x;
  const int P = T * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = KS * KS * Cin / SLICE;

  // The A pixels this thread loads are the same for every slice: keep
  // their index and (y, x) for the 3x3 taps' frame test.
  int a_m[A_PER], a_y[A_PER], a_x[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int v = tid + i * NT;
    const int m = m0 + v / VPP;
    a_m[i] = (v < A_VEC && m < P) ? m : -1;
    const int hw = m % (H * W);
    a_y[i] = hw / W;
    a_x[i] = hw % W;
  }

  int4 ra[A_PER], rb[B_PER];
  auto load = [&](int kt) {
    const int k0 = kt * SLICE;
    const int tap = k0 / Cin;
    const int c0 = k0 - tap * Cin;
    const int dy = KS == 3 ? tap / 3 - 1 : 0;
    const int dx = KS == 3 ? tap % 3 - 1 : 0;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int v = tid + i * NT;
      int4 val = make_int4(0, 0, 0, 0);
      if (a_m[i] >= 0) {
        const int sy = a_y[i] + dy, sx = a_x[i] + dx;
        if (sy >= 0 && sy < H && sx >= 0 && sx < W) {
          const size_t pix = (size_t)a_m[i] + dy * W + dx;
          val = *reinterpret_cast<const int4*>(
              x + pix * Cin + c0 + (v % VPP) * VEC_CH);
        }
      }
      ra[i] = val;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
      int4 val = make_int4(0, 0, 0, 0);
      if (v < B_VEC && n0 + c < Cout) {
        val = *reinterpret_cast<const int4*>(
            w + (size_t)(kt * BKR + r) * Cout + n0 + c);
      }
      rb[i] = val;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int v = tid + i * NT;
      if (v < A_VEC) {
        const int m = v / VPP;
        const unsigned u[4] = {(unsigned)ra[i].x, (unsigned)ra[i].y,
                               (unsigned)ra[i].z, (unsigned)ra[i].w};
        if constexpr (INT8) {
          const int row = (v % VPP) * 4;  // one word = 4 channels
#pragma unroll
          for (int j = 0; j < 4; ++j) As[buf][row + j][m] = (int)u[j];
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // one word = 2 channels
            As[buf][2 * j][m] = bf16_lo(u[j]);
            As[buf][2 * j + 1][m] = bf16_hi(u[j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * NT;
      if (v < B_VEC) {
        const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
        *reinterpret_cast<int4*>(&Bs[buf][r][c]) = rb[i];
      }
    }
  };

  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  Word acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load(kt + 1);  // global loads in flight
#pragma unroll
    for (int k = 0; k < BKR; ++k) {
      Word a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) ld4(&As[buf][k][ty * TM + i], a + i);
#pragma unroll
      for (int j = 0; j < TN; j += 4) ld4(&Bs[buf][k][tx * TN + j], b + j);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) mac(a[i], b[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // Epilogue, 4 channels at a time (Cout % 4 == 0).
  const float rs = (INT8 && res != nullptr) ? *res_scale : 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= P) continue;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int n = n0 + tx * TN + j;
      if (n >= Cout) continue;
      const size_t o = (size_t)m * Cout + n;
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        y[q] = __fadd_rn(__fmul_rn(acc_f32(acc[i][j + q]), scale[n + q]),
                         bias[n + q]);
      }
      if constexpr (INT8) {
        if (res != nullptr) {
          const int rw = *reinterpret_cast<const int*>(res + o);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float r = (float)(int8_t)(rw >> (8 * q));
            y[q] = __fadd_rn(y[q], __fmul_rn(r, rs));
          }
        }
        unsigned packed = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int v = (int)fminf(rintf(fmaxf(y[q], 0.f)), 127.f);
          packed |= (unsigned)v << (8 * q);
        }
        *reinterpret_cast<unsigned*>(out + o) = packed;
      } else {
        if (res != nullptr) {
          const uint2 rw = *reinterpret_cast<const uint2*>(res + o);
          y[0] = __fadd_rn(y[0], bf16_lo(rw.x));
          y[1] = __fadd_rn(y[1], bf16_hi(rw.x));
          y[2] = __fadd_rn(y[2], bf16_lo(rw.y));
          y[3] = __fadd_rn(y[3], bf16_hi(rw.y));
        }
        unsigned short h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          h[q] = __bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(y[q], 0.f)));
        }
        *reinterpret_cast<uint2*>(out + o) =
            make_uint2(h[0] | ((unsigned)h[1] << 16),
                       h[2] | ((unsigned)h[3] << 16));
      }
    }
  }
}

template <bool INT8, int BM, int BN, int TM, int TN>
void launch(const void* x, const void* w, const float* scale,
            const float* bias, const void* res, const float* res_scale,
            void* out, int T, int H, int W, int Cin, int Cout, int ks,
            cudaStream_t stream) {
  using Tr = Traits<INT8>;
  using In = typename Tr::In;
  using Word = typename Tr::Word;
  const int P = T * H * W;
  const dim3 grid((P + BM - 1) / BM, (Cout + BN - 1) / BN);
  const int threads = (BM / TM) * (BN / TN);
  auto xi = (const In*)x;
  auto wi = (const Word*)w;
  auto ri = (const In*)res;
  auto oi = (In*)out;
  if (ks == 1) {
    conv_q_kernel<INT8, BM, BN, TM, TN, 1><<<grid, threads, 0, stream>>>(
        xi, wi, scale, bias, ri, res_scale, oi, T, H, W, Cin, Cout);
  } else {
    conv_q_kernel<INT8, BM, BN, TM, TN, 3><<<grid, threads, 0, stream>>>(
        xi, wi, scale, bias, ri, res_scale, oi, T, H, W, Cin, Cout);
  }
}

// 128x128 tiles where they make at least two waves over the 132 SMs,
// 128x64 for the 64-wide convs, 64x64 tiles otherwise (as fused_stage.cu).
template <bool INT8>
int conv(const void* x, const void* w, const void* scale, const void* bias,
         const void* res, const void* res_scale, void* out, int T, int H,
         int W, int Cin, int Cout, int ks, void* stream) {
  constexpr int SLICE = BKR * Traits<INT8>::CH_PER_ROW;
  if ((ks != 1 && ks != 3) || Cin % SLICE || Cout % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int P = T * H * W;
  if (P == 0 || Cout == 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto sc = (const float*)scale;
  auto bi = (const float*)bias;
  auto rs = (const float*)res_scale;
  const long big = (long)((P + 127) / 128) * ((Cout + 127) / 128);
  if (Cout <= 64) {
    launch<INT8, 128, 64, 8, 4>(x, w, sc, bi, res, rs, out, T, H, W, Cin,
                                Cout, ks, s);
  } else if (big >= 264) {
    launch<INT8, 128, 128, 8, 8>(x, w, sc, bi, res, rs, out, T, H, W, Cin,
                                 Cout, ks, s);
  } else {
    launch<INT8, 64, 64, 4, 4>(x, w, sc, bi, res, rs, out, T, H, W, Cin,
                               Cout, ks, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The wrappers guarantee contiguous 16-byte-aligned tensors, Cin % 32
// (int8) or % 8 (bf16) == 0, Cout % 4 == 0 and ks in {1, 3}.
extern "C" int tao_conv_nhwc_s8(const void* x, const void* w,
                                const void* scale, const void* bias,
                                const void* res, const void* res_scale,
                                void* out, int T, int H, int W, int Cin,
                                int Cout, int ks, void* stream) {
  if ((res == nullptr) != (res_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return conv<true>(x, w, scale, bias, res, res_scale, out, T, H, W, Cin,
                    Cout, ks, stream);
}

extern "C" int tao_conv_nhwc_bf16(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  const void* res, void* out, int T, int H,
                                  int W, int Cin, int Cout, int ks,
                                  void* stream) {
  return conv<false>(x, w, scale, bias, res, nullptr, out, T, H, W, Cin,
                     Cout, ks, stream);
}
