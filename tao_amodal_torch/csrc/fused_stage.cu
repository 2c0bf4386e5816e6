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
// Bound: f32 FMAs.  The chains of the four ResNet-50 stages at 512^2,
// T=8 are about 238 GFLOP per clip; true f32 (no TF32, no tensor cores:
// the f32 reference must hold) runs on the CUDA cores at 67 TFLOP/s
// peak.  Design: implicit GEMM, M = T*H*W pixels by N = Cout, depth
// K = KS*KS*Cin.
//   * Tiles: 128 x 128 (8 x 8 per thread) or 128 x 64 (8 x 4), 256
//     threads, at most 128 registers, so two blocks share an SM.
//   * Operands: BK = 32 deep slices of A (pixel rows: eight 16-byte
//     chunks of channels per pixel) and B (weight rows) are copied by
//     16-byte cp.async into a 3-stage ring in dynamic shared memory, one
//     barrier per slice; taps outside the frame, rows past P, columns
//     past Cout and k past K are zero-filled by the copy itself.
//   * Layout: A stays pixel-major as it arrives (no transposing store),
//     rows 36 floats apart: a quarter-warp's eight chunk writes (eight
//     rows, one chunk column) land on eight distinct 4-bank groups, and
//     a warp's reads (float4 of four k, one row per half-warp, rows
//     ty + 16 i) are broadcasts from two rows on distinct banks.  B's
//     per-k reads are float4s of contiguous columns (tx*4 and
//     64 + tx*4), conflict-free.  (A k-major A tile, stored by 4-byte
//     copies through an XOR swizzle, needs fewer shared-memory reads
//     but ran slower: the copies cost more instructions than the reads
//     save.)
//   * Split K: where the output tiles cannot fill the card (the wrapper's
//     plan, ops/fused_stage.py::conv_plan), blockIdx.z sums a contiguous
//     range of K slices into an f32 workspace [splits, P, Cout] and a
//     second kernel adds the partials in split order, then the bias,
//     residual and ReLU: deterministic, no atomics.
// Keeping the chain's intermediates on chip and tensor-core paths are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;     // pixels per tile
constexpr int BK = 32;      // k per slice
constexpr int STAGES = 3;   // cp.async ring depth
constexpr int NT = 256;     // threads: 16 x 16, each 8 rows
constexpr int AS = BK + 4;  // A row stride (floats)

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool ok) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src-size 0 writes 16 zero bytes and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BN>
constexpr int smem_bytes() {
  return STAGES * (BM * AS + BK * BN) * (int)sizeof(float);
}

template <int BN, int KS>
__global__ void __launch_bounds__(NT, 2)
conv_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ res, float* __restrict__ out,
                 float* __restrict__ ws, int H, int W, int P, int Cin,
                 int Cout, int relu, int slices) {
  constexpr int TN = BN / 16;          // columns per thread
  constexpr int A_TILE = BM * AS;      // floats per stage
  constexpr int B_TILE = BK * BN;
  constexpr int B_ROW = BN / 4;        // 16-byte chunks per B row
  constexpr int B_STEP = NT / B_ROW;   // B rows per pass of the block
  constexpr int B_PER = BK / B_STEP;   // B chunks per thread
  extern __shared__ float4 smem4[];
  float* const As = reinterpret_cast<float*>(smem4);  // [STAGES][BM][AS]
  float* const Bs = As + STAGES * A_TILE;             // [STAGES][BK][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K = KS * KS * Cin;
  const int nk = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * slices;
  const int kt1 = min(nk, kt0 + slices);

  // A chunks: rows a_row + 64 (i & 1), chunk columns a_q + 4 (i >> 1)
  // (channels 4q..4q+3 of the slice); a warp loads 8 pixels x 64
  // contiguous bytes per copy.  Each tile row's pixel and (y, x) sit in
  // shared memory, not in registers: the 3x3 128x128 instance spills at
  // 128 registers otherwise.
  constexpr int A_PER = BM * BK / 4 / NT;
  const int a_row = warp * 8 + (lane & 7), a_q = lane >> 3;
  __shared__ int2 rows[BM];  // pixel (-1 past P), y << 16 | x
  if (tid < BM) {
    const int m = m0 + tid;
    const int hw = m % (H * W);
    rows[tid] = make_int2(m < P ? m : -1, (hw / W) << 16 | (hw % W));
  }
  __syncthreads();

  // B chunks: rows b_row + j * B_STEP, columns b_col..+3; a chunk past
  // Cout is empty at every k.
  const int b_row = tid / B_ROW, b_col = (tid % B_ROW) * 4;
  const int b_k_end = n0 + b_col < Cout ? K : 0;

  auto copy_slice = [&](int kt, int stage) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      // k = kt*BK + 4q as (tap, channel): Cin % 8 == 0, so a chunk lies
      // in one tap.
      const int q = a_q + 4 * (i >> 1);
      const int kk = kt * BK + q * 4;
      const int a_tap = kk / Cin, a_c = kk - a_tap * Cin;
      float* as = As + stage * A_TILE + (a_row + 64 * (i & 1)) * AS + q * 4;
      const bool k_ok = a_tap < KS * KS;
      const int dy = KS == 3 ? a_tap / 3 - 1 : 0;
      const int dx = KS == 3 ? a_tap % 3 - 1 : 0;
      const int2 r = rows[a_row + 64 * (i & 1)];
      const int sy = (r.y >> 16) + dy, sx = (r.y & 0xffff) + dx;
      const bool ok = k_ok && r.x >= 0 &&
                      (KS == 1 || (sy >= 0 && sy < H && sx >= 0 && sx < W));
      const float* src =
          ok ? x + ((size_t)(r.x + dy * W + dx) * Cin + a_c) : x;
      cp_async16(as, src, ok);
    }
    float* bs = Bs + stage * B_TILE + b_row * BN + b_col;
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int k = kt * BK + b_row + j * B_STEP;
      const bool ok = k < b_k_end;
      const float* src = ok ? w + ((size_t)k * Cout + n0 + b_col) : w;
      cp_async16(bs + j * B_STEP * BN, src, ok);
    }
  };

  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt0 + s < kt1) copy_slice(kt0 + s, s);
    cp_async_commit();
  }
  int rd = 0, wr = STAGES - 1;
  for (int kt = kt0; kt < kt1; ++kt) {
    // Slice kt has landed, and every thread is done with slice kt - 1,
    // whose stage the next copy overwrites.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < kt1) copy_slice(kt + STAGES - 1, wr);
    cp_async_commit();
    wr = wr + 1 == STAGES ? 0 : wr + 1;
    const float* a = As + rd * A_TILE + ty * AS;
    const float* b = Bs + rd * B_TILE + tx * 4;
    rd = rd + 1 == STAGES ? 0 : rd + 1;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + i * 16 * AS + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(b + (k + kk) * BN + j * 64);
          bv[4 * j] = v.x;
          bv[4 * j + 1] = v.y;
          bv[4 * j + 2] = v.z;
          bv[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = kk == 0   ? av[i].x
                           : kk == 1 ? av[i].y
                           : kk == 2 ? av[i].z
                                     : av[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the trailing groups are empty

  // Epilogue: rows ty + 16 i, columns j*64 + tx*4..+3 (Cout % 4 == 0).
  float* part = ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * P * Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= P) continue;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int n = n0 + j * 64 + tx * 4;
      if (n >= Cout) continue;
      float4 v = make_float4(acc[i][4 * j], acc[i][4 * j + 1],
                             acc[i][4 * j + 2], acc[i][4 * j + 3]);
      const size_t o = (size_t)m * Cout + n;
      if (part != nullptr) {
        *reinterpret_cast<float4*>(part + o) = v;
        continue;
      }
      const float4 bv = *reinterpret_cast<const float4*>(bias + n);
      v.x += bv.x; v.y += bv.y; v.z += bv.z; v.w += bv.w;
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

// Split K, second pass: the partials of [splits, P, Cout] summed in split
// order, then + bias, + residual, ReLU, as the single-pass epilogue.
__global__ void splitk_epilogue(const float4* __restrict__ ws,
                                const float4* __restrict__ bias,
                                const float4* __restrict__ res,
                                float4* __restrict__ out, int splits,
                                long long n4, int cout4, int relu) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    float4 v = ws[i];
    for (int z = 1; z < splits; ++z) {
      const float4 p = ws[z * n4 + i];
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    const float4 bv = bias[i % cout4];
    v.x += bv.x; v.y += bv.y; v.z += bv.z; v.w += bv.w;
    if (res != nullptr) {
      const float4 r = res[i];
      v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
    }
    if (relu) {
      v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
    }
    out[i] = v;
  }
}

template <int BN, int KS>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   const float* res, float* out, float* ws, int H, int W,
                   int P, int Cin, int Cout, int relu, int splits,
                   int slices, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(
      conv_nhwc_kernel<BN, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv_nhwc_kernel<BN, KS>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((P + BM - 1) / BM, (Cout + BN - 1) / BN, splits);
  conv_nhwc_kernel<BN, KS><<<grid, NT, smem, stream>>>(
      x, w, bias, res, out, ws, H, W, P, Cin, Cout, relu, slices);
  return cudaGetLastError();
}

}  // namespace

// The wrapper guarantees Cin % 8 == 0, Cout % 4 == 0, H and W < 2^15,
// contiguous 16-byte-aligned tensors, and a plan (ops/fused_stage.py::conv_plan):
// tile width bn (64 or 128), `splits` ranges of `slices` BK-deep slices
// covering K with none empty, and, when splits > 1, a workspace `ws` of
// splits * P * Cout floats.
extern "C" int tao_conv_nhwc_f32(const void* x, const void* w,
                                 const void* bias, const void* res,
                                 void* out, void* ws, int T, int H, int W,
                                 int Cin, int Cout, int ks, int relu, int bn,
                                 int splits, int slices, void* stream) {
  const int P = T * H * W;
  const int nk = (ks * ks * Cin + BK - 1) / BK;
  if ((ks != 1 && ks != 3) || (bn != 64 && bn != 128) || splits < 1 ||
      slices < 1 || (long long)splits * slices < nk ||
      (long long)(splits - 1) * slices >= nk ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (P == 0 || Cout == 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto xf = (const float*)x;
  auto wf = (const float*)w;
  auto bf = (const float*)bias;
  auto rf = (const float*)res;
  auto of = (float*)out;
  auto wsf = splits > 1 ? (float*)ws : nullptr;
  cudaError_t e;
  if (bn == 64) {
    e = ks == 1 ? launch<64, 1>(xf, wf, bf, rf, of, wsf, H, W, P, Cin, Cout,
                                relu, splits, slices, s)
                : launch<64, 3>(xf, wf, bf, rf, of, wsf, H, W, P, Cin, Cout,
                                relu, splits, slices, s);
  } else {
    e = ks == 1 ? launch<128, 1>(xf, wf, bf, rf, of, wsf, H, W, P, Cin,
                                 Cout, relu, splits, slices, s)
                : launch<128, 3>(xf, wf, bf, rf, of, wsf, H, W, P, Cin,
                                 Cout, relu, splits, slices, s);
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long n4 = (long long)P * Cout / 4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  splitk_epilogue<<<blocks, 256, 0, s>>>(
      (const float4*)wsf, (const float4*)bf, (const float4*)rf,
      (float4*)of, splits, n4, Cout / 4, relu);
  return (int)cudaGetLastError();
}
