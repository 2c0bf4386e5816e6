// The convolutions of an identity-bottleneck stack in int8 or bf16, on
// the tensor cores, with BatchNorm folded into each epilogue; NHWC,
// stride 1, SAME zero padding.  One kernel launch per conv:
//
//   int8 (B7): x int8 [T, H, W, Cin], w int8 [Cout, K] (k contiguous,
//     k = (ky*KS + kx)*Cin + c of the HWIO weights), scale/bias f32
//     [Cout], res int8 [T, H, W, Cout] and res_scale f32 [1], or neither
//     -> out int8:
//       y = acc*scale + bias (+ res*res_scale); q = clip(rint(relu(y)),
//       0, 127)
//   bf16 (B8): x bf16, w bf16 [K, Cout] (the HWIO weights as they are),
//     scale/bias f32 [Cout], res bf16 or none -> out bf16:
//       y = acc*scale + bias (+ res); out = bf16_rn(relu(y))
//
// Replaces the TPU kernels tao_amodal_tpu/ops/pallas/resnet_blocks.py:154
// identity_blocks_pallas (_stack_kernel, B7) and :268
// identity_blocks_bf16_pallas (_bf16_stack_kernel, B8), which run a
// frame's whole stack in VMEM.  The Python wrappers (ops/resnet_blocks.py)
// make one call per stack (tao_identity_stack_s8 / _bf16), which
// launches the conv kernel three times per block: 1x1 C -> M, 3x3 M -> M,
// 1x1 M -> C with the residual.  The intermediates go through device
// memory in int8 or bf16, rounded where the reference rounds them, so the
// numbers match its own.
//
// Bound: the four ResNet-50 stage stacks at 512^2, T=8 are 109.5 G
// multiply-adds per clip, 0.11 ms of int8 or 0.22 ms of bf16 tensor-core
// peak, while the per-conv activation traffic is about 0.67 GB in int8
// (1.3 GB in bf16), 0.2-0.4 ms at 3.35 TB/s.  On the tensor cores the
// bytes, not the multiply-adds, set the floor; holding a block's three
// convs on chip is what lowers it, and is later work.  Design: implicit
// GEMM, M = T*H*W pixels by N = Cout, depth K = KS*KS*Cin.
//   * Tensor cores through mma.sync: m16n8k16 bf16 -> f32 for B8,
//     m16n8k32 s8 -> s32 for B7.  Fragments come from shared memory by
//     ldmatrix; B8's weights stay [K, Cout] and load by ldmatrix.trans,
//     B7's are [Cout, K] (ldmatrix has no .trans for 8-bit types;
//     tao_identity_stack_s8 transposes them first, transpose_s8_kernel,
//     one launch per stack), so A and B7's B share one tile layout.
//     wgmma would need its canonical swizzled layout and matrix
//     descriptors for an A that is a 3x3 gather with zero fill; mma.sync
//     takes the gather as it comes.  The move to wgmma is a later PR's
//     work, once this kernel is right.
//   * Operands stay narrow: a slice is 64 bytes of k per row (BK = 32
//     bf16 or 64 int8).  A is [BM pixels][64 bytes], four 16-byte chunks
//     a row, chunk c of row r stored at chunk c ^ ((r >> 1) & 3); B7's B
//     is [BN][64 bytes] the same way; B8's B is [32 k][BN] bf16, chunk c
//     of row k at c ^ (k & 7).  Every ldmatrix phase and every group of
//     eight 16-byte copies then covers the 32 banks once.
//   * Copies: 16-byte cp.async into a 4-stage ring in dynamic shared
//     memory, one barrier per slice.  Each chunk computes its own tap and
//     channel, so a slice may straddle two taps (Cin % 8 bf16, % 16
//     int8); taps outside the frame, rows past P, columns past Cout and k
//     past K are zero-filled by the copy itself.  The residual tile is
//     copied the same way at the start, while the mainloop runs.
//   * Tiles: 128 x 128 (eight warps of 64 x 32) or 128 x 64 where Cout <=
//     64 (32 x 32 a warp), 256 threads, two blocks an SM (<= 128
//     registers).
//   * Epilogue through shared memory: each thread finishes its C
//     fragments in place in the residual tile, then the block writes the
//     tile out in 16-byte chunks of whole rows.
//   * Split K: where the tiles cannot fill the card (the wrapper's plan,
//     ops/resnet_blocks.py::conv_plan), blockIdx.z sums a contiguous
//     range of slices into a workspace [splits, P, Cout] (int32 for B7:
//     exact in any order; f32 for B8), and the last block of a tile to
//     arrive (a counter per tile) adds the partials in split order and
//     finishes the tile: deterministic, no second launch.
// B4's bf16 form and the int8 trunk conv run on the wgmma conv of
// csrc/conv_sm90.cu.
//
// Numerics: int8 products accumulate exactly in int32 (|acc| <= 127^2 *
// 9 * 512 < 2^31).  The tensor cores multiply bf16 exactly, but their f32
// accumulation is not round-to-nearest: chained through the whole of K it
// drifted B8 two to three times further from the reference than the
// reference's own spread between summation orders (PERF.md, PR 5).  So
// each slice's two bf16 products are chained from zero in the tensor core
// and added to the running sum with a round-to-nearest add.  Epilogues
// use round-to-nearest intrinsics never fused into FMAs, in the
// reference's order: ((acc*s) + b) + x*rs for int8, ((acc*g) + b) + x for
// bf16; __int2float_rn for accumulators above 2^24, rintf (half to even,
// as jnp.round) and __float2bfloat16_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int BM = 128;      // pixels per tile
constexpr int ROW = 64;      // bytes of k per tile row and slice
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int NT = 256;      // threads: eight warps

template <bool INT8>
struct Types;
template <>
struct Types<true> {
  using In = int8_t;
  using Acc = int;
  using Acc2 = int2;
  using Acc4 = int4;
  using Res4 = char4;  // four channels of the residual
};
template <>
struct Types<false> {
  using In = __nv_bfloat16;
  using Acc = float;
  using Acc2 = float2;
  using Acc4 = float4;
  using Res4 = uint2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
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

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

// One 64-byte slice of k (two mma k-steps, fragments a[ks], b[ks]) into
// the accumulators c.  int8: m16n8k32 chained through the C operand,
// exact.  bf16: the slice's two m16n8k16 products chained from zero, then
// added to the running f32 sum with a round-to-nearest add; chained
// across the whole of K, the tensor cores' own accumulation drifts
// further from the reference (PERF.md, PR 5).
__device__ __forceinline__ void mma_slice(int* c, const unsigned (*a)[4],
                                          const unsigned* b0,
                                          const unsigned* b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%12,%13}, {%0,%1,%2,%3};\n"
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%8,%9,%10,%11}, {%14,%15}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]), "r"(b0[0]),
        "r"(b0[1]), "r"(b1[0]), "r"(b1[1]));
}

__device__ __forceinline__ void mma_slice(float* c, const unsigned (*a)[4],
                                          const unsigned* b0,
                                          const unsigned* b1) {
  asm volatile(
      "{\n.reg .f32 d<4>;\n"
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {d0,d1,d2,d3}, "
      "{%4,%5,%6,%7}, {%12,%13}, {%16,%16,%16,%16};\n"
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {d0,d1,d2,d3}, "
      "{%8,%9,%10,%11}, {%14,%15}, {d0,d1,d2,d3};\n"
      "add.rn.f32 %0, %0, d0;\nadd.rn.f32 %1, %1, d1;\n"
      "add.rn.f32 %2, %2, d2;\nadd.rn.f32 %3, %3, d3;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]), "r"(b0[0]),
        "r"(b0[1]), "r"(b1[0]), "r"(b1[1]), "f"(0.f));
}

// Byte offsets in a stage: A (and B7's B) rows of 64 bytes, B8's B rows
// of BN bf16.
__device__ __forceinline__ int row64(int r, int c) {
  return r * ROW + ((c ^ ((r >> 1) & 3)) << 4);
}
template <int BN>
__device__ __forceinline__ int krow(int k, int c) {
  return k * (BN * 2) + ((c ^ (k & 7)) << 4);
}

// acc*scale + bias, rounded at each step as the reference rounds.
__device__ __forceinline__ float scaled(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}
__device__ __forceinline__ float scaled(float acc, float s, float b) {
  return __fadd_rn(__fmul_rn(acc, s), b);
}

template <typename Acc4>
__device__ __forceinline__ float4 scaled4(Acc4 acc, const float* s,
                                          const float* b) {
  return make_float4(scaled(acc.x, s[0], b[0]), scaled(acc.y, s[1], b[1]),
                     scaled(acc.z, s[2], b[2]), scaled(acc.w, s[3], b[3]));
}

// + residual (int8: times its scale), in the reference's order.
__device__ __forceinline__ void add_res(float4& y, char4 r, float rs) {
  y.x = __fadd_rn(y.x, __fmul_rn((float)r.x, rs));
  y.y = __fadd_rn(y.y, __fmul_rn((float)r.y, rs));
  y.z = __fadd_rn(y.z, __fmul_rn((float)r.z, rs));
  y.w = __fadd_rn(y.w, __fmul_rn((float)r.w, rs));
}
__device__ __forceinline__ void add_res(float4& y, uint2 r, float) {
  y.x = __fadd_rn(y.x, __uint_as_float(r.x << 16));
  y.y = __fadd_rn(y.y, __uint_as_float(r.x & 0xffff0000u));
  y.z = __fadd_rn(y.z, __uint_as_float(r.y << 16));
  y.w = __fadd_rn(y.w, __uint_as_float(r.y & 0xffff0000u));
}

// ReLU, rounding and the store of four neighbouring channels.
__device__ __forceinline__ void store4(int8_t* out, float4 y) {
  *reinterpret_cast<char4*>(out) =
      make_char4((signed char)fminf(rintf(fmaxf(y.x, 0.f)), 127.f),
                 (signed char)fminf(rintf(fmaxf(y.y, 0.f)), 127.f),
                 (signed char)fminf(rintf(fmaxf(y.z, 0.f)), 127.f),
                 (signed char)fminf(rintf(fmaxf(y.w, 0.f)), 127.f));
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 y) {
  const __nv_bfloat162 h0 =
      __floats2bfloat162_rn(fmaxf(y.x, 0.f), fmaxf(y.y, 0.f));
  const __nv_bfloat162 h1 =
      __floats2bfloat162_rn(fmaxf(y.z, 0.f), fmaxf(y.w, 0.f));
  *reinterpret_cast<uint2*>(out) =
      make_uint2(*reinterpret_cast<const unsigned*>(&h0),
                 *reinterpret_cast<const unsigned*>(&h1));
}

// The same for two neighbouring channels, residual read from and output
// written to the shared-memory tile at t.
__device__ __forceinline__ void finish2(int8_t* t, bool res, float rs,
                                        float y0, float y1) {
  if (res) {
    const char2 r = *reinterpret_cast<const char2*>(t);
    y0 = __fadd_rn(y0, __fmul_rn((float)r.x, rs));
    y1 = __fadd_rn(y1, __fmul_rn((float)r.y, rs));
  }
  *reinterpret_cast<char2*>(t) =
      make_char2((signed char)fminf(rintf(fmaxf(y0, 0.f)), 127.f),
                 (signed char)fminf(rintf(fmaxf(y1, 0.f)), 127.f));
}
__device__ __forceinline__ void finish2(__nv_bfloat16* t, bool res, float,
                                        float y0, float y1) {
  if (res) {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(t);
    y0 = __fadd_rn(y0, __low2float(r));
    y1 = __fadd_rn(y1, __high2float(r));
  }
  *reinterpret_cast<__nv_bfloat162*>(t) =
      __floats2bfloat162_rn(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
}

// Dynamic shared memory: the ring of slices, and after the mainloop of a
// split the C tile [BM][BN + 8] of 32-bit partials in the same bytes (row
// stride 8 banks past a multiple of 32: each half-warp's 8-byte fragment
// stores cover the 32 banks once); then the residual tile, [BM] rows of
// BN channels and 16 bytes of padding (4 banks), which the epilogue
// overwrites with the output.
template <int BN>
__host__ __device__ constexpr int tile_bytes() {
  return STAGES * (BM + BN) * ROW > BM * (BN + 8) * 4
             ? STAGES * (BM + BN) * ROW
             : BM * (BN + 8) * 4;
}
template <bool INT8, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return tile_bytes<BN>() +
         BM * (BN * (int)sizeof(typename Types<INT8>::In) + 16);
}

template <bool INT8, int BN, int KS>
__global__ void __launch_bounds__(NT, 2)
conv_q_mma_kernel(const typename Types<INT8>::In* __restrict__ x,
                  const typename Types<INT8>::In* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const typename Types<INT8>::In* __restrict__ res,
                  const float* __restrict__ res_scale,
                  typename Types<INT8>::In* __restrict__ out,
                  typename Types<INT8>::Acc* __restrict__ ws,
                  int* __restrict__ counters, int H, int W, int P, int Cin,
                  int Cout, int slices) {
  using In = typename Types<INT8>::In;
  using Acc = typename Types<INT8>::Acc;
  using Acc4 = typename Types<INT8>::Acc4;
  using Res4 = typename Types<INT8>::Res4;
  constexpr int VEC = 16 / (int)sizeof(In);   // channels per chunk
  constexpr int BK = ROW / (int)sizeof(In);   // k per slice
  constexpr int WN = BN / 32;                 // warps along N
  constexpr int WM = 8 / WN;                  // warps along M
  constexpr int MT = BM / WM / 16;            // m16 tiles per warp
  constexpr int A_TILE = BM * ROW, STAGE = (BM + BN) * ROW;
  constexpr int B_PER = BN * ROW / 16 / NT;   // B chunks per thread
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int2 rows[BM];  // pixel (-1 past P), y << 16 | x

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K = KS * KS * Cin;
  const int nk = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * slices;
  const int kt1 = min(nk, kt0 + slices);

  if (tid < BM) {
    const int m = m0 + tid;
    const int hw = m % (H * W);
    rows[tid] = make_int2(m < P ? m : -1, (hw / W) << 16 | (hw % W));
  }
  // The residual tile, copied while the mainloop runs (its own group,
  // the oldest, so the first slice's wait covers it).
  constexpr int R_CH = BN * (int)sizeof(In) / 16;  // chunks of a tile row
  constexpr int R_ROW = R_CH * 16 + 16;            // padded row, bytes
  unsigned char* const rsm = smem + tile_bytes<BN>();
  if (res != nullptr) {
    for (int v = tid; v < BM * R_CH; v += NT) {
      const int r = v / R_CH, c = (v % R_CH) * VEC;
      const bool ok = m0 + r < P && n0 + c < Cout;
      cp_async16(rsm + r * R_ROW + c * (int)sizeof(In),
                 ok ? res + ((size_t)(m0 + r) * Cout + n0 + c) : res, ok);
    }
  }
  cp_async_commit();
  __syncthreads();

  // A chunks: chunk column a_c of rows a_r and a_r + 64.
  const int a_c = tid & 3, a_r = tid >> 2;
  auto copy_slice = [&](int kt, int stage) {
    unsigned char* as = smem + stage * STAGE;
    unsigned char* bs = as + A_TILE;
    const int k = kt * BK + a_c * VEC;
    const int tap = k / Cin, ch = k - tap * Cin;
    const int dy = KS == 3 ? tap / 3 - 1 : 0;
    const int dx = KS == 3 ? tap % 3 - 1 : 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = a_r + 64 * i;
      const int2 rw = rows[r];
      const int sy = (rw.y >> 16) + dy, sx = (rw.y & 0xffff) + dx;
      const bool ok =
          k < K && rw.x >= 0 &&
          (KS == 1 || (sy >= 0 && sy < H && sx >= 0 && sx < W));
      const In* src =
          ok ? x + ((size_t)(rw.x + dy * W + dx) * Cin + ch) : x;
      cp_async16(as + row64(r, a_c), src, ok);
    }
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int v = tid + j * NT;
      if constexpr (INT8) {  // [BN][64 bytes] of w [Cout, K]
        const int n = v >> 2, c = v & 3;
        const int kk = kt * BK + c * VEC;
        const bool ok = n0 + n < Cout && kk < K;
        cp_async16(bs + row64(n, c),
                   ok ? w + ((size_t)(n0 + n) * K + kk) : w, ok);
      } else {  // [32 k][BN] of w [K, Cout]
        const int kr = v / (BN / 8), c = v % (BN / 8);
        const int kk = kt * BK + kr;
        const bool ok = kk < K && n0 + c * 8 < Cout;
        cp_async16(bs + krow<BN>(kr, c),
                   ok ? w + ((size_t)kk * Cout + n0 + c * 8) : w, ok);
      }
    }
  };

  const int wm = warp / WN, wn = warp % WN;
  Acc acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt0 + s < kt1) copy_slice(kt0 + s, s);
    cp_async_commit();
  }
  int rd = 0, wr = STAGES - 1;
  for (int kt = kt0; kt < kt1; ++kt) {
    // Slice kt has landed, and every warp is done with slice kt - 1,
    // whose stage the next copy overwrites.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < kt1) copy_slice(kt + STAGES - 1, wr);
    cp_async_commit();
    wr = wr + 1 == STAGES ? 0 : wr + 1;
    const unsigned char* as = smem + rd * STAGE;
    const unsigned char* bs = as + A_TILE;
    rd = rd + 1 == STAGES ? 0 : rd + 1;
    // The slice's B fragments (both k-steps), then A's one m16 tile at a
    // time (fewer live registers).
    unsigned b[2][4][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // 32 bytes of k per mma
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // two n8 tiles per ldmatrix
        unsigned t[4];
        if constexpr (INT8) {
          const int n = wn * 32 + p * 16 + (lane & 7) + (lane >> 4) * 8;
          ldmatrix_x4<false>(t, bs + row64(n, 2 * ks + ((lane >> 3) & 1)));
        } else {
          const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4<true>(t, bs + krow<BN>(kr, wn * 4 + p * 2 +
                                                     (lane >> 4)));
        }
        b[ks][2 * p][0] = t[0];
        b[ks][2 * p][1] = t[1];
        b[ks][2 * p + 1][0] = t[2];
        b[ks][2 * p + 1][1] = t[3];
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      unsigned a[2][4];
      const int r = wm * MT * 16 + i * 16 + (lane & 15);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldmatrix_x4<false>(a[ks], as + row64(r, 2 * ks + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_slice(acc[i][j], a, b[0][j], b[1][j]);
    }
  }
  cp_async_wait<0>();  // the trailing groups are empty
  __syncthreads();     // and every warp is done with the ring

  const int g = lane >> 2, q = lane & 3;
  const float rs = (INT8 && res != nullptr) ? *res_scale : 0.f;
  if (gridDim.z == 1) {
    // Epilogue: each thread finishes its fragments (rows g and g + 8 of
    // each m16 tile, channels 2q and 2q + 1 of each n8 tile) in place in
    // the residual tile: acc*scale + bias, + residual, ReLU, rounding.
    // Then the block writes the tile out in 16-byte chunks of whole rows.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn * 32 + j * 8 + 2 * q;
      if (n0 + c >= Cout) continue;
      const float s0 = scale[n0 + c], s1 = scale[n0 + c + 1];
      const float b0 = bias[n0 + c], b1 = bias[n0 + c + 1];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * MT * 16 + i * 16 + g + 8 * h;
          finish2(reinterpret_cast<In*>(rsm + r * R_ROW) + c, res != nullptr,
                  rs, scaled(acc[i][j][2 * h], s0, b0),
                  scaled(acc[i][j][2 * h + 1], s1, b1));
        }
      }
    }
    __syncthreads();
    for (int v = tid; v < BM * R_CH; v += NT) {
      const int r = v / R_CH, c = (v % R_CH) * VEC;
      if (m0 + r < P && n0 + c < Cout)
        *reinterpret_cast<int4*>(out + (size_t)(m0 + r) * Cout + n0 + c) =
            *reinterpret_cast<const int4*>(rsm + r * R_ROW + (v % R_CH) * 16);
    }
    return;
  }

  // Split K: this range's partials go through the C tile in shared
  // memory to ws[z] in whole rows; the last block of the tile to arrive
  // sums all of them, in split order, and finishes the tile four
  // channels at a time.
  constexpr int CS = BN + 8;
  Acc* const ca = reinterpret_cast<Acc*>(smem);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = wn * 32 + j * 8 + 2 * q;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * MT * 16 + i * 16 + g + 8 * h;
        *reinterpret_cast<typename Types<INT8>::Acc2*>(ca + r * CS + c) = {
            acc[i][j][2 * h], acc[i][j][2 * h + 1]};
      }
    }
  }
  __syncthreads();
  Acc* const part = ws + (size_t)blockIdx.z * P * Cout;
#pragma unroll 4
  for (int v = tid; v < BM * BN / 4; v += NT) {
    const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
    if (m0 + r < P && n0 + c < Cout)
      *reinterpret_cast<Acc4*>(part + (size_t)(m0 + r) * Cout + n0 + c) =
          *reinterpret_cast<const Acc4*>(ca + r * CS + c);
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (tid == 0) {
    int* const count = counters + blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(count, 1) == (int)gridDim.z - 1;
    if (last) *count = 0;  // ready for the next conv
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll 4
  for (int v = tid; v < BM * BN / 4; v += NT) {
    const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
    if (m0 + r >= P || n0 + c >= Cout) continue;
    const size_t o = (size_t)(m0 + r) * Cout + n0 + c;
    Acc4 t = __ldcg(reinterpret_cast<const Acc4*>(ws + o));
    for (int z = 1; z < (int)gridDim.z; ++z) {
      const Acc4 d = __ldcg(
          reinterpret_cast<const Acc4*>(ws + (size_t)z * P * Cout + o));
      t.x += d.x;
      t.y += d.y;
      t.z += d.z;
      t.w += d.w;
    }
    float4 y = scaled4(t, scale + n0 + c, bias + n0 + c);
    if (res != nullptr)
      add_res(y,
              *reinterpret_cast<const Res4*>(rsm + r * R_ROW +
                                             c * (int)sizeof(In)),
              rs);
    store4(out + o, y);
  }
}

// 4 x 4 bytes: words a..d are rows 0..3; returns the columns as rows.
__device__ __forceinline__ void transpose4(unsigned& a, unsigned& b,
                                           unsigned& c, unsigned& d) {
  const unsigned t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(a, b, 0x7362);
  const unsigned t2 = __byte_perm(c, d, 0x5140), t3 = __byte_perm(c, d, 0x7362);
  a = __byte_perm(t0, t2, 0x5410);
  b = __byte_perm(t0, t2, 0x7632);
  c = __byte_perm(t1, t3, 0x5410);
  d = __byte_perm(t1, t3, 0x7632);
}

// B7's weight operands: int8 [N, R, C] -> [N, C, R] (R = K, C = Cout) for
// the stack's three weight tensors in one launch.  Each thread moves one
// 16 x 16-byte block: sixteen 16-byte loads along its rows (a warp reads
// 512 contiguous bytes of a row), the transpose in registers, sixteen
// 16-byte stores (R and C are multiples of 16).
struct Transposes {
  const int8_t* src[3];
  int8_t* dst[3];
  int rows[3], cols[3], blocks[3];  // blocks: N * R/16 * C/16
};

__global__ void __launch_bounds__(256) transpose_s8_kernel(Transposes t) {
  int b = blockIdx.x * blockDim.x + threadIdx.x, j = 0;
  while (j < 3 && b >= t.blocks[j]) b -= t.blocks[j++];
  if (j == 3) return;
  const int R = t.rows[j], C = t.cols[j];
  const int cb = C / 16, rb = R / 16;
  const int c0 = b % cb * 16, r0 = b / cb % rb * 16, n = b / (cb * rb);
  const int8_t* src = t.src[j] + (size_t)n * R * C + (size_t)r0 * C + c0;
  int8_t* dst = t.dst[j] + (size_t)n * R * C + (size_t)c0 * R + r0;
  unsigned w[16][4];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)r * C);
    w[r][0] = v.x;
    w[r][1] = v.y;
    w[r][2] = v.z;
    w[r][3] = v.w;
  }
  // Block (rows 4k.., columns 4q..) becomes (rows 4q.., columns 4k..).
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      transpose4(w[4 * k][q], w[4 * k + 1][q], w[4 * k + 2][q],
                 w[4 * k + 3][q]);
  // Output row c = 4q + e: column e of word q in each group of rows.
#pragma unroll
  for (int c = 0; c < 16; ++c)
    *reinterpret_cast<uint4*>(dst + (size_t)c * R) =
        make_uint4(w[c & 3][c >> 2], w[4 + (c & 3)][c >> 2],
                   w[8 + (c & 3)][c >> 2], w[12 + (c & 3)][c >> 2]);
}

template <bool INT8, int BN, int KS>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* bias, const void* res, const float* rs,
                   void* out, void* ws, int* counters, int H, int W, int P,
                   int Cin, int Cout, int splits, int slices,
                   cudaStream_t stream) {
  using In = typename Types<INT8>::In;
  using Acc = typename Types<INT8>::Acc;
  constexpr int smem = smem_bytes<INT8, BN>();
  auto kernel = conv_q_mma_kernel<INT8, BN, KS>;
  // The attributes hold per device; setting them costs microseconds of
  // host time, so each device gets them once (a stack makes 3N launches).
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (e == cudaSuccess && !(ready.load() & bit)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) ready.fetch_or(bit);
  }
  if (e != cudaSuccess) return e;
  const dim3 grid((P + BM - 1) / BM, (Cout + BN - 1) / BN, splits);
  kernel<<<grid, NT, smem, stream>>>((const In*)x, (const In*)w, scale,
                                     bias, (const In*)res, rs, (In*)out,
                                     (Acc*)ws, counters, H, W, P, Cin, Cout,
                                     slices);
  return cudaGetLastError();
}

// The wrappers guarantee contiguous 16-byte-aligned tensors, Cin and Cout
// multiples of 16 (int8) or 8 (bf16), ks in {1, 3}, and a plan
// (ops/resnet_blocks.py::conv_plan): tile width bn (64 or 128), `splits`
// ranges of `slices` 64-byte K slices covering K with none empty, and,
// when splits > 1, a workspace `ws` of splits * P * Cout accumulators and
// one zeroed int counter per output tile, which the kernel leaves zeroed.
template <bool INT8>
int conv(const void* x, const void* w, const void* scale, const void* bias,
         const void* res, const void* res_scale, void* out, void* ws,
         void* counters, int T, int H, int W, int Cin, int Cout, int ks,
         int bn, int splits, int slices, void* stream) {
  constexpr int VEC = INT8 ? 16 : 8;
  constexpr int BK = INT8 ? 64 : 32;
  const int nk = (ks * ks * Cin + BK - 1) / BK;
  if ((ks != 1 && ks != 3) || (bn != 64 && bn != 128) || Cin % VEC ||
      Cout % VEC || H >= (1 << 15) || W >= (1 << 15) || splits < 1 ||
      slices < 1 || (long long)splits * slices < nk ||
      (long long)(splits - 1) * slices >= nk ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int P = T * H * W;
  if (P == 0 || Cout == 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto sc = (const float*)scale;
  auto bi = (const float*)bias;
  auto rs = (const float*)res_scale;
  auto cn = (int*)counters;
  cudaError_t e;
  if (bn == 64) {
    e = ks == 1 ? launch<INT8, 64, 1>(x, w, sc, bi, res, rs, out, ws, cn, H,
                                      W, P, Cin, Cout, splits, slices, s)
                : launch<INT8, 64, 3>(x, w, sc, bi, res, rs, out, ws, cn, H,
                                      W, P, Cin, Cout, splits, slices, s);
  } else {
    e = ks == 1 ? launch<INT8, 128, 1>(x, w, sc, bi, res, rs, out, ws, cn, H,
                                       W, P, Cin, Cout, splits, slices, s)
                : launch<INT8, 128, 3>(x, w, sc, bi, res, rs, out, ws, cn, H,
                                       W, P, Cin, Cout, splits, slices, s);
  }
  return (int)e;
}

// An identity stack: N blocks of 1x1 C -> M, 3x3 M -> M and 1x1 M -> C
// with the residual, each conv one launch on `stream`, all from one call
// (per-conv calls from Python could not keep ahead of the card).  Block i
// reads x (i = 0) or outs[(i - 1) % 2], writes y1, y2 and outs[i % 2];
// its operands lie at fixed strides in the [N, ...] weights w[3] and
// vectors v[6] (scale, bias per conv) and res_scale [N] (int8).  plans:
// (tile width, splits, slices) of each of the three convs.  `tiles`
// counters are zeroed first where a conv splits K.
template <bool INT8>
int stack(const void* x, const void* const* w, const float* const* v,
          const float* res_scale, void* y1, void* y2, void* const* outs,
          void* ws, void* counters, int tiles, const int* plans, int N,
          int T, int H, int W, int C, int M, cudaStream_t stream) {
  using In = typename Types<INT8>::In;
  if (tiles > 0) {
    const cudaError_t e =
        cudaMemsetAsync(counters, 0, (size_t)tiles * sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t wn[3] = {(size_t)C * M, (size_t)9 * M * M, (size_t)M * C};
  const void* cur = x;
  for (int i = 0; i < N; ++i) {
    const In* const wi[3] = {(const In*)w[0] + i * wn[0],
                             (const In*)w[1] + i * wn[1],
                             (const In*)w[2] + i * wn[2]};
    int e = conv<INT8>(cur, wi[0], v[0] + (size_t)i * M, v[1] + (size_t)i * M,
                       nullptr, nullptr, y1, ws, counters, T, H, W, C, M, 1,
                       plans[0], plans[1], plans[2], stream);
    if (e == 0)
      e = conv<INT8>(y1, wi[1], v[2] + (size_t)i * M, v[3] + (size_t)i * M,
                     nullptr, nullptr, y2, ws, counters, T, H, W, M, M, 3,
                     plans[3], plans[4], plans[5], stream);
    if (e == 0)
      e = conv<INT8>(y2, wi[2], v[4] + (size_t)i * C, v[5] + (size_t)i * C,
                     cur, INT8 ? res_scale + i : nullptr, outs[i % 2], ws,
                     counters, T, H, W, M, C, 1, plans[6], plans[7],
                     plans[8], stream);
    if (e != 0) return e;
    cur = outs[i % 2];
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The wrappers guarantee contiguous 16-byte-aligned tensors, C and M
// multiples of 16 (int8) or 8 (bf16), plans from ops/resnet_blocks.py::
// conv_plan, and, where a plan splits K, a workspace of its splits * P *
// Cout accumulators and `tiles` int counters, one per output tile.  B7
// takes its weights as the JAX package lays them out, [N, K, Cout], and
// transposes them into wt (the three tensors back to back) first.
extern "C" int tao_identity_stack_s8(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* s1, const void* b1, const void* s2, const void* b2,
    const void* s3, const void* b3, const void* res_scale, void* y1,
    void* y2, void* out0, void* out1, void* ws, void* counters, void* wt,
    const void* plans, int N, int T, int H, int W, int C, int M, int tiles,
    void* stream) {
  if (res_scale == nullptr || wt == nullptr || C % 16 || M % 16)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  int8_t* const wt1 = (int8_t*)wt;
  int8_t* const wt2 = wt1 + (size_t)N * C * M;
  int8_t* const wt3 = wt2 + (size_t)N * 9 * M * M;
  Transposes t{{(const int8_t*)w1, (const int8_t*)w2, (const int8_t*)w3},
               {wt1, wt2, wt3},
               {C, 9 * M, M},
               {M, M, C},
               {N * (C / 16) * (M / 16), N * (9 * M / 16) * (M / 16),
                N * (M / 16) * (C / 16)}};
  const long long threads =
      (long long)t.blocks[0] + t.blocks[1] + t.blocks[2];
  if (threads > 0)
    transpose_s8_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(t);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const void* const w[3] = {wt1, wt2, wt3};
  const float* const v[6] = {(const float*)s1, (const float*)b1,
                             (const float*)s2, (const float*)b2,
                             (const float*)s3, (const float*)b3};
  void* const outs[2] = {out0, out1};
  return stack<true>(x, w, v, (const float*)res_scale, y1, y2, outs, ws,
                     counters, tiles, (const int*)plans, N, T, H, W, C, M,
                     s);
}

extern "C" int tao_identity_stack_bf16(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* g1, const void* b1, const void* g2, const void* b2,
    const void* g3, const void* b3, void* y1, void* y2, void* out0,
    void* out1, void* ws, void* counters, const void* plans, int N, int T,
    int H, int W, int C, int M, int tiles, void* stream) {
  const void* const w[3] = {w1, w2, w3};
  const float* const v[6] = {(const float*)g1, (const float*)b1,
                             (const float*)g2, (const float*)b2,
                             (const float*)g3, (const float*)b3};
  void* const outs[2] = {out0, out1};
  return stack<false>(x, w, v, nullptr, y1, y2, outs, ws, counters, tiles,
                      (const int*)plans, N, T, H, W, C, M,
                      (cudaStream_t)stream);
}
