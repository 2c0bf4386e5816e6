// Hopper (sm_90a) implicit-GEMM convolutions on wgmma, NHWC: B4's bf16
// chain and the int8 trunk conv, and the int8 trunk's activation
// quantization.
//
// Replaces:
//   * the bf16 form of tao_amodal_tpu/ops/pallas/fused_stage.py:310
//     fused_bottleneck_chain (_chain_kernel:145), a stride-1 bottleneck
//     chain with BatchNorm folded, which the TPU kernel runs a row tile
//     at a time in VMEM (tao_chain_bf16_sm90; ops/fused_stage.py).  Per
//     block relu(1x1 + ba), relu(3x3 + b3), relu(1x1 + bb + residual),
//     every output rounded to bf16; the residual is the block's bf16
//     input or, at a chain's entry, the 1x1 projection (+ bd) kept in f32
//     (EPI_PROJ writes it, EPI_RES32 adds it).
//   * the XLA conv of tao_amodal_tpu/models/backbones.py:58 _int8_conv
//     (no Pallas kernel: PyTorch has no int8 convolution on CUDA) and its
//     activation scale and quantization (:72-76): tao_quantize_s8 and
//     tao_conv_s8_sm90 (ops/int8_conv.py).  int8 x int8 sums in int32,
//     then float(acc) * (s_x * s_w[c]), f32 or bf16 out; stride 1 or 2,
//     kernel 1, 3 or 7, padding (k - 1) / 2.
//
// Bounds on one H100 SXM (989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s):
// the four bf16 chains of the 384x512 trunk, T=8, are 178.8 GFLOP, 0.18
// ms of tensor-core peak, while the bytes they move through device
// memory as built (every conv's operands read once and its output
// written once: the intermediates a, h and the f32 projection included)
// take about twice that; the int8 trunk at 512^2, T=8 is 1.7e11
// multiply-adds (0.17 ms) against several GB of activations and f32
// outputs, bytes.  Both are bound by bytes where K is short (the 1x1s)
// and by the shared-memory feed where it is long (the 3x3s).
//
// Design (one kernel template, conv_wgmma_kernel<INT8, BN, KS, EPI>):
//   * M = output pixels in tiles of BM, N = Cout in tiles of BN = 64 or
//     128, K = KS*KS*Cin in slices of 128 bytes (64 bf16 or 128 int8),
//     each tile row one 128-byte swizzle row: chunk c of row r at chunk c
//     ^ (r & 7), the layout TMA's 128-byte swizzle writes and wgmma's
//     descriptors read.
//   * Tensor cores: wgmma.mma_async m64nBNk16 bf16 -> f32 and m64nBNk32
//     s8 -> s32, both operands K-major from shared memory (four k-steps a
//     slice, the descriptor's start advancing 32 bytes a step).  The
//     weights are [Cout, K] in device memory (k contiguous; the wrappers
//     lay them out once per set of weights), loaded by TMA
//     (cuTensorMapEncodeTiled, 128-byte swizzle, zero fill past K and
//     Cout).  A stride-1 1x1 conv's A is the plain [P, Cin] activation
//     matrix and loads by TMA too; any other conv's A is a gather with
//     zero fill (taps outside the frame, rows past P, k past K), by
//     16-byte cp.async into the same swizzle.
//   * Warp specialisation: one producer warpgroup keeps a ring of slices
//     full (thread 0 the TMA loads; every thread 8 or 4 rows of the
//     gather, each row's window corner computed once a tile, then one
//     cp.async.mbarrier.arrive), and the consumer warpgroups (each 64
//     rows of the tile) run wgmma as slices land, through a full and an
//     empty mbarrier per stage.  bf16: two consumers (BM = 128, 384
//     threads: each keeps an f32 sum and one k-group's products, 2 x
//     BN/2 registers), a 4-stage ring, one block an SM.  int8: one
//     consumer (BM = 64, 256 threads in <= 128 registers), a 3-stage ring
//     and about 107 KB, two blocks an SM, so that one block's epilogue
//     runs under the other's mainloop.
//   * Persistent: a block an SM slot walks work items (tile, K range),
//     the ring's phases counting on across them, so the producer loads
//     the next item while the consumers finish the last.
//   * Epilogue through shared memory: the fragments go to a C tile [BM]
//     [BN + 8] of 32-bit words beside the ring (8 banks past a multiple
//     of 32 a row: each half-warp's 8-byte stores cover the banks once),
//     and the consumers finish it 8 channels a thread: the bias or scale
//     loaded under the mainloop, the residual read 16 bytes at a time,
//     ReLU, rounding or dequantization, then 16-byte stores of whole
//     rows.
//   * Deep stages: split K, where the plans of ops/conv_sm90.py pick it
//     (the output tiles fill less than 90 % of the card's blocks: at
//     384x512, T=8 the chains' stage-3 3x3 in 2, stage 4's 1x1a in 2 and
//     3x3 in 4; the int8 trunk's stage-4 3x3s in 2).  An item sums a
//     contiguous range of slices into a workspace [splits, P, Cout] in
//     whole rows; the last to arrive of a tile's items (a counter per
//     tile) adds the partials in split order and finishes the tile:
//     deterministic, no second launch.  The counters live in one zeroed
//     buffer per device, which every kernel leaves zeroed: no memset a
//     conv.  Narrower tiles would cost a second pass over A per extra N
//     tile; a persistent walk alone cannot fill 132 SMs with stage 4's
//     48 tiles.
//
// Numerics.  int8: exact int32 sums in any order, split K included, so
// the conv equals its plain version bit for bit; the epilogue takes the
// scales from device memory and forms s_x * s_w[c] in f32, the product
// the plain version takes.  bf16: the tensor cores multiply bf16 exactly,
// but their f32 accumulation is not round-to-nearest (PERF.md, B8), so
// each k-group of `kgroup` k16-steps is chained from zero in the tensor
// core (scale-d = 0 on its first step) and added to the running sum with
// a round-to-nearest add.  The depth is the wrappers' choice (1, 2 or 4
// steps: 16, 32 or 64 of k); ops/conv_sm90.py::BF16_KGROUP says which and
// what the tolerance showed.  Epilogues use round-to-nearest intrinsics,
// never fused into FMAs, in the plain versions' order: (acc + b) +
// residual for bf16; __int2float_rn, __fmul_rn for the dequantization;
// __float2bfloat16_rn.
//
// Quantization (the int8 trunk's activation, NCHW f32 or bf16 in any
// strides -> NHWC int8 padded to Cp channels), one or two launches:
// amax_kernel writes one abs-max per block (exact in any order, no zeroed
// slot to keep; skipped for a static scale); the quantizing pass reduces
// them in every block, forms s_x = max(amax, 1e-8) / 127 (a true f32
// divide, as JAX op by op) or takes the static scale, writes s_x for the
// conv, and quantizes rintf(x / s_x) (half to even, as torch.round and
// jnp.round) clamped to [-127, 127]: a dense NHWC input with no channels
// to pad (the trunk's convs after the stem) as one flat array, anything
// else through a shared-memory tile of 32 pixels by 32 channels, so that
// both sides stay coalesced.  No host sync and no eager pass remain.
//
// With -DTAO_PROFILE (experiments/conv_sm90_profile.py) the conv adds
// its producer's and consumers' cycles by phase to device counters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int ROWB = 128;  // bytes of k per tile row and slice

// bf16: EPI_RELU (relu(acc + b (+ bf16 residual)) -> bf16), EPI_PROJ (acc +
// b -> f32), EPI_RES32 (relu(acc + b + f32 residual) -> bf16); int8:
// EPI_DQ_F32 / EPI_DQ_BF16 (float(acc) * (s_x * s_w[c]) -> f32 / bf16).
constexpr int EPI_RELU = 0, EPI_PROJ = 1, EPI_RES32 = 2, EPI_DQ_F32 = 3,
              EPI_DQ_BF16 = 4;

template <bool INT8>
struct Cfg;
template <>
struct Cfg<true> {
  using In = int8_t;
  using Acc = int;
};
template <>
struct Cfg<false> {
  using In = __nv_bfloat16;
  using Acc = float;
};

// Input frame [Hi, Wi] (a frame's first pixel at frame * Hi * Wi), output
// frame [Ho, Wo], stride, padding, channels and output pixels.
struct Geom {
  int Hi, Wi, Ho, Wo, stride, pad, Cin, Cout, P;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  // src-size 0 writes 16 zero bytes and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}


__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity` to complete.  A load that never lands
// (a fault, a byte count that does not match the box) traps after about
// 2^22 polls, seconds, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (unsigned polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}

// TMA: the box at (c0 = k, c1 = row) of `map` into shared memory at dst,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma's shared-memory matrix descriptor of a K-major operand in 128-byte
// swizzle: start address, leading byte offset 16 (unused by this layout),
// stride byte offset 1024 (eight 128-byte rows), swizzle mode 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads of the accumulators above the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_bf16_n64(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8_n64(int* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

template <int BN>
__device__ __forceinline__ void mma_step(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BN == 128)
    wgmma_bf16_n128(d, da, db, scale_d);
  else
    wgmma_bf16_n64(d, da, db, scale_d);
}
template <int BN>
__device__ __forceinline__ void mma_step(int* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BN == 128)
    wgmma_s8_n128(d, da, db, scale_d);
  else
    wgmma_s8_n64(d, da, db, scale_d);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// 32-bit accumulators as their bits, and back.
__device__ __forceinline__ int bits(float a) { return __float_as_int(a); }
__device__ __forceinline__ int bits(int a) { return a; }
__device__ __forceinline__ void set_bits(float& a, int w) {
  a = __int_as_float(w);
}
__device__ __forceinline__ void set_bits(int& a, int w) { a = w; }
// The split-K sum: exact for int32, round-to-nearest for f32.
__device__ __forceinline__ void add_bits(float& a, int w) {
  a = __fadd_rn(a, __int_as_float(w));
}
__device__ __forceinline__ void add_bits(int& a, int w) { a += w; }

// Eight 32-bit accumulators from or to shared or device memory, or
// added from another block's partials (read from L2, never L1).
template <typename Acc>
__device__ __forceinline__ void load8(const Acc* p, Acc* a) {
  const int4 u = reinterpret_cast<const int4*>(p)[0];
  const int4 v = reinterpret_cast<const int4*>(p)[1];
  const int w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) set_bits(a[i], w[i]);
}
template <typename Acc>
__device__ __forceinline__ void store8(Acc* p, const Acc* a) {
  reinterpret_cast<int4*>(p)[0] =
      make_int4(bits(a[0]), bits(a[1]), bits(a[2]), bits(a[3]));
  reinterpret_cast<int4*>(p)[1] =
      make_int4(bits(a[4]), bits(a[5]), bits(a[6]), bits(a[7]));
}
template <typename Acc>
__device__ __forceinline__ void add8_cg(const Acc* p, Acc* a) {
  const int4 u = __ldcg(reinterpret_cast<const int4*>(p));
  const int4 v = __ldcg(reinterpret_cast<const int4*>(p) + 1);
  const int w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) add_bits(a[i], w[i]);
}

__device__ __forceinline__ void store_bf16x8(void* p, const float* y) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store_f32x8(float* p, const float* y) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}

// The epilogue's per-thread channel vector: the bias (bf16) or the
// dequantization scale s_x * s_w[c] (int8) of channels n..n+7.
template <int EPI>
__device__ __forceinline__ void channel_vec(const float* __restrict__ vec,
                                            float sx, int n, float* cv) {
  if constexpr (EPI == EPI_DQ_F32 || EPI == EPI_DQ_BF16) {
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = __fmul_rn(sx, vec[n + i]);
  } else {
    const float4 b0 = reinterpret_cast<const float4*>(vec + n)[0];
    const float4 b1 = reinterpret_cast<const float4*>(vec + n)[1];
    cv[0] = b0.x, cv[1] = b0.y, cv[2] = b0.z, cv[3] = b0.w;
    cv[4] = b1.x, cv[5] = b1.y, cv[6] = b1.z, cv[7] = b1.w;
  }
}

// The epilogue of eight neighbouring channels n..n+7 of output pixel m:
// cv the bias (bf16) or the scale s_x * s_w (int8) of those channels.
template <int EPI, typename Acc>
__device__ __forceinline__ void finish8(const Acc* a, int m, int n,
                                        const Geom& g, const float* cv,
                                        const void* res_any, void* out_any) {
  const size_t o = (size_t)m * g.Cout + n;
  float y[8];
  if constexpr (EPI == EPI_DQ_F32 || EPI == EPI_DQ_BF16) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      y[i] = __fmul_rn(__int2float_rn((int)a[i]), cv[i]);
    if constexpr (EPI == EPI_DQ_F32)
      store_f32x8(static_cast<float*>(out_any) + o, y);
    else
      store_bf16x8(static_cast<__nv_bfloat16*>(out_any) + o, y);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = __fadd_rn((float)a[i], cv[i]);
    if constexpr (EPI == EPI_PROJ) {
      store_f32x8(static_cast<float*>(out_any) + o, y);
      return;
    }
    if constexpr (EPI == EPI_RES32) {
      const float* r = static_cast<const float*>(res_any) + o;
      const float4 r0 = reinterpret_cast<const float4*>(r)[0];
      const float4 r1 = reinterpret_cast<const float4*>(r)[1];
      const float rr[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = __fadd_rn(y[i], rr[i]);
    } else if (res_any != nullptr) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(res_any) + o);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[2 * i] = __fadd_rn(y[2 * i], __uint_as_float(w[i] << 16));
        y[2 * i + 1] =
            __fadd_rn(y[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u));
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = fmaxf(y[i], 0.f);
    store_bf16x8(static_cast<__nv_bfloat16*>(out_any) + o, y);
  }
}

// The shapes of a block, by operand type.  bf16: two consumer warpgroups
// (a 128-pixel tile; each thread keeps the f32 sum and one k-group's
// products, 2 x bn/2 registers) and one producer warpgroup, a 4-stage
// ring, one block an SM.  int8: one consumer warpgroup (a 64-pixel tile,
// bn/2 int32 accumulators) and one producer, a 3-stage ring, <= 128
// registers and about 107 KB a block: two blocks an SM, so that one's
// epilogue runs under the other's mainloop.
template <bool INT8>
struct Shape {
  static constexpr int CWG = INT8 ? 1 : 2;      // consumer warpgroups
  static constexpr int BM = 64 * CWG;           // output pixels a tile
  static constexpr int CT = 128 * CWG;          // consumer threads
  static constexpr int THREADS = CT + 128;      // and the producer's
  static constexpr int STAGES = INT8 ? 3 : 4;   // the ring of slices
  static constexpr int BLOCKS = INT8 ? 2 : 1;   // blocks an SM
};

template <bool INT8, int BN>
__host__ __device__ constexpr int smem_bytes() {
  // The ring, the C tile, and 1 KB to align the ring to the 1024-byte
  // swizzle pattern.
  return Shape<INT8>::STAGES * (Shape<INT8>::BM + BN) * ROWB +
         Shape<INT8>::BM * (BN + 8) * 4 + 1024;
}

#ifdef TAO_PROFILE
// Cycles of the producer's and the consumers' lead threads: producer
// waiting for a free stage, issuing loads; consumers waiting for a full
// stage, in wgmma, in the epilogue; slices, items.
__device__ unsigned long long tao_prof[8];
#define TAO_T0 long long t_ = clock64();
#define TAO_LAP(j)                                                    \
  {                                                                   \
    const long long n_ = clock64();                                   \
    if (lead) atomicAdd(&tao_prof[j], (unsigned long long)(n_ - t_)); \
    t_ = n_;                                                          \
  }
#else
#define TAO_T0
#define TAO_LAP(j)
#endif

// The consumer warpgroups' own barrier (the producer runs on).
template <int CT>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// One arrival on `bar` once every cp.async this thread has issued lands.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

template <bool INT8, int BN, int KS, int EPI>
__global__ void __launch_bounds__(Shape<INT8>::THREADS,
                                  Shape<INT8>::BLOCKS)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap amap,
                      const typename Cfg<INT8>::In* __restrict__ x,
                      const float* __restrict__ vec,
                      const float* __restrict__ sx_ptr,
                      const void* __restrict__ res_any,
                      void* __restrict__ out_any,
                      typename Cfg<INT8>::Acc* __restrict__ ws,
                      int* __restrict__ counters, Geom g, int splits,
                      int slices, int a_tma, int kgroup) {
  using In = typename Cfg<INT8>::In;
  using Acc = typename Cfg<INT8>::Acc;
  constexpr int VEC = 16 / (int)sizeof(In);   // channels per 16-byte chunk
  constexpr int BKE = ROWB / (int)sizeof(In); // k per slice
  constexpr int BM = Shape<INT8>::BM, CT = Shape<INT8>::CT;
  constexpr int STAGES = Shape<INT8>::STAGES;
  constexpr int A_BYTES = BM * ROWB, B_BYTES = BN * ROWB;
  constexpr int STAGE = A_BYTES + B_BYTES;
  constexpr int PRODUCERS = 128;
  constexpr int PSTEP = PRODUCERS / 8;        // rows between a thread's
  constexpr int PROWS = BM / PSTEP;           // A rows a producer fills
  constexpr int NACC = BN / 2;  // m64nBN accumulators of a thread
  constexpr int CS = BN + 8;    // C tile row stride, 32-bit words
  constexpr int V8 = BN / 8;    // 8-channel vectors of a tile row
  static_assert(CT % V8 == 0, "a thread's epilogue channels stay fixed");
  static_assert(INT8 ? (EPI == EPI_DQ_F32 || EPI == EPI_DQ_BF16)
                     : (EPI == EPI_RELU || EPI == EPI_PROJ ||
                        EPI == EPI_RES32),
                "int8: the dequantizing epilogues; bf16: the chain's");
  extern __shared__ unsigned char smem_raw[];
  // full: the slice has landed (TMA bytes, and the producer threads'
  // copies); empty: both consumer warpgroups are done with it.
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int last;

  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* const ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ring_s = smem_u32(ring);
  Acc* const ct = reinterpret_cast<Acc*>(ring + STAGES * STAGE);  // C tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int K = KS * KS * g.Cin;
  const int nk = (K + BKE - 1) / BKE;
  const int tiles_n = (g.Cout + BN - 1) / BN;
  const int items = (g.P + BM - 1) / BM * tiles_n * splits;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], a_tma ? 1 : PRODUCERS + 1);
      mbar_init(&empty[s], Shape<INT8>::CWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work items w = (m tile, n tile, K range), n fastest after the range:
  // neighbouring blocks share their A tile in L2.  The ring's slices
  // count on across items (it), so each stage's phases follow from it.
  if (tid >= CT) {
    // The producer: for each slice, once both consumers are done with its
    // stage, thread 0 asks TMA for the weights (and a stride-1 1x1's A);
    // otherwise every thread gathers PROWS chunks of A by cp.async (chunk
    // column a_c of rows a_r + PSTEP j), each row's window corner and frame
    // offset computed once per tile, taps outside the frame, rows past P
    // and k past K zero-filled.  It runs ahead into the next item while
    // the consumers finish the last one.
    const int pt = tid - CT, a_c = pt & 7, a_r = pt >> 3;
    const bool lead = pt == 0;
    TAO_T0
    int it = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int m0 = w / (tiles_n * splits) * BM;
      const int n0 = w / splits % tiles_n * BN, kt0 = w % splits * slices;
      const int ns = min(nk, kt0 + slices) - kt0;
      int pix[PROWS], cy[PROWS], cx[PROWS];
      if (!a_tma) {
#pragma unroll
        for (int j = 0; j < PROWS; ++j) {
          const int m = m0 + a_r + PSTEP * j;
          const int hw = m % (g.Ho * g.Wo);
          const int iy = (hw / g.Wo) * g.stride - g.pad;
          cx[j] = (hw % g.Wo) * g.stride - g.pad;
          pix[j] = (m / (g.Ho * g.Wo) * g.Hi + iy) * g.Wi + cx[j];
          cy[j] = m < g.P ? iy : -(1 << 20);  // past P: no tap in frame
        }
      }
      for (int i = 0; i < ns; ++i, ++it) {
        const int st = it % STAGES, kt = kt0 + i;
        TAO_LAP(7)
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        TAO_LAP(0)
        const uint32_t as = ring_s + st * STAGE, bs = as + A_BYTES;
        if (pt == 0) {
          mbar_expect_tx(&full[st], B_BYTES + (a_tma ? A_BYTES : 0));
          tma_load_2d(bs, &wmap, &full[st], kt * BKE, n0);
          if (a_tma) tma_load_2d(as, &amap, &full[st], kt * BKE, m0);
        }
        if (a_tma) continue;
        const int k = kt * BKE + a_c * VEC;
        const int tap = k / g.Cin, ch = k - tap * g.Cin;
        const int ky = tap / KS, kx = tap - (tap / KS) * KS;
        const int delta = (ky * g.Wi + kx) * g.Cin + ch;
#pragma unroll
        for (int j = 0; j < PROWS; ++j) {
          const int r = a_r + PSTEP * j;
          const bool ok = k < K &&
                          (unsigned)(cy[j] + ky) < (unsigned)g.Hi &&
                          (unsigned)(cx[j] + kx) < (unsigned)g.Wi;
          cp_async16(as + r * ROWB + ((a_c ^ (r & 7)) << 4),
                     ok ? x + ((long long)pix[j] * g.Cin + delta) : x, ok);
        }
        cp_async_arrive(&full[st]);
        TAO_LAP(1)
      }
    }
    return;
  }

  // The consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 of each
  // item's tile, then they finish the tile through the C tile, every
  // thread the same 8 channels (CT % V8 == 0) of rows tid / V8 + (CT /
  // V8) q.
  const int c = (tid % V8) * 8;
  const bool lead = tid == 0;
  TAO_T0
  int it = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int m0 = w / (tiles_n * splits) * BM;
    const int n0 = w / splits % tiles_n * BN, z = w % splits;
    const int kt0 = z * slices, ns = min(nk, kt0 + slices) - kt0;
    // The bias or scale of this thread's channels, loaded under the
    // mainloop.
    const bool cols = n0 + c < g.Cout;
    float cv[8];
    if (cols)
      channel_vec<EPI>(vec, (INT8 && sx_ptr != nullptr) ? *sx_ptr : 1.f,
                       n0 + c, cv);
    Acc acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0;
    float part[INT8 ? 1 : NACC];  // bf16: one k-group's products
#pragma unroll
    for (int i = 0; i < (INT8 ? 1 : NACC); ++i) part[i] = 0.f;
    for (int i = 0; i < ns; ++i, ++it) {
      const int st = it % STAGES;
      TAO_LAP(4)
      mbar_wait(&full[st], (it / STAGES) & 1);
      TAO_LAP(2)
      // The producer's copies, seen through the barrier, to the async
      // proxy that wgmma reads through.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t a_s = ring_s + st * STAGE + wg * 64 * ROWB;
      const uint32_t b_s = ring_s + st * STAGE + A_BYTES;
      if constexpr (INT8) {
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          mma_step<BN>(acc, sw128_desc(a_s + 32 * ks),
                       sw128_desc(b_s + 32 * ks), 1);
        wg_commit();
        wg_wait0();
        pin(acc);
      } else {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const bool first = (ks & (kgroup - 1)) == 0;
          if (first) wg_fence();
          mma_step<BN>(part, sw128_desc(a_s + 32 * ks),
                       sw128_desc(b_s + 32 * ks), first ? 0 : 1);
          if (((ks + 1) & (kgroup - 1)) == 0) {
            wg_commit();
            wg_wait0();
            pin(part);
#pragma unroll
            for (int j = 0; j < NACC; ++j)
              acc[j] = __fadd_rn(acc[j], part[j]);
          }
        }
      }
      if ((tid & 127) == 0) mbar_arrive(&empty[st]);
      TAO_LAP(3)
#ifdef TAO_PROFILE
      if (lead) atomicAdd(&tao_prof[5], 1ull);
#endif
    }
#ifdef TAO_PROFILE
    if (lead) atomicAdd(&tao_prof[6], 1ull);
#endif

    // The fragments to the C tile (once the last item's rows are read
    // out of it): accumulator 4j + 2h + e of a thread is row 16 * (warp %
    // 4) + lane / 4 + 8h of its warpgroup's 64, column 8j + 2 (lane % 4)
    // + e.
    consumers_sync<CT>();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
        store2(ct + r * CS + 8 * j + 2 * (lane & 3), acc[4 * j + 2 * h],
               acc[4 * j + 2 * h + 1]);
      }
    consumers_sync<CT>();
    if (splits == 1) {
      if (!cols) continue;
#pragma unroll 4
      for (int r = tid / V8; r < BM; r += CT / V8) {
        if (m0 + r >= g.P) break;
        Acc a8[8];
        load8(ct + r * CS + c, a8);
        finish8<EPI>(a8, m0 + r, n0 + c, g, cv, res_any, out_any);
      }
      continue;
    }
    // Split K: this range's partials to ws[z] in whole rows; the last
    // block of the tile to arrive sums all of them in split order and
    // finishes the tile.
    Acc* const mine = ws + (size_t)z * g.P * g.Cout;
    for (int r = tid / V8; cols && r < BM && m0 + r < g.P; r += CT / V8) {
      Acc a8[8];
      load8(ct + r * CS + c, a8);
      store8(mine + (size_t)(m0 + r) * g.Cout + n0 + c, a8);
    }
    __threadfence();
    consumers_sync<CT>();
    if (tid == 0) {
      int* const count = counters + w / splits;
      last = atomicAdd(count, 1) == splits - 1;
      if (last) *count = 0;  // zeroed again for the next conv
    }
    consumers_sync<CT>();
    if (!last) continue;
    __threadfence();
    for (int r = tid / V8; cols && r < BM && m0 + r < g.P; r += CT / V8) {
      const size_t o = (size_t)(m0 + r) * g.Cout + n0 + c;
      Acc a8[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a8[i] = 0;
      for (int zz = 0; zz < splits; ++zz)
        add8_cg(ws + (size_t)zz * g.P * g.Cout + o, a8);
      finish8<EPI>(a8, m0 + r, n0 + c, g, cv, res_any, out_any);
    }
  }
}

// ---------------------------------------------------------------------
// The int8 trunk's activation quantization.
// ---------------------------------------------------------------------

constexpr int QT = 256;             // threads of the quantization kernels
constexpr int AMAX_BLOCKS = 1024;   // at most this many partial maxima
constexpr int QUANT_BLOCKS = 1056;  // 8 an SM: every block reduces them

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The largest |x| of 16 bytes of values.
__device__ __forceinline__ float absmax16(uint4 u, float) {
  return fmaxf(fmaxf(fabsf(__uint_as_float(u.x)), fabsf(__uint_as_float(u.y))),
               fmaxf(fabsf(__uint_as_float(u.z)), fabsf(__uint_as_float(u.w))));
}
__device__ __forceinline__ float absmax16(uint4 u, __nv_bfloat16) {
  // A bf16's magnitude is the high half of an f32 with the sign cleared.
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m = fmaxf(m, fmaxf(__uint_as_float((w[i] << 16) & 0x7fffffffu),
                       __uint_as_float(w[i] & 0x7fff0000u)));
  return m;
}

// The block's maximum of each thread's v (v >= 0), in every thread.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < QT / 32; ++i) v = fmaxf(v, red[i]);
  return v;
}

// One partial abs-max a block over the n values of x, read as a flat
// array (the wrapper passes a dense tensor).
template <typename T>
__global__ void __launch_bounds__(QT)
    amax_kernel(const T* __restrict__ x, long long n,
                float* __restrict__ partials) {
  __shared__ float red[QT / 32];
  constexpr int V = 16 / (int)sizeof(T);
  const long long step = (long long)gridDim.x * QT;
  const long long first = (long long)blockIdx.x * QT + threadIdx.x;
  float m = 0.f;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
#pragma unroll 4
    for (long long i = first; i < n / V; i += step)
      m = fmaxf(m, absmax16(__ldg(xv + i), T()));
    done = n / V * V;
  }
  for (long long i = done + first; i < n; i += step)
    m = fmaxf(m, fabsf(to_f32(x[i])));
  m = block_max(m, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

// s_x in every thread: the static scale, or (n_partials > 0) max(max(
// partials), 1e-8) / 127, a true f32 divide; block 0 writes it to sx_out
// for the conv.
__device__ __forceinline__ float act_scale_of(const float* partials,
                                              int n_partials, float act_scale,
                                              float* sx_out, float* red) {
  float sx = act_scale;
  if (n_partials > 0) {
    float m = 0.f;
    for (int i = threadIdx.x; i < n_partials; i += QT)
      m = fmaxf(m, partials[i]);
    sx = __fdiv_rn(fmaxf(block_max(m, red), 1e-8f), 127.f);
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) *sx_out = sx;
  return sx;
}

__device__ __forceinline__ int8_t quantize1(float v, float sx) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
}

// The same values in the same order (an NHWC x whose channels need no
// padding): 16 bytes of x a thread at a time, to 4 (f32) or 8 (bf16)
// bytes of out; a grid-stride loop over n values.
template <typename T>
__global__ void __launch_bounds__(QT)
    quantize_flat_kernel(const T* __restrict__ x, long long n,
                         const float* __restrict__ partials, int n_partials,
                         float act_scale, float* __restrict__ sx_out,
                         int8_t* __restrict__ out) {
  __shared__ float red[QT / 32];
  const float sx =
      act_scale_of(partials, n_partials, act_scale, sx_out, red);
  constexpr int V = 16 / (int)sizeof(T);
  const long long step = (long long)gridDim.x * QT;
  const long long first = (long long)blockIdx.x * QT + threadIdx.x;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & (V - 1)) == 0) {
#pragma unroll 4
    for (long long i = first; i < n / V; i += step) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(x) + i);
      const T* v = reinterpret_cast<const T*>(&u);
      unsigned w[2] = {0, 0};  // the V bytes, little-endian
#pragma unroll
      for (int j = 0; j < V; ++j)
        w[j / 4] |= (unsigned)(uint8_t)quantize1(to_f32(v[j]), sx)
                    << (8 * (j % 4));
      if constexpr (V == 4)
        reinterpret_cast<unsigned*>(out)[i] = w[0];
      else
        reinterpret_cast<uint2*>(out)[i] = make_uint2(w[0], w[1]);
    }
    done = n / V * V;
  }
  for (long long i = done + first; i < n; i += step)
    out[i] = quantize1(to_f32(x[i]), sx);
}

// x [T, C, H, W] at element strides (sT, sC, sH, sW) -> out int8 [T, H, W,
// Cp] (channels C..Cp-1 zero).  A block quantizes tiles of 32 pixels of
// one row by 32 channels through shared memory, reading along w where the
// input is NCHW (sW == 1), along c otherwise, and writing 4 channels a
// thread; a grid-stride loop over the tiles.
template <typename T>
__global__ void __launch_bounds__(QT)
    quantize_kernel(const T* __restrict__ x,
                    const float* __restrict__ partials, int n_partials,
                    float act_scale, float* __restrict__ sx_out,
                    int8_t* __restrict__ out, int T_, int C, int H, int W,
                    long long sT, long long sC, long long sH, long long sW,
                    int Cp) {
  __shared__ float red[QT / 32];
  __shared__ __align__(16) int8_t tile[32][36];  // [pixel][channel]
  const float sx =
      act_scale_of(partials, n_partials, act_scale, sx_out, red);
  const int tid = threadIdx.x, lane = tid & 31, wrp = tid >> 5;
  const int ctiles = (Cp + 31) / 32, wtiles = (W + 31) / 32;
  const long long tiles = (long long)ctiles * wtiles * H * T_;
  const bool along_w = sW == 1 && sC != 1;
  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    const int c0 = (int)(b % ctiles) * 32;
    const int w0 = (int)(b / ctiles % wtiles) * 32;
    const long long th = b / ((long long)ctiles * wtiles);  // t * H + h
    const int h = (int)(th % H), t = (int)(th / H);
    const T* const src = x + t * sT + h * sH;
    __syncthreads();  // the previous tile's stores have read the tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = along_w ? lane : wrp + 8 * j;
      const int c = along_w ? wrp + 8 * j : lane;
      int8_t q = 0;
      if (c0 + c < C && w0 + p < W)
        q = quantize1(to_f32(src[(c0 + c) * sC + (w0 + p) * sW]), sx);
      tile[p][c] = q;
    }
    __syncthreads();
    const int p = tid >> 3, c = (tid & 7) * 4;
    if (w0 + p < W && c0 + c < Cp)
      *reinterpret_cast<char4*>(out + ((size_t)th * W + w0 + p) * Cp + c0 +
                                c) =
          *reinterpret_cast<const char4*>(&tile[p][c]);
  }
}

// ---------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Error codes of the entry points past CUDA's own: the tensor-map encoder
// is missing, or refused a map (TMA_REFUSED + its CUresult).
constexpr int NO_ENCODER = 1000, TMA_REFUSED = 1100;

// A row-major [rows, cols] matrix of esize-byte values, loaded in boxes
// of 128 bytes of columns by box_rows rows, 128-byte swizzled, zero fill
// past either edge.
int tile_map(CUtensorMap* map, const void* ptr, long long rows,
             long long cols, int esize, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * esize)};
  const cuuint32_t box[2] = {(cuuint32_t)(ROWB / esize),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      enc(map,
          esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
          2, const_cast<void*>(ptr), dims, strides, box, elem,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_REFUSED + (int)r;
}

template <bool INT8, int BN, int KS, int EPI>
cudaError_t launch(const CUtensorMap& wmap, const CUtensorMap& amap,
                   int a_tma, const void* x, const float* vec,
                   const float* sx, const void* res, void* out, void* ws,
                   int* counters, const Geom& g, int splits, int slices,
                   int kgroup, cudaStream_t stream) {
  using In = typename Cfg<INT8>::In;
  using Acc = typename Cfg<INT8>::Acc;
  constexpr int smem = smem_bytes<INT8, BN>();
  using S = Shape<INT8>;
  auto kernel = conv_wgmma_kernel<INT8, BN, KS, EPI>;
  // The attribute holds per device; setting it costs microseconds of
  // host time, so each device gets it once (a chain makes 40 launches).
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (e == cudaSuccess && !(ready.load() & bit)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) ready.fetch_or(bit);
  }
  if (e != cudaSuccess) return e;
  // One block an SM, each walking work items (tile, K range) in turn.
  static int sms[64] = {};
  if (sms[dev & 63] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev & 63], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  const long long items = (long long)((g.P + S::BM - 1) / S::BM) *
                          ((g.Cout + BN - 1) / BN) * splits;
  const long long slots = (long long)S::BLOCKS * sms[dev & 63];
  const int grid = (int)(items < slots ? items : slots);
  kernel<<<grid, S::THREADS, smem, stream>>>(
      wmap, amap, (const In*)x, vec, sx, res, out, (Acc*)ws, counters, g,
      splits, slices, a_tma, kgroup);
  return cudaGetLastError();
}

// One conv: x [T, Hi, Wi, Cin] (In), w [Cout, K] (k = (ky*ks + kx)*Cin +
// c, contiguous), vec f32 [Cout] (bf16: the bias; int8: s_w), sx the
// device s_x (int8; null: 1), res (EPI_RELU: bf16 [P, Cout] or null;
// EPI_RES32: f32 [P, Cout]), out [P, Cout].  The plan: tile width bn,
// `splits` ranges of `slices` 128-byte K slices covering K with none
// empty, and where splits > 1 a workspace of splits * P * Cout
// accumulators and one zeroed counter per output tile.
template <bool INT8>
int conv(const void* x, const void* w, const float* vec, const float* sx,
         const void* res, void* out, void* ws, int* counters, int epi,
         const Geom& g, int ks, int bn, int splits, int slices, int kgroup,
         cudaStream_t stream) {
  constexpr int ESZ = INT8 ? 1 : 2, VEC = 16 / ESZ, BKE = ROWB / ESZ;
  const long long K = (long long)ks * ks * g.Cin;
  const long long nk = (K + BKE - 1) / BKE;
  const bool ok = INT8 ? (ks == 1 || ks == 3 || ks == 7) &&
                             (epi == EPI_DQ_F32 || epi == EPI_DQ_BF16)
                       : (ks == 1 && (epi == EPI_RELU || epi == EPI_PROJ ||
                                      epi == EPI_RES32)) ||
                             (ks == 3 && epi == EPI_RELU);
  if (!ok || (bn != 64 && bn != 128) || g.Cin <= 0 || g.Cin % VEC ||
      g.Cout % (INT8 ? 16 : 8) || (g.stride != 1 && g.stride != 2) ||
      g.pad != (ks - 1) / 2 || g.Hi >= (1 << 15) || g.Wi >= (1 << 15) ||
      g.Ho != (g.Hi + 2 * g.pad - ks) / g.stride + 1 ||
      g.Wo != (g.Wi + 2 * g.pad - ks) / g.stride + 1 || splits < 1 ||
      slices < 1 || (long long)splits * slices < nk ||
      (long long)(splits - 1) * slices >= nk || (INT8 && kgroup != 0) ||
      (!INT8 && kgroup != 1 && kgroup != 2 && kgroup != 4) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (g.P <= 0 || g.Cout == 0) return (int)cudaGetLastError();
  CUtensorMap wmap{}, amap{};
  int err = tile_map(&wmap, w, g.Cout, K, ESZ, bn);
  // A stride-1 1x1 conv's A is the [P, Cin] matrix itself.
  const int a_tma = ks == 1 && g.stride == 1;
  if (err == 0 && a_tma)
    err = tile_map(&amap, x, g.P, g.Cin, ESZ, Shape<INT8>::BM);
  if (err != 0) return err;
  cudaError_t e;
#define TAO_LAUNCH(BN_, KS_, EPI_)                                          \
  launch<INT8, BN_, KS_, EPI_>(wmap, amap, a_tma, x, vec, sx, res, out, ws, \
                               counters, g, splits, slices, kgroup, stream)
#define TAO_BN(KS_, EPI_) \
  (bn == 64 ? TAO_LAUNCH(64, KS_, EPI_) : TAO_LAUNCH(128, KS_, EPI_))
  if constexpr (INT8) {
    const bool f32 = epi == EPI_DQ_F32;
    if (ks == 1)
      e = f32 ? TAO_BN(1, EPI_DQ_F32) : TAO_BN(1, EPI_DQ_BF16);
    else if (ks == 3)
      e = f32 ? TAO_BN(3, EPI_DQ_F32) : TAO_BN(3, EPI_DQ_BF16);
    else
      e = f32 ? TAO_BN(7, EPI_DQ_F32) : TAO_BN(7, EPI_DQ_BF16);
  } else {
    if (ks == 3)
      e = TAO_BN(3, EPI_RELU);
    else if (epi == EPI_PROJ)
      e = TAO_BN(1, EPI_PROJ);
    else if (epi == EPI_RES32)
      e = TAO_BN(1, EPI_RES32);
    else
      e = TAO_BN(1, EPI_RELU);
  }
#undef TAO_BN
#undef TAO_LAUNCH
  return (int)e;
}

}  // namespace

// B4's bf16 chain: `blocks` stride-1 bottlenecks, block 0 from Cin
// channels and every later one from 4M, each conv one launch on `stream`,
// all from one call.  Per block b: w[4b .. 4b+3] the bf16 [Cout, K]
// weights of its 1x1a, 3x3, 1x1b and projection (null where the block has
// none), bias[4b ..] their f32 biases (16-byte aligned), plans[12b ..]
// their (tile width, splits, slices).  Block b reads x (b = 0) or the
// previous block's output and writes outs[b % 2]; a and h [P, M] hold its
// first two outputs, res [P, 4M] f32 its projection.  kgroup: the k16-
// steps of one round-to-nearest group (1, 2 or 4).  The wrapper
// (ops/fused_stage.py) guarantees contiguous 16-byte-aligned tensors, Cin
// and M multiples of 8, and where a plan splits K a workspace of its
// splits * P * Cout floats and zeroed counters, one per output tile.
extern "C" int tao_chain_bf16_sm90(const void* x, const void* w,
                                   const void* bias, void* a, void* h,
                                   void* res, void* out0, void* out1,
                                   void* ws, void* counters,
                                   const void* plans, int blocks, int T,
                                   int H, int W, int Cin, int M, int kgroup,
                                   void* stream) {
  if (Cin % 8 || M % 8 || blocks < 1) return (int)cudaErrorInvalidValue;
  const auto* wp = static_cast<const void* const*>(w);
  const auto* bp = static_cast<const float* const*>(bias);
  const auto* pl = static_cast<const int*>(plans);
  void* const outs[2] = {out0, out1};
  auto* cn = static_cast<int*>(counters);
  auto s = static_cast<cudaStream_t>(stream);
  const void* cur = x;
  for (int b = 0; b < blocks; ++b) {
    const void* const* wb = wp + 4 * b;
    const float* const* bb = bp + 4 * b;
    const int* p = pl + 12 * b;
    const int cin = b == 0 ? Cin : 4 * M;
    const int P = T * H * W;
    auto geom = [&](int ci, int co, int ks) {
      return Geom{H, W, H, W, 1, (ks - 1) / 2, ci, co, P};
    };
    int e = conv<false>(cur, wb[0], bb[0], nullptr, nullptr, a, ws, cn,
                        EPI_RELU, geom(cin, M, 1), 1, p[0], p[1], p[2],
                        kgroup, s);
    if (e == 0)
      e = conv<false>(a, wb[1], bb[1], nullptr, nullptr, h, ws, cn, EPI_RELU,
                      geom(M, M, 3), 3, p[3], p[4], p[5], kgroup, s);
    if (e == 0 && wb[3] != nullptr) {
      if (res == nullptr) return (int)cudaErrorInvalidValue;
      e = conv<false>(cur, wb[3], bb[3], nullptr, nullptr, res, ws, cn,
                      EPI_PROJ, geom(cin, 4 * M, 1), 1, p[9], p[10], p[11],
                      kgroup, s);
      if (e == 0)
        e = conv<false>(h, wb[2], bb[2], nullptr, res, outs[b % 2], ws, cn,
                        EPI_RES32, geom(M, 4 * M, 1), 1, p[6], p[7], p[8],
                        kgroup, s);
    } else if (e == 0) {
      e = conv<false>(h, wb[2], bb[2], nullptr, cur, outs[b % 2], ws, cn,
                      EPI_RELU, geom(M, 4 * M, 1), 1, p[6], p[7], p[8],
                      kgroup, s);
    }
    if (e != 0) return e;
    cur = outs[b % 2];
  }
  return (int)cudaGetLastError();
}

// The int8 trunk conv: x int8 [T, Hi, Wi, Cin], w int8 [Cout, K], s_w f32
// [Cout], s_x a device f32 (null: 1, s_w is then the whole scale) -> out
// [T, Ho, Wo, Cout] f32 or bf16 (bf16_out), float(acc) * (s_x * s_w[c]);
// stride 1 or 2, ks 1, 3 or 7, padding (ks - 1) / 2.  The wrapper
// (ops/int8_conv.py) guarantees contiguous 16-byte-aligned tensors, Cin
// and Cout multiples of 16, a plan from ops/conv_sm90.py, and where it
// splits K a workspace of splits * P * Cout int32 and zeroed counters.
extern "C" int tao_conv_s8_sm90(const void* x, const void* w,
                                const void* s_w, const void* s_x, void* out,
                                void* ws, void* counters, int T, int Hi,
                                int Wi, int Cin, int Ho, int Wo, int Cout,
                                int ks, int stride, int bf16_out, int bn,
                                int splits, int slices, void* stream) {
  const Geom g{Hi, Wi, Ho, Wo, stride, (ks - 1) / 2, Cin, Cout, T * Ho * Wo};
  return conv<true>(x, w, static_cast<const float*>(s_w),
                    static_cast<const float*>(s_x), nullptr, out, ws,
                    static_cast<int*>(counters),
                    bf16_out ? EPI_DQ_BF16 : EPI_DQ_F32, g, ks, bn, splits,
                    slices, 0, static_cast<cudaStream_t>(stream));
}

// The int8 trunk's activation quantization, one or two launches: x f32
// or bf16 (bf16_in) [T, C, H, W] at element strides (sT, sC, sH, sW) ->
// out int8 [T, H, W, Cp] and s_x (one f32 on the device).  dynamic: s_x
// from the abs-max over every element (the wrapper passes a dense x and
// partials of AMAX_BLOCKS floats); else the static act_scale.
extern "C" int tao_quantize_s8(const void* x, int bf16_in, void* partials,
                               void* s_x, void* out, int T, int C, int H,
                               int W, long long sT, long long sC,
                               long long sH, long long sW, int Cp,
                               float act_scale, int dynamic, void* stream) {
  if (T < 1 || C < 1 || H < 1 || W < 1 || Cp < C || Cp % 4 ||
      (dynamic && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)T * C * H * W;
  int blocks = 0;
  if (dynamic) {
    const long long want = (n + QT * 16 - 1) / (QT * 16);
    blocks = (int)(want < AMAX_BLOCKS ? want : AMAX_BLOCKS);
    if (bf16_in)
      amax_kernel<<<blocks, QT, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), n,
          static_cast<float*>(partials));
    else
      amax_kernel<<<blocks, QT, 0, s>>>(static_cast<const float*>(x), n,
                                        static_cast<float*>(partials));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  auto* o = static_cast<int8_t*>(out);
  auto* sx = static_cast<float*>(s_x);
  auto* pt = static_cast<const float*>(partials);
  // An NHWC x (channels last, dense) with Cp == C is quantized as one
  // flat array.
  const bool flat = Cp == C && sC == 1 && sW == C && sH == (long long)W * C &&
                    sT == (long long)H * W * C;
  const long long work = flat ? (n + QT * 16 - 1) / (QT * 16)
                              : (long long)((Cp + 31) / 32) *
                                    ((W + 31) / 32) * H * T;
  const int grid = (int)(work < QUANT_BLOCKS ? work : QUANT_BLOCKS);
  if (flat && bf16_in)
    quantize_flat_kernel<<<grid, QT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, pt, blocks, act_scale, sx,
        o);
  else if (flat)
    quantize_flat_kernel<<<grid, QT, 0, s>>>(static_cast<const float*>(x), n,
                                             pt, blocks, act_scale, sx, o);
  else if (bf16_in)
    quantize_kernel<<<grid, QT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), pt, blocks, act_scale, sx, o,
        T, C, H, W, sT, sC, sH, sW, Cp);
  else
    quantize_kernel<<<grid, QT, 0, s>>>(static_cast<const float*>(x), pt,
                                        blocks, act_scale, sx, o, T, C, H, W,
                                        sT, sC, sH, sW, Cp);
  return (int)cudaGetLastError();
}

#ifdef TAO_PROFILE
extern "C" int tao_prof_read(void* host8) {
  const cudaError_t e = cudaMemcpyFromSymbol(host8, tao_prof, sizeof(tao_prof));
  static const unsigned long long zero[8] = {};
  cudaMemcpyToSymbol(tao_prof, zero, sizeof(zero));
  return (int)e;
}
#endif
