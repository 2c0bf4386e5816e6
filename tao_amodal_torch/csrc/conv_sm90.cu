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
// strides -> NHWC int8 padded to Cp channels), one launch: s_x = max(
// amax, 1e-8) / 127 (a true f32 divide, as JAX op by op) or the static
// scale, written for the conv, and rintf(x / s_x) (half to even, as
// torch.round and jnp.round) clamped to [-127, 127].  Bound: bytes, each
// f32 read once and each int8 written once.  A dynamic scale needs every
// element before the first can be quantized, so a cooperative grid (the
// blocks the card holds at once) reads its slices, folds their maxima at
// one grid-wide barrier (in the call's own state, zeroed on its stream
// before the launch), and quantizes.  A dense NHWC input with
// no channels to pad (the trunk's convs after the stem) keeps what it
// read in shared memory, about 28 MB over 132 SMs, and
// rereads only the rest, in reverse so that the L2 serves its last lines;
// other layouts (the stem's 3 channels padded, an NCHW view) reread their
// slice in reverse from the L2, a pixel's output channels a thread.
// No host sync and no eager pass remain.
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

constexpr int QT = 256;          // threads of the pixel form
constexpr int QF_THREADS = 512;  // threads of the flat form, two blocks an SM
constexpr int QF_KEPT = 13;      // 16-byte vectors a thread keeps on chip
constexpr int QF_SMEM_BYTES = QF_KEPT * QF_THREADS * 16;  // 104 KB a block
constexpr int QF_BATCH = 4;      // loads a thread keeps in flight

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

// The block's maximum of each thread's v (v >= 0), in every thread; red
// holds a float a warp.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) v = fmaxf(v, red[i]);
  return v;
}

// The grid-wide barrier of a dynamic scale, in the call's own state:
// sx points at 4 device words, s_x and then a count, the abs-max bits
// and the published max(abs-max, 1e-8) bits, the last three zeroed on
// the launch's stream before it (a memset node in a CUDA graph, so each
// replay starts from zero).  The launch is cooperative, so every block
// is resident at once.  Each block's thread 0 folds its abs-max into
// the abs-max word (atomicMax on the bits: non-negative floats order as
// their bits) and arrives on the count; the last to arrive publishes
// the floored maximum, which is never zero, and writes s_x; the others
// spin on the published word, and trap after about 2^22 polls (seconds)
// rather than hang.
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// s_x in every thread of every block: the abs-max of each thread's m
// over the whole grid, then max(amax, 1e-8) / 127, a true f32 divide
// (JAX's op-by-op division).  The partial maxima are folded once, at
// the barrier.
__device__ __forceinline__ float grid_scale(float m, float* red, float* sx) {
  __shared__ float share;
  m = block_max(m, red);
  if (threadIdx.x == 0) {
    unsigned* count = reinterpret_cast<unsigned*>(sx + 1);
    unsigned* amax = count + 1;
    unsigned* published = count + 2;
    atomicMax(amax, __float_as_uint(m));
    __threadfence();
    unsigned top;
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      top = __float_as_uint(fmaxf(__uint_as_float(atomicOr(amax, 0u)), 1e-8f));
      *sx = __fdiv_rn(__uint_as_float(top), 127.f);
      __threadfence();
      asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(published), "r"(top)
                   : "memory");
    } else {
      for (unsigned polls = 0; (top = ld_acquire(published)) == 0u; ++polls)
        if (polls == (1u << 22)) __trap();
    }
    share = __fdiv_rn(__uint_as_float(top), 127.f);
  }
  __syncthreads();
  return share;
}

// The static scale, written once for the conv.
__device__ __forceinline__ float static_scale(float act_scale,
                                              float* sx_out) {
  if (threadIdx.x == 0 && blockIdx.x == 0) *sx_out = act_scale;
  return act_scale;
}

// The scale and its reciprocal: quantize1 multiplies by rcp and falls
// back to the true division only where the product could round otherwise.
struct Scale {
  float sx, rcp;
  bool fast;  // rcp normal and finite: the product's error bound holds
};

__device__ __forceinline__ Scale scale_of(float sx) {
  const float r = __frcp_rn(sx);
  return Scale{sx, r, r >= 1.17549435e-38f && r <= 3.40282347e38f};
}

// clamp(rint(v / sx), -127, 127) with v / sx the correctly rounded f32
// quotient (JAX's true division; ties to even), as one byte.  The
// division, the rounding and the conversions run on the SM's quarter-
// rate units, which bound the quantizing pass, so the quotient is taken
// as q = v * rcp (rcp = RN(1 / sx)), within 3 * 2^-24 * |v / sx| of it,
// under 2^-15 where |v / sx| <= 129; where q lies further than 2^-14 from
// every half-integer, both round alike, and beyond 128 both clamp.  q is
// clamped to [-128, 128] and rounded to nearest even by adding 1.5 *
// 2^23, whose bits then hold the integer: full-rate adds only.  The rest
// (about 1e-4 of values) divide truly.
__device__ __forceinline__ int quantize1(float v, const Scale& s) {
  constexpr float MAGIC = 12582912.f;  // 1.5 * 2^23
  const float c = fminf(fmaxf(__fmul_rn(v, s.rcp), -128.f), 128.f);
  const float t = __fadd_rn(c, MAGIC);
  if (s.fast && fabsf(__fsub_rn(c, __fsub_rn(t, MAGIC))) < 0.5f - 0x1p-14f) {
    const int i = __float_as_int(t) - __float_as_int(MAGIC);
    return min(max(i, -127), 127);
  }
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s.sx)), -127.f), 127.f);
}

// 16 bytes of x quantized to out's 4 (f32) or 8 (bf16) bytes at vector
// index v.
template <typename T>
__device__ __forceinline__ void put16(int8_t* out, long long v, uint4 u,
                                      const Scale& sx) {
  constexpr int V = 16 / (int)sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
  unsigned w[2] = {0, 0};  // the V bytes, little-endian
#pragma unroll
  for (int j = 0; j < V; ++j)
    w[j / 4] |= (unsigned)(quantize1(to_f32(e[j]), sx) & 0xff)
                << (8 * (j % 4));
  if constexpr (V == 4)
    reinterpret_cast<unsigned*>(out)[v] = w[0];
  else
    reinterpret_cast<uint2*>(out)[v] = make_uint2(w[0], w[1]);
}

// The flat form: a dense NHWC x with no channels to pad (every trunk
// conv after the stem), nv 16-byte vectors in out's order.  A persistent
// grid of two blocks an SM; block b owns the contiguous vectors [nv * b /
// G, nv * (b + 1) / G), thread t its vectors t, t + 512, ...  With a
// dynamic scale the first pass reads each vector once, QF_BATCH loads in
// flight a thread, and keeps a thread's first QF_KEPT in shared memory
// (about 28 MB over 132 SMs; read with an evict-first hint, so the L2
// keeps the rest); then one grid-wide barrier; then the second pass
// rereads the rest in reverse of its first read, so that the L2's most
// recent lines hit, and quantizes what was kept last.  A static scale is
// one streaming pass.
template <typename T>
__global__ void __launch_bounds__(QF_THREADS, 2)
    quantize_flat_kernel(const T* __restrict__ x, long long nv,
                         float act_scale, int dynamic,
                         float* __restrict__ sx_out,
                         int8_t* __restrict__ out) {
  extern __shared__ uint4 kept[];  // [QF_KEPT][QF_THREADS]
  __shared__ float red[QF_THREADS / 32];
  constexpr int NT = QF_THREADS, B = QF_BATCH;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const int tid = threadIdx.x;
  const long long lo = nv * blockIdx.x / gridDim.x;
  const long long hi = nv * (blockIdx.x + 1) / gridDim.x;
  const long long first = lo + tid;
  // This thread's vectors: first + k * NT for k < nk.
  const int nk = first < hi ? (int)((hi - first - 1) / NT + 1) : 0;
  auto at = [&](int k) { return first + (long long)k * NT; };
  if (!dynamic) {
    const Scale sx = scale_of(static_scale(act_scale, sx_out));
    for (int k0 = 0; k0 < nk; k0 += B) {
      uint4 u[B];
#pragma unroll
      for (int j = 0; j < B; ++j)
        if (k0 + j < nk) u[j] = __ldcs(xv + at(k0 + j));
#pragma unroll
      for (int j = 0; j < B; ++j)
        if (k0 + j < nk) put16<T>(out, at(k0 + j), u[j], sx);
    }
    return;
  }
  const int ns = nk < QF_KEPT ? nk : QF_KEPT;
  float m = 0.f;
  for (int k0 = 0; k0 < ns; k0 += B) {
    uint4 u[B];
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (k0 + j < ns) u[j] = __ldcs(xv + at(k0 + j));
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (k0 + j < ns) {
        kept[(k0 + j) * NT + tid] = u[j];
        m = fmaxf(m, absmax16(u[j], T()));
      }
  }
  for (int k0 = ns; k0 < nk; k0 += B) {
    uint4 u[B];
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (k0 + j < nk) u[j] = __ldg(xv + at(k0 + j));
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (k0 + j < nk) m = fmaxf(m, absmax16(u[j], T()));
  }
  const Scale sx = scale_of(grid_scale(m, red, sx_out));
  for (int k0 = nk - 1; k0 >= ns; k0 -= B) {
    uint4 u[B];
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (k0 - j >= ns) u[j] = __ldg(xv + at(k0 - j));
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (k0 - j >= ns) put16<T>(out, at(k0 - j), u[j], sx);
  }
#pragma unroll 4
  for (int k = 0; k < ns; ++k) put16<T>(out, at(k), kept[k * NT + tid], sx);
}

// The pixel form: any other x (the stem's NHWC view of 3 channels padded
// to 16, an NCHW tensor, a strided view).  An item is one pixel's 16
// channels of out (a chunk: 16 bytes, or its char4s where Cp is no
// multiple of 16), items in out's order, so a warp's stores are
// contiguous, and so are its loads of a channel where pixels are (NCHW)
// or of a pixel where channels are (NHWC); the pixel's offset is one
// multiply where its pixels are evenly spaced (the stem's), else three
// divisions.  Block b owns the contiguous items [items * b /
// G, items * (b + 1) / G); with a dynamic scale one pass reads them for
// the abs-max, one grid-wide barrier, and the second pass walks them in
// reverse, so that the L2 holds what it reads first (the stem's 25 MB
// fit).
template <typename T>
__global__ void __launch_bounds__(QT)
    quantize_pixel_kernel(const T* __restrict__ x, float act_scale,
                          int dynamic, float* __restrict__ sx_out,
                          int8_t* __restrict__ out, int T_, int C, int H,
                          int W, long long sT, long long sC, long long sH,
                          long long sW, int Cp) {
  __shared__ float red[QT / 32];
  const int chunks = (Cp + 15) / 16;
  const int items = T_ * H * W * chunks;  // the host keeps it below 2^31
  const int lo = (int)((long long)items * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)items * (blockIdx.x + 1) / gridDim.x);
  const bool even = sH == (long long)W * sW && sT == (long long)H * sH;
  // Item i: its pixel's first value and out offset, and its channel c0.
  auto at = [&](int i, const T*& src, long long& dst, int& c0) {
    const int pix = chunks == 1 ? i : i / chunks;
    c0 = (i - pix * chunks) * 16;
    if (even) {
      src = x + pix * sW;
    } else {
      const int w = pix % W, th = pix / W;
      src = x + th / H * sT + th % H * sH + w * sW;
    }
    dst = (long long)pix * Cp + c0;
  };
  float s;
  if (dynamic) {
    float m = 0.f;
#pragma unroll 4
    for (int i = lo + threadIdx.x; i < hi; i += QT) {
      const T* src;
      long long dst;
      int c0;
      at(i, src, dst, c0);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (c0 + j < C) m = fmaxf(m, fabsf(to_f32(src[(c0 + j) * sC])));
    }
    s = grid_scale(m, red, sx_out);
  } else {
    s = static_scale(act_scale, sx_out);
  }
  const Scale sx = scale_of(s);
  const int n = hi - lo - (int)threadIdx.x;  // this thread's items, last
#pragma unroll 4
  for (int i = n > 0 ? lo + threadIdx.x + (n - 1) / QT * QT : lo - 1;
       i >= lo; i -= QT) {
    const T* src;
    long long dst;
    int c0;
    at(i, src, dst, c0);
    unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (c0 + j < C)
        w[j / 4] |= (unsigned)(quantize1(to_f32(src[(c0 + j) * sC]), sx) &
                               0xff)
                    << (8 * (j % 4));
    if (Cp % 16 == 0) {
      *reinterpret_cast<uint4*>(out + dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int j = 0; j < 4 && c0 + 4 * j < Cp; ++j)
        reinterpret_cast<unsigned*>(out + dst)[j] = w[j];
    }
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

// Blocks of a quantization kernel that the device holds at once (its
// occupancy at `smem` dynamic bytes times the SMs), with the kernel's
// shared-memory attribute set where it passes 48 KB: once per device,
// in the caller's per-kernel cache.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem,
                            int* cache, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int& slots = cache[dev & 63];
  if (slots == 0) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots = per_sm * sms;
  }
  *blocks = slots;
  return cudaSuccess;
}

// A quantization kernel on `grid` blocks: cooperative where it holds the
// grid-wide barrier (dynamic), after zeroing the barrier's state.
template <typename... Params, typename... Args>
cudaError_t launch_quantize(void (*kernel)(Params...), int grid, int threads,
                            int smem, int dynamic, float* sx, cudaStream_t s,
                            Args... args) {
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &coop;
  cfg.numAttrs = dynamic ? 1 : 0;
  if (dynamic) {
    const cudaError_t e = cudaMemsetAsync(sx + 1, 0, 3 * sizeof(float), s);
    if (e != cudaSuccess) return e;
  }
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
int quantize_s8(const T* x, float* sx, int8_t* o, int T_, int C, int H,
                int W, long long sT, long long sC, long long sH,
                long long sW, int Cp, float act_scale, int dynamic,
                cudaStream_t s) {
  static int flat_slots[64] = {}, pixel_slots[64] = {};
  const long long n = (long long)T_ * C * H * W;
  constexpr int V = 16 / (int)sizeof(T);
  int slots = 0;
  cudaError_t e;
  if (Cp == C && sC == 1 && sW == C && sH == (long long)W * C &&
      sT == (long long)H * W * C && n % V == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    e = resident_blocks(quantize_flat_kernel<T>, QF_THREADS, QF_SMEM_BYTES,
                        flat_slots, &slots);
    if (e != cudaSuccess) return (int)e;
    const long long nv = n / V;
    const long long want = (nv + QF_THREADS - 1) / QF_THREADS;
    const int grid = (int)(want < slots ? want : slots);
    e = launch_quantize(quantize_flat_kernel<T>, grid, QF_THREADS,
                        QF_SMEM_BYTES, dynamic, sx, s, x, nv, act_scale,
                        dynamic, sx, o);
  } else {
    const long long items = (long long)T_ * H * W * ((Cp + 15) / 16);
    if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    e = resident_blocks(quantize_pixel_kernel<T>, QT, 0, pixel_slots,
                        &slots);
    if (e != cudaSuccess) return (int)e;
    const long long want = (items + QT - 1) / QT;
    const int grid = (int)(want < slots ? want : slots);
    e = launch_quantize(quantize_pixel_kernel<T>, grid, QT, 0, dynamic, sx,
                        s, x, act_scale, dynamic, sx, o, T_, C, H, W, sT, sC,
                        sH, sW, Cp);
  }
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
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

// The int8 trunk's activation quantization in one launch: x f32 or bf16
// (bf16_in) [T, C, H, W] at element strides (sT, sC, sH, sW) -> out int8
// [T, H, W, Cp] (channels C..Cp-1 zero) and s_x: the abs-max over every
// element, a grid-wide barrier and the quantizing pass where dynamic,
// else the static act_scale.  s_x points at 4 f32 words on the device,
// 16-byte aligned: s_x, then the barrier's state, which this call zeroes
// on `stream` before a dynamic launch.  A dense NHWC x with Cp == C runs
// the flat form, any other the pixel form.
extern "C" int tao_quantize_s8(const void* x, int bf16_in, void* s_x,
                               void* out, int T, int C, int H, int W,
                               long long sT, long long sC, long long sH,
                               long long sW, int Cp, float act_scale,
                               int dynamic, void* stream) {
  if (T < 1 || C < 1 || H < 1 || W < 1 || Cp < C || Cp % 4)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int8_t*>(out);
  auto* sx = static_cast<float*>(s_x);
  if (bf16_in)
    return quantize_s8(static_cast<const __nv_bfloat16*>(x), sx, o, T, C, H,
                       W, sT, sC, sH, sW, Cp, act_scale, dynamic, s);
  return quantize_s8(static_cast<const float*>(x), sx, o, T, C, H, W, sT, sC,
                     sH, sW, Cp, act_scale, dynamic, s);
}

// Bytes the flat form can keep on chip between its passes over the
// current device (its resident blocks times a block's shared memory), or
// minus a CUDA error.
extern "C" long long tao_quantize_s8_kept_bytes(int bf16_in) {
  static int f32_slots[64] = {}, bf16_slots[64] = {};
  int slots = 0;
  const cudaError_t e =
      bf16_in ? resident_blocks(quantize_flat_kernel<__nv_bfloat16>,
                                QF_THREADS, QF_SMEM_BYTES, bf16_slots, &slots)
              : resident_blocks(quantize_flat_kernel<float>, QF_THREADS,
                                QF_SMEM_BYTES, f32_slots, &slots);
  return e != cudaSuccess ? -(long long)e : (long long)slots * QF_SMEM_BYTES;
}

#ifdef TAO_PROFILE
extern "C" int tao_prof_read(void* host8) {
  const cudaError_t e = cudaMemcpyFromSymbol(host8, tao_prof, sizeof(tao_prof));
  static const unsigned long long zero[8] = {};
  cudaMemcpyToSymbol(tao_prof, zero, sizeof(zero));
  return (int)e;
}
#endif
