// The auction assignment's rounds, looped on the card: every round of
// one benefit matrix in one launch, stopping on the card.
//
// Replaces no Pallas kernel: it is the counterpart of the lax.while_loop
// of the JAX package's auction_assign (tao_amodal_tpu/ops/hungarian.py:96,
// its body :57-89, its cond :53-56), which SORT runs for the "auction"
// and "gated_auction" assignments.  Eager PyTorch cannot branch on the
// device, so the plain version (ops/hungarian.py::auction_assign_torch)
// checks for an active row on the host after each block of rounds, a
// host sync every few rounds; this kernel runs the rounds on the card,
// so a serving clip with an auction captures as one CUDA graph.
//
// tao_auction_rounds: benefit f32 [n, m] -> row_to_col i64 [n], -1
// unassigned, one block a matrix.  First JAX's shift (:43-47): entries
// above NEG / 2 are feasible (NaN is not), the feasible minimum, if
// finite, is clamped to at most 0 and subtracted from them, the others
// become NEG; a row with a feasible entry has an option.  The shifted b,
// the prices, the column owners and the rows' state live in shared
// memory.  A round, as JAX's body computes it, in f32 round-to-nearest
// intrinsics that nvcc never contracts:
//  1. every active row (unassigned, with a feasible entry, not retired),
//     a warp a row: value = b - price, its first maximal column, the
//     best and the largest of the other values (a top-2 per lane, then a
//     butterfly merge that keeps the first index on ties), second =
//     max(max(other, NEG), floor) (floor where m == 1), bid = (best -
//     second) + eps.  A row whose best is below floor retires; the others
//     bid with one 64-bit atomicMax on their column: the high word the
//     bid's bits in an order-preserving map, the low word ~row, so the
//     highest bid wins and a tie goes to the lowest row.  A bidder that
//     finds an earlier bid on its column marks the column contested by
//     several.  One barrier.
//  2. a thread a column: a won column evicts its owner, takes the
//     winner, and price += bid.  The rows left active after the round
//     are the evicted ones and the losers of columns bid on by several,
//     so the loop's condition (an active row, and fewer than max_iters
//     rounds) is one __syncthreads_or over the columns.  One barrier.
// The condition is tested before every round, as JAX's while_loop tests
// it, so the kernel stops where JAX stops, also when max_iters binds.
//
// Bound: latency, a chain of rounds of two block-wide barriers each (the
// auction takes 0 to hundreds of rounds a SORT frame, thousands in a
// price war at eps 5e-5); bytes, b in and row_to_col out once, are a few
// tens of KB.  The design keeps the whole problem in one block's shared
// memory and computes only the active rows' bids.
//
// The result is integers of the same inputs, equal to the plain
// version's bit for bit.  The minimum and every comparison are exact,
// and a zero's sign, where two paths may differ, changes no comparison
// and, with eps > 0, no bid.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int AUCTION_THREADS = 1024;
constexpr float NEG = -1e9f;
constexpr long long SMEM_LIMIT = 227LL * 1024;
constexpr unsigned FULL = 0xffffffffu;
// flags[i]: bit 0 the row has a feasible entry, bit 1 it retired.
constexpr uint8_t HAS = 1, RETIRED = 2;

// Order-preserving map of a float's bits onto unsigned (for finite and
// infinite values; -0 is mapped as +0 by the caller), and its inverse.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Merge another lane's (best, col, second) into this lane's: the best
// under (value descending, column ascending), and the largest value of
// every other column.
__device__ __forceinline__ void merge_top2(float& best, int& col,
                                           float& second, float ob, int oc,
                                           float os) {
  if (ob > best || (ob == best && oc < col)) {
    second = fmaxf(os, best);
    best = ob;
    col = oc;
  } else {
    second = fmaxf(second, ob);
  }
}

__host__ __device__ __forceinline__ long long auction_smem(int n, int m) {
  // win u64 [m] first (8-byte aligned), then b [n * m], price [m],
  // c2r [m], r2c [n], the warps' minima [32] (4 bytes each), multi [m]
  // and flags [n] (bytes).
  return 8LL * m + 4LL * n * m + 4LL * m + 4LL * m + 4LL * n + 4LL * 32 +
         m + n;
}

__global__ void __launch_bounds__(AUCTION_THREADS)
    auction_rounds_kernel(const float* __restrict__ b_in,
                          int64_t* __restrict__ row_to_col,
                          int* __restrict__ rounds_out, int n, int m,
                          float eps, float floor_, int max_iters) {
  extern __shared__ unsigned long long asmem[];
  unsigned long long* win = asmem;                      // [m] bid keys
  float* bs = reinterpret_cast<float*>(win + m);        // [n * m]
  float* price = bs + (size_t)n * m;                    // [m]
  int* c2r = reinterpret_cast<int*>(price + m);         // [m] owner row
  int* r2c = c2r + m;                                   // [n]
  float* wmin = reinterpret_cast<float*>(r2c + n);      // [32]
  uint8_t* multi = reinterpret_cast<uint8_t*>(wmin + 32);  // [m] >1 bidder
  uint8_t* flags = multi + m;                           // [n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;

  for (int j = tid; j < m; j += blockDim.x) {
    win[j] = 0ull;
    price[j] = 0.0f;
    c2r[j] = -1;
    multi[j] = 0;
  }
  for (int i = tid; i < n; i += blockDim.x) {
    r2c[i] = -1;
    flags[i] = 0;
  }
  __syncthreads();
  // The benefit into shared memory and its feasible minimum: a thread's,
  // a warp's, then the block's.
  const int nm = n * m;
  float mn = INFINITY;
  for (int e = tid; e < nm; e += blockDim.x) {
    const float x = b_in[e];
    bs[e] = x;
    if (x > NEG / 2) mn = fminf(mn, x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
  if (lane == 0) wmin[warp] = mn;
  __syncthreads();
  mn = wmin[0];
  for (int w = 1; w < nw; ++w) mn = fminf(mn, wmin[w]);
  // minb = where(isfinite(minb), minb.clamp_max(0), 0), then the shift.
  // A row with a feasible entry has an option; threads that find one
  // store the same byte.
  const float minb = isfinite(mn) ? (mn > 0.0f ? 0.0f : mn) : 0.0f;
  for (int e = tid; e < nm; e += blockDim.x) {
    const float x = bs[e];
    if (x > NEG / 2) {
      bs[e] = __fsub_rn(x, minb);
      flags[e / m] = HAS;
    } else {
      bs[e] = NEG;
    }
  }
  __syncthreads();
  int any = 0;
  for (int i = tid; i < n; i += blockDim.x) any |= flags[i] == HAS;
  any = __syncthreads_or(any);

  int it = 0;
  while (any && it < max_iters) {
    // 1. The active rows' bids, a warp a row.
    for (int i = warp; i < n; i += nw) {
      if (r2c[i] >= 0 || flags[i] != HAS) continue;  // warp-uniform
      const float* row = bs + (size_t)i * m;
      float best = -INFINITY, second = -INFINITY;
      int col = 0x7fffffff;
      for (int j = lane; j < m; j += 32) {
        const float v = __fsub_rn(row[j], price[j]);
        if (v > best) {
          second = best;
          best = v;
          col = j;
        } else {
          second = fmaxf(second, v);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off);
        const int oc = __shfl_xor_sync(FULL, col, off);
        const float os = __shfl_xor_sync(FULL, second, off);
        merge_top2(best, col, second, ob, oc, os);
      }
      if (lane == 0) {
        if (best < floor_) {
          flags[i] = HAS | RETIRED;
        } else {
          const float sec = fmaxf(fmaxf(second, NEG), floor_);
          float bid = __fadd_rn(__fsub_rn(best, sec), eps);
          if (bid == 0.0f) bid = 0.0f;  // -0 bids as +0
          const unsigned long long key =
              ((unsigned long long)ordered(bid) << 32) | (FULL - (unsigned)i);
          if (atomicMax(win + col, key) != 0ull) multi[col] = 1;
        }
      }
    }
    __syncthreads();
    // 2. The columns: winners in, owners out, prices up.
    int left = 0;
    for (int j = tid; j < m; j += blockDim.x) {
      const unsigned long long key = win[j];
      if (key == 0ull) continue;
      const int w = (int)(FULL - (unsigned)key);
      const int old = c2r[j];
      if (old >= 0) r2c[old] = -1;
      r2c[w] = j;
      c2r[j] = w;
      price[j] = __fadd_rn(price[j], unordered((unsigned)(key >> 32)));
      left |= old >= 0 || multi[j];
      win[j] = 0ull;
      multi[j] = 0;
    }
    ++it;
    any = __syncthreads_or(left);
  }
  for (int i = tid; i < n; i += blockDim.x) row_to_col[i] = r2c[i];
  if (tid == 0 && rounds_out != nullptr) *rounds_out = it;
}

}  // namespace

// Shared memory of the tao_auction_rounds block for b [n, m], or -1
// where it exceeds a block's.
extern "C" long long tao_auction_rounds_smem(int n, int m) {
  if (n < 1 || m < 1) return -1;
  const long long bytes = auction_smem(n, m);
  return bytes <= SMEM_LIMIT ? bytes : -1;
}

// The wrapper guarantees a contiguous f32 benefit [n, m], an i64
// row_to_col [n] and n, m >= 1 within tao_auction_rounds_smem; rounds
// (one int32, or null) receives the rounds run.
extern "C" int tao_auction_rounds(const void* b, void* row_to_col,
                                  void* rounds, int n, int m, float eps,
                                  float floor_, int max_iters,
                                  void* stream) {
  const long long smem = tao_auction_rounds_smem(n, m);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        auction_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // A warp a row up to the block's 32 warps, and at least a thread a
  // column where that takes more.
  int warps = n > (m + 31) / 32 ? n : (m + 31) / 32;
  if (warps > AUCTION_THREADS / 32) warps = AUCTION_THREADS / 32;
  auction_rounds_kernel<<<1, 32 * warps, (size_t)smem,
                          (cudaStream_t)stream>>>(
      (const float*)b, (int64_t*)row_to_col, (int*)rounds, n, m, eps, floor_,
      max_iters < 0 ? 0 : max_iters);
  return (int)cudaGetLastError();
}
