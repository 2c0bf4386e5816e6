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
// unassigned, one block a matrix.  JAX's shift (:43-47): entries above
// NEG / 2 are feasible (NaN is not), the feasible minimum, if finite, is
// clamped to at most 0 and subtracted from them, the others become NEG;
// the shift is applied where an entry is read.  The benefit lies in
// shared memory where it fits (in_smem), else it is read where it lies
// (in L2 at SORT's sizes); the prices, the column owners, the bid keys,
// the rows' assignments and two lists of active rows live in shared
// memory.
//
// A round, as JAX's body computes it, in f32 round-to-nearest intrinsics
// that nvcc never contracts, over the list of active rows (the rows with
// a feasible entry at first, then the losers and the evicted owners of
// the previous round):
//  1. a warp an active row: value = b - price, its first maximal column,
//     the best and the largest of the other values (a top-2 per lane,
//     then warp reductions of the values' ordered bits), second =
//     max(max(other, NEG), floor) (floor where m == 1), bid = (best -
//     second) + eps.  A row whose best is below floor retires (it leaves
//     the lists for good); the others bid with one 64-bit atomicMax on
//     their column (the high word the bid's bits in an order-preserving
//     map, the low word ~row, so the highest bid wins and a tie goes to
//     the lowest row).  One barrier.
//  2. a thread an active row: the winner of a column evicts its owner,
//     takes the column and raises its price by the bid; the evicted owner
//     and each loser join the next round's list (one atomic a warp).
//     Only the columns bid on are visited.  One barrier; the list's
//     count is the loop's condition.
// The active count never rises (each evicted owner stands for a distinct
// winning bidder), so once it is 1 it stays at most 1: warp 0 then runs
// every remaining round alone (the row's top-2, its bid, its column's
// update by the lane that reads that column, the evicted owner the next
// row), without block barriers.  JAX's cond is tested before every
// round, so the kernel stops where JAX stops, also when max_iters binds.
//
// Bound: latency, a chain of dependent rounds (0 to hundreds a SORT
// frame, thousands in a price war at eps 5e-5), each at least one row's
// top-2 over m columns and one column update; bytes, b in and row_to_col
// out once, are a few hundred KB at most.
//
// The result is integers of the same inputs, equal to the plain
// version's bit for bit.  The minimum and every comparison are exact
// (the reductions compare ordered bits, -0 taken as +0), and a zero's
// sign, where two paths may differ, changes no comparison and, with eps
// > 0, no bid.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr float NEG = -1e9f;
constexpr long long SMEM_LIMIT = 227LL * 1024;
constexpr unsigned FULL = 0xffffffffu;

// Order-preserving map of a float's bits onto unsigned (for finite and
// infinite values; -0 is mapped as +0 by the caller), and its inverse.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Row i's best value, its first column and the largest other value, in
// every lane of the warp.  src is the unshifted benefit (shared or
// global memory); the shift is applied here.  Each lane keeps the top-2
// of its columns, read from shared memory four at a time, from L2 in a
// loop unrolled by eight (the faster of the forms tried on the H100);
// the warp then reduces the best value's ordered bits, and next, at
// once, the lowest column that holds it and the largest of every other
// lane's best and of the holders' seconds (the best itself where two
// lanes hold it).
template <bool kSmem>
__device__ __forceinline__ void row_top2(const float* src, const float* price,
                                         int i, int m, float minb, int lane,
                                         float& best, int& col,
                                         float& second) {
  const float* row = src + (size_t)i * m;
  float b1 = -INFINITY, b2 = -INFINITY;
  int c1 = 0x7fffffff;
  auto take = [&](float v, int j) {
    if (v > b1) {
      b2 = b1;
      b1 = v;
      c1 = j;
    } else {
      b2 = fmaxf(b2, v);
    }
  };
  auto value = [&](float x, float p) {
    return __fsub_rn(x > NEG / 2 ? __fsub_rn(x, minb) : NEG, p);
  };
  if (kSmem) {
    constexpr int CH = 4;
    for (int base = lane; base < m; base += 32 * CH) {
      float v[CH];
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int j = base + 32 * u;
        v[u] = j < m ? value(row[j], price[j]) : -INFINITY;  // below all
      }
#pragma unroll
      for (int u = 0; u < CH; ++u) take(v[u], base + 32 * u);
    }
  } else {
#pragma unroll 8
    for (int j = lane; j < m; j += 32) take(value(row[j], price[j]), j);
  }
  const unsigned k1 = ordered(__fadd_rn(b1, 0.0f));
  const unsigned top = __reduce_max_sync(FULL, k1);
  const bool holds = k1 == top;
  col = __reduce_min_sync(FULL, holds ? c1 : 0x7fffffff);
  const unsigned k2 =
      __reduce_max_sync(FULL, ordered(__fadd_rn(holds ? b2 : b1, 0.0f)));
  best = unordered(top);
  second = __popc(__ballot_sync(FULL, holds)) > 1 ? best : unordered(k2);
}

// The bid of a row whose best is at least floor; -0 bids as +0.
__device__ __forceinline__ float row_bid(float best, float second, float eps,
                                         float floor_) {
  const float sec = fmaxf(fmaxf(second, NEG), floor_);
  const float bid = __fadd_rn(__fsub_rn(best, sec), eps);
  return bid == 0.0f ? 0.0f : bid;
}

// Shared memory of the block: win u64 [m] first (8-byte aligned), then
// price [m], c2r [m], r2c [n], the active lists [2][n], the warps'
// minima [32] and the counts [2] (4 bytes each), and with in_smem the
// benefit [n * m].
__host__ __device__ __forceinline__ long long auction_smem(int n, int m,
                                                           int in_smem) {
  return 16LL * m + 12LL * n + 4LL * (32 + 2) +
         (in_smem ? 4LL * n * m : 0);
}

// Append v (where v >= 0) to list, at the count *cnt, one atomic a
// warp; every lane of the warp calls it.
__device__ __forceinline__ void warp_append(int* list, int* cnt, int v,
                                            int lane) {
  const unsigned mask = __ballot_sync(FULL, v >= 0);
  int base = 0;
  if (lane == 0 && mask) base = atomicAdd(cnt, __popc(mask));
  base = __shfl_sync(FULL, base, 0);
  if (v >= 0) list[base + __popc(mask & ((1u << lane) - 1))] = v;
}

template <bool kSmem>
__global__ void __launch_bounds__(MAX_THREADS)
    auction_rounds_kernel(const float* __restrict__ b_in,
                          int64_t* __restrict__ row_to_col,
                          int* __restrict__ rounds_out, int n, int m,
                          float eps, float floor_, int max_iters) {
  extern __shared__ unsigned long long asmem[];
  unsigned long long* win = asmem;                      // [m] bid keys
  float* price = reinterpret_cast<float*>(win + m);     // [m]
  int* c2r = reinterpret_cast<int*>(price + m);         // [m] owner row
  int* r2c = c2r + m;  // [n] column, -1, or -2 - the column bid on
  int* act = r2c + n;  // [2][n] active rows, by round parity
  float* wmin = reinterpret_cast<float*>(act + 2 * n);  // [32]
  int* cnt = reinterpret_cast<int*>(wmin + 32);         // [2]
  float* bs = reinterpret_cast<float*>(cnt + 2);        // [n * m] kSmem
  const float* src = kSmem ? bs : b_in;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, nt = blockDim.x;

  for (int j = tid; j < m; j += nt) {
    win[j] = 0ull;
    price[j] = 0.0f;
    c2r[j] = -1;
  }
  for (int i = tid; i < n; i += nt) r2c[i] = -1;
  if (tid < 2) cnt[tid] = 0;
  __syncthreads();
  // A warp a row: the row copied where it fits, its feasible minimum, and
  // the row into the first active list if it has a feasible entry.
  float mn = INFINITY;
  for (int i = warp; i < n; i += nw) {
    const float* row = b_in + (size_t)i * m;
    bool has = false;
#pragma unroll 4
    for (int j = lane; j < m; j += 32) {
      const float x = row[j];
      if (kSmem) bs[(size_t)i * m + j] = x;
      if (x > NEG / 2) {
        has = true;
        mn = fminf(mn, x);
      }
    }
    if (__any_sync(FULL, has) && lane == 0) act[atomicAdd(cnt, 1)] = i;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
  if (lane == 0) wmin[warp] = mn;
  __syncthreads();
  mn = wmin[0];
  for (int w = 1; w < nw; ++w) mn = fminf(mn, wmin[w]);
  // minb = where(isfinite(minb), minb.clamp_max(0), 0).
  const float minb = isfinite(mn) ? (mn > 0.0f ? 0.0f : mn) : 0.0f;

  // Block rounds while more than one row is active.  Round parity p
  // reads act[p] and its count, and appends the next round's active rows
  // to act[q]; cnt[q], last read at the previous round's start, is
  // zeroed before the first barrier.
  int nact = cnt[0], p = 0, it = 0;
  while (nact > 1 && it < max_iters) {
    const int q = p ^ 1;
    const int* cur = act + p * n;
    if (tid == 0) cnt[q] = 0;
    // 1. The active rows' bids, a warp a row.
    for (int k = warp; k < nact; k += nw) {
      const int i = cur[k];
      float best, second;
      int col;
      row_top2<kSmem>(src, price, i, m, minb, lane, best, col, second);
      if (lane == 0 && best >= floor_) {  // else it retires
        const float bid = row_bid(best, second, eps, floor_);
        atomicMax(win + col, ((unsigned long long)ordered(bid) << 32) |
                                 (FULL - (unsigned)i));
        r2c[i] = -2 - col;
      }
    }
    __syncthreads();
    // 2. A thread a row: the column's winner in (its owner out, into the
    // next list; the price up), a loser into the next list.  The winner
    // clears the key; a loser that reads the cleared key reads row -1,
    // not its own.
    for (int k0 = warp * 32; k0 < nact; k0 += nt) {
      const int k = k0 + lane;
      int next = -1;
      if (k < nact) {
        const int i = cur[k];
        const int j = -2 - r2c[i];
        if (j >= 0) {
          const unsigned long long key = win[j];
          if ((int)(FULL - (unsigned)key) == i) {
            next = c2r[j];
            if (next >= 0) r2c[next] = -1;
            r2c[i] = j;
            c2r[j] = i;
            price[j] = __fadd_rn(price[j], unordered((unsigned)(key >> 32)));
            win[j] = 0ull;
          } else {
            r2c[i] = -1;
            next = i;
          }
        }
      }
      warp_append(act + q * n, cnt + q, next, lane);
    }
    __syncthreads();
    nact = cnt[q];
    p = q;
    ++it;
  }
  // One active row: warp 0 runs the chain of single-row rounds.  Lane
  // j % 32 alone reads price[j] and c2r[j], so it alone updates them.
  if (nact == 1 && warp == 0) {
    int i = act[p * n];
    while (i >= 0 && it < max_iters) {
      float best, second;
      int col;
      row_top2<kSmem>(src, price, i, m, minb, lane, best, col, second);
      ++it;
      if (best < floor_) break;  // retires
      const float bid = row_bid(best, second, eps, floor_);
      const int owner_lane = col & 31;
      int old = -1;
      if (lane == owner_lane) {
        old = c2r[col];
        c2r[col] = i;
        price[col] = __fadd_rn(price[col], bid);
      }
      old = __shfl_sync(FULL, old, owner_lane);
      if (lane == 0) {
        r2c[i] = col;
        if (old >= 0) r2c[old] = -1;
      }
      i = old;
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) row_to_col[i] = r2c[i];
  if (tid == 0 && rounds_out != nullptr) *rounds_out = it;
}

// Per-step latencies of one warp's dependent chains (the auction's
// latency bound): a shared-memory load, a shuffle, a value-and-compare
// step (an f32 subtract and max), and a warp reduction (redux.sync);
// out[3 * k] the SM cycles and out[3 * k + 1] the nanoseconds
// (globaltimer) of `steps` steps, out[3 * k + 2] a sink that keeps the
// chain live.
__global__ void auction_step_probe_kernel(long long* out, int steps) {
  __shared__ int next[1024];
  const int lane = threadIdx.x;
  for (int k = lane; k < 1024; k += 32) next[k] = (k + 97) & 1023;
  __syncwarp();
  int v = lane;
  float x = (float)lane, y = 0.5f;
  for (int probe = 0; probe < 4; ++probe) {
    unsigned long long g0, g1;
    __syncwarp();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
    const long long c0 = clock64();
    if (probe == 0) {
      for (int s = 0; s < steps; ++s) v = next[v];
    } else if (probe == 1) {
      for (int s = 0; s < steps; ++s)
        v = __shfl_xor_sync(FULL, v, 1 + (s & 15)) + 1;
    } else if (probe == 2) {
      for (int s = 0; s < steps; ++s) x = fmaxf(__fsub_rn(x, y), y);
    } else {
      for (int s = 0; s < steps; ++s)
        v = (int)__reduce_max_sync(FULL, (unsigned)(v ^ lane)) + 1;
    }
    __syncwarp();
    const long long c1 = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    if (lane == 0) {
      out[3 * probe] = c1 - c0;
      out[3 * probe + 1] = (long long)(g1 - g0);
      out[3 * probe + 2] = v + (long long)x;
    }
  }
}

}  // namespace

// Shared memory of the tao_auction_rounds block for b [n, m]: with b in
// it (in_smem = 1) or read where it lies, or -1 where it exceeds a
// block's (227 KB: 16 m + 12 n + 136 bytes read where it lies, plus
// 4 n m in shared memory).
extern "C" long long tao_auction_rounds_smem(int n, int m, int in_smem) {
  if (n < 1 || m < 1) return -1;
  const long long bytes = auction_smem(n, m, in_smem);
  return bytes <= SMEM_LIMIT ? bytes : -1;
}

// The wrapper guarantees a contiguous f32 benefit [n, m], an i64
// row_to_col [n] and n, m >= 1 within tao_auction_rounds_smem(n, m, 0);
// rounds (one int32, or null) receives the rounds run.  b goes to shared
// memory where it fits; the kernel never writes it.
extern "C" int tao_auction_rounds(const void* b, void* row_to_col,
                                  void* rounds, int n, int m, float eps,
                                  float floor_, int max_iters,
                                  void* stream) {
  int in_smem = 1;
  long long smem = tao_auction_rounds_smem(n, m, 1);
  if (smem < 0) {
    in_smem = 0;
    smem = tao_auction_rounds_smem(n, m, 0);
    if (smem < 0) return (int)cudaErrorInvalidValue;
  }
  auto kernel = in_smem ? auction_rounds_kernel<true>
                        : auction_rounds_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // A warp a row, up to the block's 32 warps.
  const int warps = n < MAX_THREADS / 32 ? n : MAX_THREADS / 32;
  kernel<<<1, 32 * warps, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)b, (int64_t*)row_to_col, (int*)rounds, n, m, eps, floor_,
      max_iters < 0 ? 0 : max_iters);
  return (int)cudaGetLastError();
}

// out: device int64 [12], see auction_step_probe_kernel; steps >= 1.
extern "C" int tao_auction_step_probe(void* out, int steps, void* stream) {
  auction_step_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (long long*)out, steps);
  return (int)cudaGetLastError();
}
