// The two data-dependent fixpoints of the serving path, looped on the
// card: greedy NMS, from the boxes to the keep mask, and the greedy
// assignment's mutual-best rounds.
//
// Replace no Pallas kernel: they are the counterparts of the JAX
// package's nms_keep_mask (tao_amodal_tpu/ops/nms.py:41: the pairwise
// IoU of :27 and the lax.while_loop of :88) and of greedy_assign's
// lax.while_loop (tao_amodal_tpu/ops/hungarian.py:153).  Eager PyTorch
// cannot branch on the device, so the plain versions (ops/nms.py::
// nms_keep_mask_torch and nms_fixpoint_torch, ops/hungarian.py::
// greedy_fixpoint_torch) check convergence on the host after each block
// of rounds, a host sync a call; these kernels run every round on the
// card, so the serving clip captures as one CUDA graph.
//
// Bound: latency, a chain of dependent block-wide rounds.  Each rounds
// kernel keeps its whole problem in one block's shared memory, so a
// round is a few shared-memory passes and one or two barriers.
//
// NMS (tao_nms_keep, tao_nms_fixpoint): two kernels in one C call.
// The suppression matrix sup[i][j] (i ranks above j, overlaps it past
// the threshold and is valid) lives as packed bits, word-major: word
// cols[b][w][j] holds rows 32w..32w+31 of column j, so the threads of a
// warp touch consecutive words.  A producer writes the words into a
// workspace the wrapper allocates, spread over frame x column tile x
// word blocks:
//  - nms_bits_kernel (tao_nms_keep, the serving path) builds them from
//    boxes f32 [B, n, 4], scores f32 [B, n] and valid u8 [B, n] (or
//    none: all valid), a thread a word: the block's 32 row boxes against
//    column j, rows that do not rank above j, are not valid or do not
//    overlap it skipped before the division.  The IoU repeats
//    ops/boxes.py::box_iou_xyxy op by op, in round-to-nearest intrinsics
//    that nvcc never contracts into FMAs, with NaN propagating as
//    torch.maximum, torch.minimum and clamp_min propagate it, and is
//    compared with the threshold in f32, as PyTorch compares an f32
//    tensor with a Python float;
//  - nms_pack_kernel (tao_nms_fixpoint) packs a bool sup [B, n, n].
// Then nms_rounds_kernel, one block a frame, copies the frame's words
// into shared memory with 16-byte loads (or, past a block's shared
// memory, n = 1500, reads them where they lie) and runs the rounds: keep
// starts at valid; a round is keep'[j] = valid[j] & !any_i(sup[i][j] &
// keep[i]), until a round changes nothing or n rounds have run (rank r
// is final after r rounds, so the cap never binds); keep is two bit
// vectors (read one, write the other), each warp's new word one ballot.
// Bound: bytes (boxes, scores and valid in, keep out) and the latency of
// (1 + rounds) block-wide barriers; the producer's IoUs and divisions
// are spread over the card, the rounds over one block a frame.

// tao_greedy_fixpoint: b f32 [n, m], the masked benefit (every entry
// NEG or above NEG / 2: greedy_assign maps NaN, -inf and forbidden
// entries to NEG first, so no NaN reaches the kernel) -> row_to_col
// i64 [n], -1 unassigned, one block a call.  The plain loop's rounds
// match every row and column that are each other's first-index argmax
// until no row has an entry above NEG / 2; their fixpoint is sequential
// greedy in the order (value descending, row, column), which the kernel
// computes with less work a round (as csrc/sort_scan.cu's rounds, B3):
// each row's and column's best (key, index) stay in shared memory across
// rounds and are rescanned, a thread a line, only where their best
// column was taken or best row matched; matched rows and taken columns
// are bit masks and b is never written; two barriers a round.  Ties at the largest open value (SORT's plateau of zero IoUs,
// where first-index ties match one pair a round) are taken in one walk
// of that level in greedy's own order.  b lives in shared memory (rows
// of an odd stride, so the 32 entries of a warp's column scan lie in 32
// banks), or, where it does not fit, is read where it lies.
//
// Both results are integers or booleans of the same inputs, equal to
// the plain versions' bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int GREEDY_THREADS = 512;
constexpr float NEG = -1e9f;
constexpr long long SMEM_LIMIT = 227LL * 1024;

constexpr int BITS_THREADS = 128;

// torch.maximum and torch.minimum: NaN where either is NaN (fmaxf and
// fminf drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
// clamp_min(x, 0), NaN kept.
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

__device__ __forceinline__ float box_area(float4 q) {
  return __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
}

// box_iou_xyxy(p, q) > thr, op by op: inter = clamp_min(x1 - x0, 0) *
// clamp_min(y1 - y0, 0), union = (area_p + area_q) - inter, IoU 0 where
// the union is not > 0.  Where inter is not > 0 (0, or NaN, which makes
// the union NaN) the IoU is 0, with no division.
__device__ __forceinline__ bool overlaps(float4 p, float ap, float4 q,
                                         float aq, float thr) {
  const float iw = clamp0(__fsub_rn(min_nan(p.z, q.z), max_nan(p.x, q.x)));
  const float ih = clamp0(__fsub_rn(min_nan(p.w, q.w), max_nan(p.y, q.y)));
  const float inter = __fmul_rn(iw, ih);
  if (!(inter > 0.0f)) return 0.0f > thr;
  const float uni = __fsub_rn(__fadd_rn(ap, aq), inter);
  return (uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f) > thr;
}

// Grid (B * tiles, words): block (b, tile, w) builds word w of the
// columns tile * BITS_THREADS + threadIdx.x of frame b.
__global__ void __launch_bounds__(BITS_THREADS)
    nms_bits_kernel(const float4* __restrict__ boxes,
                    const float* __restrict__ scores,
                    const uint8_t* __restrict__ valid,
                    uint32_t* __restrict__ cols, int n, int tiles,
                    float thr) {
  __shared__ float4 rbox[32];
  __shared__ float rscore[32], rarea[32];
  __shared__ uint32_t rvalid;
  const int b = blockIdx.x / tiles, w = blockIdx.y, tid = threadIdx.x;
  const float4* bx = boxes + (size_t)b * n;
  const float* sc = scores + (size_t)b * n;
  if (tid < 32) {
    const int i = 32 * w + tid;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    float s = 0.f;
    if (i < n) {
      q = bx[i];
      s = sc[i];
    }
    rbox[tid] = q;
    rscore[tid] = s;
    rarea[tid] = box_area(q);
    const uint32_t ok = __ballot_sync(
        0xffffffffu, i < n && (valid == nullptr || valid[(size_t)b * n + i]));
    if (tid == 0) rvalid = ok;
  }
  __syncthreads();
  const int j = (blockIdx.x % tiles) * BITS_THREADS + tid;
  if (j >= n) return;
  const float4 q = bx[j];
  const float s = sc[j], a = box_area(q);
  uint32_t bits = 0, rows = rvalid;  // the same rows in every thread
  while (rows) {
    const int k = __ffs(rows) - 1;
    rows &= rows - 1;
    const float si = rscore[k];  // rank: (s_i > s_j) | (s_i == s_j & i < j)
    if ((si > s || (si == s && 32 * w + k < j)) &&
        overlaps(rbox[k], rarea[k], q, a, thr))
      bits |= 1u << k;
  }
  cols[((size_t)b * gridDim.y + w) * n + j] = bits;
}

// The same words from a bool sup [B, n, n]; a warp reads 32 consecutive
// bytes of each row.
__global__ void __launch_bounds__(BITS_THREADS)
    nms_pack_kernel(const uint8_t* __restrict__ sup,
                    uint32_t* __restrict__ cols, int n, int tiles) {
  const int b = blockIdx.x / tiles, w = blockIdx.y;
  const int j = (blockIdx.x % tiles) * BITS_THREADS + threadIdx.x;
  if (j >= n) return;
  const uint8_t* s = sup + (size_t)b * n * n;
  uint32_t bits = 0;
#pragma unroll 8
  for (int k = 0; k < 32; ++k) {
    const int i = 32 * w + k;
    if (i < n) bits |= (uint32_t)(s[(size_t)i * n + j] != 0) << k;
  }
  cols[((size_t)b * gridDim.y + w) * n + j] = bits;
}

// Words of the rounds block's shared memory before the columns: valid
// and two keep vectors, rounded up to 16 bytes.
__host__ __device__ inline long long rounds_vector_words(int n) {
  return (3LL * ((n + 31) / 32) + 3) / 4 * 4;
}

__global__ void __launch_bounds__(MAX_THREADS)
    nms_rounds_kernel(const uint32_t* __restrict__ gcols,
                      const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ keep, int n, int in_smem) {
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int words = (n + 31) / 32;
  uint32_t* vbits = smem;               // [words]
  uint32_t* kbits = smem + words;       // [2][words]
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t nw = (size_t)words * n;
  const uint32_t* g = gcols + (size_t)blockIdx.x * nw;
  const uint32_t* cols = g;
  if (in_smem) {
    uint32_t* s = smem + rounds_vector_words(n);  // [words][n]
    size_t e = 0;
    if ((nw & 3) == 0) {  // the frame's words start 16-byte aligned
      const uint4* g4 = reinterpret_cast<const uint4*>(g);
      uint4* s4 = reinterpret_cast<uint4*>(s);
      for (size_t q = tid; q < nw / 4; q += blockDim.x) s4[q] = g4[q];
      e = nw;
    }
    for (e += tid; e < nw; e += blockDim.x) s[e] = g[e];
    cols = s;
  }
  // blockDim is a multiple of 32, so lane 0's j is a word's first bit.
  for (int base = 0; base < n; base += blockDim.x) {
    const int j = base + tid;
    const uint32_t word = __ballot_sync(
        0xffffffffu,
        j < n && (valid == nullptr || valid[(size_t)blockIdx.x * n + j]));
    if (lane == 0 && j < n) vbits[j >> 5] = kbits[j >> 5] = word;
  }
  __syncthreads();

  int rounds = 0;
  while (rounds < n) {
    const uint32_t* cur = kbits + (rounds & 1) * words;
    uint32_t* nxt = kbits + ((rounds + 1) & 1) * words;
    int changed = 0;
    for (int base = 0; base < n; base += blockDim.x) {
      const int j = base + tid;
      bool kj = false;
      if (j < n && (vbits[j >> 5] >> (j & 31) & 1u)) {
        uint32_t hit = 0;
        for (int w = 0; w < words && !hit; ++w)
          hit = cols[(size_t)w * n + j] & cur[w];
        kj = hit == 0;
      }
      const uint32_t word = __ballot_sync(0xffffffffu, kj);
      if (lane == 0 && j < n) {
        nxt[j >> 5] = word;
        changed |= word != cur[j >> 5];
      }
    }
    ++rounds;
    if (!__syncthreads_or(changed)) break;
  }
  const uint32_t* fin = kbits + (rounds & 1) * words;
  for (int j = tid; j < n; j += blockDim.x)
    keep[(size_t)blockIdx.x * n + j] =
        (uint8_t)(fin[j >> 5] >> (j & 31) & 1u);
}

// An unsigned key that orders like the float (for values that are not
// NaN), -0 taken as +0 (torch.max finds them equal and keeps the first);
// 0 is below every such key and marks "no entry".
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ bool bit_of(const unsigned* mask, int i) {
  return (mask[i >> 5] >> (i & 31)) & 1u;
}

// First-max-index argmax over the entries e < len of the strided
// vector v[e * step] whose bit is clear in mask (bit e of mask[e >> 5]),
// by one thread, in order, so a strict > keeps the first (-0 and +0
// compare equal, as in torch.max).  Returns the key (0 where every entry
// is masked) and, in *idx, the index (0 then).  No entry is -inf: the
// masked benefit holds NEG there.
__device__ __forceinline__ unsigned line_argmax(const float* v, int step,
                                                int len,
                                                const unsigned* mask,
                                                int* idx) {
  const float none = __int_as_float(0xff800000);  // -inf
  float best = none;
  int at = 0;
  for (int w = 0; w * 32 < len; ++w) {
    const unsigned open = ~mask[w];
    const int n = len - 32 * w < 32 ? len - 32 * w : 32;
    const float* p = v + 32 * w * step;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float x = p[j * step];
      if (((open >> j) & 1u) && x > best) {
        best = x;
        at = 32 * w + j;
      }
    }
  }
  *idx = at;
  return best == none ? 0u : key_of(best);
}

constexpr int GREEDY_WARPS = GREEDY_THREADS / 32;

// Words of the block's vectors before b: row keys and best columns [n],
// column keys and best rows [m], row_to_col [n], matched rows and taken
// columns as bits, a top key a warp (room for GREEDY_WARPS).
__host__ __device__ inline long long greedy_vector_words(int n, int m) {
  return 3LL * n + 2LL * m + (n + 31) / 32 + (m + 31) / 32 + GREEDY_WARPS;
}

// The greedy mutual-best fixpoint as sequential greedy computes it (the
// largest entry first, ties by row, then column: the order that first-
// index argmaxes of rows and columns agree on), so its pairs are the
// round-by-round loop's.  Thread t owns lines t, t + blockDim, ... of
// the n rows and then the m columns.  A round:
//  1. top, the largest open row key, from the warps' tops of the last
//     round (no open row: done).  Every open row below the top whose best
//     column's best row is itself matches (mutual best: a pair of the
//     greedy matching); warp 0 walks the top level in greedy's order,
//     each row of it, first to last, taking its first open column of
//     that value.  The two never meet: a column below the top holds no
//     entry of the top value.  One barrier.
//  2. Each thread rescans its rows whose best column was taken and its
//     columns whose best row was matched (values only leave), over the
//     open entries, all such lines at once; the warps publish their
//     rows' top.  One barrier.
// A plateau of equal values (SORT's zero IoUs) is one walk, not a round
// a pair.  Every round matches at least the top row, so at most min(n,
// m) rounds run.
template <bool IN_SMEM>
__global__ void __launch_bounds__(GREEDY_THREADS)
    greedy_fixpoint_kernel(const float* __restrict__ b_in,
                           int64_t* __restrict__ row_to_col,
                           int* __restrict__ rounds_out, int n, int m) {
  extern __shared__ float4 gsm4[];
  constexpr int NW = GREEDY_WARPS;
  unsigned* rk = reinterpret_cast<unsigned*>(gsm4);  // [n] row best key
  int* rc = reinterpret_cast<int*>(rk + n);         // [n] its column
  unsigned* ck = reinterpret_cast<unsigned*>(rc + n);  // [m] column key
  int* cr = reinterpret_cast<int*>(ck + m);         // [m] its row
  int* r2c = cr + m;                                // [n]
  unsigned* rowm = reinterpret_cast<unsigned*>(r2c + n);  // matched rows
  unsigned* colt = rowm + (n + 31) / 32;                  // taken columns
  unsigned* wtop = colt + (m + 31) / 32;                  // [NW]
  // b: in shared memory after the vectors (rows of an odd stride, so the
  // 32 rows or the 32 columns a warp's threads scan lie in 32 banks), or
  // where it lies.
  float* bs = reinterpret_cast<float*>(gsm4 + (greedy_vector_words(n, m) +
                                               3) / 4);
  const int ld = IN_SMEM ? (m | 1) : m;
  const float* b = IN_SMEM ? bs : b_in;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned open_key = key_of(NEG / 2);

  for (int i = tid; i < n; i += blockDim.x) r2c[i] = -1;
  for (int w = tid; w < (n + 31) / 32 + (m + 31) / 32; w += blockDim.x)
    rowm[w] = 0u;  // rowm and colt
  if (IN_SMEM) {  // eight loads in flight a thread (n * m < 2^16 here)
    const int nm = n * m, sr = blockDim.x / m, sc = blockDim.x % m;
    int r = tid / m, c = tid % m;  // entry e's row and column, stepped
    for (int e0 = tid; e0 < nm; e0 += 8 * blockDim.x) {
      float x[8];
      int at[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = e0 + j * blockDim.x;
        x[j] = e < nm ? b_in[e] : 0.f;
        at[j] = r * ld + c;
        c += sc;
        r += sr;
        if (c >= m) {
          c -= m;
          ++r;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (e0 + j * (int)blockDim.x < nm) bs[at[j]] = x[j];
    }
  }
  __syncthreads();
  // Every line's argmax; each warp's top over its rows.
  unsigned top = 0;
  for (int t = tid; t < n + m; t += blockDim.x) {
    int at;
    if (t < n) {
      rk[t] = line_argmax(b + t * ld, 1, m, colt, &at);
      rc[t] = at;
      top = max(top, rk[t]);
    } else {
      ck[t - n] = line_argmax(b + (t - n), ld, n, rowm, &at);
      cr[t - n] = at;
    }
  }
  top = __reduce_max_sync(0xffffffffu, top);
  if (lane == 0) wtop[warp] = top;
  __syncthreads();

  int round = 0;
  for (; round < n; ++round) {
    top = 0;
    for (int w = 0; w < NW; ++w) top = max(top, wtop[w]);
    if (top <= open_key) break;
    // 1. Mutual pairs below the top.
    for (int i = tid; i < n; i += blockDim.x) {
      const unsigned k = rk[i];
      if (k > open_key && k != top && !bit_of(rowm, i)) {
        const int c = rc[i];
        if (cr[c] == i) {
          r2c[i] = c;
          atomicOr(rowm + (i >> 5), 1u << (i & 31));
          atomicOr(colt + (c >> 5), 1u << (c & 31));
        }
      }
    }
    // The top level, row by row in order.  Only this warp writes a top
    // row's bits or a top column's, so its reads see every bit it needs.
    if (warp == 0) {
      const float v = value_of(top);
      volatile const unsigned* taken = colt;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int il = i0 + lane;
        unsigned level = __ballot_sync(
            0xffffffffu, il < n && rk[il] == top && !bit_of(rowm, il));
        while (level) {
          const int i = i0 + __ffs(level) - 1;
          level &= level - 1;
          int c = rc[i];
          if ((taken[c >> 5] >> (c & 31)) & 1u) {
            // Its best column went to an earlier top row: the next open
            // column of the top value, if any.
            const float* row = b + (size_t)i * ld;
            const int from = c + 1;
            c = -1;
            for (int j0 = from; j0 < m; j0 += 32) {
              const int j = j0 + lane;
              const bool hit = j < m && !((taken[j >> 5] >> (j & 31)) & 1u) &&
                               row[j] == v;
              const unsigned found = __ballot_sync(0xffffffffu, hit);
              if (found) {
                c = j0 + __ffs(found) - 1;
                break;
              }
            }
          }
          if (c >= 0 && lane == 0) {
            r2c[i] = c;
            atomicOr(rowm + (i >> 5), 1u << (i & 31));
            atomicOr(colt + (c >> 5), 1u << (c & 31));
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    // 2. This thread's lines whose best entry left, rescanned.
    top = 0;
    for (int t = tid; t < n + m; t += blockDim.x) {
      int at;
      if (t < n) {
        if (!bit_of(rowm, t) && rk[t] > open_key) {
          unsigned k = rk[t];
          if (bit_of(colt, rc[t])) {
            rk[t] = k = line_argmax(b + t * ld, 1, m, colt, &at);
            rc[t] = at;
          }
          top = max(top, k);
        }
      } else {
        const int c = t - n;
        if (!bit_of(colt, c) && ck[c] > open_key && bit_of(rowm, cr[c])) {
          ck[c] = line_argmax(b + c, ld, n, rowm, &at);
          cr[c] = at;
        }
      }
    }
    top = __reduce_max_sync(0xffffffffu, top);
    if (lane == 0) wtop[warp] = top;
    __syncthreads();
  }
  for (int i = tid; i < n; i += blockDim.x) row_to_col[i] = r2c[i];
  if (tid == 0 && rounds_out != nullptr) *rounds_out = round;
}

// The rounds after a producer has written cols: the frame's words in
// shared memory where they fit, else read where they lie.
int launch_rounds(const uint32_t* cols, const void* valid, void* keep,
                  int B, int n, cudaStream_t stream) {
  long long smem =
      4 * (rounds_vector_words(n) + (long long)((n + 31) / 32) * n);
  int in_smem = 1;
  if (smem > SMEM_LIMIT) {
    in_smem = 0;
    smem = 4 * rounds_vector_words(n);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = (n + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  nms_rounds_kernel<<<B, threads, (size_t)smem, stream>>>(
      cols, (const uint8_t*)valid, (uint8_t*)keep, n, in_smem);
  return (int)cudaGetLastError();
}

dim3 producer_grid(int B, int n) {
  return dim3((unsigned)B * ((n + BITS_THREADS - 1) / BITS_THREADS),
              (n + 31) / 32);
}

}  // namespace

// Greedy NMS from the boxes.  The wrapper guarantees contiguous boxes
// f32 [B, n, 4] (16-byte aligned), scores f32 [B, n], valid u8 [B, n] or
// null (every box valid), keep u8 [B, n], the workspace cols u32
// [B, ceil(n / 32), n] (16-byte aligned), B * ceil(n / 128) < 2^31 and
// 1 <= n <= 65535 * 32.
extern "C" int tao_nms_keep(const void* boxes, const void* scores,
                            const void* valid, void* keep, void* cols, int B,
                            int n, float thr, void* stream) {
  if (B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  nms_bits_kernel<<<producer_grid(B, n), BITS_THREADS, 0, s>>>(
      (const float4*)boxes, (const float*)scores, (const uint8_t*)valid,
      (uint32_t*)cols, n, (n + BITS_THREADS - 1) / BITS_THREADS, thr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_rounds((const uint32_t*)cols, valid, keep, B, n, s);
}

// The fixpoint of a given suppression matrix: contiguous u8 (bool) sup
// [B, n, n], valid and keep [B, n], cols as for tao_nms_keep.
extern "C" int tao_nms_fixpoint(const void* sup, const void* valid,
                                void* keep, void* cols, int B, int n,
                                void* stream) {
  if (B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  nms_pack_kernel<<<producer_grid(B, n), BITS_THREADS, 0, s>>>(
      (const uint8_t*)sup, (uint32_t*)cols, n,
      (n + BITS_THREADS - 1) / BITS_THREADS);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_rounds((const uint32_t*)cols, valid, keep, B, n, s);
}

// Shared memory of the tao_greedy_fixpoint block for b [n, m]: with b
// in it (in_smem = 1, rows of m | 1 floats) or read where it lies, or -1
// where it exceeds a block's.
extern "C" long long tao_greedy_fixpoint_smem(int n, int m, int in_smem) {
  const long long bytes = (greedy_vector_words(n, m) + 3) / 4 * 16 +
                          (in_smem ? 4LL * n * (m | 1) : 0);
  return bytes <= SMEM_LIMIT ? bytes : -1;
}

// The wrapper guarantees a contiguous f32 b [n, m] free of NaN, an i64
// row_to_col [n] and n, m >= 1; rounds (one int32, or null) receives
// the rounds run.  b goes to shared memory where it fits; the kernel
// never writes it.
extern "C" int tao_greedy_fixpoint(const void* b, void* row_to_col,
                                   void* rounds, int n, int m,
                                   void* stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  int in_smem = 1;
  long long smem = tao_greedy_fixpoint_smem(n, m, 1);
  if (smem < 0) {
    in_smem = 0;
    smem = tao_greedy_fixpoint_smem(n, m, 0);
    if (smem < 0) return (int)cudaErrorInvalidValue;
  }
  auto kernel = in_smem ? greedy_fixpoint_kernel<true>
                        : greedy_fixpoint_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<1, GREEDY_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)b, (int64_t*)row_to_col, (int*)rounds, n, m);
  return (int)cudaGetLastError();
}
