// The two data-dependent fixpoints of the serving path, looped on the
// card: greedy NMS's Jacobi rounds and the greedy assignment's mutual-
// best rounds.
//
// Replace no Pallas kernel: they are the counterparts of the JAX
// package's two lax.while_loops, tao_amodal_tpu/ops/nms.py:88
// (nms_keep_mask) and tao_amodal_tpu/ops/hungarian.py:153
// (greedy_assign).  Eager PyTorch cannot branch on the device, so the
// plain versions (ops/nms.py::nms_fixpoint_torch, ops/hungarian.py::
// greedy_fixpoint_torch) check convergence on the host after each block
// of rounds, a host sync a call; these kernels run every round in one
// launch, so the serving clip captures as one CUDA graph.
//
// Bound: latency, a chain of dependent block-wide rounds.  Each kernel
// keeps its whole problem in one block's shared memory, so a round is a
// few shared-memory passes and one or two barriers.
//
// tao_nms_fixpoint: sup u8 [B, n, n] (sup[i][j]: i ranks above j,
// overlaps it past the threshold and is valid), valid u8 [B, n] ->
// keep u8 [B, n], one block a row b.  keep starts at valid; a round is
// keep'[j] = valid[j] & !any_i(sup[i][j] & keep[i]), until a round
// changes nothing or n rounds have run (rank r is final after r rounds,
// so the cap never binds).  The columns of sup are packed as bits in
// shared memory, word-major (cols[w * n + j] holds rows 32w..32w+31 of
// column j, so the threads of a warp read consecutive words), 500^2
// bits in 31 KB; keep is two bit vectors (read one, write the other),
// each warp's new word one ballot.  Where the packed columns do not fit
// in a block's shared memory, a round reads sup from device memory.
//
// tao_greedy_fixpoint: b f32 [n, m], the masked benefit (every entry
// NEG or above NEG / 2: greedy_assign maps NaN, -inf and forbidden
// entries to NEG first, so no NaN reaches the kernel) -> row_to_col
// i64 [n], -1 unassigned, one block a call.  A round takes each row's
// and each column's maximum with the first index on ties (torch.max's
// and argmax's; a thread scans a row or a column), matches every row
// whose best column's best row is itself and whose best value is above
// NEG / 2, and sets the matched rows and taken columns to NEG; it stops
// when no row has an entry above NEG / 2 or n rounds have run (each
// round matches the global maximum, so the cap never binds).  b lives
// in shared memory (rows of an odd stride, so the 32 rows or columns a
// warp scans lie in 32 banks), or, where it does not fit, in a device
// workspace the wrapper gives.
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
#define NEG_INF __int_as_float(0xff800000)

__global__ void __launch_bounds__(MAX_THREADS)
    nms_fixpoint_kernel(const uint8_t* __restrict__ sup,
                        const uint8_t* __restrict__ valid,
                        uint8_t* __restrict__ keep, int n, int packed) {
  extern __shared__ uint32_t smem[];
  const int words = (n + 31) / 32;
  uint32_t* vbits = smem;               // [words]
  uint32_t* kbits = smem + words;       // [2][words]
  uint32_t* cols = smem + 3 * words;    // [words][n] where packed
  const int tid = threadIdx.x, lane = tid & 31;
  const uint8_t* s = sup + (size_t)blockIdx.x * n * n;
  const uint8_t* v = valid + (size_t)blockIdx.x * n;

  if (packed) {
    // Thread j gathers column j; a warp reads 32 consecutive bytes of
    // each row.
    for (int j = tid; j < n; j += blockDim.x)
      for (int w = 0; w < words; ++w) {
        uint32_t bits = 0;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int i = 32 * w + k;
          if (i < n) bits |= (uint32_t)(s[(size_t)i * n + j] != 0) << k;
        }
        cols[(size_t)w * n + j] = bits;
      }
  }
  // blockDim is a multiple of 32, so lane 0's j is a word's first bit.
  for (int base = 0; base < n; base += blockDim.x) {
    const int j = base + tid;
    const uint32_t word = __ballot_sync(0xffffffffu, j < n && v[j] != 0);
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
        if (packed) {
          for (int w = 0; w < words; ++w)
            hit |= cols[(size_t)w * n + j] & cur[w];
        } else {
          for (int i = 0; i < n && !hit; ++i)
            hit = s[(size_t)i * n + j] != 0 &&
                  (cur[i >> 5] >> (i & 31) & 1u);
        }
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

__global__ void __launch_bounds__(GREEDY_THREADS)
    greedy_fixpoint_kernel(const float* __restrict__ b_in,
                           float* __restrict__ work,
                           int64_t* __restrict__ row_to_col, int n,
                           int m) {
  extern __shared__ float fsmem[];
  float* row_val = fsmem;                                 // [n]
  int* row_col = reinterpret_cast<int*>(row_val + n);    // [n]
  int* r2c = row_col + n;                                 // [n]
  int* col_row = r2c + n;                                 // [m]
  uint8_t* row_hit = reinterpret_cast<uint8_t*>(col_row + m);   // [n]
  uint8_t* col_hit = row_hit + n;                         // [m]
  // b [n, ld]: in shared memory after the vectors (16-byte aligned), or
  // the workspace.
  float* b = work != nullptr
                 ? work
                 : fsmem + ((3LL * n + m) + (n + m + 3) / 4 + 3) / 4 * 4;
  const int ld = m | 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < n; i += nwarps)
    for (int j = lane; j < m; j += 32)
      b[(size_t)i * ld + j] = b_in[(size_t)i * m + j];
  for (int i = tid; i < n; i += blockDim.x) r2c[i] = -1;
  __syncthreads();

  for (int round = 0; round < n; ++round) {
    // Each row's and each column's maximum, the first index on ties: a
    // thread scans a row (t < n) or a column in order, so a strict >
    // keeps the first.  The odd stride puts the rows that a warp's
    // threads scan, and the columns, in 32 banks.
    int open = 0;
    for (int t = tid; t < n + m; t += blockDim.x) {
      float v = NEG_INF;
      int k = 0;
      if (t < n) {
        const float* row = b + (size_t)t * ld;
#pragma unroll 8
        for (int j = 0; j < m; ++j) {
          const float x = row[j];
          if (x > v) {
            v = x;
            k = j;
          }
        }
        row_val[t] = v;
        row_col[t] = k;
        open |= v > NEG / 2;
      } else {
        const int j = t - n;
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
          const float x = b[(size_t)i * ld + j];
          if (x > v) {
            v = x;
            k = i;
          }
        }
        col_row[j] = k;
        col_hit[j] = 0;
      }
    }
    if (!__syncthreads_or(open)) break;
    // Mutual best pairs: each column is the best of at most one row.
    for (int i = tid; i < n; i += blockDim.x) {
      const int k = row_col[i];
      const bool mutual = row_val[i] > NEG / 2 && col_row[k] == i;
      row_hit[i] = mutual;
      if (mutual) {
        r2c[i] = k;
        col_hit[k] = 1;
      }
    }
    __syncthreads();
    for (int i = warp; i < n; i += nwarps) {
      const bool row = row_hit[i];
      for (int j = lane; j < m; j += 32)
        if (row || col_hit[j]) b[(size_t)i * ld + j] = NEG;
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += blockDim.x) row_to_col[i] = r2c[i];
}

long long greedy_vectors_bytes(int n, int m) {
  return ((3LL * n + m) + (n + m + 3) / 4 + 3) / 4 * 4 * 4;
}

}  // namespace

// Shared memory of a tao_nms_fixpoint block for n boxes, with packed
// columns (packed = 1) or without, or -1 where it exceeds a block's.
extern "C" long long tao_nms_fixpoint_smem(int n, int packed) {
  const long long words = (n + 31) / 32;
  const long long bytes = 4 * (3 * words + (packed ? words * n : 0));
  return bytes <= SMEM_LIMIT ? bytes : -1;
}

// The wrapper guarantees contiguous u8 (bool) tensors sup [B, n, n],
// valid and keep [B, n], B < 2^31, and n >= 1.
extern "C" int tao_nms_fixpoint(const void* sup, const void* valid,
                                void* keep, int B, int n, void* stream) {
  if (B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  int packed = 1;
  long long smem = tao_nms_fixpoint_smem(n, 1);
  if (smem < 0) {
    packed = 0;
    smem = tao_nms_fixpoint_smem(n, 0);
    if (smem < 0) return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = (n + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  nms_fixpoint_kernel<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint8_t*)sup, (const uint8_t*)valid, (uint8_t*)keep, n, packed);
  return (int)cudaGetLastError();
}

// Shared memory of the tao_greedy_fixpoint block for b [n, m]: with b
// in it (in_smem = 1, rows of m | 1 floats) or in a workspace, or -1
// where it exceeds a block's.
extern "C" long long tao_greedy_fixpoint_smem(int n, int m, int in_smem) {
  const long long bytes =
      greedy_vectors_bytes(n, m) + (in_smem ? 4LL * n * (m | 1) : 0);
  return bytes <= SMEM_LIMIT ? bytes : -1;
}

// The wrapper guarantees a contiguous f32 b [n, m] free of NaN, an i64
// row_to_col [n], n, m >= 1, and a workspace of n * (m | 1) floats
// (work) exactly where b does not fit in shared memory.
extern "C" int tao_greedy_fixpoint(const void* b, void* work,
                                   void* row_to_col, int n, int m,
                                   void* stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const long long smem = tao_greedy_fixpoint_smem(n, m, work == nullptr);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  greedy_fixpoint_kernel<<<1, GREEDY_THREADS, (size_t)smem,
                           (cudaStream_t)stream>>>(
      (const float*)b, (float*)work, (int64_t*)row_to_col, n, m);
  return (int)cudaGetLastError();
}
