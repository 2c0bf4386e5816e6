// Whole-clip greedy SORT association in one launch.
//
// boxes f32 [T, D, 4] xyxy, valid u8 [T, D]; the SortState fields
// (x f32 [K, 7], P f32 [K, 7, 7], alive u8 [K], track_id, hits,
// hit_streak, age, time_since_update i32 [K], next_id, frame_count i32
// []) are read from the *_in pointers and written to the *_out ones;
// det_track_id i32 [T, D] and det_report u8 [T, D] per frame.
//
// Replaces the TPU kernel tao_amodal_tpu/ops/pallas/sort_scan.py
// sort_scan_pallas (_sort_scan_kernel) and computes, frame by frame,
// what tao_amodal_torch/trackers/sort.py::sort_step computes: Kalman
// predict (with the vs_bad zeroing), the IoU of ops/boxes.py, the
// greedy mutual-best fixpoint of ops/hungarian.py (first-max-index
// ties, at most D rounds), the IoU gate, the Kalman update with the
// closed-form 4x4 inverse of ops/kalman.py, deaths, births in rank
// order, next_id and the reporting rule.
//
// Bound: latency of a sequential chain of small dependent steps (the
// plain version launches hundreds of tiny ops per frame from the host).
// Design: one block per SORT state, one thread per slot (Kalman x[7]
// and P[49] in registers for the whole clip) and per detection; the
// frame's detections and the [D, K] benefit matrix live in shared
// memory; row argmaxes are warp reductions, column argmaxes one thread
// per column, ranks of free slots and unmatched detections block
// prefix counts from warp ballots.  No host sync inside the clip.  The
// IoU, box and inverse arithmetic uses round-to-nearest intrinsics
// that are never fused into FMAs, in the plain version's order.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e9f;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// Diagonals of ops/kalman.py::_constants (Q, R and P0 are diagonal).
__device__ __forceinline__ float q_diag(int i) {
  return i < 4 ? 1.0f : (i < 6 ? 0.01f : 0.0001f);
}
__device__ __forceinline__ float r_diag(int i) { return i < 2 ? 1.0f : 10.0f; }
__device__ __forceinline__ float p0_diag(int i) {
  return i < 4 ? 10.0f : 10000.0f;
}

// ops/kalman.py::bbox_to_z.
__device__ __forceinline__ void bbox_to_z(const float* b, float* z) {
  const float w = sub(b[2], b[0]);
  const float h = sub(b[3], b[1]);
  z[0] = add(b[0], w / 2.0f);
  z[1] = add(b[1], h / 2.0f);
  z[2] = mul(w, h);
  z[3] = w / fmaxf(h, 1e-6f);
}

// ops/boxes.py::box_iou_xyxy for one (detection a, track b) pair.
__device__ __forceinline__ float iou(const float* a, const float* b) {
  const float x0 = fmaxf(a[0], b[0]);
  const float y0 = fmaxf(a[1], b[1]);
  const float x1 = fminf(a[2], b[2]);
  const float y1 = fminf(a[3], b[3]);
  const float inter =
      mul(fmaxf(sub(x1, x0), 0.0f), fmaxf(sub(y1, y0), 0.0f));
  const float area_a = mul(sub(a[2], a[0]), sub(a[3], a[1]));
  const float area_b = mul(sub(b[2], b[0]), sub(b[3], b[1]));
  const float uni = sub(add(area_a, area_b), inter);
  return uni > 0.0f ? inter / uni : 0.0f;
}

// ops/kalman.py::_inv4x4, the same formula and operation order.
__device__ __forceinline__ void inv4x4(const float (&m)[4][4],
                                       float (&o)[4][4]) {
  const float a = m[0][0], b = m[0][1], c = m[0][2], d = m[0][3];
  const float e = m[1][0], f = m[1][1], g = m[1][2], h = m[1][3];
  const float i = m[2][0], j = m[2][1], k = m[2][2], l = m[2][3];
  const float mm = m[3][0], n = m[3][1], oo = m[3][2], p = m[3][3];
  const float s0 = sub(mul(a, f), mul(e, b));
  const float s1 = sub(mul(a, g), mul(e, c));
  const float s2 = sub(mul(a, h), mul(e, d));
  const float s3 = sub(mul(b, g), mul(f, c));
  const float s4 = sub(mul(b, h), mul(f, d));
  const float s5 = sub(mul(c, h), mul(g, d));
  const float c5 = sub(mul(k, p), mul(oo, l));
  const float c4 = sub(mul(j, p), mul(n, l));
  const float c3 = sub(mul(j, oo), mul(n, k));
  const float c2 = sub(mul(i, p), mul(mm, l));
  const float c1 = sub(mul(i, oo), mul(mm, k));
  const float c0 = sub(mul(i, n), mul(mm, j));
  const float det =
      add(sub(add(add(sub(mul(s0, c5), mul(s1, c4)), mul(s2, c3)),
                  mul(s3, c2)),
              mul(s4, c1)),
          mul(s5, c0));
  const float inv_det = 1.0f / (fabsf(det) > 1e-20f ? det : 1.0f);
  const float adj[4][4] = {
      {add(sub(mul(f, c5), mul(g, c4)), mul(h, c3)),
       sub(add(mul(-b, c5), mul(c, c4)), mul(d, c3)),
       add(sub(mul(n, s5), mul(oo, s4)), mul(p, s3)),
       sub(add(mul(-j, s5), mul(k, s4)), mul(l, s3))},
      {sub(add(mul(-e, c5), mul(g, c2)), mul(h, c1)),
       add(sub(mul(a, c5), mul(c, c2)), mul(d, c1)),
       sub(add(mul(-mm, s5), mul(oo, s2)), mul(p, s1)),
       add(sub(mul(i, s5), mul(k, s2)), mul(l, s1))},
      {add(sub(mul(e, c4), mul(f, c2)), mul(h, c0)),
       sub(add(mul(-a, c4), mul(b, c2)), mul(d, c0)),
       add(sub(mul(mm, s4), mul(n, s2)), mul(p, s0)),
       sub(add(mul(-i, s4), mul(j, s2)), mul(l, s0))},
      {sub(add(mul(-e, c3), mul(f, c1)), mul(g, c0)),
       add(sub(mul(a, c3), mul(b, c1)), mul(c, c0)),
       sub(add(mul(-mm, s3), mul(n, s1)), mul(oo, s0)),
       add(sub(mul(i, s3), mul(j, s1)), mul(k, s0))},
  };
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) o[r][q] = mul(adj[r][q], inv_det);
}

// Exclusive rank of this thread among the flagged threads of the block
// (in thread order) and, in *total, the number flagged.  Every thread
// of the block must call it.
__device__ int block_rank(bool flag, int* warp_counts, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int offset = 0, sum = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int c = warp_counts[w];
    if (w < warp) offset += c;
    sum += c;
  }
  __syncthreads();  // warp_counts is reused by the next call
  *total = sum;
  return offset + rank;
}

struct State {
  const float* x;
  const float* P;
  const unsigned char* alive;
  const int* track_id;
  const int* hits;
  const int* hit_streak;
  const int* age;
  const int* tsu;
  const int* next_id;
  const int* frame_count;
};

struct StateOut {
  float* x;
  float* P;
  unsigned char* alive;
  int* track_id;
  int* hits;
  int* hit_streak;
  int* age;
  int* tsu;
  int* next_id;
  int* frame_count;
};

__global__ void sort_scan_kernel(const float* __restrict__ boxes,
                                 const unsigned char* __restrict__ valid,
                                 State in, StateOut out,
                                 int* __restrict__ det_track_id,
                                 unsigned char* __restrict__ det_report,
                                 int T, int D, int K, int max_age,
                                 int min_hits, float iou_threshold) {
  extern __shared__ float smem[];
  float* ben = smem;                        // [D, K] benefit
  float* det = ben + (size_t)D * K;         // [D, 4]
  float* best_val = det + 4 * D;            // [D]
  float* iou_at = best_val + D;             // [D]
  int* best_col = (int*)(iou_at + D);       // [D]
  int* r2c = best_col + D;                  // [D], -1 unassigned
  int* mutual = r2c + D;                    // [D]
  int* det_rank = mutual + D;               // [D]
  int* spawn_slot = det_rank + D;           // [D], -1 no birth
  int* dvalid = spawn_slot + D;             // [D]
  int* best_row = dvalid + D;               // [K]
  int* taken = best_row + K;                // [K]
  int* det_for_slot = taken + K;            // [K], -1 unmatched
  int* slot_of_rank = det_for_slot + K;     // [K]
  int* slot_id = slot_of_rank + K;          // [K]
  int* slot_rep = slot_id + K;              // [K]
  int* warp_counts = slot_rep + K;          // [32]

  const int tid = threadIdx.x;
  const bool is_slot = tid < K;
  const bool is_det = tid < D;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // This thread's slot, in registers for the whole clip.
  float x[7] = {0}, P[49] = {0};
  bool alive = false;
  int track_id = 0, hits = 0, streak = 0, age = 0, tsu = 0;
  if (is_slot) {
#pragma unroll
    for (int i = 0; i < 7; ++i) x[i] = in.x[tid * 7 + i];
#pragma unroll
    for (int i = 0; i < 49; ++i) P[i] = in.P[tid * 49 + i];
    alive = in.alive[tid] != 0;
    track_id = in.track_id[tid];
    hits = in.hits[tid];
    streak = in.hit_streak[tid];
    age = in.age[tid];
    tsu = in.tsu[tid];
  }
  int next_id = *in.next_id;
  int frame_count = *in.frame_count;

  for (int t = 0; t < T; ++t) {
    __syncthreads();  // the previous frame's shared reads are done
    ++frame_count;
    if (is_det) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        det[tid * 4 + q] = boxes[((size_t)t * D + tid) * 4 + q];
      dvalid[tid] = valid[(size_t)t * D + tid] != 0;
      r2c[tid] = -1;
      spawn_slot[tid] = -1;
    }

    // --- Kalman predict (alive slots), lifecycle counters ----------
    float trk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (is_slot) {
      det_for_slot[tid] = -1;
      if (alive) {
        const float x6 = (x[6] + x[2]) <= 0.0f ? 0.0f : x[6];
        x[0] = add(x[0], x[4]);
        x[1] = add(x[1], x[5]);
        x[2] = add(x[2], x6);
        x[6] = x6;
        // F P F^T + Q with F = I + (i, i+4) for i < 3.
        float Pn[49];
#pragma unroll
        for (int i = 0; i < 7; ++i)
#pragma unroll
          for (int j = 0; j < 7; ++j) {
            const bool ci = i < 3, cj = j < 3;
            float fp_j = P[i * 7 + j];
            if (ci) fp_j = add(fp_j, P[(i + 4) * 7 + j]);
            float v = fp_j;
            if (cj) {
              float fp_j4 = P[i * 7 + j + 4];
              if (ci) fp_j4 = add(fp_j4, P[(i + 4) * 7 + j + 4]);
              v = add(v, fp_j4);
            }
            Pn[i * 7 + j] = i == j ? add(v, q_diag(i)) : v;
          }
#pragma unroll
        for (int i = 0; i < 49; ++i) P[i] = Pn[i];
      }
      // ops/kalman.py::state_to_bbox of the (predicted) state.
      const float w = sqrtf(fmaxf(mul(x[2], x[3]), 0.0f));
      const float h = x[2] / fmaxf(w, 1e-6f);
      trk[0] = sub(x[0], w / 2.0f);
      trk[1] = sub(x[1], h / 2.0f);
      trk[2] = add(x[0], w / 2.0f);
      trk[3] = add(x[1], h / 2.0f);
      if (tsu > 0) streak = 0;
      if (alive) {
        ++age;
        ++tsu;
      }
    }
    __syncthreads();

    // --- benefit: IoU where the detection is valid and the slot alive
    if (is_slot) {
      for (int d = 0; d < D; ++d) {
        ben[d * K + tid] =
            (dvalid[d] && alive) ? iou(det + 4 * d, trk) : NEG;
      }
    }
    __syncthreads();

    // --- greedy mutual-best rounds to the fixpoint (<= D rounds) ----
    for (int round = 0; round < D; ++round) {
      // Row argmax (first max index): one warp per row.
      for (int d = warp; d < D; d += n_warps) {
        float bv = NEG;
        int bi = K;
        for (int k = lane; k < K; k += 32) {
          const float v = ben[d * K + k];
          if (bi == K || v > bv) {
            bv = v;
            bi = k;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, bv, off);
          const int oi = __shfl_down_sync(0xffffffffu, bi, off);
          if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (lane == 0) {
          best_val[d] = bv;
          best_col[d] = bi;
        }
      }
      // Column argmax (first max index): one thread per column.
      if (is_slot) {
        float bv = ben[tid];
        int bi = 0;
        for (int d = 1; d < D; ++d) {
          const float v = ben[d * K + tid];
          if (v > bv) {
            bv = v;
            bi = d;
          }
        }
        best_row[tid] = bi;
      }
      __syncthreads();
      if (is_det) {
        const int c = best_col[tid];
        const bool m = best_row[c] == tid && best_val[tid] > NEG / 2;
        mutual[tid] = m;
        if (m) {
          r2c[tid] = c;
          iou_at[tid] = best_val[tid];  // the benefit is the IoU there
        }
      }
      if (is_slot) {
        const int r = best_row[tid];
        taken[tid] = best_col[r] == tid && best_val[r] > NEG / 2;
      }
      __syncthreads();
      int open = 0;
      for (int idx = tid; idx < D * K; idx += blockDim.x) {
        const int d = idx / K, k = idx - d * K;
        if (mutual[d] || taken[k]) {
          ben[idx] = NEG;
        } else if (ben[idx] > NEG / 2) {
          open = 1;
        }
      }
      if (!__syncthreads_or(open)) break;
    }

    // --- IoU gate; matched measurements into slot order -------------
    bool good = false;
    if (is_det) {
      good = r2c[tid] >= 0 && iou_at[tid] >= iou_threshold;
      if (good) det_for_slot[r2c[tid]] = tid;
    }
    __syncthreads();

    // --- Kalman update on matched slots; deaths ----------------------
    if (is_slot) {
      const int dm = det_for_slot[tid];
      if (dm >= 0) {
        float z[4];
        bbox_to_z(det + 4 * dm, z);
        float S[4][4], Si[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            S[i][j] = i == j ? add(P[i * 7 + j], r_diag(i)) : P[i * 7 + j];
        inv4x4(S, Si);
        float Kg[7][4];
#pragma unroll
        for (int i = 0; i < 7; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float s = 0.0f;
#pragma unroll
            for (int q = 0; q < 4; ++q) s = fmaf(P[i * 7 + q], Si[q][j], s);
            Kg[i][j] = s;
          }
        float y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = sub(z[j], x[j]);
#pragma unroll
        for (int i = 0; i < 7; ++i) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) s = fmaf(Kg[i][j], y[j], s);
          x[i] = add(x[i], s);
        }
        // P <- (I - K H) P.
        float Pn[49];
#pragma unroll
        for (int i = 0; i < 7; ++i)
#pragma unroll
          for (int j = 0; j < 7; ++j) {
            float s = 0.0f;
#pragma unroll
            for (int q = 0; q < 7; ++q) {
              const float ikh =
                  (i == q ? 1.0f : 0.0f) - (q < 4 ? Kg[i][q] : 0.0f);
              s = fmaf(ikh, P[q * 7 + j], s);
            }
            Pn[i * 7 + j] = s;
          }
#pragma unroll
        for (int i = 0; i < 49; ++i) P[i] = Pn[i];
        ++hits;
        ++streak;
        tsu = 0;
      }
      alive = alive && tsu <= max_age;
    }

    // --- births: the i-th unmatched detection takes the i-th free slot
    int n_free, n_unmatched;
    const int free_rank = block_rank(is_slot && !alive, warp_counts,
                                     &n_free);
    const bool unmatched = is_det && dvalid[tid] && !good;
    const int rank = block_rank(unmatched, warp_counts, &n_unmatched);
    if (is_slot && !alive) slot_of_rank[free_rank] = tid;
    if (is_det) det_rank[tid] = rank;
    __syncthreads();
    if (unmatched && rank < n_free) {
      spawn_slot[tid] = slot_of_rank[rank];
      det_for_slot[slot_of_rank[rank]] = -2 - tid;  // born from det tid
    }
    __syncthreads();
    if (is_slot) {
      const int code = det_for_slot[tid];
      if (code <= -2) {
        const int d = -2 - code;
        bbox_to_z(det + 4 * d, x);
        x[4] = x[5] = x[6] = 0.0f;
#pragma unroll
        for (int i = 0; i < 49; ++i)
          P[i] = i % 8 == 0 ? p0_diag(i / 8) : 0.0f;
        track_id = next_id + det_rank[d];
        hits = 1;
        streak = 1;
        age = 0;
        tsu = 0;
        alive = true;
      }
      // Reporting rule (reference sort.py:245-248).
      slot_id[tid] = track_id;
      slot_rep[tid] = alive && tsu < 1 &&
                      (streak >= min_hits || frame_count <= min_hits);
    }
    next_id += min(n_unmatched, n_free);
    __syncthreads();

    // --- per-detection outputs ---------------------------------------
    if (is_det) {
      int id = 0, rep = 0;
      const int s = spawn_slot[tid];
      if (s >= 0) {
        id = slot_id[s];
        rep = slot_rep[s];
      } else if (good) {
        id = slot_id[r2c[tid]];
        rep = slot_rep[r2c[tid]];
      }
      det_track_id[(size_t)t * D + tid] = id;
      det_report[(size_t)t * D + tid] = (unsigned char)rep;
    }
  }

  if (is_slot) {
#pragma unroll
    for (int i = 0; i < 7; ++i) out.x[tid * 7 + i] = x[i];
#pragma unroll
    for (int i = 0; i < 49; ++i) out.P[tid * 49 + i] = P[i];
    out.alive[tid] = alive;
    out.track_id[tid] = track_id;
    out.hits[tid] = hits;
    out.hit_streak[tid] = streak;
    out.age[tid] = age;
    out.tsu[tid] = tsu;
  }
  if (tid == 0) {
    *out.next_id = next_id;
    *out.frame_count = frame_count;
  }
}

}  // namespace

// The wrapper guarantees contiguous tensors of the documented types,
// K, D <= 1024 and a [D, K] benefit matrix that fits shared memory.
extern "C" int tao_sort_scan_f32(
    const void* boxes, const void* valid, const void* x, const void* P,
    const void* alive, const void* track_id, const void* hits,
    const void* hit_streak, const void* age, const void* tsu,
    const void* next_id, const void* frame_count, void* x_out, void* P_out,
    void* alive_out, void* track_id_out, void* hits_out,
    void* hit_streak_out, void* age_out, void* tsu_out, void* next_id_out,
    void* frame_count_out, void* det_track_id, void* det_report, int T,
    int D, int K, int max_age, int min_hits, float iou_threshold,
    void* stream) {
  const int n = K > D ? K : D;
  const int threads = n < 32 ? 32 : (n + 31) / 32 * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)D * K + 4 * D + 2 * D) +
                      sizeof(int) * (6 * (size_t)D + 6 * (size_t)K + 32);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sort_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const State in{(const float*)x,        (const float*)P,
                 (const unsigned char*)alive, (const int*)track_id,
                 (const int*)hits,       (const int*)hit_streak,
                 (const int*)age,        (const int*)tsu,
                 (const int*)next_id,    (const int*)frame_count};
  const StateOut out{(float*)x_out,        (float*)P_out,
                     (unsigned char*)alive_out, (int*)track_id_out,
                     (int*)hits_out,       (int*)hit_streak_out,
                     (int*)age_out,        (int*)tsu_out,
                     (int*)next_id_out,    (int*)frame_count_out};
  sort_scan_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const unsigned char*)valid, in, out,
      (int*)det_track_id, (unsigned char*)det_report, T, D, K, max_age,
      min_hits, iou_threshold);
  return (int)cudaGetLastError();
}
