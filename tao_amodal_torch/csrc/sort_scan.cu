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
// ties), the IoU gate, the Kalman update with the closed-form 4x4
// inverse of ops/kalman.py, deaths, births in rank order, next_id and
// the reporting rule.
//
// Bound: latency, a chain of dependent block-wide phases per frame.
// Design: one block of NT threads per SORT state; the state, the
// frame's detections and the [D, K] benefit matrix live in shared
// memory.
//  - The IoU gate comes first: a benefit below iou_threshold is NEG
//    before the greedy rounds.  Sequential greedy takes the largest
//    benefit first (ties by row, then column, which is what first-max-
//    index mutual-best rounds compute), so it takes every pair at or
//    above the gate before any pair below it, and a pair below the gate
//    is dropped by the gate anyway: the gated fixpoint keeps exactly the
//    matches that survive the gate, and every integer output is the
//    ungated loop's.  The rounds fall from up to min(valid detections,
//    alive slots) to the longest chain of competing overlaps.
//  - Matched rows and taken columns are bit masks; the matrix is never
//    rewritten.  A row's argmax is recomputed only when its best column
//    was taken, a column's only when its best row was matched (values
//    only ever leave).  Row d and column k belong to warp d % NW and
//    k % NW, so a round reads and writes them without a race; each
//    argmax is one warp reduction (__reduce_max_sync on an order-
//    preserving key of the value, then __reduce_min_sync on the index).
//  - The benefit holds only the valid detections' rows and the alive
//    slots' columns, each compacted in order (so first-index ties fall
//    as they would on the full matrix).  The lists are kept up to date
//    in phases that meet anyway: the alive slots at the births, the
//    next frame's valid detections beside the births' ranks.
//  - The warp that fills a row of the benefit also reduces its argmax;
//    a column's argmax is reduced only where the column has an entry
//    at or above the gate, and an IoU divides only where boxes overlap.
//  - Four threads per slot share the Kalman algebra (rows i and i + 4
//    of P each), in the plain version's operation order.
// The IoU, box and inverse arithmetic uses round-to-nearest intrinsics
// that are never fused into FMAs, in the plain version's order.  No
// host sync inside the clip.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;  // threads of the block
constexpr int NW = NT / 32;
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
__device__ __forceinline__ void bbox_to_z(float4 b, float* z) {
  const float w = sub(b.z, b.x);
  const float h = sub(b.w, b.y);
  z[0] = add(b.x, w / 2.0f);
  z[1] = add(b.y, h / 2.0f);
  z[2] = mul(w, h);
  z[3] = w / fmaxf(h, 1e-6f);
}

// ops/boxes.py::box_iou_xyxy for one (detection a, track b) pair.
__device__ __forceinline__ float iou(float4 a, float4 b) {
  const float x0 = fmaxf(a.x, b.x);
  const float y0 = fmaxf(a.y, b.y);
  const float x1 = fminf(a.z, b.z);
  const float y1 = fminf(a.w, b.w);
  const float inter =
      mul(fmaxf(sub(x1, x0), 0.0f), fmaxf(sub(y1, y0), 0.0f));
  if (inter == 0.0f) return 0.0f;  // inter / uni, or 0: no division
  const float area_a = mul(sub(a.z, a.x), sub(a.w, a.y));
  const float area_b = mul(sub(b.z, b.x), sub(b.w, b.y));
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

// An unsigned key that orders like the float (for values that are not
// NaN); 0 is below every such key and marks a masked entry.
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// First-max-index argmax over the unmasked entries e = lane + 32 j < n
// of a strided vector (stride `step` floats), by the whole warp.
// mask[j] bit lane set = entry lane + 32 j is masked.  Writes the best
// value (NEG when every entry is masked) and index from lane 0.
__device__ __forceinline__ void warp_argmax(const float* v, int step, int n,
                                            const unsigned* mask, int lane,
                                            float* best_val, int* best_idx) {
  unsigned lk = 0;
  int li = 0x7fffffff;
  for (int j = 0, e = lane; e < n; ++j, e += 32) {
    if (!((mask[j] >> lane) & 1u)) {
      const unsigned k = key_of(v[e * step]);
      if (k > lk) {
        lk = k;
        li = e;
      }
    }
  }
  const unsigned m = __reduce_max_sync(0xffffffffu, lk);
  const int i = __reduce_min_sync(0xffffffffu, lk == m ? li : 0x7fffffff);
  if (lane == 0) {
    *best_val = m ? value_of(m) : NEG;
    *best_idx = m ? i : 0;
  }
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

// Shared memory of one block, in the order laid out below
// (tao_sort_scan_smem sizes it); the benefit's row stride is odd.
__host__ __device__ constexpr int stride_k(int K) { return K | 1; }

__global__ void __launch_bounds__(NT)
    sort_scan_kernel(const float* __restrict__ boxes,
                     const unsigned char* __restrict__ valid, State in,
                     StateOut out, int* __restrict__ det_track_id,
                     unsigned char* __restrict__ det_report, int T, int D,
                     int K, int max_age, int min_hits,
                     float iou_threshold) {
  extern __shared__ float4 smem4[];
  const int Kp = stride_k(K);
  const int DW = (D + 31) >> 5, KW = (K + 31) >> 5;
  float4* ctrk = smem4;                      // [K] alive slots' boxes
  float4* det = ctrk + K;                    // [D] the frame's boxes
  float4* cdet = det + D;                    // [D] valid ones' boxes
  float* ben = (float*)(cdet + D);           // [D, Kp] gated benefit
  float* Ps = ben + (size_t)D * Kp;          // [K, 49]
  float* xs = Ps + 49 * K;                   // [K, 8]
  float* rbv = xs + 8 * K;                   // [D] row best value
  float* cbv = rbv + D;                      // [K] column best value
  int* rbc = (int*)(cbv + K);                // [D] row best column
  int* r2c = rbc + D;                        // [D] -1 unmatched
  int* good = r2c + D;                       // [D]
  int* dvalid = good + D;                    // [D]
  int* cbr = dvalid + D;                     // [K] column best row
  int* alive = cbr + K;                      // [K]
  int* track = alive + K;                    // [K]
  int* hits = track + K;                     // [K]
  int* streak = hits + K;                    // [K]
  int* age = streak + K;                     // [K]
  int* tsu = age + K;                        // [K]
  int* dfs = tsu + K;                        // [K] matched det, -1
  int* sor = dfs + K;                        // [K] slot of free rank
  int* frank = sor + K;                      // [K] free rank, -1 alive
  int* alist = frank + K;                    // [K] alive slots, in order
  int* cslot = alist + K;                    // [K] column of an alive slot
  int* dlist = cslot + K;                    // [D] valid detections
  unsigned* rowm = (unsigned*)(dlist + D);   // [DW] matched rows
  unsigned* colt = rowm + DW;                // [KW] taken columns
  unsigned* cand = colt + KW;                // [KW] columns with entries
  int* wc = (int*)(cand + KW);               // [3 NW] warp counts
  // Rows and columns of the benefit, ben and the argmaxes, the masks
  // and the rounds are compact: row i is detection dlist[i], column c
  // slot alist[c].

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // Four threads per slot: rows part and part + 4 of its P.
  const int part = tid & 3;
  const unsigned group = 0xfu << (lane & 28);

  for (int s = tid; s < K; s += NT) {
#pragma unroll
    for (int q = 0; q < 7; ++q) xs[s * 8 + q] = in.x[s * 7 + q];
    alive[s] = in.alive[s] != 0;
    track[s] = in.track_id[s];
    hits[s] = in.hits[s];
    streak[s] = in.hit_streak[s];
    age[s] = in.age[s];
    tsu[s] = in.tsu[s];
  }
  for (int i = tid; i < 49 * K; i += NT) Ps[i] = in.P[i];
  int next_id = *in.next_id;
  int frame_count = *in.frame_count;

  // This thread's detection of the next frame, loaded a frame ahead.
  float4 nb = make_float4(0.f, 0.f, 0.f, 0.f);
  int nv = 0;
  if (tid < D && T > 0) {
    nb = make_float4(boxes[tid * 4], boxes[tid * 4 + 1], boxes[tid * 4 + 2],
                     boxes[tid * 4 + 3]);
    nv = valid[tid] != 0;
  }
  const unsigned below = (1u << lane) - 1u;

  // The alive slots and the first frame's valid detections, in order;
  // nidx is this thread's row if its next detection is valid.
  int n_alive = 0, n_valid = 0, nidx = 0;
  __syncthreads();  // alive[] is in
  {
    const bool al = tid < K && alive[tid];
    const unsigned ba = __ballot_sync(0xffffffffu, al);
    const unsigned bv = __ballot_sync(0xffffffffu, nv != 0);
    if (lane == 0) {
      wc[warp] = __popc(ba);
      wc[NW + warp] = __popc(bv);
    }
    __syncthreads();
    int oa = 0, ov = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int ca = wc[w], cv = wc[NW + w];
      if (w < warp) {
        oa += ca;
        ov += cv;
      }
      n_alive += ca;
      n_valid += cv;
    }
    if (al) {
      const int c = oa + __popc(ba & below);
      alist[c] = tid;
      cslot[tid] = c;
    }
    nidx = ov + __popc(bv & below);
  }

  for (int t = 0; t < T; ++t) {
    __syncthreads();  // the previous frame's births are in
    ++frame_count;
    if (tid < D) {
      det[tid] = nb;
      dvalid[tid] = nv;
      if (nv) {
        cdet[nidx] = nb;
        dlist[nidx] = tid;
      }
      r2c[tid] = -1;
      good[tid] = 0;
      if (t + 1 < T) {
        const float* b = boxes + ((size_t)(t + 1) * D + tid) * 4;
        nb = make_float4(b[0], b[1], b[2], b[3]);
        nv = valid[(size_t)(t + 1) * D + tid] != 0;
      }
    }
    if (tid < DW) rowm[tid] = 0u;
    if (tid < KW) colt[tid] = cand[tid] = 0u;

    // --- Kalman predict (alive slots), lifecycle counters ----------
    for (int s = tid >> 2; s < K; s += NT / 4) {
      const bool al = alive[s] != 0;
      float* P = Ps + 49 * s;
      float pn[2][7];
      if (al) {
        // F P F^T + Q with F = I + (i, i+4) for i < 3.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = part + 4 * r;
          if (i < 7) {
            const bool ci = i < 3;
#pragma unroll
            for (int j = 0; j < 7; ++j) {
              float fp_j = P[i * 7 + j];
              if (ci) fp_j = add(fp_j, P[(i + 4) * 7 + j]);
              float v = fp_j;
              if (j < 3) {
                float fp_j4 = P[i * 7 + j + 4];
                if (ci) fp_j4 = add(fp_j4, P[(i + 4) * 7 + j + 4]);
                v = add(v, fp_j4);
              }
              pn[r][j] = i == j ? add(v, q_diag(i)) : v;
            }
          }
        }
      }
      __syncwarp(group);
      if (al) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = part + 4 * r;
          if (i < 7) {
#pragma unroll
            for (int j = 0; j < 7; ++j) P[i * 7 + j] = pn[r][j];
          }
        }
      }
      if (part == 0) {
        float* x = xs + 8 * s;
        float x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
        if (al) {
          const float x6 = (x[6] + x2) <= 0.0f ? 0.0f : x[6];
          x0 = add(x0, x[4]);
          x1 = add(x1, x[5]);
          x2 = add(x2, x6);
          x[0] = x0;
          x[1] = x1;
          x[2] = x2;
          x[6] = x6;
        }
        // ops/kalman.py::state_to_bbox of the (predicted) state.
        const float w = sqrtf(fmaxf(mul(x2, x3), 0.0f));
        const float h = x2 / fmaxf(w, 1e-6f);
        if (al)
          ctrk[cslot[s]] = make_float4(sub(x0, w / 2.0f), sub(x1, h / 2.0f),
                                       add(x0, w / 2.0f), add(x1, h / 2.0f));
        if (tsu[s] > 0) streak[s] = 0;
        if (al) {
          ++age[s];
          ++tsu[s];
        }
        dfs[s] = -1;
      }
    }
    __syncthreads();

    // --- benefit: the IoU of each valid detection and alive slot, NEG
    // below the gate (a +0 IoU stays +0: keys order it above -0); each
    // row's argmax; which columns hold an entry.
    unsigned has = 0;  // bit j: column lane + 32 j has an entry here
    for (int i = warp; i < n_valid; i += NW) {
      const float4 a = cdet[i];
      float* row = ben + (size_t)i * Kp;
      unsigned lk = 0;
      int li = 0x7fffffff;
      for (int j = 0, c = lane; c < n_alive; ++j, c += 32) {
        float v = NEG;
        const float u = iou(a, ctrk[c]);
        if (u >= iou_threshold) {
          v = add(u, 0.0f);
          has |= 1u << j;
        }
        row[c] = v;
        const unsigned key = key_of(v);
        if (key > lk) {
          lk = key;
          li = c;
        }
      }
      const unsigned m = __reduce_max_sync(0xffffffffu, lk);
      const int best = __reduce_min_sync(0xffffffffu,
                                         lk == m ? li : 0x7fffffff);
      if (lane == 0) {
        rbv[i] = m ? value_of(m) : NEG;
        rbc[i] = m ? best : 0;
      }
    }
    for (int j = 0; j < KW; ++j) {
      const unsigned b = __ballot_sync(0xffffffffu, (has >> j) & 1u);
      if (lane == 0 && b) atomicOr(cand + j, b);
    }
    __syncthreads();

    // --- every column's argmax (NEG, row 0 where it has no entry) ----
    for (int c = warp; c < n_alive; c += NW) {
      if ((cand[c >> 5] >> (c & 31)) & 1u) {
        warp_argmax(ben + c, Kp, n_valid, rowm, lane, cbv + c, cbr + c);
      } else if (lane == 0) {
        cbv[c] = NEG;
        cbr[c] = 0;
      }
    }
    __syncthreads();

    // --- greedy mutual-best rounds to the fixpoint --------------------
    for (int round = 0;; ++round) {
      // Match every open row whose best column's best row is the row.
      bool open = false;
      if (tid < n_valid && !((rowm[tid >> 5] >> (tid & 31)) & 1u) &&
          rbv[tid] > NEG / 2) {
        open = true;
        const int c = rbc[tid];
        if (cbr[c] == tid) {
          atomicOr(rowm + (tid >> 5), 1u << (tid & 31));
          atomicOr(colt + (c >> 5), 1u << (c & 31));
          const int d = dlist[tid], k = alist[c];
          r2c[d] = k;
          if (rbv[tid] >= iou_threshold) {  // always, once gated
            good[d] = 1;
            dfs[k] = d;
          }
        }
      }
      if (!__syncthreads_or(open) || round + 1 >= D) break;
      // Recompute the argmaxes that lost their best entry: this warp's
      // rows (d % NW == warp) and columns (k % NW == warp).
      unsigned rows = 0, cols = 0;
      {
        const int i = warp + NW * lane;
        if (i < n_valid && !((rowm[i >> 5] >> (i & 31)) & 1u) &&
            rbv[i] > NEG / 2) {
          const int c = rbc[i];
          rows = (colt[c >> 5] >> (c & 31)) & 1u;
        }
        const int c = warp + NW * lane;
        if (c < n_alive && cbv[c] > NEG / 2 &&
            !((colt[c >> 5] >> (c & 31)) & 1u)) {
          const int r = cbr[c];
          cols = (rowm[r >> 5] >> (r & 31)) & 1u;
        }
      }
      rows = __ballot_sync(0xffffffffu, rows);
      cols = __ballot_sync(0xffffffffu, cols);
      while (rows) {
        const int i = warp + NW * (__ffs(rows) - 1);
        rows &= rows - 1;
        warp_argmax(ben + (size_t)i * Kp, 1, n_alive, colt, lane, rbv + i,
                    rbc + i);
      }
      while (cols) {
        const int c = warp + NW * (__ffs(cols) - 1);
        cols &= cols - 1;
        warp_argmax(ben + c, Kp, n_valid, rowm, lane, cbv + c, cbr + c);
      }
      __syncthreads();
    }

    // --- Kalman update on matched slots; deaths ----------------------
    for (int s = tid >> 2; s < K; s += NT / 4) {
      const int dm = dfs[s];
      float* P = Ps + 49 * s;
      float* x = xs + 8 * s;
      float pn[2][7], xn[2];
      if (dm >= 0) {
        float z[4];
        bbox_to_z(det[dm], z);
        float S[4][4], Si[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            S[i][j] = i == j ? add(P[i * 7 + j], r_diag(i)) : P[i * 7 + j];
        inv4x4(S, Si);
        float y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = sub(z[j], x[j]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = part + 4 * r;
          if (i < 7) {
            float Kg[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float s_ = 0.0f;
#pragma unroll
              for (int q = 0; q < 4; ++q)
                s_ = fmaf(P[i * 7 + q], Si[q][j], s_);
              Kg[j] = s_;
            }
            float s_ = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) s_ = fmaf(Kg[j], y[j], s_);
            xn[r] = add(x[i], s_);
            // P <- (I - K H) P, row i.
#pragma unroll
            for (int j = 0; j < 7; ++j) {
              float acc = 0.0f;
#pragma unroll
              for (int q = 0; q < 7; ++q) {
                const float ikh =
                    (i == q ? 1.0f : 0.0f) - (q < 4 ? Kg[q] : 0.0f);
                acc = fmaf(ikh, P[q * 7 + j], acc);
              }
              pn[r][j] = acc;
            }
          }
        }
      }
      __syncwarp(group);
      if (dm >= 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = part + 4 * r;
          if (i < 7) {
            x[i] = xn[r];
#pragma unroll
            for (int j = 0; j < 7; ++j) P[i * 7 + j] = pn[r][j];
          }
        }
      }
      if (part == 0) {
        if (dm >= 0) {
          ++hits[s];
          ++streak[s];
          tsu[s] = 0;
        }
        alive[s] = alive[s] && tsu[s] <= max_age;
      }
    }
    __syncthreads();

    // --- births: the i-th unmatched detection takes the i-th free slot;
    // the next frame's valid detections in order.
    const bool is_free = tid < K && !alive[tid];
    const bool unmatched = tid < D && dvalid[tid] && !good[tid];
    const unsigned bf = __ballot_sync(0xffffffffu, is_free);
    const unsigned bu = __ballot_sync(0xffffffffu, unmatched);
    const unsigned bn = __ballot_sync(0xffffffffu, nv != 0);
    if (lane == 0) {
      wc[warp] = __popc(bf);
      wc[NW + warp] = __popc(bu);
      wc[2 * NW + warp] = __popc(bn);
    }
    __syncthreads();
    int n_free = 0, n_unmatched = 0, free_rank = 0, rank = 0;
    n_valid = nidx = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int cf = wc[w], cu = wc[NW + w], cn = wc[2 * NW + w];
      if (w < warp) {
        free_rank += cf;
        rank += cu;
        nidx += cn;
      }
      n_free += cf;
      n_unmatched += cu;
      n_valid += cn;
    }
    free_rank += __popc(bf & below);
    rank += __popc(bu & below);
    nidx += __popc(bn & below);
    if (tid < K) {
      frank[tid] = is_free ? free_rank : -1;
      if (is_free) sor[free_rank] = tid;
    }
    __syncthreads();

    // --- births and per-detection outputs ----------------------------
    // Reporting rule (reference sort.py:245-248): alive, updated this
    // frame, and streak >= min_hits or still in the first min_hits
    // frames.  A born slot has streak 1.
    const int born_rep = 1 >= min_hits || frame_count <= min_hits;
    if (tid < D) {
      int id = 0, rep = 0;
      if (unmatched && rank < n_free) {
        const int s = sor[rank];
        float* x = xs + 8 * s;
        bbox_to_z(det[tid], x);
        x[4] = x[5] = x[6] = 0.0f;
#pragma unroll
        for (int i = 0; i < 49; ++i)
          Ps[49 * s + i] = i % 8 == 0 ? p0_diag(i / 8) : 0.0f;
        id = next_id + rank;
        track[s] = id;
        hits[s] = 1;
        streak[s] = 1;
        age[s] = 0;
        tsu[s] = 0;
        alive[s] = 1;
        rep = born_rep;
      } else if (good[tid]) {
        const int c = r2c[tid];
        const int r = frank[c];
        if (r < 0) {  // alive: updated this frame, tsu 0
          id = track[c];
          rep = streak[c] >= min_hits || frame_count <= min_hits;
        } else if (r < n_unmatched) {  // died (max_age < 0), reborn
          id = next_id + r;
          rep = born_rep;
        } else {
          id = track[c];
        }
      }
      det_track_id[(size_t)t * D + tid] = id;
      det_report[(size_t)t * D + tid] = (unsigned char)rep;
    }
    // The alive slots after the births, in order: the slots that were
    // alive and the first `born` free ones.
    const int born = min(n_unmatched, n_free);
    if (tid < K && (!is_free || free_rank < born)) {
      const int c = tid - free_rank + min(free_rank, born);
      alist[c] = tid;
      cslot[tid] = c;
    }
    n_alive = K - n_free + born;
    next_id += born;
  }
  __syncthreads();

  for (int s = tid; s < K; s += NT) {
#pragma unroll
    for (int q = 0; q < 7; ++q) out.x[s * 7 + q] = xs[s * 8 + q];
    out.alive[s] = (unsigned char)alive[s];
    out.track_id[s] = track[s];
    out.hits[s] = hits[s];
    out.hit_streak[s] = streak[s];
    out.age[s] = age[s];
    out.tsu[s] = tsu[s];
  }
  for (int i = tid; i < 49 * K; i += NT) out.P[i] = Ps[i];
  if (tid == 0) {
    *out.next_id = next_id;
    *out.frame_count = frame_count;
  }
}

// Latency of one dependent block-wide phase as the kernel above runs
// them: every thread reads a word another thread wrote in the previous
// phase, writes its own, and the block meets at __syncthreads.  Thread
// 0 writes the mean SM cycles (clock64) and nanoseconds (globaltimer)
// per phase.
__global__ void __launch_bounds__(NT)
    phase_probe_kernel(long long* out, int iters) {
  __shared__ int buf[2][NT];
  const int tid = threadIdx.x;
  int v = tid;
  buf[0][tid] = v;
  __syncthreads();
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
    v = buf[i & 1][(tid + 33 + (v & 1)) & (NT - 1)];
    buf[(i + 1) & 1][tid] = v + 1;
    __syncthreads();
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  if (tid == 0) {
    out[0] = (c1 - c0) / iters;
    out[1] = (long long)(g1 - g0);
    out[2] = v;  // keeps the chain live
  }
}

}  // namespace

// Shared memory the kernel needs for D detections and K slots, or -1
// where the kernel does not take them (K, D <= NT, K >= 1).
extern "C" long long tao_sort_scan_smem(int D, int K) {
  if (K > NT || D > NT || K < 1 || D < 0) return -1;
  const long long DW = (D + 31) / 32, KW = (K + 31) / 32;
  return 16LL * (K + 2LL * D) +
         4LL * ((long long)D * stride_k(K) + 57LL * K) + 4LL * (D + K) +
         4LL * (5LL * D + 12LL * K) + 4LL * (DW + 2LL * KW + 3LL * NW);
}

// The wrapper guarantees contiguous tensors of the documented types
// and shared memory (tao_sort_scan_smem) within a block's limit.
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
  const long long smem = tao_sort_scan_smem(D, K);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sort_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const State in{(const float*)x,             (const float*)P,
                 (const unsigned char*)alive, (const int*)track_id,
                 (const int*)hits,            (const int*)hit_streak,
                 (const int*)age,             (const int*)tsu,
                 (const int*)next_id,         (const int*)frame_count};
  const StateOut out{(float*)x_out,             (float*)P_out,
                     (unsigned char*)alive_out, (int*)track_id_out,
                     (int*)hits_out,            (int*)hit_streak_out,
                     (int*)age_out,             (int*)tsu_out,
                     (int*)next_id_out,         (int*)frame_count_out};
  sort_scan_kernel<<<1, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const unsigned char*)valid, in, out,
      (int*)det_track_id, (unsigned char*)det_report, T, D, K, max_age,
      min_hits, iou_threshold);
  return (int)cudaGetLastError();
}

// out: device int64 [3] (cycles per phase, total ns, a sink).
extern "C" int tao_sort_scan_phase_probe(void* out, int iters,
                                         void* stream) {
  phase_probe_kernel<<<1, NT, 0, (cudaStream_t)stream>>>((long long*)out,
                                                         iters);
  return (int)cudaGetLastError();
}
