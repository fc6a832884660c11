// Distance tiles on the tensor cores with a rigorous float32 filter (sm_90a).
//
// Shared by the package's nearest-neighbour kernels.  A tile holds, for up
// to 32 query rows of a warp (two 16-row MMA tiles) and 8 candidate rows,
// the KEY
//
//     key[i][j] = (1 - eps) * |x'_j|^2  -  2 q'_i . x'_j
//
// where q' = fl(q - c) and x' = fl(x - c) are the rows centred in float32 on
// one vector c that the caller picks for the query block (its centroid).
// The product runs as `mma.sync.aligned.m16n8k8` in TF32 with a float32
// accumulator that starts at (1 - eps) |x'_j|^2 (computed in float32, so the
// norm never passes through TF32).  The key only decides which candidates
// are looked at exactly: a candidate is handed to the caller's exact path
// unless
//
//     key[i][j] >= threshold_i = tau_i (1 + gam) - (1 - eps) |q'_i|^2
//
// where tau_i is the row's current k-th exact distance.  The caller computes
// the exact distance D_f = sum_f32 (q - x)^2 itself, from the rows as they
// were given.
//
// Why no candidate with D_f < tau is ever dropped.  Write u = 2^-24 (float32
// unit roundoff), v = 2^-10 (TF32 keeps 11 significand bits; v covers both
// round-to-nearest, which `cvt.rna` gives, and truncation), nq = |q'|^2,
// nx = |x'|^2, D = |q - x|^2 in real arithmetic, KS the number of k-steps
// of 8, d the row width.
//   1. Centring: q' and x' carry one rounding each, so (q' - x') differs
//      from (q - x) by at most u (|q'| + |x'|) in norm and
//      D >= |q' - x'|^2 - 4 u' (nq + nx), u' = u / (1 - u).
//   2. |q' - x'|^2 = nq + nx - 2 q'.x' exactly.
//   3. TF32 operands: tf(a) = a (1 + t), |t| <= v.  The hardware multiplies
//      the rounded operands exactly, so the products' sum misses -2 q'.x' by
//      at most 2 (2 v + v^2) sum_i |q'_i x'_i|  <=  (2 v + v^2) (nq + nx):
//      the constant before 2^-10 * sum |(2 q'_i) x'_i| is c = 2 + 2^-10.
//   4. Accumulation: every k-step adds 8 products to the accumulator in
//      float32 with at worst truncation, an error of at most 9 * 2 u * M a
//      step with M <= 2.002 (nq + nx) the largest partial sum: 36 KS u
//      (nq + nx) in all.
//   5. The float32 norms nq_f, nx_f (in any order of summation) and the
//      products by (1 - eps) are off by at most (d + 2) u relative.
//   6. The exact path's own float32 sum: D_f >= D (1 - (d + 4) u).
// Together, with T the computed key,
//     D >= T + (1 - eps) nq_f          whenever
//     eps >= 2 v + v^2 + (36 KS + 2 d + 16) u,
// and D_f < tau implies T < tau / (1 - (d + 4) u) - (1 - eps) nq_f, which the
// threshold above exceeds once gam >= 2 (d + 8) u (the spare 16 u and the
// factor 2 absorb the roundings of the threshold's own evaluation).  The
// bound a * |q'| |x'| <= (a / 2) (nq + nx) makes the error separable into a
// part of the candidate (folded into the accumulator's start) and a part of
// the row (folded into its threshold); it is tight where |q'| ~ |x'|, which
// is where the candidates near tau live once c is the block's centroid.
// `ops/_dist_tile.py:filter_bound` computes eps and gam; the kernels take
// them as arguments.
//
// The exact path and the top-k that follow the filter are here too
// (`exact_sq_dist`, `TopKRegs`, `TopKLocal`, `TopKHeap`), so that both
// kernels decide their candidates with the same arithmetic: one fmaf chain
// over the coordinates in order, and a top-k that keeps the first k of the
// (distance, id) order of candidates met in ascending id order.
//
// Why mma.sync and not wgmma.  Measured on the 1,000,000-cell search of
// ivf_score (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): this design took
// 84.7 ms, a wgmma design (m64n128k8, the query rows' A operands in
// registers, key tiles as unswizzled core matrices in shared memory, the
// norm riding in two spare coordinates) 106.3 ms with identical results.  A
// probed block is one 128 x 128 x 24 product: too little for a warpgroup-wide
// operation to pay for what it adds, since every wgmma is a rendezvous of
// the block's four warps, whose exact paths take different times (launching
// them alone cost 19% of the warps' cycles, the compare of 64 accumulators
// at a time 26%).  With mma.sync a warp is on its own between two
// __syncthreads.  The price is the rate: independent mma.sync TF32
// operations reach 250 to 273 TFLOP/s on this card, not wgmma's 495.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dist_tile {

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// D (16 x 8, float32) += A (16 x 8, row-major) * B (8 x 8, column-major) in
// TF32.  With g = lane / 4 and t = lane % 4: a0 (row g, col t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, col g), b1 (k t + 4, col
// g); c0 (row g, col 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t), c3 (g + 8,
// 2 t + 1).  The sum over the 8 k positions does not depend on which
// coordinate sits at which position as long as A and B agree: the tiles
// here put coordinates 2 t and 2 t + 1 of a k-step at positions t and t + 4,
// so a thread's B operands of one k-step are one 8-byte load.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A * B + C with C given apart from D: the first k-step of a tile, whose
// accumulator starts at the candidates' (1 - eps) |x'|^2.
__device__ __forceinline__ void mma_tf32_start(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1,
                                               float c_even, float c_odd) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %10, %11};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c_even), "f"(c_odd));
}

// Row stride (floats) of a key tile of depth dk (a multiple of 8) in shared
// memory: congruent to 8 modulo 16, so that the 8-byte operand loads of a
// half warp (4 candidate rows x 4 coordinate pairs) fall into 16 different
// bank pairs.
__host__ __device__ constexpr int key_stride(int dk) {
  return dk % 16 == 8 ? dk : dk + 8;
}

// One candidate row of a key tile: centre the DQ coordinates at `src` on
// `cen`, write them rounded to TF32 to dst[0 .. DK) (zeros beyond DQ) and
// return the float32 squared norm of the centred row (four partial sums, so
// that the chain of dependent additions is DQ / 4 long).  `src`, `cen` and
// `dst` are 16-byte aligned, DQ a multiple of 4.
template <int DQ, int DK>
__device__ __forceinline__ float stage_key_row(const float* src,
                                               const float* cen, float* dst) {
  float n0 = 0.f, n1 = 0.f, n2 = 0.f, n3 = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < DK / 4; ++c4) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * c4 < DQ) {
      const float4 v = reinterpret_cast<const float4*>(src)[c4];
      const float4 m = reinterpret_cast<const float4*>(cen)[c4];
      const float e0 = v.x - m.x, e1 = v.y - m.y, e2 = v.z - m.z,
                  e3 = v.w - m.w;
      n0 = fmaf(e0, e0, n0);
      n1 = fmaf(e1, e1, n1);
      n2 = fmaf(e2, e2, n2);
      n3 = fmaf(e3, e3, n3);
      o = make_float4(__uint_as_float(tf32_rna(e0)),
                      __uint_as_float(tf32_rna(e1)),
                      __uint_as_float(tf32_rna(e2)),
                      __uint_as_float(tf32_rna(e3)));
    }
    reinterpret_cast<float4*>(dst)[c4] = o;
  }
  return (n0 + n1) + (n2 + n3);
}

// The A operands of one 16-row query tile, -2 (q - cen) rounded to TF32, for
// all KS k-steps: rows `r0` and `r0 + 8` of `q` (row stride DQ), a dead row
// (at or beyond `n_live`) as zeros.  `t` = lane % 4.
template <int DQ, int KS>
__device__ __forceinline__ void load_query_frags(const float* q,
                                                 const float* cen, int r0,
                                                 int n_live, int t,
                                                 uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {    // coordinate 8 s + 2 t + h
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // row r0 + 8 * half
        const int k = 8 * s + 2 * t + h;
        const int r = r0 + 8 * half;
        float v = 0.f;
        if (k < DQ && r < n_live) v = -2.f * (q[r * DQ + k] - cen[k]);
        a[s][2 * h + half] = tf32_rna(v);
      }
    }
  }
}

// The keys of one 8-candidate tile against the first ML of a warp's MT
// 16-row query tiles.  `brow` points at coordinate 2 t of candidate row g of
// the key tile; `start` holds (1 - eps) |x'|^2 of candidates 2 t and 2 t + 1.
template <int KS, int MT, int ML>
__device__ __forceinline__ void tile_keys(const float* brow, float2 start,
                                          const uint32_t (&a)[MT][KS][4],
                                          float (&acc)[ML][4]) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint2 b = *reinterpret_cast<const uint2*>(brow + 8 * s);
#pragma unroll
    for (int m = 0; m < ML; ++m) {
      if (s == 0) {
        mma_tf32_start(acc[m], a[m][0], b.x, b.y, start.x, start.y);
      } else {
        mma_tf32(acc[m], a[m][s], b.x, b.y);
      }
    }
  }
}

// Candidate tiles multiplied at a time: their MMA chains overlap and one
// vote covers them.  A key tile is padded to a multiple of 8 * kBatch rows
// (dead rows: zeros, start +inf), so that a batch is always whole.
constexpr int kBatch = 2;

// All keys of one staged key tile (`n_batches` batches of 8 * kBatch
// candidates; rows of stride key_stride(8 KS) at `kt`, accumulator starts at
// `st`) against the first ML of the warp's MT query tiles, each compared with
// its row's threshold `thr[m][h]` (row 16 m + 8 h + g of the warp).  A key
// below its threshold sets bit j of the row's 128-bit mask,
// `warp_masks[4 * row + j / 32]`, j the candidate's row in the tile.
// Returns whether any bit was set (the same value on every lane).
template <int KS, int MT, int ML>
__device__ __forceinline__ bool filter_tile(const float* kt, const float* st,
                                            int n_batches,
                                            const uint32_t (&a)[MT][KS][4],
                                            const float (&thr)[MT][2],
                                            uint32_t* warp_masks, int g,
                                            int t) {
  constexpr int BS = key_stride(8 * KS);
  bool any_pass = false;
  const float* brow = kt + g * BS + 2 * t;
  const float* srow = st + 2 * t;
  for (int bt = 0; bt < n_batches; ++bt) {
    float acc[kBatch][ML][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      tile_keys<KS, MT, ML>(brow + 8 * b * BS,
                            *reinterpret_cast<const float2*>(srow + 8 * b), a,
                            acc[b]);
    }
    // the least key of each of the thread's rows against the row's
    // threshold: a tree of minima, not a chain of compares
    bool pass = false;
#pragma unroll
    for (int m = 0; m < ML; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float least = fminf(acc[0][m][2 * h], acc[0][m][2 * h + 1]);
#pragma unroll
        for (int b = 1; b < kBatch; ++b) {
          least = fminf(least,
                        fminf(acc[b][m][2 * h], acc[b][m][2 * h + 1]));
        }
        pass |= least < thr[m][h];
      }
    }
    if (__any_sync(0xffffffffu, pass)) {
      any_pass = true;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = 8 * (kBatch * bt + b) + 2 * t;  // of acc[b][.][0], [2]
#pragma unroll
        for (int m = 0; m < ML; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (acc[b][m][e] < thr[m][e >> 1]) {
              const int row = 16 * m + 8 * (e >> 1) + g;
              const int col = j + (e & 1);
              atomicOr(&warp_masks[4 * row + (col >> 5)], 1u << (col & 31));
            }
          }
        }
      }
    }
    brow += 8 * kBatch * BS;
    srow += 8 * kBatch;
  }
  return any_pass;
}

// The row's threshold: a key at or above it cannot belong to a candidate
// closer than `tau` (header comment).  tau = +inf gives +inf.
__device__ __forceinline__ float filter_threshold(float tau, float nq,
                                                  float eps, float gam) {
  return fmaf(tau, gam, tau) - nq * (1.f - eps);
}

// --- the exact path ----------------------------------------------------------

// sum((q - x)^2) in float32 over DQ coordinates (zeros beyond the row's own
// width add nothing), one fmaf chain in coordinate order: the arithmetic of
// the package's first kernels, so that a candidate's distance has the same
// bits whichever kernel computes it.  `q` and `x` are 16-byte aligned.
template <int DQ>
__device__ __forceinline__ float exact_sq_dist(const float* q,
                                               const float* x) {
  const float4* qv = reinterpret_cast<const float4*>(q);
  const float4* kv = reinterpret_cast<const float4*>(x);
  float acc = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < DQ / 4; ++c4) {
    const float4 v = kv[c4];
    const float4 w = qv[c4];
    float t = w.x - v.x;
    acc = fmaf(t, t, acc);
    t = w.y - v.y;
    acc = fmaf(t, t, acc);
    t = w.z - v.z;
    acc = fmaf(t, t, acc);
    t = w.w - v.w;
    acc = fmaf(t, t, acc);
  }
  return acc;
}

constexpr int kMaxTopK = 128;  // the longest top-k of the kernels
constexpr int kRegK = 16;      // a top-k up to this long lives in registers

// A query row's sorted top-k.  insert() is called only with a distance
// below worst(); the strict '>' keeps a candidate met earlier ahead of a
// later one at equal distance, so a caller that meets its candidates in
// ascending id order keeps the first k of the (distance, id) order.
//
// In registers (k <= kRegK): every index is a compile-time constant, and an
// insertion is kRegK predicated moves, the same for every lane of the warp.
// Slots at and beyond k take part (they start at +inf and only ever receive
// what falls off the first k) and are never written out.
struct TopKRegs {
  float d[kRegK];
  int id[kRegK];
  float kth;
  __device__ __forceinline__ void init(int, float inf) {
#pragma unroll
    for (int s = 0; s < kRegK; ++s) {
      d[s] = inf;
      id[s] = 0;
    }
    kth = inf;
  }
  __device__ __forceinline__ float worst() const { return kth; }
  __device__ __forceinline__ void insert(int k, float dist, int cand) {
#pragma unroll
    for (int s = kRegK - 1; s >= 1; --s) {
      const bool shift = d[s - 1] > dist;  // d[s - 1] moves down to s
      const bool here = !shift && d[s] > dist;
      id[s] = shift ? id[s - 1] : (here ? cand : id[s]);
      d[s] = shift ? d[s - 1] : (here ? dist : d[s]);
    }
    if (d[0] > dist) {
      d[0] = dist;
      id[0] = cand;
    }
#pragma unroll
    for (int s = 0; s < kRegK; ++s) {
      if (s == k - 1) kth = d[s];
    }
  }
  // entries that were never filled (fewer than k candidates met, or a row
  // that is not live) are written as -inf with id 0
  __device__ __forceinline__ void write(int k, bool live, float inf,
                                        float* out_negd, int* out_idx) const {
#pragma unroll
    for (int s = 0; s < kRegK; ++s) {
      if (s < k) {
        const bool found = live && d[s] < inf;
        out_negd[s] = found ? -d[s] : -inf;
        out_idx[s] = found ? id[s] : 0;
      }
    }
  }
};

// In thread-local memory (k up to kMaxTopK): a sorted insertion that shifts
// the tail one slot at a time.
struct TopKLocal {
  float d[kMaxTopK];
  int id[kMaxTopK];
  float kth;
  __device__ __forceinline__ void init(int k, float inf) {
    for (int s = 0; s < k; ++s) {
      d[s] = inf;
      id[s] = 0;
    }
    kth = inf;
  }
  __device__ __forceinline__ float worst() const { return kth; }
  __device__ __forceinline__ void insert(int k, float dist, int cand) {
    int s = k - 1;
    while (s > 0 && d[s - 1] > dist) {
      d[s] = d[s - 1];
      id[s] = id[s - 1];
      --s;
    }
    d[s] = dist;
    id[s] = cand;
    kth = d[k - 1];
  }
  __device__ __forceinline__ void write(int k, bool live, float inf,
                                        float* out_negd, int* out_idx) const {
    for (int s = 0; s < k; ++s) {
      const bool found = live && d[s] < inf;
      out_negd[s] = found ? -d[s] : -inf;
      out_idx[s] = found ? id[s] : 0;
    }
  }
};

// In thread-local memory (k up to kMaxTopK) as a max-heap on (distance, id):
// an insertion touches one root-to-leaf path (log2 k entries, the upper
// levels shared by every insertion and so kept in L1) instead of the tail of
// a sorted list.  Candidates come in ascending id order, so a new one is
// larger in (distance, id) than every entry of equal distance: it enters
// when its distance is below the root's and evicts the root, the largest
// entry in that order.  The set kept is the first k of the (distance, id)
// order, as with a sorted insertion, and write() sorts it so (heap sort).
// It breaks ties by id, so it serves a caller that meets its candidates in
// ascending id order (knn_exact); ivf_score meets them in probe order and
// keeps TopKLocal, whose ties go to the candidate met first.
struct TopKHeap {
  float d[kMaxTopK];
  int id[kMaxTopK];
  int size;
  float kth;
  __device__ __forceinline__ static bool above(float da, int ia, float db,
                                               int ib) {
    return da > db || (da == db && ia > ib);
  }
  __device__ __forceinline__ void init(int, float inf) {
    size = 0;
    kth = inf;
  }
  __device__ __forceinline__ float worst() const { return kth; }
  // move (dist, cand) down from the root of the heap d[0 .. n)
  __device__ __forceinline__ void sift_down(int n, float dist, int cand) {
    int i = 0;
    for (;;) {
      int c = 2 * i + 1;
      if (c >= n) break;
      if (c + 1 < n && above(d[c + 1], id[c + 1], d[c], id[c])) ++c;
      if (!above(d[c], id[c], dist, cand)) break;
      d[i] = d[c];
      id[i] = id[c];
      i = c;
    }
    d[i] = dist;
    id[i] = cand;
  }
  __device__ __forceinline__ void insert(int k, float dist, int cand) {
    if (size < k) {  // filling: sift up
      int i = size++;
      while (i > 0) {
        const int p = (i - 1) >> 1;
        if (!above(dist, cand, d[p], id[p])) break;
        d[i] = d[p];
        id[i] = id[p];
        i = p;
      }
      d[i] = dist;
      id[i] = cand;
      if (size == k) kth = d[0];
    } else {  // full: the new entry replaces the root
      sift_down(k, dist, cand);
      kth = d[0];
    }
  }
  // sorts the heap in place into ascending (distance, id) order, then
  // writes it; entries never filled are -inf with id 0
  __device__ __forceinline__ void write(int k, bool live, float inf,
                                        float* out_negd, int* out_idx) {
    for (int end = size - 1; end > 0; --end) {
      const float last_d = d[end];
      const int last_id = id[end];
      d[end] = d[0];
      id[end] = id[0];
      sift_down(end, last_d, last_id);
    }
    for (int s = 0; s < k; ++s) {
      const bool found = live && s < size && d[s] < inf;
      out_negd[s] = found ? -d[s] : -inf;
      out_idx[s] = found ? id[s] : 0;
    }
  }
};

// --- staging: one contiguous run from global to shared memory, completion
// on an mbarrier (cp.async.bulk, the linear form of the TMA) ---------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier has left the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from `src` (global, 16-byte aligned) to `dst`
// (shared, 16-byte aligned); `bar` receives the bytes as transactions.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace dist_tile
