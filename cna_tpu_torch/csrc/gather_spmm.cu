// Gather SpMM on Hopper (sm_90a): the diffusion step's sparse-times-dense
// product for the port's ELL graphs, one launch, one write of the result.
//
// Replaces no TPU kernel: the TPU package ran this product as an XLA gather
// plus einsum (cna_tpu/ops/spmm.py, ell_spmm and sorted_ext_spmm), never as
// a Pallas kernel.  It was added because that gather was the largest cost on
// the card in every association (ops/spmm.py's plain version writes an
// (N, K, S) gather buffer, reads it back for the contraction, and spends
// further full passes on the bucket outputs, their concatenation, the
// restoring row gather, the division by the column sums and the self term).
//
// For every output row i and every column c it computes
//
//     y[i, c] = sum_k w[i, k] * (x[j_k, c] / d[j_k])          (the graph)
//             + self_weight * (x[i, c] / d[i])                 (scaled mode)
//
// the reference's diffusion body (_nam.py:28,33: a @ (s / colsums) +
// self_weight * s / colsums) with d the column sums; in bare mode (no d, no
// self term) it is y = A @ x, ops/spmm.py:ell_spmm.  A row's edges are read
// straight from the graph as built: first its `kd` direct slots (row i of
// the (N, kd) arrays), then its mirror slots, which live in one of up to
// kMaxBuckets in-degree buckets: position p = inv_pi[i] of the
// concatenation of the buckets' rows picks the bucket and the row in it
// (graph/device.py:SortedExtGraph; slices carried over from the TPU package
// may be padded and overlap, and inv_pi still names one row of the
// concatenation).  Slots whose weight is 0 are skipped, as are ids outside
// [0, n_x) (the graph builders emit none); a skipped slot added an exact 0
// in the plain version (for finite x).  The COO spill (about 1e-4 of the
// mirror edges) is added outside the kernel.
//
// Arithmetic: the state's own type (float32 by fmaf, or float64), no TF32.
// Each term is w * (x / d) with an IEEE division, the same quotient as the
// plain version's `s / colsums`; the sum runs in a fixed order, the direct
// slots, then the mirror slots, then the self term added last (a rounded
// product, then a rounded sum, as the plain version adds it).  A term whose
// dividend is 0 is left out where that changes no bit of the sum
// (`zero_quotient_exact`).  No atomics: a row's sums stay in one thread
// group's registers, so the result is the same bit for bit from run to run.
//
// What bounds it on this card.  The least traffic of a step is the state
// read once, the result written once, the column sums, and an id and a
// weight per edge: 1.13 GB at 500,089 cells x 259 samples in float32,
// 0.34 ms at 3.35 TB/s.  Two operations per edge and column are far below
// the float32 rate, but the gathered elements are many (2.9e9 a step at
// that shape, each read, divided and added by one lane), so the issue of
// those instructions, a division's ten or so above all, bounds it before
// the bytes do.  The design:
// * no intermediate in device memory: no (N, K, S) gather, no scaled state,
//   no bucket outputs; y is written once;
// * a group of L lanes owns a whole output row (L = 32 from 32 vectors of
//   columns up, fewer for narrow states); neighbouring lanes hold
//   neighbouring columns, V consecutive columns a lane (V = 4, 2 or 1 by the
//   divisibility and alignment of the state's rows: rows of 259 float32 are
//   1,036 bytes, so they are read a column a lane, each gathered row as
//   coalesced 128-byte requests), NV vectors a lane; wider states loop over
//   column chunks;
// * the group loads L slots' ids and weights at once (one coalesced load
//   each) and keeps the live ones, in order, in its part of the block's
//   shared memory with their column sums, so that no lane spends
//   instructions on an empty slot and a gathered row's loads go out
//   together (kU rows at a time for narrow states);
// * blocks take consecutive rows, so that rows gathered by neighbouring
//   rows of the IVF compact order come from the 50 MB L2 cache (at 500,089
//   cells 61% of the direct edges join rows less than 49,152 apart).
// Measured at 500,089 x 259 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
// a first design that passed one slot at a time by warp shuffles and
// branched on empty slots took 8.7 ms on a dense state (3.5 ms with the
// division taken out); this one 3.8 to 4.2 ms (2.6 ms without the
// division), and on the association's one-hot first state 3.3 ms (8.7 ms
// before zero dividends were left out); its direct columns alone 2.4 ms,
// against 1.9 ms with every id moved within 64 rows of its row and 3.3 ms
// with uniform ids; torch.sparse.mm of the same CSR 4.8 ms.  A division
// from a reciprocal a divisor (Markstein's two fma corrections, the same
// bits) was no faster than the IEEE division.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 4;  // the graph builders emit at most 4

template <typename T>
struct Buckets {
  const int* idx[kMaxBuckets];
  const T* w[kMaxBuckets];
  long long start[kMaxBuckets];  // first position in the concatenation
  long long rows[kMaxBuckets];
  int width[kMaxBuckets];
  int count;
};

// V consecutive elements of a row, loaded and stored as one request
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ inline float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ inline double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
// a rounded product and a rounded sum, never contracted into one fma
__device__ inline float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ inline float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ inline double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Whether a term with a dividend of 0 may be left out: 0 / d is then an
// exact signed zero and so is the term, and adding a signed zero leaves a
// sum that started at +0 as it is (such a sum is never -0 in round to
// nearest).  Not for a divisor of 0 or one that is not finite (0 / d is
// then a NaN).  Skipping them spares the IEEE division its slow path, which
// it takes for a zero dividend: the association's first steps are 95 to
// 99.6% exact zeros.
template <typename T>
__device__ __forceinline__ bool zero_quotient_exact(T d) {
  return isfinite(d) && d != T(0);
}

// Add the slots [0, k) of one row (ids `idx`, weights `w`) to the group's
// sums.  `kmax` is the largest k over the warp's groups, so that every lane
// runs the warp-wide steps the same number of times.  The group's L lanes
// load L slots at once; the live ones (weight not 0, id in range) go, in
// their order, to the group's part of the block's shared arrays with their
// column sums; then each lane walks them kU at a time, all kU gathered rows
// requested before the first is added.
template <typename T, int V, int NV, int L>
__device__ __forceinline__ void add_slots(T (&acc)[NV][V],
                                          const int* __restrict__ idx,
                                          const T* __restrict__ w, int k,
                                          int kmax, const T* __restrict__ x,
                                          long long ldx, long long n_x,
                                          const T* __restrict__ d, int lane,
                                          int col0, int sv, int* s_j,
                                          T* s_w, T* s_d) {
  // rows a lane requests before it adds the first (measured: 1 is best at
  // 259 float32 columns a row, 2 at 50)
  constexpr int kU = NV * V >= 8 ? 1 : 2;
  const int gbase = threadIdx.x - lane;  // the group's first thread
  const int shift = (threadIdx.x & 31) - lane;
  const unsigned group = L == 32 ? 0xffffffffu : ((1u << L) - 1u);
  for (int q0 = 0; q0 < kmax; q0 += L) {
    const int q = q0 + lane;
    bool live = false;
    int jl = 0;
    T wl = T(0);
    if (q < k) {
      wl = w[q];
      jl = idx[q];
      live = wl != T(0) && jl >= 0 && jl < n_x;
    }
    const unsigned mine =
        (__ballot_sync(0xffffffffu, live) >> shift) & group;
    if (live) {
      const int at = gbase + __popc(mine & ((1u << lane) - 1u));
      s_j[at] = jl;
      s_w[at] = wl;
      s_d[at] = d != nullptr ? d[jl] : T(1);
    }
    __syncwarp();
    const int cnt = __popc(mine);
    for (int u = 0; u < cnt; u += kU) {
      int jj[kU];
      T ww[kU], dd[kU];
#pragma unroll
      for (int v = 0; v < kU; ++v) {
        const int at = gbase + min(u + v, cnt - 1);
        jj[v] = s_j[at];
        ww[v] = s_w[at];
        dd[v] = s_d[at];
      }
      Pack<T, V> p[kU][NV];
#pragma unroll
      for (int v = 0; v < kU; ++v) {
        const T* xr = x + static_cast<long long>(jj[v]) * ldx;
#pragma unroll
        for (int m = 0; m < NV; ++m) {
          const int cv = col0 + m * L;
          if (cv < sv) {
            p[v][m] = *reinterpret_cast<const Pack<T, V>*>(
                xr + static_cast<long long>(cv) * V);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < kU; ++v) {
        if (u + v < cnt) {
          const bool exact_zero = zero_quotient_exact(dd[v]);
#pragma unroll
          for (int m = 0; m < NV; ++m) {
            if (col0 + m * L < sv) {
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const T a = p[v][m].v[e];
                if (a != T(0) || !exact_zero) {
                  acc[m][e] = fma_t(ww[v], a / dd[v], acc[m][e]);
                }
              }
            }
          }
        }
      }
    }
    __syncwarp();  // the shared slots are read before the next are written
  }
}

template <typename T, int V, int NV, int L>
__global__ void __launch_bounds__(kThreads)
gather_spmm_kernel(const T* __restrict__ x, long long ldx, long long n_x,
                   const T* __restrict__ d, const int* __restrict__ didx,
                   const T* __restrict__ dw, int kd, const Buckets<T> bk,
                   const long long* __restrict__ inv_pi, T* __restrict__ y,
                   long long n_rows, int s, T self_weight, int has_self) {
  __shared__ int s_j[kThreads];
  __shared__ T s_w[kThreads];
  __shared__ T s_d[kThreads];
  const long long g =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long i = g / L;
  const int lane = static_cast<int>(g % L);
  // every lane stays to the end: the ballots need the whole warp
  const bool live = i < n_rows;
  const int sv = s / V;

  const int k_direct = live ? kd : 0;
  const int* mi = nullptr;
  const T* mw = nullptr;
  int k_mirror = 0;
  if (live && bk.count > 0) {
    const long long p = inv_pi[i];
#pragma unroll
    for (int b = 0; b < kMaxBuckets; ++b) {
      if (b < bk.count) {
        const long long r = p - bk.start[b];
        if (r >= 0 && r < bk.rows[b]) {
          mi = bk.idx[b] + r * bk.width[b];
          mw = bk.w[b] + r * bk.width[b];
          k_mirror = bk.width[b];
        }
      }
    }
  }
  const int kmax_direct = static_cast<int>(
      __reduce_max_sync(0xffffffffu, static_cast<unsigned>(k_direct)));
  const int kmax_mirror = static_cast<int>(
      __reduce_max_sync(0xffffffffu, static_cast<unsigned>(k_mirror)));

  for (int base = 0; base < sv; base += L * NV) {
    const int col0 = base + lane;
    T acc[NV][V];
#pragma unroll
    for (int m = 0; m < NV; ++m) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[m][e] = T(0);
    }
    add_slots<T, V, NV, L>(acc, didx + (live ? i * kd : 0),
                           dw + (live ? i * kd : 0), k_direct, kmax_direct,
                           x, ldx, n_x, d, lane, col0, sv, s_j, s_w, s_d);
    add_slots<T, V, NV, L>(acc, mi, mw, k_mirror, kmax_mirror, x, ldx, n_x,
                           d, lane, col0, sv, s_j, s_w, s_d);
    if (!live) continue;
    const T di_self = (has_self && d != nullptr) ? d[i] : T(1);
    const bool self_zero_exact =
        zero_quotient_exact(di_self) && isfinite(self_weight);
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int cv = col0 + m * L;
      if (cv < sv) {
        Pack<T, V> out;
        if (has_self) {
          const Pack<T, V> xi = *reinterpret_cast<const Pack<T, V>*>(
              x + i * ldx + static_cast<long long>(cv) * V);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            out.v[e] = xi.v[e] == T(0) && self_zero_exact
                           ? acc[m][e]
                           : add_rn(acc[m][e], mul_rn(self_weight,
                                                      xi.v[e] / di_self));
          }
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) out.v[e] = acc[m][e];
        }
        *reinterpret_cast<Pack<T, V>*>(y + i * s +
                                       static_cast<long long>(cv) * V) = out;
      }
    }
  }
}

template <typename T, int V, int NV, int L>
cudaError_t launch(const void* x, long long ldx, long long n_x,
                   const void* d, const int* didx, const void* dw, int kd,
                   const Buckets<T>& bk, const long long* inv_pi, void* y,
                   long long n_rows, int s, double self_weight, int has_self,
                   cudaStream_t stream) {
  const long long threads = n_rows * L;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  gather_spmm_kernel<T, V, NV, L>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(x), ldx, n_x, static_cast<const T*>(d), didx,
          static_cast<const T*>(dw), kd, bk, inv_pi, static_cast<T*>(y),
          n_rows, s, static_cast<T>(self_weight), has_self);
  return cudaGetLastError();
}

// L lanes a row: 32, or, for a state narrower than 32 vectors (NV is then
// 1), the power of two at or above its vectors
template <typename T, int V, int NV>
cudaError_t by_lanes(int lanes, const void* x, long long ldx, long long n_x,
                     const void* d, const int* didx, const void* dw, int kd,
                     const Buckets<T>& bk, const long long* inv_pi, void* y,
                     long long n_rows, int s, double self_weight,
                     int has_self, cudaStream_t stream) {
#define GATHER_LANES(LL)                                                   \
  return launch<T, V, NV, LL>(x, ldx, n_x, d, didx, dw, kd, bk, inv_pi, y, \
                              n_rows, s, self_weight, has_self, stream)
  if (lanes == 32) GATHER_LANES(32);
  if constexpr (NV == 1) {
    if (lanes == 16) GATHER_LANES(16);
    if (lanes == 8) GATHER_LANES(8);
    if (lanes == 4) GATHER_LANES(4);
    if (lanes == 2) GATHER_LANES(2);
    if (lanes == 1) GATHER_LANES(1);
  }
#undef GATHER_LANES
  return cudaErrorInvalidValue;
}

template <typename T, int V>
cudaError_t by_nv(int nv, int lanes, const void* x, long long ldx,
                  long long n_x, const void* d, const int* didx,
                  const void* dw, int kd, const Buckets<T>& bk,
                  const long long* inv_pi, void* y, long long n_rows, int s,
                  double self_weight, int has_self, cudaStream_t stream) {
#define GATHER_NV(N)                                                     \
  case N:                                                                \
    return by_lanes<T, V, N>(lanes, x, ldx, n_x, d, didx, dw, kd, bk,     \
                             inv_pi, y, n_rows, s, self_weight, has_self, \
                             stream)
  if constexpr (V == 1) {
    switch (nv) {
      GATHER_NV(1); GATHER_NV(2); GATHER_NV(3); GATHER_NV(4);
      GATHER_NV(5); GATHER_NV(6); GATHER_NV(7); GATHER_NV(8);
      GATHER_NV(9); GATHER_NV(10); GATHER_NV(11); GATHER_NV(12);
      GATHER_NV(13); GATHER_NV(14); GATHER_NV(15); GATHER_NV(16);
      default: break;
    }
  } else {
    switch (nv) {
      GATHER_NV(1); GATHER_NV(2); GATHER_NV(4); GATHER_NV(8);
      GATHER_NV(16);
      default: break;
    }
  }
#undef GATHER_NV
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run(int vec, int nv, int lanes, int n_buckets,
                const long long* b_idx, const long long* b_w,
                const long long* b_start, const long long* b_rows,
                const int* b_width, const void* x, long long ldx,
                long long n_x, const void* d, const int* didx,
                const void* dw, int kd, const long long* inv_pi, void* y,
                long long n_rows, int s, double self_weight, int has_self,
                cudaStream_t stream) {
  Buckets<T> bk = {};
  bk.count = n_buckets;
  for (int b = 0; b < n_buckets; ++b) {
    bk.idx[b] = reinterpret_cast<const int*>(b_idx[b]);
    bk.w[b] = reinterpret_cast<const T*>(b_w[b]);
    bk.start[b] = b_start[b];
    bk.rows[b] = b_rows[b];
    bk.width[b] = b_width[b];
  }
#define GATHER_VEC(VV)                                                    \
  return by_nv<T, VV>(nv, lanes, x, ldx, n_x, d, didx, dw, kd, bk, inv_pi, \
                      y, n_rows, s, self_weight, has_self, stream)
  if (vec == 1) GATHER_VEC(1);
  if (vec == 2) GATHER_VEC(2);
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) GATHER_VEC(4);
  }
#undef GATHER_VEC
  return cudaErrorInvalidValue;
}

}  // namespace

// x (n_x, s) with row stride ldx elements, d (n_x,) or null, y (n_rows, s)
// row-major, didx / dw (n_rows, kd) row-major (kd may be 0), the buckets'
// ids and weights (b_rows[b], b_width[b]) row-major at the device addresses
// b_idx[b] / b_w[b] (host arrays of n_buckets <= 4 entries), b_start[b] the
// bucket's first position in the concatenation of the buckets' rows, and
// inv_pi (n_rows,) int64 a row's position there (null without buckets).
// Element type float32 (is_double == 0) or float64.  `vec` columns to a
// vector (4, 2 or 1; s, ldx and the addresses of x and y multiples of it),
// `nv` vectors a lane, `lanes` lanes a row (32, or a power of two below 32
// with nv == 1).  has_self adds self_weight * x[i] / d[i] last (d may then
// be null: division by 1).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int gather_spmm_launch(
    const void* x, long long ldx, long long n_x, const void* d,
    const int* didx, const void* dw, int kd, int n_buckets,
    const long long* b_idx, const long long* b_w, const long long* b_start,
    const long long* b_rows, const int* b_width, const long long* inv_pi,
    void* y, long long n_rows, int s, int vec, int nv, int lanes,
    double self_weight, int has_self, int is_double, void* stream) {
  if (n_rows < 1 || n_x < 1 || s < 1 || kd < 0 || n_buckets < 0 ||
      n_buckets > kMaxBuckets || (n_buckets > 0 && inv_pi == nullptr) ||
      (vec != 1 && vec != 2 && vec != 4) || s % vec != 0 ||
      ldx % vec != 0 || (is_double && vec == 4) || nv < 1 ||
      nv * lanes * vec < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return static_cast<int>(run<double>(
        vec, nv, lanes, n_buckets, b_idx, b_w, b_start, b_rows, b_width, x,
        ldx, n_x, d, didx, dw, kd, inv_pi, y, n_rows, s, self_weight,
        has_self, st));
  }
  return static_cast<int>(run<float>(
      vec, nv, lanes, n_buckets, b_idx, b_w, b_start, b_rows, b_width, x, ldx,
      n_x, d, didx, dw, kd, inv_pi, y, n_rows, s, self_weight, has_self, st));
}
