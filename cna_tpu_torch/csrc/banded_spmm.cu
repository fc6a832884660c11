// Banded SpMM on Hopper (sm_90a): the in-band part of y = A @ x for a
// locality-ordered graph, one pass over the in-band edges.
//
// Replaces the TPU package's Pallas kernel `_banded_kernel`
// (cna_tpu/ops/spmm_pallas.py:216, launched by `_banded_spmm_padded` at :242)
// and keeps its contract.  Rows come in tiles of R; tile t refers to the
// `slab` = R + 2W consecutive rows of x that start at starts[t].  For every
// padded row r of tile t and every column c
//
//     y[r, c] = sum_j w[r, j] * x[starts[t] + lidx[r, j], c]
//
// over the slots j of row r whose weight is not 0.  The packed (n_pad, K)
// arrays of the graph keep an in-band edge at its ELL position and zero the
// rest, so on a real graph most slots are empty (17% hold an edge on the
// 1,000,000-cell manifold graph).  The kernel reads a derived form built
// once per graph (ops/spmm_banded.py:compact_inband): the non-zero
// slots of each row moved together in their original order, each row's run
// padded with (index 0, weight 0) slots to a multiple of 4 so that it is read
// in 16-byte loads, and a row pointer row_ptr (n_pad + 1,) in slots.  A
// skipped slot contributed an exact 0, so the sum is the packed form's.
// Accumulation is in the state's own type at full precision (float32 by fmaf,
// float64 for a float64 state): no TF32, no bf16.  Slab rows at or beyond
// n_x read as zeros; x is never padded or copied.  Out-of-band edges (the
// spill ELL and the COO tail) are applied outside this kernel.
//
// What the TPU kernel needed and this one does not: K one-hot
// (R x slab) @ (slab x S) matrix products standing in for a gather, S padded
// to 128 lanes, x padded to max(n_pad, slab) rows.
//
// What bounds it on this card: bytes.  The least traffic is 8 bytes (12 in
// float64) per in-band edge, x read once and y written once: 476 MB on the
// 1,000,000-cell manifold graph at S = 50, 0.142 ms at 3.35 TB/s (the figure
// that counts every padded slot, 848 MB = 0.253 ms, is what the first kernel
// was held to).  2 flop per edge and column are far below the float32 rate.
//
// Design: a gather, no slab staged.  A thread owns one row and V consecutive
// columns (V = 4, 2 or 1 by the divisibility of S and the alignment of x),
// walks its row's run of slots once (16-byte loads, the same address across
// the threads of a row: a broadcast) and reads each neighbour's row of x
// straight from global memory; neighbouring threads read neighbouring
// columns, so a neighbour's S columns come as one or two coalesced requests.
// The band keeps a tile's working set (at most slab x S elements, 256 KB in
// float32 at S = 50) in the L1 and L2 caches: each row of x crosses the
// memory bus about once.  Every slot is read once, whatever S is: there are
// no column chunks, and no slab length is too long.
//
// What was measured beside it on the 1,000,000-cell manifold graph (S = 50,
// float32, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): this design 0.48 ms;
// the first kernel's design on the same compacted slots (a block stages
// slab x s_chunk elements of x in shared memory; 1,280 rows x 50 columns
// exceed the 232,448 bytes a block may use, so 3 column chunks, each reading
// the tile's slots again) 1.00 ms; the first kernel itself, every padded
// slot, 1.97 ms; torch.sparse.mm of the same edges 0.83 ms.  Staging only the
// slab rows a tile's edges really refer to, at full S, does not fit either:
// the tiles refer to 1,161 of their 1,280 slab rows on average.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kGatherThreads = 256;

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};
template <>
struct Vec4<double> {
  __device__ static void load(const double* p, double (&v)[4]) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
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

template <typename T, int V>
__global__ void __launch_bounds__(kGatherThreads)
banded_gather_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ cidx, const T* __restrict__ cw,
                     const int* __restrict__ starts, const T* __restrict__ x,
                     T* __restrict__ y, long long n_items, int row_tile,
                     int n_x_rows, int s, int sv) {
  const long long o =
      static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (o >= n_items) return;
  const int r = static_cast<int>(o / sv);
  const int c = (static_cast<int>(o - static_cast<long long>(r) * sv)) * V;
  const int start = starts[r / row_tile];
  const int p1 = row_ptr[r + 1];
  T acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = T(0);
  for (int p = row_ptr[r]; p < p1; p += 4) {
    const int4 l4 = *reinterpret_cast<const int4*>(cidx + p);
    T w4[4];
    Vec4<T>::load(cw + p, w4);
    const int src[4] = {start + l4.x, start + l4.y, start + l4.z,
                        start + l4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (src[u] < n_x_rows) {  // slab rows beyond x read as zeros
        const Pack<T, V> xv = *reinterpret_cast<const Pack<T, V>*>(
            x + static_cast<size_t>(src[u]) * s + c);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fma_t(w4[u], xv.v[v], acc[v]);
      }
    }
  }
  Pack<T, V> out;
#pragma unroll
  for (int v = 0; v < V; ++v) out.v[v] = acc[v];
  *reinterpret_cast<Pack<T, V>*>(y + static_cast<size_t>(r) * s + c) = out;
}

template <typename T, int V>
cudaError_t launch_gather(const int* row_ptr, const int* cidx, const void* cw,
                          const int* starts, const void* x, void* y,
                          long long n_pad, int row_tile, int n_x_rows, int s,
                          cudaStream_t stream) {
  const int sv = s / V;
  const long long n_items = n_pad * sv;
  const long long blocks = (n_items + kGatherThreads - 1) / kGatherThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  banded_gather_kernel<T, V>
      <<<static_cast<unsigned>(blocks), kGatherThreads, 0, stream>>>(
          row_ptr, cidx, static_cast<const T*>(cw), starts,
          static_cast<const T*>(x), static_cast<T*>(y), n_items, row_tile,
          n_x_rows, s, sv);
  return cudaGetLastError();
}

}  // namespace

// row_ptr (n_tiles * row_tile + 1,) int32 in slots, every entry a multiple
// of 4; cidx and cw (row_ptr[last],) the compacted
// slab-local indices and weights, on 16-byte boundaries; starts (n_tiles,)
// int32; x (n_x_rows, s) and y (n_tiles * row_tile, s) row-major on the
// device; cw, x and y float32 (is_double == 0) or float64.  `vec` columns to
// a thread (4, 2 or 1): s must be a multiple of it and x and y start on
// vec * sizeof(element) boundaries.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int banded_spmm_launch(const int* row_ptr, const int* cidx,
                                  const void* cw, const int* starts,
                                  const void* x, void* y, int n_tiles,
                                  int row_tile, int n_x_rows, int s, int vec,
                                  int is_double, void* stream) {
  if (n_tiles < 1 || row_tile < 1 || n_x_rows < 1 || s < 1 ||
      (vec != 1 && vec != 2 && vec != 4) || s % vec != 0 ||
      (is_double && vec == 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_pad = static_cast<long long>(n_tiles) * row_tile;
#define BANDED_GATHER(T, V)                                                 \
  return static_cast<int>(launch_gather<T, V>(row_ptr, cidx, cw, starts, x, \
                                              y, n_pad, row_tile, n_x_rows, \
                                              s, st))
  if (is_double) {
    if (vec == 2) BANDED_GATHER(double, 2);
    BANDED_GATHER(double, 1);
  }
  if (vec == 4) BANDED_GATHER(float, 4);
  if (vec == 2) BANDED_GATHER(float, 2);
  BANDED_GATHER(float, 1);
#undef BANDED_GATHER
}
