// Banded SpMM on Hopper (sm_90a): the in-band part of y = A @ x for a
// locality-ordered graph, gathered out of a slab of x staged in shared memory.
//
// Replaces the TPU package's Pallas kernel `_banded_kernel`
// (cna_tpu/ops/spmm_pallas.py:216, launched by `_banded_spmm_padded` at :242)
// and keeps its contract.  Rows come in tiles of R; tile t reads only the
// `slab` = R + 2W consecutive rows of x that start at starts[t].  For every
// padded row r of tile t and every column c
//
//     y[r, c] = sum_j w[r, j] * x[starts[t] + lidx[r, j], c]
//
// with lidx (n_pad, K) int32 local to the tile's slab and w (n_pad, K) zero
// on padding and out-of-band slots.  Accumulation is in the state's own type
// at full precision (float32 by fmaf, float64 for a float64 state): no TF32,
// no bf16.  Out-of-band edges (the spill ELL and the COO tail) are applied
// outside this kernel.
//
// What the TPU kernel needed and this one does not: K one-hot
// (R x slab) @ (slab x S) matrix products standing in for a gather, S padded
// to 128 lanes, x padded to max(n_pad, slab) rows (the slab copy is
// bounds-checked here instead: rows at or beyond n_x are staged as zeros).
//
// What bounds it on this card: bytes.  Each of lidx, w, x and y crosses the
// memory bus once (2 flop per 8-byte (lidx, w) slot and per gathered
// element).  A tile's slab is (R + 2W) / R times its own rows, so
// neighbouring tiles read the same rows of x again; those re-reads are
// served by the L2 cache when the tiles run at about the same time.
//
// Design (first, simple version):
//   * grid (tiles, column chunks): a block owns one row tile and s_chunk
//     consecutive columns; the wrapper picks s_chunk so that the
//     slab x s_chunk stage fits the shared memory a block may opt into (at
//     R = 256, W = 512 and float32 that is at most 45 columns), and where
//     it can, half of that, so that two blocks share an SM and one's slab
//     copy overlaps the other's gather; every chunk reads lidx and w again;
//   * the slab is copied row by row, neighbouring threads on neighbouring
//     columns of a row (coalesced within each row's chunk);
//   * outputs are dealt to threads column-fastest, so the threads of a warp
//     that share a row read one slab row at consecutive addresses (no bank
//     conflict), and lidx / w are read as broadcasts; a warp that spans
//     several rows (s_chunk < 32) can hit the same bank in different slab
//     rows;
//   * lidx and w are read four slots at a time (16-byte loads) when K is a
//     multiple of 4, which every graph packed by this package is.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreads = 1024;

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

__device__ inline float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ inline double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
banded_spmm_kernel(const int* __restrict__ lidx, const T* __restrict__ w,
                   const int* __restrict__ starts, const T* __restrict__ x,
                   T* __restrict__ y, int row_tile, int slab_rows, int k,
                   int n_x_rows, int s, int s_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);

  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * s_chunk;
  const int sc = min(s_chunk, s - c0);  // columns of this chunk
  const int start = starts[tile];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // stage x[start : start + slab_rows, c0 : c0 + sc]; rows beyond x are 0
  const int n_stage = slab_rows * sc;
  for (int e = tid; e < n_stage; e += nthreads) {
    const int row = e / sc;
    const int col = e - row * sc;
    const int src = start + row;
    slab[e] = src < n_x_rows
                  ? x[static_cast<size_t>(src) * s + c0 + col]
                  : T(0);
  }
  __syncthreads();

  const size_t row0 = static_cast<size_t>(tile) * row_tile;
  const int n_out = row_tile * sc;
  const bool vec = (k & 3) == 0;
  for (int o = tid; o < n_out; o += nthreads) {
    const int r = o / sc;
    const int c = o - r * sc;
    const int* li = lidx + (row0 + r) * static_cast<size_t>(k);
    const T* wr = w + (row0 + r) * static_cast<size_t>(k);
    const T* col = slab + c;
    T acc = T(0);
    if (vec) {
      for (int j = 0; j < k; j += 4) {
        const int4 l4 = *reinterpret_cast<const int4*>(li + j);
        T w4[4];
        Vec4<T>::load(wr + j, w4);
        acc = fma_t(w4[0], col[l4.x * sc], acc);
        acc = fma_t(w4[1], col[l4.y * sc], acc);
        acc = fma_t(w4[2], col[l4.z * sc], acc);
        acc = fma_t(w4[3], col[l4.w * sc], acc);
      }
    } else {
      for (int j = 0; j < k; ++j) {
        acc = fma_t(wr[j], col[li[j] * sc], acc);
      }
    }
    y[(row0 + r) * s + c0 + c] = acc;
  }
}

template <typename T>
cudaError_t launch(const int* lidx, const void* w, const int* starts,
                   const void* x, void* y, int n_tiles, int row_tile,
                   int slab_rows, int k, int n_x_rows, int s, int s_chunk,
                   int threads, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(slab_rows) * s_chunk * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_spmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_tiles, (s + s_chunk - 1) / s_chunk);
  banded_spmm_kernel<T><<<grid, threads, smem, stream>>>(
      lidx, static_cast<const T*>(w), starts, static_cast<const T*>(x),
      static_cast<T*>(y), row_tile, slab_rows, k, n_x_rows, s, s_chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int banded_spmm_max_threads() { return kMaxThreads; }

// The dynamic shared memory (bytes) a block may opt into on `device`, or a
// negative CUDA error code.
extern "C" int banded_spmm_max_smem(int device) {
  int bytes = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// lidx (n_tiles * row_tile, k) int32, w the same shape, starts (n_tiles,)
// int32, x (n_x_rows, s) and y (n_tiles * row_tile, s), all row-major on the
// device; w, x and y float32 (is_double == 0) or float64.  s_chunk columns
// to a block: slab_rows * s_chunk * sizeof(element) bytes of shared memory.
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise.
extern "C" int banded_spmm_launch(const int* lidx, const void* w,
                                  const int* starts, const void* x, void* y,
                                  int n_tiles, int row_tile, int slab_rows,
                                  int k, int n_x_rows, int s, int s_chunk,
                                  int is_double, int threads, void* stream) {
  if (n_tiles < 1 || row_tile < 1 || slab_rows < 1 || k < 0 ||
      n_x_rows < 1 || s < 1 || s_chunk < 1 || s_chunk > s || threads < 32 ||
      threads > kMaxThreads || (s + s_chunk - 1) / s_chunk > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return static_cast<int>(launch<double>(lidx, w, starts, x, y, n_tiles,
                                           row_tile, slab_rows, k, n_x_rows,
                                           s, s_chunk, threads, st));
  }
  return static_cast<int>(launch<float>(lidx, w, starts, x, y, n_tiles,
                                        row_tile, slab_rows, k, n_x_rows, s,
                                        s_chunk, threads, st));
}
