// Exact self-kNN on Hopper (sm_90a), one thread per query.
//
// Replaces the TPU package's Pallas kernel `_knn_kernel`
// (cna_tpu/ops/knn_pallas.py:44, launched by `_knn_call` at :88) and keeps
// its contract: for every row q of x (N, D) float32, the k rows nearest in
// Euclidean distance, as negated squared distances in descending order
// plus int32 ids; each point is its own first neighbour; among equal
// distances the lower id comes first.
//
// What bounds it on this card: operations.  The work is N^2 * D
// multiply-adds in float32 (2 N^2 D flop: 4.0e11 at N=100k, D=20, about
// 6 ms at the H100's 67 TFLOP/s float32 peak), against 8 MB read and
// 12 MB written (a few microseconds at 3.35 TB/s).
//
// Design (first, simple version; tensor cores come later):
//   * a block of 128 threads owns 128 queries; each thread keeps its query
//     in registers, zero-padded to DQ (a multiple of 4, chosen at compile
//     time as the smallest instantiation >= D);
//   * the block walks all keys in tiles staged through shared memory
//     (zero-padded to DQ columns, about 32 KB a tile); every thread reads
//     the same key, so each shared-memory load is a broadcast;
//   * distances are sum((q - x)^2) computed directly, not the TPU's
//     |q|^2 + |x|^2 - 2 q.x expansion: the self distance is an exact 0 and
//     no cancellation occurs;
//   * each thread keeps a sorted top-k (k <= 128) in local memory and only
//     touches it when a distance beats the current k-th, which after the
//     first tiles is rare (about k ln(N/k) insertions per query).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 128;
constexpr int kMaxD = 128;
constexpr int kTileFloats = 8192;  // 32 KB of shared memory per key tile

template <int DQ>
__global__ void __launch_bounds__(kThreads)
knn_exact_kernel(const float* __restrict__ x, int n, int d, int k,
                 int tile_keys, float* __restrict__ out_negd,
                 int* __restrict__ out_idx) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);

  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool live = q < n;

  float qv[DQ];
#pragma unroll
  for (int c = 0; c < DQ; ++c) {
    qv[c] = (live && c < d) ? x[static_cast<size_t>(q) * d + c] : 0.f;
  }

  float best_d[kMaxK];
  int best_i[kMaxK];
  const float inf = __int_as_float(0x7f800000);
  for (int s = 0; s < k; ++s) {
    best_d[s] = inf;
    best_i[s] = 0;
  }
  float worst = inf;

  for (int base = 0; base < n; base += tile_keys) {
    const int cnt = min(tile_keys, n - base);
    __syncthreads();  // the previous tile is no longer read
    const size_t row0 = static_cast<size_t>(base) * d;
    for (int e = threadIdx.x; e < cnt * DQ; e += kThreads) {
      const int j = e / DQ;
      const int c = e - j * DQ;
      tile[e] = (c < d) ? x[row0 + static_cast<size_t>(j) * d + c] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < cnt; ++j) {
      const float4* kv = reinterpret_cast<const float4*>(tile + j * DQ);
      float acc = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < DQ / 4; ++c4) {
        const float4 v = kv[c4];
        float t = qv[4 * c4 + 0] - v.x;
        acc = fmaf(t, t, acc);
        t = qv[4 * c4 + 1] - v.y;
        acc = fmaf(t, t, acc);
        t = qv[4 * c4 + 2] - v.z;
        acc = fmaf(t, t, acc);
        t = qv[4 * c4 + 3] - v.w;
        acc = fmaf(t, t, acc);
      }
      if (acc < worst) {
        // sorted insertion; a strict '>' keeps earlier (lower) ids ahead
        // of later ones at equal distance
        int s = k - 1;
        while (s > 0 && best_d[s - 1] > acc) {
          best_d[s] = best_d[s - 1];
          best_i[s] = best_i[s - 1];
          --s;
        }
        best_d[s] = acc;
        best_i[s] = base + j;
        worst = best_d[k - 1];
      }
    }
  }

  if (live) {
    const size_t o = static_cast<size_t>(q) * k;
    for (int s = 0; s < k; ++s) {
      out_negd[o + s] = -best_d[s];
      out_idx[o + s] = best_i[s];
    }
  }
}

template <int DQ>
cudaError_t launch(const float* x, int n, int d, int k, float* out_negd,
                   int* out_idx, cudaStream_t stream) {
  int tile_keys = kTileFloats / DQ;
  if (tile_keys > 256) tile_keys = 256;
  const size_t smem = static_cast<size_t>(tile_keys) * DQ * sizeof(float);
  const int blocks = (n + kThreads - 1) / kThreads;
  knn_exact_kernel<DQ><<<blocks, kThreads, smem, stream>>>(
      x, n, d, k, tile_keys, out_negd, out_idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_exact_max_k() { return kMaxK; }
extern "C" int knn_exact_max_d() { return kMaxD; }

// x: (n, d) float32 row-major on the device; out_negd (n, k) float32 and
// out_idx (n, k) int32, allocated by the caller.  Launches on `stream`
// and returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int knn_exact_launch(const float* x, int n, int d, int k,
                                float* out_negd, int* out_idx,
                                void* stream) {
  if (n < 1 || d < 1 || d > kMaxD || k < 1 || k > kMaxK || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int dq = (d + 3) / 4 * 4;
  if (dq <= 32) {
    switch (dq) {
      case 4: err = launch<4>(x, n, d, k, out_negd, out_idx, s); break;
      case 8: err = launch<8>(x, n, d, k, out_negd, out_idx, s); break;
      case 12: err = launch<12>(x, n, d, k, out_negd, out_idx, s); break;
      case 16: err = launch<16>(x, n, d, k, out_negd, out_idx, s); break;
      case 20: err = launch<20>(x, n, d, k, out_negd, out_idx, s); break;
      case 24: err = launch<24>(x, n, d, k, out_negd, out_idx, s); break;
      case 28: err = launch<28>(x, n, d, k, out_negd, out_idx, s); break;
      default: err = launch<32>(x, n, d, k, out_negd, out_idx, s); break;
    }
  } else if (dq <= 48) {
    err = launch<48>(x, n, d, k, out_negd, out_idx, s);
  } else if (dq <= 64) {
    err = launch<64>(x, n, d, k, out_negd, out_idx, s);
  } else if (dq <= 96) {
    err = launch<96>(x, n, d, k, out_negd, out_idx, s);
  } else {
    err = launch<128>(x, n, d, k, out_negd, out_idx, s);
  }
  return static_cast<int>(err);
}
