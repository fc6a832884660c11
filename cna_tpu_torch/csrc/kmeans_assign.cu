// The k-means assignment on Hopper (sm_90a): the nearest of C centroids for
// every row, the tensor cores pick the candidates, float32 decides.
//
// Contract (ops/kmeans.py:kmeans_assign): for every row q of x (rows, d)
// float32, the int32 id of its nearest centroid among cent (C, d) float32
// and that squared distance, the direct float32 sum of (q - c)^2
// (dist_tile::exact_sq_dist, one fmaf chain in coordinate order); among
// equal distances the lowest centroid id.  No (rows, C) value is ever
// written to device memory, and the rows need no padding: the kernel masks
// the ragged edge itself.
//
// It replaces no Pallas kernel: the TPU package's k-means
// (cna_tpu/pp/ivf_fine.py:_kmeans_fit_matmul) is plain XLA, which the port
// first copied as plain PyTorch.  It was added because that step took 62% of
// the 1,000,000-cell graph build (PERF.md).
//
// What bounds it on this card: operations.  The work is rows * C * d
// products, 2 rows C d flop: 2.16e12 for one 1,000,000-cell IVF build
// (8 Lloyd iterations over 524,288 sampled rows and the assignment of all
// rows, C = 10,416, d = 20).  That is 4.4 ms at the dense TF32 rate of 495
// TFLOP/s, 32 ms at the float32 FMA rate, against about 42 MB (the sample)
// or 80 MB (every row) read once.  The plain PyTorch step it replaces
// wrote a (32,768 x C) float32 tile, rescaled it, took its argmin and built
// a one-hot of the same size for the update: about 14 GB of traffic a
// chunk, 2 TB a build.
//
// Design: knn_exact.cu's with k = 1 and the centroids as the key rows
// (dist_tile.cuh holds the tile product, the filter, the proof of its error
// bound and the exact distance):
//   * one centre c for the launch, the mean of the centroids, computed in a
//     fixed order by a pre-pass that also writes every centroid once as a
//     KEY row (centred, TF32, padded to dist_tile::key_stride, plus its
//     (1 - eps) |x'|^2) and as a raw row padded to DQ for the exact path:
//     about 1.9 MB at C = 10,416, d = 20, which stays in the 50 MB L2 for
//     the whole launch;
//   * a block owns 128 query rows, read straight from x into shared memory
//     (zeros beyond d and beyond the last row), four warps of 32 as two
//     16-row MMA tiles each, whose A operands stay in registers;
//   * a fifth warp streams tiles of 128 centroids through a ring of stages
//     with cp.async.bulk (full and empty mbarriers);
//   * every row starts from the exact distance to centroid 0, so its
//     threshold is finite from the first tile on; a centroid whose TF32 key
//     lies below the row's threshold sets its bit in the row's mask, and the
//     row's owner decides the masked centroids in id order with
//     exact_sq_dist, taking one only on a strict '<'.  Tiles come in
//     ascending id order, so the result is the first minimum of the
//     (distance, id) order: a centroid the filter drops has a distance at or
//     above the row's best, which a lower id already holds;
//   * 160 threads and three key stages of 12.8 KB at d <= 32, so that three
//     blocks share an SM; the Lloyd fit's 524,288 rows are 4,096 blocks.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's k-means phase on
// the 1M path's PCA scores): one assignment of 524,288 rows against 10,416
// centroids at d = 20 takes 2.31 ms, 9.6% of the 0.22 ms that its 2.2e11
// operations take at the dense bf16 peak (the benchmark's roofline) and
// 19% of the dense TF32 bound; 0.53% of the (row, centroid) pairs reach the
// exact path.  The plain version takes 53.6 ms, the step this replaced
// (tile, argmin, one-hot, oh.T @ x) 97.3 ms.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dist_tile.cuh"

namespace {

namespace dt = dist_tile;

constexpr int kMaxD = 128;
constexpr int kMT = 2;                       // 16-row query tiles to a warp
constexpr int kMmaWarps = 4;                 // warps of 32 query rows
constexpr int kRows = 32 * kMmaWarps;        // query rows to a block
constexpr int kThreads = kRows + 32;         // and the producer warp
constexpr int kTileKeys = 128;               // centroids to a stage (the
                                             // masks hold 128 a row)
constexpr int kBlocksPerSm = 3;              // aimed at for rows <= 32 floats
constexpr int kPartials = 128;               // centroid ranges of the centre
constexpr int kPrepThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kHeadBytes = 128;              // the stages' mbarriers

static_assert(kTileKeys % (8 * dt::kBatch) == 0, "tiles hold whole batches");

__host__ __device__ constexpr int key_width(int dq) {
  return dt::key_stride(8 * ((dq + 7) / 8));
}

__host__ __device__ constexpr long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

// The scratch buffer (floats): partial column sums [kPartials][DQ] | the
// centre [DQ] | raw centroids [c_pad][DQ] | key rows [c_pad][key_width] |
// the key rows' accumulator starts [c_pad].  Every part starts on 16 bytes.
struct Scratch {
  float* partial;
  float* cen;
  float* raw;
  float* keys;
  float* starts;
};

__host__ __device__ inline Scratch carve(float* base, int c, int dq) {
  const long long c_pad = round_up(c, kTileKeys);
  Scratch s;
  s.partial = base;
  s.cen = s.partial + static_cast<size_t>(kPartials) * dq;
  s.raw = s.cen + dq;
  s.keys = s.raw + static_cast<size_t>(c_pad) * dq;
  s.starts = s.keys + static_cast<size_t>(c_pad) * key_width(dq);
  return s;
}

__host__ __device__ inline size_t scratch_floats(int c, int dq) {
  const long long c_pad = round_up(c, kTileKeys);
  return static_cast<size_t>(kPartials) * dq + dq +
         static_cast<size_t>(c_pad) * (dq + key_width(dq) + 1);
}

// --- pre-pass 1: column sums of each of kPartials centroid ranges, in a
// fixed order (the centre is the same on every run) -------------------------
__global__ void __launch_bounds__(kPrepThreads)
centre_partials(const float* __restrict__ cent, int c, int d, int dq,
                float* __restrict__ partial) {
  __shared__ float part[kPrepThreads];
  const int b = blockIdx.x;
  const long long r0 = static_cast<long long>(c) * b / kPartials;
  const long long r1 = static_cast<long long>(c) * (b + 1) / kPartials;
  const int lanes = kPrepThreads / d;  // threads to a column (d <= 128)
  const int col = threadIdx.x % d;
  const int lr = threadIdx.x / d;
  float s = 0.f;
  if (lr < lanes) {
    for (long long r = r0 + lr; r < r1; r += lanes) {
      s += cent[r * d + col];
    }
  }
  part[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < dq) {
    float t = 0.f;
    if (threadIdx.x < d) {
      for (int l = 0; l < lanes; ++l) t += part[l * d + threadIdx.x];
    }
    partial[static_cast<size_t>(b) * dq + threadIdx.x] = t;
  }
}

// --- pre-pass 2: the centre, then one centroid to a thread: its raw copy
// padded to DQ, its key row and its accumulator start -----------------------
template <int DQ>
__global__ void __launch_bounds__(kPrepThreads)
key_rows(const float* __restrict__ cent, int c, int d, float eps, Scratch s) {
  constexpr int KW = key_width(DQ);
  __shared__ __align__(16) float cen[DQ];
  if (threadIdx.x < DQ) {
    float t = 0.f;
    for (int b = 0; b < kPartials; ++b) {
      t += s.partial[static_cast<size_t>(b) * DQ + threadIdx.x];
    }
    cen[threadIdx.x] = threadIdx.x < d ? t / static_cast<float>(c) : 0.f;
    if (blockIdx.x == 0) s.cen[threadIdx.x] = cen[threadIdx.x];
  }
  __syncthreads();
  const long long r = static_cast<long long>(blockIdx.x) * kPrepThreads +
                      threadIdx.x;
  const long long c_pad = round_up(c, kTileKeys);
  if (r >= c_pad) return;
  float4* raw = reinterpret_cast<float4*>(s.raw + r * DQ);
  float4* key = reinterpret_cast<float4*>(s.keys + r * KW);
  if (r >= c) {  // padding: a dead key row, never let through
#pragma unroll
    for (int c4 = 0; c4 < DQ / 4; ++c4) raw[c4] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c4 = 0; c4 < KW / 4; ++c4) key[c4] = make_float4(0.f, 0.f, 0.f, 0.f);
    s.starts[r] = __int_as_float(0x7f800000);
    return;
  }
  const float* src = cent + r * d;
  float nrm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c4 = 0; c4 < KW / 4; ++c4) {
    float v[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * c4 + j;
      if (col < DQ && col < d) {
        v[j] = src[col];
        e[j] = v[j] - cen[col];
      }
      nrm[j] = fmaf(e[j], e[j], nrm[j]);
    }
    if (4 * c4 < DQ) raw[c4] = make_float4(v[0], v[1], v[2], v[3]);
    key[c4] = make_float4(__uint_as_float(dt::tf32_rna(e[0])),
                          __uint_as_float(dt::tf32_rna(e[1])),
                          __uint_as_float(dt::tf32_rna(e[2])),
                          __uint_as_float(dt::tf32_rna(e[3])));
  }
  s.starts[r] = ((nrm[0] + nrm[1]) + (nrm[2] + nrm[3])) * (1.f - eps);
}

// Bytes of dynamic shared memory of the main kernel (mirrors its layout).
template <int DQ>
constexpr size_t main_smem_bytes(int n_stage) {
  return kHeadBytes + sizeof(float) * DQ + sizeof(uint32_t) * 4 * kRows +
         sizeof(float) * static_cast<size_t>(kRows) * DQ +
         static_cast<size_t>(n_stage) * sizeof(float) * kTileKeys *
             (key_width(DQ) + 1);
}

// --- the main kernel ---------------------------------------------------------
template <int DQ>
__global__ void __launch_bounds__(kThreads, DQ <= 32 ? kBlocksPerSm : 1)
assign_kernel(const float* __restrict__ x, long long n, int d, Scratch s,
              int c, int n_stage, float eps, float gam,
              int* __restrict__ out_id, float* __restrict__ out_dist,
              unsigned long long* __restrict__ stats) {
  constexpr int KS = (DQ + 7) / 8;
  constexpr int KW = key_width(DQ);
  constexpr uint32_t kTileBytes = sizeof(float) * kTileKeys * KW;
  constexpr uint32_t kStartBytes = sizeof(float) * kTileKeys;

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + n_stage;
  float* cen = reinterpret_cast<float*>(smem + kHeadBytes);
  uint32_t* masks = reinterpret_cast<uint32_t*>(cen + DQ);
  float* qraw = reinterpret_cast<float*>(masks + 4 * kRows);
  float* stage0 = qraw + kRows * DQ;
  auto stage_keys = [&](int st) {
    return stage0 + static_cast<size_t>(st) * kTileKeys * (KW + 1);
  };
  auto stage_starts = [&](int st) { return stage_keys(st) + kTileKeys * KW; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int q_live = static_cast<int>(min(static_cast<long long>(kRows),
                                          n - row0));
  const int live_warps = (q_live + 31) / 32;
  const int n_tiles = static_cast<int>(round_up(c, kTileKeys) / kTileKeys);

  if (tid == 0) {
    for (int st = 0; st < n_stage; ++st) {
      dt::mbar_init(&full[st], 1);
      dt::mbar_init(&empty[st], live_warps);
    }
    dt::mbar_init_fence();
  }
  if (tid < kRows) {
    reinterpret_cast<uint4*>(masks)[tid] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int e = tid; e < DQ; e += kThreads) cen[e] = s.cen[e];
  // the block's query rows, padded to DQ with zeros (the ragged edge and
  // the coordinates beyond d)
  for (int e = tid; e < q_live * DQ; e += kThreads) {
    const int r = e / DQ;
    const int col = e - r * DQ;
    qraw[e] = col < d ? x[(row0 + r) * d + col] : 0.f;
  }
  __syncthreads();

  if (warp == kMmaWarps) {  // the producer: the key stream into the ring
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % n_stage;
        const int use = t / n_stage;
        if (use > 0) dt::mbar_wait(&empty[st], (use - 1) & 1);
        dt::mbar_arrive_expect_tx(&full[st], kTileBytes + kStartBytes);
        dt::bulk_load(stage_keys(st),
                      s.keys + static_cast<size_t>(t) * kTileKeys * KW,
                      kTileBytes, &full[st]);
        dt::bulk_load(stage_starts(st),
                      s.starts + static_cast<size_t>(t) * kTileKeys,
                      kStartBytes, &full[st]);
      }
    }
    return;
  }
  if (warp >= live_warps) return;  // no live row: uniform for the warp

  const int gq = lane >> 2;  // MMA fragment row
  const int t4 = lane & 3;   // MMA fragment column pair
  const int r = 32 * warp + lane;  // the row this lane owns
  const bool live = r < q_live;
  const int m_live = min(kMT, (q_live - 32 * warp + 15) / 16);
  uint32_t afr[kMT][KS][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    dt::load_query_frags<DQ, KS>(qraw, cen, 32 * warp + 16 * m + gq, q_live,
                                 t4, afr[m]);
  }
  const float* qrow = qraw + static_cast<size_t>(live ? r : 0) * DQ;
  float nq = 0.f;
  if (live) {
#pragma unroll 4
    for (int col = 0; col < DQ; ++col) {
      const float e = qrow[col] - cen[col];
      nq = fmaf(e, e, nq);
    }
  }
  const float inf = __int_as_float(0x7f800000);
  // centroid 0 seeds the row's best, so its threshold is finite from the
  // first tile on (a later id enters only on a strict '<')
  float best_d = live ? dt::exact_sq_dist<DQ>(qrow, s.raw) : inf;
  int best_id = 0;
  unsigned n_exact = 0;
  uint32_t* warp_masks = masks + 4 * (32 * warp);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % n_stage;
    dt::mbar_wait(&full[st], (t / n_stage) & 1);
    const float thr_own =
        live ? dt::filter_threshold(best_d, nq, eps, gam) : -inf;
    float thr[kMT][2];
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        thr[m][h] = __shfl_sync(kFullWarp, thr_own, 16 * m + 8 * h + gq);
      }
    }
    constexpr int kBatches = kTileKeys / (8 * dt::kBatch);
    const bool any_pass =
        m_live == kMT
            ? dt::filter_tile<KS, kMT, kMT>(stage_keys(st), stage_starts(st),
                                            kBatches, afr, thr, warp_masks,
                                            gq, t4)
            : dt::filter_tile<KS, kMT, 1>(stage_keys(st), stage_starts(st),
                                          kBatches, afr, thr, warp_masks, gq,
                                          t4);
    __syncwarp();  // the stage is read; the masks are written
    if (lane == 0) dt::mbar_arrive(&empty[st]);
    if (any_pass) {
      uint4* mine = reinterpret_cast<uint4*>(masks) + r;
      const uint4 mk = *mine;
      if ((mk.x | mk.y | mk.z | mk.w) != 0u) {
        *mine = make_uint4(0u, 0u, 0u, 0u);
        const uint32_t words[4] = {mk.x, mk.y, mk.z, mk.w};
        const int base = t * kTileKeys;
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {
          uint32_t bits = words[wd];
          while (bits != 0u) {  // in centroid order
            const int cand = base + 32 * wd + __ffs(bits) - 1;
            bits &= bits - 1;
            ++n_exact;
            const float acc = dt::exact_sq_dist<DQ>(
                qrow, s.raw + static_cast<size_t>(cand) * DQ);
            if (acc < best_d) {
              best_d = acc;
              best_id = cand;
            }
          }
        }
      }
      __syncwarp();  // the masks are clear before the next tile sets bits
    }
  }

  if (live) {
    out_id[row0 + r] = best_id;
    out_dist[row0 + r] = best_d;
  }
  if (stats != nullptr) {
    // [0] centroids that reached the exact path (the seed excluded), [1]
    // (row, centroid) pairs of the launch
    const unsigned sum = __reduce_add_sync(kFullWarp, n_exact);
    if (lane == 0 && sum != 0u) {
      atomicAdd(&stats[0], static_cast<unsigned long long>(sum));
    }
    if (tid == 0) {
      atomicAdd(&stats[1], static_cast<unsigned long long>(q_live) *
                               static_cast<unsigned long long>(c));
    }
  }
}

template <int DQ>
cudaError_t launch(const float* x, long long n, int d, const float* cent,
                   int c, float eps, float gam, float* scratch, int* out_id,
                   float* out_dist, unsigned long long* stats,
                   cudaStream_t stream) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  // three key stages where they fit, else two
  int n_stage = 0;
  size_t smem = 0;
  for (int stages = 3; stages >= 2 && n_stage == 0; --stages) {
    smem = main_smem_bytes<DQ>(stages);
    if (smem <= static_cast<size_t>(limit)) n_stage = stages;
  }
  if (n_stage == 0) return cudaErrorInvalidValue;
  // the function's attributes are set once per instantiation and device
  static int attr_device = -1;
  if (device != attr_device) {
    err = cudaFuncSetAttribute(assign_kernel<DQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_device = device;
  }
  const Scratch s = carve(scratch, c, DQ);
  centre_partials<<<kPartials, kPrepThreads, 0, stream>>>(cent, c, d, DQ,
                                                          s.partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long c_pad = round_up(c, kTileKeys);
  key_rows<DQ><<<static_cast<unsigned>((c_pad + kPrepThreads - 1) /
                                       kPrepThreads),
                 kPrepThreads, 0, stream>>>(cent, c, d, eps, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  assign_kernel<DQ><<<blocks, kThreads, smem, stream>>>(
      x, n, d, s, c, n_stage, eps, gam, out_id, out_dist, stats);
  return cudaGetLastError();
}

int dq_of(int d) {
  if (d <= 32) return (d + 3) / 4 * 4;
  if (d <= 48) return 48;
  if (d <= 64) return 64;
  if (d <= 96) return 96;
  return 128;
}

}  // namespace

extern "C" int kmeans_assign_max_d() { return kMaxD; }

// Bytes of the scratch buffer that kmeans_assign_launch needs for C
// centroids of width d.
extern "C" long long kmeans_assign_scratch_bytes(int c, int d) {
  if (c < 1 || d < 1 || d > kMaxD) return -1;
  return static_cast<long long>(sizeof(float) * scratch_floats(c, dq_of(d)));
}

// x: (n, d) float32 row-major on the device; cent: (c, d) float32
// row-major; scratch: kmeans_assign_scratch_bytes(c, d) bytes on the device,
// 16-byte aligned; out_id (n,) int32 and out_dist (n,) float32, allocated
// by the caller.  eps and gam are the filter's error terms for the compiled
// width (ops/_dist_tile.py:filter_bound of kernel_d_pad(d); too small a
// value loses the nearest centroid, a larger one only costs time).  stats
// is null or two uint64 counters that the launch adds to: centroids that
// reached the exact path, (row, centroid) pairs.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int kmeans_assign_launch(const float* x, long long n, int d,
                                    const float* cent, int c, float eps,
                                    float gam, float* scratch, int* out_id,
                                    float* out_dist,
                                    unsigned long long* stats, void* stream) {
  if (n < 1 || (n + kRows - 1) / kRows > 0x7fffffffLL || d < 1 ||
      d > kMaxD || c < 1 || !(eps > 0.f) || !(eps < 0.5f) || !(gam > 0.f) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KMEANS_ASSIGN_CASE(W) \
  case W:                     \
    return static_cast<int>(launch<W>(x, n, d, cent, c, eps, gam, scratch, \
                                      out_id, out_dist, stats, s))
  switch (dq_of(d)) {
    KMEANS_ASSIGN_CASE(4);
    KMEANS_ASSIGN_CASE(8);
    KMEANS_ASSIGN_CASE(12);
    KMEANS_ASSIGN_CASE(16);
    KMEANS_ASSIGN_CASE(20);
    KMEANS_ASSIGN_CASE(24);
    KMEANS_ASSIGN_CASE(28);
    KMEANS_ASSIGN_CASE(32);
    KMEANS_ASSIGN_CASE(48);
    KMEANS_ASSIGN_CASE(64);
    KMEANS_ASSIGN_CASE(96);
    KMEANS_ASSIGN_CASE(128);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KMEANS_ASSIGN_CASE
}
