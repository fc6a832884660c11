// Exact self-kNN on Hopper (sm_90a): the tensor cores pick the candidates,
// float32 decides.
//
// Replaces the TPU package's Pallas kernel `_knn_kernel`
// (cna_tpu/ops/knn_pallas.py:44, launched by `_knn_call` at :88) and keeps
// its contract: for every row q of x (N, D) float32, the k rows nearest in
// Euclidean distance, as negated squared distances in descending order
// plus int32 ids; each distance is the direct float32 sum of (q - x)^2, so
// a point's distance to itself is an exact 0; among equal distances the
// lower id comes first.  The result is the first k of the (distance, id)
// order, the same bits as the package's first kernel (one thread per query,
// every distance on the CUDA cores), which this design replaced.
//
// What bounds it on this card: operations.  The work is N^2 * D products,
// 2 N^2 D flop (4.0e11 at N = 100,000, D = 20).  This kernel runs them as
// one TF32 matrix product on the tensor cores, so its bound is the card's
// dense TF32 peak: 0.81 ms at that shape (495 TFLOP/s), against 8 MB read and
// 12 MB written (a few microseconds at 3.35 TB/s).  On the CUDA cores the
// same operations are 5.97 ms at 67 TFLOP/s float32, and the direct
// difference spends an FSUB and an FFMA per coordinate, so a kernel there
// cannot go below about twice that (the first kernel took 30.7 ms); that
// figure is kept beside the bound as the earlier yardstick.
//
// Design (dist_tile.cuh holds the tile product, the filter and the proof of
// its error bound, the exact distance and the top-k):
//   * one centre c for the whole launch, the mean of x.  The proof holds for
//     any c that the query and the key rows share; the 100,000-cell path's
//     rows come in sample order, not in space, so the centroid of a block of
//     consecutive rows is close to the global mean and centring each block on
//     its own buys nothing;
//   * a pre-pass (two small kernels) computes c in a fixed order and writes
//     every row once as a KEY row: centred, rounded to TF32, padded to
//     dist_tile::key_stride, plus its (1 - eps) |x'|^2, and as an aligned raw
//     row padded to DQ for the exact path (about 18 MB at N = 100,000,
//     D = 20: the main kernel then reads it from the 50 MB L2);
//   * the main kernel: a block owns 128 query rows, four warps of 32 as two
//     16-row MMA tiles each, whose A operands (-2 (q - c), TF32) stay in
//     registers for the whole key stream; lane l owns row l of its warp for
//     the exact path; the block's raw query rows sit in shared memory;
//   * a fifth warp is the producer: one lane copies each tile of 128 key rows
//     and their starts with cp.async.bulk into a ring of stages (full and
//     empty mbarriers), so the four MMA warps never meet a __syncthreads and
//     do no work per key row;
//   * a warp multiplies its 32 rows with a tile's keys 16 at a time
//     (mma.sync.m16n8k8 TF32) and compares the least key of each row with the
//     row's threshold (dist_tile::filter_tile); a key below it sets the
//     candidate's bit in the row's 128-bit mask;
//   * the row's owner walks its mask in candidate order, recomputes
//     sum((q - x)^2) in float32 from the raw rows (dist_tile::exact_sq_dist:
//     the first kernel's fmaf chain in coordinate order) and inserts only on
//     a strict '<' against its current k-th.  Tiles come in ascending id
//     order, so the ids and distances are the first kernel's bit for bit: a
//     candidate the filter drops has a distance at or above the row's k-th at
//     that time, which k lower ids already hold (dist_tile.cuh's proof);
//   * while a row has seen fewer than k candidates its threshold is +inf, so
//     the whole first tile reaches the exact path; after it, about
//     k ln(N / k) candidates a row: 0.24% of the pairs at N = 100,000,
//     D = 20, k = 15 on the card, 1.25% at 20,000 bench cells in the CPU
//     emulation of this filter in tests/test_torch_knn.py (half of it the
//     first tile);
//   * a top-k of up to 16 lives in registers; a longer one is a max-heap on
//     (distance, id) in thread-local memory (dist_tile::TopKHeap): an
//     insertion touches log2 k entries whose upper levels stay in L1, where a
//     sorted insertion shifts the tail of a list that does not fit there (at
//     N = 100,000, D = 20, k = 64 the heap took 22.8 ms, the sorted list
//     126.0 ms, the first kernel 233.8 ms);
//   * 160 threads and three key stages of 12.5 KB at D <= 32, so that three
//     blocks share an SM and the 782 blocks of the 100,000-row case take two
//     waves on 132 SMs; the L1 / shared-memory split is CUDA's default
//     (asking for all of it as shared memory was 2 to 3% slower).
//
// What sets the pace now (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, whose
// main case reads the clock64 counters of the debug argument `stats` and a
// torch.profiler trace): 5.8 to 6.8 ms at N = 100,000, D = 20, k = 15, 12 to
// 14% of the TF32 bound; the pre-pass is under 1% of it.  Of the MMA warps'
// cycles the filter takes 55 to 59% (it runs at about a third of mma.sync's
// own rate: a tree of minima, a compare and a vote beside every 12 MMAs of
// 16 candidates), the exact path 33 to 37% (nearly every tile lets some row
// of a warp through, and its rows come from L2), waiting for key tiles 8%.
// Tried and slower (on
// the same card, variants not kept in the tree): deciding a tile's
// candidates one tile late behind an L1 prefetch (7.3 against 5.8 ms), four
// blocks to an SM (11.8 ms: spills), eight MMA warps to a block (8.0 to 9.7
// ms, though faster at k = 64), and the sorted top-k of thread-local memory
// for k > 16 (126 against 22.8 ms at k = 64).  PERF.md keeps the numbers.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dist_tile.cuh"

namespace {

namespace dt = dist_tile;

constexpr int kMaxK = dt::kMaxTopK;
constexpr int kMaxD = 128;
constexpr int kMT = 2;                       // 16-row query tiles to a warp
constexpr int kMmaWarps = 4;                 // warps of 32 query rows
constexpr int kRows = 32 * kMmaWarps;        // query rows to a block
constexpr int kThreads = kRows + 32;         // and the producer warp
constexpr int kTileKeys = 128;               // key rows to a stage (the masks
                                             // hold 128 candidates a row)
constexpr int kBlocksPerSm = 3;              // aimed at for rows <= 32 floats
constexpr int kPartials = 128;               // row ranges of the centre's sum
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
// centre [DQ] | raw rows [n_pad][DQ] | key rows [n_pad][key_width] | the
// key rows' accumulator starts [n_pad].  Every part starts on 16 bytes.
struct Scratch {
  float* partial;
  float* cen;
  float* raw;
  float* keys;
  float* starts;
};

__host__ __device__ inline Scratch carve(float* base, int n, int dq) {
  const long long n_pad = round_up(n, kTileKeys);
  Scratch s;
  s.partial = base;
  s.cen = s.partial + static_cast<size_t>(kPartials) * dq;
  s.raw = s.cen + dq;
  s.keys = s.raw + static_cast<size_t>(n_pad) * dq;
  s.starts = s.keys + static_cast<size_t>(n_pad) * key_width(dq);
  return s;
}

__host__ __device__ inline size_t scratch_floats(int n, int dq) {
  const long long n_pad = round_up(n, kTileKeys);
  return static_cast<size_t>(kPartials) * dq + dq +
         static_cast<size_t>(n_pad) * (dq + key_width(dq) + 1);
}

// --- pre-pass 1: column sums of each of kPartials row ranges, in a fixed
// order (the centre is the same on every run) -------------------------------
__global__ void __launch_bounds__(kPrepThreads)
centre_partials(const float* __restrict__ x, int n, int d, int dq,
                float* __restrict__ partial) {
  __shared__ float part[kPrepThreads];
  const int b = blockIdx.x;
  const long long r0 = static_cast<long long>(n) * b / kPartials;
  const long long r1 = static_cast<long long>(n) * (b + 1) / kPartials;
  const int lanes = kPrepThreads / d;  // threads to a column (d <= 128)
  const int c = threadIdx.x % d;
  const int lr = threadIdx.x / d;
  float s = 0.f;
  if (lr < lanes) {
    for (long long r = r0 + lr; r < r1; r += lanes) {
      s += x[r * d + c];
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

// --- pre-pass 2: the centre, then one row to a thread: its raw copy padded
// to DQ, its key row and its accumulator start ------------------------------
template <int DQ>
__global__ void __launch_bounds__(kPrepThreads)
key_rows(const float* __restrict__ x, int n, int d, float eps, Scratch s) {
  constexpr int KW = key_width(DQ);
  __shared__ __align__(16) float cen[DQ];
  if (threadIdx.x < DQ) {
    float t = 0.f;
    for (int b = 0; b < kPartials; ++b) {
      t += s.partial[static_cast<size_t>(b) * DQ + threadIdx.x];
    }
    cen[threadIdx.x] = threadIdx.x < d ? t / static_cast<float>(n) : 0.f;
    if (blockIdx.x == 0) s.cen[threadIdx.x] = cen[threadIdx.x];
  }
  __syncthreads();
  const long long r = static_cast<long long>(blockIdx.x) * kPrepThreads +
                      threadIdx.x;
  const long long n_pad = round_up(n, kTileKeys);
  if (r >= n_pad) return;
  float4* raw = reinterpret_cast<float4*>(s.raw + r * DQ);
  float4* key = reinterpret_cast<float4*>(s.keys + r * KW);
  if (r >= n) {  // padding: a dead key row, never let through
#pragma unroll
    for (int c4 = 0; c4 < DQ / 4; ++c4) raw[c4] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c4 = 0; c4 < KW / 4; ++c4) key[c4] = make_float4(0.f, 0.f, 0.f, 0.f);
    s.starts[r] = __int_as_float(0x7f800000);
    return;
  }
  const float* src = x + r * d;
  float nrm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c4 = 0; c4 < KW / 4; ++c4) {
    float v[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * c4 + j;
      if (c < DQ && c < d) {
        v[j] = src[c];
        e[j] = v[j] - cen[c];
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
template <int DQ, typename TopK>
__global__ void __launch_bounds__(kThreads, DQ <= 32 ? kBlocksPerSm : 1)
knn_tile_kernel(Scratch s, int n, int k, int n_stage, float eps, float gam,
                float* __restrict__ out_negd, int* __restrict__ out_idx,
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
  const int n_tiles = static_cast<int>(round_up(n, kTileKeys) / kTileKeys);

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
  for (int c = tid; c < DQ; c += kThreads) cen[c] = s.cen[c];
  {
    const float4* src = reinterpret_cast<const float4*>(s.raw + row0 * DQ);
    float4* dst = reinterpret_cast<float4*>(qraw);
    const int n4 = q_live * (DQ / 4);
    for (int e = tid; e < n4; e += kThreads) dst[e] = src[e];
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
    for (int c = 0; c < DQ; ++c) {
      const float e = qrow[c] - cen[c];
      nq = fmaf(e, e, nq);
    }
  }
  const float inf = __int_as_float(0x7f800000);
  TopK best;
  best.init(k, inf);
  unsigned n_exact = 0;
  uint32_t* warp_masks = masks + 4 * (32 * warp);
  // cycles of the warp waiting for key tiles, in the filter, on the exact
  // path: counted only for a caller that passes `stats`
  const bool timed = stats != nullptr;
  long long cyc[3] = {0, 0, 0};
  long long c0 = timed ? clock64() : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % n_stage;
    dt::mbar_wait(&full[st], (t / n_stage) & 1);
    if (timed) {
      const long long c1 = clock64();
      cyc[0] += c1 - c0;
      c0 = c1;
    }
    const float thr_own =
        live ? dt::filter_threshold(best.worst(), nq, eps, gam) : -inf;
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
    if (timed) {
      const long long c1 = clock64();
      cyc[1] += c1 - c0;
      c0 = c1;
    }
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
          while (bits != 0u) {  // in candidate order
            const int cand = base + 32 * wd + __ffs(bits) - 1;
            bits &= bits - 1;
            ++n_exact;
            const float acc = dt::exact_sq_dist<DQ>(
                qrow, s.raw + static_cast<size_t>(cand) * DQ);
            if (acc < best.worst()) best.insert(k, acc, cand);
          }
        }
      }
      __syncwarp();  // the masks are clear before the next tile sets bits
      if (timed) {
        const long long c1 = clock64();
        cyc[2] += c1 - c0;
        c0 = c1;
      }
    }
  }

  if (live) {
    const size_t o = static_cast<size_t>(row0 + r) * k;
    best.write(k, true, inf, out_negd + o, out_idx + o);
  }
  if (timed) {
    // [0] candidates that reached the exact path, [1] (row, candidate)
    // pairs of the launch, [2..4] the MMA warps' cycles waiting for key
    // tiles, in the filter and on the exact path
    const unsigned sum = __reduce_add_sync(kFullWarp, n_exact);
    if (lane == 0) {
      if (sum != 0u) {
        atomicAdd(&stats[0], static_cast<unsigned long long>(sum));
      }
      for (int i = 0; i < 3; ++i) {
        atomicAdd(&stats[2 + i], static_cast<unsigned long long>(cyc[i]));
      }
    }
    if (tid == 0) {
      atomicAdd(&stats[1], static_cast<unsigned long long>(q_live) *
                               static_cast<unsigned long long>(n));
    }
  }
}

template <int DQ, typename TopK>
cudaError_t launch(const float* x, int n, int d, int k, float eps, float gam,
                   float* scratch, float* out_negd, int* out_idx,
                   unsigned long long* stats, cudaStream_t stream) {
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
  // (the stages, and so the bytes, depend on the width and the device only)
  static int attr_device = -1;
  if (device != attr_device) {
    err = cudaFuncSetAttribute(knn_tile_kernel<DQ, TopK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_device = device;
  }
  const Scratch s = carve(scratch, n, DQ);
  centre_partials<<<kPartials, kPrepThreads, 0, stream>>>(x, n, d, DQ,
                                                          s.partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_pad = round_up(n, kTileKeys);
  key_rows<DQ><<<static_cast<unsigned>((n_pad + kPrepThreads - 1) /
                                       kPrepThreads),
                 kPrepThreads, 0, stream>>>(x, n, d, eps, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  knn_tile_kernel<DQ, TopK><<<blocks, kThreads, smem, stream>>>(
      s, n, k, n_stage, eps, gam, out_negd, out_idx, stats);
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

extern "C" int knn_exact_max_k() { return kMaxK; }
extern "C" int knn_exact_max_d() { return kMaxD; }

// Bytes of the scratch buffer that knn_exact_launch needs for (n, d).
extern "C" long long knn_exact_scratch_bytes(int n, int d) {
  if (n < 1 || d < 1 || d > kMaxD) return -1;
  return static_cast<long long>(sizeof(float) * scratch_floats(n, dq_of(d)));
}

// x: (n, d) float32 row-major on the device; scratch: knn_exact_scratch_bytes
// (n, d) bytes on the device, 16-byte aligned; out_negd (n, k) float32 and
// out_idx (n, k) int32, allocated by the caller.  eps and gam are the
// filter's error terms for the compiled width (ops/_dist_tile.py:
// filter_bound of kernel_d_pad(d); too small a value loses neighbours, a
// larger one only costs time).  stats is null or five uint64 counters that
// the launch adds to: candidates that reached the exact path, (row,
// candidate) pairs, and the MMA warps' cycles (clock64, summed over warps)
// waiting for key tiles, in the filter and on the exact path.  Launches on `stream` and returns cudaGetLastError() (0
// on success); does not synchronise.
extern "C" int knn_exact_launch(const float* x, int n, int d, int k,
                                float eps, float gam, float* scratch,
                                float* out_negd, int* out_idx,
                                unsigned long long* stats, void* stream) {
  if (n < 1 || d < 1 || d > kMaxD || k < 1 || k > kMaxK || k > n ||
      !(eps > 0.f) || !(eps < 0.5f) || !(gam > 0.f) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KNN_EXACT_CASE(W)                                            \
  case W:                                                            \
    return static_cast<int>(                                         \
        k <= dt::kRegK                                               \
            ? launch<W, dt::TopKRegs>(x, n, d, k, eps, gam, scratch, \
                                      out_negd, out_idx, stats, s)   \
            : launch<W, dt::TopKHeap>(x, n, d, k, eps, gam, scratch, \
                                      out_negd, out_idx, stats, s))
  switch (dq_of(d)) {
    KNN_EXACT_CASE(4);
    KNN_EXACT_CASE(8);
    KNN_EXACT_CASE(12);
    KNN_EXACT_CASE(16);
    KNN_EXACT_CASE(20);
    KNN_EXACT_CASE(24);
    KNN_EXACT_CASE(28);
    KNN_EXACT_CASE(32);
    KNN_EXACT_CASE(48);
    KNN_EXACT_CASE(64);
    KNN_EXACT_CASE(96);
    KNN_EXACT_CASE(128);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KNN_EXACT_CASE
}
