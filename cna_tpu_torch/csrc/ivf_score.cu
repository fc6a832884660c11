// IVF fine-block scoring on Hopper (sm_90a): exact top-k of every query
// row over the live rows of its probed blocks; the tensor cores pick the
// candidates, float32 decides.
//
// Replaces the TPU package's Pallas kernel `_score_kernel`
// (cna_tpu/ops/ivf_pallas.py:71, launched by `score_blocks_pallas` at :179)
// and keeps its contract.  The points live in a (F_pad, g, d_pad) block
// layout; block b owns counts[b] live rows (a count-0 block is a dummy).
// Slot s = sel[i] owns the q_blocks consecutive query blocks
// [s*q_blocks, (s+1)*q_blocks); output row i holds, for each of their
// q_blocks*g rows, the k nearest rows among the live rows of the P blocks
// named by probes[i, :], as negated squared distances in descending order
// and int32 ids in compact coordinates csum[b] + row-within-block.  Query
// rows at or beyond their block's live count, and entries for which the
// probed set held fewer than k rows, are defined: -inf and id 0.  A returned
// distance is the direct float32 sum of (q - x)^2 (a row's distance to itself
// an exact 0), the returned set is the exact float32 top-k, and among equal
// distances the candidate met first stays ahead.
//
// What the TPU kernel needed and this one does not: ids packed into the
// low mantissa bits (distances here keep full float32), a candidate tile of
// at most 2048 columns, 16 candidate operands per grid step, outputs padded
// to 128 lanes, d_pad a multiple of 128.
//
// What bounds it on this card: operations.  Every live query row meets
// every live candidate row of its probe list: 2 * rows * candidates * d
// flop, against one read of each probed block per query block.  This kernel
// runs them as a TF32 matrix product on the tensor cores, in one MMA pass,
// so its bound is the card's dense TF32 peak: 8.1 ms for the
// 1,000,000-cell search (4.0e12 flop at 495 TFLOP/s).  It takes 71 ms, 11%
// of that peak.  On the CUDA cores the same operations are 59.8 ms at 67
// TFLOP/s float32, and the direct-difference form spends an FSUB and an
// FFMA per coordinate, so it cannot go below twice that (the first kernel,
// which ran there, took 272 ms); that figure is kept beside the bound as
// the earlier yardstick and is no bound of this design.
//
// Design (dist_tile.cuh holds the tile product, the filter and its proof,
// the exact distance and the top-k):
//   * one thread block per query block (grid = slots x q_blocks), max(g, 32)
//     threads; a warp owns 32 query rows as two 16-row MMA tiles whose A
//     operands (-2 (q - c), TF32, c the query block's centroid) stay in
//     registers for the whole probe list, and lane l owns row l of them for
//     the exact path; which 32 rows a warp owns rotates with the block id,
//     so that the warp whose rows are dead is not the same scheduler's in
//     every block of an SM;
//   * warp 0 walks the probe list ahead of the block (32 probes fetched at
//     a time) and copies each live probed block (its live rows are one
//     contiguous run) with one cp.async.bulk into a ring of 2 raw stages,
//     completion on an mbarrier: the copy of probe p + 1 runs under the
//     product of probe p; count-0 and out-of-range probes are skipped,
//     offsets are 64-bit;
//   * every thread turns one staged candidate row into a key row: centred on
//     c, rounded to TF32, with its float32 norm (the accumulator's start);
//   * a warp multiplies its 32 rows with the candidates 16 at a time
//     (mma.sync.m16n8k8 TF32, the B operands one 8-byte load per k-step) and
//     compares the least key of each row with the row's threshold; a key
//     below it sets the candidate's bit in the row's 128-bit mask in shared
//     memory.  After the first few probed blocks almost no key passes
//     (0.14% of the pairs on the 1,000,000-cell index), and 16 candidates
//     cost 12 MMAs, 12 minima, 4 compares and one vote;
//   * the row's owner walks its mask in candidate order, recomputes
//     sum((q - x)^2) in float32 from the staged rows as they were given and
//     inserts into its sorted top-k only when the distance beats its
//     current k-th: the arithmetic, the order and the ties are the first
//     kernel's, so the results are the same bit for bit.  A top-k of up to
//     16 lives in registers (an insertion is 16 predicated moves, the same
//     for every lane); a longer one in thread-local memory;
//   * one key tile, two __syncthreads per probed block, and 46 KB of shared
//     memory at d_pad = 20: four blocks share an SM (71 ms for the
//     1,000,000-cell search; with two key tiles and one barrier three
//     blocks fit and the search took 84 ms).  Rows too wide for two raw
//     stages take one.
//
// What sets the pace now (cycle counters around the phases, warps' cycles
// summed over the 1,000,000-cell search at three blocks to an SM): the MMA
// and compare loop 38%, waiting at the barriers 30% (a fourth of it the
// warp whose 32 rows are dead: blocks hold 93 live rows on average), the
// key rows 14%, the exact path 11%, waiting for copies 7%.  The loop is
// within a factor of two of mma.sync's own rate.  See PERF.md for what was
// tried (wgmma, deeper batches) and what is next (key rows made by producer
// warps, so that the MMA warps never stop at a barrier).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dist_tile.cuh"

namespace {

namespace dt = dist_tile;

constexpr int kMaxK = dt::kMaxTopK;
constexpr int kMaxG = 128;
constexpr int kMaxD = 128;
constexpr int kBlocksPerSm = 4;  // aimed at for rows of up to 32 floats
constexpr int kMT = 2;  // 16-row query tiles to a warp
constexpr int kKeyPad = 8 * dt::kBatch;  // key tiles hold whole batches
constexpr unsigned kFullWarp = 0xffffffffu;

struct TileMeta {
  int cnt;      // live rows of the staged block; 0 ends the probe list
  int base_id;  // compact id of its first row
};

// Fixed part of the dynamic shared memory: barriers, tile descriptors and
// the producer's window of kAhead probes fetched ahead.
constexpr int kAhead = 32;
constexpr int kHeadBytes = 64 + 3 * kAhead * sizeof(int);

// rows of a key tile: the block's g rows, at least one whole batch
__host__ __device__ constexpr int key_rows(int g) {
  return g < kKeyPad ? kKeyPad : g;
}

// Bytes of dynamic shared memory of one block (mirrors the kernel's layout).
template <int DQ>
constexpr size_t smem_bytes(int g, int threads, int n_stage) {
  constexpr int BS = dt::key_stride(8 * ((DQ + 7) / 8));
  return kHeadBytes + sizeof(float) * DQ + 16 * static_cast<size_t>(threads) +
         sizeof(float) * static_cast<size_t>(g) * DQ * (1 + n_stage) +
         sizeof(float) * key_rows(g) * (BS + 1);
}

template <int DQ, typename TopK>
__global__ void __launch_bounds__(kMaxG, DQ <= 32 ? kBlocksPerSm : 1)
ivf_score_kernel(const float* __restrict__ x4, const int* __restrict__ sel,
                 const int* __restrict__ probes,
                 const int* __restrict__ counts,
                 const int* __restrict__ csum, int f_pad, int g, int q_blocks,
                 int n_probe, int k, int n_stage, float eps,
                 float gam, float* __restrict__ out_negd,
                 int* __restrict__ out_idx,
                 unsigned long long* __restrict__ stats) {
  constexpr int KS = (DQ + 7) / 8;
  constexpr int DK = 8 * KS;
  constexpr int BS = dt::key_stride(DK);

  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x;
  const int kr = key_rows(g);
  const size_t block_floats = static_cast<size_t>(g) * DQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  TileMeta* meta = reinterpret_cast<TileMeta*>(smem + 32);
  int* ahead_b = reinterpret_cast<int*>(smem + 64);
  int* ahead_cnt = ahead_b + kAhead;
  int* ahead_base = ahead_cnt + kAhead;
  float* cen = reinterpret_cast<float*>(smem + kHeadBytes);
  uint32_t* masks = reinterpret_cast<uint32_t*>(cen + DQ);
  float* qraw = reinterpret_cast<float*>(masks + 4 * threads);
  float* raw = qraw + block_floats;
  float* keys = raw + static_cast<size_t>(n_stage) * block_floats;
  float* starts = keys + static_cast<size_t>(kr) * BS;

  const int i = blockIdx.x;  // output slot row
  const int qb = blockIdx.y;  // query block within the slot
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = threads >> 5;
  const int gq = lane >> 2;  // MMA fragment row
  const int t4 = lane & 3;   // MMA fragment column pair
  const int slot = sel[i];
  const long long qblock = static_cast<long long>(slot) * q_blocks + qb;
  const bool in_range = slot >= 0 && qblock < f_pad;
  const int q_live = in_range ? min(counts[qblock], g) : 0;
  // the 32 query rows of this warp, and the one this lane owns
  const int role = (warp + i + qb) % n_warps;
  const int r = 32 * role + lane;
  const bool has_row = r < g;
  const bool live = r < q_live;
  const size_t out0 =
      ((static_cast<size_t>(i) * q_blocks + qb) * g + r) * k;
  const float inf = __int_as_float(0x7f800000);

  if (q_live == 0) {  // a dummy query block: uniform for the thread block
    if (has_row) {
      for (int s = 0; s < k; ++s) {
        out_negd[out0 + s] = -inf;
        out_idx[out0 + s] = 0;
      }
    }
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < n_stage; ++s) dt::mbar_init(&full[s], 1);
    dt::mbar_init_fence();
  }
  reinterpret_cast<uint4*>(masks)[tid] = make_uint4(0u, 0u, 0u, 0u);
  {
    const float4* src = reinterpret_cast<const float4*>(
        x4 + static_cast<size_t>(qblock) * block_floats);
    float4* dst = reinterpret_cast<float4*>(qraw);
    const int n4 = q_live * (DQ / 4);
    for (int e = tid; e < n4; e += threads) dst[e] = src[e];
  }
  __syncthreads();

  // --- the producer (warp 0): the next live probe into the next stage.
  // Its lanes fetch kAhead probes at a time (id, live count, first compact
  // id: three dependent loads, a lane each), so that walking the list costs
  // one round of memory latency per kAhead probed blocks; every lane keeps
  // the same cursor and lane 0 starts the copy.
  const int* my_probes = probes + static_cast<size_t>(i) * n_probe;
  int next_p = 0;
  int ahead_pos = kAhead, ahead_end = kAhead;
  int n_staged = 0;
  bool list_done = false;
  unsigned long long cand_rows = 0;
  auto stage_next = [&]() {
    if (list_done) return;
    int b = 0, cnt = 0, base = 0;
    for (;;) {
      if (ahead_pos == kAhead) {
        const int p = next_p + lane;
        int fb = -1, fc = 0, fs = 0;
        if (p < n_probe) {
          fb = my_probes[p];
          if (fb >= 0 && fb < f_pad) {
            fc = min(counts[fb], g);
            fs = csum[fb];
          }
        }
        __syncwarp();
        ahead_b[lane] = fb;
        ahead_cnt[lane] = fc;
        ahead_base[lane] = fs;
        __syncwarp();
        ahead_pos = 0;
        ahead_end = min(kAhead, n_probe - next_p);
        next_p += kAhead;
      }
      if (ahead_pos >= ahead_end) break;  // the list is exhausted
      cnt = ahead_cnt[ahead_pos];
      b = ahead_b[ahead_pos];
      base = ahead_base[ahead_pos];
      ++ahead_pos;
      if (cnt > 0) break;
    }
    const int stage = n_staged % n_stage;
    ++n_staged;
    list_done = cnt <= 0;
    cand_rows += list_done ? 0 : cnt;
    if (lane != 0) return;
    if (!list_done) {
      meta[stage].cnt = cnt;
      meta[stage].base_id = base;
      const uint32_t bytes = static_cast<uint32_t>(cnt) * DQ * sizeof(float);
      dt::mbar_arrive_expect_tx(&full[stage], bytes);
      dt::bulk_load(raw + static_cast<size_t>(stage) * block_floats,
                    x4 + static_cast<size_t>(b) * block_floats, bytes,
                    &full[stage]);
    } else {
      meta[stage].cnt = 0;
      meta[stage].base_id = 0;
      dt::mbar_arrive(&full[stage]);
    }
  };
  if (warp == 0) {
    const int ahead = n_stage > 1 ? n_stage - 1 : 1;
    for (int s = 0; s < ahead; ++s) stage_next();
  }

  // --- the query block: centroid, A operands, norms -----------------------
  for (int c = tid; c < DQ; c += threads) {
    float sum = 0.f;
    for (int row = 0; row < q_live; ++row) sum += qraw[row * DQ + c];
    cen[c] = sum / static_cast<float>(q_live);
  }
  __syncthreads();

  const int m_live = min(kMT, max(0, (q_live - 32 * role + 15) / 16));
  uint32_t afr[kMT][KS][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    dt::load_query_frags<DQ, KS>(qraw, cen, 32 * role + 16 * m + gq, q_live,
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

  TopK best;
  best.init(k, inf);
  unsigned n_exact = 0;
  uint32_t* warp_masks = masks + 4 * (tid - lane);

  for (int n = 0;; ++n) {
    const int stage = n % n_stage;
    dt::mbar_wait(&full[stage], (n / n_stage) & 1);
    const int cnt = meta[stage].cnt;
    if (cnt == 0) break;  // uniform for the thread block
    const int base_id = meta[stage].base_id;
    const float* tile = raw + static_cast<size_t>(stage) * block_floats;
    const int n_batches = (cnt + kKeyPad - 1) / kKeyPad;

    if (tid < kKeyPad * n_batches) {  // one candidate row to a thread
      if (tid < cnt) {
        const float nx = dt::stage_key_row<DQ, DK>(tile + tid * DQ, cen,
                                                   keys + tid * BS);
        starts[tid] = nx * (1.f - eps);
      } else {  // the dead rows that make the last batch whole
#pragma unroll
        for (int c4 = 0; c4 < DK / 4; ++c4) {
          reinterpret_cast<float4*>(keys + tid * BS)[c4] =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
        starts[tid] = inf;
      }
    }
    __syncthreads();  // keys ready; the previous raw stage is free
    if (warp == 0 && n_stage > 1) stage_next();

    if (m_live > 0) {
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
      const bool any_pass =
          m_live == kMT
              ? dt::filter_tile<KS, kMT, kMT>(keys, starts, n_batches, afr,
                                              thr,
                                              warp_masks, gq, t4)
              : dt::filter_tile<KS, kMT, 1>(keys, starts, n_batches, afr,
                                            thr, warp_masks, gq, t4);
      if (any_pass) {
        __syncwarp();
        uint4* mine = reinterpret_cast<uint4*>(masks) + tid;
        const uint4 mk = *mine;
        if ((mk.x | mk.y | mk.z | mk.w) != 0u) {
          *mine = make_uint4(0u, 0u, 0u, 0u);
          const uint32_t words[4] = {mk.x, mk.y, mk.z, mk.w};
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) {
            uint32_t bits = words[wd];
            while (bits != 0u) {  // in candidate order
              const int j = 32 * wd + __ffs(bits) - 1;
              bits &= bits - 1;
              ++n_exact;
              const float acc = dt::exact_sq_dist<DQ>(qrow, tile + j * DQ);
              if (acc < best.worst()) best.insert(k, acc, base_id + j);
            }
          }
        }
        __syncwarp();
      }
    }

    __syncthreads();  // before the key tile is rewritten
    if (warp == 0 && n_stage == 1) stage_next();
  }

  if (has_row) best.write(k, live, inf, out_negd + out0, out_idx + out0);
  if (stats != nullptr) {
    // [0] candidates that reached the exact path, [1] live row-candidate
    // pairs of the launch
    const unsigned sum = __reduce_add_sync(kFullWarp, n_exact);
    if (lane == 0 && sum != 0u) {
      atomicAdd(&stats[0], static_cast<unsigned long long>(sum));
    }
    if (tid == 0) {
      atomicAdd(&stats[1], cand_rows * static_cast<unsigned>(q_live));
    }
  }
}

template <int DQ, typename TopK>
cudaError_t launch(const float* x4, const int* sel, const int* probes,
                   const int* counts, const int* csum, int ns, int f_pad,
                   int g, int q_blocks, int n_probe, int k, float eps,
                   float gam, float* out_negd, int* out_idx,
                   unsigned long long* stats, cudaStream_t stream) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const int threads = g < 32 ? 32 : g;
  // two raw stages, so that the next block's copy runs under this one's
  // product; one where two do not fit
  int n_stage = 0;
  size_t smem = 0;
  for (int stages = 2; stages >= 1 && n_stage == 0; --stages) {
    smem = smem_bytes<DQ>(g, threads, stages);
    if (smem <= static_cast<size_t>(limit)) n_stage = stages;
  }
  if (n_stage == 0) return cudaErrorInvalidValue;
  // the function's attributes are set once per instantiation and device,
  // and again only where a launch needs more shared memory than any before
  static int attr_device = -1;
  static size_t attr_smem = 0;
  if (device != attr_device || smem > attr_smem) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(ivf_score_kernel<DQ, TopK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    // all of the SM's L1 / shared memory as shared memory, so that as many
    // blocks as fit by their size share an SM
    err = cudaFuncSetAttribute(ivf_score_kernel<DQ, TopK>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    attr_device = device;
    attr_smem = smem;
  }
  const dim3 grid(ns, q_blocks);
  ivf_score_kernel<DQ, TopK><<<grid, threads, smem, stream>>>(
      x4, sel, probes, counts, csum, f_pad, g, q_blocks, n_probe, k, n_stage,
      eps, gam, out_negd, out_idx, stats);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ivf_score_max_k() { return kMaxK; }
extern "C" int ivf_score_max_g() { return kMaxG; }
extern "C" int ivf_score_max_d() { return kMaxD; }

// x4: (f_pad, g, d_pad) float32 on the device, on a 16-byte boundary, d_pad
// one of the compiled widths (4, 8, ..., 32, 48, 64, 96, 128); sel (ns,),
// probes (ns, n_probe), counts and csum (f_pad,) int32; out_negd and out_idx
// (ns, q_blocks * g, k), allocated by the caller.  eps and gam are the
// filter's error terms for this width (ops/_dist_tile.py:filter_bound; too
// small a value loses neighbours, a larger one only costs time).  stats is null or
// two uint64 counters that the launch adds to: candidates that reached the
// exact path, live row-candidate pairs.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int ivf_score_launch(const float* x4, const int* sel,
                                const int* probes, const int* counts,
                                const int* csum, int ns, int f_pad, int g,
                                int d_pad, int q_blocks, int n_probe, int k,
                                float eps, float gam, float* out_negd,
                                int* out_idx, unsigned long long* stats,
                                void* stream) {
  if (ns < 1 || f_pad < 1 || g < 1 || g > kMaxG || (g & (g - 1)) != 0 ||
      q_blocks < 1 || q_blocks > 65535 || n_probe < 0 || k < 1 ||
      k > kMaxK || !(eps > 0.f) || !(eps < 0.5f) || !(gam > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IVF_SCORE_CASE(W)                                                  \
  case W:                                                                  \
    return static_cast<int>(                                               \
        k <= dt::kRegK                                                     \
            ? launch<W, dt::TopKRegs>(x4, sel, probes, counts, csum, ns,   \
                                      f_pad, g, q_blocks, n_probe, k, eps, \
                                      gam, out_negd, out_idx, stats, s)    \
            : launch<W, dt::TopKLocal>(x4, sel, probes, counts, csum, ns,  \
                                       f_pad, g, q_blocks, n_probe, k,     \
                                       eps, gam, out_negd, out_idx, stats, \
                                       s))
  switch (d_pad) {
    IVF_SCORE_CASE(4);
    IVF_SCORE_CASE(8);
    IVF_SCORE_CASE(12);
    IVF_SCORE_CASE(16);
    IVF_SCORE_CASE(20);
    IVF_SCORE_CASE(24);
    IVF_SCORE_CASE(28);
    IVF_SCORE_CASE(32);
    IVF_SCORE_CASE(48);
    IVF_SCORE_CASE(64);
    IVF_SCORE_CASE(96);
    IVF_SCORE_CASE(128);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IVF_SCORE_CASE
}
