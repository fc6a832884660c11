// IVF fine-block scoring on Hopper (sm_90a): exact top-k of every query
// row over the live rows of its probed blocks, one thread per query row.
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
// probed set held fewer than k rows, are defined: -inf and id 0.
//
// What the TPU kernel needed and this one does not: ids packed into the
// low mantissa bits (distances here keep full float32), a candidate tile of
// at most 2048 columns, 16 candidate operands per grid step, outputs padded
// to 128 lanes, d_pad a multiple of 128.
//
// What bounds it on this card: operations.  Every live query row meets
// every live candidate row of its probe list: 2 * rows * candidates * d
// flop in float32, against one read of each probed block per query block
// (g * d_pad * 4 bytes for g * g * d multiply-adds: 2 g flop per byte).
//
// Design (first, simple version, after knn_exact.cu):
//   * one thread block per query block (grid = slots x q_blocks), g
//     threads, each keeping its query row in registers (DQ = d_pad floats,
//     a compile-time width);
//   * the block walks its probe list; a probed block's live rows are copied
//     into shared memory as float4 (rows are contiguous in the layout, so
//     the copy is coalesced); count-0 and out-of-range probes are skipped,
//     rows at or beyond counts[b] are never read;
//   * distances are sum((q - x)^2) computed directly, so a row's distance to
//     itself is an exact 0;
//   * each thread keeps a sorted top-k (k <= 128) in local memory and
//     touches it only when a distance beats its current k-th; among equal
//     distances the candidate met first stays ahead;
//   * offsets into the layout are 64-bit (F_pad * g * d_pad exceeds 2^31 at
//     a few million cells).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxK = 128;
constexpr int kMaxG = 128;
constexpr int kMaxD = 128;

template <int DQ>
__global__ void __launch_bounds__(kMaxG)
ivf_score_kernel(const float* __restrict__ x4, const int* __restrict__ sel,
                 const int* __restrict__ probes,
                 const int* __restrict__ counts,
                 const int* __restrict__ csum, int f_pad, int g, int q_blocks,
                 int n_probe, int k, float* __restrict__ out_negd,
                 int* __restrict__ out_idx) {
  extern __shared__ float4 smem4[];
  const float* tile = reinterpret_cast<const float*>(smem4);

  const int i = blockIdx.x;  // output slot row
  const int qb = blockIdx.y;  // query block within the slot
  const int r = threadIdx.x;  // query row within the block
  const int slot = sel[i];
  const long long qblock = static_cast<long long>(slot) * q_blocks + qb;
  const bool in_range = slot >= 0 && qblock < f_pad;
  const int q_live = in_range ? counts[qblock] : 0;
  const bool live = r < q_live;
  const size_t out0 =
      ((static_cast<size_t>(i) * q_blocks + qb) * g + r) * k;
  const float inf = __int_as_float(0x7f800000);

  if (q_live == 0) {  // a dummy query block: uniform for the thread block
    for (int s = 0; s < k; ++s) {
      out_negd[out0 + s] = -inf;
      out_idx[out0 + s] = 0;
    }
    return;
  }

  const size_t block_floats = static_cast<size_t>(g) * DQ;
  float qv[DQ];
  {
    const float4* qrow = reinterpret_cast<const float4*>(
        x4 + static_cast<size_t>(qblock) * block_floats +
        static_cast<size_t>(r) * DQ);
#pragma unroll
    for (int c4 = 0; c4 < DQ / 4; ++c4) {
      const float4 v = live ? qrow[c4] : make_float4(0.f, 0.f, 0.f, 0.f);
      qv[4 * c4 + 0] = v.x;
      qv[4 * c4 + 1] = v.y;
      qv[4 * c4 + 2] = v.z;
      qv[4 * c4 + 3] = v.w;
    }
  }

  float best_d[kMaxK];
  int best_i[kMaxK];
  for (int s = 0; s < k; ++s) {
    best_d[s] = inf;
    best_i[s] = 0;
  }
  float worst = inf;

  const int* my_probes = probes + static_cast<size_t>(i) * n_probe;
  for (int p = 0; p < n_probe; ++p) {
    const int b = my_probes[p];
    if (b < 0 || b >= f_pad) continue;  // uniform for the thread block
    const int cnt = counts[b];
    if (cnt <= 0) continue;  // a dummy block
    const int base_id = csum[b];

    __syncthreads();  // the previous block is no longer read
    {
      const float4* src = reinterpret_cast<const float4*>(
          x4 + static_cast<size_t>(b) * block_floats);
      const int n4 = cnt * (DQ / 4);
      for (int e = r; e < n4; e += g) smem4[e] = src[e];
    }
    __syncthreads();

    if (live) {
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
          // sorted insertion; the strict '>' keeps a candidate met earlier
          // ahead of a later one at equal distance
          int s = k - 1;
          while (s > 0 && best_d[s - 1] > acc) {
            best_d[s] = best_d[s - 1];
            best_i[s] = best_i[s - 1];
            --s;
          }
          best_d[s] = acc;
          best_i[s] = base_id + j;
          worst = best_d[k - 1];
        }
      }
    }
  }

  for (int s = 0; s < k; ++s) {
    const bool found = live && best_d[s] < inf;
    out_negd[out0 + s] = found ? -best_d[s] : -inf;
    out_idx[out0 + s] = found ? best_i[s] : 0;
  }
}

template <int DQ>
cudaError_t launch(const float* x4, const int* sel, const int* probes,
                   const int* counts, const int* csum, int ns, int f_pad,
                   int g, int q_blocks, int n_probe, int k, float* out_negd,
                   int* out_idx, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(g) * DQ * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ivf_score_kernel<DQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(ns, q_blocks);
  ivf_score_kernel<DQ><<<grid, g, smem, stream>>>(
      x4, sel, probes, counts, csum, f_pad, g, q_blocks, n_probe, k,
      out_negd, out_idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ivf_score_max_k() { return kMaxK; }
extern "C" int ivf_score_max_g() { return kMaxG; }
extern "C" int ivf_score_max_d() { return kMaxD; }

// x4: (f_pad, g, d_pad) float32 on the device, d_pad one of the compiled
// widths (4, 8, ..., 32, 48, 64, 96, 128); sel (ns,), probes (ns, n_probe),
// counts and csum (f_pad,) int32; out_negd and out_idx (ns, q_blocks * g,
// k), allocated by the caller.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int ivf_score_launch(const float* x4, const int* sel,
                                const int* probes, const int* counts,
                                const int* csum, int ns, int f_pad, int g,
                                int d_pad, int q_blocks, int n_probe, int k,
                                float* out_negd, int* out_idx,
                                void* stream) {
  if (ns < 1 || f_pad < 1 || g < 1 || g > kMaxG || (g & (g - 1)) != 0 ||
      q_blocks < 1 || q_blocks > 65535 || n_probe < 0 || k < 1 ||
      k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IVF_SCORE_CASE(W)                                                  \
  case W:                                                                  \
    return static_cast<int>(launch<W>(x4, sel, probes, counts, csum, ns,   \
                                      f_pad, g, q_blocks, n_probe, k,      \
                                      out_negd, out_idx, s))
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
