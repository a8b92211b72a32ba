// Blocked-ELL sparse x dense mod 2^64 on 64-bit words, for Hopper (sm_90a):
// out[r*bm + i, :] = sum over slots j < counts[r] of
//                    blocks[r, j, i, :] @ Y[idx[r, j]*bk : (idx[r, j]+1)*bk, :]
//
// Replaces the Pallas TPU kernel repro/kernels/spmm.py:spmm_ell (u64), the
// step-2 product of Protocol 2. The TPU version walks a row block's tile
// list in a fori_loop with all of Y resident in VMEM (up to 12 MB); an SM
// has ~228 KB of shared memory, so here Y is staged one bk x k tile at a
// time, the tile a slot points at. Padded slots (j >= counts[r]) are never
// read: the reference multiplies them by a zero mask, so the words agree.
//
// Arithmetic is unsigned long long, so wraparound is defined.
//
// What bounds it: the tiles dominate the bytes (8 bytes a word) and each
// word feeds k multiply-adds, about 0.375 64-bit MACs per byte at k = 3.
// The card does ~1.7 MACs per byte of HBM rate (5.58 T MAC/s over
// 3.35 TB/s), so the kernel is bound by device-memory bytes. The design
// aims at streaming the tiles at full width on every SM:
//   * one warp per tile row: a warp reads 32 consecutive words (256 bytes)
//     per load, and a lane keeps k running sums for its row; a tile's
//     columns are spread over the lanes, not its bm x k outputs (k is 1-8,
//     which would give 24 threads). A warp shuffle sums the lanes at the
//     end.
//   * a lane issues the loads of its first 4 words of the slot's tile row
//     before the block stages the slot's Y tile, so both are in flight
//     together.
//   * the main path has two opposite shapes: X_A @ mu (nrb = 12,500 row
//     blocks of one tile each) and, through the transpose identity,
//     X_A^T @ C (nrb = 16 row blocks of 782 tiles). One block per row
//     block would run the second on 16 of 132 SMs, so the wrapper splits
//     the tile list over gridDim.y and the partial sums meet with
//     atomicAdd on unsigned 64-bit words into a zero-filled output: exact
//     and order-free mod 2^64. With one split the block stores its sums.
// Operands must be contiguous row-major; the wrapper makes contiguous
// copies of transposed Y views. The indices of used slots must point into
// Y (idx[r, j] < d_pad / bk for j < counts[r]), as the packers make them;
// they are not checked here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // tile rows in flight per block
constexpr int kPrefetch = 4;            // words per lane loaded ahead

template <int K>
__global__ void __launch_bounds__(kThreads)
spmm_ell_kernel(const u64* __restrict__ blocks, const int* __restrict__ idx,
                const int* __restrict__ counts, const u64* __restrict__ y,
                u64* __restrict__ out, int maxb, int bm, int bk,
                int per_split) {
  extern __shared__ u64 ys[];             // one Y tile, laid out [K][bk]
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.y * per_split;
  const int j1 = min(j0 + per_split, min(counts[r], maxb));
  const bool split = gridDim.y > 1;
  if (split && j0 >= j1) return;          // nothing to add (uniform)
  const long long tile = (long long)bm * bk;
  const u64* rb = blocks + (long long)r * maxb * tile;
  const int* ri = idx + (long long)r * maxb;

  for (int row0 = 0; row0 < bm; row0 += kWarps) {
    const int row = row0 + warp;
    const bool active = row < bm;
    u64 acc[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) acc[kk] = 0ULL;

    for (int j = j0; j < j1; ++j) {
      const u64* xrow = rb + (long long)j * tile + (long long)row * bk;
      u64 xv[kPrefetch];
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) {
        const int c = lane + 32 * i;
        xv[i] = (active && c < bk) ? xrow[c] : 0ULL;
      }
      const u64* ysrc = y + (long long)ri[j] * bk * K;
      __syncthreads();                    // readers of the last tile done
      for (int e = tid; e < bk * K; e += kThreads)
        ys[(e % K) * bk + e / K] = ysrc[e];
      __syncthreads();
      if (!active) continue;
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) {
        const int c = lane + 32 * i;
        if (c < bk) {
#pragma unroll
          for (int kk = 0; kk < K; ++kk) acc[kk] += xv[i] * ys[kk * bk + c];
        }
      }
      for (int c = lane + 32 * kPrefetch; c < bk; c += 32) {
        const u64 x = xrow[c];
#pragma unroll
        for (int kk = 0; kk < K; ++kk) acc[kk] += x * ys[kk * bk + c];
      }
    }

    if (!active) continue;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[kk] += __shfl_down_sync(0xffffffffu, acc[kk], off);
    }
    if (lane == 0) {
      u64* o = out + ((long long)r * bm + row) * K;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        if (split) {
          atomicAdd(o + kk, acc[kk]);
        } else {
          o[kk] = acc[kk];
        }
      }
    }
  }
}

template <int K>
cudaError_t launch(const u64* blocks, const int* idx, const int* counts,
                   const u64* y, u64* out, long long nrb, long long maxb,
                   int bm, int bk, long long per_split, int splits,
                   cudaStream_t stream) {
  dim3 grid((unsigned)nrb, (unsigned)splits);
  const size_t smem = (size_t)bk * K * sizeof(u64);
  spmm_ell_kernel<K><<<grid, kThreads, smem, stream>>>(
      blocks, idx, counts, y, out, (int)maxb, bm, bk, (int)per_split);
  return cudaGetLastError();
}

}  // namespace

// k in 1..8 columns of Y. splits blocks along each row block's tile list,
// each over per_split slots; with splits > 1 `out` must be zero-filled.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int spmm_ell_launch(const void* blocks, const void* idx,
                               const void* counts, const void* y, void* out,
                               long long nrb, long long maxb, int bm, int bk,
                               int k, long long per_split, int splits,
                               void* stream) {
  const u64* b = static_cast<const u64*>(blocks);
  const int* ix = static_cast<const int*>(idx);
  const int* cn = static_cast<const int*>(counts);
  const u64* py = static_cast<const u64*>(y);
  u64* o = static_cast<u64*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)launch<1>(b, ix, cn, py, o, nrb, maxb, bm, bk, per_split, splits, s);
    case 2: return (int)launch<2>(b, ix, cn, py, o, nrb, maxb, bm, bk, per_split, splits, s);
    case 3: return (int)launch<3>(b, ix, cn, py, o, nrb, maxb, bm, bk, per_split, splits, s);
    case 4: return (int)launch<4>(b, ix, cn, py, o, nrb, maxb, bm, bk, per_split, splits, s);
    case 5: return (int)launch<5>(b, ix, cn, py, o, nrb, maxb, bm, bk, per_split, splits, s);
    case 6: return (int)launch<6>(b, ix, cn, py, o, nrb, maxb, bm, bk, per_split, splits, s);
    case 7: return (int)launch<7>(b, ix, cn, py, o, nrb, maxb, bm, bk, per_split, splits, s);
    case 8: return (int)launch<8>(b, ix, cn, py, o, nrb, maxb, bm, bk, per_split, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
