// Blocked-ELL sparse x dense for Hopper (sm_90a), in three word types:
// float32, 32-bit words mod 2^32 and 64-bit words mod 2^64:
// out[r*bm + i, :] = sum over slots j < counts[r] of
//                    blocks[r, j, i, :] @ Y[idx[r, j]*bk : (idx[r, j]+1)*bk, :]
//
// Replaces the Pallas TPU kernel repro/kernels/spmm.py:spmm_ell with all
// three tile products of its _tile_matmul: u64 (the step-2 product of
// Protocol 2), u32 and f32 (reached through the kernel API,
// repro/kernels/ops.py:spmm). The TPU version walks a row block's tile
// list in a fori_loop with all of Y resident in VMEM (up to 12 MB); an SM
// has ~228 KB of shared memory, so here Y is staged one bk x K tile at a
// time, the tile a slot points at. Padded slots (j >= counts[r]) are never
// read: the reference multiplies them by a zero mask, so the words agree.
// The TPU's u32 tiles split each word into 16-bit limbs because the MXU has
// no 32-bit integer product; here one 32-bit IMAD wraps mod 2^32.
//
// Integer arithmetic is unsigned, so wraparound is defined. The f32 sums
// are FP32 FMAs (never TF32).
//
// What bounds it: the tiles dominate the bytes and each tile word feeds K
// multiply-adds, about 0.375 64-bit MACs per byte at K = 3 (0.75 for 32-bit
// words). The card does ~1.7 64-bit MACs (~5 32-bit ones, ~10 FP32 FMAs) per
// byte of HBM rate, so every word type is bound by device-memory bytes. The
// design aims at streaming the tiles at full width on every SM:
//   * one warp per tile row: a warp reads 32 consecutive words per load,
//     and a lane keeps K running sums for its row; a tile's columns are
//     spread over the lanes, not its bm x K outputs (K is 1-8, which would
//     give 24 threads). A warp shuffle sums the lanes at the end.
//   * a lane issues the loads of its first 4 words of the slot's tile row
//     before the block stages the slot's Y tile, so both are in flight
//     together.
//   * the main path has two opposite shapes: X_A @ mu (nrb = 12,500 row
//     blocks of one tile each) and, through the transpose identity,
//     X_A^T @ C (nrb = 16 row blocks of 782 tiles). One block per row
//     block would run the second on 16 of 132 SMs, so the wrapper splits
//     the tile list over gridDim.y and the partial sums meet with
//     atomicAdd into a zero-filled output. For the ring words that is exact
//     and order-free mod 2^l; for f32 the order of the additions changes
//     from run to run, so f32 results agree to rounding, not bit for bit.
//     With one split the block stores its sums.
//   * Y wider than 8 columns runs as column groups of at most 8: the
//     wrapper copies each group's columns into a contiguous Y, launches
//     once per group and concatenates the outputs. Row strides passed to
//     the kernel would take the 64-bit instances from 64 to 80 registers,
//     one block fewer per SM (~10 % slower on an H100 at the fit's k = 3).
// Operands must be contiguous row-major; the wrapper makes contiguous
// copies of transposed Y views. The indices of used slots must
// point into Y (idx[r, j] < d_pad / bk for j < counts[r]), as the packers
// make them; they are not checked here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // tile rows in flight per block
constexpr int kPrefetch = 4;            // words per lane loaded ahead

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
spmm_ell_kernel(const T* __restrict__ blocks, const int* __restrict__ idx,
                const int* __restrict__ counts, const T* __restrict__ y,
                T* __restrict__ out, int maxb, int bm, int bk,
                int per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);     // one Y tile, laid out [K][bk]
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.y * per_split;
  const int j1 = min(j0 + per_split, min(counts[r], maxb));
  const bool split = gridDim.y > 1;
  if (split && j0 >= j1) return;          // nothing to add (uniform)
  const long long tile = (long long)bm * bk;
  const T* rb = blocks + (long long)r * maxb * tile;
  const int* ri = idx + (long long)r * maxb;

  for (int row0 = 0; row0 < bm; row0 += kWarps) {
    const int row = row0 + warp;
    const bool active = row < bm;
    T acc[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) acc[kk] = T(0);

    for (int j = j0; j < j1; ++j) {
      const T* xrow = rb + (long long)j * tile + (long long)row * bk;
      T xv[kPrefetch];
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) {
        const int c = lane + 32 * i;
        xv[i] = (active && c < bk) ? xrow[c] : T(0);
      }
      const T* ysrc = y + (long long)ri[j] * bk * K;
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
        const T x = xrow[c];
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
      T* o = out + ((long long)r * bm + row) * K;
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

struct Args {
  const void* blocks;
  const int* idx;
  const int* counts;
  const void* y;
  void* out;
  long long nrb, maxb;
  int bm, bk;
  long long per_split;
  int splits;
  cudaStream_t stream;
};

template <typename T, int K>
cudaError_t launch(const Args& a) {
  dim3 grid((unsigned)a.nrb, (unsigned)a.splits);
  const size_t smem = (size_t)a.bk * K * sizeof(T);
  spmm_ell_kernel<T, K><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.blocks), a.idx, a.counts,
      static_cast<const T*>(a.y), static_cast<T*>(a.out), (int)a.maxb, a.bm,
      a.bk, (int)a.per_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(int k, const Args& a) {
  switch (k) {
    case 1: return launch<T, 1>(a);
    case 2: return launch<T, 2>(a);
    case 3: return launch<T, 3>(a);
    case 4: return launch<T, 4>(a);
    case 5: return launch<T, 5>(a);
    case 6: return launch<T, 6>(a);
    case 7: return launch<T, 7>(a);
    case 8: return launch<T, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// k in 1..8 columns of Y (the wrapper cuts wider Y into column groups).
// splits blocks along each row block's tile list, each over per_split
// slots; with splits > 1 `out` must be zero-filled.
// word: 0 -> float32, 1 -> 32-bit words mod 2^32, 2 -> 64-bit words mod 2^64.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int spmm_ell_launch(const void* blocks, const void* idx,
                               const void* counts, const void* y, void* out,
                               long long nrb, long long maxb, int bm, int bk,
                               int k, long long per_split, int splits,
                               int word, void* stream) {
  const Args a{blocks, static_cast<const int*>(idx),
               static_cast<const int*>(counts), y, out, nrb, maxb, bm, bk,
               per_split, splits, static_cast<cudaStream_t>(stream)};
  switch (word) {
    case 0: return (int)launch_k<float>(k, a);
    case 1: return (int)launch_k<u32>(k, a);
    case 2: return (int)launch_k<u64>(k, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
