// Ring matmul C = A @ B mod 2^64 on 64-bit words, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/modmatmul.py:modmatmul
// (_kernel_u64). The TPU version walks the K axis as a sequential grid
// dimension and carries the sum in a VMEM scratch tile; here a loop over K
// inside the block replaces that axis, and the sum stays in registers.
//
// Arithmetic is unsigned long long, so wraparound is defined (signed
// overflow is undefined in C++). cuBLAS has no 64-bit integer GEMM, hence a
// hand kernel.
//
// What bounds it: on the main path the products are tall-skinny
// (n, d_a) @ (d_a, k) and long-K (k, n) @ (n, d_a) with k = 5 and
// d_a in {18, 24}; both move ~8 bytes per multiply-add and are bound by
// device-memory bytes, not by the 64-bit multiplies (each is 3 IMADs).
// The design therefore aims at keeping all SMs busy on few output words:
//   * two tile shapes (BM x BN = 128 x 8 for tall outputs, 8 x 32 for wide
//     or short ones) so a k = 5 output column wastes at most 3 of 8 lanes;
//   * split-K over gridDim.z: the long-K product has 1 output tile, so the
//     wrapper splits K across hundreds of blocks and the partial sums meet
//     with atomicAdd on unsigned long long. Addition mod 2^64 is exact and
//     commutative, so the result is bit-identical in any order. The wrapper
//     zero-fills C before the launch.
// A and B are staged K-chunk by K-chunk in shared memory. Operands must be
// contiguous row-major; the wrapper makes contiguous copies of transposed
// or sliced views.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kBK = 16;

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
ring_matmul_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                   u64* __restrict__ c, long long M, long long K, long long N,
                   long long k_per_split) {
  constexpr int TM = BM * BN / kThreads;  // output rows per thread
  static_assert(TM >= 1 && TM * kThreads == BM * BN, "tile must fill block");
  __shared__ u64 as[BM][kBK + 1];          // +1: stagger rows across banks
  __shared__ u64 bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % BN;                 // output column in the tile
  const int ty = tid / BN;                 // output row group in the tile
  const long long row0 = (long long)blockIdx.x * BM;
  const long long col0 = (long long)blockIdx.y * BN;
  const long long k_begin = (long long)blockIdx.z * k_per_split;
  long long k_end = k_begin + k_per_split;
  if (k_end > K) k_end = K;

  u64 acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0ULL;

  for (long long k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const long long gr = row0 + r, gk = k0 + kk;
      as[r][kk] = (gr < M && gk < k_end) ? a[gr * K + gk] : 0ULL;
    }
    for (int i = tid; i < kBK * BN; i += kThreads) {
      const int kk = i / BN, cc = i % BN;
      const long long gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k_end && gc < N) ? b[gk * N + gc] : 0ULL;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const u64 bv = bs[kk][tx];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] += as[ty * TM + r][kk] * bv;
    }
    __syncthreads();
  }

  const long long gc = col0 + tx;
  if (gc >= N) return;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const long long gr = row0 + ty * TM + r;
    if (gr >= M) break;
    if (gridDim.z == 1) {
      c[gr * N + gc] = acc[r];
    } else {
      atomicAdd(c + gr * N + gc, acc[r]);
    }
  }
}

template <int BM, int BN>
cudaError_t launch(const u64* a, const u64* b, u64* c, long long M,
                   long long K, long long N, long long k_per_split,
                   int splits, cudaStream_t stream) {
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
            (unsigned)splits);
  ring_matmul_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(
      a, b, c, M, K, N, k_per_split);
  return cudaGetLastError();
}

}  // namespace

// tile: 0 -> 128 x 8 (tall outputs), 1 -> 8 x 32 (wide or short outputs).
// splits blocks along K, each over k_per_split (a multiple of 16) words.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int ring_matmul_launch(const void* a, const void* b, void* c,
                                  long long M, long long K, long long N,
                                  int tile, long long k_per_split, int splits,
                                  void* stream) {
  const u64* pa = static_cast<const u64*>(a);
  const u64* pb = static_cast<const u64*>(b);
  u64* pc = static_cast<u64*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 0) return (int)launch<128, 8>(pa, pb, pc, M, K, N, k_per_split, splits, s);
  if (tile == 1) return (int)launch<8, 32>(pa, pb, pc, M, K, N, k_per_split, splits, s);
  return (int)cudaErrorInvalidValue;
}
