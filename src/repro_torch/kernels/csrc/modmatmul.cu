// Ring matmul C = A @ B mod 2^64 on 64-bit words, or mod 2^32 on 32-bit
// words, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/modmatmul.py:modmatmul, both
// its bodies: _kernel_u64 and _kernel_u32. The TPU version walks the K axis
// as a sequential grid dimension and carries the sum in a VMEM scratch
// tile; here a loop over K inside the block replaces that axis, and the sum
// stays in registers. The TPU's u32 body splits each word into 16-bit limbs
// because the MXU has no 32-bit integer product; on Hopper one 32-bit IMAD
// already wraps mod 2^32, so the same kernel is instantiated on uint32_t.
//
// Arithmetic is unsigned (unsigned long long / unsigned int), so wraparound
// is defined (signed overflow is undefined in C++). cuBLAS has no 64-bit
// integer GEMM, hence a hand kernel.
//
// What bounds it: on the main path the products are tall-skinny
// (n, d_a) @ (d_a, k) and long-K (k, n) @ (n, d_a) with k = 5 and
// d_a in {18, 24}; both move ~8 bytes per multiply-add and are bound by
// device-memory bytes, not by the 64-bit multiplies (each is 3 IMADs).
// The mod-2^32 ring has no caller on the fits (l = 64); through the kernel
// API its widest shape, (1024, 512) @ (512, 128), is bound by the 32-bit
// multiply-adds (one IMAD each), its tall-skinny ones by bytes.
// The design therefore aims at keeping all SMs busy on few output words:
//   * two tile shapes (BM x BN = 128 x 8 for tall outputs, 8 x 32 for wide
//     or short ones) so a k = 5 output column wastes at most 3 of 8 lanes;
//   * split-K over gridDim.z: the long-K product has 1 output tile, so the
//     wrapper splits K across hundreds of blocks and the partial sums meet
//     with atomicAdd on the unsigned word (64-bit, or the native 32-bit one).
//     Addition mod 2^l is exact and commutative, so the result is
//     bit-identical in any order. The wrapper zero-fills C before the
//     launch.
// A and B are staged K-chunk by K-chunk in shared memory. Operands must be
// contiguous row-major; the wrapper makes contiguous copies of transposed
// or sliced views.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kThreads = 256;
constexpr int kBK = 16;

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
ring_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ c, long long M, long long K, long long N,
                   long long k_per_split) {
  constexpr int TM = BM * BN / kThreads;  // output rows per thread
  static_assert(TM >= 1 && TM * kThreads == BM * BN, "tile must fill block");
  __shared__ T as[BM][kBK + 1];            // +1: stagger rows across banks
  __shared__ T bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % BN;                 // output column in the tile
  const int ty = tid / BN;                 // output row group in the tile
  const long long row0 = (long long)blockIdx.x * BM;
  const long long col0 = (long long)blockIdx.y * BN;
  const long long k_begin = (long long)blockIdx.z * k_per_split;
  long long k_end = k_begin + k_per_split;
  if (k_end > K) k_end = K;

  T acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0;

  for (long long k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const long long gr = row0 + r, gk = k0 + kk;
      as[r][kk] = (gr < M && gk < k_end) ? a[gr * K + gk] : T(0);
    }
    for (int i = tid; i < kBK * BN; i += kThreads) {
      const int kk = i / BN, cc = i % BN;
      const long long gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k_end && gc < N) ? b[gk * N + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const T bv = bs[kk][tx];
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

template <typename T, int BM, int BN>
cudaError_t launch(const void* a, const void* b, void* c, long long M,
                   long long K, long long N, long long k_per_split,
                   int splits, cudaStream_t stream) {
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
            (unsigned)splits);
  ring_matmul_kernel<T, BM, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, K, N, k_per_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(int tile, const void* a, const void* b, void* c,
                        long long M, long long K, long long N,
                        long long k_per_split, int splits, cudaStream_t s) {
  if (tile == 0) return launch<T, 128, 8>(a, b, c, M, K, N, k_per_split, splits, s);
  if (tile == 1) return launch<T, 8, 32>(a, b, c, M, K, N, k_per_split, splits, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// tile: 0 -> 128 x 8 (tall outputs), 1 -> 8 x 32 (wide or short outputs).
// splits blocks along K, each over k_per_split (a multiple of 16) words.
// word_bits: 64 -> mod 2^64 on 64-bit words, 32 -> mod 2^32 on 32-bit words.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int ring_matmul_launch(const void* a, const void* b, void* c,
                                  long long M, long long K, long long N,
                                  int tile, long long k_per_split, int splits,
                                  int word_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (word_bits == 64)
    return (int)launch_tile<u64>(tile, a, b, c, M, K, N, k_per_split, splits, s);
  if (word_bits == 32)
    return (int)launch_tile<u32>(tile, a, b, c, M, K, N, k_per_split, splits, s);
  return (int)cudaErrorInvalidValue;
}
