// Fused Euclidean-squared distance for Hopper (sm_90a):
//   D'[i, j] = ||mu_j||^2 - 2 * <x_i, mu_j>      (paper Eq. 3, F_ESD)
// x (n, d) f32, mu (k, d) f32, both row-major -> D' (n, k) f32.
//
// Replaces the Pallas TPU kernel repro/kernels/esd.py:esd. Its point is the
// fusion: ||mu_j||^2 is accumulated from the same staged mu chunks that feed
// the product, so there is no separate norm pass and no intermediate
// x @ mu^T buffer in device memory. The TPU version carries both sums in
// VMEM scratch across a sequential d grid axis; here a loop over d inside
// the block replaces that axis and the sums stay in registers. mu does not
// fit on chip at the widest shape of the kernel API (k = 128, d = 512 is
// 256 KB against 227 KB of shared memory a block), so the grid tiles the
// centroids over blockIdx.y and the loop stages d in chunks of kBD.
//
// Every product is an FP32 FMA on the CUDA cores, never TF32: the plain
// version it is held to is a full-FP32 matmul.
//
// What bounds it: at the fraud deployment's widths (d = 42, k = 5) each x
// word feeds 5 FMAs, far below the card's ~20 FP32 FLOPs per byte of HBM
// rate (67 TFLOP/s over 3.35 TB/s), so it is bound by reading x; at
// k = 128, d = 512 it does 2 * 128 FLOPs per x word and is bound by the
// FP32 FMAs. Two tiles answer the two cases:
//   * tile 0, 256 rows x 8 centroids (k <= 32): few centroids, so each
//     block streams a tall slab of x once and a thread keeps 4 x 2 sums;
//   * tile 1, 128 x 128 (wide k): the classic register-blocked SIMT GEMM
//     tile, 8 x 8 sums a thread, so each staged word feeds 8 FMAs.
// A thread's outputs are strided across the tile (row ty + r * BM/TM,
// column tx + c * BN/TN), so a warp's shared-memory reads fall on
// consecutive words. The first BN threads also accumulate ||mu_j||^2 of the
// block's centroids from each staged chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBD = 16;                  // d chunk staged in shared memory

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
esd_kernel(const float* __restrict__ x, const float* __restrict__ mu,
           float* __restrict__ out, long long n, int d, int k) {
  constexpr int NX = BN / TN;              // threads across the columns
  constexpr int NY = BM / TM;              // threads across the rows
  static_assert(NX * NY == kThreads, "tile must fill the block");
  static_assert(BN <= kThreads, "one thread per centroid norm");
  __shared__ float xs[kBD][BM + 1];        // x chunk, transposed; +1: banks
  __shared__ float ms[kBD][BN + 1];        // mu chunk, transposed
  __shared__ float us[BN];                 // ||mu_j||^2 of the block's tile

  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
  float u = 0.f;                           // thread tid < BN: centroid col0+tid

  for (int d0 = 0; d0 < d; d0 += kBD) {
    for (int i = tid; i < BM * kBD; i += kThreads) {
      const int r = i / kBD, dd = i % kBD;
      const long long gr = row0 + r;
      const int gd = d0 + dd;
      xs[dd][r] = (gr < n && gd < d) ? x[gr * d + gd] : 0.f;
    }
    for (int i = tid; i < BN * kBD; i += kThreads) {
      const int c = i / kBD, dd = i % kBD;
      const int gc = col0 + c, gd = d0 + dd;
      ms[dd][c] = (gc < k && gd < d) ? mu[(long long)gc * d + gd] : 0.f;
    }
    __syncthreads();
    if (tid < BN) {
#pragma unroll
      for (int dd = 0; dd < kBD; ++dd) u = fmaf(ms[dd][tid], ms[dd][tid], u);
    }
#pragma unroll
    for (int dd = 0; dd < kBD; ++dd) {
      float a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = xs[dd][ty + r * NY];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = ms[dd][tx + c * NX];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  if (tid < BN) us[tid] = u;
  __syncthreads();

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const long long gr = row0 + ty + r * NY;
    if (gr >= n) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int lc = tx + c * NX;
      const int gc = col0 + lc;
      if (gc < k) out[gr * k + gc] = us[lc] - 2.f * acc[r][c];
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(const float* x, const float* mu, float* out, long long n,
                   int d, int k, cudaStream_t stream) {
  dim3 grid((unsigned)((n + BM - 1) / BM), (unsigned)((k + BN - 1) / BN));
  esd_kernel<BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(x, mu, out, n,
                                                            d, k);
  return cudaGetLastError();
}

}  // namespace

// tile: 0 -> 256 rows x 8 centroids (few centroids), 1 -> 128 x 128.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int esd_launch(const void* x, const void* mu, void* out,
                          long long n, int d, int k, int tile, void* stream) {
  const float* px = static_cast<const float*>(x);
  const float* pm = static_cast<const float*>(mu);
  float* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 0) return (int)launch<256, 8, 4, 2>(px, pm, po, n, d, k, s);
  if (tile == 1) return (int)launch<128, 128, 8, 8>(px, pm, po, n, d, k, s);
  return (int)cudaErrorInvalidValue;
}
