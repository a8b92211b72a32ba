// Fused row argmin -> one-hot for Hopper (sm_90a): (n, k) f32 distances ->
// (n, k) int32, one 1 per row at the first minimum (paper F^k_min, Fig. 1,
// on the plaintext path).
//
// Replaces the Pallas TPU kernel repro/kernels/argmin.py:argmin_onehot and
// keeps its exact semantics, which are those of min-reduce, compare and
// first-hit mask:
//   * the first column whose value == the row minimum wins, so ties go to
//     the lowest column and -0.0 ties +0.0;
//   * a row of +inf gives column 0;
//   * a row holding a NaN has a NaN minimum that equals nothing, so its
//     one-hot row is all zeros.
//
// What bounds it: it reads each distance once and writes one int32 for it,
// a compare per word, so it is bound by device-memory bytes. A group of G
// lanes (G = the power of two >= k, at most 32) takes one row: the lanes
// read consecutive words of the row, keep the first minimum of the columns
// they see, and a butterfly of warp shuffles within the group combines
// (value, column) pairs and a NaN flag. Then each lane writes its columns.
// Small k packs several rows into a warp, so a warp still reads and writes
// contiguous runs of words.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void __launch_bounds__(kThreads)
argmin_onehot_kernel(const float* __restrict__ d, int* __restrict__ out,
                     long long n, int k) {
  const int lane = threadIdx.x % G;
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  const bool active = row < n;
  float v = INFINITY;
  int first = k;                            // k: no column seen yet
  bool nan = false;
  if (active) {
    const float* dr = d + row * k;
    for (int c = lane; c < k; c += G) {
      const float x = dr[c];
      if (isnan(x)) {
        nan = true;
      } else if (x < v || (x == v && c < first)) {
        v = x;
        first = c;
      }
    }
  }
  // every lane of the warp reaches the shuffles (inactive rows too)
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off, G);
    const int f2 = __shfl_xor_sync(0xffffffffu, first, off, G);
    const int nan2 = __shfl_xor_sync(0xffffffffu, (int)nan, off, G);
    if (v2 < v || (v2 == v && f2 < first)) {
      v = v2;
      first = f2;
    }
    nan = nan || nan2;
  }
  if (!active) return;
  if (nan) first = k;
  int* orow = out + row * k;
  for (int c = lane; c < k; c += G) orow[c] = (c == first) ? 1 : 0;
}

template <int G>
cudaError_t launch(const float* d, int* out, long long n, int k,
                   cudaStream_t stream) {
  const long long threads = n * G;
  dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  argmin_onehot_kernel<G><<<grid, kThreads, 0, stream>>>(d, out, n, k);
  return cudaGetLastError();
}

}  // namespace

// group: lanes per row, a power of two in 1..32. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int argmin_onehot_launch(const void* d, void* out, long long n,
                                    int k, int group, void* stream) {
  const float* pd = static_cast<const float*>(d);
  int* po = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return (int)launch<1>(pd, po, n, k, s);
    case 2: return (int)launch<2>(pd, po, n, k, s);
    case 4: return (int)launch<4>(pd, po, n, k, s);
    case 8: return (int)launch<8>(pd, po, n, k, s);
    case 16: return (int)launch<16>(pd, po, n, k, s);
    case 32: return (int)launch<32>(pd, po, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
