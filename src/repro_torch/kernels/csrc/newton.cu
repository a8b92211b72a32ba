// The Newton-Raphson loop of the secure reciprocal, both parties' shares,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the loop
// (repro/core/protocol.py:reciprocal) as 2 * iters Beaver products that XLA
// fuses under jit. The port ran them eagerly, each product some twenty
// elementwise launches on k words, so the host's enqueue of the loop, and
// not the card, paced S3's division tail. Per lane and iteration:
//   dx = smul(dp, x) >> f,   x = smul(x, 2 - dx) >> f,
// where smul(a, b) with the triple (u, v, z) opens e = (a0 - u0) + (a1 - u1)
// and g = (b0 - v0) + (b1 - v1) and recombines the FUSE_BEAVER way,
//   z0' = z0 + u0 g + e (v0 + g),   z1' = z1 + u1 g + e v1,
// and >> f is SecureML's local truncation: z0' >> f, -((-z1') >> f), on
// uint64 words with logical shifts. The exchanges of e and g are the
// protocol's (the caller logs their traffic); here both parties' halves
// are at hand, as in the plain version (kernels/newton.py).
//
// What bounds it: a dependent chain of 2 * iters products on k (5 or 16)
// lanes, so latency, not bytes or operations. Each thread owns one lane
// and carries both shares of x in registers through the whole loop; the
// next iteration's 12 triple words are loaded while the current one
// computes, so a device-memory round trip is paid about once an iteration.
// The triples stay where the dealer put them, separate tensors: their
// addresses reach the kernel by value in the parameter struct `Triples`,
// at most kMaxIters iterations a launch (3,840 of the 4 KB of parameters);
// a longer loop runs in chunks that carry x through `out`.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kWords = 6;            // u0, u1, v0, v1, z0, z1 of one triple
constexpr int kPerIter = 2 * kWords;  // two products an iteration
constexpr int kMaxIters = 40;

struct Triples {
  const u64* p[kMaxIters * kPerIter];
};

// One Beaver product of the shares (a0, a1) and (b0, b1) with triple words
// w, truncated by f: the result's shares in (r0, r1).
__device__ __forceinline__ void beaver(u64 a0, u64 a1, u64 b0, u64 b1,
                                       const u64* w, int f, u64& r0,
                                       u64& r1) {
  const u64 e = (a0 - w[0]) + (a1 - w[1]);
  const u64 g = (b0 - w[2]) + (b1 - w[3]);
  const u64 z0 = w[4] + w[0] * g + e * (w[2] + g);
  const u64 z1 = w[5] + w[1] * g + e * w[3];
  r0 = z0 >> f;
  r1 = 0ull - ((0ull - z1) >> f);
}

__device__ __forceinline__ void load(const Triples& t, int it, long long i,
                                     u64* w) {
#pragma unroll
  for (int j = 0; j < kPerIter; ++j) w[j] = t.p[it * kPerIter + j][i];
}

// `__grid_constant__`: the dynamic index into t.p reads the parameter in
// place, where a plain by-value struct would be copied to local memory.
__global__ void newton_recip_kernel(const __grid_constant__ Triples t,
                                    const u64* __restrict__ dp0,
                                    const u64* __restrict__ dp1,
                                    const u64* x0, const u64* x1, u64* out0,
                                    u64* out1, long long n, int iters, int f,
                                    u64 two) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 d0 = dp0[i], d1 = dp1[i];
  u64 a0 = x0[i], a1 = x1[i];
  u64 w[kPerIter], nw[kPerIter];
  if (iters > 0) load(t, 0, i, w);
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) load(t, it + 1, i, nw);
    u64 dx0, dx1;
    beaver(d0, d1, a0, a1, w, f, dx0, dx1);
    beaver(a0, a1, two - dx0, 0ull - dx1, w + kWords, f, a0, a1);
#pragma unroll
    for (int j = 0; j < kPerIter; ++j) w[j] = nw[j];
  }
  out0[i] = a0;
  out1[i] = a1;
}

}  // namespace

// `triples` is a host array of 12 * iters device addresses, iteration by
// iteration: the first product's u0, u1, v0, v1, z0, z1, then the second's;
// each points at n words. `out` holds 2 * n words, x's two shares. `chunk`
// (at most kMaxIters) iterations go to one launch; iters == 0 still
// launches once, to copy x0 into out. Returns cudaErrorInvalidValue for a
// chunk the parameter struct cannot hold, else the first refused launch's
// cudaError_t (0 = every chunk launched).
extern "C" int newton_recip_launch(const void* const* triples, int iters,
                                   int chunk, const void* dp0,
                                   const void* dp1, const void* x0,
                                   const void* x1, void* out, long long n,
                                   int f, long long two, int blocks,
                                   int threads, void* stream) {
  if (chunk < 1 || chunk > kMaxIters) return (int)cudaErrorInvalidValue;
  u64* out0 = static_cast<u64*>(out);
  u64* out1 = out0 + n;
  const u64* xa = static_cast<const u64*>(x0);
  const u64* xb = static_cast<const u64*>(x1);
  int lo = 0;
  do {
    const int count = iters - lo < chunk ? iters - lo : chunk;
    Triples t{};
    for (int j = 0; j < count * kPerIter; ++j)
      t.p[j] = static_cast<const u64*>(triples[lo * kPerIter + j]);
    newton_recip_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        t, static_cast<const u64*>(dp0), static_cast<const u64*>(dp1), xa, xb,
        out0, out1, n, count, f, static_cast<u64>(two));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    xa = out0;
    xb = out1;
    lo += count;
  } while (lo < iters);
  return 0;
}
