// One party's share of the Kogge-Stone carry word, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ksadder.py:ks_carry_share.
// Per 64-bit word:
//   g  = and_share(e0, f0, u0, v0, z0)
//   g ^= and_share(el[l][0], fl[l][0], ul[l][0], vl[l][0], zl[l][0])
//        for each of the 6 levels l,
// where and_share(e, f, u, v, z) = z ^ (u & f) ^ (e & v) ^ [party0] (e & f).
// Only the g-chain is recombined (the p shares feed nothing locally), so the
// kernel never reads the party's input word x or slot 1 of any level.
//
// What bounds it: 35 words read and 1 written per element (288 bytes) for a
// handful of bitwise ops, so it is bound by device-memory bytes. The design
// is one elementwise grid-stride pass over the flattened comparison tensor:
// no padding to (rows, 128) as on the TPU, and the level stacks are read in
// place through their level stride (slot 0 of level l starts at l * stride),
// so slot 0 is never copied out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kLevels = 6;

__device__ __forceinline__ u64 and_share(u64 e, u64 f, u64 u, u64 v, u64 z,
                                         bool party0) {
  u64 out = z ^ (u & f) ^ (e & v);
  return party0 ? out ^ (e & f) : out;
}

__global__ void ks_carry_share_kernel(
    const u64* __restrict__ e0, const u64* __restrict__ f0,
    const u64* __restrict__ u0, const u64* __restrict__ v0,
    const u64* __restrict__ z0,
    const u64* __restrict__ el, long long sel,
    const u64* __restrict__ fl, long long sfl,
    const u64* __restrict__ ul, long long sul,
    const u64* __restrict__ vl, long long svl,
    const u64* __restrict__ zl, long long szl,
    u64* __restrict__ out, long long n, bool party0) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    u64 g = and_share(e0[i], f0[i], u0[i], v0[i], z0[i], party0);
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      g ^= and_share(el[l * sel + i], fl[l * sfl + i], ul[l * sul + i],
                     vl[l * svl + i], zl[l * szl + i], party0);
    }
    out[i] = g;
  }
}

}  // namespace

// Level stacks are (6, 2, *shape) with contiguous trailing dims; s* is each
// stack's stride (in words) between levels. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int ks_carry_share_launch(
    const void* e0, const void* f0, const void* u0, const void* v0,
    const void* z0, const void* el, long long sel, const void* fl,
    long long sfl, const void* ul, long long sul, const void* vl,
    long long svl, const void* zl, long long szl, void* out, long long n,
    int party0, int blocks, int threads, void* stream) {
  ks_carry_share_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(e0), static_cast<const u64*>(f0),
      static_cast<const u64*>(u0), static_cast<const u64*>(v0),
      static_cast<const u64*>(z0), static_cast<const u64*>(el), sel,
      static_cast<const u64*>(fl), sfl, static_cast<const u64*>(ul), sul,
      static_cast<const u64*>(vl), svl, static_cast<const u64*>(zl), szl,
      static_cast<u64*>(out), n, party0 != 0);
  return (int)cudaGetLastError();
}
