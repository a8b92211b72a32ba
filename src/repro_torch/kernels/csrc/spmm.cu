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
// has ~228 KB of shared memory, so here the Y tile a slot points at is
// staged. Padded slots (j >= counts[r]) are never read: the
// reference multiplies them by a zero mask, so the words agree. The TPU's
// u32 tiles split each word into 16-bit limbs because the MXU has no
// 32-bit integer product; here one 32-bit IMAD wraps mod 2^32.
//
// Integer arithmetic is unsigned, so wraparound is defined. The f32 sums
// are FP32 FMAs (never TF32).
//
// What bounds it, on an H100 (3.35 TB/s; ~1.7 64-bit multiply-adds, ~5
// 32-bit ones and ~10 FP32 FMAs per byte of that rate):
//   * the fit's products (k = 3, 10) and the API's narrow ones read 8 x 128
//     tiles whose every word meets k columns: 0.4-1.25 multiply-adds a
//     byte, bound by device-memory bytes;
//   * the API's C^T x (Y = x, k = 42-512 columns, the tiles one-hot: ~8
//     non-zero words in 1024) is bound by the bytes of Y, and by the
//     multiply-adds only if the zero words of the tiles are multiplied too.
// The design: one launch per call for any width of Y, Y read in place
// (no copies), two kernels chosen inside that launch:
//   * narrow Y (k <= 16, the fit's k): a block takes a few row blocks (X_A
//     @ mu: 12,500 row blocks of one tile) or part of one row block's tile
//     list (X_A^T @ C: 16 row blocks of 782 tiles); a warp per tile row,
//     its lanes over the tile's columns, each lane keeping K running sums
//     (K a template, 3 to 16, the k columns a runtime count within it) that
//     a warp shuffle adds up when the row block ends. A slot's X words go
//     straight into registers, issued before the Y tile is awaited. The Y
//     tile a slot points at is staged by cp.async, in 16-byte pieces where
//     the addresses allow (one contiguous run when Y is contiguous and k
//     odd), and kept while the next slots point at it; row-major Y lands
//     at an odd row stride, so lanes reading consecutive rows hit distinct
//     banks, and a transposed Y (the fit's mu.s1.T) is read in place from
//     its row-major original as k rows of bk words. Few sums a lane (the
//     fit's k = 3) run 5 blocks an SM for more loads in flight;
//   * wide Y (k > 16): Y in column tiles of 32 V words (V a template, 1-8)
//     spread over the grid; a block takes up to 16 row blocks at once and
//     walks their slots slot by slot, so that row blocks whose slots point
//     at one Y tile (the one-hot C^T: all of them) share its staging. X
//     tiles stream through a 4-stage cp.async ring, one barrier a slot; Y
//     tiles through a 3-stage one, two tiles ahead of the one in use. A
//     warp takes a tile row, its lanes V columns each; a warp ballot over
//     32 words of the row skips the zero words of the sparse operand, a
//     warp-uniform test: ring words always (exact), f32 only over a staged
//     Y tile found finite while it was staged (0 * inf and 0 * NaN are NaN
//     in the plain version), the flag ORed by the tile's barrier
//     (__syncthreads_or);
//   * few row blocks: the tile lists are split over blocks, which meet by
//     atomicAdd into an output that a small kernel zeroes first; the
//     product is its programmatic dependent and waits for it only before
//     its first atomicAdd. For ring words that is exact and order-free mod
//     2^l; for f32 the order of the additions changes from run to run
//     (results agree to rounding).
// Operands: blocks, idx and counts contiguous; Y row-major with a leading
// dimension, or (narrow only) the transposed view of a row-major matrix;
// out (nrb*bm, k) contiguous. The wide kernel takes bm <= 8, bk <= 128.
// The indices of used slots must point into Y (idx[r, j] < d_pad / bk for
// j < counts[r]), as the packers make them; they are not checked here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// cp.async pieces of 4, 8 or 16 bytes, in flight until waited
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_piece(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(dst), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// `rows` rows of `bytes` bytes each, from src (row stride lds bytes) to dst
// (row stride ldd bytes), in pieces of g bytes, over the block's threads
__device__ __forceinline__ void copy_rows(unsigned char* dst, long long ldd,
                                          const unsigned char* src,
                                          long long lds, int rows, int bytes,
                                          int g) {
  const int per = bytes / g;
  const int total = rows * per;
  for (int f = threadIdx.x; f < total; f += kThreads) {
    const int row = f / per, p = f - row * per;
    cp_piece(dst + row * ldd + p * g, src + row * lds + p * g, g);
  }
}

// `bytes` contiguous bytes from src to dst, in pieces of g bytes, over the
// block's threads
__device__ __forceinline__ void copy_run(unsigned char* dst,
                                         const unsigned char* src, int bytes,
                                         int g) {
  for (int off = threadIdx.x * g; off < bytes; off += kThreads * g)
    cp_piece(dst + off, src + off, g);
}

// whether a float this thread copied with copy_rows(dst, ldd, src, lds,
// rows, bytes, g) is not finite; valid once its pieces have landed
// (cp.async.wait_group). Walks the same pieces without a division.
__device__ __forceinline__ bool copied_nonfinite(const float* dst, int ldd,
                                                 int rows, int bytes,
                                                 int g) {
  const int per = bytes / g, words = g / 4;
  const int drow = kThreads / per, dp = kThreads % per;
  int row = threadIdx.x / per, pc = threadIdx.x % per;
  bool bad = false;
  for (; row < rows; row += drow, pc += dp) {
    if (pc >= per) {
      pc -= per;
      if (++row >= rows) break;
    }
    const float* w = dst + row * ldd + pc * words;
    if (words == 4) {
      const float4 v = *reinterpret_cast<const float4*>(w);
      bad |= !(isfinite(v.x) && isfinite(v.y) && isfinite(v.z) &&
               isfinite(v.w));
    } else if (words == 2) {
      const float2 v = *reinterpret_cast<const float2*>(w);
      bad |= !(isfinite(v.x) && isfinite(v.y));
    } else {
      bad |= !isfinite(w[0]);
    }
  }
  return bad;
}

// ---------------------------------------------------------------------------
// 16-byte shared loads of consecutive words
// ---------------------------------------------------------------------------

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  typedef float4 type;
  static constexpr int n = 4;
  __device__ static void put(const float4& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec16<u32> {
  typedef uint4 type;
  static constexpr int n = 4;
  __device__ static void put(const uint4& v, u32* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec16<u64> {
  typedef ulonglong2 type;
  static constexpr int n = 2;
  __device__ static void put(const ulonglong2& v, u64* o) {
    o[0] = v.x; o[1] = v.y;
  }
};

// N consecutive words from a 16-byte aligned shared address, N a multiple
// of the words in 16 bytes
template <typename T, int N>
__device__ __forceinline__ void load_words(const T* s, T* o) {
  typedef Vec16<T> V;
  static_assert(N % V::n == 0, "whole 16-byte pieces");
  const typename V::type* p = reinterpret_cast<const typename V::type*>(s);
#pragma unroll
  for (int i = 0; i < N / V::n; ++i) V::put(p[i], o + i * V::n);
}

// ---------------------------------------------------------------------------
// the work of one block
// ---------------------------------------------------------------------------

struct Params {
  long long nrb, maxb;
  int bm, bk, k;
  long long ldy;        // Y's leading dimension (words)
  int col_tile;         // columns of Y a block covers
  int col_tiles;        // column tiles over the grid
  int rows_per_block;   // row blocks a block takes
  long long per_split;  // slots of a row block's list a block takes
  int splits;
  int x_words;          // words of a staged X tile (wide)
  int y_words;          // words of a staged Y tile
  int y_stride;         // words between staged Y rows (row-major Y)
  int yg;               // cp.async piece bytes for Y
  int xg;               // cp.async piece bytes for X (wide)
  int meta_off;         // byte offset of the block's counts (and, wide,
                        // idx) copy in shared memory
};

// The work of block b: row blocks [ra, ra + rows), of each the slots
// [j0, j0 + per) that are used, and the columns [col0, col0 + cols) of Y.
// Row blocks are innermost in the block index, then column tiles, then
// splits of the tile lists, so neighbouring blocks read the same Y tiles.
struct Work {
  long long ra, j0;
  int rows, per, col0, cols;
  __device__ __forceinline__ explicit Work(const Params& p) {
    const long long units = (p.nrb + p.rows_per_block - 1) / p.rows_per_block;
    const long long u = blockIdx.x;
    const long long ru = u % units, rest = u / units;
    const int ct = (int)(rest % p.col_tiles);
    const long long s = rest / p.col_tiles;
    ra = ru * p.rows_per_block;
    rows = (int)min((long long)p.rows_per_block, p.nrb - ra);
    j0 = s * p.per_split;
    per = (int)max(0LL, min(p.maxb, j0 + p.per_split) - j0);
    col0 = ct * p.col_tile;
    cols = min(p.col_tile, p.k - col0);
  }
};

template <typename T>
__device__ __forceinline__ void put(T* o, T v, bool split) {
  if (split) {
    atomicAdd(o, v);
  } else {
    *o = v;
  }
}

// ---------------------------------------------------------------------------
// narrow Y (k <= K <= 16): a block per few row blocks (or per part of one
// row block's tile list); a warp per tile row, its lanes over the tile's
// columns; the staged Y tile is kept while the slots point at it
// ---------------------------------------------------------------------------

constexpr int kPrefetch = 4;    // X words a lane loads ahead of the barrier

// Y row e, word c, of the staged tile: YT stages [k][bk] (rows of Y^T's
// original, copied contiguous), else [bk][y_stride]
template <typename T, bool YT>
__device__ __forceinline__ T y_at(const T* ys, int e, int c, int bk,
                                  int stride) {
  return YT ? ys[c * bk + e] : ys[e * stride + c];
}

// Few sums a lane (K words <= 32 bytes, the fit's k = 3): 5 blocks an SM,
// for more X loads in flight
template <typename T, int K, bool YT>
__global__ void __launch_bounds__(kThreads, K * sizeof(T) <= 32 ? 5 : 1)
narrow_kernel(const T* __restrict__ blocks, const int* __restrict__ idx,
              const int* __restrict__ counts, const T* __restrict__ y,
              T* __restrict__ out, const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);
  int* s_end = reinterpret_cast<int*>(smem + p.meta_off);   // [rows]
  // row blocks [ra, ra + rows); blockIdx.y: the split of their lists
  const long long ra = (long long)blockIdx.x * p.rows_per_block;
  const int rows = (int)min((long long)p.rows_per_block, p.nrb - ra);
  const long long j0 = (long long)blockIdx.y * p.per_split;
  const long long jcap = min(p.maxb, j0 + p.per_split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bk = p.bk, k = p.k, ys_stride = p.y_stride;
  const bool split = p.splits > 1;
  const long long tile = (long long)p.bm * bk;
  for (int i = threadIdx.x; i < rows; i += kThreads)
    s_end[i] = (int)min((long long)counts[ra + i], jcap);
  __syncthreads();
  int staged = -1;                          // the Y tile in ys (uniform)

  for (int i = 0; i < rows; ++i) {
    const long long r = ra + i, j1 = s_end[i];
    if (split && j0 >= j1) continue;        // nothing to add (uniform)
    const T* rb = blocks + r * p.maxb * tile;
    const int* ri = idx + r * p.maxb;
    for (int row0 = 0; row0 < p.bm; row0 += kWarps) {
      const int row = row0 + warp;
      const bool active = row < p.bm;
      T acc[K];
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] = T(0);

      for (long long j = j0; j < j1; ++j) {
        const T* xrow = rb + j * tile + (long long)row * bk;
        T xv[kPrefetch];
#pragma unroll
        for (int w = 0; w < kPrefetch; ++w) {
          const int e = lane + 32 * w;
          xv[w] = (active && e < bk) ? xrow[e] : T(0);
        }
        const int yi = ri[j];
        if (yi != staged) {                 // uniform: a new Y tile
          __syncthreads();                  // readers of the last tile done
          if (YT) {   // k rows of bk words of Y^T's original
            copy_rows(smem, (long long)bk * sizeof(T),
                      reinterpret_cast<const unsigned char*>(
                          y + (long long)yi * bk),
                      p.ldy * (long long)sizeof(T), k,
                      (int)(bk * sizeof(T)), p.yg);
          } else if (ys_stride == k && p.ldy == k) {
            // odd k, Y contiguous: the tile is one run of bk * k words
            copy_run(smem,
                     reinterpret_cast<const unsigned char*>(
                         y + (long long)yi * bk * k),
                     (int)(bk * k * sizeof(T)), p.yg);
          } else {    // bk rows of k words, at an odd stride
            copy_rows(smem, (long long)ys_stride * sizeof(T),
                      reinterpret_cast<const unsigned char*>(
                          y + (long long)yi * bk * p.ldy),
                      p.ldy * (long long)sizeof(T), bk,
                      (int)(k * sizeof(T)), p.yg);
          }
          cp_commit();
          cp_wait<0>();
          __syncthreads();
          staged = yi;
        }
        if (!active) continue;
#pragma unroll
        for (int w = 0; w < kPrefetch; ++w) {
          const int e = lane + 32 * w;
          if (e < bk) {
#pragma unroll
            for (int c = 0; c < K; ++c)
              acc[c] += xv[w] * y_at<T, YT>(ys, e, c, bk, ys_stride);
          }
        }
        for (int e = lane + 32 * kPrefetch; e < bk; e += 32) {
          const T x = xrow[e];
#pragma unroll
          for (int c = 0; c < K; ++c)
            acc[c] += x * y_at<T, YT>(ys, e, c, bk, ys_stride);
        }
      }

      if (!active) continue;
#pragma unroll
      for (int c = 0; c < K; ++c) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
      }
      if (lane == 0) {
        if (split) asm volatile("griddepcontrol.wait;\n" ::: "memory");
        T* o = out + (r * p.bm + row) * k;
#pragma unroll
        for (int c = 0; c < K; ++c)
          if (c < k) put(o + c, acc[c], split);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wide Y: a column tile of 32 V words, lanes over its columns; a block
// takes up to G row blocks at once, slot by slot, so that row blocks whose
// slots point at one Y tile share its staging
// ---------------------------------------------------------------------------

constexpr int kXStages = 4;     // X tiles in the ring: the pair's, 3 ahead
constexpr int kYStages = 3;     // Y tiles: the one in use and 2 ahead

// row blocks a wide block takes: its G x V sums stay within 64 registers
template <typename T, int V>
__host__ __device__ constexpr int wide_group() {
  return 256 / (V * (int)sizeof(T)) < 16 ? 256 / (V * (int)sizeof(T)) : 16;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const T* __restrict__ blocks, const int* __restrict__ idx,
            const int* __restrict__ counts, const T* __restrict__ y,
            T* __restrict__ out, const __grid_constant__ Params p) {
  constexpr int G = wide_group<T, V>();
  constexpr bool kF32 = sizeof(T) == 4 && T(0.5) != T(0);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ybuf = reinterpret_cast<T*>(smem);                  // [kYStages]
  T* xbuf = ybuf + kYStages * p.y_words;                 // [kXStages]
  int* s_n = reinterpret_cast<int*>(smem + p.meta_off);  // [G]
  int* s_idx = s_n + p.rows_per_block;                   // [rows][per]
  const Work w(p);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bk = p.bk, ys_stride = p.y_stride;
  const bool split = p.splits > 1;
  const bool active = warp < p.bm;
  const long long tile = (long long)p.bm * bk;

  for (int i = tid; i < w.rows; i += kThreads)
    s_n[i] = (int)max(0LL, min((long long)counts[w.ra + i], w.j0 + w.per) -
                                w.j0);
  for (int f = tid; f < w.rows * w.per; f += kThreads) {
    const int i = f / w.per, t = f - i * w.per;
    s_idx[i * w.per + t] = idx[(w.ra + i) * p.maxb + w.j0 + t];
  }
  __syncthreads();
  int tmax = 0;
  for (int i = 0; i < w.rows; ++i) tmax = max(tmax, s_n[i]);

  // the pairs, slot by slot over the group: (g, t) after (g0, t0)
  auto advance = [&](int& g, int& t) {
    ++g;
    while (t < tmax) {
      while (g < w.rows && t >= s_n[g]) ++g;
      if (g < w.rows) return true;
      g = 0;
      ++t;
    }
    return false;
  };

  // producer: the next pair whose X tile to stage, its Y tiles
  int xg_ = -1, xt = 0, x_slot = 0;
  bool x_ok = advance(xg_, xt);
  int yg_ = -1, yt = 0, y_last = -1, y_loads = 0;
  bool y_ok = advance(yg_, yt);
  int c_last = -1, c_load = -1;
  int commits = 0;              // cp.async groups committed so far
  int y_group[kYStages];        // the group each staged Y tile joined
  // stage Y tiles (one cp.async piece set each) up to kYStages - 1 ahead
  // of the consumer's; they join the current cp.async group
  auto stage_y = [&]() {
    while (y_ok) {
      const int yi = s_idx[yg_ * w.per + yt];
      if (yi != y_last) {
        if (y_loads >= c_load + kYStages) return;
        copy_rows(reinterpret_cast<unsigned char*>(
                      ybuf + (y_loads % kYStages) * p.y_words),
                  (long long)ys_stride * sizeof(T),
                  reinterpret_cast<const unsigned char*>(
                      y + (long long)yi * bk * p.ldy + w.col0),
                  p.ldy * (long long)sizeof(T), bk,
                  (int)(w.cols * sizeof(T)), p.yg);
        y_group[y_loads % kYStages] = commits;
        y_last = yi;
        ++y_loads;
      }
      y_ok = advance(yg_, yt);
    }
  };
  auto stage_x = [&]() {
    if (!x_ok) return;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        blocks + ((w.ra + xg_) * p.maxb + w.j0 + xt) * tile);
    copy_run(reinterpret_cast<unsigned char*>(xbuf + x_slot * p.x_words),
             src, (int)(tile * sizeof(T)), p.xg);
    x_slot = x_slot + 1 == kXStages ? 0 : x_slot + 1;
    x_ok = advance(xg_, xt);
  };
  stage_y();
#pragma unroll
  for (int s = 0; s < kXStages - 1; ++s) {
    stage_x();
    cp_commit();
    ++commits;
  }

  T acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[g][v] = T(0);
  }
  bool finite = true;
  int c_slot = 0;
  // the product of pair (g, t) into acc[g]: a warp ballot over each 32
  // words of its tile row finds the words to multiply
  auto pair = [&](T (&a)[V], int g, int t) {
    const int yi = s_idx[g * w.per + t];
    const bool fresh = yi != c_last;           // uniform
    // wait for the pair's X tile (kXStages - 2 groups may stay pending)
    // and, for a fresh tile, for the group its Y tile joined
    int pending = kXStages - 2;
    if (fresh) {
      c_last = yi;
      ++c_load;
      pending = min(pending, commits - y_group[c_load % kYStages] - 1);
    }
    if (pending >= 2) {
      cp_wait<2>();
    } else if (pending == 1) {
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    const T* ys = ybuf + (c_load % kYStages) * p.y_words;
    if (kF32 && fresh) {
      // the stage's barrier also ORs the finiteness of the new Y tile
      finite = !__syncthreads_or(copied_nonfinite(
          reinterpret_cast<const float*>(ys), ys_stride, bk,
          (int)(w.cols * sizeof(T)), p.yg));
    } else {
      __syncthreads();       // pair landed; the previous X slot is free
    }
    if (fresh) stage_y();
    stage_x();
    cp_commit();
    ++commits;
    const T* xr = xbuf + c_slot * p.x_words + warp * bk;
    c_slot = c_slot + 1 == kXStages ? 0 : c_slot + 1;
    if (!active) return;
    const bool skip = !kF32 || finite;
    const T* yl = ys + lane * V;
    for (int e0 = 0; e0 < bk; e0 += 32) {
      const int e = e0 + lane;
      const T xv = e < bk ? xr[e] : T(0);
      unsigned m = __ballot_sync(0xffffffffu, skip ? xv != T(0) : e < bk);
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        const T xb = __shfl_sync(0xffffffffu, xv, b);
        T yv[V];
        const T* src = yl + (e0 + b) * ys_stride;
        if constexpr (V * sizeof(T) % 16 == 0) {
          load_words<T, V>(src, yv);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) yv[v] = src[v];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) a[v] += xb * yv[v];
      }
    }
  };
  for (int t = 0; t < tmax; ++t) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g < w.rows && t < s_n[g]) pair(acc[g], g, t);
  }
  cp_wait<0>();
  if (active) {
    if (split) asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= w.rows || (split && s_n[g] == 0)) continue;
      T* o = out + ((w.ra + g) * p.bm + warp) * p.k + w.col0 + lane * V;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (lane * V + v < w.cols) put(o + v, acc[g][v], split);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// out = 0 before a split launch, whose blocks meet by atomicAdd. It lets
// the product's grid start at once (launch_dependents); the product waits
// for it (griddepcontrol.wait) just before its first atomicAdd.
template <typename T>
__global__ void zero_kernel(T* __restrict__ c, long long words) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += (long long)gridDim.x * blockDim.x)
    c[i] = 0;
}

template <typename T>
cudaError_t launch_kernel(void (*kernel)(const T*, const int*, const int*,
                                         const T*, T*, Params),
                          const void* blocks, const void* idx,
                          const void* counts, const void* y, void* out,
                          const Params& p, dim3 grid, size_t smem,
                          cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const T* b = static_cast<const T*>(blocks);
  const int* i = static_cast<const int*>(idx);
  const int* c = static_cast<const int*>(counts);
  const T* yy = static_cast<const T*>(y);
  T* o = static_cast<T*>(out);
  if (p.splits == 1) {
    kernel<<<grid, kThreads, smem, s>>>(b, i, c, yy, o, p);
    return cudaGetLastError();
  }
  const long long words = p.nrb * p.bm * p.k;
  const long long zb = (words + 255) / 256;
  zero_kernel<T><<<(unsigned)(zb < 132 ? zb : 132), 256, 0, s>>>(o, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, b, i, c, yy, o, p);
}

template <typename T, bool YT>
cudaError_t launch_narrow(int width, const void* blocks, const void* idx,
                          const void* counts, const void* y, void* out,
                          const Params& p, size_t smem, cudaStream_t s) {
  const dim3 g((unsigned)((p.nrb + p.rows_per_block - 1) / p.rows_per_block),
               (unsigned)p.splits);         // row blocks, split
  switch (width) {
    case 3: return launch_kernel<T>(narrow_kernel<T, 3, YT>, blocks, idx,
                                    counts, y, out, p, g, smem, s);
    case 4: return launch_kernel<T>(narrow_kernel<T, 4, YT>, blocks, idx,
                                    counts, y, out, p, g, smem, s);
    case 8: return launch_kernel<T>(narrow_kernel<T, 8, YT>, blocks, idx,
                                    counts, y, out, p, g, smem, s);
    case 10: return launch_kernel<T>(narrow_kernel<T, 10, YT>, blocks, idx,
                                     counts, y, out, p, g, smem, s);
    case 12: return launch_kernel<T>(narrow_kernel<T, 12, YT>, blocks, idx,
                                     counts, y, out, p, g, smem, s);
    case 16: return launch_kernel<T>(narrow_kernel<T, 16, YT>, blocks, idx,
                                     counts, y, out, p, g, smem, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_wide(int width, const void* blocks, const void* idx,
                        const void* counts, const void* y, void* out,
                        const Params& p, long long blocks_, size_t smem,
                        cudaStream_t s) {
  const dim3 grid((unsigned)blocks_);
  switch (width) {
    case 1: return launch_kernel<T>(wide_kernel<T, 1>, blocks, idx, counts,
                                    y, out, p, grid, smem, s);
    case 2: return launch_kernel<T>(wide_kernel<T, 2>, blocks, idx, counts,
                                    y, out, p, grid, smem, s);
    case 4: return launch_kernel<T>(wide_kernel<T, 4>, blocks, idx, counts,
                                    y, out, p, grid, smem, s);
    case 8: return launch_kernel<T>(wide_kernel<T, 8>, blocks, idx, counts,
                                    y, out, p, grid, smem, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_word(int wide, int width, int y_t, const void* blocks,
                        const void* idx, const void* counts, const void* y,
                        void* out, const Params& p, long long grid,
                        size_t smem, cudaStream_t s) {
  if (wide)
    return y_t ? cudaErrorInvalidValue
               : launch_wide<T>(width, blocks, idx, counts, y, out, p, grid,
                                smem, s);
  if (y_t)
    return launch_narrow<T, true>(width, blocks, idx, counts, y, out, p,
                                  smem, s);
  return launch_narrow<T, false>(width, blocks, idx, counts, y, out, p, smem,
                                 s);
}

}  // namespace

// One spmm_ell, as planned by kernels/spmm.py:plan. wide: 0 -> the narrow
// kernel (width = K, 3/4/8/10/12/16 sums a lane), 1 -> the wide kernel
// (width = V, columns a lane). y_t: Y is the transposed view of a row-major matrix
// with leading dimension ldy (narrow only); else row-major with ldy. With
// splits > 1 a zero kernel runs first (out need not be zeroed). The wide
// kernel stages X tiles of x_words words in pieces of xg bytes and keeps
// the group's slot counts (rows_per_block ints) and indices
// (rows_per_block * per_split ints) at byte meta_off of shared memory; it
// takes bm <= 8 and bk <= 128.
// word: 0 -> float32, 1 -> 32-bit words mod 2^32, 2 -> 64-bit words mod 2^64.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int spmm_ell_launch(
    const void* blocks, const void* idx, const void* counts, const void* y,
    void* out, long long nrb, long long maxb, int bm, int bk, int k,
    long long ldy, int y_t, int wide, int width, int col_tile,
    int col_tiles, int rows_per_block, long long per_split, int splits,
    int x_words, int y_words, int y_stride, int yg, int xg, int meta_off,
    long long grid, long long smem, int word, void* stream) {
  const Params p{nrb, maxb, bm, bk, k, ldy, col_tile, col_tiles,
                 rows_per_block, per_split, splits, x_words, y_words,
                 y_stride, yg, xg, meta_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 0: return (int)launch_word<float>(wide, width, y_t, blocks, idx,
                                           counts, y, out, p, grid,
                                           (size_t)smem, s);
    case 1: return (int)launch_word<u32>(wide, width, y_t, blocks, idx,
                                         counts, y, out, p, grid,
                                         (size_t)smem, s);
    case 2: return (int)launch_word<u64>(wide, width, y_t, blocks, idx,
                                         counts, y, out, p, grid,
                                         (size_t)smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
