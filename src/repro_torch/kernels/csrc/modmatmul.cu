// Ring matmul C = A @ B mod 2^64 on 64-bit words, or mod 2^32 on 32-bit
// words, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/modmatmul.py:71
// modmatmul, both its bodies: _kernel_u64 (:56) and _kernel_u32 (:29). The
// TPU version walks the K axis as a sequential grid dimension and carries the
// sum in a VMEM scratch tile; here a loop over K inside the block replaces
// that axis, and the sum stays in registers. The TPU's u32 body splits each
// word into 16-bit limbs because the MXU has no 32-bit integer product; on
// Hopper one 32-bit IMAD already wraps mod 2^32, so every kernel is a
// template on the word type.
//
// Arithmetic is unsigned (unsigned long long / unsigned int), so wraparound
// is defined (signed overflow is undefined in C++). cuBLAS has no 64-bit
// integer GEMM, hence a hand kernel.
//
// What bounds it: the fit's products are tall-skinny (n, d) @ (d, k) and
// long-K (k, n) @ (n, d) with k <= 8 and d in {18, 24, 128}. Each moves
// ~8 bytes per multiply-add and is bound by device-memory bytes, not by the
// multiplies (a 64-bit multiply-add is 3 IMADs). So the design moves each
// word once, with no operand copy beside the kernel, and keeps enough
// bytes in flight:
//   * operands are read in place with their leading dimension and storage
//     offset: row-major, and the operand that the fit passes as a view also
//     as the transposed view of a row-major matrix (B of the tall variants,
//     A of the long-K ones). The layout is a template parameter (BT, AT),
//     never a runtime stride pair, so the inner loops carry no extra
//     registers;
//   * tall-skinny (N <= 8, B of at most 2048 words): B is staged in shared
//     memory once per block; the block's slab of 128 rows of A streams in
//     K chunks through a 3-stage cp.async ring, word-size copies that read
//     the slab's contiguous range coalesced. Its rows land at an odd word
//     stride, so the thread that owns a row reads it without bank
//     conflicts. The 128 x N output slab leaves through shared memory,
//     written coalesced;
//   * long-K (M <= 8 output rows, N <= 256): the K axis is cut into chunks
//     that a few hundred blocks walk through a 3-stage cp.async ring. A
//     transposed A (the one-hot share C^T) is read through its row-major
//     (n, M) original, so each chunk is two contiguous slabs: C's rows and
//     B's rows over one K range. Each block reduces its M x N partial sums
//     in shared memory and adds them with one unsigned atomicAdd per output
//     word: addition mod 2^l is exact and commutative, so the result is
//     word for word the same in any order;
//   * the two wide variants serve the kmeans-fraud cell's (16, n) @ (n, 512)
//     and (n, 512) @ (512, 16): k = 16 centroids against a party's 512
//     columns. At n = 524,288 each moves 2.21 GB (its big operand is 2.15
//     GB of it: 0.66 ms at 3.35 TB/s) and does 4.29e9 64-bit multiply-adds
//     (0.77 ms at 3 IMADs each), so each is bound by operations with the
//     bytes close behind: the big operand is read once, in 16-byte
//     cp.async copies, while the multiplies run. A product takes three
//     32-bit IMADs (Sum<u64>: the low halves' full product into a 64-bit
//     sum, the cross products into a 32-bit high word). IMAD.WIDE issues at
//     half the IMAD rate, so a product holds the IMAD pipe for four IMAD
//     slots: at best ~1.03 ms a launch at this size;
//   * long-K wide (M <= 16 output rows, 256 < N <= 2048): one block owns
//     all 16 rows and a 512-column slab, 32 outputs a thread in a 4 x 8
//     register tile, so B is read from device memory once and A once per
//     slab. About 8 blocks an SM (two resident at a time) walk K-chunks of
//     8 rows through a 3-stage ring; a transposed A is read through its
//     row-major (n, M) original, one contiguous slab a chunk. A thread
//     reads its 8 B words as 2-word shared loads of neighbouring columns
//     (conflict-free) and its 4 A words as broadcasts: 6 shared loads for
//     32 products. Blocks meet by one atomicAdd per output word, as long-K
//     does;
//   * tall wide (N <= 16, K <= 640): B (64 KB at K = 512) is staged whole,
//     once a block, from any of its layouts. One block an SM runs as two
//     halves of 256 threads that share B and nothing else: each walks its
//     own slabs of 256 rows of A through its own 2-stage ring of 16-word
//     (128-byte) row chunks, and meets only its own threads at a named
//     barrier. A 128-byte piece of each row a chunk keeps device memory
//     near its rate where 64-byte pieces left it at ~57 %. A thread owns
//     2 rows x 8 columns; rows land at a stride of 18 words (2 mod 4), so
//     the 2-word loads of 8 neighbouring rows hit distinct banks, and B's
//     words are broadcasts. A slab's rows leave straight from registers: C
//     is 1/32 of A's bytes, and a thread's 16-byte stores fill whole
//     sectors;
//   * every other shape takes the general tile: 128 x 8 or 8 x 32 outputs
//     a block, K staged in chunks of 16, split over gridDim.z with the same
//     atomicAdd when there are too few output tiles to fill the card. It
//     reads both operands row-major (no product of the fits or of the
//     kmeans-fraud cell takes it; the wrapper copies a transposed view
//     first).
// A launch whose blocks meet by atomicAdd needs C zeroed first. A small
// kernel does it, and the product is launched as its programmatic
// dependent (PDL): it starts at once and waits for the zeroing
// (griddepcontrol.wait) only before its first atomicAdd, so the fill
// overlaps the product's loads instead of preceding them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kStages = 3;        // cp.async ring depth (tall, long-K variants)

// ---------------------------------------------------------------------------
// cp.async: one word from global to shared memory, in flight until waited
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void cp_word(T* smem, const T* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(dst), "l"(gmem), "n"(static_cast<int>(sizeof(T))));
}

// two neighbouring words in one copy: 16 bytes for 64-bit words, 8 for
// 32-bit ones; both addresses aligned to the pair
template <typename T>
__device__ __forceinline__ void cp_pair(T* smem, const T* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(dst), "l"(gmem));
  }
}

template <typename T> struct PairOf;
template <> struct PairOf<u64> { typedef ulonglong2 type; };
template <> struct PairOf<u32> { typedef uint2 type; };

// two neighbouring words of shared memory in one load
template <typename T>
__device__ __forceinline__ typename PairOf<T>::type ld_pair(const T* p) {
  return *reinterpret_cast<const typename PairOf<T>::type*>(p);
}

// A running sum of products mod 2^l for the wide kernels. On 64-bit words a
// product costs three 32-bit IMADs: the low halves' full product adds into
// a 64-bit sum (one IMAD.WIDE.U32), the two cross products into a 32-bit
// high word (two IMADs), and the sum is lo + (hi << 32) mod 2^64. Written
// as `acc += a * b`, nvcc spends ~4 IMAD-pipe operations a product plus
// the moves and adds that rejoin the halves.
template <typename T> struct Sum;
template <> struct Sum<u64> {
  u64 lo;
  u32 hi;
  __device__ __forceinline__ void zero() { lo = 0; hi = 0; }
  __device__ __forceinline__ void mac(u64 a, u64 b) {
    const u32 al = (u32)a, ah = (u32)(a >> 32);
    const u32 bl = (u32)b, bh = (u32)(b >> 32);
    asm("mad.wide.u32 %0, %1, %2, %0;" : "+l"(lo) : "r"(al), "r"(bl));
    asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(hi) : "r"(ah), "r"(bl));
    asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(hi) : "r"(al), "r"(bh));
  }
  __device__ __forceinline__ u64 value() const {
    return lo + ((u64)hi << 32);
  }
};
template <> struct Sum<u32> {
  u32 v;
  __device__ __forceinline__ void zero() { v = 0; }
  __device__ __forceinline__ void mac(u32 a, u32 b) { v += a * b; }
  __device__ __forceinline__ u32 value() const { return v; }
};

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// tall-skinny: C (M, N) = A (M, K) @ B (K, N), N <= 8, A row-major
// ---------------------------------------------------------------------------

constexpr int kTallRows = 128;    // rows of A (and C) a block, one a thread

template <typename T, bool BT, int N>
__global__ void __launch_bounds__(kTallRows)
tall_kernel(const T* __restrict__ a, int lda, const T* __restrict__ b,
            int ldb, T* __restrict__ c, long long M, int K, int kc,
            int stage_words) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);          // B: bs[kk * N + j]
  T* as = bs + ((K * N + 1) & ~1);                 // A stages
  const int S = kc | 1;                            // odd row stride (words)
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kTallRows;
  const int rows = (int)min((long long)kTallRows, M - row0);
  const int nchunks = (K + kc - 1) / kc;

  for (int f = tid; f < K * N; f += kTallRows) {
    const int kk = f / N, j = f % N;
    cp_word(bs + f, BT ? b + (long long)j * ldb + kk
                       : b + (long long)kk * ldb + j);
  }
  // the slab of chunk ch: rows x kcur words, walked flat so that a warp
  // reads consecutive words of A when its rows are contiguous
  auto load_chunk = [&](int ch) {
    const int k0 = ch * kc;
    const int kcur = min(kc, K - k0);
    T* dst = as + (ch % kStages) * stage_words;
    const int dr = kTallRows / kcur, dk = kTallRows % kcur;
    int r = tid / kcur, kk = tid % kcur;
    const T* src = a + (row0 + r) * (long long)lda + k0;
    for (int f = tid; f < rows * kcur; f += kTallRows) {
      cp_word(dst + r * S + kk, src + kk);      // src: row r of the slab
      kk += dk;
      r += dr;
      src += (long long)dr * lda;
      if (kk >= kcur) {
        kk -= kcur;
        ++r;
        src += lda;
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk(s);
    cp_commit();
  }

  T acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0;
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_wait<kStages - 2>();
    __syncthreads();                  // chunk ch landed; ch - 1 is consumed
    if (ch + kStages - 1 < nchunks) load_chunk(ch + kStages - 1);
    cp_commit();
    const T* ar = as + (ch % kStages) * stage_words + tid * S;
    const T* bk = bs + ch * kc * N;
    const int kcur = min(kc, K - ch * kc);
    for (int kk = 0; kk < kcur; ++kk) {
      const T av = ar[kk];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] += av * bk[kk * N + j];
    }
  }

  // the rows x N output slab leaves through shared memory, coalesced
  cp_wait<0>();
  __syncthreads();
  T* cs = as;
#pragma unroll
  for (int j = 0; j < N; ++j) cs[tid * N + j] = acc[j];
  __syncthreads();
  T* out = c + row0 * N;
  for (int f = tid; f < rows * N; f += kTallRows) out[f] = cs[f];
}

// ---------------------------------------------------------------------------
// long-K: C (M, N) = A (M, K) @ B (K, N), M <= 8, N <= 256, B row-major
// ---------------------------------------------------------------------------

constexpr int kLongThreads = 256;

template <typename T, bool AT, int M>
__global__ void __launch_bounds__(kLongThreads)
longk_kernel(const T* __restrict__ a, int lda, const T* __restrict__ b,
             int ldb, T* __restrict__ c, long long K, int N, int kb,
             long long nchunks, int stage_words) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int G = kLongThreads / N;          // K groups of N threads
  const int j = tid % N, g = tid / N;
  // B's flat walk: thread tid starts at word tid of a chunk, steps by 256
  const int b_dk = kLongThreads / N, b_dj = kLongThreads % N;

  // chunk ch into stage s: As[kk * M + i] then Bs[kk * N + j]
  auto load_chunk = [&](long long ch, int s) {
    const long long k0 = ch * kb;
    const int kcur = (int)min((long long)kb, K - k0);
    T* as = sm + s * stage_words;
    T* bs = as + kb * M;
    if (AT) {               // A^T's row-major (K, M) original, contiguous
      for (int f = tid; f < kcur * M; f += kLongThreads) {
        const int kk = f / M, i = f % M;
        cp_word(as + f, a + (k0 + kk) * lda + i);
      }
    } else {
#pragma unroll
      for (int i = 0; i < M; ++i)
        for (int kk = tid; kk < kcur; kk += kLongThreads)
          cp_word(as + kk * M + i, a + (long long)i * lda + k0 + kk);
    }
    int kk = tid / N, jj = tid % N;
    for (int f = tid; f < kcur * N; f += kLongThreads) {
      cp_word(bs + f, b + (k0 + kk) * ldb + jj);
      kk += b_dk;
      jj += b_dj;
      if (jj >= N) {
        jj -= N;
        ++kk;
      }
    }
  };

  const long long first = blockIdx.x, step = gridDim.x;
  const int mine = (int)((nchunks - first + step - 1) / step);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) load_chunk(first + s * step, s);
    cp_commit();
  }

  T acc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] = 0;
  for (int q = 0; q < mine; ++q) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (q + kStages - 1 < mine)
      load_chunk(first + (q + kStages - 1) * step, (q + kStages - 1) % kStages);
    cp_commit();
    const T* as = sm + (q % kStages) * stage_words;
    const T* bs = as + kb * M;
    const long long k0 = (first + q * step) * kb;
    const int kcur = (int)min((long long)kb, K - k0);
    if (g < G) {
      for (int kk = g; kk < kcur; kk += G) {
        const T bv = bs[kk * N + j];
#pragma unroll
        for (int i = 0; i < M; ++i) acc[i] += as[kk * M + i] * bv;
      }
    }
  }

  // reduce the G partial sums of each output word, then one store or one
  // atomicAdd per word and block
  cp_wait<0>();
  __syncthreads();
  T* red = sm;                                     // red[(g * M + i) * N + j]
  if (g < G) {
#pragma unroll
    for (int i = 0; i < M; ++i) red[(g * M + i) * N + j] = acc[i];
  }
  __syncthreads();
  // C is zeroed by the grid launched just before this one (see
  // launch_zeroed); wait for it only now, before the first atomicAdd
  if (gridDim.x > 1) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int o = tid; o < M * N; o += kLongThreads) {
    T sum = 0;
    for (int gg = 0; gg < G; ++gg) sum += red[gg * M * N + o];
    if (gridDim.x == 1) {
      c[o] = sum;
    } else {
      atomicAdd(c + o, sum);
    }
  }
}

// ---------------------------------------------------------------------------
// long-K wide: C (M, N) = A (M, K) @ B (K, N), M <= 16, N > 256, B row-major
// ---------------------------------------------------------------------------

constexpr int kLwThreads = 256;
constexpr int kLwRows = 16;                    // C rows a block (M, padded)
constexpr int kLwCols = 2 * kLwThreads;        // C columns a block: its slab
constexpr int kLwKB = 8;                       // K rows a stage
constexpr int kLwStage = kLwKB * (kLwRows + kLwCols);   // words a stage

template <typename T, bool AT>
__global__ void __launch_bounds__(kLwThreads, 2)
longw_kernel(const T* __restrict__ a, int lda, const T* __restrict__ b,
             int ldb, T* __restrict__ c, int M, long long K, int N,
             long long nchunks, int va, int vb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kLwCols;
  const int ncols = min(kLwCols, N - col0);
  const int rg = tid >> 6;             // C rows 4 rg .. 4 rg + 3
  const int cg = tid & 63;             // C columns 2 cg + 128 j + {0, 1}

  // chunk ch into stage s: as[kk * 16 + i], then bs[kk * 512 + j]
  auto load_chunk = [&](long long ch, int s) {
    const long long k0 = ch * kLwKB;
    const int kcur = (int)min((long long)kLwKB, K - k0);
    T* as = sm + s * kLwStage;
    T* bs = as + kLwKB * kLwRows;
    if (AT) {           // rows k0.. of A^T's row-major (K, M) original
      if (va) {
        const int kk = tid >> 3, i = 2 * (tid & 7);
        if (kk < kcur && i < M) {
          const T* src = a + (k0 + kk) * lda + i;
          if (i + 1 < M) {
            cp_pair(as + kk * kLwRows + i, src);
          } else {
            cp_word(as + kk * kLwRows + i, src);
          }
        }
      } else {
        const int kk = tid >> 4, i = tid & 15;
        if (kk < kcur && i < M)
          cp_word(as + kk * kLwRows + i, a + (k0 + kk) * lda + i);
      }
    } else {            // M rows of kcur words, transposed word by word
      const int i = tid >> 3, kk = tid & 7;
      if (i < M && kk < kcur)
        cp_word(as + kk * kLwRows + i, a + (long long)i * lda + k0 + kk);
    }
    const T* brow = b + k0 * ldb + col0;
    for (int kk = 0; kk < kcur; ++kk, brow += ldb) {
      T* dst = bs + kk * kLwCols;
      if (vb) {
        const int j = 2 * tid;
        if (j + 1 < ncols) {
          cp_pair(dst + j, brow + j);
        } else if (j < ncols) {
          cp_word(dst + j, brow + j);
        }
      } else {
        for (int j = tid; j < ncols; j += kLwThreads)
          cp_word(dst + j, brow + j);
      }
    }
  };
  static_assert(kLwKB == 8 && kLwRows == 16, "load_chunk's thread maps");

  const long long first = blockIdx.y, step = gridDim.y;
  const long long mine = (nchunks - first + step - 1) / step;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) load_chunk(first + s * step, s);
    cp_commit();
  }

  Sum<T> acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j].zero();
  }
  for (long long q = 0; q < mine; ++q) {
    cp_wait<kStages - 2>();
    __syncthreads();                  // chunk q landed; q - 1 is consumed
    if (q + kStages - 1 < mine)
      load_chunk(first + (q + kStages - 1) * step,
                 (int)((q + kStages - 1) % kStages));
    cp_commit();
    const T* as = sm + (int)(q % kStages) * kLwStage + 4 * rg;
    const T* bs = sm + (int)(q % kStages) * kLwStage + kLwKB * kLwRows +
                  2 * cg;
    const int kcur = (int)min((long long)kLwKB,
                              K - (first + q * step) * kLwKB);
    auto mac_k = [&](int kk) {          // one K row: 32 products
      const auto a01 = ld_pair(as + kk * kLwRows);
      const auto a23 = ld_pair(as + kk * kLwRows + 2);
      const T av[4] = {a01.x, a01.y, a23.x, a23.y};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const auto bp = ld_pair(bs + kk * kLwCols + 128 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * j].mac(av[i], bp.x);
          acc[i][2 * j + 1].mac(av[i], bp.y);
        }
      }
    };
#pragma unroll 2
    for (int kk = 0; kk < kcur; ++kk) mac_k(kk);
  }

  // one store or one atomicAdd per output word and block; C is zeroed by
  // the grid launched just before a split one (launch_zeroed)
  cp_wait<0>();
  const bool split = gridDim.y > 1;
  if (split) asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * rg + i;
    if (row >= M) break;
    T* out = c + (long long)row * N + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 2 * cg + 128 * (j >> 1) + (j & 1);
      if (col < ncols) {
        if (split) {
          atomicAdd(out + col, acc[i][j].value());
        } else {
          out[col] = acc[i][j].value();
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tall wide: C (M, N) = A (M, K) @ B (K, N), N <= 16, K <= 640, A row-major
// ---------------------------------------------------------------------------

constexpr int kTwHalf = 256;              // threads of a half block
constexpr int kTwThreads = 2 * kTwHalf;
constexpr int kTwRows = 256;              // rows of A (and C) a half's slab
constexpr int kTwN = 16;                  // C columns (N, padded)
constexpr int kTwTN = 8;                  // C columns a thread
constexpr int kTwKC = 16;                 // K words a stage: 128 bytes a row
constexpr int kTwStages = 2;              // ring depth
constexpr int kTwS = kTwKC + 2;           // a staged row's stride: 2 mod 4
constexpr int kTwStage = kTwRows * kTwS;  // words a stage

// a thread's kTwTN sums of one row of C, the first ncols of them (2-word
// stores when C is 16 columns wide, so every pair is aligned)
template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ out, int ncols,
                                          bool pairs,
                                          const Sum<T> (&acc)[kTwTN]) {
  if (pairs) {
#pragma unroll
    for (int j = 0; j < kTwTN; j += 2) {
      typename PairOf<T>::type p;
      p.x = acc[j].value();
      p.y = acc[j + 1].value();
      *reinterpret_cast<typename PairOf<T>::type*>(out + j) = p;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTwTN; ++j)
      if (j < ncols) out[j] = acc[j].value();
  }
}

// B is staged once for the block; its two halves then run as two blocks
// would, each walking its own 256-row slabs through its own ring and
// meeting only its own 256 threads at a named barrier (1 + half), so one
// half's wait does not stall the other's products
template <typename T, bool BT>
__global__ void __launch_bounds__(kTwThreads, 1)
tallw_kernel(const T* __restrict__ a, int lda, const T* __restrict__ b,
             int ldb, T* __restrict__ c, long long M, int K, int N,
             long long nslabs, int va) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);   // B: bs[kk * 16 + j]
  const int kp = (K + 1) & ~1;              // rows of bs: K, even
  const int half = threadIdx.x / kTwHalf;
  const int tid = threadIdx.x % kTwHalf;
  T* ring = bs + kp * kTwN + half * kTwStages * kTwStage;
  const int g = tid >> 1;                   // rows g and g + 128 of a slab
  const int col0 = (tid & 1) * kTwTN;       // columns col0 .. col0 + 7

  // B whole, word by word from either layout, by all the block's threads;
  // the padding (columns N.., an odd K's extra row) is zero, so the 2-word
  // loads of A's last odd chunk add nothing
  if (BT) {
    for (int f = threadIdx.x; f < N * K; f += kTwThreads) {
      const int j = f / K, kk = f - j * K;
      cp_word(bs + kk * kTwN + j, b + (long long)j * ldb + kk);
    }
  } else {
    for (int f = threadIdx.x; f < K * N; f += kTwThreads) {
      const int kk = f / N, j = f - kk * N;
      cp_word(bs + kk * kTwN + j, b + (long long)kk * ldb + j);
    }
  }
  for (int f = threadIdx.x; f < kp * kTwN; f += kTwThreads)
    if ((f >> 4) >= K || (f & 15) >= N) bs[f] = 0;

  // item q of a half: chunk q % nch of its slab q / nch
  const int nch = (K + kTwKC - 1) / kTwKC;
  const long long first = 2LL * blockIdx.x + half, step = 2LL * gridDim.x;
  const long long items =
      first < nslabs ? (nslabs - first + step - 1) / step * nch : 0;
  auto load_item = [&](long long q, int s) {
    const long long row0 = (first + q / nch * step) * kTwRows;
    const int rows = (int)min((long long)kTwRows, M - row0);
    const int k0 = (int)(q % nch) * kTwKC;
    const int kcur = min(kTwKC, K - k0);
    T* dst = ring + s * kTwStage;
    const T* src = a + row0 * lda + k0;
    if (va) {
#pragma unroll
      for (int p = 0; p < kTwRows * kTwKC / 2 / kTwHalf; ++p) {
        const int f = tid + p * kTwHalf;
        const int r = f >> 3, kk = 2 * (f & 7);
        if (r < rows && kk < kcur) {
          const T* w = src + (long long)r * lda + kk;
          if (kk + 1 < kcur) {
            cp_pair(dst + r * kTwS + kk, w);
          } else {
            cp_word(dst + r * kTwS + kk, w);
          }
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < kTwRows * kTwKC / kTwHalf; ++p) {
        const int f = tid + p * kTwHalf;
        const int r = f >> 4, kk = f & 15;
        if (r < rows && kk < kcur)
          cp_word(dst + r * kTwS + kk, src + (long long)r * lda + kk);
      }
    }
  };
  static_assert(kTwKC == 16 && kTwN == 16 && kTwRows == kTwHalf,
                "load_item's and the tile's thread maps");
#pragma unroll
  for (int s = 0; s < kTwStages - 1; ++s) {
    if (s < items) load_item(s, s);
    cp_commit();                      // B lands with the first group
  }
  cp_wait<kTwStages - 2>();
  __syncthreads();                    // B landed, from every thread's copies

  Sum<T> acc0[kTwTN], acc1[kTwTN];    // rows g and g + 128 of a slab
#pragma unroll
  for (int j = 0; j < kTwTN; ++j) {
    acc0[j].zero();
    acc1[j].zero();
  }
  for (long long q = 0; q < items; ++q) {
    cp_wait<kTwStages - 2>();
    // item q landed; q - 1 is consumed (this half's threads only)
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + half), "n"(kTwHalf)
                 : "memory");
    if (q + kTwStages - 1 < items)
      load_item(q + kTwStages - 1, (int)((q + kTwStages - 1) % kTwStages));
    cp_commit();
    const int ch = (int)(q % nch);
    const int kcur = min(kTwKC, K - ch * kTwKC);
    const T* x0 = ring + (int)(q % kTwStages) * kTwStage + g * kTwS;
    const T* x1 = x0 + (kTwRows / 2) * kTwS;
    const T* bk = bs + ch * kTwKC * kTwN + col0;
#pragma unroll 2
    for (int kk = 0; kk < kcur; kk += 2) {   // two K words: 32 products
      const auto p0 = ld_pair(x0 + kk);
      const auto p1 = ld_pair(x1 + kk);
#pragma unroll
      for (int j = 0; j < kTwTN; j += 2) {
        const auto u = ld_pair(bk + kk * kTwN + j);
        const auto v = ld_pair(bk + (kk + 1) * kTwN + j);
        acc0[j].mac(p0.x, u.x);
        acc0[j].mac(p0.y, v.x);
        acc0[j + 1].mac(p0.x, u.y);
        acc0[j + 1].mac(p0.y, v.y);
        acc1[j].mac(p1.x, u.x);
        acc1[j].mac(p1.y, v.x);
        acc1[j + 1].mac(p1.x, u.y);
        acc1[j + 1].mac(p1.y, v.y);
      }
    }
    if (ch == nch - 1) {              // the slab is done: its rows leave
      const long long row = (first + q / nch * step) * kTwRows + g;
      if (row < M) store_row(c + row * N + col0, N - col0, N == kTwN, acc0);
      if (row + kTwRows / 2 < M)
        store_row(c + (row + kTwRows / 2) * N + col0, N - col0, N == kTwN,
                  acc1);
#pragma unroll
      for (int j = 0; j < kTwTN; ++j) {
        acc0[j].zero();
        acc1[j].zero();
      }
    }
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// general tile: any shape, A and B row-major
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBK = 16;

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
general_kernel(const T* __restrict__ a, int lda, const T* __restrict__ b,
               int ldb, T* __restrict__ c, long long M, long long K,
               long long N, long long k_per_split) {
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
      as[r][kk] = (gr < M && gk < k_end) ? a[gr * lda + gk] : T(0);
    }
    for (int i = tid; i < kBK * BN; i += kThreads) {
      const int kk = i / BN, cc = i % BN;
      const long long gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k_end && gc < N) ? b[gk * ldb + gc] : T(0);
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

  if (gridDim.z > 1) asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// C = 0 for a launch whose blocks meet by atomicAdd. It lets the product's
// grid start at once (launch_dependents); that grid waits for it with
// griddepcontrol.wait just before its first atomicAdd, so the fill
// overlaps the product's loads instead of preceding them.
template <typename T>
__global__ void zero_kernel(T* __restrict__ c, long long words) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += (long long)gridDim.x * blockDim.x)
    c[i] = 0;
}

// kernel<<<grid, block, smem, s>>>(args...), after zeroing the `words`
// words of c when `zeroed` (a split launch): the zero kernel first, then
// the product as its programmatic dependent on the same stream.
template <typename T, typename... Exp, typename... Act>
cudaError_t launch_zeroed(bool zeroed, T* c, long long words,
                          void (*kernel)(Exp...), dim3 grid, int block,
                          size_t smem, cudaStream_t s, Act... args) {
  if (!zeroed) {
    kernel<<<grid, block, smem, s>>>(args...);
    return cudaGetLastError();
  }
  const long long zb = (words + 255) / 256;
  zero_kernel<T><<<(unsigned)(zb < 132 ? zb : 132), 256, 0, s>>>(c, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, bool BT, int N>
cudaError_t launch_tall(const void* a, int lda, const void* b, int ldb,
                        void* c, long long M, int K, int kc, cudaStream_t s) {
  const int nchunks = (K + kc - 1) / kc;
  const int stages = nchunks < kStages ? nchunks : kStages;
  const int stage_words = kTallRows * (kc | 1);
  int a_words = stages * stage_words;
  if (a_words < kTallRows * N) a_words = kTallRows * N;   // output slab
  const size_t smem = sizeof(T) * (((K * N + 1) & ~1) + a_words);
  auto kernel = tall_kernel<T, BT, N>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((M + kTallRows - 1) / kTallRows);
  kernel<<<grid, kTallRows, smem, s>>>(
      static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb,
      static_cast<T*>(c), M, K, kc, stage_words);
  return cudaGetLastError();
}

template <typename T, bool AT, int M>
cudaError_t launch_longk(const void* a, int lda, const void* b, int ldb,
                         void* c, long long K, int N, int kb, int blocks,
                         cudaStream_t s) {
  const long long nchunks = (K + kb - 1) / kb;
  const int stage_words = kb * (M + N);
  int words = kStages * stage_words;
  if (words < kLongThreads * M) words = kLongThreads * M;  // reduction
  const size_t smem = sizeof(T) * words;
  auto kernel = longk_kernel<T, AT, M>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return launch_zeroed(blocks > 1, static_cast<T*>(c), (long long)M * N,
                       kernel, dim3(blocks), kLongThreads, smem, s,
                       static_cast<const T*>(a), lda,
                       static_cast<const T*>(b), ldb, static_cast<T*>(c), K,
                       N, kb, nchunks, stage_words);
}

template <typename T, int BM, int BN>
cudaError_t launch_general(const void* a, int lda, const void* b, int ldb,
                           void* c, long long M, long long K, long long N,
                           long long k_per_split, int splits,
                           cudaStream_t s) {
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
            (unsigned)splits);
  return launch_zeroed(splits > 1, static_cast<T*>(c), M * N,
                       general_kernel<T, BM, BN>, grid, kThreads, 0,
                       s, static_cast<const T*>(a), lda,
                       static_cast<const T*>(b), ldb, static_cast<T*>(c), M,
                       K, N, k_per_split);
}

// whether an operand with leading dimension ld can be copied two words at a
// time: its first word aligned to a pair, and every row starting on a pair
template <typename T>
bool pairable(const void* p, int ld) {
  return reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T)) == 0 && ld % 2 == 0;
}

template <typename T, bool AT>
cudaError_t launch_longw(const void* a, int lda, const void* b, int ldb,
                         void* c, long long M, long long K, long long N,
                         long long kb, int blocks, cudaStream_t s) {
  if (kb != kLwKB || M > kLwRows) return cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * kStages * kLwStage;
  auto kernel = longw_kernel<T, AT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + kLwCols - 1) / kLwCols), (unsigned)blocks);
  return launch_zeroed(blocks > 1, static_cast<T*>(c), M * N, kernel, grid,
                       kLwThreads, smem, s, static_cast<const T*>(a), lda,
                       static_cast<const T*>(b), ldb, static_cast<T*>(c),
                       (int)M, K, (int)N, (K + kLwKB - 1) / kLwKB,
                       (int)(AT && pairable<T>(a, lda)),
                       (int)pairable<T>(b, ldb));
}

template <typename T, bool BT>
cudaError_t launch_tallw(const void* a, int lda, const void* b, int ldb,
                         void* c, long long M, long long K, long long N,
                         long long kc, int blocks, cudaStream_t s) {
  if (kc != kTwKC || N > kTwN) return cudaErrorInvalidValue;
  const long long kp = (K + 1) & ~1LL;
  const size_t smem = sizeof(T) * (kp * kTwN + 2 * kTwStages * kTwStage);
  auto kernel = tallw_kernel<T, BT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kTwThreads, smem, s>>>(
      static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb,
      static_cast<T*>(c), M, (int)K, (int)N,
      (M + kTwRows - 1) / kTwRows, (int)pairable<T>(a, lda));
  return cudaGetLastError();
}

// Dispatch of a runtime value in [1, 8] onto a template parameter.
template <template <int> class F, typename... Args>
cudaError_t dispatch8(int v, Args... args) {
  switch (v) {
    case 1: return F<1>::run(args...);
    case 2: return F<2>::run(args...);
    case 3: return F<3>::run(args...);
    case 4: return F<4>::run(args...);
    case 5: return F<5>::run(args...);
    case 6: return F<6>::run(args...);
    case 7: return F<7>::run(args...);
    case 8: return F<8>::run(args...);
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool BT>
struct Tall {
  template <int N>
  struct F {
    static cudaError_t run(const void* a, int lda, const void* b, int ldb,
                           void* c, long long M, int K, int kc,
                           cudaStream_t s) {
      return launch_tall<T, BT, N>(a, lda, b, ldb, c, M, K, kc, s);
    }
  };
};

template <typename T, bool AT>
struct LongK {
  template <int M>
  struct F {
    static cudaError_t run(const void* a, int lda, const void* b, int ldb,
                           void* c, long long K, int N, int kb, int blocks,
                           cudaStream_t s) {
      return launch_longk<T, AT, M>(a, lda, b, ldb, c, K, N, kb, blocks, s);
    }
  };
};

template <typename T>
cudaError_t launch_variant(int variant, const void* a, int lda, int a_t,
                           const void* b, int ldb, int b_t, void* c,
                           long long M, long long K, long long N,
                           long long chunk, int blocks, cudaStream_t s) {
  switch (variant) {
    case 0:
      if (a_t || b_t) return cudaErrorInvalidValue;
      return launch_general<T, 128, 8>(a, lda, b, ldb, c, M, K, N, chunk,
                                       blocks, s);
    case 1:
      if (a_t || b_t) return cudaErrorInvalidValue;
      return launch_general<T, 8, 32>(a, lda, b, ldb, c, M, K, N, chunk,
                                      blocks, s);
    case 2:
      if (a_t) return cudaErrorInvalidValue;
      if (b_t)
        return dispatch8<Tall<T, true>::template F>(
            (int)N, a, lda, b, ldb, c, M, (int)K, (int)chunk, s);
      return dispatch8<Tall<T, false>::template F>(
          (int)N, a, lda, b, ldb, c, M, (int)K, (int)chunk, s);
    case 3:
      if (b_t) return cudaErrorInvalidValue;
      if (a_t)
        return dispatch8<LongK<T, true>::template F>(
            (int)M, a, lda, b, ldb, c, K, (int)N, (int)chunk, blocks, s);
      return dispatch8<LongK<T, false>::template F>(
          (int)M, a, lda, b, ldb, c, K, (int)N, (int)chunk, blocks, s);
    case 4:
      if (a_t) return cudaErrorInvalidValue;
      if (b_t)
        return launch_tallw<T, true>(a, lda, b, ldb, c, M, K, N, chunk,
                                     blocks, s);
      return launch_tallw<T, false>(a, lda, b, ldb, c, M, K, N, chunk,
                                    blocks, s);
    case 5:
      if (b_t) return cudaErrorInvalidValue;
      if (a_t)
        return launch_longw<T, true>(a, lda, b, ldb, c, M, K, N, chunk,
                                     blocks, s);
      return launch_longw<T, false>(a, lda, b, ldb, c, M, K, N, chunk,
                                    blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// variant: 0 -> general tile 128 x 8, 1 -> general tile 8 x 32 (chunk = K
// words per split, blocks = splits along K); 2 -> tall-skinny (chunk = K
// words a stage); 3 -> long-K (chunk = K rows a stage, blocks = grid);
// 4 -> tall wide (chunk = 8, blocks = grid, each walking slabs of 512
// rows); 5 -> long-K wide (chunk = 8, blocks = K splits of each 512-column
// slab). a_t / b_t: the operand is the transposed view of a row-major
// matrix with leading dimension lda / ldb (A in the long-K variants, B in
// the tall ones only); else it is row-major with that leading dimension.
// C is (M, N) row-major and contiguous.
// word_bits: 64 -> mod 2^64 on 64-bit words, 32 -> mod 2^32 on 32-bit words.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int ring_matmul_launch(const void* a, int lda, int a_t,
                                  const void* b, int ldb, int b_t, void* c,
                                  long long M, long long K, long long N,
                                  int variant, long long chunk, int blocks,
                                  int word_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (word_bits == 64)
    return (int)launch_variant<u64>(variant, a, lda, a_t, b, ldb, b_t, c, M,
                                    K, N, chunk, blocks, s);
  if (word_bits == 32)
    return (int)launch_variant<u32>(variant, a, lda, a_t, b, ldb, b_t, c, M,
                                    K, N, chunk, blocks, s);
  return (int)cudaErrorInvalidValue;
}
