// Ring matmul C = A @ B mod 2^64 on 64-bit words, or mod 2^32 on 32-bit
// words, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/modmatmul.py:modmatmul, both
// its bodies: _kernel_u64 and _kernel_u32. The TPU version walks the K axis
// as a sequential grid dimension and carries the sum in a VMEM scratch
// tile; here a loop over K inside the block replaces that axis, and the sum
// stays in registers. The TPU's u32 body splits each word into 16-bit limbs
// because the MXU has no 32-bit integer product; on Hopper one 32-bit IMAD
// already wraps mod 2^32, so every kernel is a template on the word type.
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
//     as the transposed view of a row-major matrix (B of tall-skinny, A of
//     long-K). The layout is a template parameter (BT, AT), never a runtime
//     stride pair, so the inner loops carry no extra registers;
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
//   * every other shape takes the general tile: 128 x 8 or 8 x 32 outputs
//     a block, K staged in chunks of 16, split over gridDim.z with the same
//     atomicAdd when there are too few output tiles to fill the card. It
//     reads both operands row-major (no product of the fits takes it; the
//     wrapper copies a transposed view first).
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

constexpr int kStages = 3;        // cp.async ring depth (tall, long-K)

// ---------------------------------------------------------------------------
// cp.async: one word from global to shared memory, in flight until waited
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void cp_word(T* smem, const T* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(dst), "l"(gmem), "n"(static_cast<int>(sizeof(T))));
}

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
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// variant: 0 -> general tile 128 x 8, 1 -> general tile 8 x 32 (chunk = K
// words per split, blocks = splits along K); 2 -> tall-skinny (chunk = K
// words a stage); 3 -> long-K (chunk = K rows a stage, blocks = grid).
// a_t / b_t: the operand is the transposed view of a row-major matrix with
// leading dimension lda / ldb (A in long-K, B in tall-skinny only); else it
// is row-major with that leading dimension. C is (M, N) row-major and
// contiguous.
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
