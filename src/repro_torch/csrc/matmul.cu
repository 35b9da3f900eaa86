// B1 — C[M,N] = A[M,K] @ B[K,N], f32 accumulation, one cast on the way
// out. A and B are row-major with a unit last stride (leading strides
// lda/ldb/ldc are free).
//
// Replaces the TPU kernel `matmul/tile` (src/repro/kernels/matmul.py:
// `_tile` at :80, launch at :138, body `_mac` at :52). On the TPU the K
// axis is a sequential "arbitrary" grid axis carrying an f32 VMEM
// accumulator between steps; here K is a loop inside each thread block
// and the accumulator lives in registers (tensor-core fragments for
// bf16, per-thread 4x4 tiles for f32).
//
// Bound on the H100, and what the design does about it:
// * Prefill shapes (M = 512, K = 2560..9728, N = 1024..9728) do 2-5 flops
//   per byte of A+B+C and more than 100 per byte once tiles are reused:
//   they are bound by operations. `matmul_bf16_tiled` runs them on the
//   tensor cores through WMMA 16x16x16 bf16 fragments (f32 accumulate) on
//   64x128 block tiles with a 32-deep K step, the next K step's tiles
//   prefetched into registers while the current one multiplies
//   (gemm_tiles.cuh, shared with B5). No TMA, no wgmma and no
//   multi-stage ring yet: those are the later PRs that make it fast.
// * Decode shapes (M = batch = 4) are pure weight streaming: every byte
//   of B is read once for 2*M flops, so they are bound by bytes. A 64-row
//   tile would waste 60 of its 64 rows and, worse, put only N/128 blocks
//   on the card. `matmul_skinny` instead gives each lane a 16-byte column
//   vector of B (coalesced 512-byte rows per warp), keeps A's few rows in
//   shared memory, splits K across the four warps of a block and across
//   blocks (`splits`, chosen by the wrapper to fill the SMs), and sums the
//   K splits in a second, deterministic pass (`splitk_reduce`).
// * f32 (tests and the comparisons in chip_smoke.py; not on the bf16
//   main path) runs `matmul_f32_tiled` on the CUDA cores in full f32 —
//   never TF32, whose ~3 decimal digits the f32 tolerance does not admit.
// Ragged M, N and K are masked in every kernel: out-of-range loads read
// zeros and out-of-range stores are skipped.
#include "gemm_tiles.cuh"

using namespace repro;

// ---------------------------------------------------------------------------
// tiles (M > 8): bf16 on the tensor cores, f32 on the CUDA cores
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(256)
    matmul_bf16_tiled(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
                      int M, int N, int K, long long lda, long long ldb, long long ldc) {
  bf16_tile<VEC>(A, B, C, M, N, K, lda, ldb, ldc, blockIdx.y * TBM, blockIdx.x * TBN);
}

__global__ void __launch_bounds__(256)
    matmul_f32_tiled(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                     int M, int N, int K, long long lda, long long ldb, long long ldc) {
  f32_tile(A, B, C, M, N, K, lda, ldb, ldc, blockIdx.y * FBM, blockIdx.x * FBN);
}

// ---------------------------------------------------------------------------
// skinny products (M <= 8): weight streaming with split K
// ---------------------------------------------------------------------------

constexpr int SK_WARPS = 4;
constexpr int SK_SMEM = 8192;  // floats: A's rows for one K split, then the warp reduction

// One block: 32 lanes x VEC columns of B (one 16-byte load per lane and K
// row), K rows [kbeg, kbeg + kchunk) shared round-robin by SK_WARPS warps.
// With `ws` the block writes its f32 partial sums to ws[split][M][N];
// without, it writes C directly.
template <typename T, int MR>
__global__ void __launch_bounds__(SK_WARPS * 32)
    matmul_skinny_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
                         float* __restrict__ ws, int M, int N, int K, long long lda, long long ldb,
                         long long ldc, int kchunk) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CG = 32 * VEC;
  __shared__ __align__(16) float sm[SK_SMEM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kbeg = blockIdx.y * kchunk;
  const int klen = min(K, kbeg + kchunk) - kbeg;

  for (int e = threadIdx.x; e < MR * klen; e += blockDim.x) {
    const int r = e / klen, c = e % klen;
    sm[r * kchunk + c] = r < M ? to_f32(A[(long long)r * lda + kbeg + c]) : 0.f;
  }
  __syncthreads();

  float acc[MR][VEC];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

  const int n = blockIdx.x * CG + lane * VEC;
  if (n < N) {  // N % VEC == 0: a lane's vector is wholly in or out
    const T* bp = B + (long long)kbeg * ldb + n;
#pragma unroll 4
    for (int kk = warp; kk < klen; kk += SK_WARPS) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(bp + (long long)kk * ldb));
      float bv[VEC];
      unpack16(raw, bv);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float a = sm[r * kchunk + kk];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(a, bv[v], acc[r][v]);
      }
    }
  }
  __syncthreads();  // A's rows are done with; the buffer now sums the warps
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) sm[(warp * MR + r) * CG + lane * VEC + v] = acc[r][v];
  __syncthreads();
  for (int e = threadIdx.x; e < MR * CG; e += blockDim.x) {
    const int r = e / CG, c = e % CG;
    const int gn = blockIdx.x * CG + c;
    if (r < M && gn < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < SK_WARPS; ++w) s += sm[(w * MR + r) * CG + c];
      if (ws)
        ws[((long long)blockIdx.y * M + r) * N + gn] = s;
      else
        C[(long long)r * ldc + gn] = from_f32<T>(s);
    }
  }
}

template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws, T* __restrict__ C, int M, int N,
                              int splits, long long ldc) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)M * N) return;
  const int r = e / N, c = e % N;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += ws[((long long)i * M + r) * N + c];
  C[(long long)r * ldc + c] = from_f32<T>(s);
}

template <typename T, int MR>
static void launch_skinny(const void* a, const void* b, void* c, float* ws, int M, int N, int K,
                          long long lda, long long ldb, long long ldc, int splits, int kchunk,
                          cudaStream_t s) {
  constexpr int CG = 32 * (16 / sizeof(T));
  const dim3 grid((N + CG - 1) / CG, splits);
  matmul_skinny_kernel<T, MR><<<grid, SK_WARPS * 32, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      splits > 1 ? ws : nullptr, M, N, K, lda, ldb, ldc, kchunk);
  if (splits > 1) {
    const long long total = (long long)M * N;
    splitk_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(ws, static_cast<T*>(c), M, N,
                                                                     splits, ldc);
  }
}

// ---------------------------------------------------------------------------
// C entries
// ---------------------------------------------------------------------------

extern "C" int matmul_tiled(const void* a, const void* b, void* c, int M, int N, int K,
                            long long lda, long long ldb, long long ldc, int dtype, int vec,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
    auto* A = static_cast<const bf16*>(a);
    auto* B = static_cast<const bf16*>(b);
    auto* C = static_cast<bf16*>(c);
    if (vec)
      matmul_bf16_tiled<true><<<grid, 256, 0, s>>>(A, B, C, M, N, K, lda, ldb, ldc);
    else
      matmul_bf16_tiled<false><<<grid, 256, 0, s>>>(A, B, C, M, N, K, lda, ldb, ldc);
  } else {
    const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    matmul_f32_tiled<<<grid, 256, 0, s>>>(static_cast<const float*>(a),
                                          static_cast<const float*>(b), static_cast<float*>(c), M,
                                          N, K, lda, ldb, ldc);
  }
  return static_cast<int>(cudaGetLastError());
}

// `ws` holds splits * M * N floats when splits > 1 (ignored otherwise);
// `kchunk` * (M <= 4 ? 4 : 8) must not exceed SK_SMEM.
extern "C" int matmul_skinny(const void* a, const void* b, void* c, void* ws, int M, int N, int K,
                             long long lda, long long ldb, long long ldc, int dtype, int splits,
                             int kchunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == BF16) {
    if (M <= 4)
      launch_skinny<bf16, 4>(a, b, c, w, M, N, K, lda, ldb, ldc, splits, kchunk, s);
    else
      launch_skinny<bf16, 8>(a, b, c, w, M, N, K, lda, ldb, ldc, splits, kchunk, s);
  } else {
    if (M <= 4)
      launch_skinny<float, 4>(a, b, c, w, M, N, K, lda, ldb, ldc, splits, kchunk, s);
    else
      launch_skinny<float, 8>(a, b, c, w, M, N, K, lda, ldb, ldc, splits, kchunk, s);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING
