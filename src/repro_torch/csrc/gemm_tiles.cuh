// Block tiles of a row-major GEMM C = A @ B with f32 accumulation and
// one cast on the way out (C may be of another type than A and B: the
// f32 accumulator is written as OutT), shared by B1 (matmul.cu, one product) and B5
// (moe_gemm.cu, one product per expert): the routes of f32 and of bf16
// operands that TMA cannot address. A caller's kernel hands each
// thread block its operands' base pointers and the output tile's origin
// (m0, n0); ragged M, N and K are masked here (out-of-range loads read
// zeros, out-of-range stores are skipped). B1 may hand a fused epilogue
// (`epi`, epilogue.cuh) that runs on each f32 value before its cast; B5
// hands none.
//
// * `bf16_tile`: tensor cores through WMMA 16x16x16 bf16 fragments (f32
//   accumulate) on a TBM x TBN tile with a TBK-deep K step, the next K
//   step's tiles prefetched into registers while the current one
//   multiplies. 256 threads: 2 x 4 warps of 32 x 32 outputs.
// * `f32_tile`: CUDA cores in full f32 (never TF32, whose ~3 decimal
//   digits the f32 tolerance does not admit), 4 x 4 outputs a thread.
//   256 threads.
#pragma once

#include <mma.h>

#include "common.cuh"
#include "epilogue.cuh"

namespace repro {

namespace wmma = nvcuda::wmma;

constexpr int TBM = 64, TBN = 128, TBK = 32;
constexpr int A_LD = TBK + 8;  // bf16 elements; +8 breaks bank conflicts, keeps 16-byte rows
constexpr int B_LD = TBN + 8;
constexpr int C_LD = TBN + 4;  // f32 staging of the output tile

// One 8-element chunk of row `row`, columns [col, col + 8), zeros past
// `rows` and `cols`; element loads (the callers' operands are the ones
// TMA cannot address, so rows need not be 16-byte aligned).
__device__ __forceinline__ uint4 load_chunk(const bf16* __restrict__ base, long long ld, int row,
                                            int col, int rows, int cols) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return out;
  const bf16* p = base + (long long)row * ld + col;
  bf16* e = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (col + i < cols) e[i] = p[i];
  return out;
}

template <typename OutT, typename EpiT = NoEpi>
__device__ __forceinline__ void bf16_tile(const bf16* __restrict__ A, const bf16* __restrict__ B,
                                          OutT* __restrict__ C, int M, int N, int K, long long lda,
                                          long long ldb, long long ldc, int m0, int n0,
                                          const EpiT& epi = EpiT()) {
  __shared__ __align__(128) bf16 As[TBM * A_LD];
  __shared__ __align__(128) bf16 Bs[TBK * B_LD];
  __shared__ __align__(128) float Cs[TBM * C_LD];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 32 x 32 outputs each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // A tile 64 x 32: one 8-element chunk per thread; B tile 32 x 128: two.
  const int a_row = tid >> 2, a_col = (tid & 3) * 8;
  const int b_row0 = tid >> 4, b_col = (tid & 15) * 8;
  uint4 ra, rb0, rb1;
  auto fetch = [&](int k0) {
    ra = load_chunk(A + (long long)m0 * lda + k0, lda, a_row, a_col, M - m0, K - k0);
    rb0 = load_chunk(B + (long long)k0 * ldb + n0, ldb, b_row0, b_col, K - k0, N - n0);
    rb1 = load_chunk(B + (long long)k0 * ldb + n0, ldb, b_row0 + 16, b_col, K - k0, N - n0);
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += TBK) {
    __syncthreads();  // the previous step's fragments are loaded
    *reinterpret_cast<uint4*>(&As[a_row * A_LD + a_col]) = ra;
    *reinterpret_cast<uint4*>(&Bs[b_row0 * B_LD + b_col]) = rb0;
    *reinterpret_cast<uint4*>(&Bs[(b_row0 + 16) * B_LD + b_col]) = rb1;
    __syncthreads();
    if (k0 + TBK < K) fetch(k0 + TBK);  // in flight while this step multiplies
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16], acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  const EpiFast f = epi.fast();
  for (int e = tid; e < TBM * TBN; e += 256) {
    const int r = e / TBN, c = e % TBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N)
      C[(long long)gm * ldc + gn] = from_f32<OutT>(epi_at(epi, f, Cs[r * C_LD + c], gm, gn));
  }
}

constexpr int FBM = 64, FBN = 64, FBK = 16;

template <typename OutT, typename EpiT = NoEpi>
__device__ __forceinline__ void f32_tile(const float* __restrict__ A, const float* __restrict__ B,
                                         OutT* __restrict__ C, int M, int N, int K, long long lda,
                                         long long ldb, long long ldc, int m0, int n0,
                                         const EpiT& epi = EpiT()) {
  __shared__ float As[FBK][FBM + 4];  // transposed: As[k][m]
  __shared__ float Bs[FBK][FBN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + 256 * i;
      const int ar = e >> 4, ac = e & 15;  // A tile 64 x 16
      const int gm = m0 + ar, gk = k0 + ac;
      As[ac][ar] = (gm < M && gk < K) ? A[(long long)gm * lda + gk] : 0.f;
      const int br = e >> 6, bc = e & 63;  // B tile 16 x 64
      const int gk2 = k0 + br, gn = n0 + bc;
      Bs[br][bc] = (gk2 < K && gn < N) ? B[(long long)gk2 * ldb + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if constexpr (!has_epi<EpiT>) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
        if (gm < M && gn < N) C[(long long)gm * ldc + gn] = from_f32<OutT>(acc[i][j]);
      }
  } else {
    // the chain in one loop, the tile staged in shared memory (epilogue.cuh)
    __shared__ float Ct[FBM][FBN + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ct[ty + 16 * i][tx + 16 * j] = acc[i][j];
    __syncthreads();
    const EpiFast f = epi.fast();
    for (int e = tid; e < FBM * FBN; e += 256) {
      const int gm = m0 + e / FBN, gn = n0 + e % FBN;
      if (gm < M && gn < N)
        C[(long long)gm * ldc + gn] = from_f32<OutT>(epi_at(epi, f, Ct[e / FBN][e % FBN], gm, gn));
    }
  }
}

}  // namespace repro
