// B2 — RMSNorm over rows, y = x * rsqrt(mean(x^2) + eps) * w, in f32,
// written in x's dtype.
//
// Replaces the TPU kernel `rmsnorm/rows` (src/repro/kernels/rmsnorm.py:
// `_rows`, launch at :72, body `_normalize` at :28).
//
// Bound on the H100: bytes. Each element is read once and written once
// and takes a handful of flops, far below the ~295 flops per byte the
// card needs before its arithmetic is the limit. The design keeps one
// row inside one warp: the sum of squares is a register reduction with
// shuffles (no shared memory, no block barrier), the row is read a second
// time from L1/L2 for the scaled write, and a block holds ROWS_PER_BLOCK
// (8) warps so both d=2560 (norm1/norm2/final) and d=128 (qk-norm) rows
// fill the card.
// The TPU's padding of rows to a multiple of the block is not needed:
// the last block's idle warps simply return.
#include "common.cuh"

using namespace repro;

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

template <typename T>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                        int rows, int d, long long ldx, long long ldy, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= rows) return;
  const T* xr = x + row * ldx;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);
  T* yr = y + row * ldy;
  for (int i = lane; i < d; i += 32) yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
}

extern "C" int rmsnorm_rows(const void* x, const void* w, void* y, int rows, int d,
                            long long ldx, long long ldy, float eps, int dtype, void* stream) {
  const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK), block(32 * ROWS_PER_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    rmsnorm_rows_kernel<bf16><<<grid, block, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y),
        rows, d, ldx, ldy, eps);
  } else {
    rmsnorm_rows_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
        rows, d, ldx, ldy, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING
