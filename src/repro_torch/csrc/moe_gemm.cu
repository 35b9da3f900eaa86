// B5 — per-expert batched GEMM out[e] = x[e] @ w[e] for every expert e:
// x [E, C, d] (the capacity buffer of the MoE dispatch), w [E, d, f],
// out [E, C, f], f32 accumulation and one cast to the output dtype. All
// three are contiguous; expert e's operands start at e times the
// per-expert stride.
//
// Replaces the TPU kernel `moe_gemm/expert_gemm` (src/repro/kernels/
// moe_gemm.py: `_expert_gemm` at :70, launch at :94, body `_mac` at :49).
// On the TPU the grid is (E, C/bc, f/bf, d/bd) with the d axis a
// sequential "arbitrary" axis carrying an f32 VMEM accumulator; here the
// grid is (f/TBN, C/TBM, E), every block independent, and d is a loop
// inside the block with the accumulator in registers.
//
// Bound on the H100, and what the design does about it:
// * On the serving path the capacity is small (qwen3-moe-235b-a22b: 40
//   slots for a 4 x 128-token prefill, 8 for a 4-slot decode tick) and
//   the weights are large (3 x 1.61 GB per layer in bf16): every launch
//   reads each expert's whole weight once for 2 x C flops per weight, so
//   it is bound by bytes (~0.48 ms for 1.61 GB at 3.35 TB/s against
//   ~0.065 ms of tensor-core work). With TBM = 64 every such capacity
//   fits in one M tile, so each weight byte is read exactly once, and
//   the grid still holds f/128 x E = 1536-4096 blocks for 132 SMs: no
//   split of d is needed.
// * The tiles are B1's (gemm_tiles.cuh): bf16 through WMMA on the tensor
//   cores, f32 on the CUDA cores in full f32 (never TF32). Rows of the
//   tile past C are zeros and cost only tensor-core time, which the byte
//   bound hides. No TMA, wgmma or multi-stage ring yet, and every expert
//   is computed even when it received no token: later PRs.
// Ragged C, f and d are masked: out-of-range loads read zeros and
// out-of-range stores are skipped.
#include "gemm_tiles.cuh"

using namespace repro;

template <bool VEC>
__global__ void __launch_bounds__(256)
    moe_gemm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                  int C, int D, int F) {
  const long long e = blockIdx.z;
  bf16_tile<VEC>(x + e * C * D, w + e * D * F, out + e * C * F, C, F, D, D, F, F,
                 blockIdx.y * TBM, blockIdx.x * TBN);
}

__global__ void __launch_bounds__(256)
    moe_gemm_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                 int C, int D, int F) {
  const long long e = blockIdx.z;
  f32_tile(x + e * C * D, w + e * D * F, out + e * C * F, C, F, D, D, F, F, blockIdx.y * FBM,
           blockIdx.x * FBN);
}

// `vec`: d and f are multiples of 8 and x, w start 16-byte aligned, so
// every row moves in 16-byte chunks (bf16 only).
extern "C" int moe_gemm(const void* x, const void* w, void* out, int E, int C, int D, int F,
                        int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    const dim3 grid((F + TBN - 1) / TBN, (C + TBM - 1) / TBM, E);
    auto* X = static_cast<const bf16*>(x);
    auto* W = static_cast<const bf16*>(w);
    auto* O = static_cast<bf16*>(out);
    if (vec)
      moe_gemm_bf16<true><<<grid, 256, 0, s>>>(X, W, O, C, D, F);
    else
      moe_gemm_bf16<false><<<grid, 256, 0, s>>>(X, W, O, C, D, F);
  } else {
    const dim3 grid((F + FBN - 1) / FBN, (C + FBM - 1) / FBM, E);
    moe_gemm_f32<<<grid, 256, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                      static_cast<float*>(out), C, D, F);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING
