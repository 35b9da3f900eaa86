// B1's fused epilogue: an elementwise chain run on the f32 accumulator
// before the one cast to C's type — the port of the `fused` branch of
// the TPU kernel's body (`_mac`, src/repro/kernels/matmul.py:60-67),
// where `ctx.epilogue.body` runs on the VMEM accumulator tile. A CUDA
// kernel cannot call a Python body, so the chain comes as a descriptor
// (`Epi`, filled by kernels/matmul.py's `_EpiDesc`): up to EPI_MAX_STEPS
// steps, each one function of the chain value and extra operands in the
// step's input order. The functions and their f32 semantics are the
// reference body's (src/repro/axe/compile.py:925-944):
//   add(a0, a1, ...)  = a0 + a1 + ... (left to right)
//   swiglu(a0, a1)    = silu(a0) * a1
//   mul_silu(a0, a1)  = a0 * silu(a1)
//   gelu(a0)          = the tanh form (jax.nn.gelu's default)
// Extras are [M, N] tensors of bf16 or f32, read element by element by
// their own leading stride at the output element's (row, column), upcast
// to f32. The chains the fusion passes build for the served models have
// one step and at most one extra (o-proj + add, up + swiglu, down + add,
// up + gelu); four of each leave room for chains written by hand.
//
// A kernel body takes the chain as a functor: `Epi`, or `NoEpi`, whose
// halves do nothing and compile to nothing, so an unfused launch runs no
// instruction of the epilogue. Each route applies it once
// per output element, where the f32 value is final: the wgmma tile's
// writeback, `splitk_reduce` after the splits are summed (never per
// split: an add would add its extra once per split), the skinny stream's
// store after the cluster's sum, the WMMA and f32 tiles' writeback.
//
// A chain is interpreted per element from the descriptor, whose fields a
// kernel reads from memory (its parameter block, taken by address): read
// per element, with 8 warps an SM to hide them (the wgmma tile's
// writeback), they cost more than the product. So the one-step chains of
// one extra the fusion passes build (`EpiKind`) copy their few fields into
// registers once per thread (`EpiFast`) and apply in a few instructions;
// any other chain runs the general interpreter, in one loop per route.
// A first version interpreted every chain at every accumulator register
// and ran the fused wgmma tile several times slower than the plain one;
// tests/torch_epilogue_times.py times each chain kind against no chain
// at the serving shapes.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int EPI_MAX_STEPS = 4;     // steps of one chain
constexpr int EPI_MAX_OPERANDS = 4;  // operands of one step
constexpr int EPI_MAX_EXTRAS = 4;    // extra tensors of one chain

enum EpiFn : int { EPI_ADD = 0, EPI_SWIGLU = 1, EPI_MUL_SILU = 2, EPI_GELU = 3 };

// The one-step chains of one extra the fusion passes build, each applied
// by its own few instructions (the wrapper sets `Epi::kind`; EPI_CHAIN
// runs the general chain).
enum EpiKind : int {
  EPI_CHAIN = 0,      // the general chain
  EPI_V_ADD_X = 1,    // add(v, x0) or add(x0, v)
  EPI_SILU_X_V = 2,   // swiglu(x0, v)
  EPI_SILU_V_X = 3,   // swiglu(v, x0)
  EPI_V_SILU_X = 4,   // mul_silu(v, x0)
  EPI_X_SILU_V = 5,   // mul_silu(x0, v)
  EPI_GELU_V = 6,     // gelu(v)
};

__device__ __forceinline__ float epi_silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float epi_gelu(float x) {
  constexpr float kAlpha = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(kAlpha * (x + 0.044715f * x * x * x)));
}

// A one-step chain's fields, in registers: its kind, extra 0 and how to
// read it.
struct EpiFast {
  int kind, nx, dtype;
  const void* x;
  long long ld;

  __device__ __forceinline__ float load(long long r, long long c) const {
    const long long off = r * ld + c;
    return dtype == BF16 ? __bfloat162float(__ldg(static_cast<const bf16*>(x) + off))
                         : __ldg(static_cast<const float*>(x) + off);
  }

  __device__ __forceinline__ float apply(float v, float x0) const {
    switch (kind) {
      case EPI_V_ADD_X: return v + x0;
      case EPI_SILU_X_V: return epi_silu(x0) * v;
      case EPI_SILU_V_X: return epi_silu(v) * x0;
      case EPI_V_SILU_X: return v * epi_silu(x0);
      case EPI_X_SILU_V: return x0 * epi_silu(v);
      default: return epi_gelu(v);  // EPI_GELU_V
    }
  }
};

// The layout is mirrored by kernels/matmul.py (`_EpiDesc`, a ctypes
// Structure with the same fields in the same order).
struct Epi {
  int steps;
  int kind;  // EpiKind
  int fn[EPI_MAX_STEPS];
  int nops[EPI_MAX_STEPS];
  int op[EPI_MAX_STEPS][EPI_MAX_OPERANDS];  // -1: the chain value; i >= 0: extra i
  int nx;                                   // extras in use
  const void* x[EPI_MAX_EXTRAS];
  long long ld[EPI_MAX_EXTRAS];
  int dtype[EPI_MAX_EXTRAS];

  // The extras' values at output element (r, c), upcast to f32, by the
  // read-only path (the extras are never written by the kernel).
  __device__ __forceinline__ void load(long long r, long long c,
                                       float (&xv)[EPI_MAX_EXTRAS]) const {
#pragma unroll
    for (int i = 0; i < EPI_MAX_EXTRAS; ++i) {
      xv[i] = 0.f;
      if (i < nx) {
        const long long off = r * ld[i] + c;
        xv[i] = dtype[i] == BF16 ? __bfloat162float(__ldg(static_cast<const bf16*>(x[i]) + off))
                                 : __ldg(static_cast<const float*>(x[i]) + off);
      }
    }
  }

  __device__ __forceinline__ EpiFast fast() const { return {kind, nx, dtype[0], x[0], ld[0]}; }

  // The general chain on the accumulator value `v` and the loaded extras.
  __device__ __forceinline__ float chain(float v, const float (&xv)[EPI_MAX_EXTRAS]) const {
#pragma unroll
    for (int s = 0; s < EPI_MAX_STEPS; ++s) {
      if (s >= steps) break;
      float a[EPI_MAX_OPERANDS];
#pragma unroll
      for (int j = 0; j < EPI_MAX_OPERANDS; ++j) {
        const int o = j < nops[s] ? op[s][j] : -1;
        // a select chain, not xv[o]: a register array indexed at run
        // time would live in local memory
        float e = xv[0];
#pragma unroll
        for (int i = 1; i < EPI_MAX_EXTRAS; ++i) e = o == i ? xv[i] : e;
        a[j] = j < nops[s] ? (o < 0 ? v : e) : 0.f;
      }
      switch (fn[s]) {
        case EPI_ADD:
          v = a[0];
#pragma unroll
          for (int j = 1; j < EPI_MAX_OPERANDS; ++j)
            if (j < nops[s]) v += a[j];
          break;
        case EPI_SWIGLU:
          v = epi_silu(a[0]) * a[1];
          break;
        case EPI_MUL_SILU:
          v = a[0] * epi_silu(a[1]);
          break;
        default:
          v = epi_gelu(a[0]);
      }
    }
    return v;
  }
};

struct NoEpi {
  __device__ __forceinline__ EpiFast fast() const { return {}; }
};

// True for a kernel instance that runs a chain.
template <typename EpiT>
constexpr bool has_epi = !std::is_same<EpiT, NoEpi>::value;

// `body(op)` with the one-step chain's function as a functor `op(v, x0)`:
// the switch on the kind is taken once, outside the caller's loop over
// its elements (a switch per element, with a gelu's data-dependent
// branches behind it, slowed the wgmma writeback several times over).
template <typename F>
__device__ __forceinline__ void with_fast_op(int kind, F&& body) {
  switch (kind) {
    case EPI_V_ADD_X: body([](float v, float x0) { return v + x0; }); break;
    case EPI_SILU_X_V: body([](float v, float x0) { return epi_silu(x0) * v; }); break;
    case EPI_SILU_V_X: body([](float v, float x0) { return epi_silu(v) * x0; }); break;
    case EPI_V_SILU_X: body([](float v, float x0) { return v * epi_silu(x0); }); break;
    case EPI_X_SILU_V: body([](float v, float x0) { return x0 * epi_silu(v); }); break;
    default: body([](float v, float) { return epi_gelu(v); });  // EPI_GELU_V
  }
}

// Output element (r, c) of accumulator value `v` through the chain: a
// one-step chain by its fields in registers (`f = epi.fast()`, read once
// per thread), any other through the descriptor.
template <typename EpiT>
__device__ __forceinline__ float epi_at(const EpiT& epi, const EpiFast& f, float v, long long r,
                                        long long c) {
  if constexpr (!has_epi<EpiT>) {
    return v;
  } else {
    if (f.kind != EPI_CHAIN) return f.apply(v, f.nx ? f.load(r, c) : 0.f);
    float xv[EPI_MAX_EXTRAS];
    epi.load(r, c, xv);
    return epi.chain(v, xv);
  }
}

// Run `launch(e)` with the chain when `epi` has steps, else with NoEpi.
template <typename F>
static int with_epilogue(const Epi* epi, F&& launch) {
  return epi && epi->steps ? launch(*epi) : launch(NoEpi{});
}

}  // namespace repro
