// B1 — C[M,N] = A[M,K] @ B[K,N], f32 accumulation, one cast on the way
// out. A and B are row-major with a unit last stride (leading strides
// lda/ldb/ldc are free). C is of the operands' type or, where the caller
// asks (`out_dtype` of the C entries), of the other one (f32 or bf16):
// every kernel writes its f32 accumulator as C's type, never rounding
// through the operands' type first.
//
// Replaces the TPU kernel `matmul/tile` (src/repro/kernels/matmul.py:
// `_tile` at :80, launch at :138, body `_mac` at :52). On the TPU the K
// axis is a sequential "arbitrary" grid axis carrying an f32 VMEM
// accumulator between steps; here K is a loop inside each thread block
// and the accumulator lives in registers.
//
// Bound on the H100, and what the design does about it. The wrapper
// (kernels/matmul.py, `tile_route`) picks one of four kernels by shape:
// * Prefill shapes (M = 512, K = 2560..9728, N = 512..9728) do 2-5 flops
//   per byte of A+B+C and more than 100 per byte once tiles are reused:
//   they are bound by operations, so they must reach Hopper's wgmma rate.
//   `matmul_bf16_wgmma` takes every bf16 product with M > 8 whose
//   operands TMA can address (K and N multiples of 8, 16-byte-aligned
//   bases and leading strides): 128x128 output tiles, one producer warp
//   keeping TMA loads of A [128 x 64] and B [64 x 128] (two 64-wide
//   128-byte-swizzled boxes) in flight through a 4-stage mbarrier ring
//   (4 x 32 KB of shared memory, one block per SM), and two consumer
//   warpgroups of 64 output rows each issuing wgmma m64n128k16 with A
//   K-major and B MN-major (transpose bit). The accumulators stay in
//   registers; the epilogue rounds to bf16 and stores straight to C.
//   A grid under one wave of blocks (qwen3-4b's k|v, 32 tiles; qwen3-moe's
//   k|v, 16 tiles) splits K in whole 64-deep steps (`tile_plan` in the
//   wrapper) into an f32 workspace that `splitk_reduce` sums in split
//   order: deterministic, no atomics. The 80-tile shapes (qwen3-4b's o and
//   down) are not split: at one block per SM, two splits make 160 blocks,
//   two waves of half the work each, no faster than one wave of 80, plus
//   the reduce pass.
// * Ragged bf16 shapes that TMA cannot take run `matmul_bf16_tiled`: WMMA
//   16x16x16 fragments (mma.sync) on 64x128x32 tiles with a register
//   prefetch and masked scalar loads (gemm_tiles.cuh, shared with B5).
// * Decode shapes (M = batch = 4) are pure weight streaming: every byte
//   of B is read once for 2*M flops, so they are bound by bytes, and
//   reaching the byte rate takes ~25 KB in flight per SM (3.35 TB/s at
//   ~1 us of latency over 132 SMs). A 64-row tile would waste 60 of its 64
//   rows and put only N/128 blocks on the card. `matmul_skinny_stream`
//   gives a block one 512-byte column segment of B (256 bf16 columns) and
//   one K split (`skinny_plan` in the wrapper picks up to 8 splits, to
//   about one block per SM, and the ring's depth); one producer thread
//   streams the segment by TMA, 16 KB (32 rows x 512 bytes) per stage,
//   through a 2-8-stage mbarrier ring; each weight's tensor map is
//   encoded at its first product and kept, so a decode step encodes
//   none. The consumers run the product transposed on the tensor cores,
//   Ct = Bt At on mma.sync m16n8k16, A's <= 8 rows the n8 operand: a
//   first version on CUDA-core FMAs (a lane per 16-byte column vector)
//   spent ~66 clocks per 512-byte row per block whatever the ring depth,
//   its consumers and not the memory the bound; mma.sync needs 8 products
//   and 9 ldmatrix per warp and stage where that loop issued ~400
//   instructions (f32, off the serving path, keeps it). The bf16 boxes
//   carry the 128-byte swizzle, so ldmatrix.trans reads Bt without bank
//   conflicts. The K splits are the blocks of one thread-block cluster
//   and are summed inside the same launch through distributed shared
//   memory, in split order: no second pass, no workspace, no atomics,
//   equal bits on every run.
// * f32 products of more than 8 rows (tests and the comparisons in
//   chip_smoke.py; not on the bf16 main path) run `matmul_f32_tiled` on
//   the CUDA cores in full f32 (f32 skinny products take the skinny
//   kernel, templated on the type) —
//   never TF32, whose ~3 decimal digits the f32 tolerance does not admit.
// Ragged M, N and K are masked in every kernel: out-of-range loads read
// zeros (TMA fills them) and out-of-range stores are skipped.
//
// The fused epilogue (epilogue.cuh; the port of `_mac`'s `fused` branch)
// is a template functor of every kernel: each C entry takes a nullable
// chain descriptor and launches the `Epi` instance when it has steps, the
// `NoEpi` one (the unfused code, unchanged) otherwise. Every route runs
// the chain once per output element on its final f32 value: the wgmma
// writeback (a one-step chain straight from the accumulator registers,
// any other through the tile staged in the free ring), `splitk_reduce`
// after the split sum (the split kernels store raw partials), the skinny
// stream after the cluster's sum (with a chain the partials take that
// path even with one split), the WMMA and f32 tiles' writeback. An
// element the chain reads of an extra costs a scalar load from device
// memory (the extras are [M, N], as C).
#include <map>
#include <mutex>
#include <tuple>

#include "epilogue.cuh"
#include "gemm_tiles.cuh"
#include "hopper.cuh"
#include "skinny_stream.cuh"

using namespace repro;

// ---------------------------------------------------------------------------
// prefill tiles (bf16, M > 8, operands TMA can address): wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64;
constexpr int WG_STAGES = 4;
constexpr int WG_CONSUMERS = 2;                      // warpgroups of 64 output rows
constexpr int WG_THREADS = WG_CONSUMERS * 128 + 32;  // + the producer warp
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;        // [128 rows][64 k], 16 KB
constexpr int WG_B_HALF = WG_BK * 64 * 2;            // [64 k][64 n], 8 KB; two per stage
constexpr int WG_STAGE_BYTES = WG_A_BYTES + 2 * WG_B_HALF;
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024;  // + slack to align to 1024

// Block (blockIdx.x, blockIdx.y) computes output tile (m, n) over K steps
// [blockIdx.z * ksteps, +ksteps): into C, or with `ws` into its split's
// f32 slice ws[blockIdx.z][M][N]. M tiles run fastest, so the blocks that
// share a column tile of B (the weight) are resident together and read it
// from device memory once.
template <typename OutT, typename EpiT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    matmul_bf16_wgmma(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, OutT* __restrict__ C,
                      float* __restrict__ ws, int M, int N, int K, long long ldc, int ksteps,
                      const __grid_constant__ EpiT epi) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);

  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BN;
  const int kt0 = blockIdx.z * ksteps;
  const int nk = min((K + WG_BK - 1) / WG_BK, kt0 + ksteps) - kt0;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);                      // the producer's expect-tx
      hopper::mbar_init(&empty[s], WG_CONSUMERS * 4);      // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == WG_CONSUMERS) {  // the producer warp: one thread keeps the ring full
    if (tid == WG_CONSUMERS * 128) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % WG_STAGES;
        hopper::mbar_wait(&empty[s], ((i / WG_STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * WG_STAGE_BYTES;
        uint8_t* b = a + WG_A_BYTES;
        const int k0 = (kt0 + i) * WG_BK;
        hopper::mbar_expect_tx(&full[s], WG_STAGE_BYTES);
        hopper::tma_load_2d(a, &map_a, &full[s], k0, m0);
        hopper::tma_load_2d(b, &map_b, &full[s], n0, k0);
        hopper::tma_load_2d(b + WG_B_HALF, &map_b, &full[s], n0 + 64, k0);
      }
    }
    return;
  }

  // consumer warpgroup `wg`: output rows m0 + 64 * wg .. + 63
  const int t = tid & 127, lane = tid & 31;
  float acc[WG_BN / 2];
#pragma unroll
  for (int i = 0; i < WG_BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % WG_STAGES;
    hopper::mbar_wait(&full[s], (i / WG_STAGES) & 1);
    const uint8_t* a = smem + s * WG_STAGE_BYTES + wg * (64 * WG_BK * 2);
    const uint8_t* b = smem + s * WG_STAGE_BYTES + WG_A_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      hopper::wgmma_ss_n128<1>(acc, hopper::desc_kmajor(a + kk * 32),
                               hopper::desc_mnmajor(b + kk * 16 * 128, WG_B_HALF), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // step i - 1's products are done reading their stage
    hopper::fence_regs(acc);
    if (i > 0 && lane == 0) hopper::mbar_arrive(&empty[(i - 1) % WG_STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int row0 = m0 + wg * 64;
  if constexpr (!has_epi<EpiT>) {
#pragma unroll
    for (int i = 0; i < WG_BN / 2; i += 2) {
      const int r = row0 + hopper::acc_row(i, t), c = n0 + hopper::acc_col(i, t);
      if (r < M && c < N) {  // N % 8 == 0: column c + 1 is inside too
        if (ws)
          *reinterpret_cast<float2*>(ws + ((long long)blockIdx.z * M + r) * N + c) =
              make_float2(acc[i], acc[i + 1]);
        else
          hopper::store_pair(C + (long long)r * ldc + c, acc[i], acc[i + 1]);
      }
    }
  } else {
    const EpiFast f = epi.fast();
    if (f.kind != EPI_CHAIN) {
      // a one-step chain, straight from the registers: every extra this
      // thread reads is loaded first, so the loads are in flight together
      float xa[WG_BN / 2];
#pragma unroll
      for (int i = 0; i < WG_BN / 2; i += 2) {
        const int r = row0 + hopper::acc_row(i, t), c = n0 + hopper::acc_col(i, t);
        xa[i] = xa[i + 1] = 0.f;
        if (f.nx && r < M && c < N) {
          xa[i] = f.load(r, c);
          xa[i + 1] = f.load(r, c + 1);
        }
      }
      with_fast_op(f.kind, [&](auto op) {
#pragma unroll
        for (int i = 0; i < WG_BN / 2; i += 2) {
          const int r = row0 + hopper::acc_row(i, t), c = n0 + hopper::acc_col(i, t);
          if (r < M && c < N)
            hopper::store_pair(C + (long long)r * ldc + c, op(acc[i], xa[i]),
                               op(acc[i + 1], xa[i + 1]));
        }
      });
    } else {
      // any other chain: both warpgroups are past their last wgmma, so the
      // ring is free; the tile goes there in f32 and one loop takes it
      // through one copy of the general chain
      constexpr int LD = WG_BN + 4;  // floats per staged row; the pad spreads the banks
      float* tile = reinterpret_cast<float*>(smem);
      asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS * 128) : "memory");
#pragma unroll
      for (int i = 0; i < WG_BN / 2; i += 2)
        *reinterpret_cast<float2*>(tile + (wg * 64 + hopper::acc_row(i, t)) * LD +
                                   hopper::acc_col(i, t)) = make_float2(acc[i], acc[i + 1]);
      asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS * 128) : "memory");
      for (int e = tid; e < WG_BM * WG_BN; e += WG_CONSUMERS * 128) {
        const int r = m0 + e / WG_BN, c = n0 + e % WG_BN;
        if (r < M && c < N)
          C[(long long)r * ldc + c] =
              from_f32<OutT>(epi_at(epi, f, tile[(e / WG_BN) * LD + e % WG_BN], r, c));
      }
    }
  }
}

// the wgmma path's K splits, summed in split order: deterministic, no
// atomics; a fused epilogue runs here, on the sum, once
template <typename OutT, typename EpiT>
__global__ void splitk_reduce(const float* __restrict__ ws, OutT* __restrict__ C, int M, int N,
                              int splits, long long ldc, const __grid_constant__ EpiT epi) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)M * N) return;
  const int r = e / N, c = e % N;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += ws[((long long)i * M + r) * N + c];
  C[(long long)r * ldc + c] = from_f32<OutT>(epi_at(epi, epi.fast(), s, r, c));
}

// ---------------------------------------------------------------------------
// ragged tiles (M > 8): bf16 on WMMA, f32 on the CUDA cores
// ---------------------------------------------------------------------------

// The wrapper sends here only bf16 operands that TMA cannot address, so
// the rows are not all 16-byte aligned: masked element loads.
template <typename OutT, typename EpiT>
__global__ void __launch_bounds__(256)
    matmul_bf16_tiled(const bf16* __restrict__ A, const bf16* __restrict__ B, OutT* __restrict__ C,
                      int M, int N, int K, long long lda, long long ldb, long long ldc,
                      const __grid_constant__ EpiT epi) {
  bf16_tile(A, B, C, M, N, K, lda, ldb, ldc, blockIdx.y * TBM, blockIdx.x * TBN, epi);
}

template <typename OutT, typename EpiT>
__global__ void __launch_bounds__(256)
    matmul_f32_tiled(const float* __restrict__ A, const float* __restrict__ B, OutT* __restrict__ C,
                     int M, int N, int K, long long lda, long long ldb, long long ldc,
                     const __grid_constant__ EpiT epi) {
  f32_tile(A, B, C, M, N, K, lda, ldb, ldc, blockIdx.y * FBM, blockIdx.x * FBN, epi);
}

// ---------------------------------------------------------------------------
// skinny products (M <= 8): one launch streaming the weight, split K
// ---------------------------------------------------------------------------

// The block body (skinny_stream.cuh) is shared with B5's decode route.
template <typename T, int MR, typename OutT, typename EpiT>
__global__ void __launch_bounds__(SK_THREADS)
    matmul_skinny_stream(const T* __restrict__ A, const __grid_constant__ CUtensorMap map_b,
                         OutT* __restrict__ C, int M, int N, int K, long long lda, long long ldc,
                         int kchunk, int stages, const __grid_constant__ EpiT epi) {
  skinny_stream<T, MR, false, OutT, EpiT>(A, &map_b, C, M, N, K, lda, ldc, kchunk, stages, 0, epi);
}

// The tensor map of a weight B [K, N] (row stride ldb) in boxes of SK_BK
// rows: bf16 64 columns wide with the 128-byte swizzle, f32 128 wide
// unswizzled. Encoded at its first product and kept, keyed by everything
// it encodes, so a key always names a valid map and a decode step encodes
// none.
static int weight_map(CUtensorMap* map, const void* b, int N, int K, long long ldb, int dtype) {
  using Key = std::tuple<const void*, int, int, long long, int>;
  static std::map<Key, CUtensorMap> maps;
  static std::mutex lock;
  const Key key{b, N, K, ldb, dtype};
  std::lock_guard<std::mutex> guard(lock);
  auto it = maps.find(key);
  if (it == maps.end()) {
    const bool bf = dtype == BF16;
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)(ldb * (bf ? 2 : 4))};
    const cuuint32_t box[2] = {bf ? 64u : 128u, SK_BK};
    CUtensorMap m;
    if (int err = encode_map(&m, bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                             2, b, dims, strides, box,
                             bf ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE))
      return err;
    it = maps.emplace(key, m).first;
  }
  *map = it->second;
  return 0;
}

template <typename T, int MR, typename OutT, typename EpiT>
static int launch_skinny(const void* a, const CUtensorMap& map_b, void* c, int M, int N, int K,
                         long long lda, long long ldc, int splits, int kchunk, int stages,
                         cudaStream_t s, const EpiT& epi) {
  auto kern = matmul_skinny_stream<T, MR, OutT, EpiT>;
  static bool ready = false;  // the attribute is set once per process
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SK_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  constexpr int CG = SK_SEG / sizeof(T);
  const dim3 grid((N + CG - 1) / CG, splits);
  const int smem = stages * SK_STAGE + skinny_a_bytes<T, MR>(kchunk) + 1024;  // + align slack
  return launch_cluster_y(kern, grid, SK_THREADS, smem, splits, s, static_cast<const T*>(a),
                          map_b, static_cast<OutT*>(c), M, N, K, lda, ldc, kchunk, stages, epi);
}

template <typename T, int MR, typename EpiT>
static int launch_skinny_out(int out_dtype, const void* a, const CUtensorMap& map_b, void* c,
                             int M, int N, int K, long long lda, long long ldc, int splits,
                             int kchunk, int stages, cudaStream_t s, const EpiT& epi) {
  return out_dtype == BF16
             ? launch_skinny<T, MR, bf16>(a, map_b, c, M, N, K, lda, ldc, splits, kchunk, stages, s,
                                          epi)
             : launch_skinny<T, MR, float>(a, map_b, c, M, N, K, lda, ldc, splits, kchunk, stages,
                                           s, epi);
}

// The split kernel stores raw f32 partials (its epilogue is NoEpi); the
// chain runs once, in splitk_reduce, on their sum.
template <typename OutT, typename EpiT>
static int launch_wgmma(const CUtensorMap& map_a, const CUtensorMap& map_b, OutT* C, void* ws,
                        int M, int N, int K, long long ldc, int splits, int kchunk,
                        cudaStream_t s, const EpiT& epi) {
  float* w = static_cast<float*>(ws);
  const dim3 grid((M + WG_BM - 1) / WG_BM, (N + WG_BN - 1) / WG_BN, splits);
  cudaError_t err;
  if (splits == 1) {
    err = cudaFuncSetAttribute(matmul_bf16_wgmma<OutT, EpiT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    matmul_bf16_wgmma<OutT, EpiT><<<grid, WG_THREADS, WG_SMEM, s>>>(map_a, map_b, C, nullptr, M,
                                                                    N, K, ldc, kchunk / WG_BK, epi);
    return static_cast<int>(cudaGetLastError());
  }
  err = cudaFuncSetAttribute(matmul_bf16_wgmma<OutT, NoEpi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_bf16_wgmma<OutT, NoEpi><<<grid, WG_THREADS, WG_SMEM, s>>>(map_a, map_b, C, w, M, N, K,
                                                                   ldc, kchunk / WG_BK, NoEpi{});
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)M * N;
  splitk_reduce<OutT, EpiT><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(w, C, M, N, splits,
                                                                            ldc, epi);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// C entries
// ---------------------------------------------------------------------------

// Every entry takes `epi`, a fused epilogue's chain descriptor or null
// (epilogue.cuh); the extras it names are [M, N] with unit column stride.

// `ws` holds splits * M * N floats when splits > 1 (ignored otherwise);
// `kchunk`, the K depth of one split, is a multiple of WG_BK.
extern "C" int matmul_wgmma(const void* a, const void* b, void* c, void* ws, int M, int N, int K,
                            long long lda, long long ldb, long long ldc, int splits, int kchunk,
                            int out_dtype, const Epi* epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[2] = {(cuuint64_t)K, (cuuint64_t)M}, strides_a[1] = {(cuuint64_t)lda * 2};
  const cuuint64_t dims_b[2] = {(cuuint64_t)N, (cuuint64_t)K}, strides_b[1] = {(cuuint64_t)ldb * 2};
  const cuuint32_t box_a[2] = {WG_BK, WG_BM}, box_b[2] = {64, WG_BK};
  if (int err = encode_bf16_map(&map_a, 2, a, dims_a, strides_a, box_a)) return err;
  if (int err = encode_bf16_map(&map_b, 2, b, dims_b, strides_b, box_b)) return err;
  return with_epilogue(epi, [&](const auto& e) {
    return out_dtype == BF16
               ? launch_wgmma(map_a, map_b, static_cast<bf16*>(c), ws, M, N, K, ldc, splits,
                              kchunk, s, e)
               : launch_wgmma(map_a, map_b, static_cast<float*>(c), ws, M, N, K, ldc, splits,
                              kchunk, s, e);
  });
}

template <typename OutT, typename EpiT>
static int launch_tiled(const void* a, const void* b, void* c, int M, int N, int K,
                        long long lda, long long ldb, long long ldc, int dtype, cudaStream_t s,
                        const EpiT& epi) {
  if (dtype == BF16) {
    const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
    matmul_bf16_tiled<OutT, EpiT><<<grid, 256, 0, s>>>(static_cast<const bf16*>(a),
                                                       static_cast<const bf16*>(b),
                                                       static_cast<OutT*>(c), M, N, K, lda, ldb,
                                                       ldc, epi);
  } else {
    const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    matmul_f32_tiled<OutT, EpiT><<<grid, 256, 0, s>>>(static_cast<const float*>(a),
                                                      static_cast<const float*>(b),
                                                      static_cast<OutT*>(c), M, N, K, lda, ldb,
                                                      ldc, epi);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int matmul_tiled(const void* a, const void* b, void* c, int M, int N, int K,
                            long long lda, long long ldb, long long ldc, int dtype, int out_dtype,
                            const Epi* epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_epilogue(epi, [&](const auto& e) {
    return out_dtype == BF16 ? launch_tiled<bf16>(a, b, c, M, N, K, lda, ldb, ldc, dtype, s, e)
                             : launch_tiled<float>(a, b, c, M, N, K, lda, ldb, ldc, dtype, s, e);
  });
}

// B's rows 16-byte aligned (base and ldb) with N % (16 / size) == 0;
// `splits` <= SK_MAX_SPLITS K splits of `kchunk` rows, a multiple of SK_BK
// with kchunk * (M <= 4 ? 4 : 8) * size <= SK_A_BYTES.
extern "C" int matmul_skinny(const void* a, const void* b, void* c, int M, int N, int K,
                             long long lda, long long ldb, long long ldc, int dtype, int out_dtype,
                             int splits, int kchunk, int stages, const Epi* epi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = dtype == BF16;
  const int a_bytes = bf ? skinny_a_bytes<bf16, 8>(kchunk)
                         : M <= 4 ? skinny_a_bytes<float, 4>(kchunk) : skinny_a_bytes<float, 8>(kchunk);
  if (M > 8 || splits < 1 || splits > SK_MAX_SPLITS || kchunk % SK_BK || a_bytes > SK_A_BYTES ||
      stages < 2 || stages > SK_MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_b;
  if (int err = weight_map(&map_b, b, N, K, ldb, dtype)) return err;
  return with_epilogue(epi, [&](const auto& e) {
    if (bf)
      return launch_skinny_out<bf16, 8>(out_dtype, a, map_b, c, M, N, K, lda, ldc, splits, kchunk,
                                        stages, s, e);
    return M <= 4 ? launch_skinny_out<float, 4>(out_dtype, a, map_b, c, M, N, K, lda, ldc, splits,
                                                kchunk, stages, s, e)
                  : launch_skinny_out<float, 8>(out_dtype, a, map_b, c, M, N, K, lda, ldc, splits,
                                                kchunk, stages, s, e);
  });
}

REPRO_EXPORT_ERROR_STRING_TMA
