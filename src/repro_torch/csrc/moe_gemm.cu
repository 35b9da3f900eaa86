// B5 — per-expert batched GEMM out[e] = x[e] @ w[e] for every expert e:
// x [E, C, d] (the capacity buffer of the MoE dispatch), w [E, d, f],
// out [E, C, f], f32 accumulation and one cast to the output dtype (the
// operands' or, where the caller asks, the other of f32 / bf16: the
// accumulator is written as that type, never rounded through the
// operands' type first). All three are contiguous; expert e's operands start at e times the
// per-expert stride.
//
// Replaces the TPU kernel `moe_gemm/expert_gemm` (src/repro/kernels/
// moe_gemm.py: `_expert_gemm` at :70, launch at :94, body `_mac` at :49).
// On the TPU the grid is (E, C/bc, f/bf, d/bd) with the d axis a
// sequential "arbitrary" axis carrying an f32 VMEM accumulator; here d is
// a loop inside each block with the accumulator in registers.
//
// Bound on the H100: the weights' bytes. On the serving path the
// capacity is small (qwen3-moe-235b-a22b: 40 slots for a 4 x 128-token
// prefill, 8 for a 4-slot decode tick) and the weights are large (3 x
// 1.61 GB per layer in bf16): each weight byte is read once for 2 x C
// flops. The wrapper (kernels/moe_gemm.py, `expert_route`) picks one of
// three routes by shape:
// * C <= 8 (every decode tick): `moe_expert_stream`, B1's skinny weight
//   stream (skinny_stream.cuh) with the expert as the grid's z: the
//   weight by TMA from a 3-D map over [E, d, f] (encoded once per weight
//   and kept) through a 2-8-stage mbarrier ring into mma.sync (Ct = Bt At,
//   x's <= 8 rows the n8 operand), up to 8 K splits summed in a cluster
//   through distributed shared memory. A decode tick routes 4 tokens x 8
//   choices, so at most 32 of 128 experts hold a token; the others'
//   capacity rows are the dispatch's zeros. Each block loads its rows of x
//   first and streams nothing when they are all zero, so the tick reads
//   the live experts' weights only (~0.4 of 1.6 GB). The host cannot know
//   which experts are live without a sync, so the grid holds every
//   (column group, split, expert) block and the card's block scheduler
//   hands the SMs that dead blocks free to live ones; `stream_plan` in
//   the wrapper sizes the splits for the live work.
// * C > 8 (prefill, C = 40 at the served shape): `moe_expert_wgmma`. Block
//   (n tile, C tile, expert) computes a 64 x 128 output tile: one producer
//   warp keeps TMA loads of x's box [64 rows x 64 d] (a 3-D map over
//   [E, C, d], so rows C..63 are zero-filled, never the next expert's)
//   and w's two [64 d x 64 f] boxes (128-byte swizzle) in a 4-stage
//   mbarrier ring, 24 KB a stage, two blocks per SM; one consumer
//   warpgroup issues wgmma m64n128k16 (B MN-major by the transpose bit)
//   and stores rows < C. With C <= 64 every weight byte is read once.
// * f32 (tests and comparisons; off the serving path) and bf16 shapes
//   TMA cannot address (d or f not a multiple of 8): B1's tiles of
//   gemm_tiles.cuh, grid (f/TBN, C/TBM, E), WMMA bf16 / CUDA-core f32.
//
// One exception to out[e] = x[e] @ w[e], on the C <= 8 route: a skipped
// block returns zeros where its weights hold Inf or NaN (einsum gives
// NaN). The MoE combine never reads the rows of an expert with no token.
#include <map>
#include <mutex>
#include <tuple>

#include "gemm_tiles.cuh"
#include "hopper.cuh"
#include "skinny_stream.cuh"

using namespace repro;

// ---------------------------------------------------------------------------
// C <= 8: the expert weight stream, empty experts skipped
// ---------------------------------------------------------------------------

template <typename OutT>
__global__ void __launch_bounds__(SK_THREADS)
    moe_expert_stream(const bf16* __restrict__ x, const __grid_constant__ CUtensorMap map_w,
                      OutT* __restrict__ out, int C, int D, int F, int kchunk, int stages) {
  const long long e = blockIdx.z;
  skinny_stream<bf16, 8, true, OutT>(x + e * C * D, &map_w, out + e * C * F, C, F, D, D, F,
                                     kchunk, stages, (int)e);
}

// ---------------------------------------------------------------------------
// C > 8: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int MW_BM = 64, MW_BN = 128, MW_BK = 64;
constexpr int MW_STAGES = 4;
constexpr int MW_THREADS = 128 + 32;              // one consumer warpgroup + the producer warp
constexpr int MW_A_BYTES = MW_BM * MW_BK * 2;     // [64 rows][64 d], 8 KB
constexpr int MW_B_HALF = MW_BK * 64 * 2;         // [64 d][64 f], 8 KB; two per stage
constexpr int MW_STAGE_BYTES = MW_A_BYTES + 2 * MW_B_HALF;
constexpr int MW_SMEM = MW_STAGES * MW_STAGE_BYTES + 1024;  // + slack to align to 1024

template <typename OutT>
__global__ void __launch_bounds__(MW_THREADS, 2)
    moe_expert_wgmma(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, OutT* __restrict__ out, int C,
                     int D, int F) {
  extern __shared__ uint8_t mw_raw[];
  __shared__ __align__(8) uint64_t full[MW_STAGES], empty[MW_STAGES];
  uint8_t* smem = mw_raw + ((1024 - (hopper::smem_addr(mw_raw) & 1023)) & 1023);

  const int n0 = blockIdx.x * MW_BN, m0 = blockIdx.y * MW_BM, e = blockIdx.z;
  const int nk = (D + MW_BK - 1) / MW_BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < MW_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's expect-tx
      hopper::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: one thread keeps the ring full
    if (tid == 128) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % MW_STAGES;
        hopper::mbar_wait(&empty[s], ((i / MW_STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * MW_STAGE_BYTES;
        uint8_t* b = a + MW_A_BYTES;
        const int k0 = i * MW_BK;
        hopper::mbar_expect_tx(&full[s], MW_STAGE_BYTES);  // boxes past C, d or f zero-filled
        hopper::tma_load_3d(a, &map_x, &full[s], k0, m0, e);
        hopper::tma_load_3d(b, &map_w, &full[s], n0, k0, e);
        hopper::tma_load_3d(b + MW_B_HALF, &map_w, &full[s], n0 + 64, k0, e);
      }
    }
    return;
  }

  // the consumer warpgroup: output rows m0 .. m0 + 63 of expert e
  const int lane = tid & 31;
  float acc[MW_BN / 2];
#pragma unroll
  for (int i = 0; i < MW_BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % MW_STAGES;
    hopper::mbar_wait(&full[s], (i / MW_STAGES) & 1);
    const uint8_t* a = smem + s * MW_STAGE_BYTES;
    const uint8_t* b = a + MW_A_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MW_BK / 16; ++kk)
      hopper::wgmma_ss_n128<1>(acc, hopper::desc_kmajor(a + kk * 32),
                               hopper::desc_mnmajor(b + kk * 16 * 128, MW_B_HALF), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // step i - 1's products are done reading their stage
    hopper::fence_regs(acc);
    if (i > 0 && lane == 0) hopper::mbar_arrive(&empty[(i - 1) % MW_STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  OutT* o = out + (long long)e * C * F;
#pragma unroll
  for (int i = 0; i < MW_BN / 2; i += 2) {
    const int r = m0 + hopper::acc_row(i, tid), c = n0 + hopper::acc_col(i, tid);
    if (r < C && c < F)  // F % 8 == 0: column c + 1 is inside too
      hopper::store_pair(o + (long long)r * F + c, acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// f32, and bf16 shapes TMA cannot address: B1's tiles
// ---------------------------------------------------------------------------

template <typename OutT>
__global__ void __launch_bounds__(256)
    moe_gemm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w, OutT* __restrict__ out,
                  int C, int D, int F) {
  const long long e = blockIdx.z;
  bf16_tile(x + e * C * D, w + e * D * F, out + e * C * F, C, F, D, D, F, F,
                 blockIdx.y * TBM, blockIdx.x * TBN);
}

template <typename OutT>
__global__ void __launch_bounds__(256)
    moe_gemm_f32(const float* __restrict__ x, const float* __restrict__ w, OutT* __restrict__ out,
                 int C, int D, int F) {
  const long long e = blockIdx.z;
  f32_tile(x + e * C * D, w + e * D * F, out + e * C * F, C, F, D, D, F, F, blockIdx.y * FBM,
           blockIdx.x * FBN);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// The 3-D tensor map of the bf16 weights w [E, D, F] in 128-byte-swizzled
// boxes of 64 columns x `rows` rows of one expert. Encoded at a weight's
// first product and kept, keyed by everything it encodes, so a decode
// step encodes none.
static int weight_map(CUtensorMap* map, const void* w, int E, int D, int F, int rows) {
  using Key = std::tuple<const void*, int, int, int, int>;
  static std::map<Key, CUtensorMap> maps;
  static std::mutex lock;
  const Key key{w, E, D, F, rows};
  std::lock_guard<std::mutex> guard(lock);
  auto it = maps.find(key);
  if (it == maps.end()) {
    const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
    const cuuint64_t strides[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
    const cuuint32_t box[3] = {64u, (cuuint32_t)rows, 1u};
    CUtensorMap m;
    if (int err = encode_bf16_map(&m, 3, w, dims, strides, box)) return err;
    it = maps.emplace(key, m).first;
  }
  *map = it->second;
  return 0;
}

// bf16, D and F multiples of 8, x and w 16-byte aligned; C <= 8;
// `splits` <= SK_MAX_SPLITS K splits of `kchunk` rows, a multiple of
// SK_BK with 8 * (kchunk + 8) * 2 <= SK_A_BYTES; 2 <= stages <= 8.
template <typename OutT>
static int launch_stream(const void* x, const CUtensorMap& map_w, void* out, int E, int C, int D,
                         int F, int splits, int kchunk, int stages, cudaStream_t s) {
  static bool ready = false;  // the attribute is set once per process and type
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(moe_expert_stream<OutT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SK_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  constexpr int CG = SK_SEG / 2;
  const dim3 grid((F + CG - 1) / CG, splits, E);
  const int smem = stages * SK_STAGE + skinny_a_bytes<bf16, 8>(kchunk) + 1024;  // + align slack
  return launch_cluster_y(moe_expert_stream<OutT>, grid, SK_THREADS, smem, splits, s,
                          static_cast<const bf16*>(x), map_w, static_cast<OutT*>(out), C, D, F,
                          kchunk, stages);
}

template <typename OutT>
static int launch_expert_wgmma(const CUtensorMap& map_x, const CUtensorMap& map_w, void* out,
                               int E, int C, int D, int F, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(moe_expert_wgmma<OutT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MW_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid((F + MW_BN - 1) / MW_BN, (C + MW_BM - 1) / MW_BM, E);
  moe_expert_wgmma<OutT><<<grid, MW_THREADS, MW_SMEM, s>>>(map_x, map_w,
                                                           static_cast<OutT*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OutT>
static void launch_tiled(const void* x, const void* w, void* out, int E, int C, int D, int F,
                         cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((F + TBN - 1) / TBN, (C + TBM - 1) / TBM, E);
    moe_gemm_bf16<OutT><<<grid, 256, 0, s>>>(static_cast<const bf16*>(x),
                                             static_cast<const bf16*>(w),
                                             static_cast<OutT*>(out), C, D, F);
  } else {
    const dim3 grid((F + FBN - 1) / FBN, (C + FBM - 1) / FBM, E);
    moe_gemm_f32<OutT><<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                            static_cast<const float*>(w),
                                            static_cast<OutT*>(out), C, D, F);
  }
}

// ---------------------------------------------------------------------------
// C entries: `out_dtype` is the type `out` is written as (F32 or BF16)
// ---------------------------------------------------------------------------

extern "C" int moe_gemm_stream(const void* x, const void* w, void* out, int E, int C, int D,
                               int F, int splits, int kchunk, int stages, int out_dtype,
                               void* stream) {
  if (C > 8 || splits < 1 || splits > SK_MAX_SPLITS || kchunk % SK_BK ||
      skinny_a_bytes<bf16, 8>(kchunk) > SK_A_BYTES || stages < 2 || stages > SK_MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map_w;
  if (int err = weight_map(&map_w, w, E, D, F, SK_BK)) return err;
  return out_dtype == BF16
             ? launch_stream<bf16>(x, map_w, out, E, C, D, F, splits, kchunk, stages, s)
             : launch_stream<float>(x, map_w, out, E, C, D, F, splits, kchunk, stages, s);
}

extern "C" int moe_gemm_wgmma(const void* x, const void* w, void* out, int E, int C, int D,
                              int F, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map_x, map_w;
  const cuuint64_t dims_x[3] = {(cuuint64_t)D, (cuuint64_t)C, (cuuint64_t)E};
  const cuuint64_t strides_x[2] = {(cuuint64_t)D * 2, (cuuint64_t)C * D * 2};
  const cuuint32_t box_x[3] = {MW_BK, MW_BM, 1};
  if (int err = encode_bf16_map(&map_x, 3, x, dims_x, strides_x, box_x)) return err;
  if (int err = weight_map(&map_w, w, E, D, F, MW_BK)) return err;
  return out_dtype == BF16 ? launch_expert_wgmma<bf16>(map_x, map_w, out, E, C, D, F, s)
                           : launch_expert_wgmma<float>(map_x, map_w, out, E, C, D, F, s);
}

extern "C" int moe_gemm(const void* x, const void* w, void* out, int E, int C, int D, int F,
                        int dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16 && out_dtype == BF16)
    launch_tiled<bf16, bf16>(x, w, out, E, C, D, F, s);
  else if (dtype == BF16)
    launch_tiled<bf16, float>(x, w, out, E, C, D, F, s);
  else if (out_dtype == BF16)
    launch_tiled<float, bf16>(x, w, out, E, C, D, F, s);
  else
    launch_tiled<float, float>(x, w, out, E, C, D, F, s);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING_TMA
