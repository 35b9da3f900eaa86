// The weight stream of products with at most 8 rows of A, shared by B1's
// skinny path (matmul.cu, `matmul_skinny_stream`: one product) and B5's
// decode route (moe_gemm.cu, `moe_gemm_stream`: one product per expert).
// Each is bound by the bytes of its weight B: every byte is read once for
// 2 * M flops. matmul.cu's header comment says why the design is what it
// is; this file holds the block body both kernels run.
//
// Block (blockIdx.x, blockIdx.y) computes columns [n0, n0 + SK_SEG / size)
// of C over K rows [kbeg, kbeg + kchunk); the gridDim.y <= SK_MAX_SPLITS
// splits of a column group form one cluster. One thread of the producer
// warp keeps a ring of `stages` stages of SK_BK rows x 512 bytes of B
// full by TMA, completing on the stage's mbarrier (bf16: four 64-column
// boxes with the 128-byte swizzle; f32: one unswizzled box); K rows past
// the weight's end are zero-filled.
// * bf16: the product runs transposed on the tensor cores, Ct = Bt At,
//   as mma.sync m16n8k16 with A's (at most) 8 rows the n8 operand: each
//   consumer warp owns 64 columns and takes Bt's 16 x 16 fragments by
//   ldmatrix.trans from its box and At's from A's rows, which sit
//   row-major in shared memory (bf16, padded to 8 rows with zeros).
// * f32: the consumer warps take a stage's rows round-robin, a lane one
//   16-byte column vector of each against A's rows (k-major, f32), with
//   CUDA-core FMAs, then sum their partials through shared memory.
// With one split the block stores C; with more, each split leaves its f32
// partial [MR][columns] in its shared memory and every block of the
// cluster sums a slice of the columns over the splits in split order,
// read through distributed shared memory, and stores it.
//
// EXPERTS (bf16 only): B is expert `expert`'s [K, N] slice of a 3-D
// tensor map over [E, K, N], so a box past K is zero-filled and never
// reads the next expert's rows; and a block whose rows of A in its K range
// are all zero (an expert that received no token: the dispatch leaves its
// capacity rows zero) streams nothing. The block loads A's rows first,
// decides block-wide (`__syncthreads_or`) whether any element is
// non-zero, and only then does the producer issue its first TMA. A
// skipping block still writes its (zero) partial and joins both cluster
// barriers, so no block leaves while another reads its shared memory.
// Zero rows times finite weights give +0, so the bits equal those of a
// block that read the weight.
//
// A consumer warp reads a stage with ordinary (generic-proxy) loads and
// the producer refills it by TMA (the async proxy), so each consumer
// thread fences the proxies (`fence.proxy.async`) before its warp
// releases the stage. Without it the refill could overwrite a stage whose
// last ldmatrix was still in flight: with several blocks per SM (8 K
// splits of a wide weight, 2-4 stages) a stage's last columns read the
// next tile's rows in up to every run.
#pragma once

#include "epilogue.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int SK_CONSUMERS = 4;                         // warps that compute
constexpr int SK_THREADS = (SK_CONSUMERS + 1) * 32;     // + the producer warp
constexpr int SK_BK = 32;                               // K rows per stage
constexpr int SK_MAX_STAGES = 8;                        // stages in flight, at most
constexpr int SK_SEG = 512;                             // bytes of each B row a block streams
constexpr int SK_STAGE = SK_BK * SK_SEG;                // 16 KB
constexpr int SK_A_BYTES = 49152;                       // A's rows of one split
constexpr int SK_MAX_SPLITS = 8;                        // K splits: one cluster, portable size
constexpr int SK_SMEM = SK_MAX_STAGES * SK_STAGE + SK_A_BYTES + 1024;  // the most a block takes

__device__ __forceinline__ void consumers_sync() {  // the consumer warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(SK_CONSUMERS * 32) : "memory");
}

// bytes of shared memory A's rows of one split of `kchunk` rows take
template <typename T, int MR>
constexpr int skinny_a_bytes(int kchunk) {
  return sizeof(T) == 2 ? 8 * (kchunk + 8) * 2 : kchunk * MR * 4;
}

// The consumer warps copy A's rows of this split (bf16) into shared
// memory, row-major [8][apitch], zeros past M and past klen (a last tile
// may reach past K, where B's rows are zeros too); the 8-element pad keeps
// ldmatrix's eight rows in distinct banks. Returns the OR of the bits of
// this thread's elements, signs masked: non-zero iff one of them is.
__device__ __forceinline__ uint32_t skinny_load_a(const bf16* __restrict__ A, bf16* sA, int M,
                                                  long long lda, int kbeg, int klen, int apitch,
                                                  int tid) {
  constexpr int NT = SK_CONSUMERS * 32;
  const int rv = apitch / 8;  // 16-byte vectors per row
  const bool vec = (reinterpret_cast<uintptr_t>(A) & 15) == 0 && lda % 8 == 0;
  const int nv = vec ? klen / 8 : 0;
  uint32_t bits = 0;
  for (int i0 = tid; i0 < 8 * rv; i0 += 4 * NT) {  // four loads in flight per thread
    uint4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT, r = i / rv, v = i % rv;
      x[u] = make_uint4(0, 0, 0, 0);
      if (r < M && v < nv) x[u] = __ldg(reinterpret_cast<const uint4*>(A + r * lda + kbeg) + v);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT;
      bits |= x[u].x | x[u].y | x[u].z | x[u].w;
      if (i < 8 * rv) *reinterpret_cast<uint4*>(sA + (i / rv) * apitch + (i % rv) * 8) = x[u];
    }
  }
  consumers_sync();
  for (int c = nv * 8 + tid; c < klen; c += NT)  // the rest, element by element
    for (int r = 0; r < M; ++r) {
      const bf16 v = A[r * lda + kbeg + c];
      bits |= *reinterpret_cast<const uint16_t*>(&v);
      sA[r * apitch + c] = v;
    }
  return bits & 0x7FFF7FFFu;
}

// Four consecutive outputs of row r from column c on, each through the
// epilogue (`f = epi.fast()`, epilogue.cuh).
template <typename OutT, typename EpiT>
__device__ __forceinline__ void store4(OutT* out, const float4& v, const EpiT& epi,
                                       const EpiFast& f, int r, int c) {
  out[0] = from_f32<OutT>(epi_at(epi, f, v.x, r, c));
  out[1] = from_f32<OutT>(epi_at(epi, f, v.y, r, c + 1));
  out[2] = from_f32<OutT>(epi_at(epi, f, v.z, r, c + 2));
  out[3] = from_f32<OutT>(epi_at(epi, f, v.w, r, c + 3));
}

// C is written as OutT (the operands' type unless the caller asks for
// another): the f32 sums are cast once, on the store. B1 may hand a fused
// epilogue (`epi`, epilogue.cuh); it runs on each f32 sum just before that
// cast, in the block that stores it: after the cluster's sum of the K
// splits, never on a split's partial. B5 hands none.
template <typename T, int MR, bool EXPERTS, typename OutT, typename EpiT = NoEpi>
__device__ __forceinline__ void skinny_stream(const T* __restrict__ A, const CUtensorMap* map_b,
                                              OutT* __restrict__ C, int M, int N, int K,
                                              long long lda, long long ldc, int kchunk, int stages,
                                              int expert, const EpiT& epi = EpiT()) {
  constexpr bool TC = sizeof(T) == 2;     // bf16: tensor cores
  static_assert(TC || !EXPERTS, "the expert stream is bf16 only");
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CG = SK_SEG / sizeof(T);  // columns per block
  constexpr int NT = SK_CONSUMERS * 32;
  extern __shared__ uint8_t sk_raw[];
  __shared__ __align__(8) uint64_t full[SK_MAX_STAGES], empty[SK_MAX_STAGES];
  // 1024-aligned: the 128-byte swizzle's atoms
  uint8_t* smem = sk_raw + ((1024 - (hopper::smem_addr(sk_raw) & 1023)) & 1023);
  T* sA = reinterpret_cast<T*>(smem + stages * SK_STAGE);
  float* part = reinterpret_cast<float*>(smem);  // [MR][CG], once the ring is done
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * CG, S = gridDim.y;
  // the partials go through shared memory and the cluster loop below when
  // there are several splits to sum or a chain to run (one copy of it)
  const bool staged = S > 1 || has_epi<EpiT>;
  const int kbeg = blockIdx.y * kchunk, klen = min(K, kbeg + kchunk) - kbeg;
  int ntiles = (klen + SK_BK - 1) / SK_BK;
  const int apitch = ntiles * SK_BK + 8;  // bf16 A's row pitch in shared memory

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);             // the producer's expect-tx
      hopper::mbar_init(&empty[s], SK_CONSUMERS);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  if constexpr (EXPERTS) {
    // A's rows first; the producer waits for the block's verdict
    uint32_t bits = 0;
    if (warp < SK_CONSUMERS)
      bits = skinny_load_a(reinterpret_cast<const bf16*>(A), reinterpret_cast<bf16*>(sA), M,
                           lda, kbeg, klen, apitch, tid);
    if (!__syncthreads_or(bits != 0)) ntiles = 0;  // all zero: stream nothing
  } else {
    __syncthreads();
  }

  if (warp == SK_CONSUMERS) {  // the producer warp: one thread
    if (lane == 0) {
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % stages;
        hopper::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], SK_STAGE);  // a box past K or N is zero-filled
        uint8_t* dst = smem + s * SK_STAGE;
        if constexpr (EXPERTS) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hopper::tma_load_3d(dst + j * (SK_STAGE / 4), map_b, &full[s], n0 + 64 * j,
                                kbeg + i * SK_BK, expert);
        } else if constexpr (TC) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hopper::tma_load_2d(dst + j * (SK_STAGE / 4), map_b, &full[s], n0 + 64 * j,
                                kbeg + i * SK_BK);
        } else {
          hopper::tma_load_2d(dst, map_b, &full[s], n0, kbeg + i * SK_BK);
        }
      }
    }
    __syncwarp();
  } else if constexpr (TC) {
    if constexpr (!EXPERTS) {
      skinny_load_a(reinterpret_cast<const bf16*>(A), reinterpret_cast<bf16*>(sA), M, lda, kbeg,
                    klen, apitch, tid);
      consumers_sync();
    }

    float d[4][4];  // Ct: 4 n16 tiles of this warp's 64 columns x 8 rows of A
#pragma unroll
    for (int t = 0; t < 4; ++t) d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0.f;
    const uint8_t* a_row = reinterpret_cast<const uint8_t*>(sA + (lane & 7) * apitch) +
                           (lane >> 3) * 16;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % stages;
      hopper::mbar_wait(&full[s], (i / stages) & 1);
      __syncwarp();
      const uint8_t* box = smem + s * SK_STAGE + warp * (SK_STAGE / 4);  // [32 k][64 n]
      uint32_t at[4];  // At's k16 fragments (b0, b1) of the stage's two k steps
      hopper::ldmatrix_x4(at, a_row + i * SK_BK * 2);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int k = kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int chunk = 2 * t + ((lane >> 3) & 1);
          uint32_t bt[4];
          hopper::ldmatrix_x4_trans(bt, box + k * 128 + ((chunk ^ (k & 7)) << 4));
          hopper::mma_16816(d[t], bt, at[2 * kk], at[2 * kk + 1]);
        }
      }
      hopper::fence_proxy_async();  // these reads before the stage's refill by TMA
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this stage may be refilled
    }

    // d[t][e]: column warp * 64 + 16 t + lane / 4 (+ 8 for e >= 2), row
    // 2 (lane % 4) + e % 2
    consumers_sync();  // every warp is done with the ring
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = warp * 64 + 16 * t + (lane >> 2) + 8 * (e >> 1), r = 2 * (lane & 3) + (e & 1);
        if (staged)
          part[r * CG + c] = d[t][e];
        else if (r < M && n0 + c < N)
          C[(long long)r * ldc + n0 + c] = from_f32<OutT>(d[t][e]);
      }
  } else {
    // A's rows of this split, k-major [kchunk][MR] in f32
    for (int e = tid; e < MR * klen; e += NT) {
      const int r = e / klen, c = e % klen;
      sA[c * MR + r] = r < M ? A[(long long)r * lda + kbeg + c] : 0.f;
    }
    consumers_sync();

    float acc[MR][VEC];
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % stages, rows = min(SK_BK, klen - i * SK_BK);
      hopper::mbar_wait(&full[s], (i / stages) & 1);
      const uint8_t* stage = smem + s * SK_STAGE + lane * 16;
#pragma unroll
      for (int jj = 0; jj < SK_BK / SK_CONSUMERS; ++jj) {
        const int j = jj * SK_CONSUMERS + warp;
        if (j < rows) {
          float bv[VEC];
          unpack16(*reinterpret_cast<const uint4*>(stage + j * SK_SEG), bv);
          const T* ap = sA + (i * SK_BK + j) * MR;
#pragma unroll
          for (int r = 0; r < MR; ++r)
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(ap[r], bv[v], acc[r][v]);
        }
      }
      hopper::fence_proxy_async();  // these reads before the stage's refill by TMA
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this stage may be refilled
    }

    // every stage has landed and been read: the ring now sums the warps
    consumers_sync();
    float* red = reinterpret_cast<float*>(smem);  // [SK_CONSUMERS][MR][CG]
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int v = 0; v < VEC; v += 4)
        *reinterpret_cast<float4*>(red + (warp * MR + r) * CG + lane * VEC + v) =
            make_float4(acc[r][v], acc[r][v + 1], acc[r][v + 2], acc[r][v + 3]);
    consumers_sync();
    for (int e = 4 * tid; e < M * CG; e += 4 * NT) {  // part[r][c] = the warps' sum
      const int r = e / CG, c = e % CG;
      float4 sum = *reinterpret_cast<const float4*>(red + r * CG + c);
#pragma unroll
      for (int w = 1; w < SK_CONSUMERS; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(red + (w * MR + r) * CG + c);
        sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
      }
      if (!staged) {
        if (n0 + c < N) {  // N % 4 == 0: the vector is wholly in or out
          store4(C + (long long)r * ldc + n0 + c, sum, NoEpi(), EpiFast(), r, n0 + c);
        }
      } else {
        *reinterpret_cast<float4*>(part + r * CG + c) = sum;
      }
    }
  }
  if (!staged) return;

  // the splits of this column group are the blocks of this cluster, and
  // block rank == blockIdx.y: each sums every S-th 4-column vector over
  // the splits in split order (equal bits on every run) and stores it
  hopper::cluster_sync();
  const int rank = blockIdx.y;
  const EpiFast f = epi.fast();
  for (int q = rank + S * tid; q < M * CG / 4; q += S * SK_THREADS) {
    const int r = 4 * q / CG, c = 4 * q % CG;
    if (n0 + c >= N) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < S; ++sp) {
      const float4 x = hopper::ld_cluster4(part + r * CG + c, sp);
      sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
    }
    store4(C + (long long)r * ldc + n0 + c, sum, epi, f, r, n0 + c);
  }
  hopper::cluster_sync();  // no block leaves while another reads its shared memory
}

}  // namespace repro
