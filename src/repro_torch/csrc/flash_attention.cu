// B3 — blocked online-softmax attention over a full sequence, and
// B4 — single-token (decode) attention over a KV cache at per-slot
// positions. Scores, running max, denominator and accumulator are f32;
// the output is written once in the input dtype.
//
// B3 replaces the TPU kernel `flash_attention/attend`
// (src/repro/kernels/flash_attention.py: `_attend` at :109, launch at
// :148, body `_softmax_mac` at :49). B4 replaces `flash_attention/decode`
// (`_decode` at :224, launch at :268, body `_decode_mac` at :174).
// On the TPU the kv axis is a sequential "arbitrary" grid axis carrying
// (m, l, acc) in VMEM scratch between steps; here the kv loop runs inside
// one thread block and the state lives in registers.
//
// Bound on the H100, and what the design does about it:
// * B3 at the prefill shape (B=4, H=32, S=128, D=128, causal) does about
//   0.55 GFLOP against 4.2 MB of q, k, v and o: bound by bytes (3.1 us),
//   though a long sequence (S=2048) is bound by operations. bf16 (the
//   serving path) runs `flash_attend_wgmma` on the tensor cores: a block
//   of FA_BQ = 64 query rows (one consumer warpgroup; 64 rather than the
//   reference's 128 because B*H = 128 blocks of 128 rows would leave
//   qwen3-4b's S=128 grid under one wave of 132 SMs) and one producer
//   warp. The producer loads the Q tile once and FA_BKV = 64-key K and V
//   tiles through a 2-stage mbarrier ring, all by TMA from 4-D tensor
//   maps over the (batch, head, seq) strides, 128-byte swizzled, zeros
//   past the sequence's end. S = Q Kt is a wgmma m64n64k16 with Q and K
//   K-major from shared memory; the online softmax runs on the f32
//   accumulator in registers (exp2, running max and denominator per row,
//   the output rescaled); P is rounded to bf16 in registers, where the
//   m64nN accumulator layout is already the A fragment of the next
//   wgmma, and P V is a wgmma with A from registers and V MN-major from
//   shared memory (transpose bit): P never touches shared memory.
//   f32 (tests, not the serving path) runs `flash_attend_kernel` on the
//   CUDA cores: 32 query rows per block (8 per warp) over 32-key tiles
//   shared through shared memory, a lane per key for the scores and D/32
//   output columns per lane for P V.
//   Both take causal and window masks from positions, with queries
//   right-aligned (offset Skv - Sq), and never load a tile wholly above
//   the causal diagonal or wholly before the window.
// * B4 (B=4, KV=8, G=4, D=128, W=256) reads every live cache byte once
//   for 2 flops per byte per query row: bound by bytes, and at the serving
//   shapes (0.4-0.7 us of bytes) by a launch's latency. bf16 (the serving
//   path) runs `flash_decode_split`, flash-decoding across blocks: the grid
//   is (batch x kv head, splits), each block one warp over `chunk` slots
//   (the wrapper's `decode_plan` picks the split from W, B*KV and the SM
//   count, never from pos, which stays on the card), so qwen3-4b's 32
//   (batch, kv head) pairs become 256 blocks. Lanes 0-15 / 16-31 bulk-copy
//   one K / V row (D x 2 contiguous bytes) each per 16-slot tile into a
//   3-stage ring (`cp.async.bulk` completing on an mbarrier; no tensor
//   map, so no host work per call), rows padded by 16 bytes so ldmatrix
//   reads are conflict-free. S = Q Kt and O += P V run on mma.sync
//   m16n8k16 (the G <= 16 grouped rows padded to 16; K the column-major B
//   operand by ldmatrix, V by ldmatrix.trans; P re-packed in registers from
//   the S accumulator as the A fragment), the online softmax in f32 base 2.
//   The (at most 8) splits of a (batch, kv head) are the blocks of one
//   thread-block cluster: each leaves its (acc, m, l) in its shared
//   memory and merges a slice of the output over all of them in split
//   order through distributed shared memory: no second launch, no
//   workspace, no atomics, equal bits on every run. f32 (tests) runs `flash_decode_kernel` on the CUDA
//   cores: one block per (batch, kv head), four warps over interleaved
//   32-slot tiles merging their states at the end.
//   Both read the [B, W, KV, D] cache through strides (no head-major copy
//   per layer and tick); a slot is valid iff k_pos <= pos[b], or every
//   slot once a ring cache has wrapped.
// Masked logits take no part (p = 0); a row with no valid key comes out
// as 0, the reference oracle's convention (kernels/ref.py).
#include "hopper.cuh"

using namespace repro;

namespace {

// Copy `nrows` rows of D elements (row stride `stride`) into f32 shared
// memory with row pitch `pitch`; rows at or past `valid` read zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* __restrict__ src,
                                          long long stride, int nrows, int valid, int tid,
                                          int nthreads) {
  for (int e = tid; e < nrows * D; e += nthreads) {
    const int r = e / D, c = e % D;
    dst[r * pitch + c] = r < valid ? to_f32(src[(long long)r * stride + c]) : 0.f;
  }
}

// Scores of ROWS query rows (Qs, pitch D) against the 32 keys of a tile
// (Ks, pitch D + 1 so that lane-per-key reads hit distinct banks):
// lane j returns s[r] = q_r . k_j.
template <int ROWS, int D>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* Ks, int lane,
                                            float (&s)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
  const float* kr = Ks + lane * (D + 1);
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kd = kr[d];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = fmaf(Qs[r * D + d], kd, s[r]);
  }
}

// The online-softmax step for one tile: s[r] holds this lane's key's
// scaled score, or -inf where masked. Updates the running max m, the
// denominator l and the accumulator acc (lane owns columns lane + 32*i),
// staging p through this warp's Ps (ROWS x 32).
template <int ROWS, int DPL>
__device__ __forceinline__ void tile_update(const float (&s)[ROWS], float (&m)[ROWS],
                                            float (&l)[ROWS], float (&acc)[ROWS][DPL], float* Ps,
                                            const float* Vs, int lane) {
  constexpr int D = 32 * DPL;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float mnew = fmaxf(m[r], warp_max(s[r]));
    const float p = s[r] == -INFINITY ? 0.f : __expf(s[r] - mnew);
    const float alpha = m[r] == -INFINITY ? 0.f : __expf(m[r] - mnew);
    l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    m[r] = mnew;
    Ps[r * 32 + lane] = p;
  }
  __syncwarp();
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    float vj[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) vj[i] = Vs[j * D + lane + 32 * i];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float pr = Ps[r * 32 + j];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pr, vj[i], acc[r][i]);
    }
  }
  __syncwarp();
}

constexpr int ATT_ROWS = 8;                  // query rows per warp in B3
constexpr int ATT_BQ = 32;                   // query rows per block in B3
constexpr int ATT_THREADS = ATT_BQ / ATT_ROWS * 32;

template <typename T, int DPL>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_attend_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int H, int G, int Sq,
                        int Skv, long long qb, long long qh, long long qs, long long kb,
                        long long kh, long long ks, long long vb, long long vh, long long vs,
                        long long ob, long long oh, long long os, int causal, int window,
                        float scale) {
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int bq = ATT_BQ;
  float* Qs = smem;               // bq x D
  float* Ks = Qs + bq * D;        // 32 x (D + 1)
  float* Vs = Ks + 32 * (D + 1);  // 32 x D
  float* Ps = Vs + 32 * D + warp * ATT_ROWS * 32;

  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / G;
  const int q0 = blockIdx.y * bq;
  const int offset = Skv - Sq;  // queries right-aligned against the keys
  const T* kp = k + b * kb + kvh * kh;
  const T* vp = v + b * vb + kvh * vh;
  load_rows<T, D>(Qs, D, q + b * qb + h * qh + (long long)q0 * qs, qs, bq, Sq - q0, tid,
                  blockDim.x);

  // keys any row of this block may see
  const int qpos_first = q0 + offset, qpos_last = min(Sq, q0 + bq) - 1 + offset;
  const int kv_hi = causal ? min(Skv, qpos_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, qpos_first - window + 1) : 0;

  float m[ATT_ROWS], l[ATT_ROWS], acc[ATT_ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ATT_ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const float* Qw = Qs + warp * ATT_ROWS * D;
  for (int t = (kv_lo / 32) * 32; t < kv_hi; t += 32) {
    __syncthreads();  // Q is loaded; the previous tile is consumed
    load_rows<T, D>(Ks, D + 1, kp + (long long)t * ks, ks, 32, Skv - t, tid, blockDim.x);
    load_rows<T, D>(Vs, D, vp + (long long)t * vs, vs, 32, Skv - t, tid, blockDim.x);
    __syncthreads();
    float s[ATT_ROWS];
    tile_scores<ATT_ROWS, D>(Qw, Ks, lane, s);
    const int kpos = t + lane;
#pragma unroll
    for (int r = 0; r < ATT_ROWS; ++r) {
      const int qi = q0 + warp * ATT_ROWS + r, qpos = qi + offset;
      const bool ok = qi < Sq && kpos < Skv && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      s[r] = ok ? s[r] * scale : -INFINITY;
    }
    tile_update<ATT_ROWS, DPL>(s, m, l, acc, Ps, Vs, lane);
  }
#pragma unroll
  for (int r = 0; r < ATT_ROWS; ++r) {
    const int qi = q0 + warp * ATT_ROWS + r;
    if (qi < Sq) {
      T* orow = o + b * ob + h * oh + (long long)qi * os;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        orow[lane + 32 * i] = from_f32<T>(l[r] > 0.f ? acc[r][i] / l[r] : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// B3, bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 64;              // query rows per block: one consumer warpgroup
constexpr int FA_BKV = 64;             // keys per K / V tile
constexpr int FA_STAGES = 2;           // K / V tiles in flight
constexpr int FA_THREADS = 128 + 32;   // the consumer warpgroup + the producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr int fa_smem_bytes() {
  return 2 * (FA_BQ * D + 2 * FA_STAGES * FA_BKV * D) + 1024;  // Q, K and V rings, align slack
}

// q/k/v through tensor maps of dims {D, seq, head, batch}; o [B,H,Sq,D] by
// strides. scale_log2 = scale * log2(e): the softmax runs in base 2.
template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
    flash_attend_wgmma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, int H,
                       int G, int Sq, int Skv, long long ob, long long oh, long long os,
                       int causal, int window, float scale_log2) {
  constexpr int NSUB = D / 64;           // 64-wide (128-byte) sub-tiles of a row
  constexpr int ON = D < 128 ? D : 128;  // output columns per P V wgmma
  constexpr int OC = D / ON;             // P V wgmmas per k16 step
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qbar, kfull[FA_STAGES], vfull[FA_STAGES], empty[FA_STAGES];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw +
                                     ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Ks = Qs + FA_BQ * D;               // FA_STAGES x NSUB x [FA_BKV][64]
  bf16* Vs = Ks + FA_STAGES * FA_BKV * D;  // likewise

  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / G;
  const int q0 = blockIdx.y * FA_BQ;
  const int offset = Skv - Sq;  // queries right-aligned against the keys
  // keys any row of this block may see, in whole tiles
  const int qpos_first = q0 + offset, qpos_last = min(Sq, q0 + FA_BQ) - 1 + offset;
  const int kv_hi = causal ? min(Skv, qpos_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, qpos_first - window + 1) : 0;
  const int t0 = kv_lo / FA_BKV * FA_BKV;
  const int ntiles = kv_hi > t0 ? (kv_hi - t0 + FA_BKV - 1) / FA_BKV : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(&qbar, 1);
    for (int s = 0; s < FA_STAGES; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: one thread issues every load
    if (tid == 128) {
      hopper::mbar_expect_tx(&qbar, FA_BQ * D * 2);
      for (int j = 0; j < NSUB; ++j)
        hopper::tma_load_4d(Qs + j * FA_BQ * 64, &map_q, &qbar, 64 * j, q0, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % FA_STAGES, t = t0 + i * FA_BKV;
        hopper::mbar_wait(&empty[s], ((i / FA_STAGES) & 1) ^ 1);
        bf16* k = Ks + s * FA_BKV * D;
        bf16* v = Vs + s * FA_BKV * D;
        hopper::mbar_expect_tx(&kfull[s], FA_BKV * D * 2);
        for (int j = 0; j < NSUB; ++j)
          hopper::tma_load_4d(k + j * FA_BKV * 64, &map_k, &kfull[s], 64 * j, t, kvh, b);
        hopper::mbar_expect_tx(&vfull[s], FA_BKV * D * 2);
        for (int j = 0; j < NSUB; ++j)
          hopper::tma_load_4d(v + j * FA_BKV * 64, &map_v, &vfull[s], 64 * j, t, kvh, b);
      }
    }
    return;
  }

  // the consumer warpgroup: rows q0 + acc_row(i, tid)
  const int lane = tid & 31;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows r and r + 8 of this thread
  float S[FA_BKV / 2];
  float acc[OC][ON / 2];
  uint32_t P[FA_BKV / 16][4];
#pragma unroll
  for (int i = 0; i < FA_BKV / 2; ++i) S[i] = 0.f;
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) acc[c][i] = 0.f;
  hopper::mbar_wait(&qbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % FA_STAGES, t = t0 + it * FA_BKV;
    const uint32_t phase = (it / FA_STAGES) & 1;
    const bf16* k = Ks + s * FA_BKV * D;
    const bf16* v = Vs + s * FA_BKV * D;

    // S = Q Kt over D in k16 steps (32 bytes within a 128-byte sub-tile row)
    hopper::mbar_wait(&kfull[s], phase);
    hopper::fence_regs(S);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss_n64<0>(
          S, hopper::desc_kmajor(Qs + (kk / 4) * FA_BQ * 64 + (kk % 4) * 16),
          hopper::desc_kmajor(k + (kk / 4) * FA_BKV * 64 + (kk % 4) * 16), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(S);

    // online softmax on the accumulator; masks only on edge tiles
    const bool edge = t + FA_BKV > Skv || (causal && t + FA_BKV - 1 > qpos_first) ||
                      (window > 0 && t <= q0 + FA_BQ - 1 + offset - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < FA_BKV / 2; ++i) {
      float x = S[i] * scale_log2;
      if (edge) {
        const int kpos = t + hopper::acc_col(i, tid);
        const int qpos = q0 + hopper::acc_row(i, tid) + offset;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        x = ok ? x : -INFINITY;
      }
      S[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], base[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row lives in the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no valid key yet: p = 0
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < FA_BKV / 2; ++i) {
      S[i] = exp2f(S[i] - base[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += S[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int i = 0; i < ON / 2; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
    // the accumulator of columns 16kk..16kk+15 is the A fragment of k step kk
#pragma unroll
    for (int kk = 0; kk < FA_BKV / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) P[kk][j] = hopper::pack_bf16(S[8 * kk + 2 * j], S[8 * kk + 2 * j + 1]);

    // acc += P V over the tile's keys in k16 steps (16 rows of V each)
    hopper::mbar_wait(&vfull[s], phase);
#pragma unroll
    for (int c = 0; c < OC; ++c) hopper::fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < FA_BKV / 16; ++kk) hopper::fence_regs(P[kk]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FA_BKV / 16; ++kk)
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const uint64_t dv = hopper::desc_mnmajor(v + c * (ON / 64) * FA_BKV * 64 + kk * 16 * 64,
                                                 FA_BKV * 64 * 2);
        if constexpr (ON == 64)
          hopper::wgmma_rs_n64<1>(acc[c], P[kk], dv, 1);
        else
          hopper::wgmma_rs_n128<1>(acc[c], P[kk], dv, 1);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < OC; ++c) hopper::fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < FA_BKV / 16; ++kk) hopper::fence_regs(P[kk]);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this stage's K and V are consumed
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  bf16* ob_ = o + b * ob + h * oh;
#pragma unroll
  for (int c = 0; c < OC; ++c)
#pragma unroll
    for (int i = 0; i < ON / 2; i += 2) {
      const int qi = q0 + hopper::acc_row(i, tid);
      if (qi < Sq) {
        const float sc = inv[(i >> 1) & 1];
        *reinterpret_cast<uint32_t*>(ob_ + qi * os + c * ON + hopper::acc_col(i, tid)) =
            hopper::pack_bf16(acc[c][i] * sc, acc[c][i + 1] * sc);
      }
    }
}

template <int ROWS, int D>
__host__ __device__ constexpr int decode_warp_floats() {
  return 32 * (D + 1) + 32 * D + ROWS * 32;  // K tile, V tile, P
}

// B4, f32 (tests, not the serving path): one block per (batch, kv head)
// on the CUDA cores
template <int ROWS, int DPL>
__global__ void flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const int* __restrict__ pos,
                                    float* __restrict__ o, int KVH, int G, int W, long long qb,
                                    long long qk, long long qg, long long kb, long long kk,
                                    long long kw, long long vb, long long vk, long long vw,
                                    long long ob, long long ok, long long og, int ring,
                                    float scale) {
  constexpr int D = 32 * DPL;
  constexpr int WF = decode_warp_floats<ROWS, D>();
  extern __shared__ float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nw = blockDim.x >> 5;
  float* Qs = smem;  // ROWS x D
  float* Ks = Qs + ROWS * D + warp * WF;
  float* Vs = Ks + 32 * (D + 1);
  float* Ps = Vs + 32 * D;

  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const int p = pos[b];
  // number of live cache slots: k_pos <= pos, or all once a ring wrapped
  const int n = (ring && p + 1 >= W) ? W : max(0, min(W, p + 1));
  const float* kp = k + b * kb + h * kk;
  const float* vp = v + b * vb + h * vk;
  load_rows<float, D>(Qs, D, q + b * qb + h * qk, qg, ROWS, G, tid, blockDim.x);
  __syncthreads();

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  for (int t = warp * 32; t < n; t += nw * 32) {
    load_rows<float, D>(Ks, D + 1, kp + (long long)t * kw, kw, 32, n - t, lane, 32);
    load_rows<float, D>(Vs, D, vp + (long long)t * vw, vw, 32, n - t, lane, 32);
    __syncwarp();
    float s[ROWS];
    tile_scores<ROWS, D>(Qs, Ks, lane, s);
    const bool live = t + lane < n;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = (live && r < G) ? s[r] * scale : -INFINITY;
    tile_update<ROWS, DPL>(s, m, l, acc, Ps, Vs, lane);
  }

  // merge the warps' partial softmax states: acc [ROWS][D], then m, l
  float* red = Ks;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) red[r * D + lane + 32 * i] = acc[r][i];
    if (lane == 0) {
      red[ROWS * D + r] = m[r];
      red[ROWS * D + ROWS + r] = l[r];
    }
  }
  __syncthreads();
  const float* red0 = Qs + ROWS * D;
  for (int e = tid; e < G * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    float mx = -INFINITY;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, red0[w * WF + ROWS * D + r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* rw = red0 + w * WF;
      const float mw = rw[ROWS * D + r];
      if (mw != -INFINITY) {
        const float sc = __expf(mw - mx);
        L = fmaf(rw[ROWS * D + ROWS + r], sc, L);
        A = fmaf(rw[r * D + c], sc, A);
      }
    }
    o[b * ob + h * ok + r * og + c] = L > 0.f ? A / L : 0.f;
  }
}

// ---------------------------------------------------------------------------
// B4, bf16: split-KV decode on mma.sync, the cache streamed by bulk copies
// ---------------------------------------------------------------------------

constexpr int DEC_BK = 16;          // cache slots per tile: one k16 step of P V
constexpr int DEC_STAGES = 3;       // tiles in flight
constexpr int DEC_ROWS = 16;        // grouped query rows, padded to mma's m16
constexpr int DEC_MAX_SPLITS = 8;   // splits: one cluster, portable size

// bytes per shared-memory row: 16 more than a cache row, so the eight rows
// one ldmatrix reads start in eight different banks
template <int D>
__host__ __device__ constexpr int dec_pitch() { return 2 * D + 16; }

template <int D>
__host__ __device__ constexpr int dec_smem_bytes() {  // Q, then the K and V rings
  return (DEC_ROWS + 2 * DEC_STAGES * DEC_BK) * dec_pitch<D>();
}

// One warp per block; block (bh, split) covers cache slots
// [split * chunk, split * chunk + chunk) of (batch, kv head) bh. Lanes 0-15
// bulk-copy one K row each and lanes 16-31 one V row each per tile into a
// DEC_STAGES ring; S = Q Kt (K as the column-major B operand by ldmatrix)
// and O += P V (P re-packed from the S accumulator as the A fragment, V by
// ldmatrix.trans) run on mma.sync with an online softmax in base 2. With
// one split the block writes o; with more, the splits of bh are the blocks
// of one cluster: each leaves its (acc, m, l) in its shared memory and
// merges a slice of o over all of them in split order.
template <int D>
__global__ void __launch_bounds__(32)
    flash_decode_split(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int* __restrict__ pos,
                       bf16* __restrict__ o, int KVH, int G, int W, int chunk, long long qb, long long qk, long long qg,
                       long long kb, long long kk, long long kw, long long vb, long long vk,
                       long long vw, long long ob, long long ok, long long og, int ring,
                       float scale_log2) {
  constexpr int P = dec_pitch<D>();
  constexpr int NT = D / 8;  // n8 tiles of a row of O
  extern __shared__ __align__(128) uint8_t dec_smem[];
  __shared__ __align__(8) uint64_t qbar, full[DEC_STAGES];
  __shared__ float fac[DEC_MAX_SPLITS * DEC_ROWS];
  uint8_t* Qs = dec_smem;
  uint8_t* Ks = Qs + DEC_ROWS * P;
  uint8_t* Vs = Ks + DEC_STAGES * DEC_BK * P;

  const int lane = threadIdx.x, gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / KVH, h = bh % KVH;
  const int split = blockIdx.y, S = gridDim.y;
  const int p = pos[b];
  // live cache slots: k_pos <= pos, or all once a ring has wrapped
  const int n = (ring && p + 1 >= W) ? W : max(0, min(W, p + 1));
  const int start = split * chunk, end = min(start + chunk, n);
  const int ntiles = end > start ? (end - start + DEC_BK - 1) / DEC_BK : 0;
  const bf16* kp = k + b * kb + h * kk;
  const bf16* vp = v + b * vb + h * vk;

  if (lane == 0) {
    hopper::mbar_init(&qbar, 1);
    for (int s = 0; s < DEC_STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncwarp();

  // tile i into stage i % DEC_STAGES; the rows past `end` are zeroed
  // (only the last tile has any), so a dead slot adds 0, never NaN
  auto issue = [&](int i) {
    const int s = i % DEC_STAGES, t = start + i * DEC_BK;
    const int rows = min(DEC_BK, end - t), r = lane & 15;
    const bool isv = lane >= 16;
    if (lane == 0) hopper::mbar_expect_tx(&full[s], 2 * rows * D * 2);
    __syncwarp();
    uint8_t* dst = (isv ? Vs : Ks) + (s * DEC_BK + r) * P;
    if (r < rows) {
      hopper::bulk_load(dst, (isv ? vp : kp) + (long long)(t + r) * (isv ? vw : kw), D * 2,
                        &full[s]);
    } else {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) reinterpret_cast<uint4*>(dst)[c] = make_uint4(0, 0, 0, 0);
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows gq and gq + 8
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (ntiles > 0) {
    if (lane == 0) hopper::mbar_expect_tx(&qbar, G * D * 2);
    __syncwarp();
    if (lane < G) {
      hopper::bulk_load(Qs + lane * P, q + b * qb + h * qk + lane * qg, D * 2, &qbar);
    } else if (lane < DEC_ROWS) {
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        reinterpret_cast<uint4*>(Qs + lane * P)[c] = make_uint4(0, 0, 0, 0);
    }
    for (int i = 0; i < min(DEC_STAGES, ntiles); ++i) issue(i);
    hopper::mbar_wait(&qbar, 0);
    __syncwarp();
  }

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % DEC_STAGES, t = start + i * DEC_BK;
    hopper::mbar_wait(&full[s], (i / DEC_STAGES) & 1);
    __syncwarp();
    const uint8_t* ks = Ks + s * DEC_BK * P;
    const uint8_t* vs = Vs + s * DEC_BK * P;

    // S [16 rows x 16 slots] = Q Kt over D in k16 steps
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      uint32_t a[4], bk[4];
      hopper::ldmatrix_x4(a, Qs + (lane & 15) * P + (c * 16 + (lane >> 4) * 8) * 2);
      hopper::ldmatrix_x4(bk, ks + ((lane & 7) + ((lane >> 4) << 3)) * P +
                                  (c * 16 + ((lane >> 3) & 1) * 8) * 2);
      hopper::mma_16816(sc[0], a, bk[0], bk[1]);
      hopper::mma_16816(sc[1], a, bk[2], bk[3]);
    }

    // online softmax in base 2; only the last tile has dead slots
    const bool edge = t + DEC_BK > end;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (edge && t + 8 * j + 2 * tq + (e & 1) >= end) x = -INFINITY;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], base[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row lives in the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - base[e >> 1]);
        rs[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // the S accumulator of slots 0-7 and 8-15 is the A fragment of P V
    const uint32_t pa[4] = {hopper::pack_bf16(sc[0][0], sc[0][1]),
                            hopper::pack_bf16(sc[0][2], sc[0][3]),
                            hopper::pack_bf16(sc[1][0], sc[1][1]),
                            hopper::pack_bf16(sc[1][2], sc[1][3])};
    // O [16 x D] += P [16 x 16] V [16 x D], V transposed by ldmatrix
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      uint32_t bv[4];
      hopper::ldmatrix_x4_trans(bv, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                        (c * 16 + (lane >> 4) * 8) * 2);
      hopper::mma_16816(acc[2 * c], pa, bv[0], bv[1]);
      hopper::mma_16816(acc[2 * c + 1], pa, bv[2], bv[3]);
    }
    __syncwarp();
    if (i + DEC_STAGES < ntiles) {
      hopper::fence_proxy_async();  // this stage's reads before its refill
      issue(i + DEC_STAGES);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row[2] = {gq, gq + 8};
  if (S == 1) {  // the whole cache in this block: normalise and write o
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= G) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      bf16* orow = o + b * ob + h * ok + row[r] * og;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq) =
            hopper::pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    return;
  }

  // this split's state (an empty split has m = -inf, l = 0, acc = 0) in
  // its own shared memory, over the ring it no longer needs: acc [G][D],
  // then m [16] and l [16]
  float* st = reinterpret_cast<float*>(Ks);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= G) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(st + row[r] * D + 8 * j + 2 * tq) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    if (tq == 0) {
      st[G * D + row[r]] = m[r];
      st[G * D + 16 + row[r]] = l[r];
    }
  }
  hopper::cluster_sync();  // the splits of bh are the blocks of this cluster, rank == split

  // fac[s][r] = 2^(m_s - M) / L for row r, 0 for an empty split
  if (lane < G) {
    float M = -INFINITY;
    for (int s = 0; s < S; ++s) M = fmaxf(M, hopper::ld_cluster(st + G * D + lane, s));
    float L = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ms = hopper::ld_cluster(st + G * D + lane, s);
      const float f = ms == -INFINITY ? 0.f : exp2f(ms - M);
      fac[s * DEC_ROWS + lane] = f;
      L = fmaf(hopper::ld_cluster(st + G * D + 16 + lane, s), f, L);
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    for (int s = 0; s < S; ++s) fac[s * DEC_ROWS + lane] *= inv;
  }
  __syncwarp();
  // this block merges every S-th 4-column vector of o, in split order
  for (int i = split + S * lane; i < G * D / 4; i += S * 32) {
    const int r = 4 * i / D, c = 4 * i % D;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      const float f = fac[s * DEC_ROWS + r];
      if (f != 0.f) {
        const float4 a = hopper::ld_cluster4(st + 4 * i, s);
        sum.x = fmaf(a.x, f, sum.x);
        sum.y = fmaf(a.y, f, sum.y);
        sum.z = fmaf(a.z, f, sum.z);
        sum.w = fmaf(a.w, f, sum.w);
      }
    }
    *reinterpret_cast<uint2*>(o + b * ob + h * ok + r * og + c) =
        make_uint2(hopper::pack_bf16(sum.x, sum.y), hopper::pack_bf16(sum.z, sum.w));
  }
  hopper::cluster_sync();  // no block leaves while another reads its shared memory
}

template <typename T, int DPL>
int launch_attend(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
                  int Sq, int Skv, const long long* st, int causal, int window, float scale,
                  cudaStream_t s) {
  constexpr int D = 32 * DPL;
  constexpr size_t smem = sizeof(float) * ((size_t)ATT_BQ * D + 32 * (D + 1) + 32 * D + ATT_BQ * 32);
  auto kern = flash_attend_kernel<T, DPL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + ATT_BQ - 1) / ATT_BQ);
  kern<<<grid, ATT_THREADS, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<T*>(o), H, H / KVH,
                                       Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                                       st[7], st[8], st[9], st[10], st[11], causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// q/k/v as 4-D tensor maps {D, seq, head, batch} over their strides
// (st: qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os in elements).
template <int D>
int launch_attend_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int KVH, int Sq, int Skv, const long long* st, int causal, int window,
                        float scale, cudaStream_t s) {
  CUtensorMap map_q, map_k, map_v;
  const cuuint64_t dims_q[4] = {D, (cuuint64_t)Sq, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t dims_kv[4] = {D, (cuuint64_t)Skv, (cuuint64_t)KVH, (cuuint64_t)B};
  const cuuint64_t str_q[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const cuuint64_t str_k[3] = {(cuuint64_t)st[5] * 2, (cuuint64_t)st[4] * 2, (cuuint64_t)st[3] * 2};
  const cuuint64_t str_v[3] = {(cuuint64_t)st[8] * 2, (cuuint64_t)st[7] * 2, (cuuint64_t)st[6] * 2};
  const cuuint32_t box_q[4] = {64, FA_BQ, 1, 1}, box_kv[4] = {64, FA_BKV, 1, 1};
  if (int err = encode_bf16_map(&map_q, 4, q, dims_q, str_q, box_q)) return err;
  if (int err = encode_bf16_map(&map_k, 4, k, dims_kv, str_k, box_kv)) return err;
  if (int err = encode_bf16_map(&map_v, 4, v, dims_kv, str_v, box_kv)) return err;
  constexpr int smem = fa_smem_bytes<D>();
  auto kern = flash_attend_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + FA_BQ - 1) / FA_BQ);
  kern<<<grid, FA_THREADS, smem, s>>>(map_q, map_k, map_v, static_cast<bf16*>(o), H, H / KVH, Sq,
                                      Skv, st[9], st[10], st[11], causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int ROWS, int DPL>
int launch_decode(const void* q, const void* k, const void* v, const int* pos, void* o, int B,
                  int KVH, int G, int W, const long long* st, int ring, float scale,
                  cudaStream_t s) {
  constexpr int D = 32 * DPL;
  int nw = 4;
  auto bytes = [](int warps) {
    return sizeof(float) * ((size_t)ROWS * D + (size_t)warps * decode_warp_floats<ROWS, D>());
  };
  while (nw > 1 && bytes(nw) > 200 * 1024) nw /= 2;
  const size_t smem = bytes(nw);
  auto kern = flash_decode_kernel<ROWS, DPL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B * KVH, nw * 32, smem, s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                      static_cast<const float*>(v), pos, static_cast<float*>(o),
                                      KVH, G, W, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                                      st[7], st[8], st[9], st[10], st[11], ring, scale);
  return static_cast<int>(cudaGetLastError());
}

// grid (B * KVH, splits) in clusters of the splits, one warp per block
template <int D>
int launch_decode_split(const void* q, const void* k, const void* v, const int* pos, void* o,
                        int B, int KVH, int G, int W, const long long* st, int ring, float scale,
                        int splits, int chunk, cudaStream_t s) {
  constexpr int smem = dec_smem_bytes<D>();
  auto kern = flash_decode_split<D>;
  static bool ready = false;  // the attribute is set once per process
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  return launch_cluster_y(
      kern, dim3(B * KVH, splits), 32, smem, splits, s, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), pos, static_cast<bf16*>(o), KVH,
      G, W, chunk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], ring, scale * LOG2E);
}

template <typename T>
int attend_for_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
                 int KVH, int Sq, int Skv, const long long* st, int causal, int window,
                 float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch_attend<T, 2>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, window, scale, s);
    case 128: return launch_attend<T, 4>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, window, scale, s);
    case 256: return launch_attend<T, 8>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int attend_wgmma_for_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
                       int KVH, int Sq, int Skv, const long long* st, int causal, int window,
                       float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch_attend_wgmma<64>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, window, scale, s);
    case 128: return launch_attend_wgmma<128>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, window, scale, s);
    case 256: return launch_attend_wgmma<256>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int ROWS>
int decode_for_d(int D, const void* q, const void* k, const void* v, const int* pos, void* o,
                 int B, int KVH, int G, int W, const long long* st, int ring, float scale,
                 cudaStream_t s) {
  switch (D) {
    case 64: return launch_decode<ROWS, 2>(q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
    case 128: return launch_decode<ROWS, 4>(q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
    case 256: return launch_decode<ROWS, 8>(q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32 decode (tests, not the serving path), by grouped rows per kv head
int decode_for_g(int D, const void* q, const void* k, const void* v, const int* pos, void* o,
                 int B, int KVH, int G, int W, const long long* st, int ring, float scale,
                 cudaStream_t s) {
  if (G <= 4) return decode_for_d<4>(D, q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
  if (G <= 8) return decode_for_d<8>(D, q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
  if (G <= 16) return decode_for_d<16>(D, q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B,H,Sq,D], k/v [B,KVH,Skv,D], o [B,H,Sq,D], each given by its
// (batch, head, seq) strides with a unit stride on D. window <= 0: none.
// `flash_attend` takes f32 (CUDA cores); `flash_attend_wgmma` takes bf16
// whose bases are 16-byte aligned and whose strides are multiples of 8.
extern "C" int flash_attend(const void* q, const void* k, const void* v, void* o, int B, int H,
                            int KVH, int Sq, int Skv, int D, long long qb, long long qh,
                            long long qs, long long kb, long long kh, long long ks, long long vb,
                            long long vh, long long vs, long long ob, long long oh, long long os,
                            int causal, int window, float scale, void* stream) {
  const long long st[12] = {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  return attend_for_d<float>(D, q, k, v, o, B, H, KVH, Sq, Skv, st, causal, window, scale,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attend_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int KVH, int Sq, int Skv, int D, long long qb,
                                  long long qh, long long qs, long long kb, long long kh,
                                  long long ks, long long vb, long long vh, long long vs,
                                  long long ob, long long oh, long long os, int causal,
                                  int window, float scale, void* stream) {
  const long long st[12] = {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  return attend_wgmma_for_d(D, q, k, v, o, B, H, KVH, Sq, Skv, st, causal, window, scale,
                            static_cast<cudaStream_t>(stream));
}

// q [B,KVH,G,D], k/v [B,KVH,W,D], o [B,KVH,G,D] by (batch, kv head,
// row) strides, unit stride on D; pos [B] int32 on the card. bf16 runs
// `flash_decode_split` over `splits` <= DEC_MAX_SPLITS blocks of `chunk`
// slots (a multiple of DEC_BK) per (batch, kv head): q, k and v 16-byte
// aligned with strides that are multiples of 8. f32 runs
// `flash_decode_kernel` (splits and chunk unused).
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* pos, void* o,
                            int B, int KVH, int G, int W, int D,
                            long long qb, long long qk, long long qg, long long kb, long long kk,
                            long long kw, long long vb, long long vk, long long vw, long long ob,
                            long long ok, long long og, int ring, float scale, int dtype,
                            int splits, int chunk, void* stream) {
  const long long st[12] = {qb, qk, qg, kb, kk, kw, vb, vk, vw, ob, ok, og};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (dtype != BF16) return decode_for_g(D, q, k, v, p, o, B, KVH, G, W, st, ring, scale, s);
  if (splits < 1 || splits > DEC_MAX_SPLITS || chunk % DEC_BK)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return launch_decode_split<64>(q, k, v, p, o, B, KVH, G, W, st, ring, scale, splits, chunk, s);
    case 128: return launch_decode_split<128>(q, k, v, p, o, B, KVH, G, W, st, ring, scale, splits, chunk, s);
    case 256: return launch_decode_split<256>(q, k, v, p, o, B, KVH, G, W, st, ring, scale, splits, chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING_TMA
