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
//   4*S*D flops per query row against 2*S*D*2 bytes of K and V per head:
//   bound by operations, on the CUDA cores in this first version (no
//   tensor cores yet — a later PR). A block holds ATT_BQ = 32 query rows
//   (8 per warp, four warps) and walks 32-key tiles that all its warps
//   share through shared memory; a lane owns one key for the scores (a
//   Q.K dot over D from shared memory) and D/32 output columns for P.V.
//   Causal and window masks come from positions, with queries
//   right-aligned (offset Skv - Sq); tiles wholly above the causal
//   diagonal or wholly before the window are never loaded.
// * B4 (B=4, KV=8, G=4, D=128, W=256) reads every cache byte once for
//   2 flops per byte per query row: bound by bytes. A block serves one
//   (batch, kv head) and its G grouped query rows, so each cached K/V row
//   is read once for all G heads that share it; the block's four warps
//   take interleaved 32-key tiles with their own online softmax and merge
//   (m, l, acc) at the end — the flash-decoding split inside one block.
//   The cache is read through strides, so the [B, W, KV, D] cache needs
//   no head-major copy per layer and tick; a slot is valid iff
//   k_pos <= pos[b], or every slot once a ring cache has wrapped.
// Masked logits take no part (p = 0); a row with no valid key comes out
// as 0, the reference oracle's convention (kernels/ref.py).
#include "common.cuh"

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

template <int ROWS, int D>
__host__ __device__ constexpr int decode_warp_floats() {
  return 32 * (D + 1) + 32 * D + ROWS * 32;  // K tile, V tile, P
}

template <typename T, int ROWS, int DPL>
__global__ void flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, const int* __restrict__ pos,
                                    T* __restrict__ o, int KVH, int G, int W, long long qb,
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
  const T* kp = k + b * kb + h * kk;
  const T* vp = v + b * vb + h * vk;
  load_rows<T, D>(Qs, D, q + b * qb + h * qk, qg, ROWS, G, tid, blockDim.x);
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
    load_rows<T, D>(Ks, D + 1, kp + (long long)t * kw, kw, 32, n - t, lane, 32);
    load_rows<T, D>(Vs, D, vp + (long long)t * vw, vw, 32, n - t, lane, 32);
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
    o[b * ob + h * ok + r * og + c] = from_f32<T>(L > 0.f ? A / L : 0.f);
  }
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

template <typename T, int ROWS, int DPL>
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
  auto kern = flash_decode_kernel<T, ROWS, DPL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B * KVH, nw * 32, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), pos, static_cast<T*>(o), KVH, G,
                                      W, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                                      st[8], st[9], st[10], st[11], ring, scale);
  return static_cast<int>(cudaGetLastError());
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

template <typename T, int ROWS>
int decode_for_d(int D, const void* q, const void* k, const void* v, const int* pos, void* o,
                 int B, int KVH, int G, int W, const long long* st, int ring, float scale,
                 cudaStream_t s) {
  switch (D) {
    case 64: return launch_decode<T, ROWS, 2>(q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
    case 128: return launch_decode<T, ROWS, 4>(q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
    case 256: return launch_decode<T, ROWS, 8>(q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int decode_for_g(int D, const void* q, const void* k, const void* v, const int* pos, void* o,
                 int B, int KVH, int G, int W, const long long* st, int ring, float scale,
                 cudaStream_t s) {
  if (G <= 4) return decode_for_d<T, 4>(D, q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
  if (G <= 8) return decode_for_d<T, 8>(D, q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
  if (G <= 16) return decode_for_d<T, 16>(D, q, k, v, pos, o, B, KVH, G, W, st, ring, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B,H,Sq,D], k/v [B,KVH,Skv,D], o [B,H,Sq,D], each given by its
// (batch, head, seq) strides with a unit stride on D. window <= 0: none.
extern "C" int flash_attend(const void* q, const void* k, const void* v, void* o, int B, int H,
                            int KVH, int Sq, int Skv, int D, long long qb, long long qh,
                            long long qs, long long kb, long long kh, long long ks, long long vb,
                            long long vh, long long vs, long long ob, long long oh, long long os,
                            int causal, int window, float scale, int dtype, void* stream) {
  const long long st[12] = {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return attend_for_d<bf16>(D, q, k, v, o, B, H, KVH, Sq, Skv, st, causal, window, scale, s);
  return attend_for_d<float>(D, q, k, v, o, B, H, KVH, Sq, Skv, st, causal, window, scale, s);
}

// q [B,KVH,G,D], k/v [B,KVH,W,D], o [B,KVH,G,D] by (batch, kv head,
// row) strides, unit stride on D; pos [B] int32 on the card.
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* pos, void* o,
                            int B, int KVH, int G, int W, int D, long long qb, long long qk,
                            long long qg, long long kb, long long kk, long long kw, long long vb,
                            long long vk, long long vw, long long ob, long long ok, long long og,
                            int ring, float scale, int dtype, void* stream) {
  const long long st[12] = {qb, qk, qg, kb, kk, kw, vb, vk, vw, ob, ok, og};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (dtype == BF16) return decode_for_g<bf16>(D, q, k, v, p, o, B, KVH, G, W, st, ring, scale, s);
  return decode_for_g<float>(D, q, k, v, p, o, B, KVH, G, W, st, ring, scale, s);
}

REPRO_EXPORT_ERROR_STRING
