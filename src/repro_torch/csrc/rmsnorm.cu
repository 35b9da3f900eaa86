// B2 — RMSNorm over rows, y = x * rsqrt(mean(x^2) + eps) * w, in f32,
// written in x's dtype.
//
// Replaces the TPU kernel `rmsnorm/rows` (src/repro/kernels/rmsnorm.py:
// `_rows`, launch at :72, body `_normalize` at :28).
//
// Bound on the H100: bytes, and at decode (4 rows) latency. Each element
// is read once and written once and takes a handful of flops, far below
// the ~295 flops per byte the card needs before its arithmetic is the
// limit. So every row makes one round trip to device memory: each thread
// issues all of its 16-byte loads of x and of w before it uses any of
// them, keeps the row in registers for the scaled write (x is never read
// twice) and stores 16-byte vectors. Two width classes, one kernel
// template (`rows_kernel<T, LANES, ROWS, VECS, VEC>`):
// * wide rows (d > NARROW_MAX_D: norm1, norm2 and the final norm, d =
//   2560-8192): one 256-thread block per row, up to WIDE_VECS 16-byte
//   chunks a thread (rows up to 32 KB; 2 for bf16 rows up to 8 KB, so few
//   registers and many blocks an SM); the sum of squares is reduced with
//   warp shuffles, then across the 8 warps through 8 floats of shared
//   memory. 512 rows make 512 blocks; 4 rows make 4 blocks, each one DRAM
//   round trip. A row wider than the registers hold (over 32 KB) is read
//   twice, the second time from L2.
// * narrow rows (d <= NARROW_MAX_D: q/k-norm, head_dim 128 and 256): a
//   group of 16 lanes per row, each lane up to NARROW_VECS chunks (one for
//   bf16 head_dim 128), reduced
//   with shuffles inside the group; 8 rows per 128-thread block (`brows`),
//   so 16384 rows make 2048 blocks and 16 rows make 2.
// A width that is not a multiple of 16 bytes, or a base that is not
// 16-byte aligned, takes the same kernel with element loads (VEC false).
// f32 keeps full f32 math; bf16 is widened to f32 on the way in and
// rounded once on the way out. The TPU's padding of rows to a multiple
// of the block is not needed: lanes past the last row load zeros and
// store nothing.
#include "common.cuh"

using namespace repro;

constexpr int NARROW_MAX_D = 256;  // widths up to this take the narrow class
constexpr int NARROW_LANES = 16;   // lanes per row
constexpr int NARROW_ROWS = 8;     // rows per block: the schedule's brows
constexpr int NARROW_VECS = 4;     // 16-byte chunks per lane: 256 f32
constexpr int WIDE_THREADS = 256;  // one block per row
constexpr int WIDE_VECS = 8;       // chunks per thread held in registers: 32 KB rows

// Chunk c of a row: elements [c * N, c * N + N) with N = 16 / sizeof(T),
// zeros past d; one 16-byte load, or (VEC false) element loads.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row, int c, int d) {
  constexpr int N = 16 / sizeof(T);
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (VEC) {
    if (c * N < d) out = __ldg(reinterpret_cast<const uint4*>(row) + c);
  } else {
    T* e = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (c * N + i < d) e[i] = row[c * N + i];
  }
  return out;
}

template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float (&out)[16 / sizeof(T)]) {
  unpack16(raw, out);
}

template <typename T>
__device__ __forceinline__ float sum_sq(const uint4& raw) {
  float v[16 / sizeof(T)];
  widen<T>(raw, v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) s = fmaf(v[i], v[i], s);
  return s;
}

// y's chunk c = x's chunk * r * w's chunk, rounded once to T
template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* __restrict__ row, int c, int d, const uint4& xr,
                                            const uint4& wr, float r) {
  constexpr int N = 16 / sizeof(T);
  if (c * N >= d) return;
  float xv[N], wv[N];
  widen<T>(xr, xv);
  widen<T>(wr, wv);
  uint4 packed;
  T* out = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = from_f32<T>(xv[i] * r * wv[i]);
  if (VEC) {
    *reinterpret_cast<uint4*>(row + c * N) = packed;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (c * N + i < d) row[c * N + i] = out[i];
  }
}

// The sum over the LANES lanes of one row: shuffles inside a group (up to
// a warp), then, for a block-wide row, the warps' sums through shared
// memory, added in warp order by every thread.
template <int LANES>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = (LANES < 32 ? LANES : 32) / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (LANES > 32) {
    __shared__ float part[LANES / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    v = 0.f;
#pragma unroll
    for (int w = 0; w < LANES / 32; ++w) v += part[w];
  }
  return v;
}

// ROWS rows per block, LANES lanes per row, each lane holding up to VECS
// chunks (lane + i * LANES) of x and of w in registers.
template <typename T, int LANES, int ROWS, int VECS, bool VEC>
__global__ void __launch_bounds__(LANES * ROWS)
    rows_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int rows,
                int d, long long ldx, long long ldy, float eps) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x % LANES;
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.x / LANES;
  const bool valid = row < rows;  // lanes past the last row still shuffle
  const T* xr = x + (valid ? row : 0) * ldx;
  T* yr = y + row * ldy;
  const int nch = (d + N - 1) / N;
  uint4 xv[VECS], wv[VECS];
  float ss = 0.f;
  if (nch <= LANES * VECS) {  // the row in registers: one round trip
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const int c = lane + i * LANES;
      xv[i] = valid ? load_chunk<T, VEC>(xr, c, d) : make_uint4(0u, 0u, 0u, 0u);
      wv[i] = load_chunk<T, VEC>(w, c, d);
    }
#pragma unroll
    for (int i = 0; i < VECS; ++i) ss += sum_sq<T>(xv[i]);
    const float r = rsqrtf(row_sum<LANES>(ss) / (float)d + eps);
    if (valid) {
#pragma unroll
      for (int i = 0; i < VECS; ++i) store_chunk<T, VEC>(yr, lane + i * LANES, d, xv[i], wv[i], r);
    }
    return;
  }
  // wider than the registers hold: the sum in passes, then x again (L2)
  for (int c0 = 0; c0 < nch; c0 += LANES * VECS) {
#pragma unroll
    for (int i = 0; i < VECS; ++i) xv[i] = load_chunk<T, VEC>(xr, c0 + lane + i * LANES, d);
#pragma unroll
    for (int i = 0; i < VECS; ++i) ss += sum_sq<T>(xv[i]);
  }
  const float r = rsqrtf(row_sum<LANES>(ss) / (float)d + eps);
  for (int c0 = 0; c0 < nch; c0 += LANES * VECS) {
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      xv[i] = load_chunk<T, VEC>(xr, c0 + lane + i * LANES, d);
      wv[i] = load_chunk<T, VEC>(w, c0 + lane + i * LANES, d);
    }
#pragma unroll
    for (int i = 0; i < VECS; ++i) store_chunk<T, VEC>(yr, c0 + lane + i * LANES, d, xv[i], wv[i], r);
  }
}

// One launch of the class whose rows take `nch` chunks, with the fewest
// chunks a lane that hold the row (registers are what bounds the blocks an
// SM keeps in flight); a wide row over 32 KB takes WIDE_VECS and passes.
template <typename T, int LANES, int ROWS, int MAX_VECS, bool VEC>
static void launch_class(int blocks, int nch, const T* x, const T* w, T* y, int rows, int d,
                         long long ldx, long long ldy, float eps, cudaStream_t s) {
  if (nch <= LANES)
    rows_kernel<T, LANES, ROWS, 1, VEC>
        <<<blocks, LANES * ROWS, 0, s>>>(x, w, y, rows, d, ldx, ldy, eps);
  else if (nch <= 2 * LANES)
    rows_kernel<T, LANES, ROWS, 2, VEC>
        <<<blocks, LANES * ROWS, 0, s>>>(x, w, y, rows, d, ldx, ldy, eps);
  else if (MAX_VECS <= 4 || nch <= 4 * LANES)
    rows_kernel<T, LANES, ROWS, 4, VEC>
        <<<blocks, LANES * ROWS, 0, s>>>(x, w, y, rows, d, ldx, ldy, eps);
  else
    rows_kernel<T, LANES, ROWS, MAX_VECS, VEC>
        <<<blocks, LANES * ROWS, 0, s>>>(x, w, y, rows, d, ldx, ldy, eps);
}

template <typename T, bool VEC>
static void launch_rows(const void* x, const void* w, void* y, int rows, int d, long long ldx,
                        long long ldy, float eps, cudaStream_t s) {
  auto* X = static_cast<const T*>(x);
  auto* W = static_cast<const T*>(w);
  auto* Y = static_cast<T*>(y);
  const int nch = (d + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T));
  if (d <= NARROW_MAX_D)
    launch_class<T, NARROW_LANES, NARROW_ROWS, NARROW_VECS, VEC>(
        (rows + NARROW_ROWS - 1) / NARROW_ROWS, nch, X, W, Y, rows, d, ldx, ldy, eps, s);
  else
    launch_class<T, WIDE_THREADS, 1, WIDE_VECS, VEC>(rows, nch, X, W, Y, rows, d, ldx, ldy, eps, s);
}

// `vec`: d * sizeof(T) is a multiple of 16 and x, w, y start 16-byte
// aligned (with ldx, ldy multiples of 16 / sizeof(T)), so every chunk
// moves as one 16-byte load or store.
extern "C" int rmsnorm_rows(const void* x, const void* w, void* y, int rows, int d,
                            long long ldx, long long ldy, float eps, int dtype, int vec,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    if (vec)
      launch_rows<bf16, true>(x, w, y, rows, d, ldx, ldy, eps, s);
    else
      launch_rows<bf16, false>(x, w, y, rows, d, ldx, ldy, eps, s);
  } else {
    if (vec)
      launch_rows<float, true>(x, w, y, rows, d, ldx, ldy, eps, s);
    else
      launch_rows<float, false>(x, w, y, rows, d, ldx, ldy, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING
