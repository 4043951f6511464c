// bilateral: the 5 x 5 bilateral filter of a batch of (image, channel)
// planes, replicate-padded at the plane edges.
//
// Replaces polyblur_tpu/ops/pallas/bilateral.py::_call (bilateral_pallas,
// the math of bilateral_block :54-74) and the mega kernel's bilateral
// prefilter stage (polyblur_fused.py:475-478). Per output pixel x:
//   f_s  = exp(-(s - x)^2 / (2 sigma_c^2)) * gw[dy][dx]   over the 25 taps s
//   out  = sum f_s s / (sum f_s + 1e-5)
// with the spatial weights gw computed on the host exactly as
// bilateral_block does (float64, then cast to f32), accumulated in f32 in
// the TPU kernel's tap order (dy outer, dx inner).
//
// Bound on the H100: operations. The weights and the taps' rounded f32
// products and sums take the SM schedulers' instruction slots; the bytes
// (one input read, one or two f32 outputs written) take a third of that
// time.
//
// Design: one exponential per neighbour pair. (s - x)^2 has the same bits
// for a pair taken either way round (negation is exact) and gw is
// symmetric, so for each of the 12 offsets d of a half-neighbourhood
// ((0, 1), (0, 2), (1, -2..2), (2, -2..2)) the weight
//   F_d(r) = exp(-(P(r + d) - P(r))^2 / (2 sigma_c^2)) gw[d]
// over the replicate-clamped plane P is pixel r's weight of its tap +d and
// pixel r + d's weight of its tap -d, the same bits for both. The centre
// tap's weight is exp(0) gw = gw. That is 12 exponentials per pixel
// instead of 25, each one MUFU ex2 of an argument prescaled by log2(e) on
// the host (the accurate expf would cost 7 more instructions per weight).
// Every tap is summed in the 25-tap form's order with its rounded
// operations (__fmul_rn / __fadd_rn: no contraction).
//
// A warp owns a strip of 124 output columns (lane l holds 4 adjacent
// columns, 4 l - 2 .. 4 l + 1 of the strip, so lanes 0 and 31 carry the
// 2-column halo) and walks down its rows. Step r computes F at row r for
// the lane's 4 columns (48 exponentials) from a 3-row register window (P
// rows r .. r + 2, 2 columns of each neighbour lane by shuffles) and
// spends each weight at once: pixel (r + 2) takes its five taps of row -2
// and pixel (r + 1) its five of row -1 (the pairs (2, .) and (1, .) read at
// their source column, from the neighbour lane by a shuffle where it lies
// there), and pixel r its last fifteen. So the state carried between rows
// is the three rows' partial sums, not the weights. A warp's first two
// steps compute only the pairs its first rows need; the rows per warp are
// chosen so that every warp of a small launch is resident at once. The
// row loads are 8-byte (f32) or 4-byte (bf16) pairs where the lane's
// columns lie inside the plane and the TileView's rows keep the alignment,
// else clamped scalars; the stores move two columns to the lane on the
// left so that each lane writes 4 aligned columns: one 16-byte store of
// f32 smooth and of the noise (8 bytes of bf16) where the output width is
// a multiple of 4, else scalars. Output dtype and the noise output are
// template cases. Planes of any size run, including H or W < 5.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using pb::bf16;

constexpr int kK = 5;                          // taps per axis
constexpr int kR = kK / 2;                     // halo
constexpr int kCols = 4;                       // columns per lane
constexpr int kWin = kCols + 2 * kR;           // window columns per lane
constexpr int kStrip = 32 * kCols - 2 * kR;    // output columns per warp
constexpr int kWarps = 4;                      // warps per block
constexpr int kBlocksPerSm = 4;                // launch bounds: 128 registers
constexpr int kPairs = 12;                     // half-neighbourhood offsets
constexpr unsigned kFull = 0xffffffffu;

struct Weights {
  float w[kK * kK];
};

// pair i = (dy, dx): (0, 1), (0, 2), then (1, -2 .. 2), (2, -2 .. 2)
__host__ __device__ constexpr int pair_dy(int i) {
  return i < 2 ? 0 : 1 + (i - 2) / kK;
}
__host__ __device__ constexpr int pair_dx(int i) {
  return i < 2 ? i + 1 : (i - 2) % kK - kR;
}
__host__ __device__ constexpr int pair_of(int dy, int dx) {
  return dy == 0 ? dx - 1 : 2 + (dy - 1) * kK + dx + kR;
}

__device__ __forceinline__ void load_pair(const float* p, float& a,
                                          float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ void load_pair(const bf16* p, float& a, float& b) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}

// kCols consecutive values to an address aligned to their size
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kCols]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[kCols]) {
  unsigned u[kCols / 2];
#pragma unroll
  for (int m = 0; m < kCols / 2; ++m) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * m], v[2 * m + 1]);
    u[m] = *reinterpret_cast<const unsigned*>(&b);
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
}

// Row y (clamped) of the plane at the lane's window: its own columns xs
// (clamped) in row[kR ..], the neighbours' in row[0 .. kR) and
// row[kR + kCols ..]; by pairs where the lane's columns lie inside the plane
// and every row keeps the pairs' alignment. Every lane of the warp calls
// it (shuffles).
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src,
                                         long long sR, int H, int y,
                                         bool pairs, const int (&xs)[kCols],
                                         float (&row)[kWin]) {
  const T* rp = src + (long long)min(max(y, 0), H - 1) * sR;
  float v[kCols];
  if (pairs) {
#pragma unroll
    for (int j = 0; j < kCols; j += 2)
      load_pair(rp + xs[0] + j, v[j], v[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = pb::to_f32(rp[xs[j]]);
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) row[kR + j] = v[j];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    row[j] = __shfl_up_sync(kFull, v[kCols - kR + j], 1);
    row[kR + kCols + j] = __shfl_down_sync(kFull, v[j], 1);
  }
}

// 2^a by the MUFU (ex2.approx: relative error ~2^-22; subnormal results
// flush to 0)
__device__ __forceinline__ float ex2(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// the weight exp(-(s - x)^2 / (2 sigma_c^2)) gw of tap s for centre x, from
// k = log2(e) / (2 sigma_c^2)
__device__ __forceinline__ float weight(float s, float x, float k, float g) {
  const float d = __fsub_rn(s, x);
  return __fmul_rn(ex2(__fmul_rn(__fmul_rn(-d, d), k)), g);
}

__device__ __forceinline__ void tap(float& num, float& den, float f,
                                    float s) {
  num = __fadd_rn(num, __fmul_rn(f, s));
  den = __fadd_rn(den, f);
}

// F of pair i at lane column c (-kR .. kCols + kR - 1): own, or the
// neighbour lane's. c is a compile-time constant after unrolling; each
// (i, c) outside the lane is read once per step.
__device__ __forceinline__ float pair_at(const float (&F)[kPairs][kCols],
                                         int i, int c) {
  if (c < 0) return __shfl_up_sync(kFull, F[i][c + kCols], 1);
  if (c >= kCols) return __shfl_down_sync(kFull, F[i][c - kCols], 1);
  return F[i][c];
}

// One row step at row r: p holds P rows r, r + 1, r + 2; num/den[k] the
// partial sums of row r + k. Computes the pairs with dy >= kMinDy at row r
// and spends them: row r + 2's taps (-2, .) (its first five: the sums start
// here), row r + 1's taps (-1, .) when kMinDy <= 1, row r's other fifteen
// when kMinDy == 0.
template <int kMinDy>
__device__ __forceinline__ void pair_step(const float (&p)[3][kWin],
                                          float (&num)[3][kCols],
                                          float (&den)[3][kCols],
                                          const Weights& gw, float k) {
  float F[kPairs][kCols];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    if (pair_dy(i) < kMinDy) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      F[i][j] = weight(p[pair_dy(i)][kR + j + pair_dx(i)], p[0][kR + j], k,
                       gw.w[(kR + pair_dy(i)) * kK + kR + pair_dx(i)]);
  }
  // row r + 2, taps (-2, e): pair (2, -e) at column j + e. Its sums start
  // here: num = 0 + f s (the sign of a zero as the 25-tap form rounds it),
  // den = f (f >= +0, so 0 + f is f)
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float f = pair_at(F, pair_of(2, kR), j - kR);
    num[2][j] = __fadd_rn(0.f, __fmul_rn(f, p[0][j]));
    den[2][j] = f;
  }
#pragma unroll
  for (int e = -kR + 1; e <= kR; ++e)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      tap(num[2][j], den[2][j], pair_at(F, pair_of(2, -e), j + e),
          p[0][kR + j + e]);
  if (kMinDy <= 1) {
    // row r + 1, taps (-1, e): pair (1, -e) at column j + e
#pragma unroll
    for (int e = -kR; e <= kR; ++e)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        tap(num[1][j], den[1][j], pair_at(F, pair_of(1, -e), j + e),
            p[0][kR + j + e]);
  }
  if (kMinDy == 0) {
    // row r: taps (0, -2), (0, -1) (pairs (0, 2), (0, 1) at j - 2, j - 1),
    // the centre (weight gw), then (0, 1), (0, 2), (1, .), (2, .) at j
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      tap(num[0][j], den[0][j], pair_at(F, pair_of(0, 2), j - 2), p[0][j]);
      tap(num[0][j], den[0][j], pair_at(F, pair_of(0, 1), j - 1),
          p[0][j + 1]);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      tap(num[0][j], den[0][j], gw.w[kR * kK + kR], p[0][kR + j]);
#pragma unroll
      for (int dx = 1; dx <= kR; ++dx)
        tap(num[0][j], den[0][j], F[pair_of(0, dx)][j], p[0][kR + j + dx]);
#pragma unroll
      for (int dy = 1; dy <= kR; ++dy)
#pragma unroll
        for (int dx = -kR; dx <= kR; ++dx)
          tap(num[0][j], den[0][j], F[pair_of(dy, dx)][j],
              p[dy][kR + j + dx]);
    }
  }
}

__device__ __forceinline__ void advance(float (&p)[3][kWin],
                                        float (&num)[3][kCols],
                                        float (&den)[3][kCols]) {
#pragma unroll
  for (int c = 0; c < kWin; ++c) {
    p[0][c] = p[1][c];
    p[1][c] = p[2][c];
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    num[0][j] = num[1][j];
    num[1][j] = num[2][j];
    den[0][j] = den[1][j];
    den[1][j] = den[2][j];
  }
}

// A row of the output: the lane's aligned group of kCols columns, strip
// columns kCols l .. (its own columns kR .. and the next lane's first kR),
// of which `left` lie inside the plane; `vec`: one aligned vector store.
template <typename Tout, bool kNoise>
__device__ __forceinline__ void store_row(const float (&p)[3][kWin],
                                          const float (&num)[3][kCols],
                                          const float (&den)[3][kCols],
                                          bool active, bool vec, int left,
                                          Tout* __restrict__ so,
                                          float* __restrict__ no) {
  float o[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    o[j] = __fdiv_rn(num[0][j], __fadd_rn(den[0][j], 1e-5f));
  float g[kCols], nz[kCols];
#pragma unroll
  for (int m = 0; m < kCols - kR; ++m) g[m] = o[kR + m];
#pragma unroll
  for (int m = 0; m < kR; ++m)
    g[kCols - kR + m] = __shfl_down_sync(kFull, o[m], 1);
#pragma unroll
  for (int m = 0; m < kCols; ++m) nz[m] = __fsub_rn(p[0][2 * kR + m], g[m]);
  if (!active) return;
  if (vec) {
    store_vec(so, g);
    if (kNoise) store_vec(no, nz);
  } else {
#pragma unroll
    for (int m = 0; m < kCols; ++m)
      if (m < left) {
        so[m] = pb::from_f32<Tout>(g[m]);
        if (kNoise) no[m] = nz[m];
      }
  }
}

template <typename T, typename Tout, bool kNoise>
__global__ void __launch_bounds__(32 * kWarps, kBlocksPerSm)
bilateral_kernel(pb::TileView v, int C, int H, int W, int strips_x,
                 int strips_y, int rows, Weights gw, float k,
                 Tout* __restrict__ smooth, float* __restrict__ noise) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int sy = w / strips_x;
  if (sy >= strips_y) return;  // whole warps
  const int sx = w - sy * strips_x;
  const int plane = blockIdx.y;
  const int n = plane / C, c = plane - n * C;
  const T* src = static_cast<const T*>(v.ptr) + v.offset(n, c, 0, 0);
  const long long sR = v.sR;
  const int x0 = sx * kStrip + kCols * lane - kR;  // the lane's column 0
  int xs[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) xs[j] = min(max(x0 + j, 0), W - 1);
  const bool pairs =
      x0 >= 0 && x0 + kCols <= W && sR % 2 == 0 &&
      reinterpret_cast<uintptr_t>(src + x0) % (2 * sizeof(T)) == 0;
  const int xg = sx * kStrip + kCols * lane;  // its store group
  const bool active = kCols * lane < kStrip && xg < W;  // else the next strip's
  const int ra = sy * rows, rb = min(H, ra + rows);
  const long long o0 = ((long long)plane * H + ra) * W + xg;
  Tout* so = smooth + o0;
  float* no = kNoise ? noise + o0 : nullptr;
  const bool vec =
      xg + kCols <= W && W % kCols == 0 &&
      reinterpret_cast<uintptr_t>(smooth) % (kCols * sizeof(Tout)) == 0 &&
      (!kNoise || reinterpret_cast<uintptr_t>(noise) % (kCols * 4) == 0);
  float p[3][kWin], num[3][kCols], den[3][kCols];
  load_row(src, sR, H, ra - 2, pairs, xs, p[0]);
  load_row(src, sR, H, ra - 1, pairs, xs, p[1]);
  load_row(src, sR, H, ra, pairs, xs, p[2]);
  pair_step<2>(p, num, den, gw, k);  // row ra - 2: row ra's first taps
  advance(p, num, den);
  load_row(src, sR, H, ra + 1, pairs, xs, p[2]);
  pair_step<1>(p, num, den, gw, k);  // row ra - 1
  advance(p, num, den);
  load_row(src, sR, H, ra + 2, pairs, xs, p[2]);
  for (int y = ra; y < rb; ++y) {
    pair_step<0>(p, num, den, gw, k);
    store_row<Tout, kNoise>(p, num, den, active, vec, W - xg, so, no);
    so += W;
    if (kNoise) no += W;
    advance(p, num, den);
    load_row(src, sR, H, y + 3, pairs, xs, p[2]);
  }
}

template <typename T, typename Tout>
void launch(dim3 grid, cudaStream_t s, const pb::TileView& v, int C, int H,
            int W, int strips_x, int strips_y, int rows, const Weights& w,
            float k, void* smooth, float* noise) {
  if (noise != nullptr)
    bilateral_kernel<T, Tout, true><<<grid, 32 * kWarps, 0, s>>>(
        v, C, H, W, strips_x, strips_y, rows, w, k,
        static_cast<Tout*>(smooth), noise);
  else
    bilateral_kernel<T, Tout, false><<<grid, 32 * kWarps, 0, s>>>(
        v, C, H, W, strips_x, strips_y, rows, w, k,
        static_cast<Tout*>(smooth), nullptr);
}

template <typename T>
void launch_in(int out_dtype, dim3 grid, cudaStream_t s,
               const pb::TileView& v, int C, int H, int W, int strips_x,
               int strips_y, int rows, const Weights& w, float k,
               void* smooth, float* noise) {
  if (out_dtype == pb::kBF16)
    launch<T, bf16>(grid, s, v, C, H, W, strips_x, strips_y, rows, w, k,
                    smooth, noise);
  else
    launch<T, float>(grid, s, v, C, H, W, strips_x, strips_y, rows, w, k,
                     smooth, noise);
}

}  // namespace

// view: the n tiles / images of C channels (dtype `dtype`), (H, W) each;
// gw: the 25 host spatial weights (row dy, column dx), centrally symmetric;
// smooth: (n C, H, W) contiguous in `out_dtype`; noise: (n C, H, W) f32 or
// null.
extern "C" int pb_bilateral(int dtype, const void* ptr, long long sB,
                            long long sC, long long sR, int batch, int tile0,
                            int tiles_w, int step_h, int step_w, int n, int C,
                            int H, int W, const float* gw, float inv_var2,
                            int out_dtype, void* smooth, float* noise,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * C > 65535 || H < 1 || W < 1 ||
      (out_dtype != pb::kF32 && out_dtype != pb::kBF16) ||
      (dtype != pb::kF32 && dtype != pb::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  Weights w;
  for (int i = 0; i < kK * kK; ++i) {
    // one weight serves a pair's two taps: gw must be centrally symmetric
    if (!(gw[i] == gw[kK * kK - 1 - i]))
      return static_cast<int>(cudaErrorInvalidValue);
    w.w[i] = gw[i];
  }
  const pb::TileView v = pb::make_view(ptr, sB, sC, sR, batch, tile0, tiles_w,
                                       step_h, step_w);
  const float k = static_cast<float>(inv_var2 * 1.4426950408889634);
  // rows per warp: as few as let every warp be resident at once, between
  // 8 and 32
  const int strips_x = (W + kStrip - 1) / kStrip;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long per_plane =
      std::max(1LL, (long long)kWarps * kBlocksPerSm * sms /
                        ((long long)n * C * strips_x));
  int rows = static_cast<int>(std::min(
      32LL, std::max(8LL, ((long long)H + per_plane - 1) / per_plane)));
  const int strips_y = (H + rows - 1) / rows;
  rows = (H + strips_y - 1) / strips_y;  // even strips
  const long long warps = (long long)strips_x * strips_y;
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps), n * C);
  if (dtype == pb::kBF16)
    launch_in<bf16>(out_dtype, grid, s, v, C, H, W, strips_x, strips_y, rows,
                    w, k, smooth, noise);
  else
    launch_in<float>(out_dtype, grid, s, v, C, H, W, strips_x, strips_y,
                     rows, w, k, smooth, noise);
  return static_cast<int>(cudaGetLastError());
}
