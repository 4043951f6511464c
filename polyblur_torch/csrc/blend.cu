// blend_overlap_add: windowed overlap-add of a restored tile batch into the
// cropped output image.
//
// Replaces the blend of polyblur_tpu/ops/pallas/polyblur_fused.py
// (_make_kernel's blend branch, the carried row/column/corner strips) and
// polyblur_tpu/ops/pallas/overlap_add.py::overlap_add_fused. The TPU blend
// carries neighbour strips across grid programs that run in order; CUDA
// blocks run in no order, so this is the gather form instead: each output
// pixel reads the tiles covering it (at most 2 x 2 for overlaps up to
// 50%), times the window, sums in f32 in the TPU kernel's order (own tile,
// left, top, top-left), multiplies by the host-computed reciprocal window
// sum, clips to [0, 1] and writes the output dtype. The crop to the
// original image is folded in.
//
// Bound on the H100: bytes (each tile element read once, the reciprocal
// window sum once, the output written once). Design: a thread owns 8
// consecutive output columns of one row for all C channels. When the tile
// step, the tile width and the left crop are multiples of 8, the 8 columns
// lie in the same tiles at a 16-byte-aligned offset, so the covering tiles
// are found once per group and every access is 16 bytes wide: tile values
// (8 bf16, or 2 x 4 f32), the window (2 x float4), the reciprocal window
// sum (2 x float4, once for all channels) and the output (16-byte stores
// where the output rows are 16-byte aligned). Other geometries, and the
// last group of a row when the width is no multiple of 8, take the
// kernel's scalar path, one column per thread; both paths round alike.
//
// blend_backward_kernel: the tiles' gradient of the same blend. It replaces
// no TPU kernel (the JAX package's overlap_add.py defines no VJP): it was
// added for training through the patch route, in place of autograd of the
// plain blend, whose index gathers differentiate into a sort and an index
// scatter over every tile element. The adjoint of the blend is a gather:
// each tile element lies at one canvas pixel, and its gradient is that
// pixel's output gradient where the clip passed it (0 <= p <= 1, p
// recomputed in the forward's order and rounding), times the reciprocal
// window sum, times the window, rounded once to the tile dtype; tile
// elements outside the crop get 0. That is autograd of the plain blend bit
// for bit: the scatter's other terms and the zeros it starts from are +0,
// so adding them only turns a -0 into +0, which the kernel does with one
// add of +0.
//
// Bound on the H100: bytes (each tile element read once, to recompute p,
// and its gradient written once; the output gradient and the reciprocal
// window sum read once). Design: as the forward's, over the whole canvas
// rather than the crop, so the margins are zeroed in the same launch: a
// thread owns V consecutive canvas columns of one row for all C channels,
// finds their covering tiles once, sums p from them, then writes each
// covering tile's V gradients. V is 4 where the tile step and width are
// multiples of 4 (upstream's 400 px / step 300 grid: 8-byte bf16, 16-byte
// f32 accesses), else 1. No 8-column path: on the H100 it ran 2.7% faster
// on the 448 / 384 grid at 12 MP and 0.3-1.6% slower at 2 MP, and no
// benchmark cell trains on that grid.
#include "common.cuh"

namespace {

using pb::bf16;

constexpr int kCols = 8;       // output columns per thread
constexpr int kThreads = 128;

// 8 consecutive values as f32, from a 16-byte-aligned address
__device__ __forceinline__ void load8(const float* p, float v[kCols]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float v[kCols]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kCols]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float v[kCols]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// Output column x of row y (canvas row Y) of image b, all channels: the
// kernel's scalar path.
template <typename TI, typename TO>
__device__ __forceinline__ void blend_column(
    const TI* __restrict__ tiles, const float* __restrict__ win,
    const float* __restrict__ inv_row, TO* __restrict__ out, int B, int C,
    int th, int tw, int sh, int sw, int ph, int pw, int Y, int pl, int h,
    int w, int y, int b, int x) {
  const long long plane = (long long)ph * pw;
  const int X = x + pl;
  const int ki0 = Y / sh, kj0 = X / sw;
  const float inv = inv_row[x];
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
    for (int ki = ki0; ki >= 0 && Y - ki * sh < ph; --ki) {
      if (ki >= th) continue;
      const int ly = Y - ki * sh;
      for (int kj = kj0; kj >= 0 && X - kj * sw < pw; --kj) {
        if (kj >= tw) continue;
        const int off = ly * pw + X - kj * sw;
        const long long t = ((long long)(ki * tw + kj) * B + b) * C + c;
        acc = __fadd_rn(acc, __fmul_rn(pb::to_f32(tiles[t * plane + off]),
                                       win[off]));
      }
    }
    out[((long long)(b * C + c) * h + y) * w + x] =
        pb::from_f32<TO>(clip01(__fmul_rn(acc, inv)));
  }
}

// Grid (column groups / kThreads, h, B). vec: the 8-column groups are
// tile-uniform and 16-byte aligned in tiles, window and inv_wsum (step,
// tile width and left crop multiples of 8, Wc of 4, aligned pointers),
// and each thread takes 8 consecutive columns; else each thread takes one
// column, the scalar path. vec_out: the output rows are 16-byte aligned
// too.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
blend_kernel(const TI* __restrict__ tiles, const float* __restrict__ win,
             const float* __restrict__ inv_wsum, TO* __restrict__ out, int B,
             int C, int th, int tw, int sh, int sw, int ph, int pw, int Wc,
             int pt, int pl, int h, int w, int vec, int vec_out) {
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int Y = y + pt;
  const float* inv_row = inv_wsum + (long long)Y * Wc + pl;
  if (!vec) {
    const int x = blockIdx.x * kThreads + threadIdx.x;
    if (x < w)
      blend_column(tiles, win, inv_row, out, B, C, th, tw, sh, sw, ph, pw, Y,
                   pl, h, w, y, b, x);
    return;
  }
  const int x0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (x0 >= w) return;
  if (x0 + kCols > w) {  // the last group of a row: no whole 8 columns
    for (int x = x0; x < w; ++x)
      blend_column(tiles, win, inv_row, out, B, C, th, tw, sh, sw, ph, pw, Y,
                   pl, h, w, y, b, x);
    return;
  }
  const long long plane = (long long)ph * pw;
  const int X0 = x0 + pl;
  const int ki0 = Y / sh, kj0 = X0 / sw;
  float inv[kCols];
  load8(inv_row + x0, inv);
  for (int c = 0; c < C; ++c) {
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
    for (int ki = ki0; ki >= 0 && Y - ki * sh < ph; --ki) {
      if (ki >= th) continue;
      const int ly = Y - ki * sh;
      for (int kj = kj0; kj >= 0 && X0 - kj * sw < pw; --kj) {
        if (kj >= tw) continue;
        const int off = ly * pw + X0 - kj * sw;
        const long long t = ((long long)(ki * tw + kj) * B + b) * C + c;
        float v[kCols], wv[kCols];
        load8(tiles + t * plane + off, v);
        load8(win + off, wv);
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], wv[i]));
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      acc[i] = clip01(__fmul_rn(acc[i], inv[i]));
    TO* dst = out + ((long long)(b * C + c) * h + y) * w + x0;
    if (vec_out) {
      store8(dst, acc);
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i) dst[i] = pb::from_f32<TO>(acc[i]);
    }
  }
}

// V consecutive values as f32 from, or to, an address aligned to V
// elements (V = 4 or 1)
template <int V>
__device__ __forceinline__ void loadv(const float* p, float v[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void loadv(const bf16* p, float v[V]) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void storev(float* p, const float v[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void storev(bf16* p, const float v[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const unsigned*>(&a),
                   *reinterpret_cast<const unsigned*>(&b));
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// Grid (column groups / kThreads, canvas rows, B): the thread's V columns
// from X0 of canvas row Y, every channel. The V columns lie in the same
// tiles (the step and tile width are multiples of V) and at V-aligned
// addresses of tiles, window and inv_wsum (Wc a multiple of V). vec_out:
// the output gradient's rows are V-aligned too
// (width and left crop multiples of V, aligned pointer); else it is read
// a column at a time.
template <typename TI, typename TO, int V>
__global__ void __launch_bounds__(kThreads)
blend_backward_kernel(const TI* __restrict__ tiles,
                      const float* __restrict__ win,
                      const float* __restrict__ inv_wsum,
                      const TO* __restrict__ gout, TI* __restrict__ gtiles,
                      int B, int C, int th, int tw, int sh, int sw, int ph,
                      int pw, int Wc, int pt, int pl, int h, int w,
                      int vec_out) {
  const int Y = blockIdx.y;
  const int b = blockIdx.z;
  const int X0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (X0 >= (tw - 1) * sw + pw) return;
  const long long plane = (long long)ph * pw;
  const int ki0 = Y / sh, kj0 = X0 / sw;
  const int y = Y - pt, x0 = X0 - pl;
  const bool row_in = y >= 0 && y < h;
  bool in[V];
  bool any = false, all = true;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    in[i] = row_in && x0 + i >= 0 && x0 + i < w;
    any = any || in[i];
    all = all && in[i];
  }
  float inv[V];
  if (all) {
    loadv<V>(inv_wsum + (long long)Y * Wc + X0, inv);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      inv[i] = in[i] ? inv_wsum[(long long)Y * Wc + X0 + i] : 0.f;
  }
  for (int c = 0; c < C; ++c) {
    // gi: the output gradient where the clip passed it, times inv; 0
    // outside the crop
    float gi[V];
#pragma unroll
    for (int i = 0; i < V; ++i) gi[i] = 0.f;
    if (any) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      for (int ki = ki0; ki >= 0 && Y - ki * sh < ph; --ki) {
        if (ki >= th) continue;
        const int ly = Y - ki * sh;
        for (int kj = kj0; kj >= 0 && X0 - kj * sw < pw; --kj) {
          if (kj >= tw) continue;
          const int off = ly * pw + X0 - kj * sw;
          const long long t = ((long long)(ki * tw + kj) * B + b) * C + c;
          float v[V], wv[V];
          loadv<V>(tiles + t * plane + off, v);
          loadv<V>(win + off, wv);
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], wv[i]));
        }
      }
      const TO* grow = gout + ((long long)(b * C + c) * h + y) * w + x0;
      float g[V];
      if (all && vec_out) {
        loadv<V>(grow, g);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) g[i] = in[i] ? pb::to_f32(grow[i]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float p = __fmul_rn(acc[i], inv[i]);
        const bool pass = p >= 0.f && p <= 1.f;  // false on NaN, as torch
        gi[i] = in[i] ? __fmul_rn(pass ? g[i] : 0.f, inv[i]) : 0.f;
      }
    }
    for (int ki = ki0; ki >= 0 && Y - ki * sh < ph; --ki) {
      if (ki >= th) continue;
      const int ly = Y - ki * sh;
      for (int kj = kj0; kj >= 0 && X0 - kj * sw < pw; --kj) {
        if (kj >= tw) continue;
        const int off = ly * pw + X0 - kj * sw;
        const long long t = ((long long)(ki * tw + kj) * B + b) * C + c;
        float wv[V], r[V];
        loadv<V>(win + off, wv);
#pragma unroll
        for (int i = 0; i < V; ++i)
          r[i] = __fadd_rn(__fmul_rn(gi[i], wv[i]), 0.f);
        storev<V>(gtiles + t * plane + off, r);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <typename TI, typename TO>
void launch(const void* tiles, const float* win, const float* inv_wsum,
            void* out, int B, int C, int th, int tw, int sh, int sw, int ph,
            int pw, int Wc, int pt, int pl, int h, int w, cudaStream_t s) {
  const int vec = sw % kCols == 0 && pw % kCols == 0 && pl % kCols == 0 &&
                  Wc % 4 == 0 && aligned16(tiles) && aligned16(win) &&
                  aligned16(inv_wsum);
  const int vec_out =
      (static_cast<long long>(w) * sizeof(TO)) % 16 == 0 && aligned16(out);
  const int groups = vec ? (w + kCols - 1) / kCols : w;
  dim3 grid((groups + kThreads - 1) / kThreads, h, B);
  blend_kernel<TI, TO><<<grid, kThreads, 0, s>>>(
      static_cast<const TI*>(tiles), win, inv_wsum, static_cast<TO*>(out), B,
      C, th, tw, sh, sw, ph, pw, Wc, pt, pl, h, w, vec, vec_out);
}

template <typename TI, typename TO, int V>
void launch_backward_v(const void* tiles, const float* win,
                       const float* inv_wsum, const void* gout, void* gtiles,
                       int B, int C, int th, int tw, int sh, int sw, int ph,
                       int pw, int Wc, int pt, int pl, int h, int w,
                       cudaStream_t s) {
  const int vec_out = w % V == 0 && pl % V == 0 && aligned16(gout);
  const int groups = ((tw - 1) * sw + pw) / V;
  dim3 grid((groups + kThreads - 1) / kThreads, (th - 1) * sh + ph, B);
  blend_backward_kernel<TI, TO, V><<<grid, kThreads, 0, s>>>(
      static_cast<const TI*>(tiles), win, inv_wsum,
      static_cast<const TO*>(gout), static_cast<TI*>(gtiles), B, C, th, tw,
      sh, sw, ph, pw, Wc, pt, pl, h, w, vec_out);
}

template <typename TI, typename TO>
void launch_backward(const void* tiles, const float* win,
                     const float* inv_wsum, const void* gout, void* gtiles,
                     int B, int C, int th, int tw, int sh, int sw, int ph,
                     int pw, int Wc, int pt, int pl, int h, int w,
                     cudaStream_t s) {
  const bool aligned = aligned16(tiles) && aligned16(win) &&
                       aligned16(inv_wsum) && aligned16(gtiles) &&
                       Wc % 4 == 0;
  if (aligned && sw % 4 == 0 && pw % 4 == 0)
    launch_backward_v<TI, TO, 4>(tiles, win, inv_wsum, gout, gtiles, B, C,
                                 th, tw, sh, sw, ph, pw, Wc, pt, pl, h, w, s);
  else
    launch_backward_v<TI, TO, 1>(tiles, win, inv_wsum, gout, gtiles, B, C,
                                 th, tw, sh, sw, ph, pw, Wc, pt, pl, h, w, s);
}

}  // namespace

// tiles: (th*tw*B, C, ph, pw) contiguous, tile-major then image;
// win: (ph, pw) f32; inv_wsum: (Hc, Wc) f32 over the padded canvas;
// out: (B, C, h, w) = canvas[pt:pt+h, pl:pl+w] of the blend.
extern "C" int pb_blend(const void* tiles, int in_dtype, const float* win,
                        const float* inv_wsum, void* out, int out_dtype,
                        int B, int C, int th, int tw, int sh, int sw, int ph,
                        int pw, int Wc, int pt, int pl, int h, int w,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == pb::kBF16 && out_dtype == pb::kF32)
    launch<bf16, float>(tiles, win, inv_wsum, out, B, C, th, tw, sh, sw, ph,
                        pw, Wc, pt, pl, h, w, s);
  else if (in_dtype == pb::kBF16 && out_dtype == pb::kBF16)
    launch<bf16, bf16>(tiles, win, inv_wsum, out, B, C, th, tw, sh, sw, ph,
                       pw, Wc, pt, pl, h, w, s);
  else if (in_dtype == pb::kF32 && out_dtype == pb::kF32)
    launch<float, float>(tiles, win, inv_wsum, out, B, C, th, tw, sh, sw, ph,
                         pw, Wc, pt, pl, h, w, s);
  else if (in_dtype == pb::kF32 && out_dtype == pb::kBF16)
    launch<float, bf16>(tiles, win, inv_wsum, out, B, C, th, tw, sh, sw, ph,
                        pw, Wc, pt, pl, h, w, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The tiles' gradient of pb_blend: tiles, win, inv_wsum and the geometry as
// there (Hc = (th-1)*sh + ph, Wc its row stride); gout: (B, C, h, w) in the
// output dtype, contiguous; gtiles: like tiles, every element written.
extern "C" int pb_blend_backward(const void* tiles, int in_dtype,
                                 const float* win, const float* inv_wsum,
                                 const void* gout, int out_dtype,
                                 void* gtiles, int B, int C, int th, int tw,
                                 int sh, int sw, int ph, int pw, int Wc,
                                 int pt, int pl, int h, int w,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((th - 1) * sh + ph > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == pb::kBF16 && out_dtype == pb::kF32)
    launch_backward<bf16, float>(tiles, win, inv_wsum, gout, gtiles, B, C,
                                 th, tw, sh, sw, ph, pw, Wc, pt, pl, h, w, s);
  else if (in_dtype == pb::kBF16 && out_dtype == pb::kBF16)
    launch_backward<bf16, bf16>(tiles, win, inv_wsum, gout, gtiles, B, C,
                                th, tw, sh, sw, ph, pw, Wc, pt, pl, h, w, s);
  else if (in_dtype == pb::kF32 && out_dtype == pb::kF32)
    launch_backward<float, float>(tiles, win, inv_wsum, gout, gtiles, B, C,
                                  th, tw, sh, sw, ph, pw, Wc, pt, pl, h, w,
                                  s);
  else if (in_dtype == pb::kF32 && out_dtype == pb::kBF16)
    launch_backward<float, bf16>(tiles, win, inv_wsum, gout, gtiles, B, C,
                                 th, tw, sh, sw, ph, pw, Wc, pt, pl, h, w, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
