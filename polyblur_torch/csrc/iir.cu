// iir: the bidirectional first-order recursive filter of the domain
// transform, along rows and along columns, and the tiles route's
// domain-transform coefficient maps.
//
// The row pass replaces polyblur_tpu/ops/pallas/iir.py::_iir_pallas_call
// (iir_scan_rows_pallas, the recurrence of _iir_kernel :76-90):
//   forward   y[i] = (1 - v[i]) x[i] + v[i] y[i-1]            (v[0] := 0)
//   backward  z[i] = (1 - v[i+1]) y[i] + v[i+1] z[i+1]        (v[W] := 0)
// The column pass is the same recurrence down the columns; it replaces the
// swapaxes + row scan of ops/domain_transform.py::recursive_filter and of
// the mega kernel's dt prefilter (polyblur_fused.py:479-483, _iir_bidi).
// dt_coeffs replaces the mega kernel's shared dt state (:436-455): the
// joint-image derivatives summed over the channels and, for one iteration
// (sigma_H = sigma_s), v = exp((1 + sigma_s / sigma_r |dI|) (-sqrt 2 / sigma_s)).
//
// The TPU runs the recurrence as a log2(W)-step Hillis-Steele composition
// of affine maps over the lane axis. Here:
//   rows     one warp per row: the row is walked in chunks of 32, each
//            chunk composed by a 5-step warp-shuffle affine scan and
//            applied to the carry of the previous chunk; forward, then
//            backward over the forward result (each lane re-reads only
//            what it wrote itself);
//   columns  one thread per column walks down the rows and back up: the
//            reads of a warp are 32 consecutive columns of one row.
// A sequential or chunked composition rounds differently from the full
// Hillis-Steele scan; the map contracts (v <= exp(-sqrt 2 / sigma_s) < 1),
// so the difference stays within a few f32 ulps of the signal.
//
// Bound on the H100: bytes — each pass reads x and v once and writes its
// output once, ~5 flops per element. Design: the row pass keeps a warp's
// reads and writes on 32 consecutive elements; the column pass has one
// thread per column, which fills only (planes x W / 32) warps (~150 at
// 2 MP RGB): its time is the latency of H dependent steps, not bandwidth.
#include "common.cuh"

namespace {

__device__ __forceinline__ void affine_compose(float& a, float& b, float ap,
                                               float bp) {
  // (a, b) o (ap, bp) = (a ap, a bp + b)
  b = __fadd_rn(__fmul_rn(a, bp), b);
  a = __fmul_rn(a, ap);
}

template <typename T>
__global__ void iir_rows_kernel(pb::TileView xv, int C, int H, int W,
                                const float* __restrict__ v, int vdiv,
                                float* __restrict__ out, int rows) {
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int p = r / H, y = r - (r / H) * H;
  const int n = p / C, c = p - (p / C) * C;
  const T* xs = static_cast<const T*>(xv.ptr) + xv.offset(n, c, y, 0);
  const float* vr = v + ((long long)(p / vdiv) * H + y) * W;
  float* o = out + ((long long)p * H + y) * W;
  float carry = 0.f;
  for (int k0 = 0; k0 < W; k0 += 32) {
    const int i = k0 + lane;
    float a = 1.f, b = 0.f;  // identity past the row's end
    if (i < W) {
      const float vi = i == 0 ? 0.f : vr[i];
      a = vi;
      b = __fmul_rn(__fsub_rn(1.f, vi), pb::to_f32(xs[i]));
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float ap = __shfl_up_sync(0xffffffffu, a, off);
      const float bp = __shfl_up_sync(0xffffffffu, b, off);
      if (lane >= off) affine_compose(a, b, ap, bp);
    }
    const float yi = __fadd_rn(__fmul_rn(a, carry), b);
    if (i < W) o[i] = yi;
    carry = __shfl_sync(0xffffffffu, yi, 31);
  }
  carry = 0.f;
  for (int k0 = ((W - 1) / 32) * 32; k0 >= 0; k0 -= 32) {
    const int i = k0 + lane;
    float a = 1.f, b = 0.f;
    if (i < W) {
      const float vs = i == W - 1 ? 0.f : vr[i + 1];
      a = vs;
      b = __fmul_rn(__fsub_rn(1.f, vs), o[i]);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float an = __shfl_down_sync(0xffffffffu, a, off);
      const float bn = __shfl_down_sync(0xffffffffu, b, off);
      if (lane + off < 32) affine_compose(a, b, an, bn);
    }
    const float zi = __fadd_rn(__fmul_rn(a, carry), b);
    if (i < W) o[i] = zi;
    carry = __shfl_sync(0xffffffffu, zi, 0);
  }
}

// x: (planes, H, W) f32; out may alias x. With `noise`, also writes
// noise = src - out, src being the (pre-filter) planes of the TileView.
template <typename T>
__global__ void iir_cols_kernel(const float* __restrict__ x, int H, int W,
                                const float* __restrict__ v, int vdiv,
                                float* out, pb::TileView src, int C,
                                float* __restrict__ noise) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  if (col >= W) return;
  const long long plane = (long long)p * H * W;
  const float* xs = x + plane + col;
  const float* vs = v + (long long)(p / vdiv) * H * W + col;
  float* os = out + plane + col;
  float yv = 0.f;
  for (int i = 0; i < H; ++i) {
    const float vi = i == 0 ? 0.f : vs[(long long)i * W];
    yv = __fadd_rn(__fmul_rn(__fsub_rn(1.f, vi), xs[(long long)i * W]),
                   __fmul_rn(vi, yv));
    os[(long long)i * W] = yv;
  }
  float zv = 0.f;
  const int n = p / C, c = p - (p / C) * C;
  const T* sp = noise != nullptr
                    ? static_cast<const T*>(src.ptr) + src.offset(n, c, 0, col)
                    : nullptr;
  for (int i = H - 1; i >= 0; --i) {
    const float vi = i == H - 1 ? 0.f : vs[(long long)(i + 1) * W];
    zv = __fadd_rn(__fmul_rn(__fsub_rn(1.f, vi), os[(long long)i * W]),
                   __fmul_rn(vi, zv));
    os[(long long)i * W] = zv;
    if (noise != nullptr)
      noise[plane + (long long)i * W + col] =
          __fsub_rn(pb::to_f32(sp[(long long)i * src.sR]), zv);
  }
}

// v_h, v_v: (n, H, W) f32 from the n tiles of C channels of the TileView;
// coeffs[6], coeffs[7] = sigma_s, sigma_r.
template <typename T>
__global__ void dt_coeffs_kernel(pb::TileView xv, int C, int H, int W,
                                 const float* __restrict__ coeffs,
                                 float* __restrict__ v_h,
                                 float* __restrict__ v_v) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  if (x >= W) return;
  const float sigma_s = coeffs[6], sigma_r = coeffs[7];
  const float ratio = __fdiv_rn(sigma_s, sigma_r);
  const float log_a = __fdiv_rn(-1.41421356237309515f, sigma_s);
  const T* src = static_cast<const T*>(xv.ptr);
  float dx = 0.f, dy = 0.f;
  for (int c = 0; c < C; ++c) {
    const long long o = xv.offset(n, c, y, x);
    const float f = pb::to_f32(src[o]);
    if (x > 0) dx = __fadd_rn(dx, fabsf(__fsub_rn(f, pb::to_f32(src[o - 1]))));
    if (y > 0)
      dy = __fadd_rn(dy, fabsf(__fsub_rn(f, pb::to_f32(src[o - xv.sR]))));
  }
  const float dh = x > 0 ? __fadd_rn(__fmul_rn(ratio, dx), 1.f) : 1.f;
  const float dv = y > 0 ? __fadd_rn(__fmul_rn(ratio, dy), 1.f) : 1.f;
  const long long o = ((long long)n * H + y) * W + x;
  v_h[o] = expf(__fmul_rn(dh, log_a));
  v_v[o] = expf(__fmul_rn(dv, log_a));
}

}  // namespace

// Row pass over the n C H rows of the TileView's (n, C, H, W) planes;
// v: (planes / vdiv, H, W) f32 (vdiv = C shares one map across a tile's
// channels); out: (n C, H, W) f32.
extern "C" int pb_iir_rows(int dtype, const void* ptr, long long sB,
                           long long sC, long long sR, int batch, int tile0,
                           int tiles_w, int step_h, int step_w, int n, int C,
                           int H, int W, const float* v, int vdiv, float* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const pb::TileView xv = pb::make_view(ptr, sB, sC, sR, batch, tile0,
                                        tiles_w, step_h, step_w);
  const long long rows = (long long)n * C * H;
  const int warps = 8;
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > 2147483647LL || vdiv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == pb::kBF16)
    iir_rows_kernel<pb::bf16><<<(unsigned)blocks, warps * 32, 0, s>>>(
        xv, C, H, W, v, vdiv, out, (int)rows);
  else if (dtype == pb::kF32)
    iir_rows_kernel<float><<<(unsigned)blocks, warps * 32, 0, s>>>(
        xv, C, H, W, v, vdiv, out, (int)rows);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Column pass over (planes, H, W) f32 x (out may alias x); v as the rows.
// noise (optional, f32 (planes, H, W)) = src - out, src the TileView's
// planes (plane p = tile p / C, channel p % C) in `src_dtype`.
extern "C" int pb_iir_cols(const float* x, int planes, int H, int W,
                           const float* v, int vdiv, float* out,
                           int src_dtype, const void* ptr, long long sB,
                           long long sC, long long sR, int batch, int tile0,
                           int tiles_w, int step_h, int step_w, int C,
                           float* noise, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes > 65535 || vdiv < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const pb::TileView src = pb::make_view(ptr, sB, sC, sR, batch, tile0,
                                         tiles_w, step_h, step_w);
  const int threads = 128;
  dim3 grid((W + threads - 1) / threads, planes);
  if (src_dtype == pb::kBF16)
    iir_cols_kernel<pb::bf16><<<grid, threads, 0, s>>>(x, H, W, v, vdiv, out,
                                                       src, C, noise);
  else if (src_dtype == pb::kF32)
    iir_cols_kernel<float><<<grid, threads, 0, s>>>(x, H, W, v, vdiv, out,
                                                    src, C, noise);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// v_h, v_v: (n, H, W) f32 maps of the n tiles of the TileView.
extern "C" int pb_dt_coeffs(int dtype, const void* ptr, long long sB,
                            long long sC, long long sR, int batch, int tile0,
                            int tiles_w, int step_h, int step_w, int n, int C,
                            int H, int W, const float* coeffs, float* v_h,
                            float* v_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const pb::TileView xv = pb::make_view(ptr, sB, sC, sR, batch, tile0,
                                        tiles_w, step_h, step_w);
  const int threads = 128;
  dim3 grid((W + threads - 1) / threads, H, n);
  if (dtype == pb::kBF16)
    dt_coeffs_kernel<pb::bf16><<<grid, threads, 0, s>>>(xv, C, H, W, coeffs,
                                                        v_h, v_v);
  else if (dtype == pb::kF32)
    dt_coeffs_kernel<float><<<grid, threads, 0, s>>>(xv, C, H, W, coeffs, v_h,
                                                     v_v);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
