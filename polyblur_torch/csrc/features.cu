// features: the edgetaper stages of the mega kernel's feature flags.
//
// Replaces the do_taper stages of polyblur_tpu/ops/pallas/polyblur_fused.py::
// _make_kernel (blend, DMA and tiles modes, :374-433 and :493-498):
//   taper_weights  per tile, the taper weight vectors of the iteration's
//                  estimated kernel: the 25 x 25 sampled kernel from its
//                  quadratic form (qa, qb, qc), its two axis projections
//                  (normalized by the kernel's sum), their 25-lag linear
//                  autocorrelations, and
//                    av[i] = 1 - (acy[i] + acy[h-1-i]) / acy[0]   (i < h)
//                    ah[j] = 1 - (acx[j] + acx[wc-1-j]) / acx[0]  (j < wc)
//                  (a lag past 24 contributes 0) — the circular
//                  autocorrelation over length n-1 of edgetaper.py:10-23,
//                  divided per tile by its lag 0 as the TPU kernel does;
//   taper_blend    one blend of the three: xc = a u + (1 - a) Ku with
//                  a = av[i] ah[j], where u is either the tile replicate-
//                  padded by 12 on load (the first blend) or the canvas xc
//                  itself (in place), and Ku the degree-1 application of
//                  the spectral operator (spectral.cu, unclipped, f32).
// The TPU program keeps the (h, wc) canvas and the weight map in VMEM; here
// the canvas lives in device memory in f32 between the launches (where the
// TPU keeps it in f32 too) and the weight map is never formed: the blend
// reads the two vectors.
//
// Bound on the H100: bytes — a blend reads u and Ku and writes xc once
// (12 B per canvas element in f32); the weights are a few thousand flops
// per tile. Design: one thread per canvas element, consecutive threads on
// consecutive columns; one block per tile for the weights.
#include "common.cuh"

namespace {

constexpr int kHalf = 12;
constexpr int kTaps = 2 * kHalf + 1;

// q: row n's (qa, qb, qc) at q[n * stride + off]; av: (n, h); ah: (n, wc)
__global__ void __launch_bounds__(256)
taper_weights_kernel(const float* __restrict__ q, int stride, int off, int h,
                     int wc, float* __restrict__ av, float* __restrict__ ah) {
  __shared__ float k2d[kTaps * kTaps];   // [row j][column t]
  __shared__ float k2dt[kTaps * kTaps];  // the quadratic form with x <-> y
  __shared__ float px[kTaps], py[kTaps], acx[kTaps], acy[kTaps];
  __shared__ float total;
  const int n = blockIdx.x, tid = threadIdx.x;
  const float* qn = q + (long long)n * stride + off;
  const float qa = qn[0], qb = qn[1], qc = qn[2];
  for (int e = tid; e < kTaps * kTaps; e += blockDim.x) {
    const float jf = static_cast<float>(e / kTaps - kHalf);  // row offset
    const float tf = static_cast<float>(e % kTaps - kHalf);  // column offset
    const float two_qb = __fmul_rn(2.f, qb);
    const float quad = __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(qa, tf), tf),
                  __fmul_rn(__fmul_rn(two_qb, tf), jf)),
        __fmul_rn(__fmul_rn(qc, jf), jf));
    const float quadt = __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(qc, tf), tf),
                  __fmul_rn(__fmul_rn(two_qb, tf), jf)),
        __fmul_rn(__fmul_rn(qa, jf), jf));
    k2d[e] = expf(__fmul_rn(-0.5f, quad));
    k2dt[e] = expf(__fmul_rn(-0.5f, quadt));
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int e = 0; e < kTaps * kTaps; ++e) s = __fadd_rn(s, k2d[e]);
    total = s;
  }
  __syncthreads();
  if (tid < kTaps) {
    // column sums: x-projection of k2d, y-projection through k2dt
    float sx = 0.f, sy = 0.f;
    for (int j = 0; j < kTaps; ++j) {
      sx = __fadd_rn(sx, k2d[j * kTaps + tid]);
      sy = __fadd_rn(sy, k2dt[j * kTaps + tid]);
    }
    px[tid] = __fdiv_rn(sx, total);
    py[tid] = __fdiv_rn(sy, total);
  }
  __syncthreads();
  if (tid < kTaps) {
    float sx = 0.f, sy = 0.f;
    for (int l = 0; l + tid < kTaps; ++l) {
      sx = __fadd_rn(sx, __fmul_rn(px[l], px[l + tid]));
      sy = __fadd_rn(sy, __fmul_rn(py[l], py[l + tid]));
    }
    acx[tid] = sx;
    acy[tid] = sy;
  }
  __syncthreads();
  for (int i = tid; i < h + wc; i += blockDim.x) {
    const bool vert = i < h;
    const int k = vert ? i : i - h;
    const int len = vert ? h : wc;
    const float* ac = vert ? acy : acx;
    float z = 0.f;
    for (int d = 0; d < kTaps; ++d) {
      // the TPU kernel adds two boolean masks: a logical or
      const float m = (k == d || k == len - 1 - d) ? 1.f : 0.f;
      z = __fadd_rn(z, __fmul_rn(ac[d], m));
    }
    const float w = __fsub_rn(1.f, __fdiv_rn(z, ac[0]));
    if (vert)
      av[(long long)n * h + k] = w;
    else
      ah[(long long)n * wc + k] = w;
  }
}

// xc (planes, h, wc) f32 = a u + (1 - a) ku; u = the TileView's plane
// (plane p = tile p / C, channel p % C) of (h - 2 pad, wc - 2 pad) read with
// the replicate clamp (pad 12), or xc itself (pad 0, in place).
template <typename T>
__global__ void taper_blend_kernel(pb::TileView uv, int C, int pad, int h,
                                   int wc, const float* __restrict__ av,
                                   const float* __restrict__ ah,
                                   const float* __restrict__ ku, float* xc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int p = blockIdx.z;
  if (j >= wc) return;
  const int n = p / C, c = p - (p / C) * C;
  const int uh = h - 2 * pad, uw = wc - 2 * pad;
  const int yi = min(max(i - pad, 0), uh - 1);
  const int xj = min(max(j - pad, 0), uw - 1);
  const float u = pb::to_f32(
      static_cast<const T*>(uv.ptr)[uv.offset(n, c, yi, xj)]);
  const float a = __fmul_rn(av[(long long)n * h + i], ah[(long long)n * wc + j]);
  const long long o = ((long long)p * h + i) * wc + j;
  xc[o] = __fadd_rn(__fmul_rn(a, u), __fmul_rn(__fsub_rn(1.f, a), ku[o]));
}

}  // namespace

// q: n rows of `stride` f32 with (qa, qb, qc) at column `off`; av: (n, h)
// and ah: (n, wc) f32 outputs.
extern "C" int pb_taper_weights(const float* q, int stride, int off, int n,
                                int h, int wc, float* av, float* ah,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || wc < 1) return static_cast<int>(cudaErrorInvalidValue);
  taper_weights_kernel<<<n, 256, 0, s>>>(q, stride, off, h, wc, av, ah);
  return static_cast<int>(cudaGetLastError());
}

// One taper blend over `planes` (tile, channel) planes of the (h, wc)
// canvas; u is the TileView (dtype `dtype`) padded by `pad` (12 or 0).
extern "C" int pb_taper_blend(int dtype, const void* ptr, long long sB,
                              long long sC, long long sR, int batch,
                              int tile0, int tiles_w, int step_h, int step_w,
                              int planes, int C, int pad, int h, int wc,
                              const float* av, const float* ah,
                              const float* ku, float* xc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes > 65535 || h > 65535 || h <= 2 * pad || wc <= 2 * pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const pb::TileView uv = pb::make_view(ptr, sB, sC, sR, batch, tile0,
                                        tiles_w, step_h, step_w);
  const int threads = 128;
  dim3 grid((wc + threads - 1) / threads, h, planes);
  if (dtype == pb::kBF16)
    taper_blend_kernel<pb::bf16><<<grid, threads, 0, s>>>(uv, C, pad, h, wc,
                                                          av, ah, ku, xc);
  else if (dtype == pb::kF32)
    taper_blend_kernel<float><<<grid, threads, 0, s>>>(uv, C, pad, h, wc, av,
                                                       ah, ku, xc);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
