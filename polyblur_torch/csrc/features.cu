// features: the edgetaper weights of the mega kernel's feature flags.
//
// Replaces the do_taper weights of polyblur_tpu/ops/pallas/polyblur_fused.py::
// _make_kernel (blend, DMA and tiles modes, :374-433):
//   taper_weights  per tile, the taper weight vectors of the iteration's
//                  estimated kernel: the 25 x 25 sampled kernel from its
//                  quadratic form (qa, qb, qc), its two axis projections
//                  (normalized by the kernel's sum), their 25-lag linear
//                  autocorrelations, and
//                    av[i] = 1 - (acy[i] + acy[h-1-i]) / acy[0]   (i < h)
//                    ah[j] = 1 - (acx[j] + acx[wc-1-j]) / acx[0]  (j < wc)
//                  (a lag past 24 contributes 0) — the circular
//                  autocorrelation over length n-1 of edgetaper.py:10-23,
//                  divided per tile by its lag 0 as the TPU kernel does.
// The three blends xc = a u + (1 - a) Ku with a = av[i] ah[j] (:493-498)
// run in the epilogue of their blur's last product (spectral.cu, mode 4
// with kTaper): the TPU program keeps the (h, wc) canvas and the weight
// map in VMEM; here the canvas lives in device memory in f32 between the
// applications, K u never leaves the registers and the weight map is
// never formed (the epilogue reads the two vectors).
//
// Bound on the H100: a few thousand flops and ~4 KB of output per tile;
// a launch's latency. Design: one block per tile; the 625 taps in
// parallel, their sum in one thread (the plain version's order), the
// projections and lags one thread each.
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
