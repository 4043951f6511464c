// tile_estimate: per-tile blind blur estimate of the patch engine.
//
// Replaces the estimation stage of the TPU mega kernel,
// polyblur_tpu/ops/pallas/polyblur_fused.py::_make_kernel (:320-360): gray
// channel mean, min/max normalization, the two spectral-derivative
// products, the 7 directional gradient maxima, Keys interpolation to 30
// angles, first-minimum argmin, the orthogonal magnitude, and the clamped
// affine (sigma^2, rho^2) model with the quadratic form (qa, qb, qc).
//
// The TPU program keeps the whole tile in VMEM; a 448 px tile's f32
// gradient fields do not fit an SM's shared memory, so the stage runs as
// three launches over the tile batch:
//   (1) tile_gray_norm   one block per tile: gray = mean over channels,
//                        block-reduced min/max, normalized gray g written
//                        to an f32 scratch; zeroes the tile's 7 maxima;
//   (2) tile_est_gemm    gx = g Dw^T and gy = Dh g as one hand-tiled f32
//                        GEMM pair over the same 64 x 64 output block; the
//                        epilogue reduces max |cos t gx - sin t gy| for the
//                        7 angles and atomicMax-es the float bits (valid:
//                        the values are >= 0);
//   (3) tile_est_final   one warp per tile: interpolation, argmin, model.
//
// Stages (1)-(2) alone are also the directional-maxima reduction of the
// whole-image estimate, replacing polyblur_tpu/ops/pallas/est_fused.py::
// directional_maxima_pallas (the (B, 7) maxima of the normalized channel
// mean, for C = 1 or 3): the wrapper ops/cuda/est_fused.py launches stages
// 1 and 2 and reads `maxima`. Stage (1) is one block per image, so at
// B = 1 it runs on one SM: correct, and slow at whole-image sizes (a split
// reduction is later work).
//
// Bound on the H100: operations — 2 * ph^3 f32 MACs per tile in (2)
// against the 67 TFLOP/s f32 rate (the products stay f32, as in the TPU
// kernel's f32 estimation path); (1) and (3) are small. Design: (2) is a
// shared-memory tiled FMA GEMM (4 x 4 outputs per thread for both gx and
// gy), the maxima never leave registers except for one atomic per angle
// and block.
#include "common.cuh"

namespace {

constexpr int kAngles = 7;   // n_angles + 1
constexpr int kInterp = 30;  // n_interpolated_angles

template <typename T>
__global__ void tile_gray_norm_kernel(pb::TileView v, int C, int ph, int pw,
                                      float* __restrict__ g,
                                      float* __restrict__ maxima) {
  const int n = blockIdx.x;
  const T* src = static_cast<const T*>(v.ptr);
  const int npx = ph * pw;
  const float inv_c = 1.0f / static_cast<float>(C);
  __shared__ float smin[32], smax[32];
  float lo = __int_as_float(0x7f800000), hi = -__int_as_float(0x7f800000);
  for (int e = threadIdx.x; e < npx; e += blockDim.x) {
    const int y = e / pw, x = e - (e / pw) * pw;
    float gray = pb::to_f32(src[v.offset(n, 0, y, x)]);
    for (int c = 1; c < C; ++c)
      gray = __fadd_rn(gray, pb::to_f32(src[v.offset(n, c, y, x)]));
    gray = __fmul_rn(gray, inv_c);
    lo = fminf(lo, gray);
    hi = fmaxf(hi, gray);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    smin[warp] = lo;
    smax[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    lo = lane < nw ? smin[lane] : __int_as_float(0x7f800000);
    hi = lane < nw ? smax[lane] : -__int_as_float(0x7f800000);
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      smin[0] = lo;
      smax[0] = hi;
    }
  }
  __syncthreads();
  const float vmin = smin[0];
  const float range = fmaxf(__fsub_rn(smax[0], vmin), 1e-8f);
  float* gt = g + (long long)n * npx;
  for (int e = threadIdx.x; e < npx; e += blockDim.x) {
    const int y = e / pw, x = e - (e / pw) * pw;
    float gray = pb::to_f32(src[v.offset(n, 0, y, x)]);
    for (int c = 1; c < C; ++c)
      gray = __fadd_rn(gray, pb::to_f32(src[v.offset(n, c, y, x)]));
    gray = __fmul_rn(gray, inv_c);
    gt[e] = fminf(fmaxf(__fdiv_rn(__fsub_rn(gray, vmin), range), 0.f), 1.f);
  }
  if (threadIdx.x < kAngles) maxima[n * kAngles + threadIdx.x] = 0.f;
}

constexpr int EB = 64;   // output block edge
constexpr int EK = 16;   // k step
constexpr int ET = 256;  // threads: 16 x 16, 4 x 4 outputs each

__global__ void __launch_bounds__(ET)
tile_est_gemm_kernel(const float* __restrict__ g, const float* __restrict__ dw,
                     const float* __restrict__ dh,
                     const float* __restrict__ cs,  // (7, 2) cos, sin
                     int ph, int pw, float* __restrict__ maxima) {
  // transposed A tiles padded to EB + 1 columns: conflict-free stores
  __shared__ float Ag[EK][EB + 1];  // g[y0 + i][k]
  __shared__ float Aw[EK][EB + 1];  // Dw[x0 + j][k]   (B of gx, transposed)
  __shared__ float Ah[EK][EB + 1];  // Dh[y0 + i][k]
  __shared__ float Bg[EK][EB];      // g[k][x0 + j]    (B of gy)
  __shared__ float red[ET / 32][kAngles];
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * EB, x0 = blockIdx.x * EB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* gt = g + (long long)n * ph * pw;
  float ax[4][4], ay[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) ax[r][s] = ay[r][s] = 0.f;
  const int kmax = max(ph, pw);
  for (int k0 = 0; k0 < kmax; k0 += EK) {
#pragma unroll
    for (int q = 0; q < (EB * EK) / ET; ++q) {
      const int e = tid + q * ET;
      const int r = e / EK, kk = e % EK, k = k0 + kk;
      const int yi = y0 + r, xj = x0 + r;
      Ag[kk][r] = (yi < ph && k < pw) ? gt[(long long)yi * pw + k] : 0.f;
      Aw[kk][r] = (xj < pw && k < pw) ? dw[(long long)xj * pw + k] : 0.f;
      Ah[kk][r] = (yi < ph && k < ph) ? dh[(long long)yi * ph + k] : 0.f;
      const int kr = k0 + e / EB, cj = x0 + e % EB;
      Bg[e / EB][e % EB] =
          (kr < ph && cj < pw) ? gt[(long long)kr * pw + cj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < EK; ++kk) {
      float a1[4], a2[4], b1[4], b2[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a1[r] = Ag[kk][ty + 16 * r];
        a2[r] = Ah[kk][ty + 16 * r];
        b1[r] = Aw[kk][tx + 16 * r];
        b2[r] = Bg[kk][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          ax[r][s] = fmaf(a1[r], b1[s], ax[r][s]);
          ay[r][s] = fmaf(a2[r], b2[s], ay[r][s]);
        }
    }
    __syncthreads();
  }
  float m[kAngles];
#pragma unroll
  for (int a = 0; a < kAngles; ++a) m[a] = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (y0 + ty + 16 * r < ph && x0 + tx + 16 * s < pw) {
#pragma unroll
        for (int a = 0; a < kAngles; ++a) {
          const float d = __fsub_rn(__fmul_rn(cs[2 * a], ax[r][s]),
                                    __fmul_rn(cs[2 * a + 1], ay[r][s]));
          m[a] = fmaxf(m[a], fabsf(d));
        }
      }
    }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int a = 0; a < kAngles; ++a) {
    float v = m[a];
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[warp][a] = v;
  }
  __syncthreads();
  if (tid < kAngles) {
    float v = 0.f;
    for (int w = 0; w < ET / 32; ++w) v = fmaxf(v, red[w][tid]);
    // non-negative floats order like their bit patterns
    atomicMax(reinterpret_cast<int*>(maxima) + n * kAngles + tid,
              __float_as_int(v));
  }
}

// est row: [idx, mn, mo, sigma2, rho2, qa, qb, qc]
__global__ void tile_est_final_kernel(const float* __restrict__ maxima,
                                      const float* __restrict__ wts,  // (30, 7)
                                      const float* __restrict__ coeffs,
                                      int N, float* __restrict__ est) {
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  float v = 1e30f;
  if (lane < kInterp) {
    v = 0.f;
    for (int j = 0; j < kAngles; ++j)
      v = __fadd_rn(v, __fmul_rn(maxima[n * kAngles + j],
                                 wts[lane * kAngles + j]));
  }
  float mn = v;
  for (int o = 16; o > 0; o >>= 1)
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  int idx = v <= mn ? lane : 1000;  // first minimum, as torch.argmin
  for (int o = 16; o > 0; o >>= 1)
    idx = min(idx, __shfl_xor_sync(0xffffffffu, idx, o));
  const int io = (idx + kInterp / 2) % kInterp;
  const float mo = __shfl_sync(0xffffffffu, v, io);
  if (lane != 0) return;
  const float cc = __fmul_rn(coeffs[4], coeffs[4]);
  const float bb = __fmul_rn(coeffs[5], coeffs[5]);
  const float s2 = __fsub_rn(__fdiv_rn(cc, __fadd_rn(__fmul_rn(mn, mn), 1e-8f)), bb);
  const float r2 = __fsub_rn(__fdiv_rn(cc, __fadd_rn(__fmul_rn(mo, mo), 1e-8f)), bb);
  const float sigma2 = fminf(fmaxf(s2, 0.09f), 16.f);
  const float rho2 = fminf(fmaxf(r2, 0.09f), 16.f);
  const float deg6 = static_cast<float>(6.0 * 3.141592653589793 / 180.0);
  const float theta = __fmul_rn(static_cast<float>(idx), deg6);
  const float ct = cosf(-theta), st = sinf(-theta);
  const float il1 = __fdiv_rn(1.f, sigma2), il2 = __fdiv_rn(1.f, rho2);
  const float cc2 = __fmul_rn(ct, ct), ss2 = __fmul_rn(st, st);
  float* e = est + n * 8;
  e[0] = static_cast<float>(idx);
  e[1] = mn;
  e[2] = mo;
  e[3] = sigma2;
  e[4] = rho2;
  e[5] = __fadd_rn(__fmul_rn(cc2, il1), __fmul_rn(ss2, il2));
  e[6] = __fmul_rn(__fmul_rn(st, ct), __fsub_rn(il1, il2));
  e[7] = __fadd_rn(__fmul_rn(cc2, il2), __fmul_rn(ss2, il1));
}

}  // namespace

// view: the n tiles (canvas or tile batch, dtype `dtype`); g: (n, ph, pw)
// f32 scratch; maxima: (n, 7) f32 scratch; est: (n, 8) f32 output.
// stage selects the launch (1, 2 or 3) so the wrapper can count each; the
// directional maxima launch stages 1 and 2 only (wts, coeffs, est unused).
extern "C" int pb_tile_estimate(int stage, int dtype, const void* ptr,
                                long long sB, long long sC, long long sR,
                                int batch, int tile0, int tiles_w, int step_h,
                                int step_w, int n, int C, int ph, int pw,
                                const float* dw, const float* dh,
                                const float* cs, const float* wts,
                                const float* coeffs, float* g, float* maxima,
                                float* est, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage == 1) {
    const pb::TileView v = pb::make_view(ptr, sB, sC, sR, batch, tile0,
                                         tiles_w, step_h, step_w);
    if (dtype == pb::kBF16)
      tile_gray_norm_kernel<pb::bf16><<<n, 1024, 0, s>>>(v, C, ph, pw, g,
                                                         maxima);
    else if (dtype == pb::kF32)
      tile_gray_norm_kernel<float><<<n, 1024, 0, s>>>(v, C, ph, pw, g,
                                                      maxima);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (stage == 2) {
    dim3 grid((pw + EB - 1) / EB, (ph + EB - 1) / EB, n);
    tile_est_gemm_kernel<<<grid, ET, 0, s>>>(g, dw, dh, cs, ph, pw, maxima);
  } else if (stage == 3) {
    tile_est_final_kernel<<<n, 32, 0, s>>>(maxima, wts, coeffs, n, est);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
