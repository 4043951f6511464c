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
// The same GEMM pair, with other epilogues, is the halo mask of the mega
// kernel's do_halo flag (polyblur_fused.py:288-302, :503-512): once per
// call the input tiles' gradients and the per-plane sum nM of
// |grad|^2 (`pb_halo_gemm` epi 1; the TPU hoists them when they fit VMEM,
// here they always fit device memory), then per iteration the gradients
// of the output o fed straight into the mask, clip, noise and store
// (epi 2), so the output gradients never leave registers.
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

// Epilogues of the derivative GEMM pair (gx = g Dw^T, gy = Dh g):
//   kMaxima  the 7 directional maxima of the estimate (atomicMax per tile);
//   kGrads   the halo mask's input gradients: gx, gy written in f32, and
//            per block the partial sum of gx^2 + gy^2 (its plane's nM is
//            the sum of the partials, taken in block order);
//   kHalo    the gradient-inversion mask of the output o (the GEMM's
//            operand): M = -(gx0 gox) - (gy0 goy), z = max(M / (nM + M +
//            1e-12), 0), o + z (u - o), clipped to [0, 1], plus the
//            prefilter's noise and clipped again when given, stored in the
//            work dtype (polyblur_fused.py:503-517).
enum Epilogue { kMaxima = 0, kGrads = 1, kHalo = 2 };

struct EstGemm {
  pb::TileView src;   // the operand planes; plane p = (p / C, p % C)
  int C, ph, pw;
  const float* dw;    // (pw, pw)
  const float* dh;    // (ph, ph)
  const float* cs;    // kMaxima: (7, 2) cos, sin
  float* maxima;      // kMaxima: (n, 7)
  float* gx;          // kGrads: (planes, ph, pw) out; kHalo: gx0 in
  float* gy;          //   "  gy0
  float* part;        // kGrads: (planes, nblk) out; kHalo: in
  pb::TileView ucmp;  // kHalo: the unfiltered planes u
  int ucmp_dtype;
  const float* noise; // kHalo: (planes, ph, pw) f32 or null
  void* out;          // kHalo: (planes, ph, pw) in out_dtype
  int out_dtype;
};

template <int EPI, typename S>
__global__ void __launch_bounds__(ET) tile_est_gemm_kernel(EstGemm p) {
  // transposed A tiles padded to EB + 1 columns: conflict-free stores
  __shared__ float Ag[EK][EB + 1];  // g[y0 + i][k]
  __shared__ float Aw[EK][EB + 1];  // Dw[x0 + j][k]   (B of gx, transposed)
  __shared__ float Ah[EK][EB + 1];  // Dh[y0 + i][k]
  __shared__ float Bg[EK][EB];      // g[k][x0 + j]    (B of gy)
  __shared__ float red[ET / 32][kAngles];
  __shared__ float s_nm;
  const int ph = p.ph, pw = p.pw;
  const float* __restrict__ dw = p.dw;
  const float* __restrict__ dh = p.dh;
  const int pl = blockIdx.z;
  const int n = pl / p.C, c = pl - (pl / p.C) * p.C;
  const int y0 = blockIdx.y * EB, x0 = blockIdx.x * EB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const S* gt = static_cast<const S*>(p.src.ptr) + p.src.offset(n, c, 0, 0);
  const long long sR = p.src.sR;
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
      Ag[kk][r] =
          (yi < ph && k < pw) ? pb::to_f32(gt[(long long)yi * sR + k]) : 0.f;
      Aw[kk][r] = (xj < pw && k < pw) ? dw[(long long)xj * pw + k] : 0.f;
      Ah[kk][r] = (yi < ph && k < ph) ? dh[(long long)yi * ph + k] : 0.f;
      const int kr = k0 + e / EB, cj = x0 + e % EB;
      Bg[e / EB][e % EB] =
          (kr < ph && cj < pw) ? pb::to_f32(gt[(long long)kr * sR + cj]) : 0.f;
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
  const int warp = tid / 32, lane = tid % 32;
  const long long plane = (long long)pl * ph * pw;
  if (EPI == kGrads) {
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int y = y0 + ty + 16 * r, x = x0 + tx + 16 * s;
        if (y < ph && x < pw) {
          const long long o = plane + (long long)y * pw + x;
          p.gx[o] = ax[r][s];
          p.gy[o] = ay[r][s];
          part = __fadd_rn(part, __fadd_rn(__fmul_rn(ax[r][s], ax[r][s]),
                                           __fmul_rn(ay[r][s], ay[r][s])));
        }
      }
    for (int o = 16; o > 0; o >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    if (lane == 0) red[warp][0] = part;
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int w = 0; w < ET / 32; ++w) v = __fadd_rn(v, red[w][0]);
      const int nblk = gridDim.x * gridDim.y;
      p.part[(long long)pl * nblk + blockIdx.y * gridDim.x + blockIdx.x] = v;
    }
    return;
  }
  if (EPI == kHalo) {
    if (tid == 0) {
      const int nblk = gridDim.x * gridDim.y;
      float v = 0.f;
      for (int b = 0; b < nblk; ++b)
        v = __fadd_rn(v, p.part[(long long)pl * nblk + b]);
      s_nm = v;
    }
    __syncthreads();
    const float nm = s_nm;
    const long long ub = p.ucmp.offset(n, c, 0, 0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int y = y0 + ty + 16 * r, x = x0 + tx + 16 * s;
        if (y < ph && x < pw) {
          const long long o = plane + (long long)y * pw + x;
          const float M = __fsub_rn(-__fmul_rn(p.gx[o], ax[r][s]),
                                    __fmul_rn(p.gy[o], ay[r][s]));
          const float z = fmaxf(
              __fdiv_rn(M, __fadd_rn(__fadd_rn(nm, M), 1e-12f)), 0.f);
          const float ov = pb::to_f32(gt[(long long)y * sR + x]);
          const long long uo = ub + (long long)y * p.ucmp.sR + x;
          const float u =
              p.ucmp_dtype == pb::kBF16
                  ? pb::to_f32(static_cast<const pb::bf16*>(p.ucmp.ptr)[uo])
                  : static_cast<const float*>(p.ucmp.ptr)[uo];
          float v = __fadd_rn(ov, __fmul_rn(z, __fsub_rn(u, ov)));
          v = fminf(fmaxf(v, 0.f), 1.f);
          if (p.noise != nullptr)
            v = fminf(fmaxf(__fadd_rn(v, p.noise[o]), 0.f), 1.f);
          if (p.out_dtype == pb::kBF16)
            static_cast<pb::bf16*>(p.out)[o] = pb::from_f32<pb::bf16>(v);
          else
            static_cast<float*>(p.out)[o] = v;
        }
      }
    return;
  }
  const float* __restrict__ cs = p.cs;
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
    atomicMax(reinterpret_cast<int*>(p.maxima) + pl * kAngles + tid,
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
    EstGemm p = {};
    // the normalized gray scratch as n one-channel tiles
    p.src = pb::make_view(g, (long long)ph * pw, (long long)ph * pw, pw, n, 0,
                          1, 0, 0);
    p.C = 1;
    p.ph = ph;
    p.pw = pw;
    p.dw = dw;
    p.dh = dh;
    p.cs = cs;
    p.maxima = maxima;
    dim3 grid((pw + EB - 1) / EB, (ph + EB - 1) / EB, n);
    tile_est_gemm_kernel<kMaxima, float><<<grid, ET, 0, s>>>(p);
  } else if (stage == 3) {
    tile_est_final_kernel<<<n, 32, 0, s>>>(maxima, wts, coeffs, n, est);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The halo mask's derivative GEMM pair over the n C planes of a TileView
// (dtype `dtype`): epi 1 writes the input gradients gx, gy ((n C, ph, pw)
// f32) and the per-block partial sums `part` ((n C, nblk) f32, nblk the
// blocks per plane); epi 2 reads them back with the f32 output o as the
// operand (dtype f32), the unfiltered planes u (a TileView in
// `ucmp_dtype`) and the optional noise ((n C, ph, pw) f32), and writes the
// masked, clipped planes to `out` ((n C, ph, pw) in `out_dtype`).
extern "C" int pb_halo_gemm(int epi, int dtype, const void* ptr, long long sB,
                            long long sC, long long sR, int batch, int tile0,
                            int tiles_w, int step_h, int step_w, int n, int C,
                            int ph, int pw, const float* dw, const float* dh,
                            float* gx, float* gy, float* part,
                            int ucmp_dtype, const void* uptr, long long usB,
                            long long usC, long long usR, int ubatch,
                            int utile0, int utiles_w, int ustep_h,
                            int ustep_w, const float* noise, void* out,
                            int out_dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)n * C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  EstGemm p = {};
  p.src = pb::make_view(ptr, sB, sC, sR, batch, tile0, tiles_w, step_h,
                        step_w);
  p.C = C;
  p.ph = ph;
  p.pw = pw;
  p.dw = dw;
  p.dh = dh;
  p.gx = gx;
  p.gy = gy;
  p.part = part;
  dim3 grid((pw + EB - 1) / EB, (ph + EB - 1) / EB, n * C);
  if (epi == kGrads) {
    if (dtype == pb::kBF16)
      tile_est_gemm_kernel<kGrads, pb::bf16><<<grid, ET, 0, s>>>(p);
    else if (dtype == pb::kF32)
      tile_est_gemm_kernel<kGrads, float><<<grid, ET, 0, s>>>(p);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (epi == kHalo && dtype == pb::kF32) {
    if ((ucmp_dtype != pb::kF32 && ucmp_dtype != pb::kBF16) ||
        (out_dtype != pb::kF32 && out_dtype != pb::kBF16))
      return static_cast<int>(cudaErrorInvalidValue);
    p.ucmp = pb::make_view(uptr, usB, usC, usR, ubatch, utile0, utiles_w,
                           ustep_h, ustep_w);
    p.ucmp_dtype = ucmp_dtype;
    p.noise = noise;
    p.out = out;
    p.out_dtype = out_dtype;
    tile_est_gemm_kernel<kHalo, float><<<grid, ET, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
