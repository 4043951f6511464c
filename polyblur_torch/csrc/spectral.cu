// kernel_spectrum and spectral_gemm: the 2D-spectral polynomial
// deconvolution p(K) of a batch of (tile, channel) planes.
//
// kernel_spectrum replaces polyblur_tpu/ops/pallas/sep_poly_fused.py::
// _kernel_spectrum_block and the Horner/packing lines of
// polyblur_fused.py::_make_kernel (:372-373) and of sep_poly_fused.py::
// _make_kernel (:316-319): per plane, the 25 x 25 masked, normalized
// Gaussian from its quadratic form (qa, qb, qc) -> (25 x Kp) tap products
// against the x-phase tables -> (h x Kp) real OTF through the y-phase
// tables, all f32; then p(K_hat) by Horner and the packed [q | q] * (1/h)
// spectrum. The quadratic forms are read from rows of any stride (the
// (n, 8) estimate rows, or the (N, 3) params of fused_polynomial).
// Bound on the H100: operations, and tiny (~6 M f32 MACs per plane).
//
// spectral_gemm replaces sep_poly_fused.py::_spectral_poly_block, the six
// DFT products the mega kernel runs per channel per iteration, and the
// whole of sep_poly_fused.py::_make_kernel (fused_polynomial_pallas) after
// its spectrum. The TPU program holds a 472 x 472 f32 canvas, its packed
// spectra and the DFT tables in VMEM; a Hopper SM has 227 KB of shared
// memory, so the application is four batched GEMM launches over (tile,
// channel) planes with the intermediates in device memory, stored in the
// work dtype (exactly where the TPU kernel rounds its product operands):
//   mode 1  R  = pad(x) @ F                       replicate pad in the A-load
//   mode 2  P  = qhat2 * ([Cy|Sy] @ [R ; swap(R) sgn])   one K = 2h product;
//                the B-load does the half-swap and sign, the epilogue the
//                spectrum multiply (before the cast, never after)
//   mode 3  Yi = [Cy|Sy] @ [P ; -swap(P) sgn]
//   mode 4  x' = cast(clip?(crop(Yi @ G)))        only the cropped block
// The pad/crop width `half` is 12 (the patch engine, the tiles route and
// the fused whole-image polynomial pad by the kernel half-support) or 0
// (the overlap-save blocks of the blocked route, whose canvas is the block
// itself); the clip to [0, 1] is a flag (the blocked route applies p(K)
// unclipped and clips after reassembly). The feature flags of the mega
// kernel (polyblur_fused.py:473-517) use the same launches: mode 1 may read
// f32 planes (the prefilter's smooth part, the taper's canvas) and round
// them to the work dtype as it loads them, mode 4 may write f32 (the
// taper's blur K u, the output the halo mask reads) and add the
// prefilter's noise after the clip, and the pad of mode 1 and the crop of
// mode 4 are separate launch arguments (the taper pads the tile onto the
// whole canvas, then crops the canvas back).
// Accumulation is f32. bf16 operands run on the tensor cores (WMMA
// m16n16k16 fragments, the mma.sync path); f32 operands run plain f32 FMA,
// never TF32 or a bf16 split.
//
// Bound on the H100: operations — 684 M MACs per (tile, channel) plane at
// 448 px tiles, ~115 M per 280 x 240 block of the 2 MP blocked route,
// against 989 TFLOP/s dense bf16 (67 TFLOP/s f32). Design: 128 x 128
// block tiles through shared memory, 8 warps of 64 x 32; loads are
// synchronous scalar loads (no cp.async/TMA pipeline yet), which is the
// first thing a faster version changes.
#include <mma.h>

#include "common.cuh"

namespace {

using pb::bf16;

// ---------------------------------------------------------------- spectrum

constexpr int kHalf = 12;
constexpr int kTaps = 2 * kHalf + 1;
constexpr int kCols = 32;  // spectrum columns per block

// plane n's quadratic form is q[n * stride + off + 0..2] = (qa, qb, qc)
__global__ void __launch_bounds__(256)
kernel_spectrum_kernel(const float* __restrict__ q, int stride, int off,
                       const float* __restrict__ coeffs,
                       const float* __restrict__ er,   // (128, kp)
                       const float* __restrict__ ei,   // (128, kp)
                       const float* __restrict__ cyt,  // (h, 32)
                       const float* __restrict__ syt,  // (h, 32)
                       int h, int kp, float* __restrict__ qhat2) {
  __shared__ float km[kTaps * kTaps];
  __shared__ float hr[kTaps][kCols];
  __shared__ float hi[kTaps][kCols];
  __shared__ float red[8];
  const int n = blockIdx.y;
  const int k0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const float* qn = q + (long long)n * stride + off;
  const float qa = qn[0], qb = qn[1], qc = qn[2];
  float part = 0.f;
  for (int e = tid; e < kTaps * kTaps; e += blockDim.x) {
    const float jf = static_cast<float>(e / kTaps - kHalf);  // row offset
    const float tf = static_cast<float>(e % kTaps - kHalf);  // column offset
    const float quad = __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(qa, tf), tf),
                  __fmul_rn(__fmul_rn(__fmul_rn(2.f, qb), tf), jf)),
        __fmul_rn(__fmul_rn(qc, jf), jf));
    const float v = expf(__fmul_rn(-0.5f, quad));
    km[e] = v;
    part = __fadd_rn(part, v);
  }
  for (int o = 16; o > 0; o >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
  if (tid % 32 == 0) red[tid / 32] = part;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < 8; ++w) total = __fadd_rn(total, red[w]);
  const float inv_total = __fdiv_rn(1.f, total);
  __syncthreads();
  for (int e = tid; e < kTaps * kTaps; e += blockDim.x)
    km[e] = __fmul_rn(km[e], inv_total);
  __syncthreads();
  // (25 x 32) tap products: hr[j][c] = sum_t km[j][t] er[t][k0 + c]
  for (int e = tid; e < kTaps * kCols; e += blockDim.x) {
    const int j = e / kCols, c = e % kCols;
    float sr = 0.f, si = 0.f;
    for (int t = 0; t < kTaps; ++t) {
      const float kv = km[j * kTaps + t];
      sr = fmaf(kv, er[t * kp + k0 + c], sr);
      si = fmaf(kv, ei[t * kp + k0 + c], si);
    }
    hr[j][c] = sr;
    hi[j][c] = si;
  }
  __syncthreads();
  const float a3 = coeffs[0], a2 = coeffs[1], a1 = coeffs[2], beta = coeffs[3];
  const float inv_h = __fdiv_rn(1.f, static_cast<float>(h));
  const int c = tid % kCols;
  float* out = qhat2 + (long long)n * h * 2 * kp;
  for (int q = tid / kCols; q < h; q += blockDim.x / kCols) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < kTaps; ++j) {
      s1 = fmaf(cyt[q * 32 + j], hr[j][c], s1);
      s2 = fmaf(syt[q * 32 + j], hi[j][c], s2);
    }
    const float kh = __fadd_rn(s1, s2);
    float p = __fadd_rn(__fmul_rn(a3, kh), a2);
    p = __fadd_rn(__fmul_rn(p, kh), a1);
    p = __fadd_rn(__fmul_rn(p, kh), beta);
    p = __fmul_rn(p, inv_h);
    out[(long long)q * 2 * kp + k0 + c] = p;
    out[(long long)q * 2 * kp + kp + k0 + c] = p;
  }
}

// ------------------------------------------------------------------- GEMM

struct GemmParams {
  pb::TileView src;     // mode 1: the tiles (canvas, state or f32 planes)
  const void* tab_a;    // modes 2, 3: [Cy | Sy] (h, 2h)
  const void* tab_b;    // mode 1: F (wc, 2kp); mode 4: G (2kp, wc)
  const void* mid;      // modes 2, 3: R / P; mode 4: Yi — (planes, h, 2kp)
  void* dst;            // modes 1-3: (planes, h, 2kp); mode 4: (planes, ph, pw)
  const float* qhat2;   // mode 2: (n, h, 2kp)
  const float* noise;   // mode 4: (planes, ph, pw) f32 added after the clip
  int C, ph, pw, h, wc, kp, half, clip;
  int M, N, K;
};

// IO flags, template parameters so that the plain instantiations keep
// their loads and stores: kF32IO — mode 1 reads f32 tiles and rounds them
// to the work dtype on load, mode 4 writes f32 instead of the work dtype;
// kNoise — mode 4 adds the noise plane after the clip and clips again.
constexpr int kF32IO = 1, kNoise = 2;

// Per-plane base pointers, resolved once per block.
template <typename T>
struct Plane {
  const T* a;
  const float* af;      // mode 1 with f32 tiles
  const T* b;
  const float* q;
  const float* nz;      // mode 4 noise plane
  T* d;
  float* df;            // mode 4 with an f32 destination
};

template <int MODE, typename T>
__device__ __forceinline__ Plane<T> plane_ptrs(const GemmParams& p, int pl) {
  Plane<T> r;
  const int n = pl / p.C, c = pl - n * p.C;
  const long long mid_plane = (long long)p.h * 2 * p.kp;
  r.q = p.qhat2 + (long long)n * mid_plane;
  r.af = nullptr;
  r.nz = nullptr;
  if (MODE == 1) {
    const long long o = p.src.offset(n, c, 0, 0);
    r.a = static_cast<const T*>(p.src.ptr) + o;
    r.af = static_cast<const float*>(p.src.ptr) + o;
    r.b = static_cast<const T*>(p.tab_b);
  } else if (MODE == 4) {
    r.a = static_cast<const T*>(p.mid) + pl * mid_plane;
    r.b = static_cast<const T*>(p.tab_b);
    if (p.noise != nullptr) r.nz = p.noise + pl * (long long)p.ph * p.pw;
  } else {
    r.a = static_cast<const T*>(p.tab_a);
    r.b = static_cast<const T*>(p.mid) + pl * mid_plane;
  }
  const long long dplane = MODE == 4 ? (long long)p.ph * p.pw : mid_plane;
  r.d = static_cast<T*>(p.dst) + pl * dplane;
  r.df = static_cast<float*>(p.dst) + pl * dplane;
  return r;
}

// A(i, k), i < M, k < K
template <int MODE, typename T, int IO>
__device__ __forceinline__ T load_a(const GemmParams& p, const Plane<T>& P,
                                    int i, int k) {
  if (MODE == 1) {
    const int y = min(max(i - p.half, 0), p.ph - 1);
    const int x = min(max(k - p.half, 0), p.pw - 1);
    const long long o = (long long)y * p.src.sR + x;
    if (IO & kF32IO) return pb::from_f32<T>(P.af[o]);
    return P.a[o];
  } else if (MODE == 4) {
    return P.a[(long long)(i + p.half) * 2 * p.kp + k];
  } else {
    return P.a[(long long)i * 2 * p.h + k];
  }
}

// B(k, j), k < K, j < N
template <int MODE, typename T>
__device__ __forceinline__ T load_b(const GemmParams& p, const Plane<T>& P,
                                    int k, int j) {
  if (MODE == 1) {
    return P.b[(long long)k * 2 * p.kp + j];
  } else if (MODE == 4) {
    return P.b[(long long)k * p.wc + j + p.half];
  } else {
    if (k < p.h) return P.b[(long long)k * 2 * p.kp + j];
    const bool lo = j < p.kp;
    const T v = P.b[(long long)(k - p.h) * 2 * p.kp + (lo ? j + p.kp : j - p.kp)];
    // mode 2: swap(R) * sgn (sgn = +1 on the re half); mode 3: * -sgn
    return (MODE == 2 ? !lo : lo) ? pb::negate(v) : v;
  }
}

template <int MODE, typename T, int IO>
__device__ __forceinline__ void store_c(const GemmParams& p,
                                        const Plane<T>& P, int i, int j,
                                        float acc) {
  if (MODE == 4) {
    const long long o = (long long)i * p.pw + j;
    if (p.clip) acc = fminf(fmaxf(acc, 0.f), 1.f);
    if (IO & kNoise) acc = fminf(fmaxf(__fadd_rn(acc, P.nz[o]), 0.f), 1.f);
    if (IO & kF32IO)
      P.df[o] = acc;
    else
      P.d[o] = pb::from_f32<T>(acc);
  } else {
    const long long o = (long long)i * 2 * p.kp + j;
    if (MODE == 2) acc = __fmul_rn(P.q[o], acc);
    P.d[o] = pb::from_f32<T>(acc);
  }
}

constexpr int BM = 128, BN = 128, BK = 32, NT = 256;

// bf16 operands, f32 accumulate on the tensor cores.
template <int MODE, int IO>
__global__ void __launch_bounds__(NT) gemm_bf16_kernel(GemmParams p) {
  using namespace nvcuda;
  constexpr int LDA = BK + 8, LDB = BN + 8;
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[NT / 32][16 * 16];
  const Plane<bf16> P = plane_ptrs<MODE, bf16>(p, blockIdx.z);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const bf16 zero = __float2bfloat16_rn(0.f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int fi = 0; fi < 4; ++fi)
#pragma unroll
    for (int fj = 0; fj < 2; ++fj) wmma::fill_fragment(acc[fi][fj], 0.f);
  for (int k0 = 0; k0 < p.K; k0 += BK) {
#pragma unroll 4
    for (int e = tid; e < BM * BK; e += NT) {
      const int i = m0 + e / BK, k = k0 + e % BK;
      As[(e / BK) * LDA + e % BK] =
          (i < p.M && k < p.K) ? load_a<MODE, bf16, IO>(p, P, i, k) : zero;
    }
#pragma unroll 4
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = k0 + e / BN, j = n0 + e % BN;
      Bs[(e / BN) * LDB + e % BN] =
          (k < p.K && j < p.N) ? load_b<MODE, bf16>(p, P, k, j) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int fi = 0; fi < 4; ++fi)
        wmma::load_matrix_sync(a[fi], As + (wm * 64 + fi * 16) * LDA + kk, LDA);
#pragma unroll
      for (int fj = 0; fj < 2; ++fj)
        wmma::load_matrix_sync(b[fj], Bs + kk * LDB + wn * 32 + fj * 16, LDB);
#pragma unroll
      for (int fi = 0; fi < 4; ++fi)
#pragma unroll
        for (int fj = 0; fj < 2; ++fj)
          wmma::mma_sync(acc[fi][fj], a[fi], b[fj], acc[fi][fj]);
    }
    __syncthreads();
  }
  float* cs = Cs[warp];
#pragma unroll
  for (int fi = 0; fi < 4; ++fi)
#pragma unroll
    for (int fj = 0; fj < 2; ++fj) {
      wmma::store_matrix_sync(cs, acc[fi][fj], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int i = m0 + wm * 64 + fi * 16 + e / 16;
        const int j = n0 + wn * 32 + fj * 16 + e % 16;
        if (i < p.M && j < p.N) store_c<MODE, bf16, IO>(p, P, i, j, cs[e]);
      }
      __syncwarp();
    }
}

// f32 operands, plain f32 FMA (no TF32): 16 x 16 threads, 8 x 8 outputs each.
template <int MODE, int IO>
__global__ void __launch_bounds__(NT) gemm_f32_kernel(GemmParams p) {
  __shared__ float As[BK][BM + 1];  // transposed A: conflict-free stores
  __shared__ float Bs[BK][BN];
  const Plane<float> P = plane_ptrs<MODE, float>(p, blockIdx.z);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
  for (int k0 = 0; k0 < p.K; k0 += BK) {
#pragma unroll 4
    for (int e = tid; e < BM * BK; e += NT) {
      const int i = m0 + e / BK, k = k0 + e % BK;
      As[e % BK][e / BK] =
          (i < p.M && k < p.K) ? load_a<MODE, float, IO>(p, P, i, k) : 0.f;
    }
#pragma unroll 4
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = k0 + e / BN, j = n0 + e % BN;
      Bs[e / BN][e % BN] =
          (k < p.K && j < p.N) ? load_b<MODE, float>(p, P, k, j) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        a[r] = As[kk][ty + 16 * r];
        b[r] = Bs[kk][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int i = m0 + ty + 16 * r, j = n0 + tx + 16 * s;
      if (i < p.M && j < p.N) store_c<MODE, float, IO>(p, P, i, j, acc[r][s]);
    }
}

template <int MODE, int IO>
void launch_io(int dtype, const GemmParams& p, dim3 grid, cudaStream_t s) {
  if (dtype == pb::kBF16)
    gemm_bf16_kernel<MODE, IO><<<grid, NT, 0, s>>>(p);
  else  // f32 work dtype: the tiles and the output are f32 anyway
    gemm_f32_kernel<MODE, IO & ~kF32IO><<<grid, NT, 0, s>>>(p);
}

// f32io: mode 1's tiles / mode 4's output are f32; noise: mode 4 adds it
template <int MODE>
void launch_gemm(int dtype, bool f32io, bool noise, const GemmParams& p,
                 int planes, cudaStream_t s) {
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, planes);
  if (f32io && noise)
    launch_io<MODE, kF32IO | kNoise>(dtype, p, grid, s);
  else if (f32io)
    launch_io<MODE, kF32IO>(dtype, p, grid, s);
  else if (noise)
    launch_io<MODE, kNoise>(dtype, p, grid, s);
  else
    launch_io<MODE, 0>(dtype, p, grid, s);
}

}  // namespace

// q: n rows of `stride` f32 with (qa, qb, qc) at column `off` (the (n, 8)
// estimate rows: stride 8, off 5; fused_polynomial's (N, 3) params: 3, 0);
// coeffs: f32 [a3, a2, a1, beta, ..]; qhat2: (n, h, 2 kp) f32 output.
extern "C" int pb_kernel_spectrum(const float* q, int stride, int off,
                                  const float* coeffs, const float* er,
                                  const float* ei, const float* cyt,
                                  const float* syt, int n, int h, int kp,
                                  float* qhat2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(kp / kCols, n);
  kernel_spectrum_kernel<<<grid, 256, 0, s>>>(q, stride, off, coeffs, er, ei,
                                              cyt, syt, h, kp, qhat2);
  return static_cast<int>(cudaGetLastError());
}

// One of the four products of a spectral application over `planes`
// (tile, channel) planes; see the modes above. Shapes: canvas (h, wc),
// packed half-spectrum kp; mode 1 reads (ph, pw) tiles replicate-padded by
// `half` (= (h - ph) / 2), mode 4 writes (ph, pw) planes cropped by `half`
// from the canvas, so the two may differ (the taper reads the tile padded
// and writes the whole canvas, then reads the canvas and writes the tile).
// src_f32 (mode 1): the tiles are f32 and rounded to the work dtype on
// load; dst_f32 (mode 4): write f32; clip != 0 clips mode 4's output to
// [0, 1]; noise (mode 4, f32 (planes, ph, pw) or null) is then added and
// the sum clipped again.
extern "C" int pb_spectral_gemm(int mode, int dtype, const void* ptr,
                                long long sB, long long sC, long long sR,
                                int batch, int tile0, int tiles_w, int step_h,
                                int step_w, int src_f32, const void* tab_a,
                                const void* tab_b, const void* mid, void* dst,
                                int dst_f32, const float* qhat2,
                                const float* noise, int planes, int C, int ph,
                                int pw, int h, int wc, int kp, int half,
                                int clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != pb::kBF16 && dtype != pb::kF32)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p;
  p.noise = noise;
  p.src = pb::make_view(ptr, sB, sC, sR, batch, tile0, tiles_w, step_h,
                        step_w);
  p.tab_a = tab_a;
  p.tab_b = tab_b;
  p.mid = mid;
  p.dst = dst;
  p.qhat2 = qhat2;
  p.C = C;
  p.ph = ph;
  p.pw = pw;
  p.h = h;
  p.wc = wc;
  p.kp = kp;
  p.half = half;
  p.clip = clip;
  switch (mode) {
    case 1:
      p.M = h; p.N = 2 * kp; p.K = wc;
      launch_gemm<1>(dtype, src_f32 != 0, false, p, planes, s);
      break;
    case 2:
      p.M = h; p.N = 2 * kp; p.K = 2 * h;
      launch_gemm<2>(dtype, false, false, p, planes, s);
      break;
    case 3:
      p.M = h; p.N = 2 * kp; p.K = 2 * h;
      launch_gemm<3>(dtype, false, false, p, planes, s);
      break;
    case 4:
      p.M = ph; p.N = pw; p.K = 2 * kp;
      launch_gemm<4>(dtype, dst_f32 != 0, noise != nullptr, p, planes, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
