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
// four launches over the tile batch:
//   (1) gray_minmax   grid (bands, tiles): each block takes a band of rows
//                     of one tile, forms gray = (sum of channels) * (1/C)
//                     and writes its (min, max) to an (n, bands, 2)
//                     scratch; the band height is chosen so that the grid
//                     has ~1024 blocks at any tile count (one 480 x 640
//                     image: 480 one-row bands). Band 0 zeroes the tile's
//                     maxima (7, or n_angles + 1);
//   (2) gray_norm     32 x 32 blocks: g = clip((gray - min) / range), min
//                     and max folded from the band partials, split for the
//                     tensor cores and written as g and its transpose (the
//                     K-major operands of gx's A and gy's B);
//   (3) est_gemm      gx = g Dw^T and gy = Dh g on the tensor cores; the
//                     epilogue reduces max |cos t gx - sin t gy| for the 7
//                     angles and atomicMax-es the float bits (valid: the
//                     values are >= 0);
//   (4) tile_est_final one warp per tile: interpolation, argmin, model.
// The gray value, its min/max and the normalization keep the plain
// version's operations in its order (__fadd_rn / __fmul_rn / __fdiv_rn),
// so g is bit-equal to it. Passes (1)-(2) are elementwise with a
// reduction, which Triton would serve as well; they stay CUDA C++ because
// (2) writes the layout of the TMA maps (tf32 hi / lo planes, 16-byte
// rows) that (3) encodes in C++.
//
// Stages (1)-(3) alone are also the directional-maxima reduction of the
// whole-image estimate, replacing polyblur_tpu/ops/pallas/est_fused.py::
// directional_maxima_pallas (the (B, n_angles + 1) maxima of the
// normalized channel mean, for any C): the wrapper ops/cuda/est_fused.py
// launches stages 1-3 and reads `maxima`. The angle count is open there:
// the patch engine's 7 angles keep their own epilogue (kMaxima, the
// angles in registers, unchanged), any other count takes kMaximaAny,
// which walks the angles in register groups of 8 (a block reduction and
// an atomicMax per group). Stage (4) runs at 7 angles only.
//
// The same GEMM, with other epilogues, is the halo mask of the mega
// kernel's do_halo flag (polyblur_fused.py:288-302, :503-512): once per
// call the input tiles' gradients and the per-plane sum nM of |grad|^2
// (`pb_halo_gemm` epi 1; the TPU hoists them when they fit VMEM, here
// they always fit device memory), then per iteration the gradients of the
// output o fed straight into the mask, clip, noise and store (epi 2), so
// the output gradients never leave registers.
//
// Bound on the H100: operations — 2 ph pw (ph + pw) MACs per plane in (3),
// 0.36 G per 448 px tile; (1) reads the tiles once, (2) reads them and
// writes 16 bytes per pixel (g and g^T, hi and lo: 282 MB per 12 MP call,
// read back by (3) through L2), (4) is small.
// Design of (3): 64 x 64 output tiles (448 = 7 x 64; ragged edges masked in
// the epilogue), one persistent block per SM walking them, so that the
// next tile's loads overlap this tile's epilogue. Four warpgroups: two
// consumers running wgmma m64n64k8 on tf32, one for gx and one for gy of
// the same tile (gy reaches the first through shared memory for the
// epilogue, which combines them per pixel), and two producers. K steps of
// 32 through a ring of 3 shared-memory stages of 64 KB, all operands
// K-major in the 128-byte swizzle: the constant tables Dw and Dh arrive by
// TMA from a host-split hi/lo copy; the estimate's g and g^T by TMA from
// stage 2's planes (one producer thread issues all 8 boxes). The halo's
// operand planes (the input tiles through any TileView, bf16 or f32, or
// the f32 iterate o) are written by the two producer warpgroups, each
// filling alternate K steps so that two steps' loads are in flight:
// 16-byte vector loads, all of a thread's issued before the first is
// used, where every tile origin and row pitch allows it (a template case;
// scalar loads otherwise), split into hi/lo and transposed for gy's B as
// they are stored. That keeps the halo at one launch per epilogue and adds
// no device-memory bytes (each row band of a plane is read by the 7
// output tiles along it, all but the first from L2); TMA could not take
// those planes: bf16, or views whose origin or pitch is not 16-byte
// aligned, and tf32 wgmma cannot transpose from shared memory (it takes
// K-major operands only).
//
// Precision: 3xTF32 (a = hi + lo, hi = a rounded to the nearest tf32, lo =
// tf32(a - hi); a b ~ hi lo + lo hi + hi hi in f32): each product is off by
// at most ~3 * 2^-22 of |a b| (the dropped lo lo and the rounding of lo),
// against the plain version's exact-f32 products; the counterpart of the
// TPU kernel's error-compensated bf16x3 estimate (_EST_DOT_COMPENSATED),
// whose ~2^-17 split error would not keep the gates.
// tests/test_torch_estimate_precision.py emulates this split on the CPU.
//
// The f32 dot mode 'highest' (ops/cuda/sep_poly_fused.py set_f32_dot_mode;
// polyblur_fused.py:251-252 reads it for f32 tiles only) is a template
// case (HI) of stage 2 and of the GEMM: a = hi + mid + lo, each rounded to
// tf32, six products per K step (lo hi, hi lo, mid mid, mid hi, hi mid for
// the step's four 8-deep slices, then the four hi hi), ~2^-33 of each
// operand left out, promoted into the running sum as above. On the TPU the
// JAX package's 'highest' estimate dot is Mosaic's DEFAULT, which truncates
// f32 operands to bf16 (polyblur_fused.py:242-244); in interpret mode on
// the CPU, the port's reference, it is an exact f32 product. The port
// follows the CPU reference: exact-f32-grade products, not the truncation.
// tests/test_torch_dot_mode.py emulates the six products on the CPU.
// Design of HI in the TMA-fed estimate (RS): stage 2 writes g and g^T in
// f32 (a third of the three pieces' bytes), the tables arrive split (3
// pieces by TMA), and each consumer loads its data operand from the stage
// into the wgmma register fragment and splits it there with the same
// rounding (split4<3>); its wgmmas take A from registers and only B from
// shared memory. gy runs transposed (gy^T = g^T Dh^T) so that both
// consumers take the data as A; its products are the three-piece order's
// with the factors swapped (mma_step_hi), so the outputs are bit-equal to
// it. A stage is 64 KB (3 stages); the producer warpgroups give their
// registers to the consumers (setmaxnreg). The halo keeps three pieces of
// every operand in the stage (2 stages of 96 KB, split by its producers):
// the same consumers there, beside producers that need their registers,
// spilled and ran 1.3x slower. tests/test_torch_est_highest.py holds the
// order on the CPU.
#include <cstdio>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kAngles = 7;   // n_angles + 1 of the patch engine's estimate
constexpr int kInterp = 30;  // n_interpolated_angles
constexpr int kGroup = 8;    // angles per register group of kMaximaAny

// ---------------------------------------------------------------- gray

// 8 consecutive source values at p as f32 (16-byte aligned p).
__device__ __forceinline__ void load8(const pb::bf16* p, float (&f)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The gray values (sum of C channels sC apart, times inv_c) of the nv <= 8
// pixels at p; the others 0. VEC: p is 16-byte aligned and, when nv == 8,
// read as vectors.
template <typename S, bool VEC>
__device__ __forceinline__ void gray8(const S* p, long long sC, int C,
                                      float inv_c, int nv, float (&g)[8]) {
  if (VEC && nv == 8) {
    load8(p, g);
    for (int c = 1; c < C; ++c) {
      float f[8];
      load8(p + c * sC, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) g[e] = __fadd_rn(g[e], f[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = 0.f;
      if (e < nv) {
        v = pb::to_f32(p[e]);
        for (int c = 1; c < C; ++c)
          v = __fadd_rn(v, pb::to_f32(p[c * sC + e]));
      }
      g[e] = v;
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) g[e] = __fmul_rn(g[e], inv_c);
}

// Stage 1: per (band, tile) the min and max of the gray values.
template <typename S, bool VEC>
__global__ void __launch_bounds__(256)
gray_minmax_kernel(pb::TileView v, int C, int ph, int pw, int rows,
                   int na1, float* __restrict__ mm,
                   float* __restrict__ maxima) {
  const int band = blockIdx.x, n = blockIdx.y, bands = gridDim.x;
  const S* base = static_cast<const S*>(v.ptr) + v.offset(n, 0, 0, 0);
  const float inv_c = 1.0f / static_cast<float>(C);
  const int r0 = band * rows, nr = min(ph, r0 + rows) - r0;
  const int segs = (pw + 7) / 8;
  float lo = __int_as_float(0x7f800000), hi = -__int_as_float(0x7f800000);
  for (int e = threadIdx.x; e < nr * segs; e += blockDim.x) {
    const int y = r0 + e / segs, x = (e % segs) * 8;
    const int nv = min(8, pw - x);
    float g[8];
    gray8<S, VEC>(base + (long long)y * v.sR + x, v.sC, C, inv_c, nv, g);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < nv) {
        lo = fminf(lo, g[k]);
        hi = fmaxf(hi, g[k]);
      }
  }
  __shared__ float smin[8], smax[8];
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
  if (threadIdx.x == 0) {
    for (int w = 1; w < blockDim.x / 32; ++w) {
      lo = fminf(lo, smin[w]);
      hi = fmaxf(hi, smax[w]);
    }
    mm[((long long)n * bands + band) * 2] = lo;
    mm[((long long)n * bands + band) * 2 + 1] = hi;
  }
  if (band == 0)
    for (int a = threadIdx.x; a < na1; a += blockDim.x)
      maxima[(long long)n * na1 + a] = 0.f;
}

// Row pitch of the normalized planes: a whole number of 16 bytes, as TMA
// needs.
__host__ __device__ inline int pitch4(int n) { return (n + 3) / 4 * 4; }

// Stage 2: g = clip((gray - min) / range) of every tile (min and max folded
// from the band partials), split into P = 2 tf32 pieces (hi, lo), or in
// f32 (P = 1: 'highest', whose GEMM splits it), and written in both layouts
// the GEMM's TMA maps read: g (n, P, ph, pitch4(pw)) and its transpose g^T
// (n, P, pw, pitch4(ph)), hi first. One 32 x 32 block of a tile per thread
// block; the transpose goes through shared memory.
template <typename S, int P>
__global__ void __launch_bounds__(256)
gray_norm_kernel(pb::TileView v, int C, int ph, int pw, int bands,
                 const float* __restrict__ mm, float* __restrict__ g2,
                 float* __restrict__ gt2) {
  __shared__ float sp[P][32][33];
  __shared__ float sr[8][2];
  const int n = blockIdx.z, tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (int b = tid; b < bands; b += 256) {
    lo = fminf(lo, mm[((long long)n * bands + b) * 2]);
    hi = fmaxf(hi, mm[((long long)n * bands + b) * 2 + 1]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (tx == 0) {
    sr[ty][0] = lo;
    sr[ty][1] = hi;
  }
  __syncthreads();
  for (int w = 0; w < 8; ++w) {
    lo = fminf(lo, sr[w][0]);
    hi = fmaxf(hi, sr[w][1]);
  }
  const float vmin = lo, range = fmaxf(__fsub_rn(hi, lo), 1e-8f);
  const S* base = static_cast<const S*>(v.ptr) + v.offset(n, 0, 0, 0);
  const float inv_c = 1.0f / static_cast<float>(C);
  const int x0 = blockIdx.x * 32, y0 = blockIdx.y * 32;
  const int ldp = pitch4(pw), ldq = pitch4(ph);
  const long long pg = (long long)ph * ldp, pt = (long long)pw * ldq;
  float* gh = g2 + P * n * pg;
  const int x = x0 + tx;
  float raw[4][3];  // the loads of 3 channels in flight before any is used
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = y0 + ty + 8 * i;
    const S* q = base + (long long)y * v.sR + x;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      raw[i][c] = y < ph && x < pw && c < C ? pb::to_f32(q[c * v.sC]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = y0 + ty + 8 * i;
    float pc[P] = {};  // the pieces, hi first
    if (y < ph && x < pw) {
      float g = raw[i][0];
#pragma unroll
      for (int c = 1; c < 3; ++c)
        if (c < C) g = __fadd_rn(g, raw[i][c]);
      const S* q = base + (long long)y * v.sR + x;
      for (int c = 3; c < C; ++c) g = __fadd_rn(g, pb::to_f32(q[c * v.sC]));
      g = __fmul_rn(g, inv_c);
      g = fminf(fmaxf(__fdiv_rn(__fsub_rn(g, vmin), range), 0.f), 1.f);
      // each piece the tf32 rounding of what the larger ones leave; one
      // piece is g itself
      float r = g;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        pc[k] = P == 1 ? r : pb::tf32_hi(r);
        r = r - pc[k];
        gh[k * pg + (long long)y * ldp + x] = pc[k];
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) sp[k][ty + 8 * i][tx] = pc[k];
  }
  __syncthreads();
  float* th = gt2 + P * n * pt;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xr = x0 + ty + 8 * i, yc = y0 + tx;
    if (xr < pw && yc < ph) {
#pragma unroll
      for (int k = 0; k < P; ++k)
        th[k * pt + (long long)xr * ldq + yc] = sp[k][tx][ty + 8 * i];
    }
  }
}

// ---------------------------------------------------------------- GEMM

constexpr int TM = 64, TN = 64;   // output tile
constexpr int TK = 32;            // K per stage: one 128-byte f32 row
constexpr int WG = 128;           // threads of a warpgroup
// warpgroups: 0 gx consumer, 1 gy consumer, 2 and 3 producers of the even
// and odd K steps
constexpr int NCONS = 2 * WG;
constexpr int NT = 4 * WG;
constexpr int BUF = 64 * 128;     // one 64-row x 32 f32 operand, 8 KB
constexpr int XLD = TN + 4;       // row pitch of RS's gy exchange, floats
// the operands of a stage: the data as gx's A (g rows y0..) and as gy's B
// (g^T rows x0..; RS: gy^T's A), then the tables by TMA; each in its
// pieces, hi first
enum { kOpA = 0, kOpB, kOpDw, kOpDh };

// The ring. The 3xTF32 case holds every operand in 2 pieces (3 stages of
// 64 KB). 'highest' (HI), TMA-fed (the estimate): the tables in 3 pieces,
// the data in f32, which the consumers split in registers (RS; 3 stages of
// 64 KB). HI with producer-written planes (the halo): every operand in 3
// pieces (2 stages of 96 KB).
template <bool HI, bool TMAD>
struct EstCfg {
  static constexpr bool RS = HI && TMAD;
  static constexpr int PD = RS ? 1 : HI ? 3 : 2;  // pieces of the data
  static constexpr int PT = HI ? 3 : 2;           // pieces of the tables
  static constexpr int kBufs = 2 * PD + 2 * PT;
  static constexpr int STAGE = kBufs * BUF;
  static constexpr int STAGES = HI && !RS ? 2 : 3;
  // gy of a tile, handed to warpgroup 0: in the accumulator layout, or for
  // RS (gy^T in the accumulators) in rows y of XLD floats
  static constexpr int XCHG = RS ? TM * XLD * 4 : TM * TN * 4;
  static constexpr int SMEM = STAGES * STAGE + XCHG + 1024;
  // buffer of piece k of operand op
  __host__ __device__ static constexpr int buf(int op, int k) {
    return op < kOpDw ? PD * op + k : 2 * PD + PT * (op - kOpDw) + k;
  }
};
// RS's registers per thread after setmaxnreg: the consumers take what the
// producers give back (2 x 128 x (216 + 40) = the SM's 65,536); the
// producers issue TMA loads from one thread.
constexpr int kRegsCons = 216, kRegsProd = 40;
// named barriers: 1 both consumer warpgroups, 2 warpgroup 0
constexpr int kBarCons = 1, kBarWg0 = 2;

// Epilogues of the derivative GEMM pair (gx = g Dw^T, gy = Dh g):
//   kMaxima  the 7 directional maxima of the estimate (atomicMax per tile);
//            the operand is the normalized gray of the tile's C channels;
//   kMaximaAny the same for na1 angles, in register groups of kGroup;
//   kGrads   the halo mask's input gradients: gx, gy written in f32, and
//            per output tile the partial sum of gx^2 + gy^2 (its plane's
//            nM is the sum of the partials, taken in tile order);
//   kHalo    the gradient-inversion mask of the output o (the GEMM's
//            operand): M = -(gx0 gox) - (gy0 goy), z = max(M / (nM + M +
//            1e-12), 0), o + z (u - o), clipped to [0, 1], plus the
//            prefilter's noise and clipped again when given, stored in the
//            work dtype (polyblur_fused.py:503-517).
// The halo's operand planes are p = (p / C, p % C) of the view.
enum Epilogue { kMaxima = 0, kGrads = 1, kHalo = 2, kMaximaAny = 3 };

struct EstGemm {
  pb::TileView src;   // the operand tiles
  int C, ph, pw;
  int planes;         // kMaxima: tiles; halo: tiles x C
  const float* cs;    // kMaxima(Any): (na1, 2) cos, sin
  float* maxima;      // kMaxima(Any): (n, na1)
  int na1;            // kMaxima(Any): angles (7 for kMaxima)
  float* gx;          // kGrads: (planes, ph, pw) out; kHalo: gx0 in
  float* gy;          //   "  gy0
  float* part;        // kGrads: (planes, ntile) out; kHalo: in
  pb::TileView ucmp;  // kHalo: the unfiltered planes u
  int ucmp_dtype;
  const float* noise; // kHalo: (planes, ph, pw) f32 or null
  void* out;          // kHalo: (planes, ph, pw) in out_dtype
  int out_dtype;
};

// 8 f32 of the 16-byte words r (bf16: one word, f32: two).
__device__ __forceinline__ void unpack8(const uint4* r, pb::bf16, float (&f)[8]) {
  const uint32_t w[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack8(const uint4* r, float, float (&f)[8]) {
  f[0] = __uint_as_float(r[0].x); f[1] = __uint_as_float(r[0].y);
  f[2] = __uint_as_float(r[0].z); f[3] = __uint_as_float(r[0].w);
  f[4] = __uint_as_float(r[1].x); f[5] = __uint_as_float(r[1].y);
  f[6] = __uint_as_float(r[1].z); f[7] = __uint_as_float(r[1].w);
}

// The producer's part of one K step of the halo: a 4-row x 8-column block
// of the plane at src, rows y.., columns x.., as f32 (zero outside the
// plane). With VEC, whole 8-pixel groups are read as 16-byte words by
// operand_prefetch, issued a step ahead, and unpacked by operand_values;
// the other groups are read element-wise by operand_values.
template <typename S>
struct OperandBlock {
  const S* src;
  int y, x;
  uint4 raw[4][sizeof(S) / 2];  // 16-byte words per 8 pixels
};

template <typename S, bool VEC>
__device__ __forceinline__ void operand_prefetch(const EstGemm& p,
                                                 OperandBlock<S>& b) {
  if (!VEC || b.x + 8 > p.pw) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (b.y + i < p.ph) {
      const uint4* a = reinterpret_cast<const uint4*>(
          b.src + (long long)(b.y + i) * p.src.sR + b.x);
#pragma unroll
      for (int w = 0; w < (int)(sizeof(S) / 2); ++w) b.raw[i][w] = __ldg(a + w);
    }
}

template <typename S, bool VEC>
__device__ __forceinline__ void operand_values(const EstGemm& p,
                                               const OperandBlock<S>& b,
                                               float (&v)[4][8]) {
  const int nv = max(0, min(8, p.pw - b.x));
  if (VEC && nv == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (b.y + i < p.ph) {
        unpack8(b.raw[i], S(), v[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const S* row = b.src + (long long)(b.y + i) * p.src.sR + b.x;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[i][e] = b.y + i < p.ph && e < nv ? pb::to_f32(row[e]) : 0.f;
    }
  }
}

__device__ __forceinline__ void store16(uint8_t* d, const float (&f)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
}

using pb::split4;

// One K step of one product on the stage at sa into the fresh accumulator
// t, the small terms first; one MMA group. 3xTF32 over 32 of K, or
// 'highest' with every operand in 3 pieces in the stage (the halo): the
// five small products of the step's four 8-deep slices, then their four
// hi hi products.
//   warpgroup 0: t = A_g Dw^T    (A = g rows, B = Dw rows)
//   warpgroup 1: t = Dh B_g^T    (A = Dh rows, B = g^T rows)
template <class Cf>
__device__ __forceinline__ void mma_step(uint32_t sa, int wg, float (&t)[32]) {
  static_assert(!Cf::RS && Cf::PD == Cf::PT, "pieces of every operand");
  const int oa = wg ? kOpDh : kOpA, ob = wg ? kOpB : kOpDw;
  const uint32_t ah = sa + Cf::buf(oa, 0) * BUF;
  const uint32_t al = sa + Cf::buf(oa, Cf::PT - 1) * BUF;
  const uint32_t bh = sa + Cf::buf(ob, 0) * BUF;
  const uint32_t bl = sa + Cf::buf(ob, Cf::PT - 1) * BUF;
  pb::fence_regs(t);
  pb::wgmma_fence();
  if constexpr (Cf::PT == 2) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dah = pb::sw128_desc(ah) + 2 * kk;
      const uint64_t dal = pb::sw128_desc(al) + 2 * kk;
      const uint64_t dbh = pb::sw128_desc(bh) + 2 * kk;
      const uint64_t dbl = pb::sw128_desc(bl) + 2 * kk;
      pb::wgmma_tf32_n64(t, dah, dbl, kk);  // kk == 0 starts from zero
      pb::wgmma_tf32_n64(t, dal, dbh);
      pb::wgmma_tf32_n64(t, dah, dbh);
    }
  } else {
    const uint32_t am = sa + Cf::buf(oa, 1) * BUF;
    const uint32_t bm = sa + Cf::buf(ob, 1) * BUF;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dah = pb::sw128_desc(ah) + 2 * kk;
      const uint64_t dam = pb::sw128_desc(am) + 2 * kk;
      const uint64_t dal = pb::sw128_desc(al) + 2 * kk;
      const uint64_t dbh = pb::sw128_desc(bh) + 2 * kk;
      const uint64_t dbm = pb::sw128_desc(bm) + 2 * kk;
      const uint64_t dbl = pb::sw128_desc(bl) + 2 * kk;
      pb::wgmma_tf32_n64(t, dal, dbh, kk);  // kk == 0 starts from zero
      pb::wgmma_tf32_n64(t, dah, dbl);
      pb::wgmma_tf32_n64(t, dam, dbm);
      pb::wgmma_tf32_n64(t, dam, dbh);
      pb::wgmma_tf32_n64(t, dah, dbm);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pb::wgmma_tf32_n64(t, pb::sw128_desc(ah) + 2 * kk,
                         pb::sw128_desc(bh) + 2 * kk);
  }
  pb::wgmma_commit();
}

// One 'highest' K step of warpgroup W into the fresh accumulator t; one
// MMA group. W = 0 runs gx = g Dw^T, W = 1 gy^T = g^T Dh^T, so that both
// take the data as A and a table as B. A, this warpgroup's f32 data operand
// at da (64 rows x 32 of K, 128-byte swizzle), is read into the register
// fragment and split there into hi, mid, lo (split4<3>, the split the
// three-piece design's stage 2 made); B is the table's
// three pieces from sb, BUF apart. Per 8-deep slice the five small products
// as (A piece, B piece), 0 hi, 1 mid, 2 lo:
//   gx:   (2,0) (0,2) (1,1) (1,0) (0,1)  lo hi, hi lo, mid mid, mid hi,
//                                        hi mid of (g, Dw)
//   gy^T: (0,2) (2,0) (1,1) (0,1) (1,0)  the same of (Dh, g^T), factors
//                                        swapped
// then the step's four hi hi: each output element sums the products of the
// three-piece design in its order.
template <int W>
__device__ __forceinline__ void mma_step_hi(uint32_t sb, const uint8_t* da,
                                            int warp, int lane,
                                            float (&t)[32]) {
  float a[4][3][4];  // [slice][piece][fragment register]
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 16 * warp + (lane >> 2) + 8 * (j & 1);
      const int chunk = 2 * kk + (j >> 1);
      v[j] = *reinterpret_cast<const float*>(
          da + r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * (lane & 3));
    }
    split4<3>(v, a[kk]);
  }
  const uint64_t bh = pb::sw128_desc(sb), bm = pb::sw128_desc(sb + BUF),
                 bl = pb::sw128_desc(sb + 2 * BUF);
  pb::fence_regs(t);
  pb::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t h = bh + 2 * kk, m = bm + 2 * kk, l = bl + 2 * kk;
    if constexpr (W == 0) {
      pb::wgmma_tf32_n64_rs(t, a[kk][2], h, kk);  // kk == 0 starts from zero
      pb::wgmma_tf32_n64_rs(t, a[kk][0], l);
      pb::wgmma_tf32_n64_rs(t, a[kk][1], m);
      pb::wgmma_tf32_n64_rs(t, a[kk][1], h);
      pb::wgmma_tf32_n64_rs(t, a[kk][0], m);
    } else {
      pb::wgmma_tf32_n64_rs(t, a[kk][0], l, kk);
      pb::wgmma_tf32_n64_rs(t, a[kk][2], h);
      pb::wgmma_tf32_n64_rs(t, a[kk][1], m);
      pb::wgmma_tf32_n64_rs(t, a[kk][0], m);
      pb::wgmma_tf32_n64_rs(t, a[kk][1], h);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    pb::wgmma_tf32_n64_rs(t, a[kk][0], bh + 2 * kk);
  pb::wgmma_commit();
}

// A tile's output coordinates from the persistent walk index.
struct TileAt {
  int pl, y0, x0;
};

__device__ __forceinline__ TileAt tile_at(const EstGemm& p, int t) {
  const int tx = (p.pw + TN - 1) / TN, ty = (p.ph + TM - 1) / TM;
  const int pl = t / (tx * ty), r = t - pl * (tx * ty);
  return {pl, (r / tx) * TM, (r % tx) * TN};
}

// Step it of this block's walk (it = j nk + kt: K step kt of its j-th
// tile) for producer thread t: gx's A block (t < 64: rows y0 + 4 rg ..,
// columns = k k0 + 8 cg .., rg = t / 4, cg = t % 4) or gy's B block
// (rows = k k0 + 4 rg .., columns x0 + 8 cg .., stored transposed; rg =
// (t - 64) % 8, cg = (t - 64) / 8, so that the 8 threads of a
// quarter-warp store to 8 different 16-byte columns of the swizzle).
template <typename S>
__device__ __forceinline__ OperandBlock<S> step_block(const EstGemm& p,
                                                      int it, int nk, int t,
                                                      TileAt& at) {
  const int j = it / nk, k0 = (it - j * nk) * TK;
  at = tile_at(p, blockIdx.x + j * gridDim.x);
  const int n = at.pl / p.C, c = at.pl - n * p.C;
  OperandBlock<S> b;
  b.src = static_cast<const S*>(p.src.ptr) + p.src.offset(n, c, 0, 0);
  if (t < 64) {
    b.y = at.y0 + 4 * (t >> 2);
    b.x = k0 + 8 * (t & 3);
  } else {
    b.y = k0 + 4 * ((t - 64) & 7);
    b.x = at.x0 + 8 * ((t - 64) >> 3);
  }
  return b;
}

// tdw, tdh: the split tables; tg, tgt (kMaxima): the normalized gray
// planes g and g^T of stage 2, (PD n) planes, PD pieces per tile.
template <int EPI, typename S, bool VEC, bool HI>
__global__ void __launch_bounds__(NT, 1)
est_gemm_kernel(const __grid_constant__ CUtensorMap tdw,
                const __grid_constant__ CUtensorMap tdh,
                const __grid_constant__ CUtensorMap tg,
                const __grid_constant__ CUtensorMap tgt, const EstGemm p) {
  // kMaxima: the whole stage arrives by TMA; the halo's planes are
  // written by the producer warpgroups
  constexpr bool TMAD = EPI == kMaxima || EPI == kMaximaAny;
  using Cf = EstCfg<HI, TMAD>;
  constexpr bool RS = Cf::RS;
  constexpr int PD = Cf::PD, PT = Cf::PT, STAGES = Cf::STAGES;
  constexpr int STAGE = Cf::STAGE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float red[4][kGroup];
  __shared__ float s_nm;
  const uint32_t raw_u32 = pb::smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw_u32);
  float* xchg = reinterpret_cast<float*>(sbase + STAGES * STAGE);
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int warp = t / 32, lane = t % 32;
  const int tiles = p.planes * ((p.ph + TM - 1) / TM) * ((p.pw + TN - 1) / TN);
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int nk = (max(p.ph, p.pw) + TK - 1) / TK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      pb::mbar_init(pb::smem_u32(&full[s]), TMAD ? 1 : 1 + WG / 32);
      pb::mbar_init(pb::smem_u32(&empty[s]), NCONS);
    }
    pb::mbar_fence_init();
  }
  __syncthreads();

  if (wg >= 2) {
    // ------------------------------------------------------- producers
    if constexpr (RS) pb::setmaxnreg_dec<kRegsProd>();
    if (TMAD) {
      // one thread: the tables and the gray planes, 8 boxes a step
      if (tid != 2 * WG) return;
      for (int it = 0; it < mine * nk; ++it) {
        const int j = it / nk, kt = it - j * nk;
        const TileAt at = tile_at(p, blockIdx.x + j * gridDim.x);
        const int s = it % STAGES, k0 = kt * TK;
        pb::mbar_wait(pb::smem_u32(&empty[s]), ((it / STAGES) & 1) ^ 1);
        const uint32_t sa = base + s * STAGE;
        const uint32_t fb = pb::smem_u32(&full[s]);
        pb::mbar_arrive_tx(fb, Cf::kBufs * BUF);
#pragma unroll
        for (int k = 0; k < PD; ++k) {
          pb::tma_load_3d(sa + Cf::buf(kOpA, k) * BUF, &tg, k0, at.y0,
                          PD * at.pl + k, fb);
          pb::tma_load_3d(sa + Cf::buf(kOpB, k) * BUF, &tgt, k0, at.x0,
                          PD * at.pl + k, fb);
        }
#pragma unroll
        for (int k = 0; k < PT; ++k) {
          pb::tma_load_3d(sa + Cf::buf(kOpDw, k) * BUF, &tdw, k0, at.x0, k,
                          fb);
          pb::tma_load_3d(sa + Cf::buf(kOpDh, k) * BUF, &tdh, k0, at.y0, k,
                          fb);
        }
      }
      return;
    }
    // warpgroup 2 + q fills the steps it = q, q + 2, .. of this block's
    // walk; the loads of its next step are in flight while it waits for
    // a free stage and stores this one
    const int q = wg - 2, total = mine * nk;
    const int rg = t < 64 ? t >> 2 : (t - 64) & 7;
    const int cg = t < 64 ? t & 3 : (t - 64) >> 3;
    TileAt at, at_next;
    OperandBlock<S> blk;
    if (q < total) {
      blk = step_block<S>(p, q, nk, t, at);
      operand_prefetch<S, VEC>(p, blk);
    }
    for (int it = q; it < total; it += 2) {
      const int k0 = (it % nk) * TK;
      float v[4][8];
      operand_values<S, VEC>(p, blk, v);
      const TileAt cur = at;
      if (it + 2 < total) {
        blk = step_block<S>(p, it + 2, nk, t, at_next);
        operand_prefetch<S, VEC>(p, blk);
        at = at_next;
      }
      const int s = it % STAGES;
      pb::mbar_wait(pb::smem_u32(&empty[s]), ((it / STAGES) & 1) ^ 1);
      const uint32_t sa = base + s * STAGE;
      const uint32_t fb = pb::smem_u32(&full[s]);
      if (t == 0) {
        pb::mbar_arrive_tx(fb, 2 * PT * BUF);
#pragma unroll
        for (int k = 0; k < PT; ++k) {
          pb::tma_load_3d(sa + Cf::buf(kOpDw, k) * BUF, &tdw, k0, cur.x0, k,
                          fb);
          pb::tma_load_3d(sa + Cf::buf(kOpDh, k) * BUF, &tdh, k0, cur.y0, k,
                          fb);
        }
      }
      uint8_t* st = sbase + s * STAGE;
      float pc[PD][4];
      if (t < 64) {
        // odd row groups store their second half first, so that a
        // quarter-warp's 8 stores meet 8 different 16-byte columns
        const bool swap = rg & 1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * rg + i;
#pragma unroll
          for (int step = 0; step < 2; ++step) {
            const int hf = step ^ swap;
            const int off = r * 128 + (((2 * cg + hf) ^ (r & 7)) << 4);
            float a[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a[e] = swap ? v[i][4 * (1 - step) + e] : v[i][4 * step + e];
            split4<PD>(a, pc);
#pragma unroll
            for (int k = 0; k < PD; ++k)
              store16(st + Cf::buf(kOpA, k) * BUF + off, pc[k]);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int jr = 8 * cg + e;
          const int off = jr * 128 + ((rg ^ (jr & 7)) << 4);
          const float a[4] = {v[0][e], v[1][e], v[2][e], v[3][e]};
          split4<PD>(a, pc);
#pragma unroll
          for (int k = 0; k < PD; ++k)
            store16(st + Cf::buf(kOpB, k) * BUF + off, pc[k]);
        }
      }
      // one arrival per warp, after every lane's stores are ordered for
      // the tensor cores
      pb::fence_proxy_async();
      __syncwarp();
      if (lane == 0) pb::mbar_arrive(fb);
    }
    return;
  }

  // --------------------------------------------------------- consumers
  // Warpgroup 0 runs gx, 1 runs gy (RS: gy^T), over the same 64 x 64
  // output tile. Each K step's products go to a fresh accumulator, which
  // is then added to the running sum with a rounded f32 add: the tensor
  // cores' f32 accumulation truncates, and over a whole 448-deep K its bias
  // reached 2e-4 of the estimate's values; within a step of 32 it stays far
  // below the split's own error. The step's group is waited for before its
  // accumulator is read, so that no wgmma is serialized; the other
  // warpgroup's MMAs keep the tensor cores busy meanwhile.
  if constexpr (RS) pb::setmaxnreg_inc<kRegsCons>();
  // accumulator r of this thread: row i0 + 8 ((r / 2) % 2), column
  // j0 + 8 (r / 4) + r % 2
  const int i0 = 16 * warp + (lane >> 2), j0 = 2 * (lane & 3);
  int it = 0;
  for (int j = 0; j < mine; ++j) {
    const TileAt at = tile_at(p, blockIdx.x + j * gridDim.x);
    float acc[32], tmp[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      pb::mbar_wait(pb::smem_u32(&full[s]), (it / STAGES) & 1);
      if constexpr (RS) {
        const uint32_t sb = base + s * STAGE + Cf::buf(wg ? kOpDh : kOpDw,
                                                       0) * BUF;
        const uint8_t* da = sbase + s * STAGE +
                            Cf::buf(wg ? kOpB : kOpA, 0) * BUF;
        if (wg == 0)
          mma_step_hi<0>(sb, da, warp, lane, tmp);
        else
          mma_step_hi<1>(sb, da, warp, lane, tmp);
      } else {
        mma_step<Cf>(base + s * STAGE, wg, tmp);
      }
      pb::wgmma_wait<0>();
      pb::fence_regs(tmp);
      pb::mbar_arrive(pb::smem_u32(&empty[s]));
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[r] = __fadd_rn(acc[r], tmp[r]);
    }
    // gy to warpgroup 0, once warpgroup 0 has read the last tile's: in the
    // accumulator layout (thread t, register r at xchg[r * 128 + t]), or
    // for RS at (y, x) = (column, row) of gy^T, xchg[y XLD + x]
    pb::named_barrier(kBarCons, NCONS);
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if constexpr (RS)
          xchg[(j0 + 8 * (r >> 2) + (r & 1)) * XLD + i0 + 8 * ((r >> 1) & 1)] =
              acc[r];
        else
          xchg[r * WG + t] = acc[r];
      }
    }
    pb::named_barrier(kBarCons, NCONS);
    if (wg == 1) continue;
    const float(&ax)[32] = acc;
    float ay[32];
#pragma unroll
    for (int r = 0; r < 32; ++r)
      ay[r] = RS ? xchg[(i0 + 8 * ((r >> 1) & 1)) * XLD + j0 + 8 * (r >> 2) +
                        (r & 1)]
                 : xchg[r * WG + t];

    const int pl = at.pl;
    const long long plane = (long long)pl * p.ph * p.pw;
    if (EPI == kMaxima) {
      const float* __restrict__ cs = p.cs;
      float m[kAngles];
#pragma unroll
      for (int a = 0; a < kAngles; ++a) m[a] = 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int y = at.y0 + i0 + 8 * ((r >> 1) & 1);
        const int x = at.x0 + j0 + 8 * (r >> 2) + (r & 1);
        if (y < p.ph && x < p.pw) {
#pragma unroll
          for (int a = 0; a < kAngles; ++a) {
            const float d = __fsub_rn(__fmul_rn(cs[2 * a], ax[r]),
                                      __fmul_rn(cs[2 * a + 1], ay[r]));
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
      pb::named_barrier(kBarWg0, WG);
      if (t < kAngles) {
        const float v = fmaxf(fmaxf(red[0][t], red[1][t]),
                              fmaxf(red[2][t], red[3][t]));
        // non-negative floats order like their bit patterns
        atomicMax(reinterpret_cast<int*>(p.maxima) + pl * kAngles + t,
                  __float_as_int(v));
      }
      pb::named_barrier(kBarWg0, WG);
    } else if (EPI == kMaximaAny) {
      // the angles a0 .. a0 + 7 per pass, as kMaxima's 7
      const float* __restrict__ cs = p.cs;
      for (int a0 = 0; a0 < p.na1; a0 += kGroup) {
        float m[kGroup];
#pragma unroll
        for (int a = 0; a < kGroup; ++a) m[a] = 0.f;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int y = at.y0 + i0 + 8 * ((r >> 1) & 1);
          const int x = at.x0 + j0 + 8 * (r >> 2) + (r & 1);
          if (y < p.ph && x < p.pw) {
#pragma unroll
            for (int a = 0; a < kGroup; ++a) {
              if (a0 + a < p.na1) {
                const float d =
                    __fsub_rn(__fmul_rn(cs[2 * (a0 + a)], ax[r]),
                              __fmul_rn(cs[2 * (a0 + a) + 1], ay[r]));
                m[a] = fmaxf(m[a], fabsf(d));
              }
            }
          }
        }
#pragma unroll
        for (int a = 0; a < kGroup; ++a) {
          float v = m[a];
          for (int o = 16; o > 0; o >>= 1)
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
          if (lane == 0) red[warp][a] = v;
        }
        pb::named_barrier(kBarWg0, WG);
        if (t < kGroup && a0 + t < p.na1) {
          const float v = fmaxf(fmaxf(red[0][t], red[1][t]),
                                fmaxf(red[2][t], red[3][t]));
          atomicMax(reinterpret_cast<int*>(p.maxima) +
                        (long long)pl * p.na1 + a0 + t,
                    __float_as_int(v));
        }
        pb::named_barrier(kBarWg0, WG);
      }
    } else if (EPI == kGrads) {
      float part = 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int y = at.y0 + i0 + 8 * ((r >> 1) & 1);
        const int x = at.x0 + j0 + 8 * (r >> 2) + (r & 1);
        if (y < p.ph && x < p.pw) {
          const long long o = plane + (long long)y * p.pw + x;
          p.gx[o] = ax[r];
          p.gy[o] = ay[r];
          part = __fadd_rn(part, __fadd_rn(__fmul_rn(ax[r], ax[r]),
                                           __fmul_rn(ay[r], ay[r])));
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
      if (lane == 0) red[warp][0] = part;
      pb::named_barrier(kBarWg0, WG);
      if (t == 0) {
        const int tx = (p.pw + TN - 1) / TN;
        const int ntile = ((p.ph + TM - 1) / TM) * tx;
        p.part[(long long)pl * ntile + (at.y0 / TM) * tx + at.x0 / TN] =
            __fadd_rn(__fadd_rn(red[0][0], red[1][0]),
                      __fadd_rn(red[2][0], red[3][0]));
      }
      pb::named_barrier(kBarWg0, WG);
    } else {
      if (t == 0) {
        const int ntile = ((p.ph + TM - 1) / TM) * ((p.pw + TN - 1) / TN);
        float v = 0.f;
        for (int b = 0; b < ntile; ++b)
          v = __fadd_rn(v, p.part[(long long)pl * ntile + b]);
        s_nm = v;
      }
      pb::named_barrier(kBarWg0, WG);
      const float nm = s_nm;
      const int n = pl / p.C, c = pl - n * p.C;
      const float* gt = static_cast<const float*>(p.src.ptr) +
                        p.src.offset(n, c, 0, 0);
      const long long ub = p.ucmp.offset(n, c, 0, 0);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int y = at.y0 + i0 + 8 * ((r >> 1) & 1);
        const int x = at.x0 + j0 + 8 * (r >> 2) + (r & 1);
        if (y < p.ph && x < p.pw) {
          const long long o = plane + (long long)y * p.pw + x;
          const float M = __fsub_rn(-__fmul_rn(p.gx[o], ax[r]),
                                    __fmul_rn(p.gy[o], ay[r]));
          const float z = fmaxf(
              __fdiv_rn(M, __fadd_rn(__fadd_rn(nm, M), 1e-12f)), 0.f);
          const float ov = gt[(long long)y * p.src.sR + x];
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
      // s_nm is rewritten for the next tile only after every thread of
      // warpgroup 0 has read it
      pb::named_barrier(kBarWg0, WG);
    }
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

// ---------------------------------------------------------------- host

// Whether every tile of the view starts on a 16-byte boundary and its rows
// are whole 16-byte blocks apart, so that 8-pixel groups at multiples of 8
// columns load as vectors.
bool vec_ok(const pb::TileView& v, int esz) {
  const long long a = static_cast<long long>(
      reinterpret_cast<uintptr_t>(v.ptr));
  return a % 16 == 0 && (v.sR * esz) % 16 == 0 && (v.sC * esz) % 16 == 0 &&
         (v.batch == 1 || (v.sB * esz) % 16 == 0) &&
         (static_cast<long long>(v.step_w) * esz) % 16 == 0;
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <int EPI, typename S, bool VEC, bool HI>
int launch_gemm_io(const EstGemm& p, const CUtensorMap (&m)[4],
                   cudaStream_t s) {
  constexpr int kSmem =
      EstCfg<HI, EPI == kMaxima || EPI == kMaximaAny>::SMEM;
  auto kern = est_gemm_kernel<EPI, S, VEC, HI>;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const int tiles =
      p.planes * ((p.ph + TM - 1) / TM) * ((p.pw + TN - 1) / TN);
  kern<<<min(tiles, num_sms()), NT, kSmem, s>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

// The derivative GEMM pair over p.planes planes; g2, gt2 (kMaxima): the
// split normalized planes of stage 2, else null (the halo's planes are
// read from p.src).
template <int EPI, typename S, bool HI>
int launch_gemm(const EstGemm& p, const void* dw2, const void* dh2,
                const float* g2, const float* gt2, cudaStream_t s) {
  // the tables: (PT, n, pad64(n)) f32, hi first, read as K = n columns
  // the gray planes (kMaxima): PD pieces per tile
  constexpr long long PT = EstCfg<HI, true>::PT, PD = EstCfg<HI, true>::PD;
  const long long lw = (p.pw + 63) / 64 * 64, lh = (p.ph + 63) / 64 * 64;
  const long long ldp = pitch4(p.pw), ldq = pitch4(p.ph);
  CUtensorMap m[4];
  bool ok = pb::tma_map_3d(&m[0], dw2, true, p.pw, p.pw, PT, lw, lw * p.pw,
                           TN) &&
            pb::tma_map_3d(&m[1], dh2, true, p.ph, p.ph, PT, lh, lh * p.ph,
                           TM);
  if (EPI == kMaxima || EPI == kMaximaAny)
    ok = ok &&
         pb::tma_map_3d(&m[2], g2, true, p.pw, p.ph, PD * p.planes, ldp,
                        ldp * p.ph, TM) &&
         pb::tma_map_3d(&m[3], gt2, true, p.ph, p.pw, PD * p.planes, ldq,
                        ldq * p.pw, TN);
  else
    m[2] = m[3] = m[0];  // not read
  if (!ok) {
    fprintf(stderr, "estimate GEMM: cuTensorMapEncodeTiled refused a map\n");
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (EPI == kMaxima || EPI == kMaximaAny) {
    return launch_gemm_io<EPI, S, true, HI>(p, m, s);
  } else {
    if (vec_ok(p.src, sizeof(S)))
      return launch_gemm_io<EPI, S, true, HI>(p, m, s);
    return launch_gemm_io<EPI, S, false, HI>(p, m, s);
  }
}

template <typename S>
int launch_minmax(const pb::TileView& v, int C, int ph, int pw, int rows,
                  int na1, int n, float* mm, float* maxima, cudaStream_t s) {
  dim3 grid((ph + rows - 1) / rows, n);
  if (vec_ok(v, sizeof(S)))
    gray_minmax_kernel<S, true><<<grid, 256, 0, s>>>(v, C, ph, pw, rows, na1,
                                                     mm, maxima);
  else
    gray_minmax_kernel<S, false><<<grid, 256, 0, s>>>(v, C, ph, pw, rows,
                                                      na1, mm, maxima);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// view: the n tiles (canvas or tile batch, dtype `dtype`); high: the
// 'highest' instantiation (tables in PT = 3 pieces, g in PD = 1: f32;
// f32 tiles only) or the 3xTF32 one (0: PT = PD = 2;
// ops/cuda/sep_poly_fused.py dot_variant); dw2, dh2: the split derivative
// tables (PT, pw, pad64(pw)) and (PT, ph, pad64(ph)) f32 (hi first); mm:
// (n, bands, 2) f32 scratch, bands = ceil(ph / rows); g2, gt2: (n, PD, ph,
// pitch4(pw)) and (n, PD, pw, pitch4(ph)) f32 scratch;
// na1: the angle count (n_angles + 1), cs: its (na1, 2) f32 cos / sin;
// maxima: (n, na1) f32 scratch; est: (n, 8) f32 output. stage selects the
// launch (1 min/max, 2 normalize, 3 GEMM, 4 final) so the wrapper can
// count each; the directional maxima launch stages 1-3 only (wts, coeffs,
// est unused); stage 4 needs na1 = 7.
extern "C" int pb_tile_estimate(int stage, int dtype, const void* ptr,
                                long long sB, long long sC, long long sR,
                                int batch, int tile0, int tiles_w, int step_h,
                                int step_w, int n, int C, int ph, int pw,
                                int rows, int na1, const float* dw2,
                                const float* dh2,
                                const float* cs, const float* wts,
                                const float* coeffs, float* mm, float* g2,
                                float* gt2, float* maxima, float* est,
                                int high, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 65535 || rows < 1 || na1 < 1 || (stage == 4 && na1 != kAngles) ||
      (dtype != pb::kBF16 && dtype != pb::kF32) || (high != 0 && high != 1) ||
      (high && dtype != pb::kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool b16 = dtype == pb::kBF16;
  const pb::TileView v = pb::make_view(ptr, sB, sC, sR, batch, tile0,
                                       tiles_w, step_h, step_w);
  const int bands = (ph + rows - 1) / rows;
  if (stage == 1)
    return b16 ? launch_minmax<pb::bf16>(v, C, ph, pw, rows, na1, n, mm,
                                         maxima, s)
               : launch_minmax<float>(v, C, ph, pw, rows, na1, n, mm, maxima,
                                      s);
  if (stage == 2) {
    dim3 grid((pw + 31) / 32, (ph + 31) / 32, n);
    if (b16)
      gray_norm_kernel<pb::bf16, 2><<<grid, dim3(32, 8), 0, s>>>(
          v, C, ph, pw, bands, mm, g2, gt2);
    else if (high)
      gray_norm_kernel<float, 1><<<grid, dim3(32, 8), 0, s>>>(
          v, C, ph, pw, bands, mm, g2, gt2);
    else
      gray_norm_kernel<float, 2><<<grid, dim3(32, 8), 0, s>>>(
          v, C, ph, pw, bands, mm, g2, gt2);
    return static_cast<int>(cudaGetLastError());
  }
  if (stage == 3) {
    EstGemm p = {};
    p.src = v;
    p.C = C;
    p.ph = ph;
    p.pw = pw;
    p.planes = n;
    p.cs = cs;
    p.maxima = maxima;
    p.na1 = na1;
    if (high)
      return na1 == kAngles
                 ? launch_gemm<kMaxima, float, true>(p, dw2, dh2, g2, gt2, s)
                 : launch_gemm<kMaximaAny, float, true>(p, dw2, dh2, g2, gt2,
                                                         s);
    if (na1 == kAngles)
      return launch_gemm<kMaxima, float, false>(p, dw2, dh2, g2, gt2, s);
    return launch_gemm<kMaximaAny, float, false>(p, dw2, dh2, g2, gt2, s);
  }
  if (stage == 4) {
    tile_est_final_kernel<<<n, 32, 0, s>>>(maxima, wts, coeffs, n, est);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The halo mask's derivative GEMM pair over the n C planes of a TileView
// (dtype `dtype`): epi 1 writes the input gradients gx, gy ((n C, ph, pw)
// f32) and the per-output-tile partial sums `part` ((n C, ntile) f32,
// ntile the 64 x 64 output tiles per plane); epi 2 reads them back with
// the f32 output o as the operand (dtype f32), the unfiltered planes u (a
// TileView in `ucmp_dtype`) and the optional noise ((n C, ph, pw) f32),
// and writes the masked, clipped planes to `out` ((n C, ph, pw) in
// `out_dtype`; it may be the tensor u reads). high: as pb_tile_estimate's
// (the tables dw2, dh2 hold its PT pieces).
extern "C" int pb_halo_gemm(int epi, int dtype, const void* ptr, long long sB,
                            long long sC, long long sR, int batch, int tile0,
                            int tiles_w, int step_h, int step_w, int n, int C,
                            int ph, int pw, const float* dw2, const float* dh2,
                            float* gx, float* gy, float* part,
                            int ucmp_dtype, const void* uptr, long long usB,
                            long long usC, long long usR, int ubatch,
                            int utile0, int utiles_w, int ustep_h,
                            int ustep_w, const float* noise, void* out,
                            int out_dtype, int high, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)n * C * ((ph + TM - 1) / TM) * ((pw + TN - 1) / TN) >
          0x7fffffffLL ||
      (high != 0 && high != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  EstGemm p = {};
  p.src = pb::make_view(ptr, sB, sC, sR, batch, tile0, tiles_w, step_h,
                        step_w);
  p.C = C;
  p.ph = ph;
  p.pw = pw;
  p.planes = n * C;
  p.gx = gx;
  p.gy = gy;
  p.part = part;
  if (epi == kGrads) {
    if (dtype == pb::kBF16 && !high)
      return launch_gemm<kGrads, pb::bf16, false>(p, dw2, dh2, nullptr,
                                                  nullptr, s);
    if (dtype == pb::kF32 && high)
      return launch_gemm<kGrads, float, true>(p, dw2, dh2, nullptr, nullptr,
                                              s);
    if (dtype == pb::kF32)
      return launch_gemm<kGrads, float, false>(p, dw2, dh2, nullptr, nullptr,
                                               s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (epi == kHalo && dtype == pb::kF32) {
    if ((ucmp_dtype != pb::kF32 && ucmp_dtype != pb::kBF16) ||
        (out_dtype != pb::kF32 && out_dtype != pb::kBF16))
      return static_cast<int>(cudaErrorInvalidValue);
    p.ucmp = pb::make_view(uptr, usB, usC, usR, ubatch, utile0, utiles_w,
                           ustep_h, ustep_w);
    p.ucmp_dtype = ucmp_dtype;
    p.noise = noise;
    p.out = out;
    p.out_dtype = out_dtype;
    if (high)
      return launch_gemm<kHalo, float, true>(p, dw2, dh2, nullptr, nullptr,
                                             s);
    return launch_gemm<kHalo, float, false>(p, dw2, dh2, nullptr, nullptr,
                                            s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
