// kernel_spectrum and spectral_gemm: the 2D-spectral polynomial
// deconvolution p(K) of a batch of (tile, channel) planes.
//
// kernel_spectrum replaces polyblur_tpu/ops/pallas/sep_poly_fused.py::
// _kernel_spectrum_block and the Horner/packing lines of
// polyblur_fused.py::_make_kernel (:372-373) and of sep_poly_fused.py::
// _make_kernel (:316-319): per plane, the T x T masked, normalized
// Gaussian (T = 2 half + 1 taps: 25 on the patch engine's path, up to 31
// for the whole-image polynomial, as the TPU kernel's 32-column tap tables
// allow) from its quadratic form (qa, qb, qc) -> (T x Kp) tap products
// against the x-phase tables -> (h x Kp) real OTF through the y-phase
// tables, all f32; then p(K_hat) by Horner and the packed [q | q] * (1/h)
// spectrum. The quadratic forms are read from rows of any stride (the
// (n, 8) estimate rows, or the (N, 3) params of fused_polynomial).
// Bound on the H100: bytes, its f32 output (~1 MB per 448 px plane); the
// design is in the spectrum section below.
//
// spectral_gemm replaces sep_poly_fused.py::_spectral_poly_block, the six
// DFT products the mega kernel runs per channel per iteration, and the
// whole of sep_poly_fused.py::_make_kernel (fused_polynomial_pallas) after
// its spectrum. The TPU program holds a 472 x 472 f32 canvas, its packed
// spectra and the DFT tables in VMEM; a Hopper SM has 227 KB of shared
// memory, so the application is four batched GEMM launches over (tile,
// channel) planes with the intermediates in device memory, stored in the
// work dtype (exactly where the TPU kernel rounds its product operands).
// The y-DFT runs on stacked real/imaginary parts, Rst = [Rr ; Ri] (2h x kp),
// so that each product is a plain GEMM against a constant table (no
// half-swap or sign in any operand load):
//   mode 1  R^T = F^T pad(x)^T       -> RS = Rst^T (kp x 2h)
//   mode 2  Pst = q * (T2 Rst),  T2 = [[Cy, Sy], [-Sy, Cy]]  -> PS = Pst^T;
//           the spectrum multiply in the epilogue, before the cast
//   mode 3  Zst = T3 Pst,        T3 = [[Cy, -Sy], [Sy, Cy]]  -> ZZ = [Zr | Zi]
//   mode 4  x' = cast(clip?(crop(ZZ G)))    only the cropped block; or,
//           with the taper, x' = a pad(x) + (1 - a) ZZ G in f32, a the
//           tile's weight map av[i] ah[j]: the blend of the edgetaper
//           (polyblur_fused.py:493-498) in the epilogue of its blur
// The pad width of mode 1 and the crop of mode 4 are launch arguments: 12
// (the patch engine, the tiles route and the fused whole-image polynomial
// pad by the kernel half-support), 0 (the overlap-save blocks of the
// blocked route, whose canvas is the block itself), or one of each (the
// taper pads the tile onto the whole canvas, then crops the canvas back).
// The clip to [0, 1] is a flag. Mode 1 may read f32 planes (the
// prefilter's smooth part, the taper's canvas) and round them to the work
// dtype as it loads them; mode 4 may write f32 (the taper's blur K u, the
// output the halo mask reads) and add the prefilter's noise after the
// clip. The taper's three applications (the degree-1 operator K on the
// whole canvas) each blend K u with u itself in mode 4's epilogue: K u
// never reaches device memory, and the blend costs mode 4 one more read
// of u (and of the weight vectors) instead of a launch of its own.
//
// Bound on the H100: operations — 684 M MACs per (tile, channel) plane at
// 448 px tiles, ~115 M per 280 x 240 block of the 2 MP blocked route.
// Design: A and B are K-major everywhere; TMA brings 128-byte-swizzled
// tiles through an mbarrier ring from one producer thread, and two
// consumer warpgroups run wgmma m64n128 on them with f32 accumulators in
// registers, one MMA group in flight; bf16 products run two blocks per SM
// so that one block's epilogue overlaps the other's MMAs. The epilogues
// (layout change, the spectrum multiply, crop / clip / noise / cast) load
// what they need first, then store straight from the registers, two
// elements per store; the taper's blend stages the tile in the idle ring
// and walks it in row-contiguous float4s (see taper_tile). Mode 1's B
// operand (the tiles, replicate-padded, f32 or work dtype) comes by TMA
// from the source, the tile's origin in the box coordinates, where the
// work dtype is bf16 and the source's base and strides are whole 16-byte
// blocks (the TMA feed); otherwise (any stride) the producer warpgroups
// write all of it into the stages (the gather). On the TMA feed the
// producer warp rewrites only the column margins of the tile's rows, and
// the margin rows, which repeat the first and last row, are left as TMA
// brought them: their columns of C are the copies the epilogue writes of
// the first and last interior column. A box must start on a 16-byte block
// of the source (elsewhere it raises an illegal instruction), so a tile
// whose padded origin lies d columns past one is read from d columns left
// of it against a copy of F^T moved d columns right: the same products d
// places later in K, which the tensor cores group into other 16-deep
// sums, so that RS may differ from the gather's in a last bit (d = 0: the
// gather's bits). bf16 operands run on bf16 wgmma; f32 operands run
// 3xTF32 (a = hi + lo, hi = a rounded to tf32; a b ~ hi hi + hi lo + lo hi
// on tf32 wgmma, ~2^-22 relative per product), the counterpart of the TPU
// kernel's error-compensated bf16 split (sep_poly_fused.py::_split_bf16);
// the split is made in shared memory by the consumers.
//
// The f32 dot mode 'highest' (ops/cuda/sep_poly_fused.py set_f32_dot_mode,
// the TPU kernel's Precision.HIGHEST, sep_poly_fused.py:255-258) is a
// kernel of its own (gemm_hi_kernel): a = hi + mid + lo, each rounded to
// tf32, and six products (lo hi, hi lo, mid mid, mid hi, hi mid, then hi
// hi), a split that leaves ~2^-33 of each operand. Adding lo lo to the
// two-piece split would buy nothing: its lo already leaves ~2^-22. The
// tensor cores' f32 accumulation truncates, which over the whole of K
// costs more than the two-piece split itself (a CPU emulation: ~95 dB from
// plain f32 for one 448 px application), so each 32-deep K stage runs into
// a fresh accumulator, its five small products first, and is added to the
// running sum with a rounded f32 add (~120 dB from plain f32, which is
// itself ~122 dB from exact). Every product has one constant table as an
// operand; the host splits the tables into their three pieces once
// (ops/cuda/polyblur_fused.py table_pieces) and TMA brings them, while
// the data arrives in f32 and each consumer splits its own rows in
// registers, as wgmma's A operand (A from registers): a stage of modes
// 2-4 is 40 KB against the three-piece design's 72 KB, and no barrier
// holds the two consumer warpgroups together. Modes 1 and 3 hold the data
// as B, so they run transposed (C^T = data table^T) with the factors of
// each product swapped, and every output element sums the same products
// in the same order as the design that split both operands in shared
// memory: the outputs are bit-equal to it. On the CPU
// tests/test_torch_spectral_highest.py holds the order, on the card
// tools/spectral_highest_ab.py the bits.
#include <cstdio>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using pb::bf16;

// ---------------------------------------------------------------- spectrum
//
// The output is (n, h, 2 kp) f32, ~1 MB per 448 px plane, for ~6 M f32
// FMAs of y-pass per plane: the least time is that of the stores, and at
// n = 1 the latency of one block is most of it. Design: a block owns 64
// spectrum columns of a chunk of rows of one plane, grid (kp / 64, row
// chunks, n), the chunks sized on the host so that n = 1, 12 and 88 each
// give the 132 SMs several blocks. The block forms the plane's normalized
// Gaussian and its x-pass (tap products) for its 64 columns in shared
// memory (forming them once per plane in a first launch measured slower
// at n = 1, 12 and 88: PERF.md, the kernel_spectrum row); then walks
// its rows in passes of 64, staging the y-phase rows transposed in shared
// memory, with each thread computing a 4 x 4 block of rows x columns from
// float4 reads (4 loads for 32 FMAs) and writing both halves of the
// packed row with 16-byte stores. Loops whose trip count all threads
// share start all their global loads at once. Every dot product sums in the
// same order as the plain version's steps (taps t, then row offsets j,
// ascending; one FMA each).
//
// The half-support is a template parameter H: the patch engine's 12 (ker
// size 25) is its own instantiation, with every tap loop's trip count a
// constant, as before; H = -1 takes the half-support (0 .. kMaxHalf) at
// run time, with shared arrays sized for 31 taps (~36 KB).

constexpr int kHalf = 12;         // the patch engine's half-support
constexpr int kMaxHalf = 15;      // 31 taps: the tap tables' 32 columns
constexpr int kSpecCols = 64;     // spectrum columns per block
constexpr int kSpecRows = 64;     // rows per pass: 16 row groups of 4
constexpr int kSpecThreads = 256; // 16 column groups x 16 row groups
constexpr int kYPitch = kSpecRows + 4;  // staged y-phase rows (16-byte rows)

// taps the shared arrays of instantiation H hold
template <int H>
constexpr int spec_taps() { return 2 * (H < 0 ? kMaxHalf : H) + 1; }

template <int H>
struct SpecTaps {
  static constexpr int T = spec_taps<H>();
  float km[T * T];
  float red[8];
  __align__(16) float hr[T][kSpecCols];
  __align__(16) float hi[T][kSpecCols];
};

// The normalized taps x taps Gaussian (taps = 2 half + 1; half = H when H
// >= 0) of the quadratic form (qa, qb, qc) into s.km, then its tap
// products against the x-phase tables for columns k0 .. k0 + 63:
// s.hr[j][c] = sum_t km[j][t] er[t][k0 + c], t ascending; s.hi likewise
// with ei. Ends with a barrier.
template <int H>
__device__ __forceinline__ void spectrum_taps(
    float qa, float qb, float qc, const float* __restrict__ er,
    const float* __restrict__ ei, int kp, int k0, int half, SpecTaps<H>& s) {
  const int hf = H < 0 ? half : H;
  const int kTaps = 2 * hf + 1;
  const int tid = threadIdx.x;
  float part = 0.f;
  for (int e = tid; e < kTaps * kTaps; e += kSpecThreads) {
    const float jf = static_cast<float>(e / kTaps - hf);  // row offset
    const float tf = static_cast<float>(e % kTaps - hf);  // column offset
    const float quad = __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(qa, tf), tf),
                  __fmul_rn(__fmul_rn(__fmul_rn(2.f, qb), tf), jf)),
        __fmul_rn(__fmul_rn(qc, jf), jf));
    const float v = expf(__fmul_rn(-0.5f, quad));
    s.km[e] = v;
    part = __fadd_rn(part, v);
  }
  for (int o = 16; o > 0; o >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
  if (tid % 32 == 0) s.red[tid / 32] = part;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kSpecThreads / 32; ++w)
    total = __fadd_rn(total, s.red[w]);
  const float inv_total = __fdiv_rn(1.f, total);
  __syncthreads();
  for (int e = tid; e < kTaps * kTaps; e += kSpecThreads)
    s.km[e] = __fmul_rn(s.km[e], inv_total);
  __syncthreads();
  // thread: column c, tap rows j0, j0 + 4, .. (7 at most for 25 taps, 8
  // for 31); each er / ei value is loaded once for all of them
  const int c = tid % kSpecCols;
  const int j0 = tid / kSpecCols;
  constexpr int kRowsPerThread = (SpecTaps<H>::T + 3) / 4;
  float sr[kRowsPerThread], si[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) sr[m] = si[m] = 0.f;
#pragma unroll 5
  for (int t = 0; t < kTaps; ++t) {
    const float vr = er[t * kp + k0 + c];
    const float vi = ei[t * kp + k0 + c];
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int j = j0 + 4 * m;
      if (j < kTaps) {
        const float kv = s.km[j * kTaps + t];
        sr[m] = fmaf(kv, vr, sr[m]);
        si[m] = fmaf(kv, vi, si[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int j = j0 + 4 * m;
    if (j < kTaps) {
      s.hr[j][c] = sr[m];
      s.hi[j][c] = si[m];
    }
  }
  __syncthreads();
}

// plane n's quadratic form is q[n * stride + off + 0..2] = (qa, qb, qc).
// Block (x, y, z) = (64 columns, `rows` rows, plane).
template <int H>
__global__ void __launch_bounds__(kSpecThreads)
kernel_spectrum_kernel(const float* __restrict__ q, int stride, int off,
                       const float* __restrict__ coeffs,
                       const float* __restrict__ er,   // (128, kp)
                       const float* __restrict__ ei,   // (128, kp)
                       const float* __restrict__ cyt,  // (h, 32)
                       const float* __restrict__ syt,  // (h, 32)
                       int h, int kp, int rows, int half,
                       float* __restrict__ qhat2) {
  constexpr int T = SpecTaps<H>::T;
  __shared__ SpecTaps<H> s;
  __shared__ __align__(16) float cys[T][kYPitch];
  __shared__ __align__(16) float sys[T][kYPitch];
  const int kTaps = 2 * (H < 0 ? half : H) + 1;
  const int n = blockIdx.z;
  const int k0 = blockIdx.x * kSpecCols;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(h, r0 + rows);
  const int tid = threadIdx.x;
  const float* qn = q + (long long)n * stride + off;
  spectrum_taps<H>(qn[0], qn[1], qn[2], er, ei, kp, k0, half, s);
  const float a3 = coeffs[0], a2 = coeffs[1], a1 = coeffs[2], beta = coeffs[3];
  const float inv_h = __fdiv_rn(1.f, static_cast<float>(h));
  const int cg = tid % 16, rg = tid / 16;
  float* out = qhat2 + (long long)n * h * 2 * kp + k0 + 4 * cg;
  for (int p0 = r0; p0 < r1; p0 += kSpecRows) {
    // the y-phase rows p0 .. p0 + 63, transposed: a warp reads one
    // 128-byte table row (32 columns, 25 used); all loads are started
    // before the barrier that ends the last pass
    constexpr int kStage = kSpecRows * 32 / kSpecThreads;
    const int jt = tid % 32;
    float cst[kStage], sst[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int r = tid / 32 + k * (kSpecThreads / 32);
      const bool in = jt < kTaps && p0 + r < r1;
      cst[k] = in ? cyt[(p0 + r) * 32 + jt] : 0.f;
      sst[k] = in ? syt[(p0 + r) * 32 + jt] : 0.f;
    }
    __syncthreads();  // the taps are in; the last pass read its rows
    if (jt < kTaps) {
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int r = tid / 32 + k * (kSpecThreads / 32);
        cys[jt][r] = cst[k];
        sys[jt][r] = sst[k];
      }
    }
    __syncthreads();
    float s1[4][4], s2[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s1[r][c] = s2[r][c] = 0.f;
#pragma unroll 5
    for (int j = 0; j < kTaps; ++j) {
      const float4 cy = *reinterpret_cast<const float4*>(&cys[j][4 * rg]);
      const float4 sy = *reinterpret_cast<const float4*>(&sys[j][4 * rg]);
      const float4 hr = *reinterpret_cast<const float4*>(&s.hr[j][4 * cg]);
      const float4 hi = *reinterpret_cast<const float4*>(&s.hi[j][4 * cg]);
      const float cv[4] = {cy.x, cy.y, cy.z, cy.w};
      const float sv[4] = {sy.x, sy.y, sy.z, sy.w};
      const float rv[4] = {hr.x, hr.y, hr.z, hr.w};
      const float iv[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s1[r][c] = fmaf(cv[r], rv[c], s1[r][c]);
          s2[r][c] = fmaf(sv[r], iv[c], s2[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = p0 + 4 * rg + r;
      if (row < r1) {
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kh = __fadd_rn(s1[r][c], s2[r][c]);
          float p = __fadd_rn(__fmul_rn(a3, kh), a2);
          p = __fadd_rn(__fmul_rn(p, kh), a1);
          p = __fadd_rn(__fmul_rn(p, kh), beta);
          o[c] = __fmul_rn(p, inv_h);
        }
        const float4 v = make_float4(o[0], o[1], o[2], o[3]);
        float* dst = out + (long long)row * 2 * kp;
        *reinterpret_cast<float4*>(dst) = v;
        *reinterpret_cast<float4*>(dst + kp) = v;
      }
    }
  }
}

// ------------------------------------------------------------------- GEMM
//
// Every product is C = A B^T with A (M x K) and B (N x K) both K-major
// (row-major with K contiguous), the one layout wgmma takes for tf32 and
// its fastest for bf16. Block tile BM x BN = 128 x 128; K in steps of 128
// bytes (64 bf16 / 32 f32) through a ring of shared-memory stages. Warps
// 0-7 are two consumer warpgroups (64 rows each) running wgmma; after
// them comes the producer: one thread starts the TMA loads. Mode 1's B,
// the replicate-padded tiles, comes one of two ways (the feed, chosen on
// the host from what the source is: ops/cuda/polyblur_fused.py
// mode1_feed). With a bf16 work dtype and a source in bf16 or f32 whose
// base and strides are whole 16-byte blocks, TMA brings the tile's rows as
// they lie in the source, the tile's origin in the box coordinates, and
// the producer warp rewrites only the margins (tma_margins); otherwise two
// producer warpgroups write all of B into the swizzled stage themselves
// (fill_stage: any stride or dtype).

constexpr int BM = 128;
constexpr int NCONS = 256;            // two consumer warpgroups

// IO flags, template parameters so that each instantiation keeps only its
// own loads and stores: kF32IO — mode 1 reads f32 tiles and rounds them to
// the work dtype, mode 4 writes f32 instead of the work dtype; kNoise —
// mode 4 adds the noise plane after the clip and clips again; kTaper —
// mode 4 (f32 out, no clip) blends its product with the application's
// input tiles by the taper weights; kTmaFeed — mode 1 (bf16) takes the
// tiles by TMA.
constexpr int kF32IO = 1, kNoise = 2, kTaper = 4, kTmaFeed = 8;

// Per (product, dtype, feed): bf16 modes 2-4 and mode 1 on the TMA feed
// run two blocks per SM (one producer warp, 96 registers a thread), so
// that one block's prologue and epilogue overlap the other's MMAs; mode 1
// on the gather (whose producer is two warpgroups writing B) and the f32
// split (twice the stage bytes) run one block per SM with a deeper ring.
// The TMA feed of f32 tiles brings each stage's 64 columns as two f32
// boxes, which the consumers round to bf16 in place into the first: its
// 48 KB stages fit two blocks per SM at two stages. (Rounding them into
// wgmma's A fragments instead, C^T = data table^T, ran 1.5x slower: the
// registers allow one MMA group at a time.)
template <int MODE, typename T, int IO = 0>
struct Cfg {
  static constexpr int BK = 128 / sizeof(T);       // K per stage
  static constexpr bool kSplit = sizeof(T) == 4;   // 3xTF32
  static constexpr int PIECES = kSplit ? 2 : 1;
  static constexpr bool kFeed =
      MODE == 1 && !kSplit && (IO & kTmaFeed) != 0;
  static constexpr bool kF32In = kFeed && (IO & kF32IO) != 0;
  static constexpr bool kPair = !kSplit && (MODE != 1 || kFeed);
  static constexpr int BN = 128;                   // tile columns
  static constexpr int ACC = BN / 2;               // accumulator floats
  // producer threads: the gather writes B with two warpgroups
  static constexpr int NPROD = MODE == 1 && !kFeed ? 256 : kPair ? 32 : 128;
  static constexpr int NT = NCONS + NPROD;
  static constexpr int BLOCKS = kPair ? 2 : 1;     // per SM
  static constexpr int STAGES = kF32In ? 2 : kSplit || kPair ? 3 : 4;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BN * 128;
  // the fed B as TMA brings it: one box of the source's 128-byte rows, or
  // two of f32
  static constexpr int B_RAW = kF32In ? 2 * B_BYTES : B_BYTES;
  // per stage: A, B, and for the split their smaller pieces after them
  static constexpr int PAIR = A_BYTES + B_BYTES;
  static constexpr int STAGE = kF32In ? A_BYTES + B_RAW : PAIR * PIECES;
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

struct GemmParams {
  pb::TileView src;     // mode 1: the tiles (canvas, state or f32 planes)
  void* dst;            // the product's destination
  const float* qhat2;   // mode 2: (n, h, 2kp)
  const float* noise;   // mode 4: (planes, ph, pw) f32 added after the clip
  int C, ph, pw, h, wc, kp, half, clip;
  int M, N, K;
  int ldd;              // destination row length, elements
  long long dplane;     // destination plane stride, elements
  const float* av;      // mode 4 with the taper: (n, h) row weights
  const float* ah;      //   and (n, wc) column weights
  int tpad, tu_f32;     //   src padded by tpad onto the canvas; f32 or T
  int src_w;            // mode 1's TMA feed: the source's columns
  void* rnd;            // mode 4 with the taper: the output in bf16 too, or
                        //   null
};

__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

// Lane `idx` of the 16-byte vectors r[], as f32 (idx a compile-time
// constant after unrolling).
template <typename TS>
__device__ __forceinline__ float lane(const uint4* r, int idx) {
  constexpr int VI = 16 / sizeof(TS);
  const uint4 v = r[idx / VI];
  const int e = idx % VI;
  if constexpr (sizeof(TS) == 4) {
    const uint32_t w = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
    return __uint_as_float(w);
  } else {
    const int wi = e / 2;
    const uint32_t w = wi == 0 ? v.x : wi == 1 ? v.y : wi == 2 ? v.z : v.w;
    return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
  }
}

// 32-bit word `idx` of the 16-byte vectors r[] (idx a compile-time
// constant after unrolling).
__device__ __forceinline__ uint32_t word(const uint4* r, int idx) {
  const uint4 v = r[idx / 4];
  const int e = idx % 4;
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Mode 1's B stage: rows n0.. of the (h x wc) replicate-padded canvas of
// plane pl, columns k0 .. k0 + BK, zero outside it, in 16-byte chunks of
// the 128B-swizzled rows (chunk c of row r sits at c ^ (r % 8)); each of
// the PT producer threads writes NB * 8 / PT chunks (NB rows: the tile's
// BN), in batches of CB whose
// loads are all in flight before any is used. K >= 0: every source row
// starts K elements past a 16-byte boundary (the rows' stride is whole
// 16-byte blocks), so a chunk inside the tile is NV aligned 16-byte
// loads; chunks that reach into the replicated margins (and every chunk
// for K < 0) load element-wise.
template <typename T, typename TS, int K, int NV, int CB, int PT>
__device__ __forceinline__ void fill_batch(const GemmParams& p,
                                           const TS* base, int n0, int k0,
                                           uint8_t* sb, int t) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CH = CB;
  uint4 raw[CH][NV];
  bool vec[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int q = t + j * PT, r = q >> 3;
    const int y = n0 + r, sx0 = k0 + (q & 7) * E - p.half;
    vec[j] = K >= 0 && y < p.h && sx0 >= 0 && sx0 + E <= p.pw;
    if (vec[j]) {
      const int sy = min(max(y - p.half, 0), p.ph - 1);
      const uint4* a = reinterpret_cast<const uint4*>(
          base + static_cast<long long>(sy) * p.src.sR + sx0 -
          (K < 0 ? 0 : K));
#pragma unroll
      for (int v = 0; v < NV; ++v) raw[j][v] = __ldg(a + v);
    }
  }
  // same dtype and a shift of whole 32-bit words: the chunk is four of
  // the loaded words, moved without conversion
  constexpr bool kMove =
      sizeof(TS) == sizeof(T) && K >= 0 && (K * sizeof(T)) % 4 == 0;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int q = t + j * PT, r = q >> 3, cc = q & 7;
    uint8_t* dst = sb + r * 128 + ((cc ^ (r & 7)) << 4);
    if constexpr (kMove) {
      if (vec[j]) {
        constexpr int W0 = (K < 0 ? 0 : K) * sizeof(T) / 4;
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(word(raw[j], W0), word(raw[j], W0 + 1),
                       word(raw[j], W0 + 2), word(raw[j], W0 + 3));
        continue;
      }
    }
    const int y = n0 + r, x0 = k0 + cc * E;
    float v[E];
    if (vec[j]) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] = lane<TS>(raw[j], (K < 0 ? 0 : K) + e);
    } else if (y < p.h) {
      const int sy = min(max(y - p.half, 0), p.ph - 1);
      const TS* row = base + static_cast<long long>(sy) * p.src.sR;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int x = x0 + e;
        v[e] = x < p.wc ? pb::to_f32(row[min(max(x - p.half, 0), p.pw - 1)])
                        : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = 0.f;
    }
    uint4 w;
    if constexpr (E == 8) {
      w.x = pack2(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
      w.y = pack2(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
      w.z = pack2(__float2bfloat16_rn(v[4]), __float2bfloat16_rn(v[5]));
      w.w = pack2(__float2bfloat16_rn(v[6]), __float2bfloat16_rn(v[7]));
    } else {
      w = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
    }
    *reinterpret_cast<uint4*>(dst) = w;
  }
}

template <typename T, typename TS, int K, int PT, int NB>
__device__ __forceinline__ void fill_padded(const GemmParams& p,
                                            const TS* base, int n0, int k0,
                                            uint8_t* sb, int t) {
  constexpr int E = 16 / sizeof(T);
  constexpr int VI = 16 / sizeof(TS);
  constexpr int CH = NB * 8 / PT;
  constexpr int NV = K < 0 ? 1 : (K + E + VI - 1) / VI;
  constexpr int CB = NV > 2 ? CH / 2 : CH;  // chunks per batch of loads
#pragma unroll
  for (int j0 = 0; j0 < CH; j0 += CB)
    fill_batch<T, TS, K, NV, CB, PT>(p, base, n0, k0, sb, t + j0 * PT);
}

// The shift K of fill_padded for plane pl's tile: -1 unless every row
// starts at the same offset from a 16-byte boundary.
template <typename TS>
__device__ __forceinline__ int fill_shift(const GemmParams& p,
                                          const TS* base) {
  constexpr int VI = 16 / sizeof(TS);
  if ((p.src.sR * static_cast<long long>(sizeof(TS))) % 16 != 0) return -1;
  const long long e =
      static_cast<long long>(reinterpret_cast<uintptr_t>(base) / sizeof(TS)) -
      p.half;
  return static_cast<int>(((e % VI) + VI) % VI);
}

template <typename T, typename TS, int PT, int NB>
__device__ __forceinline__ void fill_stage(const GemmParams& p,
                                           const TS* base, int shift, int n0,
                                           int k0, uint8_t* sb, int t) {
  switch (shift) {
    case 0: fill_padded<T, TS, 0, PT, NB>(p, base, n0, k0, sb, t); break;
    case 1: fill_padded<T, TS, 1, PT, NB>(p, base, n0, k0, sb, t); break;
    case 2: fill_padded<T, TS, 2, PT, NB>(p, base, n0, k0, sb, t); break;
    case 3: fill_padded<T, TS, 3, PT, NB>(p, base, n0, k0, sb, t); break;
    case 4: fill_padded<T, TS, 4, PT, NB>(p, base, n0, k0, sb, t); break;
    case 5: fill_padded<T, TS, 5, PT, NB>(p, base, n0, k0, sb, t); break;
    case 6: fill_padded<T, TS, 6, PT, NB>(p, base, n0, k0, sb, t); break;
    case 7: fill_padded<T, TS, 7, PT, NB>(p, base, n0, k0, sb, t); break;
    default: fill_padded<T, TS, -1, PT, NB>(p, base, n0, k0, sb, t); break;
  }
}

// pad(x)'s element at column x of a row whose first and last elements have
// the bits el and er, where TMA brought `keep` (interior columns lo .. hi -
// 1 of wc): 0 left of column 0 and from wc on.
__device__ __forceinline__ uint32_t margin_bits(int x, uint32_t keep,
                                                uint32_t el, uint32_t er,
                                                int lo, int hi, int wc) {
  return x < 0 || x >= wc ? 0u : x < lo ? el : x >= hi ? er : keep;
}

// Mode 1's TMA feed: lane t's rows of pad(x) in a block of BN rows from
// n0 are n0 + t + 32 i; el[i], er[i] get the bits of the first and last
// element of the tile's row there where it is one (load once a block).
template <typename TS, int BN>
__device__ __forceinline__ void row_ends(const GemmParams& p, const TS* src,
                                         int n0, int t,
                                         uint32_t (&el)[BN / 32],
                                         uint32_t (&er)[BN / 32]) {
  using U = typename std::conditional<sizeof(TS) == 4, uint32_t,
                                      unsigned short>::type;
  const U* s = reinterpret_cast<const U*>(src);
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    const int y = n0 + t + 32 * i - p.half;    // the tile's row
    el[i] = er[i] = 0u;
    if (y >= 0 && y < p.ph) {
      const U* row = s + static_cast<long long>(y) * p.src.sR;
      el[i] = __ldg(row);
      er[i] = __ldg(row + p.pw - 1);
    }
  }
}

// Mode 1's TMA feed, the producer warp's part of a stage that reaches the
// column margins: `raw` holds NBOX boxes of the source's 128-byte rows in
// the stage's swizzle for rows n0 .. n0 + BN - 1 of pad(x), as TMA brought
// them from around the tile (done on `landed`, phase par); stage column k
// holds pad(x)'s column k0 + k - d, d the feed's shift (see gemm_kernel).
// In every interior row the chunks that reach left of `half` or past half
// + pw - 1 are rewritten: the row's first element (el) left of `half`, its
// last (er) from half + pw on, 0 left of column 0 and from wc on, TMA's
// elements between; a lane's four rows at once, a chunk of one kind of
// column stored whole without a load. The margin rows are left as TMA
// brought them: each reaches only its own column of C, which the epilogue
// writes from the interior row it repeats (feed_store_pair).
template <typename TS, int NBOX, int BN>
__device__ __forceinline__ void tma_margins(
    const GemmParams& p, int n0, int k0, int d, uint8_t* raw,
    uint32_t landed, uint32_t par, int t, const uint32_t (&el)[BN / 32],
    const uint32_t (&er)[BN / 32]) {
  constexpr int E = 16 / sizeof(TS);   // elements per 16-byte chunk
  constexpr int CH = NBOX * 8;         // chunks per stage row
  constexpr int RPL = BN / 32;         // rows per lane
  const int lo = p.half, hi = p.half + p.pw;   // pad(x)'s interior columns
  const int x_k0 = k0 - d;                     // stage column 0's
  // chunks 0 .. jl - 1 reach left of lo, jr .. CH - 1 past hi - 1
  const int jl = min(CH, max(0, (lo - x_k0 + E - 1) / E));
  const int jr = max(jl, min(CH, max(0, (hi - x_k0) / E)));
  pb::mbar_wait(landed, par);
#pragma unroll 1
  for (int j = jl > 0 ? 0 : jr; j < CH; j = j + 1 == jl ? jr : j + 1) {
    const int x0 = x_k0 + j * E, x1 = x0 + E;
    uint4* q[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int r = t + 32 * i;
      q[i] = reinterpret_cast<uint4*>(raw + (j / 8) * (BN * 128) + r * 128 +
                                      (((j & 7) ^ (r & 7)) << 4));
    }
    // a chunk of one kind of column takes one value, without a load
    const int kind = x1 <= 0 || x0 >= p.wc       ? 0
                     : x0 >= 0 && x1 <= lo        ? 1
                     : x0 >= hi && x1 <= p.wc     ? 2
                                                  : 3;
    if (kind < 3) {
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const int y = n0 + t + 32 * i - p.half;
        if (y < 0 || y >= p.ph) continue;      // a margin row
        uint32_t w = kind == 0 ? 0u : kind == 1 ? el[i] : er[i];
        if constexpr (E == 8) w |= w << 16;
        *q[i] = make_uint4(w, w, w, w);
      }
      continue;
    }
    uint4 v[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) v[i] = *q[i];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int y = n0 + t + 32 * i - p.half;
      if (y < 0 || y >= p.ph) continue;        // a margin row
      uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (E == 4) {
          w[k] = margin_bits(x0 + k, w[k], el[i], er[i], lo, hi, p.wc);
        } else {
          const uint32_t a = margin_bits(x0 + 2 * k, w[k] & 0xffffu, el[i],
                                         er[i], lo, hi, p.wc);
          const uint32_t b = margin_bits(x0 + 2 * k + 1, w[k] >> 16, el[i],
                                         er[i], lo, hi, p.wc);
          w[k] = a | (b << 16);
        }
      }
      *q[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The TMA feed of f32 tiles, on the consumers: the stage's two f32 boxes
// (columns k0 .. k0 + 31 and k0 + 32 .. k0 + 63 of 128 rows) rounded to
// bf16 in place into the first, which then is B, as the gather rounds
// them. Thread tid takes half tid % 2 of row tid / 2: it reads its box's
// row, and writes its four chunks of the first box's row once its warp,
// which holds the row's other half, has read.
__device__ __forceinline__ void round_f32_stage(uint8_t* raw, int tid) {
  constexpr int kBox = 128 * 128;
  const int r = tid >> 1, hf = tid & 1, sw = r & 7;
  const uint8_t* row = raw + hf * kBox + r * 128;
  uint4 w[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 a =
        *reinterpret_cast<const float4*>(row + (((2 * m) ^ sw) << 4));
    const float4 b =
        *reinterpret_cast<const float4*>(row + (((2 * m + 1) ^ sw) << 4));
    w[m] = make_uint4(
        pack2(__float2bfloat16_rn(a.x), __float2bfloat16_rn(a.y)),
        pack2(__float2bfloat16_rn(a.z), __float2bfloat16_rn(a.w)),
        pack2(__float2bfloat16_rn(b.x), __float2bfloat16_rn(b.y)),
        pack2(__float2bfloat16_rn(b.z), __float2bfloat16_rn(b.w)));
  }
  __syncwarp();
  uint8_t* out = raw + r * 128;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    *reinterpret_cast<uint4*>(out + (((4 * hf + m) ^ sw) << 4)) = w[m];
}

using pb::tf32_hi;

// 3xTF32: the raw f32 tile at `raw` becomes its tf32 part in place, its
// remainder (also rounded to tf32) goes to `lo`; 128 threads, 16 B each
// step.
__device__ __forceinline__ void split_tf32(uint8_t* raw, uint8_t* lo,
                                           int bytes, int t) {
  for (int o = t * 16; o < bytes; o += 128 * 16) {
    float4 v = *reinterpret_cast<float4*>(raw + o);
    float4 h = make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z),
                           tf32_hi(v.w));
    *reinterpret_cast<float4*>(raw + o) = h;
    *reinterpret_cast<float4*>(lo + o) =
        make_float4(tf32_hi(v.x - h.x), tf32_hi(v.y - h.y),
                    tf32_hi(v.z - h.z), tf32_hi(v.w - h.w));
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* d, float a, float b, bool pair) {
  if (pair) {
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
    else
      *reinterpret_cast<float2*>(d) = make_float2(a, b);
  } else {
    d[0] = pb::from_f32<T>(a);
  }
}

// xc = a u + (1 - a) ku in the operands and rounding order of the taper's
// plain version
__device__ __forceinline__ float taper_blend(float a, float u, float ku) {
  return __fadd_rn(__fmul_rn(a, u), __fmul_rn(__fsub_rn(1.f, a), ku));
}

// The taper's epilogue (mode 4 with kTaper): xc = blend(av[i] ah[j],
// pad(u)[i][j], acc) for the block's 128 x 128 tile, read from `tile`, the
// accumulators staged in shared memory (pitch kTP). The accumulator
// fragments hold a warp's elements as 8 rows x 8 columns, so the blend
// walks the staged tile instead: a warp covers one row of it in 32
// float4s (a thread one float4 column on every 8th row, its ah loaded
// once), loads u and av for a batch of 8 chunks, then stores them. u
// is the application's input (mode 1's TileView, f32 or T) replicate-padded
// by tpad, or with tpad = 0 the destination itself: mode 1 has read it
// before mode 4 runs, and each element is loaded and stored by the same
// thread, loads first. With p.rnd each xc is also stored rounded to bf16
// there.
template <typename TU, int BN>
__device__ __forceinline__ void taper_tile(const GemmParams& p, int pl,
                                           int m0, int n0, const float* tile,
                                           int t) {
  constexpr int kTP = BN + 8;            // staged tile pitch, floats
  constexpr int kC4 = BN / 4;            // float4 columns of the tile
  constexpr int kRows = NCONS / kC4;     // rows between a thread's chunks
  constexpr int kQ = BM / kRows;         // chunks per thread
  constexpr int kB = 8;                  // chunks per batch of loads
  constexpr bool kF32U = std::is_same<TU, float>::value;
  const int n = pl / p.C, c = pl - n * p.C;
  const TU* ub = static_cast<const TU*>(p.src.ptr) + p.src.offset(n, c, 0, 0);
  const int uh = p.h - 2 * p.tpad, uw = p.wc - 2 * p.tpad;
  const float* avn = p.av + static_cast<long long>(n) * p.h;
  float* dst = static_cast<float*>(p.dst) + pl * p.dplane;
  bf16* rnd = p.rnd == nullptr ? nullptr
                               : static_cast<bf16*>(p.rnd) + pl * p.dplane;
  // a thread's chunks share one float4 column j .. j + 3 of the tile
  const int c4 = t % kC4, r0 = t / kC4, j = n0 + 4 * c4;
  const bool whole = j + 3 < p.N;
  const float* ahn = p.ah + static_cast<long long>(n) * p.wc;
  float w[4];
  int xj[4];  // u's columns, replicate-clamped
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int jc = min(j + e, p.N - 1);
    w[e] = ahn[jc];
    xj[e] = min(max(jc - p.tpad, 0), uw - 1);
  }
  const bool vec_u = kF32U && p.tpad == 0 && whole;
#pragma unroll
  for (int q0 = 0; q0 < kQ; q0 += kB) {
    float x[kB][4], ai[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int i = min(m0 + r0 + kRows * (q0 + b), p.M - 1);
      ai[b] = avn[i];
      const TU* ur =
          ub + static_cast<long long>(min(max(i - p.tpad, 0), uh - 1)) *
                   p.src.sR;
      if (vec_u && (reinterpret_cast<uintptr_t>(ur + j) & 15) == 0) {
        const float4 v = *reinterpret_cast<const float4*>(ur + j);
        x[b][0] = v.x, x[b][1] = v.y, x[b][2] = v.z, x[b][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[b][e] = pb::to_f32(ur[xj[e]]);
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int r = r0 + kRows * (q0 + b), i = m0 + r;
      const float4 k4 =
          *reinterpret_cast<const float4*>(tile + r * kTP + 4 * c4);
      const float ku[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[b][e] = taper_blend(__fmul_rn(ai[b], w[e]), x[b][e], ku[e]);
      if (i >= p.M) continue;
      const long long o = static_cast<long long>(i) * p.ldd + j;
      float* d = dst + o;
      if (whole && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
        *reinterpret_cast<float4*>(d) =
            make_float4(x[b][0], x[b][1], x[b][2], x[b][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < p.N) d[e] = x[b][e];
      }
      if (rnd != nullptr) {  // the canvas rounded to bf16 besides
        bf16* r = rnd + o;
        if (whole && (reinterpret_cast<uintptr_t>(r) & 7) == 0) {
          *reinterpret_cast<uint2*>(r) = make_uint2(
              pack2(__float2bfloat16_rn(x[b][0]),
                    __float2bfloat16_rn(x[b][1])),
              pack2(__float2bfloat16_rn(x[b][2]),
                    __float2bfloat16_rn(x[b][3])));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j + e < p.N) r[e] = __float2bfloat16_rn(x[b][e]);
        }
      }
    }
  }
}

// The epilogue of one accumulator pair C[i, j], C[i, j + 1] (j even),
// in two passes so that every load of the tile's epilogue (the spectrum,
// the noise) is in flight before its first store: the stores may alias
// nothing, but the compiler cannot know that.
//   mode 1: C = R^T (2kp x h)   -> RS[i % kp][(i >= kp) h + j]
//   mode 2: C = (T2 Rst)^T      -> PS[i][j] = q[j mod h][i] C
//   mode 3: C = T3 Pst (2h x kp) -> ZZ[i mod h][(i >= h) kp + j]
//   mode 4: C = x' (oh x ow)    -> clip, noise, cast, out[i][j]
template <int MODE, int IO>
__device__ __forceinline__ void finish_pair(const GemmParams& p, int pl,
                                            int i, int j, float& a,
                                            float& b) {
  if (i >= p.M || j >= p.N) return;
  if (MODE == 2) {
    const float* q =
        p.qhat2 + static_cast<long long>(pl / p.C) * p.h * 2 * p.kp + i;
    const int y0 = j < p.h ? j : j - p.h;
    const int y1 = j + 1 < p.h ? j + 1 : j + 1 - p.h;
    a = __fmul_rn(__ldg(q + static_cast<long long>(y0) * 2 * p.kp), a);
    b = __fmul_rn(__ldg(q + static_cast<long long>(y1) * 2 * p.kp), b);
  } else if (MODE == 4) {
    if (p.clip) {
      a = fminf(fmaxf(a, 0.f), 1.f);
      b = fminf(fmaxf(b, 0.f), 1.f);
    }
    if (IO & kNoise) {
      const float* nz =
          p.noise + pl * p.dplane + static_cast<long long>(i) * p.ldd + j;
      a = fminf(fmaxf(__fadd_rn(a, __ldg(nz)), 0.f), 1.f);
      if (j + 1 < p.N) b = fminf(fmaxf(__fadd_rn(b, __ldg(nz + 1)), 0.f), 1.f);
    }
  }
}

template <int MODE, typename T, int IO>
__device__ __forceinline__ void store_pair(const GemmParams& p, int pl, int i,
                                           int j, float a, float b) {
  if (i >= p.M || j >= p.N) return;
  const bool two = j + 1 < p.N;
  if (MODE == 4) {
    const long long o = pl * p.dplane + static_cast<long long>(i) * p.ldd + j;
    const bool pair = two && (o & 1) == 0;
    if (IO & kF32IO) {
      float* d = static_cast<float*>(p.dst) + o;
      store2(d, a, b, pair);
      if (two && !pair) d[1] = b;
    } else {
      T* d = static_cast<T*>(p.dst) + o;
      store2(d, a, b, pair);
      if (two && !pair) d[1] = pb::from_f32<T>(b);
    }
    return;
  }
  T* d = static_cast<T*>(p.dst) + pl * p.dplane;
  long long o;
  if (MODE == 1) {
    const bool im = i >= p.kp;
    o = static_cast<long long>(im ? i - p.kp : i) * p.ldd + (im ? p.h : 0) + j;
  } else if (MODE == 2) {
    o = static_cast<long long>(i) * p.ldd + j;
  } else {
    const bool im = i >= p.h;
    o = static_cast<long long>(im ? i - p.h : i) * p.ldd + (im ? p.kp : 0) + j;
  }
  const bool pair = two && ((pl * p.dplane + o) & 1) == 0;
  store2(d + o, a, b, pair);
  if (two && !pair) d[o + 1] = pb::from_f32<T>(b);
}

// Mode 1 on the TMA feed: B's margin rows were left as TMA brought them,
// so C's columns left of `half` and from half + ph on (rows of pad(x) that
// repeat the tile's first and last) are copies of its first and last
// interior columns, the same products: the block that holds such a column
// writes its copies, and no block writes a margin column from its own
// accumulators.
template <typename T>
__device__ __forceinline__ void feed_store(const GemmParams& p, int pl, int i,
                                           int j, float v) {
  const int lo = p.half, hi = p.half + p.ph;  // interior columns
  if (i >= p.M || j < lo || j >= hi) return;
  const bool im = i >= p.kp;
  T* row = static_cast<T*>(p.dst) + pl * p.dplane +
           static_cast<long long>(im ? i - p.kp : i) * p.ldd + (im ? p.h : 0);
  const T b = pb::from_f32<T>(v);
  row[j] = b;
  if (j == lo)
    for (int k = 0; k < lo; ++k) row[k] = b;
  if (j == hi - 1)
    for (int k = hi; k < p.N; ++k) row[k] = b;
}

template <typename T, int IO>
__device__ __forceinline__ void feed_store_pair(const GemmParams& p, int pl,
                                                int i, int j, float a,
                                                float b) {
  if (i < p.M && j > p.half && j + 2 < p.half + p.ph) {
    store_pair<1, T, IO>(p, pl, i, j, a, b);  // neither an interior end
    return;
  }
  feed_store<T>(p, pl, i, j, a);
  feed_store<T>(p, pl, i, j + 1, b);
}

// The epilogue of a block's 128 x BN tile of C. Accumulator r of consumer
// thread tid (warpgroup wg, warp, lane) holds C[i, j], i = m0 + 64 wg + 16
// warp + lane / 4 + 8 ((r / 2) % 2), j = n0 + 8 (r / 4) + 2 (lane % 4) +
// r % 2. Mode 4 with the taper stages the tile in the ring, once both
// consumer warpgroups are done reading it, and blends it (taper_tile);
// every other product finishes and stores its accumulator pairs.
template <int MODE, typename T, int IO, int BN, int RING>
__device__ __forceinline__ void epilogue(const GemmParams& p, int pl, int m0,
                                         int n0, float (&acc)[BN / 2],
                                         uint8_t* sbase, int tid) {
  constexpr int ACC = BN / 2;
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  if constexpr (MODE == 4 && (IO & kTaper)) {
    constexpr int kTP = BN + 8;  // taper_tile's pitch
    static_assert(BM * kTP * 4 <= RING, "the staged tile must fit the ring");
    pb::named_barrier(1, NCONS);
    float* tile = reinterpret_cast<float*>(sbase);
    const int ti = wg * 64 + warp * 16 + (lane >> 2), tj = 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < ACC; r += 2)
      *reinterpret_cast<float2*>(tile + (ti + 8 * ((r >> 1) & 1)) * kTP + tj +
                                 8 * (r >> 2)) = make_float2(acc[r],
                                                             acc[r + 1]);
    pb::named_barrier(1, NCONS);
    if (p.tu_f32)
      taper_tile<float, BN>(p, pl, m0, n0, tile, tid);
    else
      taper_tile<T, BN>(p, pl, m0, n0, tile, tid);
    return;
  }
  const int i0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int j0 = n0 + 2 * (lane & 3);
  if constexpr (MODE == 1 && (IO & kTmaFeed) != 0) {
#pragma unroll
    for (int r = 0; r < ACC; r += 2)
      feed_store_pair<T, IO>(p, pl, i0 + 8 * ((r >> 1) & 1),
                             j0 + 8 * (r >> 2), acc[r], acc[r + 1]);
    return;
  }
#pragma unroll
  for (int r = 0; r < ACC; r += 2)
    finish_pair<MODE, IO>(p, pl, i0 + 8 * ((r >> 1) & 1), j0 + 8 * (r >> 2),
                          acc[r], acc[r + 1]);
#pragma unroll
  for (int r = 0; r < ACC; r += 2)
    store_pair<MODE, T, IO>(p, pl, i0 + 8 * ((r >> 1) & 1), j0 + 8 * (r >> 2),
                            acc[r], acc[r + 1]);
}

// One (BM x BN) tile of one plane's product. tma_a / tma_b: the A and B
// operands as (planes, rows, K) maps; mode 1's B map is the source as
// (images, channels, rows, columns) on the TMA feed, and none on the
// gather, whose producer warpgroups write B.
template <int MODE, typename T, int IO>
__global__ void __launch_bounds__(Cfg<MODE, T, IO>::NT,
                                  Cfg<MODE, T, IO>::BLOCKS)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
            const __grid_constant__ CUtensorMap tma_b, const GemmParams p) {
  using Cf = Cfg<MODE, T, IO>;
  constexpr int BN = Cf::BN, ACC = Cf::ACC;
  constexpr bool kPadB = MODE == 1 && !Cf::kFeed;  // the gather
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[Cf::STAGES], empty[Cf::STAGES],
      landed[Cf::STAGES];
  const uint32_t raw_u32 = pb::smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw_u32);
  const int tid = threadIdx.x;
  const int pl = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int nk = (p.K + Cf::BK - 1) / Cf::BK;
  // The TMA feed: plane pl's tile (TileView) as image img, channel fc of
  // the source, pad(x)'s origin at (fy, fx + fd). A box's first column
  // must lie on a 16-byte block, so the boxes start fd columns left of
  // pad(x)'s and A is F^T moved fd columns right (plane fd of the shifted
  // tables): the same products, fd columns later in K (fd 0: the gather's
  // bits exactly).
  int fc = 0, fimg = 0, fy = 0, fx = 0, fd = 0;
  if constexpr (Cf::kFeed) {
    constexpr int E = (IO & kF32IO) != 0 ? 4 : 16 / sizeof(T);
    const int n = pl / p.C;
    const int q = n / p.src.batch, tile = p.src.tile0 + q;
    const int ti = tile / p.src.tiles_w;
    const int ox = (tile - ti * p.src.tiles_w) * p.src.step_w - p.half;
    fc = pl - n * p.C;
    fimg = n - q * p.src.batch;
    fy = ti * p.src.step_h - p.half;
    fd = ((ox % E) + E) % E;
    fx = ox - fd;
    nk = (p.K + fd + Cf::BK - 1) / Cf::BK;
  }
  if (tid == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      // the TMA feed: the producer warp's 32 arrivals, one of them with
      // the stage's bytes, or its bytes on `landed` and the 32 after the
      // margins
      pb::mbar_init(pb::smem_u32(&full[s]),
                    kPadB ? 1 + Cf::NPROD : Cf::kFeed ? 32 : 1);
      pb::mbar_init(pb::smem_u32(&empty[s]), NCONS);
      pb::mbar_init(pb::smem_u32(&landed[s]), 1);
    }
    pb::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ------------------------------------------------------- producer
    const int t = tid - NCONS;
    if constexpr (Cf::kFeed) {
      using TS = typename std::conditional<(IO & kF32IO) != 0, float,
                                           T>::type;
      constexpr int NBOX = Cf::B_RAW / Cf::B_BYTES;
      constexpr int W = 128 / sizeof(TS);  // a box's columns
      const TS* src = static_cast<const TS*>(p.src.ptr) +
                      p.src.offset(pl / p.C, fc, 0, 0);
      uint32_t el[BN / 32], er[BN / 32];
      row_ends<TS, BN>(p, src, n0, t, el, er);
      // the zeros left of pad(x) and from its column wc on lie in the
      // source (outside it TMA brings zeros itself)
      const int ox = fx + fd;  // pad(x)'s column 0 in the source
      const bool zl = ox > 0, zr = ox + p.wc < p.src_w;
      uint32_t lph = 0;  // landed's phase, a bit per stage
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % Cf::STAGES;
        pb::mbar_wait(pb::smem_u32(&empty[s]),
                      ((kt / Cf::STAGES) & 1) ^ 1);
        // whether the stage reaches the column margins: the columns that
        // repeat the row's ends, or zeros inside the source
        const int k0 = kt * Cf::BK, x0 = k0 - fd, x1 = x0 + Cf::BK;
        const bool fix = (x0 < p.half && x1 > 0) ||
                         (x1 > p.half + p.pw && x0 < p.wc) ||
                         (x0 < 0 && zl) || (x1 > p.wc && zr);
        const uint32_t sa = base + s * Cf::STAGE;
        const uint32_t fb = pb::smem_u32(&full[s]);
        const uint32_t lb = pb::smem_u32(&landed[s]);
        if (t == 0) {
          const uint32_t bar = fix ? lb : fb;
          pb::mbar_arrive_tx(bar, Cf::A_BYTES + Cf::B_RAW);
          pb::tma_load_3d(sa, &tma_a, k0, m0, fd, bar);
#pragma unroll
          for (int i = 0; i < NBOX; ++i)
            pb::tma_load_4d(sa + Cf::A_BYTES + i * Cf::B_BYTES, &tma_b,
                            fx + k0 + i * W, fy + n0, fc, fimg, bar);
        }
        if (!fix) {
          if (t != 0) pb::mbar_arrive(fb);
          continue;
        }
        tma_margins<TS, NBOX, BN>(p, n0, k0, fd,
                                  sbase + s * Cf::STAGE + Cf::A_BYTES, lb,
                                  (lph >> s) & 1, t, el, er);
        lph ^= 1u << s;
        pb::fence_proxy_async();
        pb::mbar_arrive(fb);
      }
      return;
    }
    if (!kPadB && t != 0) return;
    // mode 4 reads the rows of the canvas the crop keeps
    const int ra = MODE == 4 ? p.half : 0;
    const int pa = (MODE == 2 || MODE == 4) ? pl : 0;
    const int pbp = MODE == 3 ? pl : 0;
    using TS = typename std::conditional<(IO & kF32IO) != 0, float, T>::type;
    const int n = pl / p.C, c = pl - n * p.C;
    const TS* src =
        static_cast<const TS*>(p.src.ptr) + p.src.offset(n, c, 0, 0);
    int shift = -1;
    if constexpr (kPadB) shift = fill_shift<TS>(p, src);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % Cf::STAGES;
      const uint32_t par = ((kt / Cf::STAGES) & 1) ^ 1;
      pb::mbar_wait(pb::smem_u32(&empty[s]), par);
      const uint32_t sa = base + s * Cf::STAGE;
      const uint32_t fb = pb::smem_u32(&full[s]);
      if (t == 0) {
        pb::mbar_arrive_tx(fb, kPadB ? Cf::A_BYTES
                                     : Cf::A_BYTES + Cf::B_BYTES);
        pb::tma_load_3d(sa, &tma_a, kt * Cf::BK, m0 + ra, pa, fb);
        if (!kPadB)
          pb::tma_load_3d(sa + Cf::A_BYTES, &tma_b, kt * Cf::BK, n0 + ra,
                          pbp, fb);
      }
      if constexpr (kPadB) {
        fill_stage<T, TS, Cf::NPROD, BN>(p, src, shift, n0, kt * Cf::BK,
                                         sbase + s * Cf::STAGE + Cf::A_BYTES,
                                         t);
        pb::fence_proxy_async();
        pb::mbar_arrive(fb);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  const int wg = tid >> 7, t = tid & 127;
  float acc[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc[r] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % Cf::STAGES;
    pb::mbar_wait(pb::smem_u32(&full[s]), (kt / Cf::STAGES) & 1);
    const uint32_t sa = base + s * Cf::STAGE + wg * (64 * 128);
    const uint32_t sb = base + s * Cf::STAGE + Cf::A_BYTES;
    if constexpr (Cf::kF32In) {
      round_f32_stage(sbase + s * Cf::STAGE + Cf::A_BYTES, tid);
      pb::fence_proxy_async();
      pb::named_barrier(1, NCONS);
    }
    if (Cf::kSplit) {
      uint8_t* st = sbase + s * Cf::STAGE;
      uint8_t* lo = st + Cf::A_BYTES + Cf::B_BYTES;
      split_tf32(st + wg * (64 * 128), lo + wg * (64 * 128), 64 * 128, t);
      split_tf32(st + Cf::A_BYTES + wg * (BN / 2 * 128),
                 lo + Cf::A_BYTES + wg * (BN / 2 * 128), BN / 2 * 128, t);
      pb::fence_proxy_async();
      pb::named_barrier(1, NCONS);
    }
    pb::fence_regs(acc);
    pb::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = pb::sw128_desc(sa) + 2 * kk;
      const uint64_t db = pb::sw128_desc(sb) + 2 * kk;
      if (Cf::kSplit) {
        const uint32_t lo = Cf::A_BYTES + Cf::B_BYTES;
        pb::wgmma_tf32(acc, da, pb::sw128_desc(sb + lo) + 2 * kk);
        pb::wgmma_tf32(acc, pb::sw128_desc(sa + lo) + 2 * kk, db);
        pb::wgmma_tf32(acc, da, db);
      } else {
        pb::wgmma_bf16(acc, da, db);
      }
    }
    pb::wgmma_commit();
    // one group stays in flight: the previous step's is done, so its
    // stage goes back to the producer
    pb::wgmma_wait<1>();
    pb::fence_regs(acc);
    if (kt > 0)
      pb::mbar_arrive(pb::smem_u32(&empty[(kt - 1) % Cf::STAGES]));
  }
  pb::wgmma_wait<0>();
  pb::fence_regs(acc);
  epilogue<MODE, T, IO, BN, Cf::STAGES * Cf::STAGE>(p, pl, m0, n0, acc, sbase,
                                                    tid);
}

template <int MODE, typename T, int IO>
int launch_io(const CUtensorMap& a, const CUtensorMap& b, const GemmParams& p,
              int planes, cudaStream_t s) {
  using Cf = Cfg<MODE, T, IO>;
  auto kern = gemm_kernel<MODE, T, IO>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.N + Cf::BN - 1) / Cf::BN, (p.M + BM - 1) / BM, planes);
  kern<<<grid, Cf::NT, Cf::SMEM, s>>>(a, b, p);
  return static_cast<int>(cudaGetLastError());
}

// f32io: mode 1's tiles / mode 4's output are f32; noise: mode 4 adds it;
// taper: mode 4 blends (f32 out); feed: mode 1 (bf16) takes the tiles by
// TMA, b their map. An f32 work dtype reads and writes f32 anyway, so its
// f32io cases are not instantiated.
template <int MODE, typename T>
int launch_gemm(bool f32io, bool noise, bool taper, bool feed,
                const CUtensorMap& a, const CUtensorMap& b,
                const GemmParams& p, int planes, cudaStream_t s) {
  if constexpr (MODE == 1 && sizeof(T) == 2) {
    if (feed && f32io)
      return launch_io<1, T, kTmaFeed | kF32IO>(a, b, p, planes, s);
    if (feed) return launch_io<1, T, kTmaFeed>(a, b, p, planes, s);
  }
  if constexpr (MODE == 4) {
    constexpr int kOut = sizeof(T) == 4 ? 0 : kF32IO;
    if (taper) return launch_io<4, T, kOut | kTaper>(a, b, p, planes, s);
  }
  if constexpr (sizeof(T) == 2) {
    if (f32io && noise)
      return launch_io<MODE, T, kF32IO | kNoise>(a, b, p, planes, s);
    if (f32io) return launch_io<MODE, T, kF32IO>(a, b, p, planes, s);
  }
  if (noise) return launch_io<MODE, T, kNoise>(a, b, p, planes, s);
  return launch_io<MODE, T, 0>(a, b, p, planes, s);
}

// ------------------------------------------------------------- 'highest'
//
// A block's tile is DM data rows x TN table rows, K in stages of 32: the
// f32 data (by TMA, or in mode 1 written by the producers as above) and
// the table's three tf32 pieces (by TMA; split on the host). Each consumer
// warpgroup takes 64 data rows as wgmma's A: it reads them into the A
// fragment, splits them there and runs the stage's 24 m64nWNk8 products
// against WN table rows into a fresh accumulator, waits for them and
// promotes the stage into its running sum; no barrier joins the two
// warpgroups, so one's split, wait and promotion hide under the other's
// MMAs. The producers give their registers to the consumers (setmaxnreg).
// Modes 2-4: 128 data rows (64 a warpgroup) x 64 table rows, 3 stages of
// 40 KB (4 and 5 stages, or 128 table rows, measured no faster). Mode 1,
// whose producers write the data and bound it: 64 data rows (both
// warpgroups read them) x 256 table rows (128 each, m64n128k8), 2 stages
// of 104 KB, so that the producers fill each canvas row half as often as
// the three-piece design did (PERF.md: 128 data x 64 table rows ran
// 1.15x slower than that design, 64 x 128 0.78x, 64 x 256 0.62x; with one
// producer warpgroup, or fewer than 64 registers for the producers,
// slower). In modes 2 and 4 the data is A as built (C = data table^T);
// modes 1 and 3 run C^T = data table^T and store C^T's elements where C's
// go, 8 consecutive elements of a destination row per warp and register
// (whole 32-byte sectors).
template <int MODE>
struct HiCfg {
  static constexpr bool kFill = MODE == 1;             // producers write
  static constexpr int BK = 32;                        // K per stage
  static constexpr int WN = kFill ? 128 : 64;  // a warpgroup's table rows
  static constexpr int ACC = WN / 2;           // accumulator floats
  static constexpr int DM = kFill ? 64 : 128;          // data rows
  static constexpr int TN = kFill ? 2 * WN : WN;       // table rows
  static constexpr int A_BYTES = DM * 128;             // the data, f32
  static constexpr int B_BYTES = TN * 128;             // a table piece
  static constexpr int STAGE = A_BYTES + 3 * B_BYTES;  // 104 KB, 40 KB
  static constexpr int STAGES = kFill ? 2 : 3;
  static constexpr int SMEM = STAGES * STAGE + 1024;
  // producer threads (mode 1: two warpgroups writing the data; else one
  // issuing TMA from one thread) and the registers per thread after
  // setmaxnreg: the consumers take what the producers give back
  static constexpr int NPROD = kFill ? 256 : 128;
  static constexpr int NT = NCONS + NPROD;
  static constexpr int PROD = kFill ? 64 : 40;
  static constexpr int CONS = kFill ? 192 : 232;
  static_assert(NCONS * CONS + NPROD * PROD <= 65536, "registers");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

// One K stage into the fresh accumulator t; one MMA group. The
// warpgroup's 64 data rows at da (f32, 32 of K, 128-byte swizzle) are read
// into the A fragment (register j of lane l in warp w: row 16 w + l / 4 +
// 8 (j % 2), column l % 4 + 4 (j / 2) of each 8-deep slice) and split there
// (split4<3>, the rounding the host gives the tables); B is the table's
// pieces hi, mid, lo from sb, PIECE bytes apart. Per 8-deep slice the five
// small products as (A piece, B piece), 0 hi, 1 mid, 2 lo:
//   C = data table^T   (modes 2, 4): (2,0) (0,2) (1,1) (1,0) (0,1)
//   C^T = data table^T (modes 1, 3): (0,2) (2,0) (1,1) (0,1) (1,0)
// i.e. lo hi, hi lo, mid mid, mid hi, hi mid of (A, B) as the three-piece
// design ran them (modes 1 and 3: of (table, data), the factors swapped);
// then the stage's four hi hi.
template <int WN>
__device__ __forceinline__ void wgmma_rs(float (&t)[WN / 2],
                                         const float (&a)[4], uint64_t db,
                                         int acc = 1) {
  if constexpr (WN == 64)
    pb::wgmma_tf32_n64_rs(t, a, db, acc);
  else
    pb::wgmma_tf32_n128_rs(t, a, db, acc);
}

template <bool SWAP, int PIECE, int WN>
__device__ __forceinline__ void mma_stage_hi(uint32_t sb, const uint8_t* da,
                                             int warp, int lane,
                                             float (&t)[WN / 2]) {
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
    pb::split4<3>(v, a[kk]);
  }
  const uint64_t bh = pb::sw128_desc(sb);
  const uint64_t bm = pb::sw128_desc(sb + PIECE);
  const uint64_t bl = pb::sw128_desc(sb + 2 * PIECE);
  pb::fence_regs(t);
  pb::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t h = bh + 2 * kk, m = bm + 2 * kk, l = bl + 2 * kk;
    if constexpr (!SWAP) {
      wgmma_rs<WN>(t, a[kk][2], h, kk);  // kk == 0 starts from zero
      wgmma_rs<WN>(t, a[kk][0], l);
      wgmma_rs<WN>(t, a[kk][1], m);
      wgmma_rs<WN>(t, a[kk][1], h);
      wgmma_rs<WN>(t, a[kk][0], m);
    } else {
      wgmma_rs<WN>(t, a[kk][0], l, kk);
      wgmma_rs<WN>(t, a[kk][2], h);
      wgmma_rs<WN>(t, a[kk][1], m);
      wgmma_rs<WN>(t, a[kk][0], m);
      wgmma_rs<WN>(t, a[kk][1], h);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<WN>(t, a[kk][0], bh + 2 * kk);
  pb::wgmma_commit();
}

// C's element (i, j) of mode 1 (RS[i % kp][(i >= kp) h + j]) or 3
// (ZZ[i mod h][(i >= h) kp + j]), stored from C^T's accumulators.
template <int MODE>
__device__ __forceinline__ void store_t(const GemmParams& p, int pl, int i,
                                        int j, float v) {
  if (i >= p.M || j >= p.N) return;
  const int half = MODE == 1 ? p.kp : p.h;   // the stacked halves' rows
  const int col = MODE == 1 ? p.h : p.kp;    // the second half's column
  const bool im = i >= half;
  float* d = static_cast<float*>(p.dst) + pl * p.dplane;
  d[static_cast<long long>(im ? i - half : i) * p.ldd + (im ? col : 0) + j] =
      v;
}

// One DM x TN tile of one plane's 'highest' product. tma_d: the data
// (planes, rows, K) in f32, DM-row boxes (mode 1: none, the producers
// write the tiles); tma_t: the table's pieces (3, rows, K), TN-row boxes.
template <int MODE, int IO>
__global__ void __launch_bounds__(HiCfg<MODE>::NT, 1)
gemm_hi_kernel(const __grid_constant__ CUtensorMap tma_d,
               const __grid_constant__ CUtensorMap tma_t, const GemmParams p) {
  using Cf = HiCfg<MODE>;
  constexpr bool kSwap = MODE == 1 || MODE == 3;
  constexpr bool kFill = Cf::kFill;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[Cf::STAGES], empty[Cf::STAGES];
  const uint32_t raw_u32 = pb::smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw_u32);
  const int tid = threadIdx.x;
  const int pl = blockIdx.z;
  const int d0 = blockIdx.y * Cf::DM, t0 = blockIdx.x * Cf::TN;
  const int nk = (p.K + Cf::BK - 1) / Cf::BK;
  if (tid == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      pb::mbar_init(pb::smem_u32(&full[s]), kFill ? 1 + Cf::NPROD : 1);
      pb::mbar_init(pb::smem_u32(&empty[s]), NCONS);
    }
    pb::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ------------------------------------------------------- producer
    pb::setmaxnreg_dec<Cf::PROD>();
    const int t = tid - NCONS;
    if (!kFill && t != 0) return;
    // mode 4 reads the rows and columns of the canvas the crop keeps
    const int ra = MODE == 4 ? p.half : 0;
    const int n = pl / p.C, c = pl - n * p.C;
    const float* src =
        static_cast<const float*>(p.src.ptr) + p.src.offset(n, c, 0, 0);
    int shift = -1;
    if constexpr (kFill) shift = fill_shift<float>(p, src);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % Cf::STAGES;
      const uint32_t par = ((kt / Cf::STAGES) & 1) ^ 1;
      pb::mbar_wait(pb::smem_u32(&empty[s]), par);
      const uint32_t sa = base + s * Cf::STAGE;
      const uint32_t fb = pb::smem_u32(&full[s]);
      if (t == 0) {
        pb::mbar_arrive_tx(fb, (kFill ? 0 : Cf::A_BYTES) + 3 * Cf::B_BYTES);
        if (!kFill)
          pb::tma_load_3d(sa, &tma_d, kt * Cf::BK, d0 + ra, pl, fb);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          pb::tma_load_3d(sa + Cf::A_BYTES + k * Cf::B_BYTES, &tma_t,
                          kt * Cf::BK, t0 + ra, k, fb);
      }
      if constexpr (kFill) {
        fill_stage<float, float, Cf::NPROD, Cf::DM>(p, src, shift, d0,
                                                    kt * Cf::BK,
                                                    sbase + s * Cf::STAGE, t);
        pb::fence_proxy_async();
        pb::mbar_arrive(fb);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  pb::setmaxnreg_inc<Cf::CONS>();
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  // this warpgroup's 64 data rows and WN table rows within the tile
  const int dw = kFill ? 0 : 64 * wg, tw = kFill ? Cf::WN * wg : 0;
  float acc[Cf::ACC];
#pragma unroll
  for (int r = 0; r < Cf::ACC; ++r) acc[r] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % Cf::STAGES;
    pb::mbar_wait(pb::smem_u32(&full[s]), (kt / Cf::STAGES) & 1);
    float tmp[Cf::ACC];
    mma_stage_hi<kSwap, Cf::B_BYTES, Cf::WN>(
        base + s * Cf::STAGE + Cf::A_BYTES + tw * 128,
        sbase + s * Cf::STAGE + dw * 128, warp, lane, tmp);
    pb::wgmma_wait<0>();
    pb::fence_regs(tmp);
    pb::mbar_arrive(pb::smem_u32(&empty[s]));
#pragma unroll
    for (int r = 0; r < Cf::ACC; ++r) acc[r] = __fadd_rn(acc[r], tmp[r]);
  }
  if constexpr (kSwap) {
    // accumulator r: C^T's row d0 + dw + 16 warp + lane / 4 + 8 ((r / 2)
    // % 2), column t0 + tw + 8 (r / 4) + 2 (lane % 4) + r % 2
    const int j0 = d0 + dw + warp * 16 + (lane >> 2);
    const int i0 = t0 + tw + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < Cf::ACC; ++r)
      store_t<MODE>(p, pl, i0 + 8 * (r >> 2) + (r & 1),
                    j0 + 8 * ((r >> 1) & 1), acc[r]);
  } else {
    epilogue<MODE, float, IO, Cf::TN, Cf::STAGES * Cf::STAGE>(
        p, pl, d0, t0, acc, sbase, tid);
  }
}

template <int MODE, int IO>
int launch_hi(const CUtensorMap& d, const CUtensorMap& t, const GemmParams& p,
              int planes, cudaStream_t s) {
  using Cf = HiCfg<MODE>;
  auto kern = gemm_hi_kernel<MODE, IO>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  // x: the table's rows (C's columns, C^T's rows in modes 1 and 3)
  constexpr bool kSwap = MODE == 1 || MODE == 3;
  const int rows_t = kSwap ? p.M : p.N, rows_d = kSwap ? p.N : p.M;
  dim3 grid((rows_t + Cf::TN - 1) / Cf::TN, (rows_d + Cf::DM - 1) / Cf::DM,
            planes);
  kern<<<grid, Cf::NT, Cf::SMEM, s>>>(d, t, p);
  return static_cast<int>(cudaGetLastError());
}

// Padded row lengths, shared with ops/cuda/polyblur_fused.py: K widths of
// the tables and of RS / PS round up to a whole number of 64-element rows.
inline int pad64(int n) { return (n + 63) / 64 * 64; }

// The TMA feed's shifted copies of F^T, one per column a bf16 box may
// start left of pad(x)'s (ops/cuda/polyblur_fused.py fwd_shifts).
constexpr int kShifts = 8;

// feed (mode 1, bf16): the tiles by TMA from their source, a (src_b,
// C, src_h, src_w) tensor with the TileView's strides; tab is then F^T's
// kShifts shifted copies.
template <typename T>
int spectral_gemm(int mode, bool src_f32, bool dst_f32, bool feed,
                  int src_b, int src_h, int src_w, const void* tab,
                  const void* mid, GemmParams& p, int planes,
                  cudaStream_t s) {
  const bool f32 = sizeof(T) == 4;
  constexpr int BN = Cfg<1, T>::BN;  // B's box rows, every mode
  const int h = p.h, kp = p.kp, l2 = pad64(2 * h);
  const long long rs = static_cast<long long>(kp) * l2;  // RS / PS plane
  const long long zz = static_cast<long long>(h) * 2 * kp;
  CUtensorMap a, b;
  bool ok = true;
  switch (mode) {
    case 1: {  // A = F^T (2kp x wc); B from the tiles
      p.M = 2 * kp; p.N = h; p.K = p.wc; p.ldd = l2; p.dplane = rs;
      // the TMA feed's A: F^T moved 0 .. 7 columns right, (8, 2kp, lt)
      feed = feed && sizeof(T) == 2;
      const long long lt = pad64(p.wc + (feed ? kShifts - 1 : 0));
      ok = pb::tma_map_3d(&a, tab, f32, feed ? lt : p.wc, 2 * kp,
                          feed ? kShifts : 1, lt, 2LL * kp * lt, BM);
      b = a;
      if (ok && feed) {
        // a single image's or channel's stride is never stepped: any
        // whole-block one does
        const long long sc = p.C > 1 ? p.src.sC : p.src.sR * src_h;
        const long long sb = src_b > 1 ? p.src.sB : sc * p.C;
        ok = pb::tma_map_4d(&b, p.src.ptr, src_f32, src_w, src_h, p.C, src_b,
                            p.src.sR, sc, sb, BN);
      }
      if (!ok) break;
      return launch_gemm<1, T>(src_f32, false, false, feed, a, b, p, planes,
                               s);
    }
    case 2:  // A = RS (kp x 2h), B = T2 (2h x 2h)
      p.M = kp; p.N = 2 * h; p.K = 2 * h; p.ldd = l2; p.dplane = rs;
      ok = pb::tma_map_3d(&a, mid, f32, 2 * h, kp, planes, l2, rs, BM) &&
           pb::tma_map_3d(&b, tab, f32, 2 * h, 2 * h, 1, l2, 2LL * h * l2,
                          BN);
      if (!ok) break;
      return launch_gemm<2, T>(false, false, false, false, a, b, p, planes, s);
    case 3:  // A = T3 (2h x 2h), B = PS (kp x 2h)
      p.M = 2 * h; p.N = kp; p.K = 2 * h; p.ldd = 2 * kp; p.dplane = zz;
      ok = pb::tma_map_3d(&a, tab, f32, 2 * h, 2 * h, 1, l2, 2LL * h * l2,
                          BM) &&
           pb::tma_map_3d(&b, mid, f32, 2 * h, kp, planes, l2, rs, BN);
      if (!ok) break;
      return launch_gemm<3, T>(false, false, false, false, a, b, p, planes, s);
    case 4:  // A = ZZ (h x 2kp) from row `half`, B = G^T (wc x 2kp)
      p.M = p.ph; p.N = p.pw; p.K = 2 * kp; p.ldd = p.pw;
      p.dplane = static_cast<long long>(p.ph) * p.pw;
      ok = pb::tma_map_3d(&a, mid, f32, 2 * kp, h, planes, 2 * kp, zz, BM) &&
           pb::tma_map_3d(&b, tab, f32, 2 * kp, p.wc, 1, 2 * kp,
                          2LL * kp * p.wc, BN);
      if (!ok) break;
      return launch_gemm<4, T>(dst_f32, p.noise != nullptr, p.av != nullptr,
                               false, a, b, p, planes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  fprintf(stderr, "spectral_gemm mode %d: cuTensorMapEncodeTiled refused a "
                  "map (pointer alignment or stride)\n", mode);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The 'highest' products, f32: tab holds the mode's table in its three
// tf32 pieces, (3, rows, ld) with the ld of the table itself; the data map
// reads DM-row boxes of the plane, the table map TN-row boxes of a piece.
int spectral_gemm_hi(int mode, const void* tab, const void* mid,
                     GemmParams& p, int planes, cudaStream_t s) {
  const int h = p.h, kp = p.kp, l2 = pad64(2 * h), lw = pad64(p.wc);
  const long long rs = static_cast<long long>(kp) * l2;  // RS / PS plane
  const long long zz = static_cast<long long>(h) * 2 * kp;
  CUtensorMap d, t;
  bool ok = true;
  switch (mode) {
    case 1:  // the tiles (by the producers) x F^T (2kp x wc): C^T
      p.M = 2 * kp; p.N = h; p.K = p.wc; p.ldd = l2; p.dplane = rs;
      ok = pb::tma_map_3d(&t, tab, true, p.wc, 2 * kp, 3, lw, 2LL * kp * lw,
                          HiCfg<1>::TN);
      d = t;
      if (!ok) break;
      return launch_hi<1, 0>(d, t, p, planes, s);
    case 2:  // RS (kp x 2h) x T2 (2h x 2h)
      p.M = kp; p.N = 2 * h; p.K = 2 * h; p.ldd = l2; p.dplane = rs;
      ok = pb::tma_map_3d(&d, mid, true, 2 * h, kp, planes, l2, rs,
                          HiCfg<2>::DM) &&
           pb::tma_map_3d(&t, tab, true, 2 * h, 2 * h, 3, l2, 2LL * h * l2,
                          HiCfg<2>::TN);
      if (!ok) break;
      return launch_hi<2, 0>(d, t, p, planes, s);
    case 3:  // PS (kp x 2h) x T3 (2h x 2h): C^T
      p.M = 2 * h; p.N = kp; p.K = 2 * h; p.ldd = 2 * kp; p.dplane = zz;
      ok = pb::tma_map_3d(&d, mid, true, 2 * h, kp, planes, l2, rs,
                          HiCfg<3>::DM) &&
           pb::tma_map_3d(&t, tab, true, 2 * h, 2 * h, 3, l2, 2LL * h * l2,
                          HiCfg<3>::TN);
      if (!ok) break;
      return launch_hi<3, 0>(d, t, p, planes, s);
    case 4:  // ZZ (h x 2kp) from row `half` x G^T (wc x 2kp)
      p.M = p.ph; p.N = p.pw; p.K = 2 * kp; p.ldd = p.pw;
      p.dplane = static_cast<long long>(p.ph) * p.pw;
      ok = pb::tma_map_3d(&d, mid, true, 2 * kp, h, planes, 2 * kp, zz,
                          HiCfg<4>::DM) &&
           pb::tma_map_3d(&t, tab, true, 2 * kp, p.wc, 3, 2 * kp,
                          2LL * kp * p.wc, HiCfg<4>::TN);
      if (!ok) break;
      if (p.av != nullptr) return launch_hi<4, kTaper>(d, t, p, planes, s);
      if (p.noise != nullptr) return launch_hi<4, kNoise>(d, t, p, planes, s);
      return launch_hi<4, 0>(d, t, p, planes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  fprintf(stderr, "spectral_gemm mode %d: cuTensorMapEncodeTiled refused a "
                  "map (pointer alignment or stride)\n", mode);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Rows per block of kernel_spectrum: whole passes of 64, split so that
// the grid holds about four blocks per SM of the H100 where the planes
// allow it (n = 88 at kp 256: 2 chunks; n = 12: 8; n = 1: 8).
static int spectrum_rows(int n, int h, int kp) {
  const int col_blocks = kp / kSpecCols;
  const int passes = (h + kSpecRows - 1) / kSpecRows;
  int chunks = (4 * 132 + col_blocks * n - 1) / (col_blocks * n);
  chunks = chunks < 1 ? 1 : (chunks > passes ? passes : chunks);
  return ((passes + chunks - 1) / chunks) * kSpecRows;
}

// q: n rows of `stride` f32 with (qa, qb, qc) at column `off` (the (n, 8)
// estimate rows: stride 8, off 5; fused_polynomial's (N, 3) params: 3, 0);
// coeffs: f32 [a3, a2, a1, beta, ..]; half: the kernel half-support (0 ..
// 15; the tap tables hold its 2 half + 1 taps); qhat2: (n, h, 2 kp) f32
// output; kp a multiple of 64.
extern "C" int pb_kernel_spectrum(const float* q, int stride, int off,
                                  const float* coeffs, const float* er,
                                  const float* ei, const float* cyt,
                                  const float* syt, int n, int h, int kp,
                                  int half, float* qhat2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kp % kSpecCols != 0 || n < 1 || n > 65535 || half < 0 ||
      half > kMaxHalf)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = spectrum_rows(n, h, kp);
  dim3 grid(kp / kSpecCols, (h + rows - 1) / rows, n);
  if (half == kHalf)
    kernel_spectrum_kernel<kHalf><<<grid, kSpecThreads, 0, s>>>(
        q, stride, off, coeffs, er, ei, cyt, syt, h, kp, rows, half, qhat2);
  else
    kernel_spectrum_kernel<-1><<<grid, kSpecThreads, 0, s>>>(
        q, stride, off, coeffs, er, ei, cyt, syt, h, kp, rows, half, qhat2);
  return static_cast<int>(cudaGetLastError());
}


// One of the four products of a spectral application over `planes`
// (tile, channel) planes; see the modes above. Shapes: canvas (h, wc),
// packed half-spectrum kp; mode 1 reads (ph, pw) tiles replicate-padded by
// `half` (= (h - ph) / 2), mode 4 writes (ph, pw) planes cropped by `half`
// from the canvas, so the two may differ (the taper reads the tile padded
// and writes the whole canvas, then reads the canvas and writes the tile).
// tab: the mode's table — mode 1 F^T (2kp, pad64(wc)), mode 2 T2 and mode
// 3 T3 (2h, pad64(2h)), mode 4 G^T (wc, 2kp); mid: mode 2 RS, mode 3 PS
// (planes, kp, pad64(2h)), mode 4 ZZ (planes, h, 2kp); dst: mode 1 RS,
// mode 2 PS, mode 3 ZZ, mode 4 the (planes, ph, pw) output. src_f32 (mode
// 1): the tiles are f32 and rounded to the work dtype on load; dst_f32
// (mode 4): write f32; clip != 0 clips mode 4's output to [0, 1]; noise
// (mode 4, f32 (planes, ph, pw) or null) is then added and the sum clipped
// again. av, ah (mode 4, the taper's (n, h) and (n, wc) f32 weights, or
// null): the output is the whole canvas (half 0) in f32, unclipped, blended
// with the tiles of the TileView padded by tpad, x' = a pad(x) + (1 - a) x';
// rnd (with the taper in bf16, or null): a bf16 canvas of the output's
// shape that also gets x', rounded (the next application's mode-1 source).
// feed (mode 1, bf16 work dtype): the tiles by TMA, their source a (src_b,
// C, src_h, src_w) tensor whose base and strides are whole 16-byte blocks
// (ops/cuda/polyblur_fused.py mode1_feed), tab F^T's 8 shifted copies
// (8, 2kp, pad64(wc + 7)) (fwd_shifts); 0: the producers' gather.
// high (f32 only): the 'highest' kernel (three pieces, six products; tab
// is then the table's (3, rows, ld) tf32 pieces, ops/cuda/polyblur_fused.py
// table_pieces); 0 the 3xTF32 one (ops/cuda/sep_poly_fused.py dot_variant).
extern "C" int pb_spectral_gemm(int mode, int dtype, const void* ptr,
                                long long sB, long long sC, long long sR,
                                int batch, int tile0, int tiles_w, int step_h,
                                int step_w, int src_f32, const void* tab,
                                const void* mid, void* dst, int dst_f32,
                                const float* qhat2, const float* noise,
                                int planes, int C, int ph, int pw, int h,
                                int wc, int kp, int half, int clip,
                                const float* av, const float* ah, int tpad,
                                void* rnd, int feed, int src_b, int src_h,
                                int src_w, int high, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool taper = mode == 4 && av != nullptr;
  if (high != 0 && (high != 1 || dtype != pb::kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (taper && (ah == nullptr || clip || noise != nullptr || half != 0 ||
                ph != h || pw != wc || tpad < 0 || h <= 2 * tpad ||
                wc <= 2 * tpad || (dtype == pb::kBF16 && !dst_f32)))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p;
  p.src = pb::make_view(ptr, sB, sC, sR, batch, tile0, tiles_w, step_h,
                        step_w);
  p.dst = dst;
  p.qhat2 = qhat2;
  p.noise = mode == 4 ? noise : nullptr;
  p.C = C;
  p.ph = ph;
  p.pw = pw;
  p.h = h;
  p.wc = wc;
  p.kp = kp;
  p.half = half;
  p.clip = clip;
  p.av = taper ? av : nullptr;
  p.ah = taper ? ah : nullptr;
  p.tpad = tpad;
  p.tu_f32 = src_f32 != 0 || dtype == pb::kF32;
  p.src_w = src_w;
  p.rnd = taper && dtype == pb::kBF16 ? rnd : nullptr;
  if (dtype == pb::kBF16)
    return spectral_gemm<bf16>(mode, src_f32 != 0, dst_f32 != 0, feed != 0,
                               src_b, src_h, src_w, tab, mid, p, planes, s);
  if (dtype == pb::kF32 && high)
    return spectral_gemm_hi(mode, tab, mid, p, planes, s);
  if (dtype == pb::kF32)
    return spectral_gemm<float>(mode, false, dst_f32 != 0, false, src_b,
                                src_h, src_w, tab, mid, p, planes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
