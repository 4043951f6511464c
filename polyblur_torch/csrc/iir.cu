// iir: the bidirectional first-order recursive filter of the domain
// transform, along rows and along columns, with the tiles route's
// domain-transform coefficient maps folded into the row pass.
//
// The row pass replaces polyblur_tpu/ops/pallas/iir.py::_iir_pallas_call
// (iir_scan_rows_pallas, the recurrence of _iir_kernel :76-90):
//   forward   y[i] = (1 - v[i]) x[i] + v[i] y[i-1]            (v[0] := 0)
//   backward  z[i] = (1 - v[i+1]) y[i] + v[i+1] z[i+1]        (v[W] := 0)
// The column pass is the same recurrence down the columns; it replaces the
// swapaxes + row scan of ops/domain_transform.py::recursive_filter and of
// the mega kernel's dt prefilter (polyblur_fused.py:479-483, _iir_bidi).
// The row pass's dt case also replaces the mega kernel's shared dt state
// (:436-455): the joint-image derivatives summed over the channels and,
// for one iteration (sigma_H = sigma_s),
// v = exp((1 + sigma_s / sigma_r |dI|) (-sqrt 2 / sigma_s)), computed from
// the rows the pass loads anyway (and the row above, for the column map)
// and scanned from registers: v_h never reaches device memory, v_v is
// written for the column pass.
//
// The TPU runs the recurrence as a log2(W)-step Hillis-Steele composition
// of affine maps over the lane axis. Bound on the H100: bytes — each pass
// reads x and v once and writes its output once (the dt case reads the
// tile and writes out and v_v; the column pass also writes the
// prefilter's noise), ~6 flops per element. So both passes are built to
// keep many loads in flight and to move each byte once:
//   rows     a lane owns a run of kRun = 16 adjacent elements, loaded with
//            16-byte loads where the view, the width and the maps allow
//            (else one element at a time), so a warp has its whole row's
//            loads in flight at once (the PR 3 kernel issued one 32-element
//            chunk's loads at a time, each after the previous chunk's
//            carry). A warp takes the planes that share one map (vdiv = C:
//            the C channels of a tile row), loads the map once and
//            interleaves their scans. A row of up to 512 elements is one
//            warp's and stays in registers, y included, so x and v are read
//            once and out written once. A longer row is split into
//            512-element chunks over the warps of one block (up to 8, their
//            loads in flight together), the carry passed through shared
//            memory; only past 4096 elements does the block
//            walk such spans, y then passing through `out`. The plain row
//            pass composes each lane's run serially, a 5-step shuffle scan
//            composes one map per lane, and the lane applies its carry
//            along its run (shuffles per 16 elements, not per element). The
//            dt stage keeps the PR 3 kernel's order, so that it is bit-equal
//            to it and a prefiltered path's result to the PR 3 path's:
//            chunks of 32 elements (a lane pair's runs), each composed by a
//            5-step Hillis-Steele scan, the second lane taking its
//            partner's elements by shuffles, then applied to the previous
//            chunk's last output. Its bf16 paths' estimates follow the
//            plain versions' through near-ties (chip_smoke.py's training
//            phase (h) holds a flip to a 1e-3 margin), and the run order
//            moved one past it; the pair order costs more arithmetic.
//   columns  a block owns a strip of 32 columns of one plane and walks it
//            in chunks of 32 rows: each chunk of x and v is copied
//            coalesced (cp.async, 16 bytes a thread where the width
//            allows, a ring of 3 stages two chunks ahead of the scan) into
//            32 x 36 shared tiles, and each warp scans 4 adjacent columns
//            (lane = row, one float4 each of x and v) with a 5-step
//            shuffle scan per chunk and a carry across chunks. The backward
//            pass mirrors it bottom-up; its results go back through the
//            tile so that every store is a coalesced float4 too (the
//            noise's source is loaded before the chunk's scan). For H <=
//            512 the strip's forward result stays in shared memory (448 x
//            36 f32 = 63 KB), so y never reaches device memory; taller
//            planes write y to `out` and read it back.
// The column pass composes in the PR 3 chunks of 32 too (a column of a
// plane equals the dt stage's row pass of its transpose bit for bit). Both
// orders differ from the plain version's full Hillis-Steele scan, so
// they round differently; the map contracts (v <= exp(-sqrt 2 / sigma_s) <
// 1), so the difference stays within a few f32 ulps of the signal. Every
// product and sum is rounded on its own (no FMA contraction):
// tests/test_torch_iir_rows.py emulates both row orders.
//
// The column pass used to run one thread per column down H dependent
// global loads (latency, ~13x its byte bound at config 2's tiles); the
// chunked strip needs two barriers and one carry per 32 rows, with the
// next chunks' copies in flight. Issuing the copies, not the scan, sets
// its time: a thread copies 16 bytes per chunk, and only widths that are
// no multiple of 4 (or pointers off 16 bytes) take the slower form of one
// 4-byte copy per element.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void affine_compose(float& a, float& b, float ap,
                                               float bp) {
  // (a, b) o (ap, bp) = (a ap, a bp + b)
  b = __fadd_rn(__fmul_rn(a, bp), b);
  a = __fmul_rn(a, ap);
}

// ---- row pass
constexpr int kRun = 16;                // elements per lane (a chunk: 2)
constexpr int kSeg = 32 * kRun;         // elements per warp
// rows of <= kSeg: a warp each, 2 to a block. The 3-plane kernels take
// 130-210 registers: 8-warp blocks put one block on an SM and left a
// second, nearly empty wave at config 2's 5376 rows; small blocks fill
// every SM's register file and even out the waves.
constexpr int kRowWarps = 2;
constexpr int kSegWarps = 8;            // longer rows: chunks per block

// 16 bytes at p (16-byte aligned) as f32 values: 4 f32 or 8 bf16 (a bf16
// is the upper half of its f32)
__device__ __forceinline__ void load16(const float* p, float* d) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  d[0] = q.x;
  d[1] = q.y;
  d[2] = q.z;
  d[3] = q.w;
}

__device__ __forceinline__ void load16(const pb::bf16* p, float* d) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[2 * k] = __uint_as_float(w[k] << 16);
    d[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// The run of kRun elements of a row from element i0, zeros past W. kVec:
// the row is 16-byte aligned and W a multiple of 16 bytes' elements, so a
// 16-byte piece lies wholly inside the row or wholly past it.
template <bool kVec, typename T>
__device__ __forceinline__ void load_run(const T* row, int i0, int W,
                                         float (&d)[kRun]) {
  if (kVec) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < kRun / E; ++q) {
      if (i0 + q * E < W) {
        load16(row + i0 + q * E, d + q * E);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) d[q * E + e] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      d[j] = i0 + j < W ? pb::to_f32(row[i0 + j]) : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_run(float* row, int i0, int W,
                                          const float (&d)[kRun]) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q)
      if (i0 + 4 * q < W)
        *reinterpret_cast<float4*>(row + i0 + 4 * q) =
            make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (i0 + j < W) row[i0 + j] = d[j];
  }
}

// The feedback of element j of a lane's run (element i of the row):
// forward v[i] (0 at i = 0), backward v[i+1] (0 at i = W - 1; vn is v just
// past the run); 1, with b = 0, is the identity past the row's end.
template <bool kRev>
__device__ __forceinline__ float coef(const float (&vr)[kRun], float vn,
                                      int j, int i, int W) {
  if (i >= W) return 1.f;
  if (kRev)
    return i == W - 1 ? 0.f : (j + 1 < kRun ? vr[j + 1 < kRun ? j + 1 : j]
                                            : vn);
  return i == 0 ? 0.f : vr[j];
}

// One pass of the recurrence over a span of NP rows sharing the map vr,
// the row pass's order: each lane composes its run serially, a 5-step
// shuffle scan composes one map per lane, and the lane applies its carry
// along its run; a row split over segs warps composes the warps' aggregate
// maps through `tot`. On entry xr holds the pass's inputs (x forward, y
// backward), on exit its outputs. carry: the value just before the span
// (after it, backward); a split row returns there the value at the span's
// far end.
template <int NP, bool kRev>
__device__ __forceinline__ void run_scan_pass(float (&xr)[NP][kRun],
                                              const float (&vr)[kRun],
                                              float vn, int i0, int W,
                                              int lane, int s, int segs,
                                              float (&carry)[NP],
                                              float (*tot)[NP + 1]) {
  // the lane's run composed in the pass's order: (A, B) maps the value
  // before the run to the value at its end; xr <- b
  float A = 1.f, B[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) B[p] = 0.f;
#pragma unroll
  for (int t = 0; t < kRun; ++t) {
    const int j = kRev ? kRun - 1 - t : t;
    const int i = i0 + j;
    const float a = coef<kRev>(vr, vn, j, i, W);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      // past W, a = 1 and the input is 0 (loads fill zeros) or a value
      // carried through, so b = 0
      const float b = __fmul_rn(__fsub_rn(1.f, a), xr[p][j]);
      xr[p][j] = b;
      B[p] = __fadd_rn(__fmul_rn(a, B[p]), b);
    }
    A = __fmul_rn(a, A);
  }
  // inclusive scan over the lanes: each lane's map after its predecessors'
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool in = kRev ? lane + off < 32 : lane >= off;
    const float ap = kRev ? __shfl_down_sync(kFull, A, off)
                          : __shfl_up_sync(kFull, A, off);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float bp = kRev ? __shfl_down_sync(kFull, B[p], off)
                            : __shfl_up_sync(kFull, B[p], off);
      if (in) B[p] = __fadd_rn(__fmul_rn(A, bp), B[p]);
    }
    if (in) A = __fmul_rn(A, ap);
  }
  // the warp's carry: the span's, through the maps of the warps before it
  float cw[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) cw[p] = carry[p];
  if (segs > 1) {
    __syncthreads();  // the previous pass's totals are read
    if (lane == (kRev ? 0 : 31)) {
      tot[s][0] = A;
#pragma unroll
      for (int p = 0; p < NP; ++p) tot[s][1 + p] = B[p];
    }
    __syncthreads();
    for (int u = 0; u < segs; ++u) {
      const int w = kRev ? segs - 1 - u : u;
      const float ta = tot[w][0];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (w == s) cw[p] = carry[p];
        carry[p] = __fadd_rn(__fmul_rn(ta, carry[p]), tot[w][1 + p]);
      }
    }
  }
  // the lane's carry: the value at the end of the lane before it
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const float e = __fadd_rn(__fmul_rn(A, cw[p]), B[p]);
    const float prev = kRev ? __shfl_down_sync(kFull, e, 1)
                            : __shfl_up_sync(kFull, e, 1);
    if (lane != (kRev ? 31 : 0)) cw[p] = prev;
  }
  // ... applied along the run
#pragma unroll
  for (int t = 0; t < kRun; ++t) {
    const int j = kRev ? kRun - 1 - t : t;
    const float a = coef<kRev>(vr, vn, j, i0 + j, W);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      cw[p] = __fadd_rn(__fmul_rn(a, cw[p]), xr[p][j]);
      xr[p][j] = cw[p];
    }
  }
}

// The element at pass-order position t of a lane's run
template <bool kRev>
__device__ __forceinline__ constexpr int order(int t) {
  return kRev ? kRun - 1 - t : t;
}

// x from the lane before this one in pass order
template <bool kRev>
__device__ __forceinline__ float from_prev(float x) {
  return kRev ? __shfl_down_sync(kFull, x, 1) : __shfl_up_sync(kFull, x, 1);
}

// One step of the 5-step scan within each chunk (shift kSft): every
// element composes with the one kSft before it in the chunk, the pair's
// second lane in pass order reading its partner's elements by shuffles;
// before the chunk, the identity. At kSft = kRun the partner (the first
// lane) keeps its elements, so they are read as the step goes; below, the
// ones read are taken before the step writes them.
template <int NP, bool kRev, int kSft>
__device__ __forceinline__ void chunk_step(float (&A)[kRun],
                                           float (&xr)[NP][kRun],
                                           bool second) {
  if (kSft == kRun) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const float pa = from_prev<kRev>(A[j]);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float pb = from_prev<kRev>(xr[p][j]);
        const float b = __fadd_rn(__fmul_rn(A[j], pb), xr[p][j]);
        xr[p][j] = second ? b : xr[p][j];
      }
      A[j] = second ? __fmul_rn(A[j], pa) : A[j];
    }
    return;
  }
  constexpr int kQ = kSft < kRun ? kSft : 1;
  float pa[kQ], pb[NP][kQ];  // the partner's last kSft elements
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = order<kRev>(kRun - kQ + q);
    pa[q] = from_prev<kRev>(A[j]);
#pragma unroll
    for (int p = 0; p < NP; ++p) pb[p][q] = from_prev<kRev>(xr[p][j]);
  }
#pragma unroll
  for (int t = kRun - 1; t >= 0; --t) {  // sources t - kSft still unwritten
    const int j = order<kRev>(t);
    if (t >= kQ) {
      const int k = order<kRev>(t >= kQ ? t - kQ : 0);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        xr[p][j] = __fadd_rn(__fmul_rn(A[j], xr[p][k]), xr[p][j]);
      A[j] = __fmul_rn(A[j], A[k]);
    } else {
      const int q = t < kQ ? t : 0;  // the partner's position kRun - kSft + t
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float b = __fadd_rn(__fmul_rn(A[j], pb[p][q]), xr[p][j]);
        xr[p][j] = second ? b : xr[p][j];
      }
      A[j] = second ? __fmul_rn(A[j], pa[q]) : A[j];
    }
  }
}

// The chunk walk's shared memory, by chunk of the block (warp w's chunk c
// at w kWarpChunks + c): each chunk's total (A, then B per plane) and the
// value carried into it, and each row's value at its far end (by warp).
constexpr int kWarpChunks = kSeg / 32;
template <int NP>
struct Walk {
  float tot[kSegWarps * kWarpChunks][NP + 1];
  float cin[kSegWarps * kWarpChunks][NP];
  float end[kSegWarps][NP];
};

// One pass of the recurrence over a span of NP rows sharing the map vr, the
// dt stage's order, the PR 3 kernel's, so that it is bit-equal to it: the
// row in chunks of 32 elements (a lane pair's runs), each chunk's maps
// composed by a 5-step Hillis-Steele scan (identity shifted in at the
// chunk's start) and applied to the value carried in, the previous chunk's
// last output; backward the mirror image. On entry xr holds the pass's inputs (x
// forward, y backward), on exit its outputs. carry: the value just before
// the span (after it, backward), returned as the value at its far end.
template <int NP, bool kRev>
__device__ __forceinline__ void pair_scan_pass(float (&xr)[NP][kRun],
                                               const float (&vr)[kRun],
                                               float vn, int i0, int W,
                                               int lane, int s, int segs,
                                               float (&carry)[NP],
                                               Walk<NP>& walk) {
  // the elements' maps (a, b): A, and b into xr; identity past W
  float A[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int i = i0 + j;
    const float a = coef<kRev>(vr, vn, j, i, W);
    A[j] = a;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      xr[p][j] = i < W ? __fmul_rn(__fsub_rn(1.f, a), xr[p][j]) : 0.f;
  }
  // the scan within each chunk
  const bool second = ((lane & 1) != 0) != kRev;
  chunk_step<NP, kRev, 1>(A, xr, second);
  chunk_step<NP, kRev, 2>(A, xr, second);
  chunk_step<NP, kRev, 4>(A, xr, second);
  chunk_step<NP, kRev, 8>(A, xr, second);
  chunk_step<NP, kRev, 16>(A, xr, second);
  // the walk: one lane per row carries the value through the span's
  // chunks in pass order (a chunk's total, at its second lane's last
  // element, applied to the value), through shared memory
  const int warp = threadIdx.x / 32;
  const int first = segs == 1 ? warp * kWarpChunks : 0;  // the row's chunks
  const int mine_c = first + s * kWarpChunks + lane / 2;
  const int span0 = i0 - s * kSeg - lane * kRun;  // the span's first element
  const int n = min(segs * kWarpChunks, (W - span0 + 31) / 32);
  auto sync = [segs] {
    if (segs > 1)
      __syncthreads();
    else
      __syncwarp();
  };
  sync();  // the previous pass's reads of the walk are done
  if (second) {
    constexpr int jl = order<kRev>(kRun - 1);
    walk.tot[mine_c][0] = A[jl];
#pragma unroll
    for (int p = 0; p < NP; ++p) walk.tot[mine_c][1 + p] = xr[p][jl];
  }
  sync();
  if (lane == 0 && (segs == 1 || s == 0)) {
    float cur[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) cur[p] = carry[p];
#pragma unroll 4
    for (int u = 0; u < n; ++u) {
      const int c = first + (kRev ? n - 1 - u : u);
      const float ta = walk.tot[c][0];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        walk.cin[c][p] = cur[p];
        cur[p] = __fadd_rn(__fmul_rn(ta, cur[p]), walk.tot[c][1 + p]);
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) walk.end[warp][p] = cur[p];
  }
  sync();
  // each element's output: its chunk prefix applied to the chunk's carry
  // (lanes wholly past W take 0: their outputs are not stored)
  const bool in = mine_c - first < n;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const float m = in ? walk.cin[mine_c][p] : 0.f;
    carry[p] = walk.end[segs == 1 ? warp : 0][p];
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      xr[p][j] = __fadd_rn(__fmul_rn(A[j], m), xr[p][j]);
  }
}

struct RowArgs {
  pb::TileView xv;       // the (n, C, H, W) planes
  int C, H, W;
  const float* v;        // (maps, H, W) f32; null in the dt case
  int vdiv;              // planes per map (dt: C)
  float* out;            // (n C, H, W) f32
  int maps;
  int segs;              // warps per row: 1 (a warp per row), or its chunks
  const float* coeffs;   // dt: sigma_s, sigma_r at 6, 7
  float* v_v;            // dt: (n, H, W) f32, the column pass's maps
};

// dt: one channel's contribution to the summed absolute differences of
// the lane's run: f its row from element i0, u the row above (read when y
// > 0), left0 the element before the run (read by lane 0 when i0 > 0)
__device__ __forceinline__ void dt_accumulate(const float (&f)[kRun],
                                              const float (&u)[kRun],
                                              float left0, int i0, int W,
                                              int y, int lane,
                                              float (&dx)[kRun],
                                              float (&dy)[kRun]) {
  // the element before the run: the previous lane's last, else left0
  float left = __shfl_up_sync(kFull, f[kRun - 1], 1);
  if (lane == 0) left = left0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int i = i0 + j;
    const float fl = j == 0 ? left : f[j > 0 ? j - 1 : 0];
    if (i > 0 && i < W) dx[j] = __fadd_rn(dx[j], fabsf(__fsub_rn(f[j], fl)));
    if (y > 0 && i < W)
      dy[j] = __fadd_rn(dy[j], fabsf(__fsub_rn(f[j], u[j])));
  }
}

// The loads of dt_accumulate's operands for one channel's row
template <bool kVec, typename T>
__device__ __forceinline__ void dt_load(const T* row, long long sR, int i0,
                                        int W, int y, int lane,
                                        float (&f)[kRun], float (&u)[kRun],
                                        float& left0) {
  load_run<kVec>(row, i0, W, f);
  if (y > 0) load_run<kVec>(row - sR, i0, W, u);
  left0 = lane == 0 && i0 > 0 ? pb::to_f32(row[i0 - 1]) : 0.f;
}

// dt: the maps of row y of tile m over the lane's run, in the order of
// the plain version (channels in order, then dH = ratio dx + 1, v =
// exp(dH log_a), each operation rounded): v_h into vr, v_v stored; the
// channels' rows into xr when the warp scans all C at once (NP == C)
template <bool kVec, typename T, int NP>
__device__ __forceinline__ void dt_maps(const RowArgs& a, int m, int y,
                                        int i0, int lane, float (&vr)[kRun],
                                        float (&xr)[NP][kRun]) {
  const T* src = static_cast<const T*>(a.xv.ptr);
  const int W = a.W;
  float dx[kRun], dy[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) dx[j] = dy[j] = 0.f;
  if (NP == a.C) {
    // every load in flight before the first use
    float up[NP][kRun], left0[NP];
#pragma unroll
    for (int c = 0; c < NP; ++c)
      dt_load<kVec>(src + a.xv.offset(m, c, y, 0), a.xv.sR, i0, W, y, lane,
                    xr[c], up[c], left0[c]);
#pragma unroll
    for (int c = 0; c < NP; ++c)
      dt_accumulate(xr[c], up[c], left0[c], i0, W, y, lane, dx, dy);
  } else {
    for (int c = 0; c < a.C; ++c) {
      float f[kRun], up[kRun], left0;
      dt_load<kVec>(src + a.xv.offset(m, c, y, 0), a.xv.sR, i0, W, y, lane,
                    f, up, left0);
      dt_accumulate(f, up, left0, i0, W, y, lane, dx, dy);
    }
  }
  const float sigma_s = a.coeffs[6], sigma_r = a.coeffs[7];
  const float ratio = __fdiv_rn(sigma_s, sigma_r);
  const float log_a = __fdiv_rn(-1.41421356237309515f, sigma_s);
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const float dh = i0 + j > 0 ? __fadd_rn(__fmul_rn(ratio, dx[j]), 1.f)
                                : 1.f;
    const float dv = y > 0 ? __fadd_rn(__fmul_rn(ratio, dy[j]), 1.f) : 1.f;
    vr[j] = expf(__fmul_rn(dh, log_a));
    dy[j] = expf(__fmul_rn(dv, log_a));
  }
  store_run<kVec>(a.v_v + ((long long)m * a.H + y) * W, i0, W, dy);
}

// A warp per (map, row) for W <= kSeg, several rows to a block; else a
// block of segs warps per (map, row), warp s owning elements [s kSeg,
// (s + 1) kSeg) of each span of segs kSeg. kVec: the view, W, v, out and
// v_v allow 16-byte accesses (load_run). kDt: v_h and v_v from the tiles
// (one span: W <= kSegWarps kSeg).
template <typename T, int NP, bool kVec, bool kDt>
__global__ void __launch_bounds__(kSegWarps * 32)
iir_rows_kernel(const RowArgs a) {
  __shared__ Walk<NP> walk;
  __shared__ float vfirst[kSegWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int segs = a.segs, H = a.H, W = a.W;
  const long long r =
      segs == 1 ? (long long)blockIdx.x * kRowWarps + warp : blockIdx.x;
  if (r >= (long long)a.maps * H) return;  // whole warps, no barrier
  const int s = segs == 1 ? 0 : warp;
  const int m = (int)(r / H), y = (int)(r - (long long)m * H);
  const int span = segs * kSeg;
  const int nsp = (W + span - 1) / span;
  const long long mrow = ((long long)m * H + y) * W;  // the map's row
  const int i00 = s * kSeg + lane * kRun;  // the lane's run in span 0
  float vr[kRun];
  float xr[NP][kRun];
  if (kDt)
    dt_maps<kVec, T, NP>(a, m, y, i00, lane, vr, xr);
  else if (nsp == 1)
    load_run<kVec>(a.v + mrow, i00, W, vr);
  const T* src = static_cast<const T*>(a.xv.ptr);
  for (int g = 0; g < a.vdiv / NP; ++g) {
    const int p0 = m * a.vdiv + g * NP;
    const T* xrow[NP];
    float* orow[NP];
    float carry[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = p0 + q, n = p / a.C;
      xrow[q] = src + a.xv.offset(n, p - n * a.C, y, 0);
      orow[q] = a.out + ((long long)p * H + y) * W;
      carry[q] = 0.f;
    }
    for (int k = 0; k < nsp; ++k) {
      const int i0 = k * span + i00;
      if (nsp > 1) load_run<kVec>(a.v + mrow, i0, W, vr);
      if (!kDt || NP != a.C) {
#pragma unroll
        for (int q = 0; q < NP; ++q) load_run<kVec>(xrow[q], i0, W, xr[q]);
      }
      // read after the pass's barriers (stored after the loads: a warp
      // issues in order, and the store waits for v)
      if (segs > 1 && nsp == 1 && g == 0 && lane == 0) vfirst[s] = vr[0];
      if (kDt)
        pair_scan_pass<NP, false>(xr, vr, 0.f, i0, W, lane, s, segs,
                                  carry, walk);
      else
        run_scan_pass<NP, false>(xr, vr, 0.f, i0, W, lane, s, segs,
                                 carry, walk.tot);
      if (nsp > 1) {
#pragma unroll
        for (int q = 0; q < NP; ++q) store_run<kVec>(orow[q], i0, W, xr[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) carry[q] = 0.f;
    for (int k = nsp - 1; k >= 0; --k) {
      const int i0 = k * span + i00;
      if (nsp > 1) {
        load_run<kVec>(a.v + mrow, i0, W, vr);
#pragma unroll
        for (int q = 0; q < NP; ++q)  // y, stored by this lane
          load_run<kVec>(static_cast<const float*>(orow[q]), i0, W, xr[q]);
        __syncthreads();  // the previous span's vfirst is read
        if (lane == 0) vfirst[s] = vr[0];
        __syncthreads();
      }
      // v just past the lane's run: the next lane's first, the next
      // warp's, or the next span's
      float vn = __shfl_down_sync(kFull, vr[0], 1);
      if (lane == 31) {
        const int inext = i0 + kRun;
        vn = s + 1 < segs ? vfirst[s + 1]
                          : (!kDt && inext < W ? a.v[mrow + inext] : 0.f);
      }
      if (kDt)
        pair_scan_pass<NP, true>(xr, vr, vn, i0, W, lane, s, segs,
                                 carry, walk);
      else
        run_scan_pass<NP, true>(xr, vr, vn, i0, W, lane, s, segs,
                                carry, walk.tot);
#pragma unroll
      for (int q = 0; q < NP; ++q) store_run<kVec>(orow[q], i0, W, xr[q]);
    }
  }
}

// ---- column pass
constexpr int kStrip = 32;                 // columns per block
constexpr int kChunk = 32;                 // rows per chunk
constexpr int kColWarps = 8;               // warp w scans columns 4w .. 4w+3
constexpr int kStages = 3;                 // the cp.async ring
constexpr int kP = kStrip + 4;             // shared row pitch, floats
constexpr int kTile = kChunk * kP;         // floats per shared tile
constexpr int kSmemYRows = 512;            // y in shared memory up to here
static_assert(kColWarps * 32 == kChunk * kStrip / 4,
              "one 16-byte copy per thread and tile");

// Asynchronous copies to shared memory, zero-filled when !in: 16 bytes
// (the global address 16-byte aligned) or 4.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x: (planes, H, W) f32; out may alias x. Block (strip, plane). With
// `noise`, also writes noise = src - out, src being the (pre-filter) planes
// of the TileView. kSmemY: the strip's forward result stays in shared
// memory (H <= kSmemYRows). kVec: W % 4 == 0 and x, v, out, noise 16-byte
// aligned; each thread then copies and stores one float4 of a 32 x 32
// chunk (row tid / 8), else four floats (rows warp + 8 j, column lane).
// In the shared tiles (pitch 36 floats) a lane's float4 of 4 columns of
// its row is conflict-free for the scan (a quarter-warp's 8 rows cover
// the 32 banks) and for the stores (a quarter-warp reads one row).
template <typename T, bool kSmemY, bool kVec>
__global__ void __launch_bounds__(kColWarps * 32)
iir_cols_kernel(const float* x, int H, int W, const float* __restrict__ v,
                int vdiv, float* out, pb::TileView src, int C,
                float* __restrict__ noise) {
  extern __shared__ __align__(16) float smem[];
  float* ys = smem + kStages * 2 * kTile;  // kSmemY: (H, kP)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = blockIdx.y, col0 = blockIdx.x * kStrip;
  const long long plane = (long long)p * H * W;
  const float* vp = v + (long long)(p / vdiv) * H * W;
  float* op = out + plane;
  const int nch = (H + kChunk - 1) / kChunk;
  // the chunk elements this thread copies and stores: (row, column) in
  // the chunk of e = 0..3
  auto rc = [&](int e, int& r, int& c) {
    r = kVec ? tid / 8 : warp + kColWarps * e;
    c = kVec ? 4 * (tid % 8) + e : lane;
  };

  // rows 32 k .. of `a` (x, or y read back; none when null) and of v
  // shifted down by `vsh` rows into stage s; zeros past the plane
  auto load = [&](const float* a, int k, int vsh, int s) {
    float* xs = smem + s * 2 * kTile;
#pragma unroll
    for (int e = 0; e < (kVec ? 1 : 4); ++e) {
      int r, c;
      rc(e, r, c);
      const int row = k * kChunk + r, col = col0 + c;
      const bool in = col < W && row < H;
      const bool vin = col < W && row + vsh < H;
      const float* ga = in ? a + (long long)row * W + col : a;
      const float* gv = vin ? vp + (long long)(row + vsh) * W + col : vp;
      if (kVec) {
        if (a != nullptr) cp_async16(xs + r * kP + c, ga, in);
        cp_async16(xs + kTile + r * kP + c, gv, vin);
      } else {
        if (a != nullptr) cp_async4(xs + r * kP + c, ga, in);
        cp_async4(xs + kTile + r * kP + c, gv, vin);
      }
    }
  };

  // forward: y[i] = (1 - v[i]) x[i] + v[i] y[i-1], v[0] := 0
  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  const float* xp = x + plane;
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nch) load(xp, k, 0, k);
    cp_async_commit();
  }
  for (int k = 0; k < nch; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk k is in; chunk k - 1's stage is free
    if (k + kStages - 1 < nch)
      load(xp, k + kStages - 1, 0, (k + kStages - 1) % kStages);
    cp_async_commit();
    float* xs = smem + (k % kStages) * 2 * kTile;
    const int i = k * kChunk + lane;
    float4* xl = reinterpret_cast<float4*>(xs + lane * kP + 4 * warp);
    const float4 x4 = *xl;
    const float4 v4 = *reinterpret_cast<const float4*>(xs + kTile +
                                                       lane * kP + 4 * warp);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
    float a[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = 1.f;  // identity past the plane's end
      b[j] = 0.f;
      if (i < H) {
        const float vi = i == 0 ? 0.f : vv[j];
        a[j] = vi;
        b[j] = __fmul_rn(__fsub_rn(1.f, vi), xv[j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ap = __shfl_up_sync(0xffffffffu, a[j], off);
        const float bp = __shfl_up_sync(0xffffffffu, b[j], off);
        if (lane >= off) affine_compose(a[j], b[j], ap, bp);
      }
    }
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = __fadd_rn(__fmul_rn(a[j], carry[j]), b[j]);
      carry[j] = __shfl_sync(0xffffffffu, y[j], 31);
    }
    const float4 y4 = make_float4(y[0], y[1], y[2], y[3]);
    if (kSmemY) {
      if (i < H) *reinterpret_cast<float4*>(ys + i * kP + 4 * warp) = y4;
    } else {
      *xl = y4;  // the elements this thread read
      __syncthreads();
#pragma unroll
      for (int e = 0; e < (kVec ? 1 : 4); ++e) {
        int r, c;
        rc(e, r, c);
        const int row = k * kChunk + r, col = col0 + c;
        if (row < H && col < W) {
          float* d = op + (long long)row * W + col;
          if (kVec)
            *reinterpret_cast<float4*>(d) =
                *reinterpret_cast<const float4*>(xs + r * kP + c);
          else
            *d = xs[r * kP + c];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage consumed, y written

  // backward: z[i] = (1 - v[i+1]) y[i] + v[i+1] z[i+1], v[H] := 0
#pragma unroll
  for (int j = 0; j < 4; ++j) carry[j] = 0.f;
  const float* yp = kSmemY ? nullptr : op;
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nch) load(yp, nch - 1 - t, 1, t);
    cp_async_commit();
  }
  const int n = p / C, ch = p - (p / C) * C;
  const T* sp = noise != nullptr
                    ? static_cast<const T*>(src.ptr) + src.offset(n, ch, 0, 0)
                    : nullptr;
  for (int t = 0; t < nch; ++t) {
    const int k = nch - 1 - t;
    // the noise's source elements of this chunk, in flight during the scan
    float sv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int r, c;
      rc(e, r, c);
      const int row = k * kChunk + r, col = col0 + c;
      sv[e] = sp != nullptr && row < H && col < W
                  ? pb::to_f32(sp[(long long)row * src.sR + col])
                  : 0.f;
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < nch)
      load(yp, nch - kStages - t, 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    float* xs = smem + (t % kStages) * 2 * kTile;
    const int i = k * kChunk + lane;
    float4* xl = reinterpret_cast<float4*>(xs + lane * kP + 4 * warp);
    const float4 y4 = kSmemY ? *reinterpret_cast<const float4*>(
                                   ys + min(i, H - 1) * kP + 4 * warp)
                             : *xl;
    const float4 v4 = *reinterpret_cast<const float4*>(xs + kTile +
                                                       lane * kP + 4 * warp);
    const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
    float a[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = 1.f;
      b[j] = 0.f;
      if (i < H) {
        const float vs = i == H - 1 ? 0.f : vv[j];
        a[j] = vs;
        b[j] = __fmul_rn(__fsub_rn(1.f, vs), yv[j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float an = __shfl_down_sync(0xffffffffu, a[j], off);
        const float bn = __shfl_down_sync(0xffffffffu, b[j], off);
        if (lane + off < 32) affine_compose(a[j], b[j], an, bn);
      }
    }
    float z[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      z[j] = __fadd_rn(__fmul_rn(a[j], carry[j]), b[j]);
      carry[j] = __shfl_sync(0xffffffffu, z[j], 0);
    }
    *xl = make_float4(z[0], z[1], z[2], z[3]);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < (kVec ? 1 : 4); ++e) {
      int r, c;
      rc(e, r, c);
      const int row = k * kChunk + r, col = col0 + c;
      if (row < H && col < W) {
        const long long o = (long long)row * W + col;
        if (kVec) {
          const float4 z4 = *reinterpret_cast<const float4*>(xs + r * kP + c);
          *reinterpret_cast<float4*>(op + o) = z4;
          if (noise != nullptr)
            *reinterpret_cast<float4*>(noise + plane + o) = make_float4(
                __fsub_rn(sv[0], z4.x), __fsub_rn(sv[1], z4.y),
                __fsub_rn(sv[2], z4.z), __fsub_rn(sv[3], z4.w));
        } else {
          const float zi = xs[r * kP + c];
          op[o] = zi;
          if (noise != nullptr) noise[plane + o] = __fsub_rn(sv[e], zi);
        }
      }
    }
  }
}

}  // namespace

template <typename T, bool kSmemY, bool kVec>
static int launch_cols(dim3 grid, size_t smem, cudaStream_t s, const float* x,
                       int H, int W, const float* v, int vdiv, float* out,
                       const pb::TileView& src, int C, float* noise) {
  auto kern = iir_cols_kernel<T, kSmemY, kVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kColWarps * 32, smem, s>>>(x, H, W, v, vdiv, out, src, C,
                                          noise);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_cols(bool smem_y, bool vec, dim3 grid, size_t smem,
                       cudaStream_t s, const float* x, int H, int W,
                       const float* v, int vdiv, float* out,
                       const pb::TileView& src, int C, float* noise) {
  if (smem_y)
    return vec ? launch_cols<T, true, true>(grid, smem, s, x, H, W, v, vdiv,
                                            out, src, C, noise)
               : launch_cols<T, true, false>(grid, smem, s, x, H, W, v, vdiv,
                                             out, src, C, noise);
  return vec ? launch_cols<T, false, true>(grid, smem, s, x, H, W, v, vdiv,
                                           out, src, C, noise)
             : launch_cols<T, false, false>(grid, smem, s, x, H, W, v, vdiv,
                                            out, src, C, noise);
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  if (planes < 1 || planes > 65535 || H < 1 || W < 1 || vdiv < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const pb::TileView src = pb::make_view(ptr, sB, sC, sR, batch, tile0,
                                         tiles_w, step_h, step_w);
  const bool smem_y = H <= kSmemYRows;
  const bool vec = W % 4 == 0 && aligned16(x) && aligned16(v) &&
                   aligned16(out) && aligned16(noise);
  const size_t smem = sizeof(float) * (kStages * 2 * kTile +
                                       (smem_y ? (size_t)H * kP : 0));
  dim3 grid((W + kStrip - 1) / kStrip, planes);
  if (src_dtype == pb::kBF16)
    return launch_cols<pb::bf16>(smem_y, vec, grid, smem, s, x, H, W, v,
                                 vdiv, out, src, C, noise);
  if (src_dtype == pb::kF32)
    return launch_cols<float>(smem_y, vec, grid, smem, s, x, H, W, v, vdiv,
                              out, src, C, noise);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static bool rows_vec(const pb::TileView& xv, int W) {
  constexpr long long E = 16 / sizeof(T);
  return aligned16(xv.ptr) && xv.sB % E == 0 && xv.sC % E == 0 &&
         xv.sR % E == 0 && xv.step_w % E == 0 && W % E == 0;
}

template <typename T, int NP, bool kDt>
static int launch_rows(const RowArgs& a, bool vec, cudaStream_t s) {
  const long long rows = (long long)a.maps * a.H;
  const long long blocks =
      a.segs == 1 ? (rows + kRowWarps - 1) / kRowWarps : rows;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * (a.segs == 1 ? kRowWarps : a.segs);
  if (vec)
    iir_rows_kernel<T, NP, true, kDt><<<(unsigned)blocks, threads, 0, s>>>(a);
  else
    iir_rows_kernel<T, NP, false, kDt><<<(unsigned)blocks, threads, 0, s>>>(
        a);
  return static_cast<int>(cudaGetLastError());
}

// The warps per row, and the launch by dtype and planes per warp (3 where
// the map's planes come in threes: the channels of an RGB tile)
template <bool kDt>
static int rows_entry(int dtype, RowArgs a, bool vec_io, cudaStream_t s) {
  a.segs = a.W <= kSeg ? 1 : std::min(kSegWarps, (a.W + kSeg - 1) / kSeg);
  const bool np3 = a.vdiv % 3 == 0;
  if (dtype == pb::kBF16) {
    const bool vec = vec_io && rows_vec<pb::bf16>(a.xv, a.W);
    return np3 ? launch_rows<pb::bf16, 3, kDt>(a, vec, s)
               : launch_rows<pb::bf16, 1, kDt>(a, vec, s);
  }
  if (dtype == pb::kF32) {
    const bool vec = vec_io && rows_vec<float>(a.xv, a.W);
    return np3 ? launch_rows<float, 3, kDt>(a, vec, s)
               : launch_rows<float, 1, kDt>(a, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Row pass over the n C H rows of the TileView's (n, C, H, W) planes;
// v: (planes / vdiv, H, W) f32 (vdiv = C shares one map across a tile's
// channels); out: (n C, H, W) f32.
extern "C" int pb_iir_rows(int dtype, const void* ptr, long long sB,
                           long long sC, long long sR, int batch, int tile0,
                           int tiles_w, int step_h, int step_w, int n, int C,
                           int H, int W, const float* v, int vdiv, float* out,
                           void* stream) {
  if (n < 1 || C < 1 || H < 1 || W < 1 || vdiv < 1 ||
      ((long long)n * C) % vdiv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  RowArgs a;
  a.xv = pb::make_view(ptr, sB, sC, sR, batch, tile0, tiles_w, step_h,
                       step_w);
  a.C = C;
  a.H = H;
  a.W = W;
  a.v = v;
  a.vdiv = vdiv;
  a.out = out;
  a.maps = static_cast<int>((long long)n * C / vdiv);
  a.coeffs = nullptr;
  a.v_v = nullptr;
  return rows_entry<false>(dtype, a, aligned16(v) && aligned16(out),
                            static_cast<cudaStream_t>(stream));
}

// The dt stage's maps and row pass in one launch: from the n tiles of C
// channels of the TileView and coeffs[6], coeffs[7] = sigma_s, sigma_r,
// out = the row pass of the tiles with v_h, (n C, H, W) f32, and v_v, (n,
// H, W) f32. W <= 4096 (one span).
extern "C" int pb_dt_rows(int dtype, const void* ptr, long long sB,
                          long long sC, long long sR, int batch, int tile0,
                          int tiles_w, int step_h, int step_w, int n, int C,
                          int H, int W, const float* coeffs, float* out,
                          float* v_v, void* stream) {
  if (n < 1 || C < 1 || H < 1 || W < 1 || W > kSegWarps * kSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  RowArgs a;
  a.xv = pb::make_view(ptr, sB, sC, sR, batch, tile0, tiles_w, step_h,
                       step_w);
  a.C = C;
  a.H = H;
  a.W = W;
  a.v = nullptr;
  a.vdiv = C;
  a.out = out;
  a.maps = n;
  a.coeffs = coeffs;
  a.v_v = v_v;
  return rows_entry<true>(dtype, a, aligned16(out) && aligned16(v_v),
                           static_cast<cudaStream_t>(stream));
}
