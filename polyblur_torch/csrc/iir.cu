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
// of affine maps over the lane axis. Here both passes compose it in chunks
// of 32 with a 5-step warp-shuffle affine scan, each chunk applied to the
// carry of the previous one (a multiply and an add, the only serial step
// per chunk):
//   rows     one warp per row walks it in chunks of 32, forward, then
//            backward over the forward result (each lane re-reads only
//            what it wrote itself);
//   columns  a block owns a strip of 32 columns of one plane and walks it
//            in chunks of 32 rows: each chunk of x and v is copied
//            coalesced (cp.async, 16 bytes a thread where the width
//            allows, a ring of 3 stages two chunks ahead of the scan) into
//            32 x 36 shared tiles, and each warp scans 4 adjacent columns
//            (lane = row, one float4 each of x and v), the row pass
//            transposed. The backward pass mirrors it bottom-up; its
//            results go back through the tile so that every store is a
//            coalesced float4 too (the noise's source is loaded before
//            the chunk's scan). For H <= 512 the strip's forward result
//            stays in shared memory (448 x 36 f32 = 63 KB), so y never
//            reaches device memory; taller planes write y to `out` and
//            read it back.
// A chunked composition rounds differently from the full Hillis-Steele
// scan; the map contracts (v <= exp(-sqrt 2 / sigma_s) < 1), so the
// difference stays within a few f32 ulps of the signal. Both passes
// compose in the same chunks, so the column pass of a plane equals the
// row pass of its transpose bit for bit.
//
// Bound on the H100: bytes — each pass reads x and v once and writes its
// output once (the column pass also the prefilter's noise), ~6 flops per
// element. The column pass used to run one thread per column down H
// dependent global loads and back (latency, ~13x its byte bound at
// config 2's tiles); the chunked strip needs two barriers and one carry
// per 32 rows, with the next chunks' copies in flight. Issuing the
// copies, not the scan, sets the time: a thread copies 16 bytes per
// chunk, and only widths that are no multiple of 4 (or pointers off 16
// bytes) take the slower form of one 4-byte copy per element.
#include <cstdint>

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
