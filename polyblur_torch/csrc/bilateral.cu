// bilateral: the 5 x 5 bilateral filter of a batch of (image, channel)
// planes, replicate-padded at the plane edges.
//
// Replaces polyblur_tpu/ops/pallas/bilateral.py::_call (bilateral_pallas,
// the math of bilateral_block :54-74) and the mega kernel's bilateral
// prefilter stage (polyblur_fused.py:475-478). Per output pixel x:
//   f_s  = exp(-(s - x)^2 / (2 sigma_c^2)) * gw[dy][dx]   over the 25 taps s
//   out  = sum f_s s / (sum f_s + 1e-5)
// with the spatial weights gw computed on the host exactly as
// bilateral_block does (float64, then cast to f32), accumulated in f32 in
// the TPU kernel's tap order (dy outer, dx inner).
//
// The TPU program holds a whole plane in VMEM (up to 640 px). Here one
// thread computes one output pixel; the block's 32 x 8 output tile and its
// 2-pixel halo are staged once in shared memory with the replicate clamp
// applied on load, so any plane size runs. The input is read through a
// TileView (the patch engine's first iteration reads its tiles straight
// from the canvas); the output is `smooth` in f32 or bf16 and, when asked,
// `noise = x - smooth` in f32 in the same pass (the tiles route's
// prefilter keeps both in f32, as the TPU kernel does).
//
// Bound on the H100: operations — 25 accurate exponentials and ~8 f32
// flops per tap per pixel against one input read and one or two outputs
// written per pixel. Design: each input element is loaded from device
// memory once per block (36 x 12 staged values for 32 x 8 outputs), the
// taps read shared memory, and the exponentials are expf (not __expf), as
// the reference's exp.
#include "common.cuh"

namespace {

constexpr int kK = 5;       // taps per axis
constexpr int kR = kK / 2;  // halo
constexpr int kBX = 32, kBY = 8;

struct Weights {
  float w[kK * kK];
};

template <typename T>
__global__ void __launch_bounds__(kBX * kBY)
bilateral_kernel(pb::TileView v, int C, int H, int W, Weights gw,
                 float inv_var2, int out_dtype, void* __restrict__ smooth,
                 float* __restrict__ noise) {
  __shared__ float tile[kBY + 2 * kR][kBX + 2 * kR];
  const int p = blockIdx.z;
  const int n = p / C, c = p - (p / C) * C;
  const T* src = static_cast<const T*>(v.ptr) + v.offset(n, c, 0, 0);
  const int x0 = blockIdx.x * kBX, y0 = blockIdx.y * kBY;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int e = tid; e < (kBY + 2 * kR) * (kBX + 2 * kR); e += kBX * kBY) {
    const int ty = e / (kBX + 2 * kR), tx = e - ty * (kBX + 2 * kR);
    const int yy = min(max(y0 + ty - kR, 0), H - 1);
    const int xx = min(max(x0 + tx - kR, 0), W - 1);
    tile[ty][tx] = pb::to_f32(src[(long long)yy * v.sR + xx]);
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float xc = tile[threadIdx.y + kR][threadIdx.x + kR];
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int dy = 0; dy < kK; ++dy)
#pragma unroll
    for (int dx = 0; dx < kK; ++dx) {
      const float s = tile[threadIdx.y + dy][threadIdx.x + dx];
      const float d = __fsub_rn(s, xc);
      const float f =
          __fmul_rn(expf(__fmul_rn(__fmul_rn(-d, d), inv_var2)),
                    gw.w[dy * kK + dx]);
      num = __fadd_rn(num, __fmul_rn(f, s));
      den = __fadd_rn(den, f);
    }
  const float out = __fdiv_rn(num, __fadd_rn(den, 1e-5f));
  const long long o = ((long long)p * H + y) * W + x;
  if (out_dtype == pb::kBF16)
    static_cast<pb::bf16*>(smooth)[o] = pb::from_f32<pb::bf16>(out);
  else
    static_cast<float*>(smooth)[o] = out;
  if (noise != nullptr) noise[o] = __fsub_rn(xc, out);
}

}  // namespace

// view: the n tiles / images of C channels (dtype `dtype`), (H, W) each;
// gw: the 25 host spatial weights (row dy, column dx); smooth: (n C, H, W)
// contiguous in `out_dtype`; noise: (n C, H, W) f32 or null.
extern "C" int pb_bilateral(int dtype, const void* ptr, long long sB,
                            long long sC, long long sR, int batch, int tile0,
                            int tiles_w, int step_h, int step_w, int n, int C,
                            int H, int W, const float* gw, float inv_var2,
                            int out_dtype, void* smooth, float* noise,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * C > 65535 || (out_dtype != pb::kF32 && out_dtype != pb::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const pb::TileView v = pb::make_view(ptr, sB, sC, sR, batch, tile0, tiles_w,
                                       step_h, step_w);
  Weights w;
  for (int i = 0; i < kK * kK; ++i) w.w[i] = gw[i];
  dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, n * C);
  dim3 block(kBX, kBY);
  if (dtype == pb::kBF16)
    bilateral_kernel<pb::bf16><<<grid, block, 0, s>>>(
        v, C, H, W, w, inv_var2, out_dtype, smooth, noise);
  else if (dtype == pb::kF32)
    bilateral_kernel<float><<<grid, block, 0, s>>>(v, C, H, W, w, inv_var2,
                                                   out_dtype, smooth, noise);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
