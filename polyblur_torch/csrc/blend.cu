// blend_overlap_add: windowed overlap-add of a restored tile batch into the
// cropped output image.
//
// Replaces the blend of polyblur_tpu/ops/pallas/polyblur_fused.py
// (_make_kernel's blend branch, the carried row/column/corner strips) and
// polyblur_tpu/ops/pallas/overlap_add.py::overlap_add_fused. The TPU blend
// carries neighbour strips across grid programs that run in order; CUDA
// blocks run in no order, so this is the gather form instead: one thread
// per cropped output pixel reads the (at most 2 x 2, for overlaps up to
// 50%) tiles covering it, times the window, sums in f32 in the TPU
// kernel's order (own tile, left, top, top-left), multiplies by the
// host-computed reciprocal window sum, clips to [0, 1] and writes the
// output dtype. The crop to the original image is folded in.
//
// Bound on the H100: bytes (each tile element is read once except in the
// overlap seams; the output is written once). Consecutive threads handle
// consecutive output columns, so tile, window and output accesses are
// coalesced.
#include "common.cuh"

namespace {

template <typename TI, typename TO>
__global__ void blend_kernel(const TI* __restrict__ tiles,
                             const float* __restrict__ win,
                             const float* __restrict__ inv_wsum,
                             TO* __restrict__ out, int B, int C, int th,
                             int tw, int sh, int sw, int ph, int pw, int Wc,
                             int pt, int pl, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int bc = blockIdx.z;
  if (x >= w) return;
  const int b = bc / C;
  const int c = bc - b * C;
  const int Y = y + pt;
  const int X = x + pl;
  const int ki0 = Y / sh;
  const int kj0 = X / sw;
  const long long plane = (long long)ph * pw;
  float acc = 0.f;
  for (int ki = ki0; ki >= 0 && Y - ki * sh < ph; --ki) {
    if (ki >= th) continue;
    const int ly = Y - ki * sh;
    for (int kj = kj0; kj >= 0 && X - kj * sw < pw; --kj) {
      if (kj >= tw) continue;
      const int lx = X - kj * sw;
      const long long t = ((long long)(ki * tw + kj) * B + b) * C + c;
      const float v = pb::to_f32(tiles[t * plane + (long long)ly * pw + lx]);
      acc = __fadd_rn(acc, __fmul_rn(v, win[ly * pw + lx]));
    }
  }
  const float o = __fmul_rn(acc, inv_wsum[(long long)Y * Wc + X]);
  out[((long long)bc * h + y) * w + x] =
      pb::from_f32<TO>(fminf(fmaxf(o, 0.f), 1.f));
}

template <typename TI, typename TO>
void launch(const void* tiles, const float* win, const float* inv_wsum,
            void* out, int B, int C, int th, int tw, int sh, int sw, int ph,
            int pw, int Wc, int pt, int pl, int h, int w, cudaStream_t s) {
  const int threads = 256;
  dim3 grid((w + threads - 1) / threads, h, B * C);
  blend_kernel<TI, TO><<<grid, threads, 0, s>>>(
      static_cast<const TI*>(tiles), win, inv_wsum, static_cast<TO*>(out), B,
      C, th, tw, sh, sw, ph, pw, Wc, pt, pl, h, w);
}

}  // namespace

// tiles: (th*tw*B, C, ph, pw) contiguous, tile-major then image;
// win: (ph, pw) f32; inv_wsum: (Hc, Wc) f32 over the padded canvas;
// out: (B, C, h, w) = canvas[pt:pt+h, pl:pl+w] of the blend.
extern "C" int pb_blend(const void* tiles, int in_dtype, const float* win,
                        const float* inv_wsum, void* out, int out_dtype,
                        int B, int C, int th, int tw, int sh, int sw, int ph,
                        int pw, int Wc, int pt, int pl, int h, int w,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using pb::bf16;
  if (in_dtype == pb::kBF16 && out_dtype == pb::kF32)
    launch<bf16, float>(tiles, win, inv_wsum, out, B, C, th, tw, sh, sw, ph,
                        pw, Wc, pt, pl, h, w, s);
  else if (in_dtype == pb::kBF16 && out_dtype == pb::kBF16)
    launch<bf16, bf16>(tiles, win, inv_wsum, out, B, C, th, tw, sh, sw, ph,
                       pw, Wc, pt, pl, h, w, s);
  else if (in_dtype == pb::kF32 && out_dtype == pb::kF32)
    launch<float, float>(tiles, win, inv_wsum, out, B, C, th, tw, sh, sw, ph,
                         pw, Wc, pt, pl, h, w, s);
  else if (in_dtype == pb::kF32 && out_dtype == pb::kBF16)
    launch<float, bf16>(tiles, win, inv_wsum, out, B, C, th, tw, sh, sw, ph,
                        pw, Wc, pt, pl, h, w, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
