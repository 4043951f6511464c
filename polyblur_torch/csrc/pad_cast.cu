// edge_pad_cast: even-crop + replicate edge-pad + dtype cast in one pass.
//
// Replaces polyblur_tpu/ops/pallas/pad_cast.py::_make_kernel /
// edge_pad_cast. The TPU kernel walks each plane in aligned stripes with
// double-buffered DMA windows because Mosaic DMA slices must be (8, 128)
// aligned; here one thread writes one canvas element from a clamped source
// index, so no alignment gate and no extra DMA-window columns exist.
//
// Bound on the H100: bytes (read the image once, write the canvas once;
// no arithmetic). Design: consecutive threads write consecutive canvas
// columns (coalesced stores); the reads of a row are coalesced except at
// the replicated margins, which hit the same cached source element.
#include "common.cuh"

namespace {

template <typename TI, typename TO>
__global__ void edge_pad_cast_kernel(const TI* __restrict__ x,
                                     TO* __restrict__ out, int H_in,
                                     int W_in, int h, int w, int pt, int pl,
                                     int Hp, int Wp) {
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  const int Y = blockIdx.y;
  const long long plane = blockIdx.z;
  if (X >= Wp) return;
  const int sy = min(max(Y - pt, 0), h - 1);
  const int sx = min(max(X - pl, 0), w - 1);
  out[(plane * Hp + Y) * Wp + X] =
      pb::from_f32<TO>(pb::to_f32(x[(plane * H_in + sy) * W_in + sx]));
}

template <typename TI, typename TO>
void launch(const void* x, void* out, int planes, int H_in, int W_in, int h,
            int w, int pt, int pl, int Hp, int Wp, cudaStream_t s) {
  const int threads = 256;
  dim3 grid((Wp + threads - 1) / threads, Hp, planes);
  edge_pad_cast_kernel<TI, TO><<<grid, threads, 0, s>>>(
      static_cast<const TI*>(x), static_cast<TO*>(out), H_in, W_in, h, w, pt,
      pl, Hp, Wp);
}

}  // namespace

// x: (planes, H_in, W_in) contiguous; out: (planes, Hp, Wp) contiguous.
// Rows/cols at and beyond (h, w) of x are never read (the even-crop).
extern "C" int pb_edge_pad_cast(const void* x, int in_dtype, void* out,
                                int out_dtype, int planes, int H_in,
                                int W_in, int h, int w, int pt, int pl,
                                int Hp, int Wp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using pb::bf16;
  if (in_dtype == pb::kF32 && out_dtype == pb::kBF16)
    launch<float, bf16>(x, out, planes, H_in, W_in, h, w, pt, pl, Hp, Wp, s);
  else if (in_dtype == pb::kF32 && out_dtype == pb::kF32)
    launch<float, float>(x, out, planes, H_in, W_in, h, w, pt, pl, Hp, Wp, s);
  else if (in_dtype == pb::kBF16 && out_dtype == pb::kBF16)
    launch<bf16, bf16>(x, out, planes, H_in, W_in, h, w, pt, pl, Hp, Wp, s);
  else if (in_dtype == pb::kBF16 && out_dtype == pb::kF32)
    launch<bf16, float>(x, out, planes, H_in, W_in, h, w, pt, pl, Hp, Wp, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
