// edge_pad_cast: even-crop + replicate edge-pad + dtype cast in one pass.
//
// Replaces polyblur_tpu/ops/pallas/pad_cast.py::_make_kernel /
// edge_pad_cast. The TPU kernel walks each plane in aligned stripes with
// double-buffered DMA windows because Mosaic DMA slices must be (8, 128)
// aligned; here each block writes a band of canvas rows of one plane.
//
// Bound on the H100: bytes (read the image once, write the canvas once;
// no arithmetic). Design: every thread stores whole 16-byte chunks of a
// canvas row (8 bf16 or 4 f32), aligned to their absolute address; a row
// whose start is not 16-byte aligned gets its few head and tail elements
// one by one. An interior chunk loads its source columns with 16-byte
// vector loads from the aligned blocks that cover them and shifts the
// values into place (the shift is a template case, uniform along a row),
// so a left pad that is no multiple of the vector width, or an odd source
// width, costs no narrow loads. A chunk wholly inside a replicated margin
// is one clamped element broadcast.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // canvas rows per block

// the 16-byte block at p, widened to f32
template <typename TI>
__device__ __forceinline__ void widen(const TI* p, float* f);

template <>
__device__ __forceinline__ void widen<float>(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

template <>
__device__ __forceinline__ void widen<pb::bf16>(const pb::bf16* p, float* f) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// v[e] = p[K + e], e < VO, p aligned to 16 bytes
template <typename TI, int VO, int K>
__device__ __forceinline__ void gather(const TI* p, float (&v)[VO]) {
  constexpr int VI = 16 / sizeof(TI);
  constexpr int NV = (K + VO + VI - 1) / VI;
  float f[NV * VI];
#pragma unroll
  for (int i = 0; i < NV; ++i) widen<TI>(p + i * VI, f + i * VI);
#pragma unroll
  for (int e = 0; e < VO; ++e) v[e] = f[K + e];
}

template <typename TI, int VO>
__device__ __forceinline__ void gather_any(const TI* p, int k,
                                           float (&v)[VO]) {
  switch (k) {
    case 0: gather<TI, VO, 0>(p, v); break;
    case 1: gather<TI, VO, 1>(p, v); break;
    case 2: gather<TI, VO, 2>(p, v); break;
    case 3: gather<TI, VO, 3>(p, v); break;
    case 4: gather<TI, VO, 4>(p, v); break;
    case 5: gather<TI, VO, 5>(p, v); break;
    case 6: gather<TI, VO, 6>(p, v); break;
    default: gather<TI, VO, 7>(p, v); break;
  }
}

template <typename TO, int VO>
__device__ __forceinline__ void store16(TO* d, const float (&v)[VO]) {
  uint4 w;
  if constexpr (VO == 8) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&b);
    }
    w = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    w = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                   __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  *reinterpret_cast<uint4*>(d) = w;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
edge_pad_cast_kernel(const TI* __restrict__ x, TO* __restrict__ out,
                     int H_in, int W_in, int h, int w, int pt, int pl,
                     int Hp, int Wp, int bands) {
  constexpr int VO = 16 / sizeof(TO);
  constexpr int VI = 16 / sizeof(TI);
  const int plane = blockIdx.x / bands;
  const int Y0 = (blockIdx.x - plane * bands) * kRows;
  const int tid = threadIdx.x;
  for (int Y = Y0; Y < min(Y0 + kRows, Hp); ++Y) {
    const int sy = min(max(Y - pt, 0), h - 1);
    const long long si = (static_cast<long long>(plane) * H_in + sy) * W_in;
    const TI* src = x + si;
    const long long oi = (static_cast<long long>(plane) * Hp + Y) * Wp;
    TO* dst = out + oi;
    const int head = min(static_cast<int>((VO - oi % VO) % VO), Wp);
    const int nch = (Wp - head) / VO;
    const int tail = head + nch * VO;
    for (int c = tid; c < nch; c += kThreads) {
      const int X0 = head + c * VO;
      const int s0 = X0 - pl;
      float v[VO];
      if (s0 >= 0 && s0 + VO <= w) {
        const int k = static_cast<int>(
            (reinterpret_cast<uintptr_t>(src + s0) / sizeof(TI)) % VI);
        gather_any<TI, VO>(src + s0 - k, k, v);
      } else if (s0 + VO <= 0 || s0 >= w) {
        const float e = pb::to_f32(src[s0 < 0 ? 0 : w - 1]);
#pragma unroll
        for (int i = 0; i < VO; ++i) v[i] = e;
      } else {
#pragma unroll
        for (int i = 0; i < VO; ++i)
          v[i] = pb::to_f32(src[min(max(s0 + i, 0), w - 1)]);
      }
      store16<TO, VO>(dst + X0, v);
    }
    const int rest = head + (Wp - tail);
    if (tid < rest) {
      const int X = tid < head ? tid : tail + (tid - head);
      dst[X] = pb::from_f32<TO>(pb::to_f32(src[min(max(X - pl, 0), w - 1)]));
    }
  }
}

template <typename TI, typename TO>
void launch(const void* x, void* out, int planes, int H_in, int W_in, int h,
            int w, int pt, int pl, int Hp, int Wp, cudaStream_t s) {
  const int bands = (Hp + kRows - 1) / kRows;
  edge_pad_cast_kernel<TI, TO><<<planes * bands, kThreads, 0, s>>>(
      static_cast<const TI*>(x), static_cast<TO*>(out), H_in, W_in, h, w, pt,
      pl, Hp, Wp, bands);
}

}  // namespace

// x: (planes, H_in, W_in) contiguous; out: (planes, Hp, Wp) contiguous and
// 16-byte aligned. Rows/cols at and beyond (h, w) of x are never read
// (the even-crop).
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
