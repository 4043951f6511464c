// Shared helpers of the polyblur_torch CUDA kernels (sm_90a).
//
// Every kernel library exposes a plain C interface loaded with ctypes:
// pointers arrive as void*, the stream as a void* (cudaStream_t), and each
// entry returns cudaGetLastError() right after its launch so a refused
// launch surfaces in the Python wrapper instead of being lost.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace pb {

// dtype codes shared with the Python wrappers (ops/cuda/_build.py)
enum DType { kF32 = 0, kBF16 = 1 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round-to-nearest-even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float negate(float v) { return -v; }
__device__ __forceinline__ bf16 negate(bf16 v) {
  return __ushort_as_bfloat16(__bfloat16_as_ushort(v) ^ 0x8000u);
}

// Tile n of a (B, C, H, W) canvas on a regular tile grid, or of a
// (N, C, ph, pw) tile batch (batch = N, tiles_w = 1, steps 0).
// Tile n is grid tile tile0 + n / batch of image n % batch; grid tile t
// sits at ((t / tiles_w) * step_h, (t % tiles_w) * step_w).
struct TileView {
  const void* ptr;
  long long sB, sC, sR;  // element strides of image, channel, row
  int batch, tile0, tiles_w, step_h, step_w;

  __device__ __forceinline__ long long offset(int n, int c, int y, int x) const {
    const int q = n / batch;
    const int b = n - q * batch;
    const int t = tile0 + q;
    const int ti = t / tiles_w;
    const int tj = t - ti * tiles_w;
    return (long long)b * sB + (long long)c * sC +
           (long long)(ti * step_h + y) * sR + (long long)(tj * step_w + x);
  }
};

inline TileView make_view(const void* ptr, long long sB, long long sC,
                          long long sR, int batch, int tile0, int tiles_w,
                          int step_h, int step_w) {
  TileView v;
  v.ptr = ptr;
  v.sB = sB;
  v.sC = sC;
  v.sR = sR;
  v.batch = batch;
  v.tile0 = tile0;
  v.tiles_w = tiles_w;
  v.step_h = step_h;
  v.step_w = step_w;
  return v;
}

}  // namespace pb

extern "C" const char* pb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
