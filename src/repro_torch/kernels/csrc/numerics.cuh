// Device arithmetic shared by the kernels: conversions between the payload
// dtypes and float32, the rounding of float32 through bfloat16, and (for
// sync_fused.cu and quantize.cu) the symmetric
// per-block int8 quantization of the JAX package's
// src/repro/kernels/quantize.py:block_quantize, as XLA compiles it:
//
//     scale = max|v| * f32(1/127)                     (a division by a constant
//                                                      becomes a reciprocal multiply)
//     q     = clip(rint(v * (1/scale)), -127, 127)    (0 where scale == 0)
//     v^    = q * scale
//
// 1/scale is an IEEE division; rintf rounds half to even like jnp.round; q
// passes through an integer like the int8 cast, so -0 comes out as +0. Every
// product is a round-to-nearest intrinsic and the library is built with
// -fmad=false, so nothing is contracted into an FMA. One warp quantizes one
// block of 256 elements, 8 a lane; the kernels hold lane l's elements at
// l, l+32, ..., l+224 of the block, so every warp load is coalesced.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kPerLane = kBlock / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// float32 -> the nearest bfloat16 (half to even) -> float32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the block's max|v| from each lane's partial max
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float block_scale(float amax, float inv127) {
  return __fmul_rn(amax, inv127);
}

__device__ __forceinline__ float block_inv(float scale) {
  return scale > 0.0f ? __fdiv_rn(1.0f, scale) : 0.0f;
}

__device__ __forceinline__ int quant_code(float v, float inv) {
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f));
}

__device__ __forceinline__ float dequant(int q, float scale) {
  return __fmul_rn(static_cast<float>(q), scale);
}

}  // namespace
