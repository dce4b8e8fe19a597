// One-pass error-feedback int8 encode of a sync payload leaf. Per block of
// 256 elements of one worker's row:
//
//     v     = x + e                                  (fp32)
//     scale = max|v| * f32(1/127)
//     q     = clip(rint(v * (1/scale)), -127, 127)   (0 where scale == 0)
//     v^    = max(q * scale, lower)                  lower: 0 for B^2, -FLT_MAX otherwise
//     wire  = v^ in x's dtype                        (bf16 rounds to nearest even)
//     e'    = v - wire
//
// Replaces the TPU kernel src/repro/kernels/sync_fused.py:fused_ef_blocks
// (body _fused_kernel), reached through fused_ef_leaf and the int8 codec's
// ef_roundtrip.
//
// Bound on the H100: device-memory bytes. Per element it reads x (payload
// dtype) and e (fp32) and writes wire and e': 12 bytes for a bf16 payload,
// 16 for fp32. The int8 codes and the scales never leave registers.
//
// Design: one warp per quantization block, 8 elements per lane. Lane l holds
// elements l, l+32, ..., l+224 of its block, so each of the eight loads and
// stores of a warp covers 32 consecutive elements: coalesced for any leaf
// size and any worker-row offset (head_b's rows of 793,471 elements start at
// odd offsets, which rules out vector loads without a second code path).
// max|v| is reduced across the warp with __shfl_xor_sync. The kernel takes the
// leaf's (lead, body) geometry and treats elements past the end of a worker's
// row as zeros, exactly the zero padding of the TPU wrapper, so blocks never
// straddle workers and nothing is copied. The new residual is written over e
// in place: each element is read before it is written by the same lane, and
// at full Big LSTM width this saves about 13 GB of device memory per round.
//
// Numerics, held bitwise against the plain version and the JAX reference:
// XLA compiles max|v|/127 as a multiplication by f32(1/127), so the kernel
// does too; 1/scale is an IEEE division; rintf rounds half to even like
// jnp.round; q passes through an integer like the int8 cast, so -0 becomes
// +0; every product and sum is a round-to-nearest intrinsic and the file is
// built with -fmad=false, so v - q*scale is never contracted into an FMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

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

template <typename T, bool kClampNonneg>
__global__ void fused_ef_kernel(const T* __restrict__ x, float* e, T* __restrict__ wire,
                                int64_t lead, int64_t body, int64_t blocks_per_row,
                                float inv127) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t total = lead * blocks_per_row;
  const float lower = kClampNonneg ? 0.0f : -FLT_MAX;
  for (int64_t b = warp; b < total; b += n_warps) {  // warp-uniform loop
    const int64_t row = b / blocks_per_row;
    const int64_t col0 = (b - row * blocks_per_row) * kBlock;
    const int64_t base = row * body;
    float v[kPerLane];
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t c = col0 + j * 32 + lane;
      v[j] = 0.0f;
      if (c < body) v[j] = __fadd_rn(to_f32(x[base + c]), e[base + c]);
      amax = fmaxf(amax, fabsf(v[j]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    }
    const float scale = __fmul_rn(amax, inv127);
    const float inv = scale > 0.0f ? __fdiv_rn(1.0f, scale) : 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t c = col0 + j * 32 + lane;
      if (c < body) {
        const float q = fminf(fmaxf(rintf(__fmul_rn(v[j], inv)), -127.0f), 127.0f);
        const float vhat = fmaxf(__fmul_rn(static_cast<float>(static_cast<int>(q)), scale), lower);
        const T w = from_f32<T>(vhat);
        wire[base + c] = w;
        e[base + c] = __fsub_rn(v[j], to_f32(w));
      }
    }
  }
}

template <typename T, bool kClampNonneg>
void launch(const void* x, void* e, void* wire, int64_t lead, int64_t body, float inv127,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int kWarps = kThreads / 32;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t blocks_per_row = (body + kBlock - 1) / kBlock;
  const int64_t want = (lead * blocks_per_row + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  const int grid = static_cast<int>(want < cap ? want : cap);
  fused_ef_kernel<T, kClampNonneg><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(e), static_cast<T*>(wire), lead, body,
      blocks_per_row, inv127);
}

}  // namespace

// x: (lead, body) payload in `dtype` (0 = float32, 1 = bfloat16); e: the fp32
// residual of the same geometry, overwritten with the new residual; wire: the
// output in x's dtype. inv127 is f32(1/127). Returns the CUDA error code of
// the launch (0 on success).
extern "C" int fused_ef(const void* x, void* e, void* wire, long long lead, long long body,
                        int dtype, int clamp_nonneg, float inv127, void* stream) {
  if (lead <= 0 || body <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && clamp_nonneg) {
    launch<float, true>(x, e, wire, lead, body, inv127, s);
  } else if (dtype == 0) {
    launch<float, false>(x, e, wire, lead, body, inv127, s);
  } else if (dtype == 1 && clamp_nonneg) {
    launch<__nv_bfloat16, true>(x, e, wire, lead, body, inv127, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, false>(x, e, wire, lead, body, inv127, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
