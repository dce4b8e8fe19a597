// One-pass error-feedback int8 encode of a sync payload. Per block of 256
// elements of one worker's row:
//
//     v     = x + e                                  (fp32)
//     scale = max|v| * f32(1/127)
//     q     = clip(rint(v * (1/scale)), -127, 127)   (0 where scale == 0)
//     v^    = max(q * scale, lower)
//     wire  = v^ in the wire's dtype                 (bf16 rounds to nearest even)
//     e'    = v - wire
//
// Two kernels:
//   fused_ef  one payload leaf; lower 0 for B^2, -FLT_MAX otherwise; the wire
//             in x's dtype. Replaces the TPU kernel
//             src/repro/kernels/sync_fused.py:fused_ef_blocks (body
//             _fused_kernel), reached through fused_ef_leaf and the int8
//             codec's ef_roundtrip.
//   flat_ef   a whole fp32 flat plane (R, P), P a multiple of 256: `lower`
//             and the bf16 wire rounding come per block from two fp32
//             sidecars of one plane row (low, and rnd > 0), in place of the
//             static variants; the wire is fp32. Replaces
//             src/repro/kernels/sync_fused.py:flat_ef_blocks (body
//             _flat_ef_kernel), reached through flat_ef_plane.
//
// Bound on the H100: device-memory bytes. Per element they read x and e and
// write wire and e': 12 bytes for a bf16 payload, 16 for fp32 (and for every
// flat plane). With `codes` and `scales` null the int8 codes and the scales
// never leave registers; a run with one worker a rank passes both, and each
// block's 256 codes (0 past the end of a row) and its scale are written
// beside the wire (1 + 4/256 bytes more per element): they are what the
// rank puts on the wire, and a peer's dequantize of them gives its v^.
//
// Design: one warp per quantization block, 8 elements per lane (numerics.cuh).
// Lane l holds elements l, l+32, ..., l+224 of its block, so each of the eight
// loads and stores of a warp covers 32 consecutive elements: coalesced for
// any leaf size and any worker-row offset (head_b's rows of 793,471 elements
// start at odd offsets, which rules out vector loads without a second code
// path). fused_ef takes the leaf's (lead, body) geometry and treats elements
// past the end of a worker's row as zeros, exactly the zero padding of the TPU
// wrapper, so blocks never straddle workers and nothing is copied. flat_ef
// needs no mask: a plane row is a whole number of blocks. Block b of a plane
// reads its sidecars at b % (blocks per row), so the sidecars of one plane
// row serve every worker. The new residual is written over e in place: each
// element is read before it is written by the same lane, and at full Big
// LSTM width this saves about 13 GB of device memory per round.
//
// Numerics, held bitwise against the plain versions and the JAX reference,
// are numerics.cuh's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "numerics.cuh"

namespace {

template <typename T, bool kClampNonneg>
__global__ void fused_ef_kernel(const T* __restrict__ x, float* e, T* __restrict__ wire,
                                int8_t* __restrict__ codes, float* __restrict__ scales,
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
    const float scale = block_scale(warp_max(amax), inv127);
    const float inv = block_inv(scale);
    if (scales != nullptr && lane == 0) scales[b] = scale;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t c = col0 + j * 32 + lane;
      const int q = quant_code(v[j], inv);
      if (codes != nullptr) codes[b * kBlock + j * 32 + lane] = static_cast<int8_t>(q);
      if (c < body) {
        const float vhat = fmaxf(dequant(q, scale), lower);
        const T w = from_f32<T>(vhat);
        wire[base + c] = w;
        e[base + c] = __fsub_rn(v[j], to_f32(w));
      }
    }
  }
}

__global__ void flat_ef_kernel(const float* __restrict__ x, float* e, float* __restrict__ wire,
                               int8_t* __restrict__ codes, float* __restrict__ scales,
                               const float* __restrict__ rnd, const float* __restrict__ low,
                               int64_t total, int64_t blocks_per_row, float inv127) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t b = warp; b < total; b += n_warps) {  // warp-uniform loop
    const int64_t base = b * kBlock;
    const int64_t side = b % blocks_per_row;
    const float lower = low[side];
    const bool r16 = rnd[side] > 0.0f;
    float v[kPerLane];
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t i = base + j * 32 + lane;
      v[j] = __fadd_rn(x[i], e[i]);
      amax = fmaxf(amax, fabsf(v[j]));
    }
    const float scale = block_scale(warp_max(amax), inv127);
    const float inv = block_inv(scale);
    if (scales != nullptr && lane == 0) scales[b] = scale;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t i = base + j * 32 + lane;
      const int q = quant_code(v[j], inv);
      if (codes != nullptr) codes[i] = static_cast<int8_t>(q);
      const float vhat = fmaxf(dequant(q, scale), lower);
      const float w = r16 ? round_bf16(vhat) : vhat;
      wire[i] = w;
      e[i] = __fsub_rn(v[j], w);
    }
  }
}

// one warp per block; as many warps as blocks, up to 16 thread blocks a SM
int grid_for(int64_t n_blocks) {
  constexpr int kWarps = 256 / 32;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n_blocks + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(want < cap ? want : cap);
}

template <typename T, bool kClampNonneg>
void launch(const void* x, void* e, void* wire, void* codes, void* scales, int64_t lead,
            int64_t body, float inv127, cudaStream_t stream) {
  const int64_t blocks_per_row = (body + kBlock - 1) / kBlock;
  fused_ef_kernel<T, kClampNonneg><<<grid_for(lead * blocks_per_row), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(e), static_cast<T*>(wire),
      static_cast<int8_t*>(codes), static_cast<float*>(scales), lead, body, blocks_per_row,
      inv127);
}

}  // namespace

// x: (lead, body) payload in `dtype` (0 = float32, 1 = bfloat16); e: the fp32
// residual of the same geometry, overwritten with the new residual; wire: the
// output in x's dtype; codes (int8, lead * ceil(body / 256) * 256) and scales
// (fp32, one a block), both null or both set: the wire's int8 form, each
// row's blocks zero-padded. inv127 is f32(1/127). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int fused_ef(const void* x, void* e, void* wire, void* codes, void* scales,
                        long long lead, long long body, int dtype, int clamp_nonneg,
                        float inv127, void* stream) {
  if (lead <= 0 || body <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && clamp_nonneg) {
    launch<float, true>(x, e, wire, codes, scales, lead, body, inv127, s);
  } else if (dtype == 0) {
    launch<float, false>(x, e, wire, codes, scales, lead, body, inv127, s);
  } else if (dtype == 1 && clamp_nonneg) {
    launch<__nv_bfloat16, true>(x, e, wire, codes, scales, lead, body, inv127, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, false>(x, e, wire, codes, scales, lead, body, inv127, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, e, wire: n_blocks contiguous fp32 blocks of 256 (a flat plane, all its
// worker rows); e is overwritten with the new residual. codes, scales: null,
// or the wire's int8 codes (n_blocks * 256) and fp32 scales (n_blocks). rnd,
// low: fp32 sidecars of `blocks_per_row` blocks (one plane row), which
// divides n_blocks. Returns the CUDA error code of the launch (0 on success).
extern "C" int flat_ef(const void* x, void* e, void* wire, void* codes, void* scales,
                       const void* rnd, const void* low, long long n_blocks,
                       long long blocks_per_row, float inv127, void* stream) {
  if (n_blocks <= 0) return 0;
  if (blocks_per_row <= 0 || n_blocks % blocks_per_row) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flat_ef_kernel<<<grid_for(n_blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(e), static_cast<float*>(wire),
      static_cast<int8_t*>(codes), static_cast<float*>(scales), static_cast<const float*>(rnd),
      static_cast<const float*>(low), n_blocks, blocks_per_row, inv127);
  return static_cast<int>(cudaGetLastError());
}
