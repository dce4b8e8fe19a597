// Per-block int8 quantize / dequantize of a (nblocks, 256) view, the kernel
// pair of the three-pass sync encode (--unfused-sync) and of the int8 codec's
// separate encode and decode:
//
//     quantize    scale = max|v| * f32(1/127);  q = clip(rint(v / scale), ±127)
//                 -> q int8 (nblocks, 256), scales fp32 (nblocks, 1)
//     dequantize  x^ = q * scale  -> fp32 (nblocks, 256)
//
// Replace the TPU kernels src/repro/kernels/quantize.py:quantize_blocks
// (body _quant_kernel) and dequantize_blocks (body _dequant_kernel).
//
// Bound on the H100: device-memory bytes. Quantize reads 4 bytes (fp32; 2 for
// bf16) and writes 1 + 4/256 per element; dequantize reads 1 + 4/256 and
// writes 4: about 5.02 bytes an element each.
//
// Design: quantize runs one warp per block with numerics.cuh's arithmetic, the
// same as the one-pass EF kernels', so the three-pass and one-pass encodes
// agree bitwise; lane l holds elements l, l+32, ... of its block, so loads and
// the int8 stores are coalesced, and lane 0 writes the block's scale.
// Dequantize is a grid-stride elementwise loop; element i reads the scale of
// block i / 256, which the 256 neighbouring threads share through the cache.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "numerics.cuh"

namespace {

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                float* __restrict__ scales, int64_t n_blocks, float inv127) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t b = warp; b < n_blocks; b += n_warps) {  // warp-uniform loop
    const int64_t base = b * kBlock;
    float v[kPerLane];
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      v[j] = to_f32(x[base + j * 32 + lane]);
      amax = fmaxf(amax, fabsf(v[j]));
    }
    const float scale = block_scale(warp_max(amax), inv127);
    const float inv = block_inv(scale);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      q[base + j * 32 + lane] = static_cast<int8_t>(quant_code(v[j], inv));
    }
    if (lane == 0) scales[b] = scale;
  }
}

__global__ void dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                                  float* __restrict__ y, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = dequant(q[i], scales[i / kBlock]);
  }
}

int capped_grid(int64_t want) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(want < cap ? want : cap);
}

}  // namespace

// x: n_blocks contiguous blocks of 256 in `dtype` (0 = float32, 1 = bfloat16);
// q: int8 of the same geometry; scales: n_blocks fp32. inv127 is f32(1/127).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int quantize_blocks(const void* x, void* q, void* scales, long long n_blocks,
                               int dtype, float inv127, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = capped_grid((n_blocks + 7) / 8);  // 8 warps a thread block
  if (dtype == 0) {
    quantize_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                                 static_cast<int8_t*>(q),
                                                 static_cast<float*>(scales), n_blocks, inv127);
  } else if (dtype == 1) {
    quantize_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n_blocks, inv127);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: n_blocks contiguous int8 blocks of 256; scales: n_blocks fp32; y: fp32
// of q's geometry. Returns the CUDA error code of the launch (0 on success).
extern "C" int dequantize_blocks(const void* q, const void* scales, void* y,
                                 long long n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  const int64_t n = static_cast<int64_t>(n_blocks) * kBlock;
  dequantize_kernel<<<capped_grid((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
