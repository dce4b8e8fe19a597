// Fused (Local) AdaAlter parameter update, one pass over device memory:
//
//     y         = x - (eta * g) * rsqrt(b2_sync + t'*eps^2)   (fp32, stored in x's dtype)
//     b2_local' = b2_local + g * g                              (fp32)
//
// Two kernels, one expression (adaalter_y / adaalter_b2 below):
//   adaalter_update  one parameter leaf, x and g in fp32 or bf16. Replaces
//                    the TPU kernel src/repro/kernels/adaalter_update.py:
//                    fused_update_2d (body _kernel), reached through
//                    fused_update and ops.tree_fused_update.
//   flat_update      whole fp32 flat planes (R, P), P a multiple of 65,536;
//                    rows of 128 elements whose fp32 `rnd` flag is > 0 hold a
//                    bf16 leaf, and their y is rounded through bf16. Replaces
//                    src/repro/kernels/adaalter_update.py:flat_fused_update
//                    (body _flat_kernel).
// Because both kernels evaluate the same device functions, a flat plane and
// the per-leaf tensors get bitwise the same update on the card; rsqrtf is
// approximate, so two different spellings could differ in the last bit.
//
// Bound on the H100: device-memory bytes. Per element adaalter_update reads
// x and g in the parameter dtype and b2_sync, b2_local in fp32, and writes y
// and b2_local': 18 bytes at bf16, 24 at fp32; flat_update moves 24 bytes
// (every plane is fp32). Five flops an element are far below the card's
// balance point, so the only cost that matters is moving each byte once.
//
// Design: grid-stride elementwise loops. adaalter_update has consecutive
// threads on consecutive elements, so every access is coalesced without any
// alignment assumption, and masks the ragged tail by the loop bound: a leaf is
// never padded (the TPU wrapper's padding to a 512x128 tile is a TPU layout
// artefact). flat_update reads and writes float4s: a plane is a whole
// allocation and every slot starts at a multiple of 65,536 elements, so
// every row is 16-byte aligned (the wrapper checks). It reads a row's flag
// at (i / 128) % (rows per worker), so one plane row's sidecar serves all
// workers. It may write y over x and b2_local' over b2_local: each element is
// read before the same thread writes it. eta and t'*eps^2 come from a
// 2-float device buffer, the counterpart of the TPU kernel's SMEM scalars, so
// the host never waits on the device. Products and sums are written as
// round-to-nearest intrinsics (and the library is built with -fmad=false):
// b2_local + g*g must not contract into an FMA, because the plain versions
// round the product first and b2_local' is held bitwise. rsqrtf is
// approximate, as is the plain versions' torch.rsqrt; y is held to rtol 1e-6
// (fp32) / 8e-3 (bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "numerics.cuh"

namespace {

constexpr int kLanes = 128;  // elements per row of a flat plane's rnd sidecar

__device__ __forceinline__ float adaalter_y(float x, float g, float b2_sync, float eta,
                                            float extra) {
  const float denom = rsqrtf(__fadd_rn(b2_sync, extra));
  return __fsub_rn(x, __fmul_rn(__fmul_rn(eta, g), denom));
}

__device__ __forceinline__ float adaalter_b2(float b2_local, float g) {
  return __fadd_rn(b2_local, __fmul_rn(g, g));
}

template <typename T>
__global__ void adaalter_update_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                       const float* __restrict__ b2_sync,
                                       const float* __restrict__ b2_local,
                                       const float* __restrict__ scalars, T* __restrict__ y,
                                       float* __restrict__ b2_out, int64_t n) {
  const float eta = scalars[0];
  const float extra = scalars[1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = to_f32(g[i]);
    y[i] = from_f32<T>(adaalter_y(to_f32(x[i]), gi, b2_sync[i], eta, extra));
    b2_out[i] = adaalter_b2(b2_local[i], gi);
  }
}

__device__ __forceinline__ float flat_y(float x, float g, float bs, float eta, float extra,
                                        bool r16) {
  const float y = adaalter_y(x, g, bs, eta, extra);
  return r16 ? round_bf16(y) : y;
}

// x/y and b2_local/b2_out may alias: no __restrict__ on them
__global__ void flat_update_kernel(const float4* x, const float4* __restrict__ g,
                                   const float4* b2_sync, const float4* b2_local,
                                   const float* __restrict__ rnd,
                                   const float* __restrict__ scalars, float4* y,
                                   float4* b2_out, int64_t n4, int64_t rows_per_worker) {
  const float eta = scalars[0];
  const float extra = scalars[1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const bool r16 = rnd[(i / (kLanes / 4)) % rows_per_worker] > 0.0f;
    const float4 xv = x[i], gv = g[i], bs = b2_sync[i], bl = b2_local[i];
    float4 yv, bv;
    yv.x = flat_y(xv.x, gv.x, bs.x, eta, extra, r16);
    yv.y = flat_y(xv.y, gv.y, bs.y, eta, extra, r16);
    yv.z = flat_y(xv.z, gv.z, bs.z, eta, extra, r16);
    yv.w = flat_y(xv.w, gv.w, bs.w, eta, extra, r16);
    bv.x = adaalter_b2(bl.x, gv.x);
    bv.y = adaalter_b2(bl.y, gv.y);
    bv.z = adaalter_b2(bl.z, gv.z);
    bv.w = adaalter_b2(bl.w, gv.w);
    y[i] = yv;
    b2_out[i] = bv;
  }
}

int capped_grid(int64_t n, int threads) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(want < cap ? want : cap);
}

template <typename T>
void launch(const void* x, const void* g, const void* b2_sync, const void* b2_local,
            const void* scalars, void* y, void* b2_out, int64_t n, cudaStream_t stream) {
  adaalter_update_kernel<T><<<capped_grid(n, 256), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(b2_sync),
      static_cast<const float*>(b2_local), static_cast<const float*>(scalars),
      static_cast<T*>(y), static_cast<float*>(b2_out), n);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g and y share it). Returns the CUDA
// error code of the launch (0 on success).
extern "C" int adaalter_update(const void* x, const void* g, const void* b2_sync,
                               const void* b2_local, const void* scalars, void* y,
                               void* b2_out, long long n, int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, g, b2_sync, b2_local, scalars, y, b2_out, n, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, g, b2_sync, b2_local, scalars, y, b2_out, n, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Whole fp32 planes of n elements (all worker rows), 16-byte aligned, n a
// multiple of rows_per_worker * 128; rnd: rows_per_worker fp32 flags (one
// plane row). y may be x and b2_out may be b2_local. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int flat_update(const void* x, const void* g, const void* b2_sync,
                           const void* b2_local, const void* rnd, const void* scalars,
                           void* y, void* b2_out, long long n, long long rows_per_worker,
                           void* stream) {
  if (n <= 0) return 0;
  if (rows_per_worker <= 0 || n % (rows_per_worker * kLanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n4 = n / 4;
  flat_update_kernel<<<capped_grid(n4, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(g),
      static_cast<const float4*>(b2_sync), static_cast<const float4*>(b2_local),
      static_cast<const float*>(rnd), static_cast<const float*>(scalars),
      static_cast<float4*>(y), static_cast<float4*>(b2_out), n4, rows_per_worker);
  return static_cast<int>(cudaGetLastError());
}
