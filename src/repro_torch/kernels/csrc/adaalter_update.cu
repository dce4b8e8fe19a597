// Fused (Local) AdaAlter parameter update, one pass over a parameter leaf:
//
//     y         = x - (eta * g) * rsqrt(b2_sync + t'*eps^2)   (fp32, stored in x's dtype)
//     b2_local' = b2_local + g * g                              (fp32)
//
// Replaces the TPU kernel src/repro/kernels/adaalter_update.py:fused_update_2d
// (body _kernel), reached through fused_update and ops.tree_fused_update.
//
// Bound on the H100: device-memory bytes. Per element it reads x and g in the
// parameter dtype and b2_sync, b2_local in fp32, and writes y and b2_local':
// 18 bytes at bf16, 24 at fp32, for five flops -- far below the card's
// balance point, so the only cost that matters is moving each byte once.
//
// Design: a grid-stride elementwise loop. Consecutive threads touch
// consecutive elements, so every load and store is coalesced without any
// alignment assumption; the ragged tail is masked by the loop bound, so a
// leaf is never padded (the TPU wrapper's padding to a 512x128 tile is a TPU
// layout artefact). One launch covers a whole stacked leaf, all workers.
// eta and t'*eps^2 come from a 2-float device buffer, the counterpart of the
// TPU kernel's SMEM scalars, so the host never waits on the device.
// Products and sums are written as round-to-nearest intrinsics (and the file
// is built with -fmad=false): b2_local + g*g must not contract into an FMA,
// because the plain version rounds the product first and b2_local' is held
// bitwise. rsqrtf is approximate, as is the plain version's torch.rsqrt; y is
// held to rtol 1e-6 (fp32) / 8e-3 (bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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
    const float denom = rsqrtf(__fadd_rn(b2_sync[i], extra));
    const float upd = __fmul_rn(__fmul_rn(eta, gi), denom);
    y[i] = from_f32<T>(__fsub_rn(to_f32(x[i]), upd));
    b2_out[i] = __fadd_rn(b2_local[i], __fmul_rn(gi, gi));
  }
}

template <typename T>
void launch(const void* x, const void* g, const void* b2_sync, const void* b2_local,
            const void* scalars, void* y, void* b2_out, int64_t n, cudaStream_t stream) {
  constexpr int kThreads = 256;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  adaalter_update_kernel<T><<<blocks, kThreads, 0, stream>>>(
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
