// Mamba-2 SSD chunk scan, forward (the state-space-duality form of
// arXiv:2405.21060). For each (batch, head), chunks in order, with an fp32
// state S (N, hd) carried from one chunk to the next:
//
//     cum  = cumsum(dA over the chunk)
//     y    = tril(C·Bᵀ ⊙ exp(cum_i − cum_j))·x̄ + exp(cum)·(C·S)
//     S   <- exp(cum_last)·S + Bᵀ·(exp(cum_last − cum)·x̄)
//
// x̄ (B, NZ, c, NH, hd), B and C (B, NZ, c, N) in fp32 or bf16, dA (B, NZ, c,
// NH) fp32, y (B, NZ, c, NH, hd) fp32, without the D-skip term (the caller
// adds it). Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan
// (body _kernel).
//
// Bound on the H100: operations. At the mamba2-370m scoring shape x̄ and y
// are 134 MB each and B, C, dA 19 MB together, 0.086 ms at 3.35 TB/s, while
// the least work (C·Bᵀ once per (batch, chunk), lower triangles only, C·S and
// the state update per head) is about 19.5 GFLOP: 0.29 ms at the 67 TFLOP/s
// of fp32 outside the tensor cores. TF32 would not hold the 1e-4 tolerance of
// the reference, so the sums are fp32 FMAs on the CUDA cores.
//
// Design, right and simple first: one thread block of 256 threads per
// (batch, head). The TPU's sequential chunk axis becomes a loop inside the
// block, and S lives in shared memory across it (32 KB at N=128, hd=64). Each
// chunk stages x̄ (c × hd), B and C (c × N, rows padded to N+1 floats so that
// threads reading different rows hit different banks) and cum in shared
// memory, converted to fp32, then runs three phases separated by barriers:
// M = tril(C·Bᵀ ⊙ decay) (c × c), y (c × hd, written straight to device
// memory) and the state update (N × hd). The inputs are read in place through
// their strides (the TPU wrapper's head-major transposes are tiling, not part
// of the function). The upper triangle is masked by selection, never by a
// product: exp(cum_i − cum_j) can be inf there. expf is the IEEE-accurate
// exponential. The library is built with -fmad=false, so the dot products
// spell their FMAs with __fmaf_rn. What this leaves for a faster version: C·Bᵀ
// is recomputed for every head (+22% operations), every FMA reads shared
// memory, and a 32k-token sequence at batch 1 fills only NH blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "numerics.cuh"

namespace {

constexpr int kSsdThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kMaxState = 128;
constexpr int kMaxHeadDim = 64;

struct SsdStrides {       // element strides of the inputs
  long long x[5];         // x̄ (B, NZ, c, NH, hd)
  long long b[4];         // B (B, NZ, c, N)
  long long c[4];         // C (B, NZ, c, N)
  long long da[4];        // dA (B, NZ, c, NH)
};

size_t ssd_smem_bytes(int c, int n, int hd) {
  const size_t floats = static_cast<size_t>(n) * hd + static_cast<size_t>(c) * hd +
                        2 * static_cast<size_t>(c) * (n + 1) + static_cast<size_t>(c) * c + 3 * c;
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ da, float* __restrict__ y, const SsdStrides st,
                    int nz, int c, int nh, int hd, int n) {
  extern __shared__ float smem[];
  const int ldn = n + 1;
  float* S = smem;           // (n, hd), carried across chunks
  float* xs = S + n * hd;    // (c, hd)
  float* Bs = xs + c * hd;   // (c, ldn); scaled by seg after the M phase
  float* Cs = Bs + c * ldn;  // (c, ldn)
  float* M = Cs + c * ldn;   // (c, c)
  float* cum = M + c * c;    // (c)
  float* ecum = cum + c;     // exp(cum)
  float* seg = ecum + c;     // exp(cum_last − cum)

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  for (int i = tid; i < n * hd; i += kSsdThreads) S[i] = 0.0f;

  for (int z = 0; z < nz; ++z) {
    // ---- stage the chunk in shared memory, as fp32 ------------------------
    const T* xz = x + bi * st.x[0] + z * st.x[1] + h * st.x[3];
    for (int i = tid; i < c * hd; i += kSsdThreads) {
      const int l = i / hd, p = i % hd;
      xs[i] = to_f32(xz[l * st.x[2] + p * st.x[4]]);
    }
    const T* bz = bm + bi * st.b[0] + z * st.b[1];
    const T* cz = cm + bi * st.c[0] + z * st.c[1];
    for (int i = tid; i < c * n; i += kSsdThreads) {
      const int l = i / n, k = i % n;
      Bs[l * ldn + k] = to_f32(bz[l * st.b[2] + k * st.b[3]]);
      Cs[l * ldn + k] = to_f32(cz[l * st.c[2] + k * st.c[3]]);
    }
    const float* dz = da + bi * st.da[0] + z * st.da[1] + h * st.da[3];
    for (int l = tid; l < c; l += kSsdThreads) cum[l] = dz[l * st.da[2]];
    __syncthreads();
    if (tid == 0) {  // the chunk's cumulative sum, in order
      float acc = 0.0f;
      for (int l = 0; l < c; ++l) {
        acc = __fadd_rn(acc, cum[l]);
        cum[l] = acc;
      }
    }
    __syncthreads();

    // ---- M = tril(C·Bᵀ ⊙ exp(cum_l − cum_s)) ------------------------------
    const float last = cum[c - 1];
    for (int l = tid; l < c; l += kSsdThreads) {
      ecum[l] = expf(cum[l]);
      seg[l] = expf(__fsub_rn(last, cum[l]));
    }
    for (int i = tid; i < c * c; i += kSsdThreads) {
      const int l = i / c, s = i % c;
      float v = 0.0f;
      if (s <= l) {  // selection, not a product: the upper triangle may be inf
        float dot = 0.0f;
        for (int k = 0; k < n; ++k) dot = __fmaf_rn(Cs[l * ldn + k], Bs[s * ldn + k], dot);
        v = __fmul_rn(dot, expf(__fsub_rn(cum[l], cum[s])));
      }
      M[i] = v;
    }
    __syncthreads();

    // ---- y = M·x̄ + exp(cum)·(C·S); then B <- seg ⊙ B for the update -------
    float* yz = y + (static_cast<long long>(bi) * nz + z) * c * nh * hd + h * hd;
    for (int i = tid; i < c * hd; i += kSsdThreads) {
      const int l = i / hd, p = i % hd;
      float intra = 0.0f;
      for (int s = 0; s <= l; ++s) intra = __fmaf_rn(M[l * c + s], xs[s * hd + p], intra);
      float inter = 0.0f;
      for (int k = 0; k < n; ++k) inter = __fmaf_rn(Cs[l * ldn + k], S[k * hd + p], inter);
      yz[static_cast<long long>(l) * nh * hd + p] = __fadd_rn(intra, __fmul_rn(ecum[l], inter));
    }
    for (int i = tid; i < c * n; i += kSsdThreads) {  // M phase done: B is free
      const int l = i / n, k = i % n;
      Bs[l * ldn + k] = __fmul_rn(Bs[l * ldn + k], seg[l]);
    }
    __syncthreads();

    // ---- S <- exp(cum_last)·S + (seg ⊙ B)ᵀ·x̄ -------------------------------
    const float decay = ecum[c - 1];
    for (int i = tid; i < n * hd; i += kSsdThreads) {
      const int k = i / hd, p = i % hd;
      float acc = 0.0f;
      for (int s = 0; s < c; ++s) acc = __fmaf_rn(Bs[s * ldn + k], xs[s * hd + p], acc);
      S[i] = __fadd_rn(__fmul_rn(decay, S[i]), acc);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_ssd(const void* x, const void* bm, const void* cm, const float* da, float* y,
               const SsdStrides& st, long long batch, int nz, int c, int nh, int hd, int n,
               cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes(c, n, hd);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = batch * nh;
  ssd_scan_kernel<T><<<static_cast<unsigned>(blocks), kSsdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm), da, y, st,
      nz, c, nh, hd, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block, in bytes, for chunk c, state n and head
// dimension hd.
extern "C" long long ssd_scan_smem_bytes(int c, int n, int hd) {
  return static_cast<long long>(ssd_smem_bytes(c, n, hd));
}

// x̄, B, C in `dtype` (0 = float32, 1 = bfloat16), dA float32, each read
// through its element strides: strides[0:5] x̄, [5:9] B, [9:13] C, [13:17] dA.
// y: contiguous float32 (batch, nz, c, nh, hd). c <= 64, n <= 128, hd <= 64.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ssd_scan(const void* x, const void* bm, const void* cm, const void* da, void* y,
                        const long long* strides, int dtype, long long batch, int nz, int c,
                        int nh, int hd, int n, void* stream) {
  if (c < 1 || c > kMaxChunk || n < 1 || n > kMaxState || hd < 1 || hd > kMaxHeadDim || nh < 1 ||
      batch * nh > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || nz <= 0) return 0;
  SsdStrides st;
  for (int i = 0; i < 5; ++i) st.x[i] = strides[i];
  for (int i = 0; i < 4; ++i) {
    st.b[i] = strides[5 + i];
    st.c[i] = strides[9 + i];
    st.da[i] = strides[13 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dap = static_cast<const float*>(da);
  float* yp = static_cast<float*>(y);
  if (dtype == 0) return launch_ssd<float>(x, bm, cm, dap, yp, st, batch, nz, c, nh, hd, n, s);
  if (dtype == 1) {
    return launch_ssd<__nv_bfloat16>(x, bm, cm, dap, yp, st, batch, nz, c, nh, hd, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
