// Mamba-2 SSD chunk scan, forward (the state-space-duality form of
// arXiv:2405.21060), as three chunk-parallel launches:
//
//   1. ssd_chunk_states  one block per (batch, chunk, group of kGroup heads):
//        cum   = cumsum(dA over the chunk), in order
//        states[b, z, h] = (seg ⊙ B)ᵀ·x̄_h with seg = exp(cum_last − cum)
//        decay[b, z, h]  = exp(cum_last)
//   2. ssd_state_pass    one thread per (batch, head, n, p): walks the chunks
//        in order and overwrites states[z] with the state entering chunk z,
//        S <- S·decay[z] + states[z] from S = 0 (the plain version's order)
//   3. ssd_chunk_output  one block per (batch, chunk, group of kGroup heads):
//        CB = C·Bᵀ once for the group, then per head
//        y  = tril(CB ⊙ exp(cum_i − cum_j))·x̄_h + exp(cum) ⊙ (C·states[b, z, h])
//
// x̄ (B, NZ, c, NH, hd), B and C (B, NZ, c, N) in fp32 or bf16, dA (B, NZ, c,
// NH) fp32, read in place through their strides; y (B, NZ, c, NH, hd) fp32,
// without the D-skip term (the caller adds it). The caller allocates states
// (B, NZ, NH, N, hd) and decay (B, NZ, NH), fp32. Replaces the TPU kernel
// src/repro/kernels/ssd_scan.py:ssd_scan (body _kernel), whose sequential
// chunk axis carried S in VMEM.
//
// Bound on the H100: operations. At the mamba2-370m scoring shape x̄ and y
// are 134 MB each and B, C, dA 19 MB together, 0.086 ms at 3.35 TB/s, while
// the least work (C·Bᵀ once per (batch, chunk), lower triangles only, C·S and
// the state update per head) is about 19.5 GFLOP. One TF32 pass would miss
// the plain version's 1e-4 by an order of magnitude, so the four products run
// on the tensor cores as 3xTF32 (mma_tf32.cuh): three products each, 58.5
// GFLOP at the dense TF32 rate of 495 TFLOP/s, 0.118 ms.
//
// Design. Nothing crosses chunks inside a block: the recurrence is launch 2,
// elementwise and coalesced, so every chunk of every sequence runs in
// parallel and a 32k-token sequence at batch 1 fills the card (2,048 blocks
// of each chunk kernel). B (and C) are staged once per block and shared by
// its kGroup heads, and C·Bᵀ is computed once per (batch, chunk), not per
// head. Each product is warp tiles of mma.sync m16n8k8 over operands in
// shared memory, rows padded so that every fragment load of a warp hits 32
// distinct banks. A tile is staged with all of a thread's loads in flight
// at once (Tile), and the states kernel loads the next head's x̄ while it
// multiplies this one's. The output kernel holds C·Bᵀ in its accumulator
// registers across the group's heads, forms M there (the upper triangle
// masked by selection, never by a product: exp(cum_i − cum_j) can be inf
// there), accumulates exp(cum) ⊙ (C·S) and M·x̄ into one accumulator and
// writes y from registers straight to device memory; its 108.5 KB of shared
// memory fit two blocks on an SM. expf is the IEEE-accurate exponential.
// The library is built with -fmad=false, so the elementwise products and
// sums round as the plain version's do.
//
// What bounds it now, and what is left for a faster version: on the card it
// takes several times its bound (PERF.md). states makes a round trip through
// device memory, written, read and written by the pass, then read: 1.07 GB
// at the scoring shape, 0.32 ms at the HBM rate by itself, more than the
// inputs and y together. And each block waits for the next head's tiles
// between its products, as mma.sync from shared memory has no asynchronous
// feed; wgmma fed by TMA, and states kept out of device memory, are the
// next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"
#include "numerics.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kGroup = 8;      // heads per block of the chunk kernels
// the tiles: chunk, state and head sizes up to these, zero-padded in shared memory
constexpr int kC = 64, kN = 128, kP = 64;
// row pitches in floats: a row-major A operand wants a pitch of 4 mod 32, a
// transposed A operand and a row-major B operand 8 mod 32, and a transposed B
// operand 4 mod 32, so that a warp's fragment loads hit 32 distinct banks
constexpr int kLdRow = kN + 4;  // C and B rows, read as A (l, n) or as B (n, s)
constexpr int kLdBt = kN + 8;   // B rows in the states kernel, read as A (n, s)
constexpr int kLdP = kP + 8;    // x̄ and S rows, read as B (s, p) or (n, p)
constexpr int kLdM = kC + 4;    // M rows, read as A (l, s)
constexpr int kAhead = 8;       // chunks the state pass loads ahead

struct SsdStrides {  // element strides of the inputs
  long long x[5];    // x̄ (B, NZ, c, NH, hd)
  long long b[4];    // B (B, NZ, c, N)
  long long c[4];    // C (B, NZ, c, N)
  long long da[4];   // dA (B, NZ, c, NH)
};

constexpr size_t kStatesSmem = sizeof(float) * (kC * kLdBt + kC * kLdP + 2 * kGroup * kC);
constexpr int kUnion = kC * kLdRow > kN * kLdP ? kC * kLdRow : kN * kLdP;
constexpr size_t kOutputSmem =
    sizeof(float) * (kC * kLdRow + kUnion + kC * kLdM + kC * kLdP + kGroup * kC);

// Four consecutive elements as fp32 (bf16 widens exactly: its bits on top).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// A (ROWS × COLS) tile of a strided input, held in registers as fp32 from its
// loads to its stores into shared memory: every load of the thread is issued
// before the first store, so the block waits out one memory latency, not one
// per element, and a kernel can keep the next tile's loads in flight while it
// computes. Each thread holds 4 consecutive elements of a row per slot; rows
// that are contiguous and 4-element aligned load them with one instruction.
template <typename T, int ROWS, int COLS>
struct Tile {
  static_assert((ROWS * COLS) % (4 * kThreads) == 0 && COLS % 4 == 0, "tile");
  static constexpr int kSlots = ROWS * COLS / (4 * kThreads);
  float4 v[kSlots];

  // Zero beyond (valid_rows, valid_cols).
  __device__ __forceinline__ void load(const T* __restrict__ src, long long rs, long long cs,
                                       int valid_rows, int valid_cols) {
    const bool vec = cs == 1 && valid_cols == COLS && rs % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int i = 4 * (u * kThreads + threadIdx.x), r = i / COLS, k = i % COLS;
      if (r >= valid_rows) {
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (vec) {
        v[u] = load4(src + r * rs + k);
      } else {
        const T* p = src + r * rs;
        v[u] = make_float4(k < valid_cols ? to_f32(p[k * cs]) : 0.f,
                           k + 1 < valid_cols ? to_f32(p[(k + 1) * cs]) : 0.f,
                           k + 2 < valid_cols ? to_f32(p[(k + 2) * cs]) : 0.f,
                           k + 3 < valid_cols ? to_f32(p[(k + 3) * cs]) : 0.f);
      }
    }
  }

  // Into dst with pitch ld (a multiple of 4), each row times row_scale[r]
  // where one is given.
  __device__ __forceinline__ void store(float* __restrict__ dst, int ld,
                                        const float* __restrict__ row_scale = nullptr) const {
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int i = 4 * (u * kThreads + threadIdx.x), r = i / COLS;
      float4 w = v[u];
      if (row_scale) {
        const float f = row_scale[r];
        w = make_float4(__fmul_rn(w.x, f), __fmul_rn(w.y, f), __fmul_rn(w.z, f),
                        __fmul_rn(w.w, f));
      }
      *reinterpret_cast<float4*>(dst + r * ld + i % COLS) = w;
    }
  }
};

template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage(float* __restrict__ dst, int ld, const T* __restrict__ src,
                                      long long rs, long long cs, int valid_rows, int valid_cols) {
  Tile<T, ROWS, COLS> t;
  t.load(src, rs, cs, valid_rows, valid_cols);
  t.store(dst, ld);
}

// dA of the block's heads into cum (kGroup × kC), then each head's cumulative
// sum over the chunk, in order, one thread a head; rows past c repeat the
// last value, so that every exponent on a padded row or column is finite.
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* da, long long rs,
                                             long long hs, int c, int heads) {
  for (int i = threadIdx.x; i < kGroup * kC; i += kThreads) {
    const int j = i / kC, l = i % kC;
    if (j < heads && l < c) cum[i] = da[j * hs + l * rs];
  }
  __syncthreads();
  if (threadIdx.x < heads) {
    float* row = cum + threadIdx.x * kC;
    float acc = 0.0f;
    for (int l = 0; l < c; ++l) {
      acc = __fadd_rn(acc, row[l]);
      row[l] = acc;
    }
    for (int l = c; l < kC; ++l) row[l] = acc;
  }
  __syncthreads();
}

// ---- 1. each chunk's own state, and its decay ------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_states(const T* __restrict__ x, const T* __restrict__ bm, const float* __restrict__ da,
                     float* __restrict__ states, float* __restrict__ decay, const SsdStrides st,
                     int nz, int c, int nh, int hd, int n) {
  extern __shared__ float smem[];
  float* Bs = smem;                // (kC, kLdBt)
  float* xs = Bs + kC * kLdBt;     // (kC, kLdP): seg ⊙ x̄ of one head
  float* cum = xs + kC * kLdP;     // (kGroup, kC)
  float* seg = cum + kGroup * kC;  // (kGroup, kC): exp(cum_last − cum)

  const int bi = blockIdx.x / nz, z = blockIdx.x % nz;
  const int h0 = blockIdx.y * kGroup;
  const int heads = min(kGroup, nh - h0);
  stage<T, kC, kN>(Bs, kLdBt, bm + bi * st.b[0] + z * st.b[1], st.b[2], st.b[3], c, n);
  chunk_cumsum(cum, da + bi * st.da[0] + z * st.da[1] + h0 * st.da[3], st.da[2], st.da[3], c,
               heads);
  for (int i = threadIdx.x; i < heads * kC; i += kThreads) {
    seg[i] = expf(__fsub_rn(cum[(i / kC) * kC + kC - 1], cum[i]));
  }
  if (threadIdx.x < heads) {
    decay[(static_cast<long long>(bi) * nz + z) * nh + h0 + threadIdx.x] =
        expf(cum[threadIdx.x * kC + kC - 1]);
  }

  // warp tile of the (N × hd) state: rows 32·wm, columns 32·wn
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  const int kc = (c + 7) & ~7;
  const bool pairs = (hd & 1) == 0;
  const T* x0 = x + bi * st.x[0] + z * st.x[1] + h0 * st.x[3];
  Tile<T, kC, kP> xt;  // x̄ of the next head, in flight during this head's product
  xt.load(x0, st.x[2], st.x[4], c, hd);
  for (int j = 0; j < heads; ++j) {
    const int h = h0 + j;
    __syncthreads();  // seg is written; the previous head is done with xs
    xt.store(xs, kLdP, seg + j * kC);
    __syncthreads();
    if (j + 1 < heads) xt.load(x0 + (j + 1) * st.x[3], st.x[2], st.x[4], c, hd);
    float acc[2][4][4] = {};
    // A (n, s) = B[s][n], B (s, p) = (seg ⊙ x̄)[s][p], K = c
    warp_tile_mma_3xtf32<2, 4>(acc, Bs + 32 * wm, 1, kLdBt, xs + 32 * wn, kLdP, 1, kc);
    float* dst = states + ((static_cast<long long>(bi) * nz + z) * nh + h) * n * hd;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; r += 2) {
          const int row = 32 * wm + acc_row(mt, r), col = 32 * wn + acc_col(nt, r);
          if (row >= n || col >= hd) continue;
          float* o = dst + row * hd + col;
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(acc[mt][nt][r], acc[mt][nt][r + 1]);
          } else {
            o[0] = acc[mt][nt][r];
            if (col + 1 < hd) o[1] = acc[mt][nt][r + 1];
          }
        }
      }
    }
  }
}

// ---- 2. the recurrence across chunks, in place -----------------------------
__global__ void __launch_bounds__(kThreads)
    ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay, int nz, int nh,
                   long long per_head, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long bh = i / per_head;
  const long long bi = bh / nh;
  const int h = static_cast<int>(bh % nh);
  float* s = states + (bi * nz * nh + h) * per_head + i % per_head;  // chunk z at s[z·zs]
  const float* d = decay + bi * nz * nh + h;                         // chunk z at d[z·nh]
  const long long zs = nh * per_head;
  float v[kAhead], dk[kAhead], vn[kAhead], dn[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (u < nz) {
      v[u] = s[u * zs];
      dk[u] = d[u * nh];
    }
  }
  float S = 0.0f;
  for (int z0 = 0; z0 < nz; z0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {  // the next chunks' loads in flight
      const int z = z0 + kAhead + u;
      if (z < nz) {
        vn[u] = s[z * zs];
        dn[u] = d[z * nh];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int z = z0 + u;
      if (z < nz) {
        s[z * zs] = S;
        S = __fadd_rn(__fmul_rn(S, dk[u]), v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      v[u] = vn[u];
      dk[u] = dn[u];
    }
  }
}

// ---- 3. y, from the state entering each chunk ------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_output(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
                     const float* __restrict__ da, const float* __restrict__ states,
                     float* __restrict__ y, const SsdStrides st, int nz, int c, int nh, int hd,
                     int n) {
  extern __shared__ float smem[];
  float* Cs = smem;              // (kC, kLdRow)
  float* U = Cs + kC * kLdRow;   // B (kC, kLdRow) for C·Bᵀ, then S (kN, kLdP) of one head
  float* Ms = U + kUnion;        // (kC, kLdM)
  float* xs = Ms + kC * kLdM;    // (kC, kLdP)
  float* cum = xs + kC * kLdP;   // (kGroup, kC)

  const int bi = blockIdx.x / nz, z = blockIdx.x % nz;
  const int h0 = blockIdx.y * kGroup;
  const int heads = min(kGroup, nh - h0);
  stage<T, kC, kN>(Cs, kLdRow, cm + bi * st.c[0] + z * st.c[1], st.c[2], st.c[3], c, n);
  stage<T, kC, kN>(U, kLdRow, bm + bi * st.b[0] + z * st.b[1], st.b[2], st.b[3], c, n);
  chunk_cumsum(cum, da + bi * st.da[0] + z * st.da[1] + h0 * st.da[3], st.da[2], st.da[3], c,
               heads);  // its barriers also cover the staging

  // warp tile of the (c × c) and (c × hd) products: rows 16·wm, columns 32·wn
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  const int kn = (n + 7) & ~7;
  const int kin = min(16 * (wm + 1), (c + 7) & ~7);  // M is 0 past the warp's last row
  float cb[1][4][4] = {};
  // A (l, n) = C[l][n], B (n, s) = B[s][n], K = N
  warp_tile_mma_3xtf32<1, 4>(cb, Cs + 16 * wm * kLdRow, kLdRow, 1, U + 32 * wn * kLdRow, 1, kLdRow,
                             kn);
  const int row0 = 16 * wm + acc_row(0, 0), row1 = row0 + 8;
  const long long ypitch = static_cast<long long>(nh) * hd;
  const T* x0 = x + bi * st.x[0] + z * st.x[1] + h0 * st.x[3];
  const float* s0 = states + ((static_cast<long long>(bi) * nz + z) * nh + h0) * n * hd;
  for (int j = 0; j < heads; ++j) {
    const int h = h0 + j;
    const float* cj = cum + j * kC;
    __syncthreads();  // C·Bᵀ has read B, the previous head is done with U, Ms, xs
    stage<T, kC, kP>(xs, kLdP, x0 + j * st.x[3], st.x[2], st.x[4], c, hd);
    stage<float, kN, kP>(U, kLdP, s0 + static_cast<long long>(j) * n * hd, hd, 1, n, hd);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = 16 * wm + acc_row(0, r), s = 32 * wn + acc_col(nt, r);
        // selection, not a product: the upper triangle may be inf
        float m = 0.0f;
        if (s <= l) m = __fmul_rn(cb[0][nt][r], expf(__fsub_rn(cj[l], cj[s])));
        Ms[l * kLdM + s] = m;
      }
    }
    __syncthreads();
    // y = exp(cum) ⊙ (C·S) + M·x̄ in one accumulator: A (l, n) = C[l][n],
    // B (n, p) = S[n][p], K = N; then A (l, s) = M[l][s], B (s, p) = x̄[s][p],
    // K up to the warp's last row (M is 0 past it)
    float acc[1][4][4] = {};
    warp_tile_mma_3xtf32<1, 4>(acc, Cs + 16 * wm * kLdRow, kLdRow, 1, U + 32 * wn, kLdP, 1, kn);
    const float e0 = expf(cj[row0]), e1 = expf(cj[row1]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[0][nt][r] = __fmul_rn(r < 2 ? e0 : e1, acc[0][nt][r]);
    }
    warp_tile_mma_3xtf32<1, 4>(acc, Ms + 16 * wm * kLdM, kLdM, 1, xs + 32 * wn, kLdP, 1, kin);
    float* yz = y + (static_cast<long long>(bi) * nz + z) * c * ypitch + h * hd;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = r < 2 ? row0 : row1, p = 32 * wn + acc_col(nt, r);
        if (l < c && p < hd) yz[l * ypitch + p] = acc[0][nt][r];
      }
    }
  }
}

// ---- the product helper on its own -----------------------------------------
// c = a·b for a (64 × 128) and b (128 × 64), row-major fp32, one block of 8
// warps, 16 × 32 output tiles. transposed = 0 stages A row-major and B by
// rows of K (the output kernel's C·S); 1 stages A by rows of K and B by rows
// of N (the states kernel's Bᵀ·x̄ and the output kernel's C·Bᵀ).
constexpr int kTestM = 64, kTestK = 128, kTestN = 64;
constexpr size_t kTestSmem = sizeof(float) * 2 * (kTestK * kLdP > kTestM * kLdRow
                                                      ? kTestK * kLdP
                                                      : kTestM * kLdRow);

__global__ void __launch_bounds__(kThreads)
    ssd_mma_selftest_kernel(const float* __restrict__ a, const float* __restrict__ b,
                            float* __restrict__ c, int transposed) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + kTestSmem / sizeof(float) / 2;
  for (int i = threadIdx.x; i < kTestM * kTestK; i += kThreads) {
    const int r = i / kTestK, k = i % kTestK;
    if (transposed) {
      As[k * kLdP + r] = a[i];
    } else {
      As[r * kLdRow + k] = a[i];
    }
  }
  for (int i = threadIdx.x; i < kTestK * kTestN; i += kThreads) {
    const int k = i / kTestN, j = i % kTestN;
    if (transposed) {
      Bs[j * kLdRow + k] = b[i];
    } else {
      Bs[k * kLdP + j] = b[i];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  float acc[1][4][4] = {};
  if (transposed) {
    warp_tile_mma_3xtf32<1, 4>(acc, As + 16 * wm, 1, kLdP, Bs + 32 * wn * kLdRow, 1, kLdRow,
                               kTestK);
  } else {
    warp_tile_mma_3xtf32<1, 4>(acc, As + 16 * wm * kLdRow, kLdRow, 1, Bs + 32 * wn, kLdP, 1,
                               kTestK);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      c[(16 * wm + acc_row(0, r)) * kTestN + 32 * wn + acc_col(nt, r)] = acc[0][nt][r];
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

long long pass_blocks(long long batch, int nh, int hd, int n) {
  return (batch * nh * n * hd + kThreads - 1) / kThreads;
}

template <typename T>
int launch_ssd(const void* x, const void* bm, const void* cm, const float* da, float* states,
               float* decay, float* y, const SsdStrides& st, long long batch, int nz, int c,
               int nh, int hd, int n, cudaStream_t stream) {
  cudaError_t err = allow_smem(ssd_chunk_states<T>, kStatesSmem);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_output<T>, kOutputSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 chunks(static_cast<unsigned>(batch * nz), (nh + kGroup - 1) / kGroup);
  ssd_chunk_states<T><<<chunks, kThreads, kStatesSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), da, states, decay, st, nz, c, nh, hd, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_pass<<<static_cast<unsigned>(pass_blocks(batch, nh, hd, n)), kThreads, 0, stream>>>(
      states, decay, nz, nh, static_cast<long long>(n) * hd, batch * nh * n * hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_output<T><<<chunks, kThreads, kOutputSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm), da, states, y,
      st, nz, c, nh, hd, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch geometry at these sizes, for fp32 inputs: out[0] heads per
// block of the chunk kernels, out[1] threads a block, then for
// ssd_chunk_states (out[2..4]), ssd_state_pass (out[5..7]) and
// ssd_chunk_output (out[8..10]) the blocks, the dynamic shared memory of one
// block (bytes) and the blocks an SM holds at once. Returns a CUDA error code.
extern "C" int ssd_scan_plan(long long batch, int nz, int nh, int hd, int n, long long* out) {
  const long long chunk_blocks = batch * nz * ((nh + kGroup - 1) / kGroup);
  int per_sm[3] = {0, 0, 0};
  cudaError_t err = allow_smem(ssd_chunk_states<float>, kStatesSmem);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_output<float>, kOutputSmem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[0], ssd_chunk_states<float>,
                                                        kThreads, kStatesSmem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[1], ssd_state_pass, kThreads, 0);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[2], ssd_chunk_output<float>,
                                                        kThreads, kOutputSmem);
  }
  const long long geometry[11] = {kGroup, kThreads,
                                  chunk_blocks, static_cast<long long>(kStatesSmem), per_sm[0],
                                  pass_blocks(batch, nh, hd, n), 0, per_sm[1],
                                  chunk_blocks, static_cast<long long>(kOutputSmem), per_sm[2]};
  for (int i = 0; i < 11; ++i) out[i] = geometry[i];
  return static_cast<int>(err);
}

// x̄, B, C in `dtype` (0 = float32, 1 = bfloat16), dA float32, each read
// through its element strides: strides[0:5] x̄, [5:9] B, [9:13] C, [13:17] dA.
// states (batch, nz, nh, n, hd) and decay (batch, nz, nh): float32 scratch;
// y: contiguous float32 (batch, nz, c, nh, hd). c <= 64, n <= 128, hd <= 64.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int ssd_scan(const void* x, const void* bm, const void* cm, const void* da,
                        void* states, void* decay, void* y, const long long* strides, int dtype,
                        long long batch, int nz, int c, int nh, int hd, int n, void* stream) {
  if (c < 1 || c > kC || n < 1 || n > kN || hd < 1 || hd > kP || nh < 1 ||
      batch * nz > 0x7fffffffLL || pass_blocks(batch, nh, hd, n) > 0x7fffffffLL) {
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
  float* sp = static_cast<float*>(states);
  float* dp = static_cast<float*>(decay);
  float* yp = static_cast<float*>(y);
  if (dtype == 0) {
    return launch_ssd<float>(x, bm, cm, dap, sp, dp, yp, st, batch, nz, c, nh, hd, n, s);
  }
  if (dtype == 1) {
    return launch_ssd<__nv_bfloat16>(x, bm, cm, dap, sp, dp, yp, st, batch, nz, c, nh, hd, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// c = a·b through warp_tile_mma_3xtf32, for a (64 × 128) and b (128 × 64),
// contiguous float32; `transposed` picks the operand layouts in shared memory
// (see ssd_mma_selftest_kernel). Returns the CUDA error code of the launch.
extern "C" int ssd_mma_selftest(const void* a, const void* b, void* c, int transposed,
                                void* stream) {
  cudaError_t err = allow_smem(ssd_mma_selftest_kernel, kTestSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_mma_selftest_kernel<<<1, kThreads, kTestSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c),
      transposed);
  return static_cast<int>(cudaGetLastError());
}
