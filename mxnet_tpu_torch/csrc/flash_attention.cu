// Flash attention for Hopper (sm_90a): the forward and the two backward
// passes, behind a plain C interface loaded with ctypes
// (mxnet_tpu_torch/parallel/flash_attention.py).
//
// Replaces, in mxnet_tpu/parallel/flash_attention.py:
//   flash_fwd_kernel     <- _kernel          (the forward, online softmax)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel   (dq pass, with _bwd_block)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (dk/dv pass, with _bwd_block)
//
// Layout: q, k, v, o, do, dq, dk, dv are (BH, T, D) contiguous and 16-byte
// aligned, one element type for all of them (fp32, bf16 or fp16; each
// kernel is instantiated per type); lse and delta are (BH, T) fp32.
// Supported head dims: every D <= 128 that is a multiple of 8 (the wrapper
// raises on the rest). A tile's feature width DP is 64 for D <= 64 and 128
// above, zero-filled past D.
//
// Arithmetic is fp32 throughout, as in the TPU kernels: q, k, v and do are
// converted to fp32 as they are staged in shared memory, the scores, p and
// ds stay fp32, and each output is rounded once at its store. Every dot
// product is summed in ascending order of its index by fp32 FMA. Ragged T
// is masked on both the q and the k side, so every T >= 1 has a kernel
// form (the TPU kernels need a block that divides T and fall back to the
// dense formula otherwise).
//
// Bound: per (q, k) pair that is live (all T^2 pairs, or T(T+1)/2 with
// causal), the forward does 4*D operations (QK^T and PV), the dq pass 6*D
// (S, dP, dS.K) and the dk/dv pass 8*D (S, dP, P^T.dO, dS^T.Q), against
// bytes of O(BH*T*D). At D = 64 and T = 2048 that is ~500 operations per
// byte, so all three are operations-bound, on tensor cores in the limit.
// These kernels run on the CUDA cores in fp32 FMA: no tensor cores yet,
// because bf16 mma operands would move where p is rounded; wgmma tiles,
// TMA and a deeper pipeline are later work. What bounds them now is the
// issue rate of FMAs and shared-memory loads and the latency of the tile
// loads, so the design feeds each thread's 4x4 register tile with 16-byte
// shared loads, and loads the next tile from global memory (16-byte
// vectors, held in registers) while the current one is in use.
//
// Design: one 256-thread block per (batch*head, 64-row tile); the TPU's
// sequential grid axis becomes a loop inside the block over the other
// side's 64-row tiles, staged through shared memory as fp32 rows of stride
// DP + 4 (converted once, as they are stored). A thread owns rows ty + 16i (i < 4) of the block's tile and
// columns tx + 16j (j < 4) of each 64x64 score tile, so the online-softmax
// state of a row (m, l) lives in the registers of the 16 threads of that
// row and row reductions are 16-lane shuffles. The score products read
// both operands as float4 along the feature axis (row strides of an odd
// number of float4, so the 16 rows a warp reads spread over all banks);
// the second products (P.V, dS.K, P^T.dO, dS^T.Q) read the score tile as
// float4 along its columns and the other operand as float4 along features,
// each thread accumulating output columns 64g + 4tx + (0..3). With causal
// the loops stop at (forward, dq) or start from (dk/dv) the diagonal tile.
// A fully masked score is -inf; every exp is guarded as in the TPU kernel
// (p = 0 where s = -inf or lse = -inf, corr = 0 where m_prev = -inf), so a
// fully masked tile or row gives zeros, never NaN.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // k rows per tile (== BQ: the diagonal is one tile)
constexpr int NT = 256;       // threads per block, 16 x 16
constexpr int TM = 4;         // rows per thread: ty + 16 i
constexpr int TN = 4;         // score columns per thread: tx + 16 j
constexpr int LP = BK + 16;   // row stride of a score tile (ty rows 16 banks apart)
constexpr float NEG_INF = -INFINITY;
// Blocks per SM the register budget is cut for: two at DP = 64 (128
// registers a thread, a few spilled, measured faster on the H100), one at
// DP = 128 (where a 128-register cut spills hundreds of bytes).
template <int DP>
constexpr int min_blocks() {
  return DP == 64 ? 2 : 1;
}

// 16 bytes of elements (4 fp32 or 8 bf16/fp16) to fp32, exactly.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float* f, __half) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __half2float(__ushort_as_half(
        static_cast<unsigned short>(w[e] & 0xffffu)));
    f[2 * e + 1] = __half2float(__ushort_as_half(
        static_cast<unsigned short>(w[e] >> 16)));
  }
}

// Store 4 consecutive outputs, rounded once to E (8 or 16 bytes).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}

__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  __half2 a = __floats2half2_rn(v[0], v[1]);
  __half2 b = __floats2half2_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// A 64-row tile of a (T, D) matrix in flight from global memory: each
// thread holds NV 16-byte vectors in registers, issued together so their
// latencies overlap (and, in the loops below, overlap the previous tile's
// arithmetic). Rows >= T and columns >= D read as zero.
template <typename E, int DP>
struct TileLoad {
  static constexpr int VE = 16 / sizeof(E);   // elements per vector
  static constexpr int VPR = DP / VE;         // vectors per row
  static constexpr int NV = 64 * VPR / NT;    // vectors per thread
  uint4 buf[NV];

  __device__ __forceinline__ void fetch(const E* src, int r0, int T,
                                        int D) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int idx = threadIdx.x + n * NT;
      const int r = idx / VPR;
      const int c = (idx % VPR) * VE;
      buf[n] = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < T && c < D)
        buf[n] = *reinterpret_cast<const uint4*>(
            src + static_cast<int64_t>(r0 + r) * D + c);
    }
  }

  // fp32 into shared memory (row stride DP + 4), times `mul`
  __device__ __forceinline__ void stage(float* dst, float mul) const {
    constexpr int LD = DP + 4;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int idx = threadIdx.x + n * NT;
      const int r = idx / VPR;
      const int c = (idx % VPR) * VE;
      float f[VE];
      unpack(buf[n], f, E());
#pragma unroll
      for (int e = 0; e < VE; e += 4)
        *reinterpret_cast<float4*>(dst + r * LD + c + e) = make_float4(
            f[e] * mul, f[e + 1] * mul, f[e + 2] * mul, f[e + 3] * mul);
    }
  }
};

// s[i][j] += A[ty + 16i, :] . B[tx + 16j, :] over the DP features, in
// ascending feature order. A and B are staged tiles (row stride DP + 4).
template <int DP>
__device__ __forceinline__ void score_tile(float (&s)[TM][TN],
                                           const float* A, const float* B,
                                           int ty, int tx) {
  constexpr int LD = DP + 4;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = ld4(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = ld4(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// out[i][4g + e] += sum_c P[ty + 16i, c] * M[c, 64g + 4tx + e] over the 64
// columns c of a score tile P (row stride LP), in ascending c; M is a
// staged tile (row stride DP + 4).
template <int DP>
__device__ __forceinline__ void mix_tile(float (&out)[TM][DP / 16],
                                         const float* P, const float* M,
                                         int ty, int tx) {
  constexpr int LD = DP + 4;
  constexpr int NG = DP / 64;
#pragma unroll 2
  for (int c = 0; c < 64; c += 4) {
    float4 p[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) p[i] = ld4(P + (ty + 16 * i) * LP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 m = ld4(M + (c + cc) * LD + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float pc = comp(p[i], cc);
          out[i][4 * g + 0] = fmaf(pc, m.x, out[i][4 * g + 0]);
          out[i][4 * g + 1] = fmaf(pc, m.y, out[i][4 * g + 1]);
          out[i][4 * g + 2] = fmaf(pc, m.z, out[i][4 * g + 2]);
          out[i][4 * g + 3] = fmaf(pc, m.w, out[i][4 * g + 3]);
        }
      }
    }
  }
}

// Store out[i][4g + e] * mul[i] to row (r0 + ty + 16i), columns
// 64g + 4tx + (0..3) of a (T, D) output, inside its bounds (D is a
// multiple of 8, so a group of 4 columns is all in or all out).
template <typename E, int DP>
__device__ __forceinline__ void store_rows(E* dst, int r0, int T, int D,
                                           const float (&out)[TM][DP / 16],
                                           const float (&mul)[TM], int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= T) continue;
#pragma unroll
    for (int g = 0; g < DP / 64; ++g) {
      const int c = 64 * g + 4 * tx;
      if (c >= D) continue;
      const float v[4] = {out[i][4 * g] * mul[i], out[i][4 * g + 1] * mul[i],
                          out[i][4 * g + 2] * mul[i],
                          out[i][4 * g + 3] * mul[i]};
      store4(dst + static_cast<int64_t>(r) * D + c, v);
    }
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------- forward

template <typename E, int DP>
__global__ void __launch_bounds__(NT, min_blocks<DP>())
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, E* __restrict__ o,
                 float* __restrict__ lse, int T, int D, float scale,
                 int causal) {
  constexpr int LD = DP + 4;
  constexpr int NO = DP / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // 64 x LD, pre-scaled
  float* Ks = Qs + BQ * LD;     // 64 x LD
  float* Vs = Ks + BK * LD;     // 64 x LD
  float* Ps = Vs + BK * LD;     // 64 x LP

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nq = (T + BQ - 1) / BQ;
  const int64_t bh = blockIdx.x / nq;
  // heaviest causal tiles (the last q rows) are scheduled first
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * BQ;
  const int64_t base = bh * static_cast<int64_t>(T) * D;
  q += base;
  k += base;
  v += base;
  o += base;

  TileLoad<E, DP> kin, vin;
  {
    TileLoad<E, DP> qin;
    qin.fetch(q, q0, T, D);
    kin.fetch(k, 0, T, D);
    vin.fetch(v, 0, T, D);
    qin.stage(Qs, scale);
  }

  float m[TM], l[TM], acc[TM][NO];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(T, q0 + BQ) : T;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads of Ks, Vs, Ps are done
    kin.stage(Ks, 1.f);
    vin.stage(Vs, 1.f);
    __syncthreads();
    if (k0 + BK < k_end) {  // the next tile loads under this one's math
      kin.fetch(k, k0 + BK, T, D);
      vin.fetch(v, k0 + BK, T, D);
    }

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    score_tile<DP>(s, Qs, Ks, ty, tx);

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qr = q0 + ty + 16 * i;
      float bmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool live = kc < T && (!causal || kc <= qr);
        s[i][j] = live ? s[i][j] : NEG_INF;
        bmax = fmaxf(bmax, s[i][j]);
      }
      bmax = row_max16(bmax);
      const float m_new = fmaxf(m[i], bmax);
      const float m_safe = m_new == NEG_INF ? 0.f : m_new;
      const float corr = m[i] == NEG_INF ? 0.f : expf(m[i] - m_safe);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_safe);
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rsum += p;
      }
      rsum = row_sum16(rsum);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // Ps is complete
    mix_tile<DP>(acc, Ps, Vs, ty, tx);
  }

  float inv[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qr = q0 + ty + 16 * i;
    const float lc = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / lc;
    // a fully masked row keeps lse = -inf: -inf + log(1e-30) = -inf
    if (tx == 0 && qr < T) lse[bh * T + qr] = m[i] + logf(lc);
  }
  store_rows<E, DP>(o, q0, T, D, acc, inv, ty, tx);
}

// --------------------------------------------------------------- dq pass

template <typename E, int DP>
__global__ void __launch_bounds__(NT, min_blocks<DP>())
flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const E* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, E* __restrict__ dq,
                    int T, int D, float scale, int causal) {
  constexpr int LD = DP + 4;
  constexpr int NO = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // 64 x LD, pre-scaled
  float* dOs = Qs + BQ * LD;    // 64 x LD
  float* Ks = dOs + BQ * LD;    // 64 x LD
  float* Vs = Ks + BK * LD;     // 64 x LD
  float* dSs = Vs + BK * LD;    // 64 x LP

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nq = (T + BQ - 1) / BQ;
  const int64_t bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * BQ;
  const int64_t base = bh * static_cast<int64_t>(T) * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dq += base;

  TileLoad<E, DP> kin, vin;
  {
    TileLoad<E, DP> qin, doin;
    qin.fetch(q, q0, T, D);
    doin.fetch(dout, q0, T, D);
    kin.fetch(k, 0, T, D);
    vin.fetch(v, 0, T, D);
    qin.stage(Qs, scale);
    doin.stage(dOs, 1.f);
  }

  float row_lse[TM], row_delta[TM], acc[TM][NO];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qr = q0 + ty + 16 * i;
    row_lse[i] = qr < T ? lse[bh * T + qr] : NEG_INF;
    row_delta[i] = qr < T ? delta[bh * T + qr] : 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(T, q0 + BQ) : T;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    kin.stage(Ks, 1.f);
    vin.stage(Vs, 1.f);
    __syncthreads();
    if (k0 + BK < k_end) {
      kin.fetch(k, k0 + BK, T, D);
      vin.fetch(v, k0 + BK, T, D);
    }

    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
    score_tile<DP>(s, Qs, Ks, ty, tx);
    score_tile<DP>(dp, dOs, Vs, ty, tx);

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qr = q0 + ty + 16 * i;
      const bool row_live = row_lse[i] != NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool live = row_live && kc < T && (!causal || kc <= qr);
        // p = exp(s - lse) is the exact softmax: lse is the forward's row
        // logsumexp, so no renormalization
        const float p = live ? expf(s[i][j] - row_lse[i]) : 0.f;
        dSs[(ty + 16 * i) * LP + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
    mix_tile<DP>(acc, dSs, Ks, ty, tx);
  }

  // dq_i = scale * sum_j ds_ij k_j
  const float mul[TM] = {scale, scale, scale, scale};
  store_rows<E, DP>(dq, q0, T, D, acc, mul, ty, tx);
}

// ------------------------------------------------------------ dk/dv pass

template <typename E, int DP>
__global__ void __launch_bounds__(NT, min_blocks<DP>())
flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, const E* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, E* __restrict__ dk,
                     E* __restrict__ dv, int T, int D, float scale,
                     int causal) {
  constexpr int LD = DP + 4;
  constexpr int NO = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;             // 64 x LD (this block's k rows)
  float* Vs = Ks + BK * LD;     // 64 x LD
  float* Qs = Vs + BK * LD;     // 64 x LD, pre-scaled
  float* dOs = Qs + BQ * LD;    // 64 x LD
  float* Pt = dOs + BQ * LD;    // 64 x LP: p^T, k rows by q columns
  float* dSt = Pt + BK * LP;    // 64 x LP: ds^T
  float* Ls = dSt + BK * LP;    // 64: lse of the q tile
  float* Dl = Ls + BQ;          // 64: delta of the q tile

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nk = (T + BK - 1) / BK;
  const int64_t bh = blockIdx.x / nk;
  // heaviest causal tiles (the first k rows) are scheduled first
  const int k0 = static_cast<int>(blockIdx.x % nk) * BK;
  const int64_t base = bh * static_cast<int64_t>(T) * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dk += base;
  dv += base;
  lse += bh * T;
  delta += bh * T;

  // causal: q rows before k0 see none of these keys; BQ == BK, so the
  // walk starts at the diagonal tile
  const int q_begin = causal ? k0 : 0;
  TileLoad<E, DP> qin, doin;
  {
    TileLoad<E, DP> kin, vin;
    kin.fetch(k, k0, T, D);
    vin.fetch(v, k0, T, D);
    qin.fetch(q, q_begin, T, D);
    doin.fetch(dout, q_begin, T, D);
    kin.stage(Ks, 1.f);
    vin.stage(Vs, 1.f);
  }

  float dk_acc[TM][NO], dv_acc[TM][NO];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NO; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = q_begin; q0 < T; q0 += BQ) {
    __syncthreads();
    qin.stage(Qs, scale);
    doin.stage(dOs, 1.f);
    if (threadIdx.x < BQ) {
      const int qr = q0 + threadIdx.x;
      Ls[threadIdx.x] = qr < T ? lse[qr] : NEG_INF;
      Dl[threadIdx.x] = qr < T ? delta[qr] : 0.f;
    }
    __syncthreads();
    if (q0 + BQ < T) {  // the next tile loads under this one's math
      qin.fetch(q, q0 + BQ, T, D);
      doin.fetch(dout, q0 + BQ, T, D);
    }

    // transposed tiles: st[i][j] = k_(ty+16i) . qs_(tx+16j)
    float st[TM][TN], dpt[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) st[i][j] = dpt[i][j] = 0.f;
    score_tile<DP>(st, Ks, Qs, ty, tx);
    score_tile<DP>(dpt, Vs, dOs, ty, tx);

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int kr = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int qc = tx + 16 * j;
        const float row_lse = Ls[qc];
        const bool live = row_lse != NEG_INF && kr < T && q0 + qc < T &&
                          (!causal || kr <= q0 + qc);
        const float p = live ? expf(st[i][j] - row_lse) : 0.f;
        Pt[(ty + 16 * i) * LP + qc] = p;
        dSt[(ty + 16 * i) * LP + qc] = p * (dpt[i][j] - Dl[qc]);
      }
    }
    __syncthreads();

    // dv_j += sum_i p_ij do_i ; dk_j += sum_i ds_ij qs_i (qs carries the
    // scale already, so dk takes no second factor)
    mix_tile<DP>(dv_acc, Pt, dOs, ty, tx);
    mix_tile<DP>(dk_acc, dSt, Qs, ty, tx);
  }

  const float one[TM] = {1.f, 1.f, 1.f, 1.f};
  store_rows<E, DP>(dk, k0, T, D, dk_acc, one, ty, tx);
  store_rows<E, DP>(dv, k0, T, D, dv_acc, one, ty, tx);
}

// ----------------------------------------------------------- launching

template <int DP>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((BQ + 2 * BK) * (DP + 4) + BQ * LP);
}
template <int DP>
constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * BQ + 2 * BK) * (DP + 4) + BQ * LP);
}
template <int DP>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * BQ + 2 * BK) * (DP + 4) + 2 * BK * LP +
                          2 * BQ);
}

// Above 48 KB a block's shared memory must be opted into, once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o, *o2;   // o (forward) / dq / dk; dv
  float* lse_out;
  int BH, T, D;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename E, int DP>
cudaError_t launch_fwd(const Args& a) {
  static bool ready = false;
  auto kernel = flash_fwd_kernel<E, DP>;
  cudaError_t err = allow_smem(kernel, fwd_smem<DP>(), &ready);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(a.BH) * ((a.T + BQ - 1) / BQ);
  kernel<<<static_cast<unsigned>(blocks), NT, fwd_smem<DP>(), a.stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k),
      static_cast<const E*>(a.v), static_cast<E*>(a.o), a.lse_out, a.T, a.D,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename E, int DP>
cudaError_t launch_dq(const Args& a) {
  static bool ready = false;
  auto kernel = flash_bwd_dq_kernel<E, DP>;
  cudaError_t err = allow_smem(kernel, dq_smem<DP>(), &ready);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(a.BH) * ((a.T + BQ - 1) / BQ);
  kernel<<<static_cast<unsigned>(blocks), NT, dq_smem<DP>(), a.stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k),
      static_cast<const E*>(a.v), static_cast<const E*>(a.dout), a.lse,
      a.delta, static_cast<E*>(a.o), a.T, a.D, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename E, int DP>
cudaError_t launch_dkv(const Args& a) {
  static bool ready = false;
  auto kernel = flash_bwd_dkv_kernel<E, DP>;
  cudaError_t err = allow_smem(kernel, dkv_smem<DP>(), &ready);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(a.BH) * ((a.T + BK - 1) / BK);
  kernel<<<static_cast<unsigned>(blocks), NT, dkv_smem<DP>(), a.stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k),
      static_cast<const E*>(a.v), static_cast<const E*>(a.dout), a.lse,
      a.delta, static_cast<E*>(a.o), static_cast<E*>(a.o2), a.T, a.D,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_width(int which, const Args& a) {
  if (a.D <= 64) {
    if (which == 0) return launch_fwd<E, 64>(a);
    if (which == 1) return launch_dq<E, 64>(a);
    return launch_dkv<E, 64>(a);
  }
  if (which == 0) return launch_fwd<E, 128>(a);
  if (which == 1) return launch_dq<E, 128>(a);
  return launch_dkv<E, 128>(a);
}

cudaError_t dispatch(int which, int dtype, const Args& a) {
  if (dtype == DT_F32) return dispatch_width<float>(which, a);
  if (dtype == DT_BF16) return dispatch_width<__nv_bfloat16>(which, a);
  return dispatch_width<__half>(which, a);
}

bool bad_args(int BH, int T, int D, int dt) {
  return BH < 1 || T < 1 || D < 8 || D > 128 || D % 8 != 0 || dt < DT_F32 ||
         dt > DT_F16 ||
         static_cast<int64_t>(BH) * ((T + BQ - 1) / BQ) > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Pointers must be 16-byte aligned (the wrapper checks). Each launch
// returns its cudaError_t.

// o, lse <- attention(q, k, v).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, float* lse, int BH, int T, int D,
                               float scale, int causal, int dtype,
                               void* stream) {
  if (bad_args(BH, T, D, dtype)) return cudaErrorInvalidValue;
  Args a = {q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse,
            BH, T, D, scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(0, dtype, a);
}

// dq <- dL/dq from the forward's residuals; delta = rowsum(do * o) - dlse.
int flash_attention_bwd_dq_launch(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq, int BH, int T, int D, float scale,
                                  int causal, int dtype, void* stream) {
  if (bad_args(BH, T, D, dtype)) return cudaErrorInvalidValue;
  Args a = {q, k, v, dout, lse, delta, dq, nullptr, nullptr,
            BH, T, D, scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(1, dtype, a);
}

// dk, dv <- dL/dk, dL/dv from the same residuals.
int flash_attention_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int BH, int T, int D,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  if (bad_args(BH, T, D, dtype)) return cudaErrorInvalidValue;
  Args a = {q, k, v, dout, lse, delta, dk, dv, nullptr,
            BH, T, D, scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(2, dtype, a);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
