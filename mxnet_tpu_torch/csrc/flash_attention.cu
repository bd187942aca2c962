// Flash attention for Hopper (sm_90a): the forward and the two backward
// passes, behind a plain C interface loaded with ctypes
// (mxnet_tpu_torch/parallel/flash_attention.py).
//
// Replaces, in mxnet_tpu/parallel/flash_attention.py:
//   flash_fwd_tc_kernel     <- _kernel          (the forward, online softmax),
//                              bf16 and fp16, on the tensor cores
//   flash_fwd_kernel        <- _kernel          in fp32 on the CUDA cores
//   flash_bwd_dq_tc_kernel  <- _bwd_dq_kernel   (dq pass, with _bwd_block),
//                              bf16 and fp16, on the tensor cores
//   flash_bwd_dkv_tc_kernel <- _bwd_dkv_kernel  (dk/dv pass, with
//                              _bwd_block), bf16 and fp16, tensor cores
//   flash_bwd_dq_kernel, flash_bwd_dkv_kernel: the same two passes in fp32
//                              on the CUDA cores
//
// Layout: q, k, v, o, do, dq, dk, dv are (BH, T, D) contiguous and 16-byte
// aligned, one element type for all of them (fp32, bf16 or fp16; each
// kernel is instantiated per type); lse and delta are (BH, T) fp32.
// Supported head dims: every D <= 128 that is a multiple of 8 (the wrapper
// raises on the rest). A tile's feature width DP is 64 for D <= 64 and 128
// above, zero-filled past D (so a D that is not a multiple of 16 pads the
// k-depth of the tensor-core products with zeros). Ragged T is masked on
// both the q and the k side, so every T >= 1 has a kernel form (the TPU
// kernels need a block that divides T and fall back to the dense formula
// otherwise): rows >= T read as zeros and are never stored.
//
// Bound: per (q, k) pair that is live (all T^2 pairs, or T(T+1)/2 with
// causal), the forward does 4*D operations (QK^T and PV), the dq pass 6*D
// (S, dP, dS.K) and the dk/dv pass 8*D (S, dP, P^T.dO, dS^T.Q), against
// bytes of O(BH*T*D). At D = 64 and T = 2048 that is ~500 operations per
// byte, so all three are bound by operations, at the bf16 tensor-core peak
// (989 TFLOP/s on an H100 SXM).
//
// The fp32 kernels run on the CUDA cores in fp32 FMA (tensor cores in
// TF32 could not hold fp32 parity): q, k, v and do are
// converted to fp32 as they are staged in shared memory, the scores, p and
// ds stay fp32, and each output is rounded once at its store. Every dot
// product is summed in ascending order of its index by fp32 FMA. What
// bounds them is the issue rate of FMAs and shared-memory loads and the
// latency of the tile loads, so the design feeds each thread's 4x4
// register tile with 16-byte shared loads, and loads the next tile from
// global memory (16-byte vectors, held in registers) while the current one
// is in use. One 256-thread block per (batch*head, 64-row tile); the TPU's
// sequential grid axis becomes a loop inside the block over the other
// side's 64-row tiles, staged through shared memory as fp32 rows of stride
// DP + 4 (converted once, as they are stored). A thread owns rows ty + 16i
// (i < 4) of the block's tile and columns tx + 16j (j < 4) of each 64x64
// score tile, so the online-softmax state of a row (m, l) lives in the
// registers of the 16 threads of that row and row reductions are 16-lane
// shuffles. The score products read both operands as float4 along the
// feature axis (row strides of an odd number of float4, so the 16 rows a
// warp reads spread over all banks); the second products (P.V, dS.K,
// P^T.dO, dS^T.Q) read the score tile as float4 along its columns and the
// other operand as float4 along features, each thread accumulating output
// columns 64g + 4tx + (0..3).
//
// The bf16/fp16 kernels run on the tensor cores (warpgroup wgmma,
// m64nNk16, fp32 accumulators). In the forward a block is one warpgroup
// and its 64 q rows (Q loaded once), and 64-row K and V tiles stream
// through a ring of four stages (three at DP = 128); per tile S = Q.K^T
// with both operands in shared memory, the online softmax in registers (a
// row's max and sum over its four lanes by two shuffles, in log2 units: one
// multiply and one exp2 per score), the O accumulator rescaled by corr, and
// O += P.V with P packed in place as the register A operand and V read
// MN-major. What bounds it is the softmax: one exp2 per score on the
// special-function unit (16 a clock per SM against the tensor cores' 4D
// operations per score) and the instructions around it, so the products
// are software-pipelined against it (two S accumulators in turn): S of the
// next tile and P.V of the previous one run on the tensor cores while this
// tile's softmax runs, and three blocks share an SM (168 registers at
// DP = 64). On the H100 this beat the dq pass's geometry (two warpgroups,
// a 128-row q tile, each tile's products waited for before its softmax)
// at (8, 8, 2048, 64) causal; a two-warpgroup block pipelined the same way
// needs 157 registers, so one block per SM, and was slower. The dq pass
// mirrors the TPU's grid over q tiles with k sequential, the dk/dv pass its
// grid over k tiles with q sequential: both recompute S and dP, which is
// the price of a dq without atomics, so two launches on the same inputs
// give the same bits (no kernel here uses atomics). A block
// is two warpgroups; each owns 64 rows (wgmma's M): q rows in the dq pass
// (a 128-row q tile per block, k tiles of 64), k rows in the dk/dv pass (a
// 128-row k tile, q tiles of 32, so that a warpgroup's four accumulators
// fit in registers). Per tile the dq pass computes S = Q.K^T and
// dP = dO.V^T with both operands in shared memory, forms dS in registers
// from the accumulators and adds dS.K to dQ with dS as the register A
// operand (the accumulator's fragment is the A fragment of the next
// product: no trip through shared memory) and the K tile read MN-major
// (wgmma's transpose bit). The dk/dv pass computes S^T = K.Q^T and
// dP^T = V.dO^T, then dV += P^T.dO and dK += dS^T.Q the same way. Tiles are
// loaded with 16-byte cp.async straight into the 128-byte-swizzled layout
// the wgmma descriptors read (at DP = 64 in bf16 a row is exactly one
// swizzle atom), in a ring of two stages: the next tile's loads run under
// the current tile's products.
//
// What bounds the backward passes, short of the tensor-core peak: while a
// warpgroup forms p and ds on the CUDA cores its products wait. So the
// exponentials overlap the dP product (S and dP are two commit groups),
// only the diagonal and ragged tiles test liveness, the exponent is one FMA
// and one exp2 (log2(e) folded into the scale and the lse), and each pass
// fits 128 registers at DP <= 64 so that two blocks share an SM and one
// block's products run under the other's p and ds.
//
// Numerics: scale multiplies the fp32 S accumulator (not q: 1/sqrt(D) would
// round in bf16). The forward rounds p = exp(S*scale - m_running) once to
// the input type as the A operand of P.V, a rounding the TPU kernel (p in
// fp32) does not make and SDPA's flash forward does; l sums the fp32 p, and
// o = O / max(l, 1e-30) and lse = m + log(max(l, 1e-30)) are formed in fp32.
// In the backward, p = exp(S*scale - lse) and ds = p * (dP - delta) are
// computed in fp32 and rounded once to the input type as register operands
// (the single rounding these kernels add, at the points where bf16
// attention itself rounds p and ds); dq and dk take the scale once at
// their store; every output is rounded once at its store. A masked score
// takes an exponent of -inf and a row whose lse is -inf one of +inf, so
// either gives p = 0, never NaN.
//
// Both designs skip causal tiles that are wholly masked (the loops stop at
// (forward, dq) or start from (dk/dv) the diagonal) and mask only the
// diagonal and ragged tiles, and schedule the heaviest causal tiles first.
// In the fp32 kernels and the tensor-core forward a fully masked score is
// -inf and every exp is guarded as in the TPU kernel (p = 0 where s = -inf
// or lse = -inf, corr = 0 where m_prev = -inf), so a fully masked tile or
// row gives zeros, never NaN.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// The CUDA-core kernels run only in fp32 (bf16 and fp16 take the
// tensor-core kernels): 16 bytes of 4 elements, and a store of 4.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

// ------------------------------------- bf16/fp16 backward: tensor cores

// wgmma products with fp32 accumulators, one set per input type E.
// ss: A and B from shared memory (descriptors), both K-major.
// rs: A from registers (4 x 32-bit, the m16n8k16 A fragment of each warp),
// B from shared memory, MN-major (transpose bit set).
// scale_d = 0 overwrites the accumulator, 1 adds to it.
#define FLASH_WGMMA_OPS(TY, E)                                                 \
  __device__ __forceinline__ void wgmma_ss_n32(                                \
      float (&d)[16], uint64_t da, uint64_t db, int scale_d, E) {              \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                           \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"           \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
        "%15"                                                                  \
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15])                                                            \
      : "l"(da), "l"(db), "r"(scale_d));                                       \
  }                                                                            \
  __device__ __forceinline__ void wgmma_ss_n64(                                \
      float (&d)[32], uint64_t da, uint64_t db, int scale_d, E) {              \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"           \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
        "%28, %29, %30, %31"                                                   \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31])                                               \
      : "l"(da), "l"(db), "r"(scale_d));                                       \
  }                                                                            \
  __device__ __forceinline__ void wgmma_rs_n64(                                \
      float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d, E) {   \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"           \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
        "%28, %29, %30, %31"                                                   \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31])                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));    \
  }

FLASH_WGMMA_OPS("bf16", __nv_bfloat16)
FLASH_WGMMA_OPS("f16", __half)
#undef FLASH_WGMMA_OPS

constexpr int WG = 128;        // threads of a warpgroup
constexpr int NTC = 2 * WG;    // threads of a tensor-core block
constexpr int ROWS = 64;       // rows a warpgroup owns (wgmma's M)
// depth of the ring of streamed tiles: the next tile loads under the
// current one's products
constexpr int STAGES = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A tile of R rows x DP columns of a 16-bit type lives in shared memory as
// DP / 64 panels of R rows x 128 bytes (panel p at p * R * 128), each
// 1024-byte group of 8 rows one 128-byte swizzle atom: the 16-byte chunk c
// of row r sits at r * 128 + ((c ^ (r & 7)) << 4). wgmma reads it K-major
// (features along K: the score products) or MN-major (features along N, rows
// along K: the second products), through these descriptors.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);  // 128-byte swizzle
}

// K-major, features 16kk..16kk+15: 32 bytes into the atom row; 8-row groups
// 1024 bytes apart (SBO); LBO is unused with a swizzle this wide.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return wgmma_desc(tile + (kk >> 2) * R * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major, rows 16kk..16kk+15 of panel p as K, its 64 columns as N:
// K's 8-row groups 1024 bytes apart (SBO), panels R * 128 apart (LBO).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int p, int kk) {
  return wgmma_desc(tile + p * R * 128 + kk * 2048, R * 128, 1024);
}

// rows r0.. of a (T, D) matrix into a tile, by 16-byte cp.async into the
// swizzled layout, by the NTHR threads of the block; chunks past T or D are
// filled with zeros
template <typename E, int R, int DP, int NTHR = NTC>
__device__ __forceinline__ void load_tile(uint32_t tile, const E* src,
                                          int r0, int T, int D) {
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  static_assert(R * CPR % NTHR == 0, "tile chunks must split evenly");
#pragma unroll
  for (int n = 0; n < R * CPR / NTHR; ++n) {
    const int idx = threadIdx.x + n * NTHR;
    const int r = idx / CPR;
    const int c = idx % CPR;
    const bool ok = r0 + r < T && c * 8 < D;
    const E* g = ok ? src + static_cast<int64_t>(r0 + r) * D + c * 8 : src;
    const uint32_t dst =
        tile + (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(g), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// n fp32 entries r0.. of a row vector of length T (zeros past T)
__device__ __forceinline__ void load_vec(uint32_t dst, const float* src,
                                         int r0, int T, int n) {
  if (static_cast<int>(threadIdx.x) < n) {
    const int r = r0 + threadIdx.x;
    const bool ok = r < T;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     dst + 4 * threadIdx.x),
                 "l"(ok ? src + r : src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the landed tiles, written through the generic proxy, made visible to
// wgmma's reads (the async proxy); then a block barrier
__device__ __forceinline__ void tiles_ready() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed product groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

constexpr float LOG2E = 1.4426950408889634f;

// exp(s * scale - lse) = exp2(s * scale * log2(e) - lse * log2(e)); a row
// (or column) whose lse is -inf gets +inf here, so its p is exp2(-inf) = 0
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == NEG_INF ? INFINITY : lse * LOG2E;
}

// keeps the compiler from moving accumulator accesses across the asynchronous
// products (before a fence, after a wait)
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi,
                                          __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of an m64nN product: thread t of the warpgroup holds, for
// each 8-column block j, rows 16 (t / 32) + (t % 32) / 4 (registers 4j,
// 4j + 1) and 8 below it (4j + 2, 4j + 3), columns 8j + 2 (t % 4) + (0, 1).
// Store one 64-column panel of it, times mul, to rows row0.. and columns
// col0.. of a (T, D) output, inside its bounds.
template <typename E>
__device__ __forceinline__ void store_acc(E* dst, const float (&acc)[32],
                                          int row0, int col0, int T, int D,
                                          float mul, int t) {
  const int ra = row0 + 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col0 + 8 * j + 2 * (t & 3);
    if (c >= D) continue;  // D is a multiple of 8: both columns or neither
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      if (r < T)
        *reinterpret_cast<uint32_t*>(dst + static_cast<int64_t>(r) * D + c) =
            pack2(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul, E());
    }
  }
}

// blocks per SM the dq pass's registers are cut for: two at DP = 64 (128
// registers a thread), one at DP = 128
template <int DP>
constexpr int dq_tc_min_blocks() {
  return DP == 64 ? 2 : 1;
}

template <int DP>
constexpr uint32_t dq_tc_smem() {
  // Q and dO tiles of 128 rows, a ring of K and V tiles of 64 rows, and
  // 1024 bytes to align the swizzle atoms
  return 2 * (2 * ROWS) * DP * 2 + 2 * STAGES * 64 * DP * 2 + 1024;
}

template <typename E, int DP>
__global__ void __launch_bounds__(NTC, dq_tc_min_blocks<DP>())
flash_bwd_dq_tc_kernel(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, const E* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, E* __restrict__ dq,
                       int T, int D, float scale, int causal) {
  constexpr int BQ2 = 2 * ROWS;  // q rows per block, 64 per warpgroup
  constexpr int BK2 = 64;        // k rows per tile
  constexpr uint32_t QT = BQ2 * DP * 2;  // bytes of a q-side tile
  constexpr uint32_t KT = BK2 * DP * 2;  // bytes of a k-side tile
  constexpr int NP = DP / 64;            // 64-column panels of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t dOs = Qs + QT;
  const uint32_t Ks = dOs + QT;             // STAGES tiles
  const uint32_t Vs = Ks + STAGES * KT;     // STAGES tiles

  const int wg = threadIdx.x / WG;
  const int t = threadIdx.x % WG;
  const int nq = (T + BQ2 - 1) / BQ2;
  const int64_t bh = blockIdx.x / nq;
  // heaviest causal tiles (the last q rows) are scheduled first
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * BQ2;
  const int64_t base = bh * static_cast<int64_t>(T) * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dq += base;
  lse += bh * T;
  delta += bh * T;

  const int k_end = causal ? min(T, q0 + BQ2) : T;
  const int n_tiles = (k_end + BK2 - 1) / BK2;
  load_tile<E, BQ2, DP>(Qs, q, q0, T, D);
  load_tile<E, BQ2, DP>(dOs, dout, q0, T, D);
  // the ring: tile i in stage i % STAGES, STAGES - 1 tiles in flight ahead
  // of the one in use, one commit group per tile (empty past the last)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) {
      load_tile<E, BK2, DP>(Ks + i * KT, k, i * BK2, T, D);
      load_tile<E, BK2, DP>(Vs + i * KT, v, i * BK2, T, D);
    }
    cp_commit();
  }

  // this warpgroup's q rows, and the two rows of them this thread holds
  const int wq0 = q0 + ROWS * wg;
  const int ra = wq0 + 16 * (t >> 5) + ((t & 31) >> 2);
  const float scale_log2 = scale * LOG2E;
  float row_l2[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    row_l2[h] = lse_log2(r < T ? lse[r] : NEG_INF);
    row_delta[h] = r < T ? delta[r] : 0.f;
  }
  // the k rows this warpgroup sees: none when all its rows are past T
  const int wk_end = wq0 >= T ? 0 : causal ? min(T, wq0 + ROWS) : T;

  float acc[NP][32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = dp[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) acc[p][i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK2;
    const uint32_t kt = Ks + (it % STAGES) * KT;
    const uint32_t vt = Vs + (it % STAGES) * KT;
    {  // later tiles load under this one's products
      const int nt = it + STAGES - 1;
      if (nt < n_tiles) {
        load_tile<E, BK2, DP>(Ks + (nt % STAGES) * KT, k, nt * BK2, T, D);
        load_tile<E, BK2, DP>(Vs + (nt % STAGES) * KT, v, nt * BK2, T, D);
      }
      cp_commit();
      cp_wait<STAGES - 1>();  // tile it has landed
    }
    tiles_ready();

    if (k0 < wk_end) {  // uniform over the warpgroup
      const uint32_t qa = Qs + wg * ROWS * 128;
      const uint32_t da = dOs + wg * ROWS * 128;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(s, desc_k<BQ2>(qa, kk), desc_k<BK2>(kt, kk), kk, E());
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<BQ2>(da, kk), desc_k<BK2>(vt, kk), kk, E());
      wg_commit();
      wg_wait<1>();  // S is in; the exponentials overlap the dP product
      reg_fence(s);

      // only the diagonal and the ragged tiles are masked (s = -inf)
      const bool edge = k0 + BK2 > T || (causal && k0 + BK2 - 1 > wq0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const int col = k0 + 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
        const bool live = !edge || (col < T && (!causal || col <= ra + 8 * h));
        // p = exp(s - lse) is the exact softmax: lse is the forward's row
        // logsumexp, so no renormalization
        s[i] = exp2f(live ? fmaf(s[i], scale_log2, -row_l2[h]) : NEG_INF);
      }
      wg_wait<0>();
      reg_fence(dp);
      uint32_t a[BK2 / 16][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        // the accumulator's (row, column) pairs are the A fragment's
        a[i >> 3][(i >> 1) & 3] =
            pack2(s[i] * (dp[i] - row_delta[h]),
                  s[i + 1] * (dp[i + 1] - row_delta[h]), E());
      }

#pragma unroll
      for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK2 / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs_n64(acc[p], a[kk], desc_mn<BK2>(kt, p, kk), 1, E());
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
    }
    __syncthreads();  // every read of this stage is done before its refill
  }

  // dq_i = scale * sum_j ds_ij k_j
#pragma unroll
  for (int p = 0; p < NP; ++p)
    store_acc<E>(dq, acc[p], wq0, 64 * p, T, D, scale, t);
}

// q rows per tile of the dk/dv pass: 32, so that S^T and dP^T (16
// registers each) fit beside dK and dV in 128 registers at DP = 64, for two
// blocks per SM, and beside dK and dV of 64 registers each at DP = 128 (one
// block per SM)
constexpr int DKV_BQ = 32;

template <int DP>
constexpr int dkv_tc_min_blocks() {
  return DP == 64 ? 2 : 1;
}

template <int DP>
constexpr uint32_t dkv_tc_smem() {
  // K and V tiles of 128 rows, a ring of Q, dO, lse and delta tiles, and
  // 1024 bytes to align the swizzle atoms
  return 2 * (2 * ROWS) * DP * 2 + 2 * STAGES * DKV_BQ * DP * 2 +
         2 * STAGES * DKV_BQ * 4 + 1024;
}

template <typename E, int DP>
__global__ void __launch_bounds__(NTC, dkv_tc_min_blocks<DP>())
flash_bwd_dkv_tc_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const E* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, E* __restrict__ dk,
                        E* __restrict__ dv, int T, int D, float scale,
                        int causal) {
  constexpr int BK2 = 2 * ROWS;      // k rows per block, 64 per warpgroup
  constexpr int BQ2 = DKV_BQ;        // q rows per tile
  constexpr int NS = BQ2 / 2;        // registers of an m64 x BQ2 accumulator
  constexpr uint32_t KT = BK2 * DP * 2;
  constexpr uint32_t QT = BQ2 * DP * 2;
  constexpr int NP = DP / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t Ks = (raw + 1023) & ~1023u;
  const uint32_t Vs = Ks + KT;
  const uint32_t Qs = Vs + KT;                // STAGES tiles
  const uint32_t dOs = Qs + STAGES * QT;      // STAGES tiles
  const uint32_t Ls = dOs + STAGES * QT;      // STAGES rows of BQ2 lse
  const uint32_t Dl = Ls + STAGES * BQ2 * 4;  // STAGES rows of BQ2 delta
  const unsigned char* generic = smem_raw + (Ks - raw);

  const int wg = threadIdx.x / WG;
  const int t = threadIdx.x % WG;
  const int nk = (T + BK2 - 1) / BK2;
  const int64_t bh = blockIdx.x / nk;
  // heaviest causal tiles (the first k rows) are scheduled first
  const int k0 = static_cast<int>(blockIdx.x % nk) * BK2;
  const int64_t base = bh * static_cast<int64_t>(T) * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dk += base;
  dv += base;
  lse += bh * T;
  delta += bh * T;

  // causal: q rows before k0 see none of these keys (k0 is a multiple of BQ2)
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (T - q_begin + BQ2 - 1) / BQ2;
  load_tile<E, BK2, DP>(Ks, k, k0, T, D);
  load_tile<E, BK2, DP>(Vs, v, k0, T, D);
  // the ring: tile i in stage i % STAGES, STAGES - 1 tiles in flight ahead
  // of the one in use, one commit group per tile (empty past the last)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) {
      const int r0 = q_begin + i * BQ2;
      load_tile<E, BQ2, DP>(Qs + i * QT, q, r0, T, D);
      load_tile<E, BQ2, DP>(dOs + i * QT, dout, r0, T, D);
      load_vec(Ls + i * BQ2 * 4, lse, r0, T, BQ2);
      load_vec(Dl + i * BQ2 * 4, delta, r0, T, BQ2);
    }
    cp_commit();
  }

  const int wk0 = k0 + ROWS * wg;  // this warpgroup's first k row
  const int ka = wk0 + 16 * (t >> 5) + ((t & 31) >> 2);
  const float scale_log2 = scale * LOG2E;

  float dk_acc[NP][32], dv_acc[NP][32], st[NS], dpt[NS];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int p = 0; p < NP; ++p) dk_acc[p][i] = dv_acc[p][i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) st[i] = dpt[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * BQ2;
    const int stage = it % STAGES;
    const uint32_t qt = Qs + stage * QT;
    const uint32_t dot = dOs + stage * QT;
    {  // later tiles load under this one's products
      const int nt = it + STAGES - 1;
      if (nt < n_tiles) {
        const int ns = nt % STAGES;
        const int r0 = q_begin + nt * BQ2;
        load_tile<E, BQ2, DP>(Qs + ns * QT, q, r0, T, D);
        load_tile<E, BQ2, DP>(dOs + ns * QT, dout, r0, T, D);
        load_vec(Ls + ns * BQ2 * 4, lse, r0, T, BQ2);
        load_vec(Dl + ns * BQ2 * 4, delta, r0, T, BQ2);
      }
      cp_commit();
      cp_wait<STAGES - 1>();  // tile it has landed
    }
    tiles_ready();

    // live for this warpgroup unless all its k rows are past T or (causal)
    // after every q row of the tile; uniform over the warpgroup
    if (wk0 < T && !(causal && q0 + BQ2 - 1 < wk0)) {
      const uint32_t ka_tile = Ks + wg * ROWS * 128;
      const uint32_t va_tile = Vs + wg * ROWS * 128;
      wg_fence();
      // transposed scores: st = K . Q^T, dpt = V . dO^T (k rows by q columns)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n32(st, desc_k<BK2>(ka_tile, kk), desc_k<BQ2>(qt, kk), kk,
                     E());
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n32(dpt, desc_k<BK2>(va_tile, kk), desc_k<BQ2>(dot, kk), kk,
                     E());
      wg_commit();
      wg_wait<1>();  // S^T is in; the exponentials overlap the dP^T product
      reg_fence(st);

      const bool edge = q0 + BQ2 > T || wk0 + ROWS > T ||
                        (causal && q0 < wk0 + ROWS - 1);
      const float* lrow = reinterpret_cast<const float*>(
          generic + (Ls - Ks) + stage * BQ2 * 4);
      const float* drow = reinterpret_cast<const float*>(
          generic + (Dl - Ks) + stage * BQ2 * 4);
      uint32_t pa[BQ2 / 16][4], sa[BQ2 / 16][4];
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int kr = ka + 8 * ((i >> 1) & 1);
        const int qc = 8 * (i >> 2) + 2 * (t & 3);  // column in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + qc);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qr = q0 + qc + e;
          const bool live =
              !edge || (qr < T && kr < T && (!causal || kr <= qr));
          st[i + e] = exp2f(live ? fmaf(st[i + e], scale_log2,
                                        -lse_log2(e ? l2.y : l2.x))
                                 : NEG_INF);
        }
        pa[i >> 3][(i >> 1) & 3] = pack2(st[i], st[i + 1], E());
      }
      wg_wait<0>();
      reg_fence(dpt);
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(drow + 8 * (i >> 2) + 2 * (t & 3));
        sa[i >> 3][(i >> 1) & 3] = pack2(st[i] * (dpt[i] - d2.x),
                                         st[i + 1] * (dpt[i + 1] - d2.y), E());
      }

#pragma unroll
      for (int p = 0; p < NP; ++p) {
        reg_fence(dv_acc[p]);
        reg_fence(dk_acc[p]);
      }
      wg_fence();
      // dv_j += sum_i p_ij do_i ; dk_j += sum_i ds_ij q_i
#pragma unroll
      for (int kk = 0; kk < BQ2 / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          wgmma_rs_n64(dv_acc[p], pa[kk], desc_mn<BQ2>(dot, p, kk), 1, E());
          wgmma_rs_n64(dk_acc[p], sa[kk], desc_mn<BQ2>(qt, p, kk), 1, E());
        }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        reg_fence(dv_acc[p]);
        reg_fence(dk_acc[p]);
      }
    }
    __syncthreads();  // every read of this stage is done before its refill
  }

  // dk_j = scale * sum_i ds_ij q_i (the scale once, at the store)
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    store_acc<E>(dk, dk_acc[p], wk0, 64 * p, T, D, scale, t);
    store_acc<E>(dv, dv_acc[p], wk0, 64 * p, T, D, 1.f, t);
  }
}

// The forward's ring of K and V tiles: deep enough that the tile after
// the current one has landed while the current one's softmax runs (tile
// it + STAGES - 1 loads once tile it - 1's P.V is done). Its blocks per SM:
// three at DP = 64 (170 registers a thread), two at DP = 128.
template <int DP>
__host__ __device__ constexpr int fwd_stages() {
  return DP == 64 ? 4 : 3;
}

template <int DP>
constexpr int fwd_tc_min_blocks() {
  return DP == 64 ? 3 : 2;
}

template <int DP>
constexpr uint32_t fwd_tc_smem() {
  // a Q tile of 64 rows, the ring of K and V tiles of 64 rows, and 1024
  // bytes to align the swizzle atoms
  return ROWS * DP * 2 + 2 * fwd_stages<DP>() * 64 * DP * 2 + 1024;
}

constexpr float LN2 = 0.6931471805599453f;

// 2^x by one MUFU.EX2, a result below 2^-126 flushed to zero (exp2f adds
// three instructions to keep it denormal). A p that small is below any
// contribution to a row whose largest p is 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// o, lse <- attention(q, k, v) on the tensor cores. A block is one
// warpgroup and its 64 q rows. Per k tile, S = Q.K^T by wgmma from shared
// memory; the online softmax in registers, in log2 units (m is the running
// max of S * scale * log2(e), p = exp2(that - m)); P packed in place to the
// register A operand of O += P.V, V read MN-major. The products are
// software-pipelined against the softmax: S of the next tile and P.V of
// the previous one run on the tensor cores while this tile's softmax runs
// on the CUDA cores (two S accumulators, used in turn).
template <typename E, int DP>
__global__ void __launch_bounds__(WG, fwd_tc_min_blocks<DP>())
flash_fwd_tc_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, E* __restrict__ o,
                    float* __restrict__ lse, int T, int D, float scale,
                    int causal) {
  constexpr int BK2 = 64;                // k rows per tile
  constexpr int NS = fwd_stages<DP>();   // stages of the ring
  constexpr uint32_t QT = ROWS * DP * 2;  // bytes of the q tile
  constexpr uint32_t KT = BK2 * DP * 2;   // bytes of a k-side tile
  constexpr int NP = DP / 64;             // 64-column panels of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Ks = Qs + QT;          // NS tiles
  const uint32_t Vs = Ks + NS * KT;     // NS tiles

  const int t = threadIdx.x;
  const int nq = (T + ROWS - 1) / ROWS;
  const int64_t bh = blockIdx.x / nq;
  // heaviest causal tiles (the last q rows) are scheduled first
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * ROWS;
  const int64_t base = bh * static_cast<int64_t>(T) * D;
  q += base;
  k += base;
  v += base;
  o += base;
  lse += bh * T;

  const int k_end = causal ? min(T, q0 + ROWS) : T;
  const int n_tiles = (k_end + BK2 - 1) / BK2;
  auto load_kv = [&](int i) {  // tile i into stage i % NS, one commit group
    if (i < n_tiles) {
      load_tile<E, BK2, DP, WG>(Ks + (i % NS) * KT, k, i * BK2, T, D);
      load_tile<E, BK2, DP, WG>(Vs + (i % NS) * KT, v, i * BK2, T, D);
    }
    cp_commit();
  };
  load_tile<E, ROWS, DP, WG>(Qs, q, q0, T, D);
  // NS - 1 tiles in flight before the first product (Q in tile 0's group)
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) load_kv(i);

  // the two rows of the block's q rows this thread holds
  const int ra = q0 + 16 * (t >> 5) + ((t & 31) >> 2);
  const float scale_log2 = scale * LOG2E;

  // m: the running row max in log2 units; l: this thread's share of the
  // row sum (its 16 columns of each tile), summed over the row's four
  // lanes at the end
  float acc[NP][32], s0[32], s1[32], m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int p = 0; p < NP; ++p) acc[p][i] = 0.f;
  }

  // S of tile i into s (scale_d 0: no need to clear s)
  auto issue_s = [&](float (&s)[32], int i) {
    const uint32_t kt = Ks + (i % NS) * KT;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(s, desc_k<ROWS>(Qs, kk), desc_k<BK2>(kt, kk), kk, E());
    wg_commit();
  };

  cp_wait<NS - 2>();  // tile 0 (and Q) has landed
  tiles_ready();
  if (n_tiles > 0) {
    issue_s(s0, 0);
    wg_wait<0>();
    reg_fence(s0);
  }

  // One tile: sc holds its S; S of the next tile goes into sn.
  auto step = [&](float (&sc)[32], float (&sn)[32], int it) {
    const int k0 = it * BK2;
    const bool more = it + 1 < n_tiles;
    if (more) {  // the next tile's S runs under this tile's softmax
      cp_wait<NS - 3>();  // tile it + 1 has landed
      tiles_ready();
      issue_s(sn, it + 1);
    }
    // only the diagonal and the ragged tiles are masked (s = -inf)
    const bool edge = k0 + BK2 > T || (causal && k0 + BK2 - 1 > q0);
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int col = k0 + 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
      const bool live = !edge || (col < T && (!causal || col <= ra + 8 * h));
      sc[i] = live ? sc[i] * scale_log2 : NEG_INF;
      mt[h] = fmaxf(mt[h], sc[i]);
    }
    float corr[2], m_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a row's 64 columns are spread over the four lanes t % 4
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      // the TPU kernel's guards: a row with no live key yet keeps
      // m = -inf, its p are exp2(-inf) = 0 and its corr is 0
      m_safe[h] = m_new == NEG_INF ? 0.f : m_new;
      corr[h] = m[h] == NEG_INF ? 0.f : exp2_ftz(m[h] - m_safe[h]);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = exp2_ftz(sc[i] - m_safe[h]);
      l[h] += sc[i];  // the unrounded p
    }
    // the previous tile's P.V is done (S of the next may still run) ...
    if (more) {
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
    // ... so its stage refills, and O takes this tile's correction
    load_kv(it + NS - 1);
    uint32_t a[BK2 / 16][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      // the accumulator's (row, column) pairs are the A fragment's
      a[i >> 3][(i >> 1) & 3] = pack2(sc[i], sc[i + 1], E());
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= corr[(i >> 1) & 1];
    }
    const uint32_t vt = Vs + (it % NS) * KT;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK2 / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs_n64(acc[p], a[kk], desc_mn<BK2>(vt, p, kk), 1, E());
    wg_commit();
    if (more) {  // the next tile's S is in (P.V may still run)
      wg_wait<1>();
      reg_fence(sn);
    }
  };
  for (int it = 0; it < n_tiles; it += 2) {
    step(s0, s1, it);
    if (it + 1 < n_tiles) step(s1, s0, it + 1);
  }
  wg_wait<0>();
#pragma unroll
  for (int p = 0; p < NP; ++p) reg_fence(acc[p]);

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float lc = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / lc;
    const int r = ra + 8 * h;
    // natural-log lse; a fully masked row keeps -inf (m = -inf)
    if ((t & 3) == 0 && r < T) lse[r] = m[h] * LN2 + logf(lc);
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] *= inv[(i >> 1) & 1];
    store_acc<E>(o, acc[p], q0, 64 * p, T, D, 1.f, t);
  }
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
  if constexpr (std::is_same<E, float>::value) {
    auto kernel = flash_fwd_kernel<E, DP>;
    cudaError_t err = allow_smem(kernel, fwd_smem<DP>(), &ready);
    if (err != cudaSuccess) return err;
    const int64_t blocks = static_cast<int64_t>(a.BH) * ((a.T + BQ - 1) / BQ);
    kernel<<<static_cast<unsigned>(blocks), NT, fwd_smem<DP>(), a.stream>>>(
        static_cast<const E*>(a.q), static_cast<const E*>(a.k),
        static_cast<const E*>(a.v), static_cast<E*>(a.o), a.lse_out, a.T,
        a.D, a.scale, a.causal);
  } else {
    auto kernel = flash_fwd_tc_kernel<E, DP>;
    cudaError_t err = allow_smem(kernel, fwd_tc_smem<DP>(), &ready);
    if (err != cudaSuccess) return err;
    const int64_t blocks =
        static_cast<int64_t>(a.BH) * ((a.T + ROWS - 1) / ROWS);
    kernel<<<static_cast<unsigned>(blocks), WG, fwd_tc_smem<DP>(),
             a.stream>>>(
        static_cast<const E*>(a.q), static_cast<const E*>(a.k),
        static_cast<const E*>(a.v), static_cast<E*>(a.o), a.lse_out, a.T,
        a.D, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename E, int DP>
cudaError_t launch_dq(const Args& a) {
  static bool ready = false;
  if constexpr (std::is_same<E, float>::value) {
    auto kernel = flash_bwd_dq_kernel<E, DP>;
    cudaError_t err = allow_smem(kernel, dq_smem<DP>(), &ready);
    if (err != cudaSuccess) return err;
    const int64_t blocks = static_cast<int64_t>(a.BH) * ((a.T + BQ - 1) / BQ);
    kernel<<<static_cast<unsigned>(blocks), NT, dq_smem<DP>(), a.stream>>>(
        static_cast<const E*>(a.q), static_cast<const E*>(a.k),
        static_cast<const E*>(a.v), static_cast<const E*>(a.dout), a.lse,
        a.delta, static_cast<E*>(a.o), a.T, a.D, a.scale, a.causal);
  } else {
    auto kernel = flash_bwd_dq_tc_kernel<E, DP>;
    cudaError_t err = allow_smem(kernel, dq_tc_smem<DP>(), &ready);
    if (err != cudaSuccess) return err;
    const int64_t blocks =
        static_cast<int64_t>(a.BH) * ((a.T + 2 * ROWS - 1) / (2 * ROWS));
    kernel<<<static_cast<unsigned>(blocks), NTC, dq_tc_smem<DP>(),
             a.stream>>>(
        static_cast<const E*>(a.q), static_cast<const E*>(a.k),
        static_cast<const E*>(a.v), static_cast<const E*>(a.dout), a.lse,
        a.delta, static_cast<E*>(a.o), a.T, a.D, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename E, int DP>
cudaError_t launch_dkv(const Args& a) {
  static bool ready = false;
  if constexpr (std::is_same<E, float>::value) {
    auto kernel = flash_bwd_dkv_kernel<E, DP>;
    cudaError_t err = allow_smem(kernel, dkv_smem<DP>(), &ready);
    if (err != cudaSuccess) return err;
    const int64_t blocks = static_cast<int64_t>(a.BH) * ((a.T + BK - 1) / BK);
    kernel<<<static_cast<unsigned>(blocks), NT, dkv_smem<DP>(), a.stream>>>(
        static_cast<const E*>(a.q), static_cast<const E*>(a.k),
        static_cast<const E*>(a.v), static_cast<const E*>(a.dout), a.lse,
        a.delta, static_cast<E*>(a.o), static_cast<E*>(a.o2), a.T, a.D,
        a.scale, a.causal);
  } else {
    auto kernel = flash_bwd_dkv_tc_kernel<E, DP>;
    cudaError_t err = allow_smem(kernel, dkv_tc_smem<DP>(), &ready);
    if (err != cudaSuccess) return err;
    const int64_t blocks =
        static_cast<int64_t>(a.BH) * ((a.T + 2 * ROWS - 1) / (2 * ROWS));
    kernel<<<static_cast<unsigned>(blocks), NTC, dkv_tc_smem<DP>(),
             a.stream>>>(
        static_cast<const E*>(a.q), static_cast<const E*>(a.k),
        static_cast<const E*>(a.v), static_cast<const E*>(a.dout), a.lse,
        a.delta, static_cast<E*>(a.o), static_cast<E*>(a.o2), a.T, a.D,
        a.scale, a.causal);
  }
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
