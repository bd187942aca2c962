// Fused matmul + epilogue for Hopper (sm_90a), behind a plain C interface
// loaded with ctypes (mxnet_tpu_torch/parallel/fused.py).
//
// Replaces: mxnet_tpu/parallel/fused.py fused_matmul (kernel body
// _mm_kernel) and fused_batch_matmul (kernel body _bmm_kernel). It computes
// out = epilogue(X . W^T) when wt (W is (N, K), the FullyConnected layout)
// or epilogue(X . W) (W is (K, N), a 1x1 HWIO convolution weight),
// accumulated in fp32; the batched entry does the same for each of B
// (X[b], W[b]) pairs, blockIdx.z walking the batch. The whole epilogue runs
// on the accumulator, in grammar order, before the single store of each
// output element, so no interior tensor of a fusion region (the pre-bias,
// pre-activation, pre-residual values) reaches device memory.
//
// Two routes, chosen by the caller from the dtypes, the shape and the
// alignment alone (parallel/fused.py ``route``), never by a tile or a flag;
// a launch names its route and its tile and refuses what the route cannot
// take (the caller raises: no route stands in for another).
//
// * The tensor-core route (fused_matmul_tc_kernel): X and W of one 16-bit
//   type (bf16 or fp16), K a multiple of 8 (and N too when W is (K, N)),
//   16-byte aligned bases and batch strides of a multiple of 8 elements.
// * The CUDA-core route (fused_matmul_kernel): everything else, fp32 first.
//
// Bound: bytes = X (M*K) + W (N*K) + extras (N per vector step, M*N per
// residual step) + out (M*N), each at its element width; operations =
// 2*M*N*K (all times B when batched). On the tensor cores (989 TFLOP/s bf16)
// the served ResNet-50's 1x1 regions under amp (K, N of 64..2048) are bound
// by their bytes (about 300 operations a byte is the ridge); in fp32 on the
// CUDA cores (67 TFLOP/s) the same shapes are bound by operations: the fp32
// product stays in full fp32 (no TF32) to hold parity with the reference.
//
// Tensor-core design: one block per BM x BN output tile ((128, 128),
// (128, 64), (64, 128) or (64, 64): TC_TILES), one consumer warpgroup per
// 64 rows. K is walked in stages of 64 (one 128-byte row of 16-bit
// elements): a ring of STAGES stages (3 at 128 x 128, else 4) of an X tile
// (BM rows x 64) and a W tile (BN x 64 K-major when wt, 64 x BN in 64-column
// panels otherwise), filled by 16-byte cp.async with zero fill past M, N and
// K, straight into the 128-byte swizzle the wgmma descriptors read (as
// csrc/flash_attention.cu loads its tiles). Every thread of the block
// issues copies; STAGES - 1 stages are in flight ahead of the one being
// multiplied, a stage's products run on while the previous stage's are
// waited for and its slot refilled, and two or three blocks share an SM
// (99 or 65 KB each) so one block's barriers run under another's
// products. cp.async rather than TMA:
// the ragged edges, the batched strides and the transposed batch_dot view
// all index as in a plain load, the layout is the one the flash kernels
// already read correctly, and no tensor-map descriptor has to be encoded
// per launch on the host (through the driver entry point) or kept alive in
// a captured CUDA graph. Each stage is 4 k16 steps of one wgmma m64nBNk16
// per warpgroup (bf16 or fp16 in, fp32 accumulators; n128 reads each X
// tile from shared memory half as often as two n64 would), A and B from
// shared memory, B K-major for wt and MN-major otherwise (wgmma's
// transpose bit reads the (K, N) weight and a contiguous batch_dot operand
// in place: no copy). Each output is summed over k in ascending k16 steps
// at the same position of its 64-row, 8-column block whatever the tile,
// and the card gives such an output the same bits at n64 and n128 (held
// by the card tests and chip_smoke.py at every compiled tile), so every
// tile gives the same bits. After the last stage the accumulators pass
// through the ring's shared memory as fp32 rows of BN + 8 (the stride
// keeps each half-warp's 8-byte writes on distinct banks), and every
// thread then runs the epilogue on runs of 4 consecutive columns,
// consecutive threads on consecutive runs (residual reads and output
// stores coalesced), four runs at a time so that four extra loads are in
// flight a thread (read one at a time, the residual regions of the served
// ResNet-50 at bucket 8 took up to 1.4x as long; prefetching them into L1
// instead was slower still). Left out for later work: a producer warp
// with mbarriers (or TMA), the epilogue's extras loaded under the
// products, persistent blocks, clusters; split-K would change the bits.
//
// CUDA-core design: a register-tiled SGEMM, one 256-thread block per BT x
// BT output tile, BT 128 or 64 (the same kernel, a template). What bounds
// an fp32 product on the CUDA cores short of the FMA rate is the issue of
// shared loads beside the FMAs and the latency of the global loads; so each
// thread accumulates a (BT/16) x (BT/16) micro-tile (8 x 8 at BT 128: 64
// FMAs for 4 16-byte shared loads), at rows 64g + 4ty + (0..3) and columns
// 64g + 4tx + (0..3), reading both operands as float4 from k-major shared
// tiles (one warp's X reads a broadcast, its W reads 16 consecutive
// float4). K is walked in slices: each thread fetches runs of 4 consecutive
// elements of X and of W of the next slice into registers, converting to
// fp32, while the current slice is multiplied, then stores them into the
// other of two shared buffers (transposed to k-major where the operand runs
// along K): one barrier per slice. Where both operands are fp32 with
// 16-byte aligned rows (the fp32 training and serving paths), each run is
// one 16-byte load and the slice is 16 deep at BT 128 and 32 at BT 64 (2
// runs per operand and thread: measured faster on the H100 than 8 and 16,
// at 128 registers without spills); otherwise the element types and widths
// are decoded at run time (8-byte loads of bf16/fp16 runs where aligned,
// element by element at a ragged edge) and the slice is 8 and 16 deep (1
// run). Each output is one fp32 FMA chain over k in ascending order, the
// same sums as before the redesign. The epilogue runs after the product,
// RPR = 4096 / BT rows at a time: the accumulators of those rows go through
// the slices' shared memory, and each thread then takes runs of 4
// consecutive columns, consecutive threads on consecutive runs, so residual
// reads and output stores are coalesced 16-byte accesses where the rows
// allow, and the epilogue's code is one loop rather than one copy per
// accumulator (64 unrolled copies of its switch, activations included, cost
// more in instruction fetch than the product's K loop at K 512). BT is a
// launch parameter: the caller names 128 or 64 (a tuned tile, autotune's
// ``fusion.blocks``, or the default rule of autotune/cost_model.py). Each
// output is the same fp32 FMA chain at either tile, so the tile changes the
// time and never a bit of the result. Ragged M, N and K edges are masked:
// zero fill on load, no store outside the output. Element types (fp32,
// bf16, fp16) are runtime codes, uniform across the grid. The batched form
// offsets X, W, out and the residual extras by per-batch element strides;
// the 2-d form is the same kernel with B = 1 and strides 0. A transposed
// batch_dot operand (the view transpose(k, (0, 2, 1)) of a contiguous (B,
// N, K) k) is read in place through the wt form, with no copy (on either
// route).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FM_MAX_STEPS 8

enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

enum {
  ST_VADD = 0,      // y += v[n]        (bias, vadd)
  ST_VMUL = 1,      // y *= v[n]
  ST_RES_ADD = 2,   // y += r[m, n]
  ST_RES_MUL = 3,   // y *= r[m, n]
  ST_RELU = 4,
  ST_SIGMOID = 5,
  ST_TANH = 6,
  ST_SOFTRELU = 7,
  ST_SOFTSIGN = 8,
  ST_MUL_S = 9,     // y * s
  ST_DIV_S = 10,    // y / s
  ST_PLUS_S = 11,   // y + s
  ST_MINUS_S = 12,  // y - s
  ST_RMINUS_S = 13  // s - y
};

// The epilogue, passed by value as a kernel parameter. Its layout is
// mirrored by a ctypes.Structure on the Python side (checked through
// fused_matmul_epilogue_size).
struct FmEpilogue {
  int n_steps;
  int code[FM_MAX_STEPS];
  float scalar[FM_MAX_STEPS];
  int dtype[FM_MAX_STEPS];
  const void* ptr[FM_MAX_STEPS];
};

namespace {

constexpr int NT = 256;  // threads per block, 16 x 16
// Shared tiles of a K slice are k-major rows of BT + 4 fp32 (the 4 keep the
// float4 reads aligned and spread a transposed store over all banks).

__device__ __forceinline__ float load_f(const void* p, int64_t i, int dt) {
  if (dt == DT_F32) return static_cast<const float*>(p)[i];
  if (dt == DT_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ int64_t elem_bytes(int dt) {
  return dt == DT_F32 ? 4 : 2;
}

__device__ __forceinline__ void store_f(void* p, int64_t i, int dt,
                                        float v) {
  if (dt == DT_F32) {
    static_cast<float*>(p)[i] = v;
  } else if (dt == DT_BF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<__half*>(p)[i] = __float2half(v);
  }
}

// The n (0..4) elements p[i..i+n) as fp32 in f, zeros after them: one 16-
// (fp32) or 8-byte (bf16, fp16) load when ``vec`` and n == 4.
__device__ __forceinline__ void load4(float (&f)[4], const void* p,
                                      int64_t i, int n, int dt, bool vec) {
  if (vec && n == 4) {
    if (dt == DT_F32) {
      const float4 u = *reinterpret_cast<const float4*>(
          static_cast<const float*>(p) + i);
      f[0] = u.x;
      f[1] = u.y;
      f[2] = u.z;
      f[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(
          static_cast<const uint16_t*>(p) + i);
      const uint32_t w[2] = {u.x, u.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (dt == DT_BF16) {
          f[2 * e] = __uint_as_float(w[e] << 16);
          f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
        } else {
          f[2 * e] = __half2float(__ushort_as_half(
              static_cast<unsigned short>(w[e] & 0xffffu)));
          f[2 * e + 1] = __half2float(__ushort_as_half(
              static_cast<unsigned short>(w[e] >> 16)));
        }
      }
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = e < n ? load_f(p, i + e, dt) : 0.f;
}

// The epilogue on 4 consecutive outputs of one row, the first ``cnt`` of
// them inside the output: ``mn`` is the first one's offset in a residual
// extra (batch offset included), ``n`` its column (the index into a vector
// extra). Each step is decoded once for the 4 and applied to each in
// grammar order; the extras are read as one vector when ``vec``.
__device__ __forceinline__ void apply_epilogue4(const FmEpilogue& ep,
                                                float (&y)[4], int64_t mn,
                                                int64_t n, int cnt,
                                                bool vec) {
  for (int s = 0; s < ep.n_steps; ++s) {
    const float v = ep.scalar[s];
    const int code = ep.code[s];
    if (code <= ST_RES_MUL) {
      float e[4];
      load4(e, ep.ptr[s], code <= ST_VMUL ? n : mn, cnt, ep.dtype[s], vec);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        y[i] = (code == ST_VADD || code == ST_RES_ADD) ? y[i] + e[i]
                                                       : y[i] * e[i];
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t = y[i];
      switch (code) {
        case ST_RELU: t = t < 0.f ? 0.f : t; break;  // NaN propagates
        case ST_SIGMOID: t = 1.f / (1.f + expf(-t)); break;
        case ST_TANH: t = tanhf(t); break;
        case ST_SOFTRELU: t = fmaxf(t, 0.f) + log1pf(expf(-fabsf(t))); break;
        case ST_SOFTSIGN: t = t / (1.f + fabsf(t)); break;
        case ST_MUL_S: t = t * v; break;
        case ST_DIV_S: t = t / v; break;
        case ST_PLUS_S: t = t + v; break;
        case ST_MINUS_S: t = t - v; break;
        case ST_RMINUS_S: t = v - t; break;
        default: break;
      }
      y[i] = t;
    }
  }
}

// Store the first ``cnt`` of 4 consecutive outputs, each rounded once to
// the output type: one 16- (fp32) or 8-byte (bf16, fp16) store when
// ``vec`` and cnt == 4.
__device__ __forceinline__ void store4(void* p, int64_t i, int dt,
                                       const float (&y)[4], int cnt,
                                       bool vec) {
  if (vec && cnt == 4) {
    if (dt == DT_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
          make_float4(y[0], y[1], y[2], y[3]);
    } else if (dt == DT_BF16) {
      __nv_bfloat162 a = __floats2bfloat162_rn(y[0], y[1]);
      __nv_bfloat162 b = __floats2bfloat162_rn(y[2], y[3]);
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(p) + i) =
          make_uint2(*reinterpret_cast<uint32_t*>(&a),
                     *reinterpret_cast<uint32_t*>(&b));
    } else {
      __half2 a = __floats2half2_rn(y[0], y[1]);
      __half2 b = __floats2half2_rn(y[2], y[3]);
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(p) + i) =
          make_uint2(*reinterpret_cast<uint32_t*>(&a),
                     *reinterpret_cast<uint32_t*>(&b));
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < cnt) store_f(p, i + e, dt, y[e]);
}

// 16 bytes of fp32 at element i of p where ``ok``, else zeros
__device__ __forceinline__ void load_f4(float (&f)[4], const void* p,
                                       int64_t i, bool ok) {
  float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok)
    u = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

// One K slice (BKT deep) of a BT x BT output tile in flight from global
// memory to shared memory: each thread holds NV runs of 4 consecutive
// elements of X (along K) and NV of W (along K when wt, along N otherwise),
// converted to fp32 as they arrive, in registers while the previous slice
// is multiplied. F32V: both operands fp32 with rows of a multiple of 4
// elements from a 16-byte aligned start, so each run is one 16-byte load
// or none (a ragged edge is then whole runs); otherwise element types and
// widths are decoded at run time.
template <int BT, int BKT, bool F32V>
struct SliceLoad {
  static constexpr int LDS = BT + 4;
  static constexpr int NV = BT * BKT / (4 * NT);  // runs per operand
  static_assert(NV >= 1 && BT * BKT % (4 * NT) == 0, "runs split evenly");
  float a[NV][4], b[NV][4];

  // run v of X (and of W when wt): row idx / (BKT / 4), k (idx % (BKT/4))
  // * 4, idx = tid + v * NT; of W (K, N): row idx / (BT / 4), columns
  // (idx % (BT / 4)) * 4
  __device__ __forceinline__ void fetch(const void* x, const void* w, int M,
                                        int N, int K, int m0, int n0, int k0,
                                        int x_dt, int w_dt, bool vx, bool vw,
                                        int wt) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int idx = threadIdx.x + v * NT;
      const int r = idx / (BKT / 4), kk = k0 + (idx % (BKT / 4)) * 4;
      const int k = k0 + idx / (BT / 4), n = n0 + (idx % (BT / 4)) * 4;
      if constexpr (F32V) {
        load_f4(a[v], x, (int64_t)(m0 + r) * K + kk, m0 + r < M && kk < K);
        if (wt)
          load_f4(b[v], w, (int64_t)(n0 + r) * K + kk, n0 + r < N && kk < K);
        else
          load_f4(b[v], w, (int64_t)k * N + n, k < K && n < N);
      } else {
        const int kn = max(0, min(4, K - kk));
        load4(a[v], x, (int64_t)(m0 + r) * K + kk, m0 + r < M ? kn : 0,
              x_dt, vx);
        if (wt)
          load4(b[v], w, (int64_t)(n0 + r) * K + kk, n0 + r < N ? kn : 0,
                w_dt, vw);
        else
          load4(b[v], w, (int64_t)k * N + n,
                k < K ? max(0, min(4, N - n)) : 0, w_dt, vw);
      }
    }
  }

  __device__ __forceinline__ void stage(float (*As)[LDS], float (*Bs)[LDS],
                                        int wt) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int idx = threadIdx.x + v * NT;
      const int r = idx / (BKT / 4), kk = (idx % (BKT / 4)) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) As[kk + e][r] = a[v][e];
      if (wt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) Bs[kk + e][r] = b[v][e];
      } else {
        *reinterpret_cast<float4*>(&Bs[idx / (BT / 4)][(idx % (BT / 4)) * 4]) =
            make_float4(b[v][0], b[v][1], b[v][2], b[v][3]);
      }
    }
  }
};

// One BT x BT output tile per 256-thread block; thread (ty, tx) owns rows
// 64g + 4ty + (0..3) and columns 64g + 4tx + (0..3), g < BT / 64.
template <int BT, int BKT, bool F32V>
__global__ void __launch_bounds__(NT)
fused_matmul_kernel(const void* __restrict__ x, const void* __restrict__ w,
                    void* __restrict__ out, int M, int N, int K,
                    int64_t x_bs, int64_t w_bs, int x_dt, int w_dt,
                    int out_dt, int wt, int vx, int vw, int vo,
                    FmEpilogue ep) {
  constexpr int LDS = SliceLoad<BT, BKT, F32V>::LDS;
  constexpr int TMN = BT / 16;  // rows (and columns) per thread
  // the two buffers of X and W slices; after the product, the output tile
  // passes through the same memory in rounds of RPR rows
  constexpr int RPR = 4096 / BT;
  static_assert(4 * BKT * LDS >= RPR * BT, "an output round must fit");
  __shared__ __align__(16) float smem[4 * BKT * LDS];
  float(*As)[BKT][LDS] = reinterpret_cast<float(*)[BKT][LDS]>(smem);
  float(*Bs)[BKT][LDS] =
      reinterpret_cast<float(*)[BKT][LDS]>(smem + 2 * BKT * LDS);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BT;
  const int n0 = blockIdx.y * BT;
  // this block's batch: X and W move by their strides, the output by M*N
  // (it is contiguous (B, M, N)); the base pointers move once here so the
  // tile loads index as in the 2-d form. The residual extras are indexed
  // with the batch offset o_off (each has its own element type).
  const int64_t b = blockIdx.z;
  const int64_t o_off = b * (int64_t)M * N;
  x = static_cast<const char*>(x) + b * x_bs * elem_bytes(x_dt);
  w = static_cast<const char*>(w) + b * w_bs * elem_bytes(w_dt);
  out = static_cast<char*>(out) + o_off * elem_bytes(out_dt);

  float acc[TMN][TMN];
#pragma unroll
  for (int i = 0; i < TMN; ++i)
#pragma unroll
    for (int j = 0; j < TMN; ++j) acc[i][j] = 0.f;

  SliceLoad<BT, BKT, F32V> in;
  in.fetch(x, w, M, N, K, m0, n0, 0, x_dt, w_dt, vx, vw, wt);
  in.stage(As[0], Bs[0], wt);
  __syncthreads();
  const int n_slices = (K + BKT - 1) / BKT;
  for (int s = 0; s < n_slices; ++s) {
    const int cur = s & 1;
    // the next slice loads under this one's products
    if (s + 1 < n_slices)
      in.fetch(x, w, M, N, K, m0, n0, (s + 1) * BKT, x_dt, w_dt, vx, vw, wt);
#pragma unroll
    for (int kk = 0; kk < BKT; ++kk) {
      float a[TMN], bv[TMN];
#pragma unroll
      for (int g = 0; g < TMN / 4; ++g) {
        const float4 va =
            *reinterpret_cast<const float4*>(&As[cur][kk][64 * g + 4 * ty]);
        const float4 vb =
            *reinterpret_cast<const float4*>(&Bs[cur][kk][64 * g + 4 * tx]);
        a[4 * g] = va.x;
        a[4 * g + 1] = va.y;
        a[4 * g + 2] = va.z;
        a[4 * g + 3] = va.w;
        bv[4 * g] = vb.x;
        bv[4 * g + 1] = vb.y;
        bv[4 * g + 2] = vb.z;
        bv[4 * g + 3] = vb.w;
      }
#pragma unroll
      for (int i = 0; i < TMN; ++i)
#pragma unroll
        for (int j = 0; j < TMN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (s + 1 < n_slices) in.stage(As[cur ^ 1], Bs[cur ^ 1], wt);
    __syncthreads();
  }

  // The epilogue and the stores, RPR rows at a time: the threads holding
  // those rows write them to shared memory, then every thread takes runs
  // of 4 consecutive columns, consecutive threads on consecutive runs, so
  // residual reads and output stores are coalesced and the epilogue's code
  // exists once (a loop, not unrolled over the accumulators).
#pragma unroll
  for (int rd = 0; rd < BT / RPR; ++rd) {
    __syncthreads();  // the products' (or the last round's) reads are done
#pragma unroll
    for (int i = 0; i < TMN; ++i) {
      const int r = 64 * (i / 4) + 4 * ty + i % 4;
      if (r / RPR != rd) continue;
#pragma unroll
      for (int g = 0; g < TMN / 4; ++g)
        *reinterpret_cast<float4*>(&smem[(r % RPR) * BT + 64 * g + 4 * tx]) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
    }
    __syncthreads();
#pragma unroll 1
    for (int e = 4 * tid; e < RPR * BT; e += 4 * NT) {
      const int m = m0 + rd * RPR + e / BT, n = n0 + e % BT;
      if (m >= M || n >= N) continue;
      const float4 v = *reinterpret_cast<const float4*>(&smem[e]);
      float y[4] = {v.x, v.y, v.z, v.w};
      const int64_t mn = (int64_t)m * N + n;
      const int cnt = min(4, N - n);
      apply_epilogue4(ep, y, o_off + mn, n, cnt, vo);
      store4(out, mn, out_dt, y, cnt, vo);
    }
  }
}

// ------------------------------------------ tensor-core route (16-bit)

constexpr int WG = 128;    // threads of a warpgroup
constexpr int TC_BK = 64;  // K depth of a stage: one 128-byte swizzle row

// wgmma m64nNk16 (N 64 or 128) with fp32 accumulators, one set per 16-bit
// input type E: A and B from shared memory through descriptors, A K-major,
// B K-major (TB 0) or MN-major (TB 1, the transpose bit); the products add
// to d. The accumulator of 8-column block c of the N columns is registers
// 4c..4c+3 at either width, so an m64n128 accumulator is two m64n64 ones
// side by side.
#define FM_WGMMA(TY, E)                                                        \
  template <int TB>                                                            \
  __device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,       \
                                            uint64_t db, E) {                  \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"           \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
        "%28, %29, %30, %31"                                                   \
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"                                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
          "+f"(d[30]), "+f"(d[31])                                             \
        : "l"(da), "l"(db), "r"(1), "n"(TB));                                  \
  }                                                                            \
  template <int TB>                                                            \
  __device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,      \
                                             uint64_t db, E) {                 \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"          \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                     \
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"                                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
        : "l"(da), "l"(db), "r"(1), "n"(TB));                                  \
  }

FM_WGMMA("bf16", __nv_bfloat16)
FM_WGMMA("f16", __half)
#undef FM_WGMMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A tile of R rows x 64 16-bit elements is R rows of 128 bytes, each
// 1024-byte group of 8 rows one 128-byte swizzle atom: the 16-byte chunk c
// of row r sits at r * 128 + ((c ^ (r & 7)) << 4). A (BN K-rows x 64)
// MN-major W tile is BN / 64 such panels of 64 rows, 8192 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);  // 128-byte swizzle
}

// K-major, k16 step kk: 32 bytes into the atom rows; 8-row groups 1024
// bytes apart (SBO); LBO is unused with a swizzle this wide
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return wgmma_desc(tile + kk * 32, 16, 1024);
}

// MN-major, K rows 16kk..16kk+15 of the tile's 64-row panels, their
// columns as N: K's 8-row groups 1024 bytes apart (SBO), the 64-column
// panels 8192 apart (LBO)
__device__ __forceinline__ uint64_t desc_mn(uint32_t panel, int kk) {
  return wgmma_desc(panel + kk * 2048, 64 * 128, 1024);
}

__device__ __forceinline__ void cp16(uint32_t dst, const uint16_t* src,
                                     bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// keeps the compiler from moving accumulator accesses across the
// asynchronous products (before a fence, after a wait)
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// rows r0.. (R of them) of a row-major (rows, K) matrix, columns k0..k0+63,
// into a K-major tile by the NTH threads of the block; chunks past ``rows``
// or K are zeros (K is a multiple of 8: a chunk is whole or absent)
template <int R, int NTH>
__device__ __forceinline__ void load_k(uint32_t tile, const uint16_t* src,
                                       int r0, int rows, int K, int k0) {
  static_assert(R * 8 % NTH == 0, "tile chunks must split evenly");
#pragma unroll
  for (int n = 0; n < R * 8 / NTH; ++n) {
    const int idx = threadIdx.x + n * NTH;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = r0 + r < rows && k0 + c * 8 < K;
    cp16(tile + r * 128 + ((c ^ (r & 7)) << 4),
         ok ? src + (int64_t)(r0 + r) * K + k0 + c * 8 : src, ok);
  }
}

// rows k0..k0+63 of a row-major (K, N) matrix, columns n0..n0+BN-1, into
// BN / 64 MN-major panels; chunks past K or N are zeros (N is a multiple
// of 8)
template <int BN, int NTH>
__device__ __forceinline__ void load_mn(uint32_t tile, const uint16_t* src,
                                        int k0, int K, int n0, int N) {
  constexpr int CPR = BN / 8;  // 16-byte chunks of a row
  static_assert(TC_BK * CPR % NTH == 0, "tile chunks must split evenly");
#pragma unroll
  for (int n = 0; n < TC_BK * CPR / NTH; ++n) {
    const int idx = threadIdx.x + n * NTH;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = k0 + r < K && n0 + c * 8 < N;
    cp16(tile + (c >> 3) * TC_BK * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4),
         ok ? src + (int64_t)(k0 + r) * N + n0 + c * 8 : src, ok);
  }
}

// Stages of the ring of a BM x BN tile, 3 at 128 x 128, else 4, so that two
// or three blocks share an SM, and its dynamic shared memory: the ring and
// 1024 bytes to align the swizzle atoms. The output tile passes through the
// ring's memory as fp32 rows of BN + 8. (A deeper ring for grids smaller
// than the card, 6 to 12 stages in 192 KB, measured slower on the H100 at
// the served ResNet-50's bucket-1 shapes.)
__host__ __device__ constexpr int tc_stages(int bm, int bn) {
  return bm * bn >= 128 * 128 ? 3 : 4;
}
__host__ __device__ constexpr int tc_smem(int bm, int bn) {
  return tc_stages(bm, bn) * (bm + bn) * 128 + 1024;
}

// An activation or scalar step (``code`` above ST_RES_MUL, scalar ``v``)
// on one fp32 value: apply_epilogue4's switch, which the CUDA-core route
// keeps inline as it was.
__device__ __forceinline__ float epilogue_op(int code, float v, float t) {
  switch (code) {
    case ST_RELU: return t < 0.f ? 0.f : t;  // NaN propagates
    case ST_SIGMOID: return 1.f / (1.f + expf(-t));
    case ST_TANH: return tanhf(t);
    case ST_SOFTRELU: return fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)));
    case ST_SOFTSIGN: return t / (1.f + fabsf(t));
    case ST_MUL_S: return t * v;
    case ST_DIV_S: return t / v;
    case ST_PLUS_S: return t + v;
    case ST_MINUS_S: return t - v;
    case ST_RMINUS_S: return v - t;
    default: return t;
  }
}

// The epilogue on U runs of 4 consecutive outputs of one thread (run u:
// ``mn[u]`` its first output's offset in a residual extra, ``n[u]`` its
// column, the first ``cnt[u]`` inside the output; 0 for a run past it), in
// grammar order. Each step that reads an extra issues the U runs' loads
// before it decodes any, so U loads are in flight a thread.
template <int U>
__device__ __forceinline__ void apply_epilogue_runs(
    const FmEpilogue& ep, float (&y)[U][4], const int64_t (&mn)[U],
    const int64_t (&n)[U], const int (&cnt)[U], bool vec) {
  for (int s = 0; s < ep.n_steps; ++s) {
    const float v = ep.scalar[s];
    const int code = ep.code[s];
    if (code > ST_RES_MUL) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) y[u][k] = epilogue_op(code, v, y[u][k]);
      continue;
    }
    const void* p = ep.ptr[s];
    const int dt = ep.dtype[s];
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = code <= ST_VMUL ? n[u] : mn[u];
      raw[u] = make_uint4(0, 0, 0, 0);
      if (vec && cnt[u] == 4) {
        if (dt == DT_F32) {
          raw[u] =
              *reinterpret_cast<const uint4*>(static_cast<const float*>(p) + i);
        } else {
          const uint2 h = *reinterpret_cast<const uint2*>(
              static_cast<const uint16_t*>(p) + i);
          raw[u] = make_uint4(h.x, h.y, 0, 0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float e[4];
      if (vec && cnt[u] == 4) {
        if (dt == DT_F32) {
          e[0] = __uint_as_float(raw[u].x);
          e[1] = __uint_as_float(raw[u].y);
          e[2] = __uint_as_float(raw[u].z);
          e[3] = __uint_as_float(raw[u].w);
        } else {
          const uint32_t w2[2] = {raw[u].x, raw[u].y};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (dt == DT_BF16) {
              e[2 * h] = __uint_as_float(w2[h] << 16);
              e[2 * h + 1] = __uint_as_float(w2[h] & 0xffff0000u);
            } else {
              e[2 * h] = __half2float(__ushort_as_half(
                  static_cast<unsigned short>(w2[h] & 0xffffu)));
              e[2 * h + 1] = __half2float(__ushort_as_half(
                  static_cast<unsigned short>(w2[h] >> 16)));
            }
          }
        }
      } else {
        load4(e, p, code <= ST_VMUL ? n[u] : mn[u], cnt[u], dt, false);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        y[u][k] = (code == ST_VADD || code == ST_RES_ADD) ? y[u][k] + e[k]
                                                         : y[u][k] * e[k];
    }
  }
}

// One BM x BN output tile per block of BM / 64 warpgroups; warpgroup g owns
// rows 64g..64g+63 and all BN columns: one m64nBN accumulator.
template <typename E, int BM, int BN, int S, bool WT>
__global__ void __launch_bounds__(BM / 64 * WG, 2)
fused_matmul_tc_kernel(const uint16_t* __restrict__ x,
                       const uint16_t* __restrict__ w, void* __restrict__ out,
                       int M, int N, int K, int64_t x_bs, int64_t w_bs,
                       int out_dt, int vo, FmEpilogue ep) {
  constexpr int NTH = BM / 64 * WG;
  constexpr uint32_t AT = BM * 128, BTB = BN * 128;  // bytes of a stage's tiles
  constexpr int LDO = BN + 8;
  static_assert(BM * LDO * 4 <= S * (AT + BTB), "the output tile must fit");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t As = (raw + 1023) & ~1023u;
  const uint32_t Bs = As + S * AT;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int64_t b = blockIdx.z;
  const int64_t o_off = b * (int64_t)M * N;
  x += b * x_bs;
  w += b * w_bs;
  out = static_cast<char*>(out) + o_off * elem_bytes(out_dt);
  const int g = threadIdx.x / WG, t = threadIdx.x % WG;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  const int nk = (K + TC_BK - 1) / TC_BK;
  auto load = [&](int slot, int kt) {
    const int k0 = kt * TC_BK;
    load_k<BM, NTH>(As + slot * AT, x, m0, M, K, k0);
    if constexpr (WT)
      load_k<BN, NTH>(Bs + slot * BTB, w, n0, N, K, k0);
    else
      load_mn<BN, NTH>(Bs + slot * BTB, w, k0, K, n0, N);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<S - 2>();  // this thread's copies of stage kt have landed
    // made visible to wgmma's reads (the async proxy), then to the block
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int slot = kt % S;
    const uint32_t a = As + slot * AT + g * 64 * 128;
    const uint32_t bt = Bs + slot * BTB;
    reg_fence(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint64_t db = WT ? desc_k(bt, kk) : desc_mn(bt, kk);
      if constexpr (BN == 128)
        wgmma_n128<WT ? 0 : 1>(acc, desc_k(a, kk), db, E());
      else
        wgmma_n64<WT ? 0 : 1>(acc, desc_k(a, kk), db, E());
    }
    wg_commit();
    reg_fence(acc);
    // stage kt's products run on while stage kt - 1's are waited for, by
    // every warpgroup; then its slot takes stage kt + S - 1
    wg_wait<1>();
    __syncthreads();
    if (kt + S - 1 < nk) load((kt + S - 1) % S, kt + S - 1);
    cp_commit();
  }
  wg_wait<0>();
  reg_fence(acc);

  // The accumulator through shared memory: thread t of warpgroup g holds,
  // for each 8-column block c8, rows 64g + 16 (t / 32) + (t % 32) / 4
  // (registers 4c8, 4c8 + 1) and 8 below it (4c8 + 2, 4c8 + 3), columns
  // 8c8 + 2 (t % 4) + (0, 1).
  cp_wait<0>();
  __syncthreads();  // every warpgroup is done reading the ring
  float* stage = reinterpret_cast<float*>(smem_raw + (As - raw));
  const int r0 = 64 * g + 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
  for (int c8 = 0; c8 < BN / 8; ++c8) {
    const int c = 8 * c8 + 2 * (t & 3);
    *reinterpret_cast<float2*>(&stage[r0 * LDO + c]) =
        make_float2(acc[4 * c8], acc[4 * c8 + 1]);
    *reinterpret_cast<float2*>(&stage[(r0 + 8) * LDO + c]) =
        make_float2(acc[4 * c8 + 2], acc[4 * c8 + 3]);
  }
  __syncthreads();
  // the epilogue and the stores: runs of 4 consecutive columns,
  // consecutive threads on consecutive runs, U runs of a thread at a time
  // (their extras' loads in flight together)
  constexpr int U = 4;
  static_assert(BM * BN % (4 * NTH * U) == 0, "runs must split evenly");
#pragma unroll 1
  for (int e0 = 4 * threadIdx.x; e0 < BM * BN; e0 += 4 * NTH * U) {
    float y[U][4];
    int64_t res[U], n[U];
    int cnt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * 4 * NTH;
      const int r = e / BN, c = e % BN;
      const int m = m0 + r;
      n[u] = n0 + c;
      res[u] = o_off + (int64_t)m * N + n[u];
      cnt[u] = m < M && n[u] < N ? min(4, N - (int)n[u]) : 0;
      const float4 v = *reinterpret_cast<const float4*>(&stage[r * LDO + c]);
      y[u][0] = v.x;
      y[u][1] = v.y;
      y[u][2] = v.z;
      y[u][3] = v.w;
    }
    apply_epilogue_runs<U>(ep, y, res, n, cnt, vo);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (cnt[u]) store4(out, res[u] - o_off, out_dt, y[u], cnt[u], vo);
  }
}

// a 16-byte (fp32) or 8-byte (16-bit) vector of 4 elements at every element
// offset that is a multiple of 4 from ``p``: ``row`` and ``batch`` strides
// multiples of 4, ``p`` aligned to 4 elements
bool vec_ok(const void* p, int dt, int64_t row, int64_t batch) {
  const int64_t bytes = dt == DT_F32 ? 16 : 8;
  return row % 4 == 0 && batch % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the output and every extra read in runs of 4 (vectors by column,
// residuals by row and batch, as the output)
int epilogue_vec(const void* out, int out_dt, int M, int N,
                 const FmEpilogue* ep) {
  int vo = vec_ok(out, out_dt, N, (int64_t)M * N);
  for (int s = 0; s < ep->n_steps; ++s)
    if (ep->code[s] <= ST_RES_MUL)
      vo = vo && vec_ok(ep->ptr[s], ep->dtype[s], N, (int64_t)M * N);
  return vo;
}

// The CUDA-core route's compiled tiles, one row each: the output tile edge
// BT and the K-slice depth of each of its forms (fp32 operands in 16-byte
// runs / any other).
constexpr int TILES[][3] = {{128, 16, 8}, {64, 32, 16}};
constexpr int N_TILES = sizeof(TILES) / sizeof(TILES[0]);
// The tensor-core route's: (BM, BN, the K depth of a stage). The first row
// is the largest; each row's shared memory is tc_smem(BM, BN). Python reads
// both tables (fused_matmul_tiles), so the tuner's space and the kernel's
// instantiations cannot drift apart.
constexpr int TC_TILES[][3] = {
    {128, 128, TC_BK}, {128, 64, TC_BK}, {64, 128, TC_BK}, {64, 64, TC_BK}};
constexpr int N_TC_TILES = sizeof(TC_TILES) / sizeof(TC_TILES[0]);

int launch(const void* x, const void* w, void* out, int B, int M, int N,
           int K, int64_t x_bs, int64_t w_bs, int x_dt, int w_dt, int out_dt,
           int wt, int tile, const FmEpilogue* ep, cudaStream_t stream) {
  // the caller names the edge (parallel/fused.py resolves it): one of TILES
  if (tile != 128 && tile != 64) return (int)cudaErrorInvalidValue;
  const int vx = vec_ok(x, x_dt, K, x_bs);
  const int vw = vec_ok(w, w_dt, wt ? K : N, w_bs);
  const int vo = epilogue_vec(out, out_dt, M, N, ep);
  const bool f32v = x_dt == DT_F32 && w_dt == DT_F32 && vx && vw;
  const bool big = tile == 128;
  const int bt = big ? 128 : 64;
  const dim3 grid((M + bt - 1) / bt, (N + bt - 1) / bt, B);
  auto kernel = big ? (f32v ? fused_matmul_kernel<128, 16, true>
                            : fused_matmul_kernel<128, 8, false>)
                    : (f32v ? fused_matmul_kernel<64, 32, true>
                            : fused_matmul_kernel<64, 16, false>);
  kernel<<<grid, NT, 0, stream>>>(x, w, out, M, N, K, x_bs, w_bs, x_dt, w_dt,
                                  out_dt, wt, vx, vw, vo, *ep);
  return (int)cudaGetLastError();
}

template <typename E, int BM, int BN, bool WT>
int launch_tc_tile(const void* x, const void* w, void* out, int B, int M,
                   int N, int K, int64_t x_bs, int64_t w_bs, int out_dt,
                   const FmEpilogue* ep, cudaStream_t stream) {
  auto kernel = fused_matmul_tc_kernel<E, BM, BN, tc_stages(BM, BN), WT>;
  constexpr int smem = tc_smem(BM, BN);
  static bool ready = false;  // the attribute, once per instantiation
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, BM / 64 * WG, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), out,
      M, N, K, x_bs, w_bs, out_dt, epilogue_vec(out, out_dt, M, N, ep), *ep);
  return (int)cudaGetLastError();
}

template <typename E, bool WT>
int launch_tc_type(int bm, int bn, const void* x, const void* w, void* out,
                   int B, int M, int N, int K, int64_t x_bs, int64_t w_bs,
                   int out_dt, const FmEpilogue* ep, cudaStream_t stream) {
  if (bm == 128 && bn == 128)
    return launch_tc_tile<E, 128, 128, WT>(x, w, out, B, M, N, K, x_bs, w_bs,
                                           out_dt, ep, stream);
  if (bm == 128 && bn == 64)
    return launch_tc_tile<E, 128, 64, WT>(x, w, out, B, M, N, K, x_bs, w_bs,
                                          out_dt, ep, stream);
  if (bm == 64 && bn == 128)
    return launch_tc_tile<E, 64, 128, WT>(x, w, out, B, M, N, K, x_bs, w_bs,
                                          out_dt, ep, stream);
  return launch_tc_tile<E, 64, 64, WT>(x, w, out, B, M, N, K, x_bs, w_bs,
                                       out_dt, ep, stream);
}

// The tensor-core route, or cudaErrorInvalidValue for what it cannot take:
// a tile outside TC_TILES, operands not of one 16-bit type, K (or N for a
// (K, N) weight) not a multiple of 8, a base not 16-byte aligned or a batch
// stride not a multiple of 8 elements.
int launch_tc(const void* x, const void* w, void* out, int B, int M, int N,
              int K, int64_t x_bs, int64_t w_bs, int x_dt, int w_dt,
              int out_dt, int wt, int bm, int bn, const FmEpilogue* ep,
              cudaStream_t stream) {
  bool tiled = false;
  for (int i = 0; i < N_TC_TILES; ++i)
    tiled = tiled || (TC_TILES[i][0] == bm && TC_TILES[i][1] == bn);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       x_bs % 8 == 0 && w_bs % 8 == 0 && K % 8 == 0 &&
                       (wt || N % 8 == 0);
  if (!tiled || !aligned || x_dt != w_dt || x_dt == DT_F32)
    return (int)cudaErrorInvalidValue;
  if (x_dt == DT_BF16)
    return wt ? launch_tc_type<__nv_bfloat16, true>(
                    bm, bn, x, w, out, B, M, N, K, x_bs, w_bs, out_dt, ep,
                    stream)
              : launch_tc_type<__nv_bfloat16, false>(
                    bm, bn, x, w, out, B, M, N, K, x_bs, w_bs, out_dt, ep,
                    stream);
  return wt ? launch_tc_type<__half, true>(bm, bn, x, w, out, B, M, N, K,
                                           x_bs, w_bs, out_dt, ep, stream)
            : launch_tc_type<__half, false>(bm, bn, x, w, out, B, M, N, K,
                                            x_bs, w_bs, out_dt, ep, stream);
}

enum { ROUTE_SIMT = 0, ROUTE_TC = 1 };

int launch_route(const void* x, const void* w, void* out, int B, int M,
                 int N, int K, int64_t x_bs, int64_t w_bs, int x_dt, int w_dt,
                 int out_dt, int wt, int route, int bm, int bn,
                 const FmEpilogue* ep, cudaStream_t stream) {
  if (route == ROUTE_TC)
    return launch_tc(x, w, out, B, M, N, K, x_bs, w_bs, x_dt, w_dt, out_dt,
                     wt, bm, bn, ep, stream);
  if (route != ROUTE_SIMT || bm != bn) return (int)cudaErrorInvalidValue;
  return launch(x, w, out, B, M, N, K, x_bs, w_bs, x_dt, w_dt, out_dt, wt, bm,
                ep, stream);
}

}  // namespace

extern "C" int fused_matmul_epilogue_size() {
  return (int)sizeof(FmEpilogue);
}

extern "C" int fused_matmul_max_steps() { return FM_MAX_STEPS; }

extern "C" const char* fused_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueues one launch on ``stream`` by ``route`` (0 the CUDA cores, 1 the
// tensor cores) at output tile block_m x block_n (the CUDA-core route
// compiles square tiles of 128 and 64); returns cudaGetLastError() (0 when
// the launch was accepted), cudaErrorInvalidValue for a tile the route does
// not compile or operands it cannot take. Does not synchronise and
// allocates nothing.
extern "C" int fused_matmul_launch(const void* x, const void* w, void* out,
                                   int M, int N, int K, int x_dt, int w_dt,
                                   int out_dt, int wt, int route, int block_m,
                                   int block_n, const FmEpilogue* ep,
                                   void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  return launch_route(x, w, out, 1, M, N, K, 0, 0, x_dt, w_dt, out_dt, wt,
                      route, block_m, block_n, ep, (cudaStream_t)stream);
}

// The batched form: out[b] = epilogue(X[b] . W[b]) for b < B (W[b]^T when
// wt). X[b] starts x_bs elements after X[b-1], W[b] w_bs after W[b-1]; the
// output and the residual extras are contiguous (B, M, N). Same route, tile
// and return contract as fused_matmul_launch.
extern "C" int fused_batch_matmul_launch(const void* x, const void* w,
                                         void* out, int B, int M, int N,
                                         int K, long long x_bs,
                                         long long w_bs, int x_dt, int w_dt,
                                         int out_dt, int wt, int route,
                                         int block_m, int block_n,
                                         const FmEpilogue* ep, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return (int)cudaSuccess;
  return launch_route(x, w, out, B, M, N, K, (int64_t)x_bs, (int64_t)w_bs,
                      x_dt, w_dt, out_dt, wt, route, block_m, block_n, ep,
                      (cudaStream_t)stream);
}

// The compiled tiles of ``route``: row i of TILES (0: edge, K-slice depth of
// the fp32 16-byte form, of the other form) or of TC_TILES (1: BM, BN, K
// depth of a stage); -1 past the last row.
extern "C" int fused_matmul_tiles(int route, int i, int col) {
  if (i < 0 || col < 0 || col > 2) return -1;
  if (route == ROUTE_SIMT) return i < N_TILES ? TILES[i][col] : -1;
  if (route == ROUTE_TC) return i < N_TC_TILES ? TC_TILES[i][col] : -1;
  return -1;
}

// Dynamic shared memory of a block of the tensor-core route's row i.
extern "C" int fused_matmul_tc_smem(int i) {
  if (i < 0 || i >= N_TC_TILES) return -1;
  return tc_smem(TC_TILES[i][0], TC_TILES[i][1]);
}
