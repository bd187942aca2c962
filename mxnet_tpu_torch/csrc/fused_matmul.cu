// Fused matmul + epilogue for Hopper (sm_90a), behind a plain C interface
// loaded with ctypes (mxnet_tpu_torch/parallel/fused.py).
//
// Replaces: mxnet_tpu/parallel/fused.py fused_matmul (kernel body
// _mm_kernel) and fused_batch_matmul (kernel body _bmm_kernel). It computes
// out = epilogue(X . W^T) when wt (W is (N, K), the FullyConnected layout)
// or epilogue(X . W) (W is (K, N), a 1x1 HWIO convolution weight),
// accumulated in fp32; the batched entry does the same for each of B
// (X[b], W[b]) pairs, blockIdx.z walking the batch. The whole epilogue runs
// on the accumulator in registers, in grammar order, before the single
// store of each output element, so no interior tensor of a fusion region
// (the pre-bias, pre-activation, pre-residual values) reaches device
// memory.
//
// Bound: bytes = X (M*K) + W (N*K) + extras (N per vector step, M*N per
// residual step) + out (M*N), each at its element width; operations =
// 2*M*N*K (all times B when batched). At the ResNet-50 1x1 shapes (K, N of
// 64..2048) and at the attention block's batch_dot shapes (K of 64..2048)
// the operations bound, in fp32 on the CUDA cores: the product stays in
// full fp32 (no TF32, no tensor cores) to hold parity with the reference.
//
// Design: a register-tiled SGEMM, one 256-thread block per BT x BT output
// tile, BT 128 or 64 (the same kernel, a template). What bounds an fp32
// product on the CUDA cores short of the FMA rate is the issue of shared
// loads beside the FMAs and the latency of the global loads; so each
// thread accumulates a (BT/16) x (BT/16) micro-tile (8 x 8 at BT 128: 64
// FMAs for 4 16-byte shared loads), at rows 64g + 4ty + (0..3) and columns
// 64g + 4tx + (0..3), reading both operands as float4 from k-major shared
// tiles (one warp's X reads a broadcast, its W reads 16 consecutive
// float4). K is walked in slices: each thread fetches runs of 4
// consecutive elements of X and of W of the next slice into registers,
// converting to fp32, while the current slice is multiplied, then stores
// them into the other of two shared buffers (transposed to k-major where
// the operand runs along K): one barrier per slice. Where both operands
// are fp32 with 16-byte aligned rows (the fp32 training and serving
// paths), each run is one 16-byte load and the slice is 16 deep at BT 128
// and 32 at BT 64 (2 runs per operand and thread: measured faster on the
// H100 than 8 and 16, at 128 registers without spills); otherwise the
// element types and widths are decoded at run time (8-byte loads of
// bf16/fp16 runs where aligned, element by element at a ragged edge) and
// the slice is 8 and 16 deep (1 run). Each output is one
// fp32 FMA chain over k in ascending order, the same sums as before the
// redesign. The epilogue runs after the product, RPR = 4096 / BT rows at a
// time: the accumulators of those rows go through the slices' shared
// memory, and each thread then takes runs of 4 consecutive columns,
// consecutive threads on consecutive runs, so residual reads and output
// stores are coalesced 16-byte accesses where the rows allow, and the
// epilogue's code is one loop rather than one copy per accumulator (64
// unrolled copies of its switch, activations included, cost more in
// instruction fetch than the product's K loop at K 512). BT is a launch
// parameter: the caller names 128 or 64 (a tuned tile, autotune's
// ``fusion.blocks``), or 0 for the rule 128 where its grid fills every SM
// at least once, else 64 (a small grid, such as ResNet-50's 7x7 stage,
// keeps four times the blocks). Each output is the same fp32 FMA chain at
// either tile, so the tile changes the time and never a bit of the result. Ragged M, N and K edges are masked: zero fill on
// load, no store outside the output. Element types (fp32, bf16, fp16) are
// runtime codes, uniform across the grid. The batched form offsets X, W,
// out and the residual extras by per-batch element strides; the 2-d form
// is the same kernel with B = 1 and strides 0. A transposed batch_dot
// operand (the view transpose(k, (0, 2, 1)) of a contiguous (B, N, K) k)
// is read in place through the wt form, with no copy.

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

// a 16-byte (fp32) or 8-byte (16-bit) vector of 4 elements at every element
// offset that is a multiple of 4 from ``p``: ``row`` and ``batch`` strides
// multiples of 4, ``p`` aligned to 4 elements
bool vec_ok(const void* p, int dt, int64_t row, int64_t batch) {
  const int64_t bytes = dt == DT_F32 ? 16 : 8;
  return row % 4 == 0 && batch % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The compiled tiles, one row each: the output tile edge BT and the K-slice
// depth of each route (fp32 operands in 16-byte runs / any other). Python
// reads the same table (fused_matmul_tiles), so the tuner's space and the
// kernel's instantiations cannot drift apart.
constexpr int TILES[][3] = {{128, 16, 8}, {64, 32, 16}};
constexpr int N_TILES = sizeof(TILES) / sizeof(TILES[0]);

int launch(const void* x, const void* w, void* out, int B, int M, int N,
           int K, int64_t x_bs, int64_t w_bs, int x_dt, int w_dt, int out_dt,
           int wt, int tile, const FmEpilogue* ep, cudaStream_t stream) {
  // the caller names the edge (parallel/fused.py resolves it): one of TILES
  if (tile != 128 && tile != 64) return (int)cudaErrorInvalidValue;
  const int vx = vec_ok(x, x_dt, K, x_bs);
  const int vw = vec_ok(w, w_dt, wt ? K : N, w_bs);
  // the output and every extra read in runs of 4 (vectors by column,
  // residuals by row and batch, as the output)
  int vo = vec_ok(out, out_dt, N, (int64_t)M * N);
  for (int s = 0; s < ep->n_steps; ++s)
    if (ep->code[s] <= ST_RES_MUL)
      vo = vo && vec_ok(ep->ptr[s], ep->dtype[s], N, (int64_t)M * N);
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

}  // namespace

extern "C" int fused_matmul_epilogue_size() {
  return (int)sizeof(FmEpilogue);
}

extern "C" int fused_matmul_max_steps() { return FM_MAX_STEPS; }

extern "C" const char* fused_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueues one launch on ``stream`` at output tile ``tile`` (128 or 64);
// returns cudaGetLastError() (0 when the launch was accepted),
// cudaErrorInvalidValue for a tile that is not compiled. Does not
// synchronise and allocates nothing.
extern "C" int fused_matmul_launch(const void* x, const void* w, void* out,
                                   int M, int N, int K, int x_dt, int w_dt,
                                   int out_dt, int wt, int tile,
                                   const FmEpilogue* ep, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  return launch(x, w, out, 1, M, N, K, 0, 0, x_dt, w_dt, out_dt, wt, tile,
                ep, (cudaStream_t)stream);
}

// The batched form: out[b] = epilogue(X[b] . W[b]) for b < B (W[b]^T when
// wt). X[b] starts x_bs elements after X[b-1], W[b] w_bs after W[b-1]; the
// output and the residual extras are contiguous (B, M, N). Same return
// contract as fused_matmul_launch.
extern "C" int fused_batch_matmul_launch(const void* x, const void* w,
                                         void* out, int B, int M, int N,
                                         int K, long long x_bs,
                                         long long w_bs, int x_dt, int w_dt,
                                         int out_dt, int wt, int tile,
                                         const FmEpilogue* ep, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return (int)cudaSuccess;
  return launch(x, w, out, B, M, N, K, (int64_t)x_bs, (int64_t)w_bs, x_dt,
                w_dt, out_dt, wt, tile, ep, (cudaStream_t)stream);
}

// The compiled tiles: row i of TILES as (edge, K-slice depth of the fp32
// 16-byte route, K-slice depth of the other route); -1 past the last row.
extern "C" int fused_matmul_tiles(int i, int col) {
  if (i < 0 || i >= N_TILES || col < 0 || col > 2) return -1;
  return TILES[i][col];
}
