// Fused matmul + epilogue for Hopper (sm_90a), behind a plain C interface
// loaded with ctypes (mxnet_tpu_torch/parallel/fused.py).
//
// Replaces: mxnet_tpu/parallel/fused.py fused_matmul (kernel body
// _mm_kernel) and fused_batch_matmul (kernel body _bmm_kernel). It computes
// out = epilogue(X . W^T) when wt (W is (N, K), the FullyConnected layout)
// or epilogue(X . W) (W is (K, N), a 1x1 HWIO convolution weight),
// accumulated in fp32; the batched entry does the same for each of B
// (X[b], W[b]) pairs, blockIdx.z walking the batch. The whole epilogue runs on the
// accumulator in registers, in grammar order, before the single store of
// each output element, so no interior tensor of a fusion region (the
// pre-bias, pre-activation, pre-residual values) reaches device memory.
//
// Bound: bytes = X (M*K) + W (N*K) + extras (N per vector step, M*N per
// residual step) + out (M*N), each at its element width; operations =
// 2*M*N*K (all times B when batched). At the ResNet-50 1x1 shapes (K, N of
// 64..2048) and at the attention block's batch_dot shapes (K of 64..2048)
// the operations bound in fp32 on the CUDA cores. The product stays in full fp32 (no TF32,
// no tensor cores) to hold parity with the reference; wgmma/TMA tiles are
// later work.
//
// Design: one 256-thread block per 64x64 output tile. The K axis is walked
// in steps of 32 through shared memory: X and W tiles are loaded with
// consecutive threads on consecutive addresses, converted to fp32, and
// stored k-major (padded by one column so the transposed stores do not
// conflict). Each thread accumulates a 4x4 micro-tile in registers at rows
// ty+16i and columns tx+16j, so one warp's shared reads are a broadcast
// (X) and 16 consecutive words (W). Ragged M, N and K edges are masked:
// zero fill on load, no store outside the output. Element types (fp32,
// bf16, fp16) are runtime codes, uniform across the grid. The batched form
// offsets X, W, out and the residual extras by per-batch element strides;
// the 2-d form is the same kernel with B = 1 and strides 0. A transposed
// batch_dot operand (the view transpose(k, (0, 2, 1)) of a contiguous
// (B, N, K) k) is read in place through the wt form, with no copy.

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

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int NT = 256;  // (BM / TM) * (BN / TN)

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

// ``mn`` is the element's offset in a residual extra (batch offset
// included), ``n`` its column (the index into a vector extra).
__device__ __forceinline__ float apply_epilogue(const FmEpilogue& ep,
                                                float y, int64_t mn,
                                                int64_t n) {
  for (int s = 0; s < ep.n_steps; ++s) {
    const float v = ep.scalar[s];
    switch (ep.code[s]) {
      case ST_VADD: y += load_f(ep.ptr[s], n, ep.dtype[s]); break;
      case ST_VMUL: y *= load_f(ep.ptr[s], n, ep.dtype[s]); break;
      case ST_RES_ADD: y += load_f(ep.ptr[s], mn, ep.dtype[s]); break;
      case ST_RES_MUL: y *= load_f(ep.ptr[s], mn, ep.dtype[s]); break;
      case ST_RELU: y = y < 0.f ? 0.f : y; break;  // NaN propagates
      case ST_SIGMOID: y = 1.f / (1.f + expf(-y)); break;
      case ST_TANH: y = tanhf(y); break;
      case ST_SOFTRELU: y = fmaxf(y, 0.f) + log1pf(expf(-fabsf(y))); break;
      case ST_SOFTSIGN: y = y / (1.f + fabsf(y)); break;
      case ST_MUL_S: y = y * v; break;
      case ST_DIV_S: y = y / v; break;
      case ST_PLUS_S: y = y + v; break;
      case ST_MINUS_S: y = y - v; break;
      case ST_RMINUS_S: y = v - y; break;
      default: break;
    }
  }
  return y;
}

__global__ void __launch_bounds__(NT)
fused_matmul_kernel(const void* __restrict__ x, const void* __restrict__ w,
                    void* __restrict__ out, int M, int N, int K,
                    int64_t x_bs, int64_t w_bs, int x_dt, int w_dt,
                    int out_dt, int wt, FmEpilogue ep) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // this block's batch: X and W move by their strides, the output by M*N
  // (it is contiguous (B, M, N)); the base pointers move once here so the
  // tile loads index as in the 2-d form. The residual extras are indexed
  // with the batch offset o_off (each has its own element type).
  const int64_t b = blockIdx.z;
  const int64_t o_off = b * (int64_t)M * N;
  x = static_cast<const char*>(x) + b * x_bs * elem_bytes(x_dt);
  w = static_cast<const char*>(w) + b * w_bs * elem_bytes(w_dt);
  out = static_cast<char*>(out) + o_off * elem_bytes(out_dt);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // X tile (BM x BK), k fastest across threads
#pragma unroll
    for (int r = 0; r < (BM * BK) / NT; ++r) {
      const int e = tid + r * NT;
      const int kk = e % BK, mm = e / BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K)
                       ? load_f(x, (int64_t)gm * K + gk, x_dt)
                       : 0.f;
    }
    if (wt) {
      // W is (N, K): k fastest across threads
#pragma unroll
      for (int r = 0; r < (BN * BK) / NT; ++r) {
        const int e = tid + r * NT;
        const int kk = e % BK, nn = e / BK;
        const int gn = n0 + nn, gk = k0 + kk;
        Bs[kk][nn] = (gn < N && gk < K)
                         ? load_f(w, (int64_t)gn * K + gk, w_dt)
                         : 0.f;
      }
    } else {
      // W is (K, N): n fastest across threads
#pragma unroll
      for (int r = 0; r < (BN * BK) / NT; ++r) {
        const int e = tid + r * NT;
        const int nn = e % BN, kk = e / BN;
        const int gn = n0 + nn, gk = k0 + kk;
        Bs[kk][nn] = (gn < N && gk < K)
                         ? load_f(w, (int64_t)gk * N + gn, w_dt)
                         : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + (BM / TM) * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + (BN / TN) * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + (BM / TM) * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + (BN / TN) * j;
      if (n >= N) continue;
      const int64_t mn = (int64_t)m * N + n;
      const float y = apply_epilogue(ep, acc[i][j], o_off + mn, n);
      store_f(out, mn, out_dt, y);
    }
  }
}

}  // namespace

extern "C" int fused_matmul_epilogue_size() {
  return (int)sizeof(FmEpilogue);
}

extern "C" int fused_matmul_max_steps() { return FM_MAX_STEPS; }

extern "C" const char* fused_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Enqueues one launch on ``stream``; returns cudaGetLastError() (0 when the
// launch was accepted). Does not synchronise and allocates nothing.
extern "C" int fused_matmul_launch(const void* x, const void* w, void* out,
                                   int M, int N, int K, int x_dt, int w_dt,
                                   int out_dt, int wt, const FmEpilogue* ep,
                                   void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, 1);
  fused_matmul_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, w, out, M, N, K, 0, 0, x_dt, w_dt, out_dt, wt, *ep);
  return (int)cudaGetLastError();
}

// The batched form: out[b] = epilogue(X[b] . W[b]) for b < B (W[b]^T when
// wt). X[b] starts x_bs elements after X[b-1], W[b] w_bs after W[b-1]; the
// output and the residual extras are contiguous (B, M, N). Same return
// contract as fused_matmul_launch.
extern "C" int fused_batch_matmul_launch(const void* x, const void* w,
                                         void* out, int B, int M, int N,
                                         int K, long long x_bs,
                                         long long w_bs, int x_dt, int w_dt,
                                         int out_dt, int wt,
                                         const FmEpilogue* ep, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, B);
  fused_matmul_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, w, out, M, N, K, (int64_t)x_bs, (int64_t)w_bs, x_dt, w_dt, out_dt,
      wt, *ep);
  return (int)cudaGetLastError();
}
