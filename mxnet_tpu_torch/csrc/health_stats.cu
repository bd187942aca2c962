// The training-health layer's per-step reduction (observability/health.py)
// on sm_90a: for each of n watched tensors (loss, gradients, parameters),
// read in place through a table of device pointers, the finite-element
// count, the sum of squares and the sum of its finite elements, in float64.
//
// The JAX package computes this with one XLA program over all tensors
// (mxnet_tpu/observability/health.py _stats_impl); there is no Pallas
// kernel behind it. Here one launch covers every tensor: each block
// reduces one chunk of HS_CHUNK elements of one tensor into a partial row;
// the last block to finish (a counter behind a fence) sums each tensor's
// partial rows in a fixed order, one warp a tensor, so the result does not
// depend on the blocks' order. A count is a sum of per-chunk integers
// (at most HS_CHUNK) in float64: exact far past any tensor size.
//
// The host entry point enqueues, on one stream: the copy of this step's
// pointer table from pinned host memory, the kernel, the copy of the
// (n, 3) result into pinned host memory, and the event behind it. It does
// not synchronise and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HS_THREADS 256
#define HS_CHUNK 8192

enum { HS_F32 = 0, HS_BF16 = 1, HS_F16 = 2, HS_F64 = 3 };

template <int DT>
__device__ __forceinline__ double hs_load(const void* p, long long i) {
  if (DT == HS_F32) return (double)__ldg(static_cast<const float*>(p) + i);
  if (DT == HS_BF16)
    return (double)__bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (DT == HS_F16)
    return (double)__half2float(static_cast<const __half*>(p)[i]);
  return __ldg(static_cast<const double*>(p) + i);
}

template <int DT>
__device__ __forceinline__ void hs_chunk(const void* p, long long start,
                                         long long end, double& c,
                                         double& q, double& s) {
  for (long long i = start + threadIdx.x; i < end; i += HS_THREADS) {
    double x = hs_load<DT>(p, i);
    if (isfinite(x)) {
      c += 1.0;
      q += x * x;
      s += x;
    }
  }
}

__device__ __forceinline__ double hs_warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ptrs[n]: device addresses; dtypes[n]; numels[n]; chunk_tensor[nchunks],
// chunk_start[nchunks]: which tensor and element each block starts at;
// first_chunk[n + 1]: tensor t owns chunks [first_chunk[t],
// first_chunk[t + 1]); partials[3 * nchunks]; counter: 0 before a launch,
// left 0 after it; out[3 * n]: [finite count, sum(x^2), sum(x)] per tensor.
__global__ void __launch_bounds__(HS_THREADS)
health_stats_kernel(const unsigned long long* __restrict__ ptrs,
                    const int* __restrict__ dtypes,
                    const long long* __restrict__ numels,
                    const int* __restrict__ chunk_tensor,
                    const long long* __restrict__ chunk_start,
                    const int* __restrict__ first_chunk, int n, int nchunks,
                    double* partials, unsigned int* counter, double* out) {
  const int b = blockIdx.x;
  const int t = chunk_tensor[b];
  const long long start = chunk_start[b];
  const long long end = min(start + (long long)HS_CHUNK, numels[t]);
  const void* p = reinterpret_cast<const void*>(ptrs[t]);
  double c = 0.0, q = 0.0, s = 0.0;
  switch (dtypes[t]) {
    case HS_F32: hs_chunk<HS_F32>(p, start, end, c, q, s); break;
    case HS_BF16: hs_chunk<HS_BF16>(p, start, end, c, q, s); break;
    case HS_F16: hs_chunk<HS_F16>(p, start, end, c, q, s); break;
    default: hs_chunk<HS_F64>(p, start, end, c, q, s); break;
  }
  __shared__ double red[3][HS_THREADS / 32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  c = hs_warp_sum(c);
  q = hs_warp_sum(q);
  s = hs_warp_sum(s);
  if (lane == 0) {
    red[0][warp] = c;
    red[1][warp] = q;
    red[2][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double rc = 0.0, rq = 0.0, rs = 0.0;
    for (int w = 0; w < HS_THREADS / 32; ++w) {
      rc += red[0][w];
      rq += red[1][w];
      rs += red[2][w];
    }
    partials[3 * b] = rc;
    partials[3 * b + 1] = rq;
    partials[3 * b + 2] = rs;
    __threadfence();
    last = atomicAdd(counter, 1u) == (unsigned int)(nchunks - 1);
  }
  __syncthreads();
  if (!last) return;
  // the last block: one warp a tensor, its lanes striding over the
  // tensor's partial rows, then a fixed-order shuffle reduction
  for (int u = warp; u < n; u += HS_THREADS / 32) {
    double uc = 0.0, uq = 0.0, us = 0.0;
    for (int k = first_chunk[u] + lane; k < first_chunk[u + 1]; k += 32) {
      uc += __ldcg(partials + 3 * k);
      uq += __ldcg(partials + 3 * k + 1);
      us += __ldcg(partials + 3 * k + 2);
    }
    uc = hs_warp_sum(uc);
    uq = hs_warp_sum(uq);
    us = hs_warp_sum(us);
    if (lane == 0) {
      out[3 * u] = uc;
      out[3 * u + 1] = uq;
      out[3 * u + 2] = us;
    }
  }
  if (threadIdx.x == 0) *counter = 0u;
}

extern "C" int health_stats_chunk() { return HS_CHUNK; }

extern "C" const char* health_stats_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// A plan's device tables and scratch, fixed from its first launch on (the
// host keeps one per call signature and passes its address).
struct HsPlan {
  unsigned long long* dev_ptrs;  // n: the pointer table's device copy
  const int* dtypes;             // n
  const long long* numels;       // n
  const int* chunk_tensor;       // nchunks
  const long long* chunk_start;  // nchunks
  const int* first_chunk;        // n + 1
  double* partials;              // 3 * nchunks
  unsigned int* counter;         // 1, zero between launches
  double* dev_out;               // 3 * n
  int n;
  int nchunks;
};

extern "C" int health_stats_plan_size() { return (int)sizeof(HsPlan); }

// host_ptrs: pinned, the n addresses of this launch (read by the copy when
// the stream reaches it: not rewritten before ``event`` of a later launch
// from the same buffer has happened); host_out: pinned (n, 3) float64 the
// result is copied to; event: recorded after that copy (null: none).
// Returns the first failing call's error (0 when everything was enqueued).
extern "C" int health_stats_launch(const HsPlan* plan,
                                   const unsigned long long* host_ptrs,
                                   double* host_out, void* event,
                                   void* stream) {
  const int n = plan->n, nchunks = plan->nchunks;
  if (n <= 0 || nchunks <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(plan->dev_ptrs, host_ptrs,
                                    sizeof(unsigned long long) * n,
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  health_stats_kernel<<<nchunks, HS_THREADS, 0, st>>>(
      plan->dev_ptrs, plan->dtypes, plan->numels, plan->chunk_tensor,
      plan->chunk_start, plan->first_chunk, n, nchunks, plan->partials,
      plan->counter, plan->dev_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(host_out, plan->dev_out, sizeof(double) * 3 * n,
                        cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return (int)err;
  if (event != nullptr) err = cudaEventRecord((cudaEvent_t)event, st);
  return (int)err;
}
