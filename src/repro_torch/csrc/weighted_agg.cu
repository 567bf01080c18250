// weighted_agg_multi for Hopper (sm_90a): out[k, p] = sum_c w[c, k] * stack[c, p].
//
// Replaces the Pallas TPU kernel repro/kernels/weighted_agg.py::weighted_agg_multi
// (FedHC stage-1 per-cluster aggregation: one pass over the (C, P) client stack
// for all K clusters).
//
// Bound on the card: device-memory bytes.  The stack is read once and the
// (K, P) output written once; the kernel does 2K flops per stack element, K/2
// flop per byte in f32, far under the ~20 flop/byte where the H100's f32 units
// would become the limit, so tensor cores buy nothing here.  To reach the
// memory rate the card needs a few MB of loads in flight, i.e. many warps, each
// with independent loads outstanding.
//
// Design against that bound:
//  * a block owns a tile of 32 * VEC contiguous columns: lane l of every warp
//    owns columns l*VEC .. l*VEC+VEC-1 of the tile (VEC = 4, one float4 load,
//    when P % 4 == 0 and the stack is 16-byte aligned), so a warp reads one
//    row's tile as one contiguous, coalesced segment;
//  * the clients are split twice: across the WARPS warps of a block (warp w
//    takes rows w, w + WARPS, ...) and, when the column tiles alone give too
//    few blocks (LeNet's small leaves at C = 800 give one), across blocks
//    (gridDim.y "splits" of rows_per_split rows each).  A first version that
//    had one thread walk all C rows of its column was latency-bound: 1.5 ms
//    for one stage-1 at C = 800, 36x the bound (PERF.md);
//  * each thread keeps its K x VEC accumulators in registers (KMAX = 4, 8 or 16,
//    the smallest bucket >= K; the wrapper raises above 16);
//  * the (C, K) weights are staged through shared memory in chunks of CHUNK rows
//    (C = 10k would not fit at once), padded to KMAX with zeros so the inner
//    loop has no branch on K;
//  * the warps' partial sums are reduced in shared memory in a fixed order, one
//    k at a time; with splits > 1 each block writes its f32 partial to a
//    (splits, K, P) scratch the wrapper allocates, and a second kernel sums the
//    splits in order.  No atomics: the result does not change from run to run;
//  * f32 and bf16 stacks, always f32 accumulation, output in the stack's dtype;
//  * the ragged edge of P is masked, not padded (the TPU kernel padded P to
//    BLOCK_P = 2048 lanes; nothing on this card needs that).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 256;      // weight rows per shared-memory chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int KMAX, int VEC>
__global__ void __launch_bounds__(THREADS)
wagg_multi_kernel(const T* __restrict__ stack, const float* __restrict__ w,
                  T* __restrict__ out, float* __restrict__ part, int C,
                  long long P, int K, int rows_per_split) {
  __shared__ float sw[CHUNK * KMAX];
  __shared__ float red[WARPS][32 * VEC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 = ((long long)blockIdx.x * 32 + lane) * VEC;
  const bool active = p0 < P;
  const int c_lo = blockIdx.y * rows_per_split;
  const int c_hi = min(C, c_lo + rows_per_split);

  float acc[KMAX][VEC];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = 0.0f;

  for (int c0 = c_lo; c0 < c_hi; c0 += CHUNK) {
    const int cn = min(CHUNK, c_hi - c0);
    __syncthreads();                       // previous chunk fully consumed
    for (int i = threadIdx.x; i < cn * KMAX; i += THREADS) {
      const int c = i / KMAX, k = i - c * KMAX;
      sw[i] = k < K ? w[(long long)(c0 + c) * K + k] : 0.0f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int c = warp; c < cn; c += WARPS) {
        const T* row = stack + (long long)(c0 + c) * P + p0;
        float x[VEC];
        if constexpr (VEC == 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(row));
          x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) x[v] = to_f32(row[v]);
        }
        const float* wc = sw + c * KMAX;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[k][v] = fmaf(wc[k], x[v], acc[k][v]);
      }
    }
  }

  // reduce the WARPS partial sums of each column, one k at a time
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    __syncthreads();                       // red is free again
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[warp][lane * VEC + v] = acc[k][v];
    __syncthreads();
    if (warp == 0 && active) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) s += red[i][lane * VEC + v];
        const long long idx = (long long)k * P + p0 + v;
        if (part != nullptr) part[(long long)blockIdx.y * K * P + idx] = s;
        else store(out + idx, s);
      }
    }
  }
}

template <typename T>
__global__ void wagg_sum_splits_kernel(const float* __restrict__ part,
                                       T* __restrict__ out, int splits,
                                       long long KP) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= KP) return;
  float s = 0.0f;
  for (int j = 0; j < splits; ++j) s += part[(long long)j * KP + i];
  store(out + i, s);
}

template <typename T, int VEC>
cudaError_t launch(const T* stack, const float* w, T* out, float* part,
                   int C, long long P, int K, int splits, cudaStream_t stream) {
  const long long tiles = (P + 32 * VEC - 1) / (32 * VEC);
  const int rows = (C + splits - 1) / splits;
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  float* p = splits > 1 ? part : nullptr;
  if (K <= 4)
    wagg_multi_kernel<T, 4, VEC><<<grid, THREADS, 0, stream>>>(stack, w, out, p, C, P, K, rows);
  else if (K <= 8)
    wagg_multi_kernel<T, 8, VEC><<<grid, THREADS, 0, stream>>>(stack, w, out, p, C, P, K, rows);
  else
    wagg_multi_kernel<T, 16, VEC><<<grid, THREADS, 0, stream>>>(stack, w, out, p, C, P, K, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long kp = (long long)K * P;
  wagg_sum_splits_kernel<T><<<(unsigned)((kp + 255) / 256), 256, 0, stream>>>(
      part, out, splits, kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 = cudaSuccess).  The caller
// checks 1 <= K <= 16, C >= 1, P >= 1, contiguity and placement, and picks
// vec (4 needs P % 4 == 0 and a 16-byte-aligned stack) and splits (part must
// then hold splits * K * P floats; it is unused when splits == 1).
int wagg_multi_f32(const float* stack, const float* w, float* out, float* part,
                   int C, long long P, int K, int vec, int splits,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    if (P % 4 != 0 || (uintptr_t)stack % 16 != 0) return (int)cudaErrorInvalidValue;
    return (int)launch<float, 4>(stack, w, out, part, C, P, K, splits, s);
  }
  return (int)launch<float, 1>(stack, w, out, part, C, P, K, splits, s);
}

int wagg_multi_bf16(const void* stack, const float* w, void* out, float* part,
                    int C, long long P, int K, int vec, int splits,
                    void* stream) {
  if (vec != 1) return (int)cudaErrorInvalidValue;
  return (int)launch<__nv_bfloat16, 1>(
      (const __nv_bfloat16*)stack, w, (__nv_bfloat16*)out, part, C, P, K,
      splits, (cudaStream_t)stream);
}

}  // extern "C"
