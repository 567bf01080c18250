// kmeans_assign for Hopper (sm_90a): for every point x_n (row of x, (N, D)),
// the nearest centroid by the expanded squared distance
//   d(n, k) = |x_n|^2 - 2 x_n . c_k + |c_k|^2
// as an int32 index, and that minimum distance as f32.
//
// Replaces the Pallas TPU kernel repro/kernels/kmeans.py::kmeans_assign (the
// Eq. 13 assignment step; in FedHC the per-round geometry-drift check).
//
// Bound on the card: device-memory bytes, and at the main path's size
// (N = 800 satellites, D = 3, K = 4: 16 KB in and out) in practice the launch
// itself.  The work is N*K*(2D+1) flops, a handful per byte read.
//
// Design:
//  * one thread per point; the thread keeps its point in registers and
//    loops over the centroids;
//  * the (K, D) centroids and their squared norms are staged once per block
//    in shared memory (the wrapper raises when they exceed 48 KB);
//  * the same expanded formula, in the same association, as the reference
//    (repro/kernels/ref.py::kmeans_assign_ref), so argmin decisions round as
//    the reference's do;
//  * a strict '<' in the running argmin keeps the first index on ties, as
//    jnp.argmin / torch.argmin do;
//  * D and K are loop bounds: nothing is padded to lanes (the TPU kernel
//    padded D to 128 and K to 8 and masked padded centroids to +inf).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int* __restrict__ assign, float* __restrict__ dmin,
                     int N, int D, int K) {
  extern __shared__ float smem[];
  float* cs = smem;              // (K, D) centroids
  float* cn = smem + K * D;      // (K,) squared norms
  for (int i = threadIdx.x; i < K * D; i += THREADS) cs[i] = c[i];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += THREADS) {
    float s = 0.0f;
    for (int d = 0; d < D; ++d) s = fmaf(cs[k * D + d], cs[k * D + d], s);
    cn[k] = s;
  }
  __syncthreads();

  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const float* xn = x + (long long)n * D;
  float xx = 0.0f;
  for (int d = 0; d < D; ++d) xx = fmaf(xn[d], xn[d], xx);

  int best = 0;
  float best_d = INFINITY;
  for (int k = 0; k < K; ++k) {
    float dot = 0.0f;
    for (int d = 0; d < D; ++d) dot = fmaf(xn[d], cs[k * D + d], dot);
    const float dist = (xx - 2.0f * dot) + cn[k];
    if (dist < best_d || k == 0) { best_d = dist; best = k; }
  }
  assign[n] = best;
  dmin[n] = best_d;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  The caller
// checks N, D, K >= 1, K*(D+1) floats <= 48 KB, contiguity and placement.
int kmeans_assign_f32(const float* x, const float* c, int* assign,
                      float* dmin, int N, int D, int K, void* stream) {
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  const size_t shmem = (size_t)K * (D + 1) * sizeof(float);
  kmeans_assign_kernel<<<blocks, THREADS, shmem, (cudaStream_t)stream>>>(
      x, c, assign, dmin, N, D, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
