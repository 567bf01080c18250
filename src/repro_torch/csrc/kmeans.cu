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
// Design, against the launch itself (the floor a kernel this size can reach):
//  * one thread per point, with nothing between its loads and its result: no
//    shared memory and no barrier.  Every thread reads the (K, D) centroids
//    through the read-only cache (the whole grid reads the same few dozen
//    floats) and computes each centroid's squared norm itself;
//  * for 3-D points (satellite positions: the FL drift check, D = 3) and
//    K <= 8, D and K are template constants and each lane of a warp loads
//    one centroid coordinate, once, which the warp hands round with
//    shuffles: a thread issues its point's 3 loads and one more, all before
//    its first FMA, waits on memory once, and runs no loop.  Other shapes
//    loop over K and D through the read-only cache.  A first version staged
//    the centroids and their norms in shared memory behind two
//    __syncthreads (a second dependent round trip before the first point
//    load) and took 1.9x the floor of one launch; runtime bounds on D and K
//    with masked loads still took ~1.35x (PERF.md);
//  * the same expanded formula, in the same association, as the reference
//    (repro/kernels/ref.py::kmeans_assign_ref), so argmin decisions round as
//    the reference's do;
//  * a strict '<' in the running argmin keeps the first index on ties, as
//    jnp.argmin / torch.argmin do;
//  * nothing is padded in memory (the TPU kernel padded D to 128 and K to 8
//    and masked padded centroids to +inf).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int POINT_D = 3, POINT_KMAX = 8;   // the template-shaped case

// D and K known: the centroids come from one load a warp
template <int D, int K>
__global__ void __launch_bounds__(THREADS)
kmeans_assign_fixed_kernel(const float* __restrict__ x,
                           const float* __restrict__ c,
                           int* __restrict__ assign,
                           float* __restrict__ dmin, int N) {
  static_assert(D * K <= 32, "one centroid coordinate a lane");
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n - (int)(threadIdx.x & 31) >= N) return;  // the whole warp is past N
  const bool active = n < N;
  const int lane = threadIdx.x & 31;
  const float cl = lane < K * D ? __ldg(c + lane) : 0.0f;
  float xr[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    xr[d] = active ? __ldg(x + (long long)n * D + d) : 0.0f;
  float xx = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) xx = fmaf(xr[d], xr[d], xx);
  int best = 0;
  float best_d = INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float dot = 0.0f, cc = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float cd = __shfl_sync(0xffffffffu, cl, k * D + d);
      dot = fmaf(xr[d], cd, dot);
      cc = fmaf(cd, cd, cc);
    }
    const float dist = (xx - 2.0f * dot) + cc;
    if (dist < best_d || k == 0) { best_d = dist; best = k; }
  }
  if (active) {
    assign[n] = best;
    dmin[n] = best_d;
  }
}

template <int K>
void launch_fixed(const float* x, const float* c, int* assign, float* dmin,
                  int N, unsigned blocks, cudaStream_t s) {
  kmeans_assign_fixed_kernel<POINT_D, K><<<blocks, THREADS, 0, s>>>(
      x, c, assign, dmin, N);
}

__global__ void __launch_bounds__(THREADS)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int* __restrict__ assign, float* __restrict__ dmin,
                     int N, int D, int K) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const float* xn = x + (long long)n * D;
  float xx = 0.0f;
  for (int d = 0; d < D; ++d) xx = fmaf(__ldg(xn + d), __ldg(xn + d), xx);

  int best = 0;
  float best_d = INFINITY;
  for (int k = 0; k < K; ++k) {
    const float* ck = c + (long long)k * D;
    float dot = 0.0f, cc = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float cd = __ldg(ck + d);
      dot = fmaf(__ldg(xn + d), cd, dot);
      cc = fmaf(cd, cd, cc);
    }
    const float dist = (xx - 2.0f * dot) + cc;
    if (dist < best_d || k == 0) { best_d = dist; best = k; }
  }
  assign[n] = best;
  dmin[n] = best_d;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  The caller
// checks N, D, K >= 1, contiguity and placement.
int kmeans_assign_f32(const float* x, const float* c, int* assign,
                      float* dmin, int N, int D, int K, void* stream) {
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == POINT_D && K <= POINT_KMAX) {
    switch (K) {
      case 1: launch_fixed<1>(x, c, assign, dmin, N, blocks, s); break;
      case 2: launch_fixed<2>(x, c, assign, dmin, N, blocks, s); break;
      case 3: launch_fixed<3>(x, c, assign, dmin, N, blocks, s); break;
      case 4: launch_fixed<4>(x, c, assign, dmin, N, blocks, s); break;
      case 5: launch_fixed<5>(x, c, assign, dmin, N, blocks, s); break;
      case 6: launch_fixed<6>(x, c, assign, dmin, N, blocks, s); break;
      case 7: launch_fixed<7>(x, c, assign, dmin, N, blocks, s); break;
      default: launch_fixed<8>(x, c, assign, dmin, N, blocks, s); break;
    }
  } else {
    kmeans_assign_kernel<<<blocks, THREADS, 0, s>>>(x, c, assign, dmin, N, D, K);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
