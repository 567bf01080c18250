// flash_attention (forward), the f32 route, on the CUDA cores (sm_90a):
// blockwise online-softmax attention with GQA, a tanh logit soft-cap, and
// causal and sliding-window masks, for q (B, Hq, Sq, D) and k, v (B, Hkv, Sk,
// D).  kernels/flash_attention.py routes by dtype: f32 comes here (the tensor
// cores' f32 mode is TF32, which cannot hold an f32 result to 3e-5), bf16 to
// the tensor-core kernel of csrc/flash_attention_sm90.cu.
//
//   s[i, j] = softcap(q_i . k_j / sqrt(D)),  masked to NEG_INF off the band
//   out_i   = sum_j softmax_j(s[i, :]) v_j
//
// q tokens sit at the end of the kv axis (q_pos = Sk - Sq + i), so one kernel
// serves prefill (Sq == Sk) and decode against a cache (Sq < Sk).  Query head h
// reads kv head h / (Hq / Hkv).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (its _kernel body and pl.pallas_call).
//
// Bound on the card: operations.  Every live (q, k) pair costs 4 D flops (the
// q.k dot and the p*v update), and with D = 256 that is ~1000 flops for every
// ~1 KB of k and v that a q tile reads once from memory; gemma2-2b's prefill
// (B = 2, S = 8192) needs ~0.55 TFLOP a global layer, 0.56 ms at the bf16
// tensor-core rate of 989 TFLOP/s.  This kernel runs on the CUDA cores in f32
// FMA (67 TFLOP/s peak, 8.2 ms for that layer), with no wgmma, no TMA and no
// overlap of loads with compute.
//
// Design:
//  * one block of 256 threads owns (b, h, a tile of BQ = 64 query rows); a loop
//    inside the block over kv tiles of BK = 64 keys takes the place of the
//    TPU's sequential kv grid axis, and the running max m, sum l and the
//    (BQ, D) accumulator persist across it in registers;
//  * the loop visits only the kv tiles that meet the band: causal
//    k_start <= q_last, window k_end > q_first - window, so a sliding-window
//    layer costs O(S * window), not O(S^2); inside a tile the element masks
//    (kv padding, causal, window) apply, with the finite NEG_INF;
//  * q, k, v tiles are staged in shared memory as f32 (rows padded by 4 floats
//    so that the float4 reads of a quarter-warp fall in distinct banks); at
//    D = 256 that is 217 KB of dynamic shared memory, one block per SM;
//  * thread (ra, ca) of the 16 x 16 thread grid owns rows ra + 16 i and keys
//    ca + 16 j (i, j < 4) of the score tile, and the same rows times columns
//    4 ca + 64 j .. + 3 of the output; a row's 16 owners are the 16 lanes of a
//    half-warp, so its max and sum reduce with four shuffles;
//  * f32 and bf16 inputs, all arithmetic in f32 (p stays f32 for P.V, as in
//    the TPU kernel), output in the input's dtype, finalized as
//    acc / max(l, 1e-30);
//  * any strides over (b, h, s) with D contiguous, so the model's (B, S, H, D)
//    activations are read and written in place through transposed views;
//  * the heaviest causal q tiles (the last) are launched first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;                // query rows of a block
constexpr int BK = 64;                // keys of a kv tile
constexpr int PPITCH = BK + 4;        // row pitch of the probability tile
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];   // strides over (b, h, s), elements
  int Sq, Sk, D, group;                    // group = Hq / Hkv
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// rows [row0, row0 + valid) of src (D contiguous, rows `stride` apart) into
// ROWS x DMAX floats of dst at pitch DMAX + 4; zeros elsewhere
template <typename T, int DMAX, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long stride, int row0, int valid,
                                          int D) {
  constexpr int PITCH = DMAX + 4;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < ROWS * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX;
    float x = 0.0f;
    if (r < valid && c < D) x = to_f32(src[(long long)(row0 + r) * stride + c]);
    dst[r * PITCH + c] = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(Params p) {
  constexpr int PITCH = DMAX + 4;
  constexpr int NJ = DMAX / 64;         // float4 output columns of a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * PITCH;
  float* Vs = Ks + BK * PITCH;
  float* Ps = Vs + BK * PITCH;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ra = warp * 2 + (lane >> 4), ca = lane & 15;
  const int tile = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  T* o = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1];

  const int q0 = tile * BQ;
  const int q_first = p.Sk - p.Sq + q0;                       // position of row 0
  const int q_last = p.Sk - p.Sq + min(q0 + BQ, p.Sq) - 1;    // last real row
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int dlim = (p.D + 3) & ~3;

  load_tile<T, DMAX, BQ>(Qs, q, p.qs[2], q0, min(BQ, p.Sq - q0), p.D);

  float m[4], l[4];
  float4 acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();                      // the previous tile is consumed
    const int kvalid = min(BK, p.Sk - k0);
    load_tile<T, DMAX, BK>(Ks, k, p.ks[2], k0, kvalid, p.D);
    load_tile<T, DMAX, BK>(Vs, v, p.vs[2], k0, kvalid, p.D);
    __syncthreads();

    // scores: s[i][j] = q_(ra+16i) . k_(ca+16j)
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < dlim; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ra + 16 * i) * PITCH + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (ca + 16 * j) * PITCH + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, soft-cap, mask; online softmax over the tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_first + ra + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + ca + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        Ps[(ra + 16 * i) * PPITCH + ca + 16 * j] = s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j].x *= alpha; acc[i][j].y *= alpha;
        acc[i][j].z *= alpha; acc[i][j].w *= alpha;
      }
    }
    __syncthreads();

    // acc += P . V over the tile's keys
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ra + 16 * i) * PPITCH + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = Vs + (kk + t) * PITCH + ca * 4;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pi = comp(pv[i], t);
            acc[i][j].x = fmaf(pi, vv.x, acc[i][j].x);
            acc[i][j].y = fmaf(pi, vv.y, acc[i][j].y);
            acc[i][j].z = fmaf(pi, vv.z, acc[i][j].z);
            acc[i][j].w = fmaf(pi, vv.w, acc[i][j].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + 16 * i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (long long)row * p.os[2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = ca * 4 + 64 * j;
      const float4 a = acc[i][j];
      if (c + 0 < p.D) store(orow + c + 0, a.x / den);
      if (c + 1 < p.D) store(orow + c + 1, a.y / den);
      if (c + 2 < p.D) store(orow + c + 2, a.z / den);
      if (c + 3 < p.D) store(orow + c + 3, a.w / den);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, int B, int Hq, cudaStream_t stream) {
  constexpr int PITCH = DMAX + 4;
  const size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BK) * PITCH + (size_t)BQ * PPITCH);
  // the opt-in above 48 KB, once per device (a later call may be captured
  // into a CUDA graph, where only stream work belongs)
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid((unsigned)((p.Sq + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int B, int Hq, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64>(p, B, Hq, stream);
  if (p.D <= 128) return launch<T, 128>(p, B, Hq, stream);
  return launch<T, 256>(p, B, Hq, stream);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  dtype 0 is
// float32, 1 bfloat16; q, k, v, o share it.  strides holds 12 element strides:
// (b, h, s) of q, k, v and o, in that order; D is contiguous in all four.  The
// caller checks 1 <= D <= 256, Hq % Hkv == 0, Sq <= Sk when causal, and that
// every size fits an int.
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                        void* o, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                        const long long* strides, int causal, int window,
                        float softcap, float scale, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.Sq = Sq; p.Sk = Sk; p.D = D; p.group = Hq / Hkv;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_d<float>(p, B, Hq, s);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(p, B, Hq, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
