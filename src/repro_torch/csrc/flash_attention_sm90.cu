// flash_attention (forward, bf16) on Hopper's tensor cores (sm_90a): blockwise
// online-softmax attention with GQA, a tanh logit soft-cap, and causal and
// sliding-window masks, for q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D) in bf16:
//
//   s[i, j] = softcap(q_i . k_j / sqrt(D)),  masked to NEG_INF off the band
//   out_i   = sum_j softmax_j(s[i, :]) v_j
//
// q tokens sit at the end of the kv axis (q_pos = Sk - Sq + i); query head h
// reads kv head h / (Hq / Hkv).  The bf16 route of kernels/flash_attention.py;
// f32 inputs take csrc/flash_attention.cu (the tensor cores' f32 mode is TF32,
// 10 bits of mantissa, which cannot hold an f32 result to 3e-5).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (its _kernel body and pl.pallas_call).
//
// Bound on the card: operations.  Every live (q, k) pair costs 4 D flops on
// the tensor cores (q.k and p*v): 1,024 at D = 256, ~1.0 ps at 989 TFLOP/s;
// gemma2-2b's global prefill layer (B = 2, S = 8192) is 0.55 TFLOP, 0.56 ms.
// Each pair also costs three special-function ops (ex2 and rcp for the
// soft-cap, ex2 for p), ~0.7 ps at 16 a clock on each of 132 SMs, and ~0.2 ps
// of scale, max, mask and sum on the FP32 pipes: without overlap the softmax
// alone is ~70% of the tensor-core bound.  Two consumer warpgroups overlap
// one's softmax with the other's wgmma.
//
// Design:
//  * one block of 384 threads owns (b, h, a tile of BQ = 128 query rows):
//    warpgroups 0 and 1 are consumers of 64 rows each, warpgroup 2 the
//    producer.  setmaxnreg gives the producer 24 registers and each consumer
//    240 (the O accumulator alone is 128 f32 a thread at D = 256; ptxas uses
//    ~210 and spills nothing);
//  * one producer thread issues TMA loads (cp.async.bulk.tensor.4d) over the
//    strided (D, S, H, B) view of each operand, in boxes of 64 elements
//    (128 bytes) along D with 128-byte swizzle, so the model's (B, S, H, D)
//    activations are read without a copy and D = 256 takes four boxes.  Q is
//    loaded once; K and V tiles of BK = 64 keys go through a ring of stages
//    (2 at D = 256: Q 64 KB + 2 x (32 + 32) KB; up to 4 at smaller D).  Each
//    stage has full barriers for K and for V (TMA transaction bytes) and an
//    empty barrier the eight consumer warps arrive on, so the next tiles load
//    while the current one is multiplied;
//  * S = Q K^T is wgmma.mma_async m64n64k16 bf16 -> f32 with both operands in
//    shared memory, K-major; O += P V is the same shape with P from registers
//    (the S accumulator converted to bf16 in place: the accumulator and the
//    A-fragment layouts coincide for 16-bit types) and V read MN-major from
//    shared memory (the transpose flag; V needs no copy), one instruction per
//    64 columns of D.  FA3's intra-warpgroup overlap and ping-pong and a
//    persistent scheduler are later work;
//  * the loop visits only the kv tiles that meet the block's band (causal
//    k_start <= q_last, window k_end > q_first - window), so a sliding-window
//    layer costs O(S * window); a consumer skips a tile wholly masked for its
//    64 rows, and applies element masks (kv padding, causal, window) only on
//    tiles that cross an edge;
//  * numerics, against the TPU kernel: scores in f32 from exact bf16 products;
//    scale, then cap * tanh(s / cap) with tanh(x) = 1 - 2 / (2^(2x log2 e) + 1)
//    on ex2.approx and rcp.approx (absolute error ~1e-7 in tanh, ~5e-6 in a
//    score capped at 50; libm's tanhf is a multi-instruction routine and
//    tanh.approx's 2^-11 would be 0.024 in a score near the cap); log2 e is
//    folded in after the cap; the finite NEG_INF = -1e30 as in the reference,
//    so a row whose first visited tile is wholly masked accumulates p = 1 and
//    is wiped by alpha = 0 when a live key arrives; l sums p in f32;
//    finalize acc / max(l, 1e-30), out in bf16;
//  * P V runs as P_hi V + P_lo V, P split into two bf16 parts (~16 bits of
//    each probability): P rounded once to bf16 (2^-9 of a probability near 1)
//    put gemma2's layer outputs outside the card check's rtol 1e-2 / atol
//    1e-3 against the plain version, on rows with few keys or peaked scores.
//    The second product costs half again the tensor-core work;
//  * the heaviest causal q tiles (the last) are launched first.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                 // query rows of a block
constexpr int BK = 64;                  // keys of a kv tile
constexpr int CONSUMERS = 2;            // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + one producer warpgroup
constexpr int MAX_STAGES = 4;
constexpr int SMEM_MAX = 232448;        // a block's dynamic shared memory
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;
constexpr int PRODUCER_REGS = 24;       // setmaxnreg: 128 x 24 + 256 x 240
constexpr int CONSUMER_REGS = 240;      // <= 65,536

struct Params {
  void* o;
  long long os[3];                      // strides of o over (b, h, s), elements
  int Sq, Sk, D, group, causal, window, stages, n_qtiles;
  float sm_scale;                       // 1/sqrt(D) * log2 e (no soft-cap)
  float cap_in;                         // 2 log2 e / (sqrt(D) cap)
  float cap_out;                        // cap * log2 e (0: no soft-cap)
};

// ------------------------------------------------------------------ PTX glue

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed.  (A __trap() on a
// spin count here made ptxas spill the O accumulator and serialize the
// wgmmas.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptors, 128-byte swizzle.  The high word is the
// same for every operand here (stride between 8-row groups 1024 bytes,
// layout B128); the low word holds the start address >> 4 and the leading
// byte offset >> 4.  Offsets within a tile are added to the low word (the
// address field never carries: shared addresses stay under 2^18), and the two
// words meet inside the wgmma's asm, so no 64-bit descriptor is kept live.
constexpr uint32_t DESC_HI = (1024u >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across the
// asynchronous wgmma that owns it
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WGMMA_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"
#define WGMMA_OUT32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),    \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),             \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),             \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),             \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64); A and B in shared memory,
// both K-major, given by the low words of their descriptors
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint32_t a_lo, uint32_t b_lo,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"
      "setp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", da, db, p, 1, 1, 0, 0;\n}"
      : WGMMA_OUT32(d)
      : "r"(a_lo), "r"(b_lo), "r"(DESC_HI), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64); B in shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint32_t b_lo) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%36, %37};\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}"
      : WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo), "r"(DESC_HI), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------- kernel

// DPAD: D rounded up to a multiple of 64 (TMA fills the columns past D with
// zeros, which add nothing to q.k and land in output columns not written)
template <int DPAD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, Params p) {
  constexpr int NC = DPAD / 64;                     // 128-byte boxes along D
  constexpr uint32_t Q_CHUNK = BQ * 128;            // bytes of one Q box
  constexpr uint32_t KV_CHUNK = BK * 128;           // bytes of one K or V box
  constexpr uint32_t Q_BYTES = NC * Q_CHUNK;
  constexpr uint32_t KV_BYTES = NC * KV_CHUNK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];

  // 1024-byte alignment for the 128-byte swizzle atoms
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = sQ + Q_BYTES;                // stage s: K, then V
  const uint32_t bars = sKV + p.stages * 2 * KV_BYTES;
  // barriers: q_full, k_full[MAX_STAGES], v_full[MAX_STAGES], empty[MAX_STAGES]
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + MAX_STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * MAX_STAGES + s); };

  const int tile = p.n_qtiles - 1 - (int)blockIdx.x;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int q0 = tile * BQ;
  const int q_first = p.Sk - p.Sq + q0;                        // row 0's position
  const int q_last = p.Sk - p.Sq + min(q0 + BQ, p.Sq) - 1;     // last real row
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? (max(0, q_first - p.window + 1) / BK) * BK : 0;
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);         // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);   // warp-uniform
  if (wg == CONSUMERS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c) tma_load_4d(sQ + c * Q_CHUNK, &qmap, q_full, 64 * c, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % p.stages;
        const uint32_t round = (uint32_t)(it / p.stages);
        mbar_wait(empty(s), (round & 1u) ^ 1u);    // the first round passes
        const int k0 = k_lo + it * BK;
        const uint32_t sk = sKV + (uint32_t)s * 2 * KV_BYTES, sv = sk + KV_BYTES;
        mbar_expect_tx(k_full(s), KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) tma_load_4d(sk + c * KV_CHUNK, &kmap, k_full(s), 64 * c, k0, hk, b);
        mbar_expect_tx(v_full(s), KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) tma_load_4d(sv + c * KV_CHUNK, &vmap, v_full(s), 64 * c, k0, hk, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
    const int cw = wg;                           // rows 64 cw .. 64 cw + 63 of the tile
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r_lo = 16 * warp + lane / 4;        // this thread's rows: r_lo, r_lo + 8
    const int col0 = 2 * (lane % 4);              // and columns col0 + 8 i + {0, 1}
    const int wg_row0 = q0 + 64 * cw;
    const bool wg_live = wg_row0 < p.Sq;
    const int wg_first = p.Sk - p.Sq + wg_row0;           // positions of the
    const int wg_last = wg_first + 63;                    // warpgroup's rows
    const int pos0 = wg_first + r_lo;                     // this thread's rows
    const float cap_out = p.cap_out, cap_in = p.cap_in, sm_scale = p.sm_scale;

    float o[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    const uint32_t q_lo0 = desc_lo(sQ + (uint32_t)cw * 64 * 128, 16);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % p.stages;
      const uint32_t parity = (uint32_t)(it / p.stages) & 1u;
      const int k0 = k_lo + it * BK;
      const bool dead = !wg_live || (p.causal && k0 > wg_last) ||
                        (p.window > 0 && k0 + BK - 1 <= wg_first - p.window);
      if (dead) {                                 // wholly masked for these rows
        mbar_wait(v_full(s), parity);             // keeps the ring's order
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
        continue;
      }
      const bool edge = (p.causal && k0 + BK - 1 > wg_first) ||
                        (p.window > 0 && k0 <= wg_last - p.window) ||
                        (k0 + BK > p.Sk);
      const uint32_t sk = sKV + (uint32_t)s * 2 * KV_BYTES, sv = sk + KV_BYTES;
      const uint32_t k_lo_desc = desc_lo(sk, 16), v_lo_desc = desc_lo(sv, 1024);
      uint32_t q_lo = q_lo0;
      asm volatile("" : "+r"(q_lo));     // keeps q's 16 offsets in the loop

      // S = Q K^T over D, 16 at a time
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      mbar_wait(k_full(s), parity);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DPAD / 16; ++kk) {
        const uint32_t off = (uint32_t)(kk % 4) * 32;    // 16 columns in the box
        wgmma_ss(sc, q_lo + (((kk / 4) * Q_CHUNK + off) >> 4),
                 k_lo_desc + (((kk / 4) * KV_CHUNK + off) >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, soft-cap, mask (in log2 units); online softmax over the tile
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i];
        if (cap_out > 0.0f) x = cap_out - 2.0f * cap_out * rcp(ex2(x * cap_in) + 1.0f);
        else x *= sm_scale;
        if (edge) {
          const int qpos = pos0 + 8 * ((i >> 1) & 1);
          const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
          bool ok = kpos < p.Sk;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          x = ok ? x : NEG_INF;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += sc[i];
      }
      // P = hi + lo, both bf16 (A of the 4 k-steps of P V): ~16 bits of p
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = sc[8 * kk + 2 * j], b = sc[8 * kk + 2 * j + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
          const float2 h = __bfloat1622float2(hi);
          p_hi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][j] = pack_bf16(a - h.x, b - h.y);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

      // O += P_hi V + P_lo V, 16 keys at a time, one instruction per 64
      // columns of D
      mbar_wait(v_full(s), parity);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint32_t dv = v_lo_desc + ((c * KV_CHUNK + kk * 16 * 128) >> 4);
          wgmma_rs(o[c], p_hi[kk], dv);
          wgmma_rs(o[c], p_lo[kk], dv);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // finalize: acc / max(l, 1e-30); l's four partial sums of a row first
    if (wg_live) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float t = l[r];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        inv[r] = 1.0f / fmaxf(t, 1e-30f);
      }
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] + h * p.os[1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wg_row0 + r_lo + 8 * r;
        if (row >= p.Sq) continue;
        __nv_bfloat16* orow = out + (long long)row * p.os[2];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int col = 64 * c + 8 * i + col0;
            if (col < p.D)
              *reinterpret_cast<uint32_t*>(orow + col) =
                  pack_bf16(o[c][4 * i + 2 * r] * inv[r], o[c][4 * i + 2 * r + 1] * inv[r]);
          }
      }
    }
  }
}

// ----------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once in the copy of libcuda the
// process has loaded (no link against libcuda, no runtime-API signature)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a bf16 map over the (D, S, H, B) view of t with strides (b, h, s) in
// elements; boxes of 64 x rows x 1 x 1, 128-byte swizzle, zeros out of bounds
bool make_map(CUtensorMap* map, const void* t, int D, int S, int H, int B,
              const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DPAD>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   const Params& p, int B, int Hq, int smem, cudaStream_t stream) {
  // the opt-in above 48 KB, once per device (a later call may be captured
  // into a CUDA graph, where only stream work belongs)
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DPAD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid((unsigned)p.n_qtiles, (unsigned)Hq, (unsigned)B);
  flash_fwd_sm90_kernel<DPAD><<<grid, THREADS, smem, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on a launch, a cudaError_t from the launch, or -1 when libcuda
// refused a tensor map.  q, k, v, o are bf16; strides holds 12 element strides:
// (b, h, s) of q, k, v and o, in that order; D is contiguous in all four.
// The caller (kernels/flash_attention.py::plan) checks 16 <= D <= 256 with
// D % 16 == 0, Hq % Hkv == 0, Sq <= Sk when causal, 16-byte aligned base
// pointers and strides, 1 <= stages <= 4, and that smem bytes (1024 of
// alignment slack, Q, the stages and the barriers) fit 232,448.
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                             int B, int Hq, int Hkv, int Sq, int Sk, int D,
                             const long long* strides, int causal, int window,
                             float softcap, float scale, int stages, int smem,
                             void* stream) {
  if (D < 16 || D > 256 || D % 16 != 0 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 ||
      Sk < 1 || B < 1 || stages < 1 || stages > MAX_STAGES || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, D, Sq, Hq, B, strides, BQ) ||
      !make_map(&km, k, D, Sk, Hkv, B, strides + 3, BK) ||
      !make_map(&vm, v, D, Sk, Hkv, B, strides + 6, BK))
    return -1;
  Params p;
  p.o = o;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.Sq = Sq; p.Sk = Sk; p.D = D; p.group = Hq / Hkv;
  p.causal = causal; p.window = window; p.stages = stages;
  p.n_qtiles = (Sq + BQ - 1) / BQ;
  p.sm_scale = scale * LOG2E;
  p.cap_out = softcap > 0.0f ? softcap * LOG2E : 0.0f;
  p.cap_in = softcap > 0.0f ? 2.0f * LOG2E * scale / softcap : 0.0f;
  cudaStream_t s = (cudaStream_t)stream;
  const int dpad = (D + 63) / 64 * 64;
  if (dpad == 64) return (int)launch<64>(qm, km, vm, p, B, Hq, smem, s);
  if (dpad == 128) return (int)launch<128>(qm, km, vm, p, B, Hq, smem, s);
  if (dpad == 192) return (int)launch<192>(qm, km, vm, p, B, Hq, smem, s);
  return (int)launch<256>(qm, km, vm, p, B, Hq, smem, s);
}

}  // extern "C"
