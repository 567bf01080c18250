// weighted_agg_multi for Hopper (sm_90a): for every leaf i of a parameter tree,
// out_i[k, p] = sum_c w[c, k] * stack_i[c, p], all leaves in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/weighted_agg.py::weighted_agg_multi
// (FedHC stage-1 per-cluster aggregation: one pass over the (C, P) client stack
// for all K clusters), which the reference calls once per leaf
// (weighted_agg_multi_tree).
//
// Bound on the card: device-memory bytes, C * sum(P_i) + C * K + K * sum(P_i)
// elements, each moved once.  The kernel does 2K flops per stack element, K/2
// flop per byte in f32, far under the ~20 flop/byte where the H100's f32 units
// would become the limit, so tensor cores buy nothing.  One FedHC stage-1 at
// C = 800 (10 LeNet leaves, 44,426 columns, K = 4) reads 142 MB: 0.0427 ms at
// 3.35 TB/s.
//
// The old design and its numbers (PERF.md): one thread per column walking all
// C rows took 1.540 ms for that stage-1; splitting C over the 8 warps of a
// block and over blocks took 0.1146 ms, 37% of the bound, in ~19 dependent
// kernels: one launch per leaf (10 ctypes calls), plus a second kernel that
// summed the row splits of 9 of the 10 leaves, most of them moving a few KB;
// f1.w (69% of the bytes) kept ~30 KB of loads in flight per SM, and bf16
// stacks loaded one element a lane.
//
// This design:
//  * one launch per stage-1.  The wrapper (kernels/weighted_agg.py::
//    plan_grouped) cuts every leaf into column tiles of 32 * VEC columns; a
//    block takes one tile and finds its leaf in a descriptor table (input,
//    output, P, first tile, VEC) passed by value as a kernel parameter
//    (nothing is copied to the device, so the launch can be captured in a
//    CUDA graph).  LeNet's stage-1 is 355 blocks, 2.7 an SM of an H100;
//  * 16-byte loads wherever a leaf allows them (P * sizeof(T) % 16 == 0 and a
//    16-byte-aligned base): 4 f32 or 8 bf16 a lane.  Narrow or unaligned leaves
//    (LeNet's c1.w, c1.b, f3.b) take one element a lane;
//  * within a block the 8 warps share the rows: warp w takes rows w, w + 8,
//    ..., so no warp walks all of C.  Each thread issues the loads of ROWS
//    rows (8; 4 where K * VEC accumulators are many) before its first FMA:
//    32 KB of loads in flight a block, and three blocks an SM for the f32
//    stage-1 (launch bounds cap it at 80 registers);
//  * the (C, K) weights are staged in shared memory a chunk of rows at a
//    time, padded to KMAX = 4, 8 or 16 (the smallest bucket >= K) with zeros
//    so the inner loop has no branch on K;
//  * any K.  A thread keeps KMAX x VEC accumulators in registers, so K above
//    16 is cut into passes of 16 clusters: the grid has a block for every
//    (column tile, pass), the pass varying fastest, so the blocks of one tile
//    run side by side and the later passes find the tile's rows in L2.  One
//    pass of 32 clusters with 2 elements a lane (no re-read, fewer bytes in
//    flight a load) was slower at every K and dtype measured on an H100 SXM
//    at 700 W (PERF.md), and went.  On that card the passes run at ~30% of
//    the byte bound at K = 17 and 32: a thread does 64 FMAs and 16
//    shared-memory weight reads a 16-byte load, and at 188 registers an SM
//    holds one block;
//  * any number of leaves: the wrapper cuts a tree of more than MAX_LEAVES
//    leaves into launches of at most MAX_LEAVES, each with its own table;
//  * the block sums its warps' partials in warp order in shared memory and
//    writes the tile's outputs once.  No atomics and no second kernel: two
//    calls on the same inputs give the same bits;
//  * no row splits across blocks.  A version that split a tile's rows over
//    the blocks of a thread-block cluster and summed them through
//    distributed shared memory was slower at every split count for the
//    stage-1 at C = 800 (0.0525 ms with one split, 0.0724 with eight) and no
//    faster at C = 10,000 (0.590-0.599 ms with one to three), on an H100 SXM
//    at 700 W (PERF.md): once the tiles fill the card a split only adds a
//    block's set-up and reduction;
//  * f32 and bf16 stacks, always f32 accumulation, output in the stack's dtype;
//    the ragged edge of P is masked, not padded (the TPU kernel padded P to
//    BLOCK_P = 2048 lanes).
// Plain 16-byte loads are kept, with no TMA producer warp: on the H100 they
// reach 82% of the byte bound at C = 800 and ~90% at C = 10,000 (PERF.md), so
// a bulk-copy ring would buy at most the remaining tenth or two.
//
// A stack of few clients (C <= SMALL_C_ROWS = 8: the transformer FL round,
// four gemma2-2b clients, 2.61e9 columns) leaves most of the design above
// idle: at C = 4 half of a block's warps have no row, the other half issue
// one 16-byte load each, and 10.2M blocks of 256 columns each pay a weight
// stage and a reduction through shared memory for ~3 KB of traffic.  On an
// H100 SXM at 700 W that stage-1 took 157 ms against its 9.36 ms byte bound
// (PERF.md, row 1e).  So at C <= 8 a block's tile is THREADS lanes wide
// instead of 32 (2048 bf16 or 1024 f32 columns), each thread owns its 16
// bytes of columns in every row: it issues all C loads first, then for each
// cluster sums its rows in row order in f32 (no shared memory, no
// reduction across warps) and stores 16 bytes.  Same table, same grid rule
// (a block a tile and pass), deterministic; wagg_grouped_rows_kernel, one
// copy with its row loops unrolled to SMALL_C_ROWS.  On the same card the
// gemma2-2b stage-1 then took 12.65 ms, 74% of the bound (one bf16
// torch.matmul a leaf: 72.9 ms).
//
// weighted_agg (K = 1) with small C (kernels/weighted_agg.py::plan picks it
// for C <= SMALL_C_MAX) replaces the Pallas TPU kernel
// repro/kernels/weighted_agg.py::weighted_agg and is bound by bytes too.  At
// small C a split over warps leaves each thread few loads in flight and pays
// the reduction through shared memory for one output, so wagg_small_c_kernel
// streams instead: each thread owns 16 bytes of columns (4 f32 or 8 bf16; 1
// element where P or the stack is not 16-byte aligned), issues the loads of
// all C rows before its first FMA (CMAX, the smallest bucket >= C, unrolled),
// reads the weights through the read-only cache, sums in row order in f32 with
// no shared memory and no second pass, and writes its 16 bytes once.
// Deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_LEAVES = 64;     // descriptor table entries (kernel parameter)
constexpr int CHUNK_FLOATS = 4096; // weights staged at once: 4096 / KMAX rows
constexpr int SMALL_C_ROWS = 8;    // C at most this: a thread owns its rows

struct Leaf {
  const void* in;   // (C, P) stack of the leaf
  void* out;        // (K, P) output of the leaf
  long long P;
  int first;        // first column tile of the leaf in the grid
  int vec;          // elements a lane loads from a row: 16 / sizeof(T), or 1
};

struct Table {      // leaves in work order
  Leaf leaf[MAX_LEAVES];
  int n;
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes as 4 f32 or 8 bf16, and back
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  __nv_bfloat162 h;
  memcpy(&h, &v, 4);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = bf2(w[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ uint4 pack16(const float (&f)[VEC]) {
  if constexpr (VEC == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      memcpy(&w[i], &h, 4);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// one row of a lane's columns: 16 bytes, or one element
template <typename T, int VEC> struct Row { using type = uint4; };
template <typename T> struct Row<T, 1> { using type = T; };

template <typename T, int VEC>
__device__ __forceinline__ typename Row<T, VEC>::type load_row(const T* p) {
  if constexpr (VEC == 1) return __ldg(p);
  else return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T, int KMAX, int VEC>
__device__ __forceinline__ void fma_row(float (&acc)[KMAX][VEC],
                                        const typename Row<T, VEC>::type& x,
                                        const float* wr) {
  float e[VEC];
  if constexpr (VEC == 1) e[0] = to_f32(x);
  else unpack16(x, e);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const float wk = wr[k];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = fmaf(wk, e[v], acc[k][v]);
  }
}

// One block: column tile `tile` of leaf `lf`, all C rows, clusters k0 to
// k0 + KMAX - 1 (those below K).
template <typename T, int KMAX, int VEC>
__device__ __forceinline__ void grouped_tile(
    const Leaf& lf, int tile, int C, const float* __restrict__ w, int K,
    int k0, float* smem) {
  constexpr int TILE = 32 * VEC;
  constexpr int ROWS = KMAX * VEC >= 128 ? 4 : 8;  // loads before the first FMA
  constexpr int CHUNK_ROWS = CHUNK_FLOATS / KMAX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long P = lf.P;
  const long long t0 = (long long)tile * TILE;     // the tile's first column
  const long long col = t0 + lane * VEC;           // this lane's first column
  const bool active = col < P;
  const T* in = static_cast<const T*>(lf.in) + col;

  float acc[KMAX][VEC];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CHUNK_ROWS) {
    const int cn = min(CHUNK_ROWS, C - c0);
    __syncthreads();                       // previous chunk fully consumed
    for (int i = threadIdx.x; i < cn * KMAX; i += THREADS) {
      const int c = i / KMAX, k = i - c * KMAX;
      smem[i] = k0 + k < K ? __ldg(w + (long long)(c0 + c) * K + k0 + k) : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    const T* base = in + (long long)c0 * P;
    int c = warp;
    for (; c + (ROWS - 1) * WARPS < cn; c += ROWS * WARPS) {
      typename Row<T, VEC>::type x[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        x[r] = load_row<T, VEC>(base + (long long)(c + r * WARPS) * P);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        fma_row<T, KMAX, VEC>(acc, x[r], smem + (c + r * WARPS) * KMAX);
    }
    if (c < cn) {                          // the last, partial batch of rows
      typename Row<T, VEC>::type x[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (c + r * WARPS < cn)
          x[r] = load_row<T, VEC>(base + (long long)(c + r * WARPS) * P);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (c + r * WARPS < cn)
          fma_row<T, KMAX, VEC>(acc, x[r], smem + (c + r * WARPS) * KMAX);
    }
  }

  // the tile's outputs, summed over warps in warp order
  T* out = static_cast<T*>(lf.out);
  float* red = smem;                       // (WARPS, TILE)
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k0 + k >= K) break;
    __syncthreads();                       // weights / red consumed
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[warp * TILE + lane * VEC + v] = acc[k][v];
    __syncthreads();
    for (int j = threadIdx.x; j < TILE; j += THREADS) {
      const long long p = t0 + j;
      if (p >= P) continue;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) s += red[i * TILE + j];
      store(out + (long long)(k0 + k) * P + p, s);
    }
  }
}

// blocks an SM should hold: 3 (at most 85 registers a thread) where a
// thread's accumulators and loads in flight fit (f32, K <= 4: the FL
// stage-1); wider accumulators keep the compiler's choice
template <typename T, int KMAX>
__host__ __device__ constexpr int min_blocks() { return KMAX * (16 / (int)sizeof(T)) <= 16 ? 3 : 1; }

// block b: column tile b / passes, clusters from (b % passes) * KMAX
template <typename T, int KMAX>
__global__ void __launch_bounds__(THREADS, (min_blocks<T, KMAX>()))
wagg_grouped_kernel(const __grid_constant__ Table tab,
                    const float* __restrict__ w, int C, int K, int passes) {
  constexpr int VW = 16 / sizeof(T);       // a lane's 16 bytes: 4 f32, 8 bf16
  __shared__ __align__(16) float smem[cmax(CHUNK_FLOATS, WARPS * 32 * VW)];
  const int tile = blockIdx.x / passes;
  const int k0 = (blockIdx.x - tile * passes) * KMAX;
  int li = 0;
  for (int i = 1; i < tab.n; ++i)
    if (tab.leaf[i].first <= tile) li = i;
  const Leaf& lf = tab.leaf[li];
  if (lf.vec == 1)
    grouped_tile<T, KMAX, 1>(lf, tile - lf.first, C, w, K, k0, smem);
  else
    grouped_tile<T, KMAX, VW>(lf, tile - lf.first, C, w, K, k0, smem);
}

// One block at C <= SMALL_C_ROWS rows: column tile `tile` of leaf `lf`,
// THREADS lanes of VEC columns, clusters k0 to k0 + KMAX - 1 (those below
// K).  The row loops are unrolled to SMALL_C_ROWS and guarded by C.
template <typename T, int KMAX, int VEC>
__device__ __forceinline__ void rows_tile(const Leaf& lf, int tile, int C,
                                          const float* __restrict__ w, int K,
                                          int k0) {
  const long long P = lf.P;
  const long long col = ((long long)tile * THREADS + threadIdx.x) * VEC;
  if (col >= P) return;
  const T* in = static_cast<const T*>(lf.in) + col;
  typename Row<T, VEC>::type x[SMALL_C_ROWS];
#pragma unroll
  for (int c = 0; c < SMALL_C_ROWS; ++c)
    if (c < C) x[c] = load_row<T, VEC>(in + (long long)c * P);
  T* out = static_cast<T*>(lf.out) + col;
  // a leaf's outputs start on a 16-byte boundary unless a narrower leaf
  // came before it in the buffer: then its lanes store element by element
  const bool wide = VEC > 1 && ((uintptr_t)lf.out & 15) == 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k0 + k >= K) break;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int c = 0; c < SMALL_C_ROWS; ++c) {
      if (c < C) {
        const float wk = __ldg(w + (long long)c * K + k0 + k);
        float e[VEC];
        if constexpr (VEC == 1) e[0] = to_f32(x[c]);
        else unpack16(x[c], e);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wk, e[v], acc[v]);
      }
    }
    T* o = out + (long long)(k0 + k) * P;
    if constexpr (VEC > 1) {
      if (wide) {
        *reinterpret_cast<uint4*>(o) = pack16<T, VEC>(acc);
        continue;
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) store(o + v, acc[v]);
  }
}

// C <= SMALL_C_ROWS: block b takes column tile b / passes (THREADS lanes)
// and clusters from (b % passes) * KMAX
template <typename T, int KMAX>
__global__ void __launch_bounds__(THREADS, 2)
wagg_grouped_rows_kernel(const __grid_constant__ Table tab,
                         const float* __restrict__ w, int C, int K,
                         int passes) {
  constexpr int VW = 16 / sizeof(T);
  const int tile = blockIdx.x / passes;
  const int k0 = (blockIdx.x - tile * passes) * KMAX;
  int li = 0;
  for (int i = 1; i < tab.n; ++i)
    if (tab.leaf[i].first <= tile) li = i;
  const Leaf& lf = tab.leaf[li];
  if (lf.vec == 1)
    rows_tile<T, KMAX, 1>(lf, tile - lf.first, C, w, K, k0);
  else
    rows_tile<T, KMAX, VW>(lf, tile - lf.first, C, w, K, k0);
}

template <typename T>
cudaError_t launch_grouped(const Table& tab, const float* w, int C, int K,
                           int kmax, int tiles, cudaStream_t s) {
  const int passes = (K + kmax - 1) / kmax;
  const unsigned grid = (unsigned)tiles * (unsigned)passes;
  if (C <= SMALL_C_ROWS) {
    if (kmax == 4)
      wagg_grouped_rows_kernel<T, 4><<<grid, THREADS, 0, s>>>(tab, w, C, K, passes);
    else if (kmax == 8)
      wagg_grouped_rows_kernel<T, 8><<<grid, THREADS, 0, s>>>(tab, w, C, K, passes);
    else
      wagg_grouped_rows_kernel<T, 16><<<grid, THREADS, 0, s>>>(tab, w, C, K, passes);
  } else if (kmax == 4) {
    wagg_grouped_kernel<T, 4><<<grid, THREADS, 0, s>>>(tab, w, C, K, passes);
  } else if (kmax == 8) {
    wagg_grouped_kernel<T, 8><<<grid, THREADS, 0, s>>>(tab, w, C, K, passes);
  } else {
    wagg_grouped_kernel<T, 16><<<grid, THREADS, 0, s>>>(tab, w, C, K, passes);
  }
  return cudaGetLastError();
}

template <typename T, int CMAX, int VEC>
__global__ void __launch_bounds__(THREADS)
wagg_small_c_kernel(const T* __restrict__ stack, const float* __restrict__ w,
                    T* __restrict__ out, int C, long long P) {
  const long long p0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (p0 >= P) return;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  if constexpr (VEC == 1) {
    float x[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) x[c] = to_f32(stack[(long long)c * P + p0]);
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) acc[0] = fmaf(__ldg(w + c), x[c], acc[0]);
    store(out + p0, acc[0]);
  } else {
    // 16 bytes a row: VEC = 16 / sizeof(T) elements
    uint4 x[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) x[c] = __ldg(reinterpret_cast<const uint4*>(stack + (long long)c * P + p0));
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        const float wc = __ldg(w + c);
        float e[VEC];
        unpack16(x[c], e);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wc, e[v], acc[v]);
      }
    }
    *reinterpret_cast<uint4*>(out + p0) = pack16<T>(acc);
  }
}

template <typename T, int VEC>
cudaError_t launch_small_c(const T* stack, const float* w, T* out, int C,
                           long long P, cudaStream_t stream) {
  const long long threads = (P + VEC - 1) / VEC;
  const unsigned grid = (unsigned)((threads + THREADS - 1) / THREADS);
  if (C <= 8)
    wagg_small_c_kernel<T, 8, VEC><<<grid, THREADS, 0, stream>>>(stack, w, out, C, P);
  else if (C <= 16)
    wagg_small_c_kernel<T, 16, VEC><<<grid, THREADS, 0, stream>>>(stack, w, out, C, P);
  else
    wagg_small_c_kernel<T, 32, VEC><<<grid, THREADS, 0, stream>>>(stack, w, out, C, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// weighted_agg_multi over n <= MAX_LEAVES leaves in one launch.  dtype 0 =
// f32, 1 = bf16 (every leaf).  The arrays hold the leaves in work order:
// input (C, P_i) and output (K, P_i) pointers, P_i, the first column tile of
// each leaf and its elements a lane (16 / sizeof(T) or 1; 16 needs P_i *
// sizeof(T) % 16 == 0 and a 16-byte-aligned input).  Leaf i has
// ceil(P_i / (lanes * vec_i)) column tiles, lanes = THREADS at C <=
// SMALL_C_ROWS and 32 above; the tiles of the leaves are consecutive and
// number `tiles`.  kmax (4, 8 or 16) clusters a pass,
// ceil(K / kmax) passes (kmax 4 and 8 take one): one block for each (tile,
// pass).  Returns cudaGetLastError() after the launch (0 =
// cudaSuccess), or cudaErrorInvalidValue for arguments the kernel does not
// take; the caller checks contiguity, placement and that the weights are
// (C, K) f32.
int wagg_grouped(int dtype, int n, const void* const* ins, void* const* outs,
                 const long long* ps, const int* firsts, const int* vecs,
                 int tiles, const float* w, int C, int K, int kmax,
                 void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (n < 1 || n > MAX_LEAVES || K < 1 || C < 1 || tiles < 1)
    return (int)cudaErrorInvalidValue;
  if ((kmax != 4 && kmax != 8 && kmax != 16) || (kmax < 16 && K > kmax))
    return (int)cudaErrorInvalidValue;
  if ((long long)tiles * ((K + kmax - 1) / kmax) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  const int vw = 16 / esize;
  const long long lanes = C <= SMALL_C_ROWS ? THREADS : 32;
  Table tab;
  memset(&tab, 0, sizeof(tab));
  tab.n = n;
  long long next = 0;
  for (int i = 0; i < n; ++i) {
    const long long P = ps[i];
    const int vec = vecs[i];
    if (P < 1 || (vec != 1 && vec != vw) || firsts[i] != next)
      return (int)cudaErrorInvalidValue;
    if (vec == vw && ((P * esize) % 16 != 0 || (uintptr_t)ins[i] % 16 != 0))
      return (int)cudaErrorInvalidValue;
    tab.leaf[i] = Leaf{ins[i], outs[i], P, firsts[i], vec};
    next += (P + lanes * vec - 1) / (lanes * vec);
  }
  if (next != tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_grouped<float>(tab, w, C, K, kmax, tiles, s);
  return (int)launch_grouped<__nv_bfloat16>(tab, w, C, K, kmax, tiles, s);
}

// weighted_agg, K = 1, 1 <= C <= 32: out (P,) = w (C,) . stack (C, P).
// vec 16 (bytes) needs P * sizeof(T) % 16 == 0 and a 16-byte-aligned stack
// and out; vec 1 takes any.  Returns cudaGetLastError() after the launch.
int wagg_small_c(int dtype, const void* stack, const float* w, void* out,
                 int C, long long P, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C < 1 || C > 32 || P < 1) return (int)cudaErrorInvalidValue;
  const bool v16 = vec == 16;
  if (v16 && ((uintptr_t)stack % 16 != 0 || (uintptr_t)out % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (v16 && P % 4 != 0) return (int)cudaErrorInvalidValue;
    return v16 ? (int)launch_small_c<float, 4>((const float*)stack, w, (float*)out, C, P, s)
               : (int)launch_small_c<float, 1>((const float*)stack, w, (float*)out, C, P, s);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (v16 && P % 8 != 0) return (int)cudaErrorInvalidValue;
    return v16 ? (int)launch_small_c<bf, 8>((const bf*)stack, w, (bf*)out, C, P, s)
               : (int)launch_small_c<bf, 1>((const bf*)stack, w, (bf*)out, C, P, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
