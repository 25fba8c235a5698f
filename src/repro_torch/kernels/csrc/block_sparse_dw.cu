// Compact weight gradient of the channel-block sparse update, for Hopper,
// for one weight or for a stack of E experts that share one selection.
//
//   x:   [E, M, K]              activations (fan-in K), fp32 or bf16
//   dy:  [E, M, N]              upstream gradient, same type,
//                               N = n_shards * n_blocks * block
//   idx: [n_shards, n_sel]      int32 selected block indices, local to each
//                               shard, shared by every expert
//   out: [E, K, n_shards, n_sel, block] fp32
//
//   out[e, :, s, j, :] = x[e]^T @ dy[e][:, (s*n_blocks + idx[s,j])*block : +block]
//
// Replaces four TPU kernels of the reference package: `block_sparse_dw_kernel`
// and `block_sparse_dw_pipelined_kernel` (src/repro/kernels/masked_dw.py; a
// dense layer's weight, E = 1, entry point `block_sparse_dw_launch`) and
// `batched_dw_kernel` and `batched_dw_pipelined_kernel`
// (src/repro/kernels/batched_dw.py; the MoE expert leaves [E, K, N], entry
// point `batched_dw_launch`). Unselected dy blocks are never read.
//
// Bound on an H100: 2*E*M*K*n_sel*n_shards*block operations against
// E*(M*K + M*n_sel*n_shards*block) input elements plus the fp32 output.
// A dense layer at the LM path's shapes (M = 4096 tokens, block 128) does
// some 250 to 2000 operations a byte, above the card's ~295 for bf16, so
// the tensor cores' rate bounds it. An expert leaf at deepseek-moe-16b's
// shapes (E = 64, M = capacity 481, block 128, n_sel 2-3 of 11-16) does
// fewer, ~120 a byte, the fp32 output being the largest term (134 MB for
// w_gate), so the memory rate bounds it. This version runs on the fp32
// CUDA cores (exact products of bf16 inputs, fp32 sums, like the
// reference's preferred_element_type=f32) and so sits well below either
// bound; a wgmma version is later work.
//
// Design. One block of 256 threads per (shard*selected block, column
// tile of BN, K tile of TK, expert). The expert is blockIdx.z: each tensor
// has a per-expert stride (M*K for x, M*N for dy, K*n_shards*n_sel*block for
// out) and a block first moves its three base pointers to its expert, so
// one launch covers every expert and shard with the single-weight tiling.
// One source rather than a copy of the tiling per entry point: the dense
// and the expert dW share every fix and every later speed-up, and a single
// weight is expert 0 of one. The block reads idx[s, j] from device memory
// itself, so a new selection (every step of the dynamic phase) needs no
// host sync and no rebuild. It loops over M, staging a [TM, TK] tile of x
// and a [TM, BN] tile of the selected dy columns in shared memory, and each
// thread keeps a 4x4 fp32 accumulator in registers. Nothing carries between
// blocks, so the output needs no reduction pass and no atomics: the result
// is deterministic. Ragged K, M and block edges are masked (an expert's
// capacity M = 481 is no multiple of TM: the tail rows read as zeros and
// nothing is read past the expert's last row); offsets are 64-bit. Each
// output row of a tile is written by 16 neighbouring threads at
// neighbouring addresses.
//
// Two instances of the same tiling:
//  - grid: synchronous loads, converting to fp32 into shared memory; takes
//    any block width and any alignment.
//  - pipelined: a double-buffered cp.async M loop, raw tiles in shared
//    memory, the next tile in flight while the current one is consumed.
//    It needs rows, block and pointers 16-byte aligned (checked by the
//    wrapper; K and N 16-byte aligned make every expert's base aligned too).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;        // output rows (fan-in K) per block
constexpr int BN = 64;        // output columns of one selected block per block
constexpr int TM = 32;        // contraction rows staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct Geometry {
  int64_t M, K, N;
  int n_shards, n_sel, block, n_blocks, col_tiles;
  int64_t x_stride, dy_stride, out_stride;   // per expert, in elements
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Tile {
  int sj;         // s * n_sel + j
  int ct;         // column tile within the selected block
  int64_t col0;   // first dy column of this tile
  int ncol;       // valid columns in this tile
  int64_t k0;     // first fan-in row of this tile
  int nk;         // valid fan-in rows in this tile
};

__device__ __forceinline__ Tile tile_of(const int* __restrict__ idx,
                                        const Geometry& g) {
  Tile t;
  t.sj = blockIdx.x / g.col_tiles;
  t.ct = blockIdx.x % g.col_tiles;
  const int s = t.sj / g.n_sel;
  int sel = idx[t.sj];
  // indices are trusted; the clamp only keeps a bad one inside the tensor
  sel = min(max(sel, 0), g.n_blocks - 1);
  t.col0 = ((int64_t)s * g.n_blocks + sel) * g.block + (int64_t)t.ct * BN;
  t.ncol = min(BN, g.block - t.ct * BN);
  t.k0 = (int64_t)blockIdx.y * TK;
  const int64_t k_left = g.K - t.k0;
  t.nk = k_left < TK ? (int)k_left : TK;
  return t;
}

__device__ __forceinline__ void store_tile(float (&acc)[4][4], float* out,
                                           const Tile& t, const Geometry& g,
                                           int tx, int ty) {
  // out[k, s, j, c] sits at (k * n_shards * n_sel + s * n_sel + j) * block + c
  const int64_t row_stride = (int64_t)g.n_shards * g.n_sel * g.block;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = ty + 16 * i;
    if (kk >= t.nk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c >= t.ncol) continue;
      out[(t.k0 + kk) * row_stride + (int64_t)t.sj * g.block +
          (int64_t)t.ct * BN + c] = acc[i][j];
    }
  }
}

// The block's tile of one expert's output (expert 0 for a single weight).
template <typename T>
__device__ __forceinline__ void grid_tile(const T* __restrict__ x,
                                          const T* __restrict__ dy,
                                          const int* __restrict__ idx,
                                          float* __restrict__ out,
                                          const Geometry& g, int64_t expert) {
  __shared__ float xs[TM][TK];
  __shared__ float ds[TM][BN];
  x += expert * g.x_stride;
  dy += expert * g.dy_stride;
  out += expert * g.out_stride;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const Tile t = tile_of(idx, g);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t m0 = 0; m0 < g.M; m0 += TM) {
    for (int e = tid; e < TM * TK; e += THREADS) {
      const int r = e / TK, c = e % TK;
      const int64_t m = m0 + r;
      xs[r][c] = (m < g.M && c < t.nk) ? to_f32(x[m * g.K + t.k0 + c]) : 0.f;
    }
    for (int e = tid; e < TM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int64_t m = m0 + r;
      ds[r][c] = (m < g.M && c < t.ncol) ? to_f32(dy[m * g.N + t.col0 + c])
                                         : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < TM; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ds[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  store_tile(acc, out, t, g, tx, ty);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  // src_bytes 0 fills the 16 shared-memory bytes with zeros (masked edge)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the async copies of one stage: x[m0:m0+TM, k0:k0+TK] into xs and the
// selected dy columns [m0:m0+TM, col0:col0+BN] into ds. The wrapper
// guarantees K, block and the pointers are 16-byte aligned, so a chunk is
// either wholly inside the tile or wholly outside it (then zero-filled).
template <typename T>
__device__ __forceinline__ void issue_stage(T* xs, T* ds,
                                            const T* __restrict__ x,
                                            const T* __restrict__ dy,
                                            const Tile& t, const Geometry& g,
                                            int64_t m0, int tid) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte chunk
  for (int c = tid; c < TM * TK / VEC; c += THREADS) {
    const int r = c / (TK / VEC), cc = (c % (TK / VEC)) * VEC;
    const int64_t m = m0 + r;
    const bool ok = m < g.M && cc < t.nk;
    cp_async16(xs + r * TK + cc, ok ? x + m * g.K + t.k0 + cc : x,
               ok ? 16 : 0);
  }
  for (int c = tid; c < TM * BN / VEC; c += THREADS) {
    const int r = c / (BN / VEC), cc = (c % (BN / VEC)) * VEC;
    const int64_t m = m0 + r;
    const bool ok = m < g.M && cc < t.ncol;
    cp_async16(ds + r * BN + cc, ok ? dy + m * g.N + t.col0 + cc : dy,
               ok ? 16 : 0);
  }
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ void pipelined_tile(const T* __restrict__ x,
                                               const T* __restrict__ dy,
                                               const int* __restrict__ idx,
                                               float* __restrict__ out,
                                               const Geometry& g,
                                               int64_t expert) {
  __shared__ __align__(16) T xs[2][TM][TK];
  __shared__ __align__(16) T ds[2][TM][BN];
  x += expert * g.x_stride;
  dy += expert * g.dy_stride;
  out += expert * g.out_stride;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const Tile t = tile_of(idx, g);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int64_t n_m = (g.M + TM - 1) / TM;
  issue_stage(&xs[0][0][0], &ds[0][0][0], x, dy, t, g, 0, tid);
  for (int64_t it = 0; it < n_m; ++it) {
    const int buf = (int)(it & 1);
    if (it + 1 < n_m) {
      // the other buffer was last read in the previous iteration, which
      // ended in __syncthreads()
      issue_stage(&xs[buf ^ 1][0][0], &ds[buf ^ 1][0][0], x, dy, t, g,
                  (it + 1) * TM, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < TM; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f32(xs[buf][r][ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_f32(ds[buf][r][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_tile(acc, out, t, g, tx, ty);
}

// Four kernels, two tilings times two entry points: the batched ones take
// their expert from blockIdx.z, and have names of their own so that a
// profile tells the expert dW from a dense layer's.
#define DW_KERNEL(name, tile, expert)                                        \
  template <typename T>                                                      \
  __global__ void __launch_bounds__(THREADS)                                 \
      name(const T* __restrict__ x, const T* __restrict__ dy,               \
           const int* __restrict__ idx, float* __restrict__ out,            \
           Geometry g) {                                                     \
    tile<T>(x, dy, idx, out, g, expert);                                    \
  }
DW_KERNEL(dw_grid_kernel, grid_tile, 0)
DW_KERNEL(dw_pipelined_kernel, pipelined_tile, 0)
DW_KERNEL(batched_dw_grid_kernel, grid_tile, (int64_t)blockIdx.z)
DW_KERNEL(batched_dw_pipelined_kernel, pipelined_tile, (int64_t)blockIdx.z)
#undef DW_KERNEL

template <typename T>
cudaError_t launch(const void* x, const void* dy, const int* idx, float* out,
                   const Geometry& g, int experts, bool batched,
                   int pipelined, cudaStream_t stream) {
  const dim3 grid((unsigned)(g.n_shards * g.n_sel * g.col_tiles),
                  (unsigned)((g.K + TK - 1) / TK), (unsigned)experts);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  if (!batched && pipelined) {
    dw_pipelined_kernel<T><<<grid, THREADS, 0, stream>>>(xt, dyt, idx, out,
                                                         g);
  } else if (!batched) {
    dw_grid_kernel<T><<<grid, THREADS, 0, stream>>>(xt, dyt, idx, out, g);
  } else if (pipelined) {
    batched_dw_pipelined_kernel<T><<<grid, THREADS, 0, stream>>>(
        xt, dyt, idx, out, g);
  } else {
    batched_dw_grid_kernel<T><<<grid, THREADS, 0, stream>>>(xt, dyt, idx,
                                                            out, g);
  }
  return cudaGetLastError();
}

int run(const void* x, const void* dy, const void* idx, void* out,
        bool batched, int64_t e, int64_t m, int64_t k, int64_t n,
        int n_shards, int n_sel, int block, int dtype, int pipelined,
        void* stream) {
  Geometry g;
  g.M = m;
  g.K = k;
  g.N = n;
  g.n_shards = n_shards;
  g.n_sel = n_sel;
  g.block = block;
  g.n_blocks = (int)(n / ((int64_t)n_shards * block));
  g.col_tiles = (block + BN - 1) / BN;
  g.x_stride = m * k;
  g.dy_stride = m * n;
  g.out_stride = k * n_shards * n_sel * block;
  const int* ip = static_cast<const int*>(idx);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int experts = (int)e;
  if (dtype == 0)
    return (int)launch<float>(x, dy, ip, op, g, experts, batched, pipelined,
                              st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dy, ip, op, g, experts, batched,
                                      pipelined, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Each returns the launch's cudaGetLastError().

// One weight: x [M, K], dy [M, N], out [K, n_shards, n_sel, block].
extern "C" int block_sparse_dw_launch(const void* x, const void* dy,
                                      const void* idx, void* out, int64_t m,
                                      int64_t k, int64_t n, int n_shards,
                                      int n_sel, int block, int dtype,
                                      int pipelined, void* stream) {
  return run(x, dy, idx, out, false, 1, m, k, n, n_shards, n_sel, block,
             dtype, pipelined, stream);
}

// E experts, one launch: x [E, C, K], dy [E, C, N],
// out [E, K, n_shards, n_sel, block]; E <= 65535 (the grid's z).
extern "C" int batched_dw_launch(const void* x, const void* dy,
                                 const void* idx, void* out, int64_t e,
                                 int64_t c, int64_t k, int64_t n,
                                 int n_shards, int n_sel, int block,
                                 int dtype, int pipelined, void* stream) {
  return run(x, dy, idx, out, true, e, c, k, n, n_shards, n_sel, block,
             dtype, pipelined, stream);
}
