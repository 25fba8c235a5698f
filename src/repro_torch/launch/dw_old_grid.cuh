// The dW grid instance as it was before the packed tile: one CTA per
// (selected block, 64-column tile, 64-row fan-in tile, expert), [32 x 64]
// tiles of x and dy widened to fp32 in shared memory by element loads, a
// 4 x 4 fp32 accumulator a thread. Not built with the port: `python -m
// repro_torch.launch.dw_probe` splices it into a copy of
// `kernels/csrc/block_sparse_dw.cu` (variant `old_grid`) to time it beside
// the shipped grid instance and to check that their fp32 results are
// bitwise equal.

namespace old_grid {

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    kernel(const T* __restrict__ x, const T* __restrict__ dy,
           const int* __restrict__ idx, float* __restrict__ out, Geometry g,
           int batched) {
  grid_tile<T>(x, dy, idx, out, g, batched ? (int64_t)blockIdx.z : 0);
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const int* idx, float* out,
                   int64_t e, int64_t m, int64_t k, int64_t n, int n_shards,
                   int n_sel, int block, bool batched, cudaStream_t stream) {
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
  const dim3 grid((unsigned)(g.n_shards * g.n_sel * g.col_tiles),
                  (unsigned)((g.K + TK - 1) / TK), (unsigned)e);
  kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x),
                                          static_cast<const T*>(dy), idx, out,
                                          g, (int)batched);
  return cudaGetLastError();
}

}  // namespace old_grid
