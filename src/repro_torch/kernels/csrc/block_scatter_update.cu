// Block scatter-update for Hopper: a stacked weight with its selected
// column blocks overwritten, in place or into a second tensor.
//
//   out[k, r, (s * n_blocks + idx[k, s, j]) * block + c] = cast(upd[k, r, s, j, c])
//   out = w everywhere else
//
//   w, out [K, R, N]               fp32 or bf16, N = S * n_blocks * block
//   upd    [K, R, S, n_sel, block] fp32, or w's type
//   idx    [K, S, n_sel]           int32, block ids local to each shard
//
// One entry, two modes: `out == w` writes in place (only the selected
// blocks are written, the rest is neither read nor written); any other
// `out` (which must not overlap w) receives the whole result in one pass,
// so a caller that must keep w needs no copy of it first.
//
// Replaces the TPU kernel `block_scatter_update_kernel` of the reference
// package (src/repro/kernels/scatter_blocks.py), which aliases w to its
// output. A stacked leaf with lead dims ([K, E, d, N]) arrives with them
// flattened into R by the wrapper. idx is read from device memory inside
// the kernel, so a new selection rebuilds nothing. An index outside
// [0, n_blocks) is skipped (the plain version raises on it). Where a (k, s)
// names one block twice, the highest j wins, as the TPU kernel's
// sequential j axis gives.
//
// Rounding. fp32 -> bf16 is round-to-nearest-even (`__float2bfloat16_rn`),
// as `.astype` and `Tensor.to` do, and a NaN stores 0x7FC0 as `Tensor.to`
// does, so every stored value equals the plain version's (kernels/ref.py)
// bit for bit. Same-type copies move bits.
//
// Bound on an H100: memory, with no arithmetic to speak of. In place, upd
// is read once and the selected elements of w written once; out of place,
// the unselected elements of w are read, upd read and all of out written.
// At the serving wave's 7 llama3-8b leaves (bf16 w, fp32 upd, block 8,
// r = 0.25) that is 654.3 MB in place (0.195 ms at 3.35 TB/s) and 1962.9
// MB out of place (0.586 ms). A 32-byte sector of w holds two blocks of 8
// bf16, and at r = 0.25 a random selection touches 43.75% of the sectors,
// mostly half of one: if the memory system reads and writes back a partly
// written sector whole, the in-place floor is near 0.34 ms.
//
// Design: a walk in column order. A CTA takes one k, a tile of 8 rows and
// a span of SPAN 16-byte pieces of a row. It first builds a table in shared
// memory, block of the span -> upd slot s * n_sel + j (or -1), from
// idx[k]; then its threads walk the tile's rows, one piece each, so a warp
// covers 512 contiguous bytes of a row, and every index is worked out once
// a thread, in 32-bit arithmetic, not once a piece. A thread issues the
// loads of all its rows before the first cast and store. Out of place, every
// piece of the span is a thread's: a selected piece reads and casts its
// upd values (a whole 32-byte sector of fp32 upd at block 8), any other
// copies w's 16 bytes, and every store covers whole sectors and lines. In
// place, the span's selected pieces are first compacted, in column order,
// so that neighbouring lanes store neighbouring selected pieces in one
// instruction (a sector whose two blocks are both selected is written
// whole) and no thread idles on an unselected piece. Where a block, N or a
// base pointer forbids 16-byte pieces, the same walk takes one element a
// thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SPAN = 256;           // pieces of a row a CTA takes
// Rows a CTA takes: short CTAs keep the last wave of a call short (longer
// tiles ran slower at the serving wave's leaves).
constexpr int TILE_ROWS = 8;
// Rows a thread has in flight: out of place each thread takes all 8 rows
// of its piece at once; in place the selected pieces share the threads,
// and 4 ran faster than 8.
template <bool IN_PLACE>
constexpr int kUnroll = IN_PLACE ? 4 : 8;
// Design choices that `launch/scatter_probe.py` undoes one at a time:
// the column-order walk (else upd's memory order, one thread a piece of
// upd, after a copy of w when out of place) and the table in shared memory
// (else each thread scans idx[k, s] for its block).
constexpr bool kColumnOrder = true;
constexpr bool kTable = true;

template <typename TW, typename TU> __device__ __forceinline__ TW cast(TU v);
template <> __device__ __forceinline__ float cast<float, float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16, float>(float v) {
  if (v != v) return __ushort_as_bfloat16(0x7FC0);
  return __float2bfloat16_rn(v);
}

// N elements a thread moves at once: 16 or 32 bytes as 16-byte vectors, or
// one element.
template <typename T, int N>
struct alignas(16) Piece {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Piece<T, N> load_piece(const T* p) {
  Piece<T, N> out;
  if constexpr (sizeof(T) * N % 16 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(p);
    uint4* dst = reinterpret_cast<uint4*>(out.v);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(T) * N / 16); ++i) dst[i] = src[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out.v[i] = p[i];
  }
  return out;
}

template <typename T, int N>
__device__ __forceinline__ void store_piece(T* p, const Piece<T, N>& in) {
  if constexpr (sizeof(T) * N % 16 == 0) {
    uint4* dst = reinterpret_cast<uint4*>(p);
    const uint4* src = reinterpret_cast<const uint4*>(in.v);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(T) * N / 16); ++i) dst[i] = src[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = in.v[i];
  }
}

template <typename TW, typename TU, int N>
__device__ __forceinline__ Piece<TW, N> cast_piece(const Piece<TU, N>& in) {
  Piece<TW, N> out;
#pragma unroll
  for (int i = 0; i < N; ++i) out.v[i] = cast<TW, TU>(in.v[i]);
  return out;
}

struct Geometry {
  int64_t R;         // rows of one k
  int64_t N;         // elements of a row
  int S, n_sel, n_blocks, block;
  int upd_row;       // elements of an upd row: S * n_sel * block
  int pieces;        // pieces of a row: N / VEC
  int spans;         // CTAs across a row
  int row_tiles;     // CTAs down the R rows of one k
};

// The upd slot s * n_sel + j that writes global block `blk` of k's row
// (blk = s * n_blocks + b), or -1: a scan of idx[k, s], the highest j
// winning (the probe's `no_table` variant).
__device__ __forceinline__ int scan_idx(const int* ik, const Geometry& g,
                                        int blk) {
  const int s = blk / g.n_blocks;
  const int b = blk - s * g.n_blocks;
  int e = -1;
  for (int j = 0; j < g.n_sel; ++j)
    if (ik[s * g.n_sel + j] == b) e = s * g.n_sel + j;
  return e;
}

// One CTA: k, a tile of rows, a span of pieces (module note). VEC weight
// elements a piece; IN_PLACE: out is w, and only selected pieces move.
template <typename TW, typename TU, int VEC, bool IN_PLACE>
__global__ void __launch_bounds__(THREADS)
scatter_columns_kernel(TW* __restrict__ out, const TW* __restrict__ w,
                       const TU* __restrict__ upd,
                       const int* __restrict__ idx, Geometry g) {
  __shared__ int table[SPAN + 1];     // the blocks a span touches
  __shared__ int active[SPAN];        // in place: the selected pieces
  __shared__ int warp_counts[THREADS / 32];

  int cta = blockIdx.x;
  const int span = cta % g.spans;
  cta /= g.spans;
  const int tile = cta % g.row_tiles;
  const int64_t k = cta / g.row_tiles;
  const int tid = threadIdx.x;

  const int p0 = span * SPAN;
  const int P = min(SPAN, g.pieces - p0);
  const int c0 = p0 * VEC;                       // the span's first column
  const int b0 = c0 / g.block;                   // the first block it touches
  const int nb = (c0 + P * VEC - 1) / g.block - b0 + 1;
  const int* ik = idx + k * g.S * g.n_sel;

  if constexpr (kTable) {
    for (int i = tid; i < nb; i += THREADS) table[i] = -1;
    __syncthreads();
    for (int s = 0; s < g.S; ++s)
      for (int j = tid; j < g.n_sel; j += THREADS) {
        const int b = ik[s * g.n_sel + j];
        if (b < 0 || b >= g.n_blocks) continue;
        const int i = s * g.n_blocks + b - b0;
        if (i >= 0 && i < nb) atomicMax(&table[i], s * g.n_sel + j);
      }
    __syncthreads();
  }
  auto slot = [&](int blk) -> int {
    if constexpr (kTable) return table[blk - b0];
    else return scan_idx(ik, g, blk);
  };

  int A = P;          // the span's pieces that move, one a thread's
  if constexpr (IN_PLACE) {
    const bool sel = tid < P && slot((c0 + tid * VEC) / g.block) >= 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, sel);
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    A = 0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      before += i < warp ? warp_counts[i] : 0;
      A += warp_counts[i];
    }
    if (sel) active[before + __popc(ballot & ((1u << lane) - 1u))] = tid;
    __syncthreads();
    if (A == 0) return;
  }
  const int groups = THREADS / A;                // threads down the rows
  const int grp = tid / A;
  if (grp >= groups) return;
  const int q = IN_PLACE ? active[tid - grp * A] : tid - grp * A;
  const int col = c0 + q * VEC;
  const int blk = col / g.block;
  const int e = slot(blk);
  const int uoff = e >= 0 ? e * g.block + (col - blk * g.block) : 0;

  const int64_t row0 = (int64_t)tile * TILE_ROWS;
  const int64_t left = g.R - row0;
  const int rows = left < TILE_ROWS ? (int)left : TILE_ROWS;
  const int64_t first = k * g.R + row0;          // among all K * R rows
  TW* o = out + first * g.N + col;
  const TU* u = upd + first * g.upd_row + uoff;
  const TW* src = w + first * g.N + col;
  const bool from_upd = IN_PLACE || e >= 0;
  constexpr int UNROLL = kUnroll<IN_PLACE>;
  for (int r = grp; r < rows; r += groups * UNROLL) {
    // every load of the UNROLL rows first (a row past the tile reloads the
    // last one), then the casts and stores: a cast between two loads would
    // wait for the first before issuing the second
    Piece<TU, VEC> raw[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int rr = min(r + i * groups, rows - 1);
      if (from_upd)
        raw[i] = load_piece<TU, VEC>(u + (int64_t)rr * g.upd_row);
      else
        *reinterpret_cast<Piece<TW, VEC>*>(&raw[i]) =
            load_piece<TW, VEC>(src + (int64_t)rr * g.N);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int rr = r + i * groups;
      if (rr < rows)
        store_piece<TW, VEC>(
            o + (int64_t)rr * g.N,
            from_upd ? cast_piece<TW, TU, VEC>(raw[i])
                     : *reinterpret_cast<const Piece<TW, VEC>*>(&raw[i]));
    }
  }
}

// The probe's `upd_order` variant: one thread a piece of upd, in upd's
// memory order, its destination found from idx with 32-bit divisions; one
// CTA a span of SPAN pieces of one upd row. Duplicates leave either value.
template <typename TW, typename TU, int VEC>
__global__ void __launch_bounds__(THREADS)
scatter_upd_order_kernel(TW* __restrict__ out, const TU* __restrict__ upd,
                         const int* __restrict__ idx, Geometry g) {
  const int row_pieces = g.upd_row / VEC;
  const int spans = (row_pieces + SPAN - 1) / SPAN;
  const int cta = blockIdx.x;
  const int row = cta / spans;                   // among all K * R rows
  const int i = (cta - row * spans) * SPAN + threadIdx.x;
  if (i >= row_pieces) return;
  const int per_block = g.block / VEC;
  const int e = i / per_block;                   // s * n_sel + j
  const int s = e / g.n_sel;
  const int b = idx[row / (int)g.R * g.S * g.n_sel + e];
  if (b < 0 || b >= g.n_blocks) return;
  const int col = (s * g.n_blocks + b) * g.block + (i - e * per_block) * VEC;
  store_piece<TW, VEC>(out + (int64_t)row * g.N + col,
                       cast_piece<TW, TU, VEC>(load_piece<TU, VEC>(
                           upd + (int64_t)row * g.upd_row + i * VEC)));
}

template <typename TW, typename TU, int VEC, bool IN_PLACE>
int launch_columns(void* out, const void* w, const void* upd, const int* idx,
                   int64_t K, Geometry g, cudaStream_t stream) {
  g.pieces = (int)(g.N / VEC);
  g.spans = (g.pieces + SPAN - 1) / SPAN;
  const int64_t tiles = (g.R + TILE_ROWS - 1) / TILE_ROWS;
  const int64_t ctas = K * g.spans * tiles;
  if (tiles > INT_MAX || ctas > INT_MAX) return (int)cudaErrorInvalidValue;
  g.row_tiles = (int)tiles;
  scatter_columns_kernel<TW, TU, VEC, IN_PLACE>
      <<<(unsigned)ctas, THREADS, 0, stream>>>(
          static_cast<TW*>(out), static_cast<const TW*>(w),
          static_cast<const TU*>(upd), idx, g);
  return (int)cudaGetLastError();
}

template <typename TW, typename TU, int VEC>
int launch_upd_order(void* out, const void* w, const void* upd,
                     const int* idx, int64_t K, Geometry g,
                     cudaStream_t stream) {
  if (out != w) {
    const cudaError_t err = cudaMemcpyAsync(
        out, w, K * g.R * g.N * sizeof(TW), cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t spans = (g.upd_row / VEC + SPAN - 1) / SPAN;
  const int64_t ctas = K * g.R * spans;
  if (ctas == 0) return 0;
  if (ctas > INT_MAX) return (int)cudaErrorInvalidValue;
  scatter_upd_order_kernel<TW, TU, VEC>
      <<<(unsigned)ctas, THREADS, 0, stream>>>(
          static_cast<TW*>(out), static_cast<const TU*>(upd), idx, g);
  return (int)cudaGetLastError();
}

template <typename TW, typename TU, int VEC>
int launch_vec(void* out, const void* w, const void* upd, const int* idx,
               int64_t K, const Geometry& g, cudaStream_t stream) {
  if constexpr (!kColumnOrder)
    return launch_upd_order<TW, TU, VEC>(out, w, upd, idx, K, g, stream);
  if (out == w)
    return launch_columns<TW, TU, VEC, true>(out, w, upd, idx, K, g, stream);
  return launch_columns<TW, TU, VEC, false>(out, w, upd, idx, K, g, stream);
}

template <typename TW, typename TU>
int launch(void* out, const void* w, const void* upd, const int* idx,
           int64_t K, const Geometry& g, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TW);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(upd)) & 15) == 0 &&
      g.block % VEC == 0 && g.N % VEC == 0;
  if (aligned) return launch_vec<TW, TU, VEC>(out, w, upd, idx, K, g, stream);
  return launch_vec<TW, TU, 1>(out, w, upd, idx, K, g, stream);
}

}  // namespace

// out == w: in place; else out must not overlap w. w_dtype / upd_dtype:
// 0 = fp32, 1 = bf16 (upd is fp32 or w's type). Returns the CUDA error of
// the launch (0 = launched).
extern "C" int block_scatter_update_launch(void* out, const void* w,
                                           const void* upd, const void* idx,
                                           int64_t K, int64_t R, int64_t N,
                                           int S, int n_sel, int block,
                                           int w_dtype, int upd_dtype,
                                           void* stream) {
  if (K < 0 || R < 0 || S <= 0 || n_sel < 0 || block <= 0 || N > INT_MAX ||
      N % ((int64_t)S * block) != 0 ||
      (int64_t)S * n_sel * block > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (K * R * N == 0 || (out == w && n_sel == 0)) return 0;
  Geometry g{};
  g.R = R;
  g.N = N;
  g.S = S;
  g.n_sel = n_sel;
  g.n_blocks = (int)(N / ((int64_t)S * block));
  g.block = block;
  g.upd_row = S * n_sel * block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (w_dtype == 0 && upd_dtype == 0)
    return launch<float, float>(out, w, upd, ix, K, g, s);
  if (w_dtype == 1 && upd_dtype == 0)
    return launch<__nv_bfloat16, float>(out, w, upd, ix, K, g, s);
  if (w_dtype == 1 && upd_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(out, w, upd, ix, K, g, s);
  return (int)cudaErrorInvalidValue;
}
