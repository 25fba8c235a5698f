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
// point `batched_dw_launch`). Unselected dy blocks are never read. Seen
// from the output, the compact layout is a matrix [E, K, C] with C =
// n_shards * n_sel * block columns, whose column c is dy's column
// (s*n_blocks + idx[s, j])*block + c % block, sj = s*n_sel + j = c / block.
//
// Bound on an H100: 2*E*M*K*C operations against E*(M*K + M*C) input
// elements plus the fp32 output E*K*C. A dense layer at the LM path's
// shapes (M = 4096 tokens, block 128) does some 250 to 2000 operations a
// byte, above the card's ~295 for bf16, so the tensor cores' rate bounds
// it (0.352 ms for the 7 leaves of a llama3-8b layer). An expert leaf at
// deepseek-moe-16b's shapes (E = 64, M = capacity 481, n_sel 2-3 of 11-16)
// does ~120 a byte, the fp32 output being the largest term (134 MB for
// w_gate), so the memory rate bounds it (0.239 ms for the 3 leaves).
//
// Two instances; the wrapper (`kernels/ops.py`, `dw_instance`) picks by the
// arguments alone, and a launch that fails raises there:
//
//  - pipelined (TMA + wgmma; `dw_tma_kernel`, `batched_dw_tma_kernel`):
//    bf16, K and N multiples of 8 (TMA's 16-byte row strides), block a
//    multiple of 64 and 16-byte-aligned bases: every bf16 leaf of the LM,
//    MoE and rwkv paths. One CTA computes a tile of one expert's [K, C]
//    output, 128 fan-in rows by 128 * NH compact columns: one selected
//    block at block 128 and NH = 1 (two at block 64, half of one at 256).
//    One producer warp keeps a ring of stages in flight with TMA, each
//    stage 64 contraction rows of x [64 x 128 fan-in] and of the selected
//    dy columns [64 x 128 NH] in bf16 (64 x 64 boxes, 128-byte swizzle),
//    under full / empty mbarrier pairs. Two consumer warpgroups multiply
//    with `wgmma.mma_async.m64n128k16.f32.bf16.bf16` on the tensor cores,
//    each 64 fan-in rows by all the tile's columns, fp32 sums in registers
//    (bf16 products are exact in fp32, as the reference's
//    preferred_element_type=f32). Both operands are MN-major in shared
//    memory (x has the fan-in contiguous, dy its columns), so both go
//    through wgmma's transpose immediates; a descriptor's leading byte
//    offset is the stride between 64-element swizzle atoms along M / N (8
//    KB: the next box), its stride byte offset the stride between groups of
//    8 contraction rows (1 KB). NH = 2 (256 columns, 4 stages of 48 KB, one
//    CTA an SM) where the contraction is long and the tiles make two waves
//    (llama3-8b's w_gate, w_up, w_down): each stage's x then serves twice
//    the products, which is what bounds the 128-column tile there (L2 to
//    shared memory, ~470 of the card's 989 TFLOP/s). NH = 1 (3 stages of
//    32 KB, two CTAs an SM, so that one CTA's epilogue overlaps the
//    other's loads) everywhere else, the memory-bound expert leaves among
//    them. The producer reads idx[s, j] from device memory itself and hands
//    TMA the selected dy column, so a new selection needs no host sync and
//    no rebuild; a bad index is clamped into the tensor. x and dy are
//    mapped as 3-D tensors [E, M, K] and [E, M, N] (E = 1 for a dense
//    weight), so the tail box of an expert's M = 481 rows reads zeros,
//    never the next expert's rows; a ragged fan-in reads zeros the same way
//    and its rows are not stored. The tensor maps are encoded on the host
//    at every call (they hold the base pointers) through
//    `cudaGetDriverEntryPoint`, so the library needs no -lcuda, and passed
//    as __grid_constant__ parameters. Where the tiles make fewer than two
//    waves of the card's CTA slots (llama3-8b's wq / wo give 192, wk / wv
//    64, deepseek-moe-16b's attention leaves 48), the contraction is split
//    over a thread-block cluster of up to 4 CTAs: each stages its fp32
//    partial tile in its own shared memory and, after a cluster barrier,
//    each sums its share of the rows from every partial through distributed
//    shared memory in slice order. No atomics: the result is a function of
//    the inputs, the shapes and the card's SM count, bitwise from run to
//    run. The epilogue always goes through shared memory so that a warp
//    writes whole 512-byte runs of a row of the compact layout. A ring wait
//    that cannot finish traps instead of hanging the card.
//  - grid (`dw_grid_kernel`, `batched_dw_grid_kernel`): every other call:
//    fp32 inputs, misaligned bases, rows that are no multiple of 16 bytes,
//    and blocks that are no multiple of 64 (the serving waves use block 8).
//    One CTA of 128 threads (four an SM) computes a 64 x 128 tile of one
//    expert's [K, C] output: 64 fan-in rows by 128 compact columns, across
//    as many selected blocks as those columns span (16 at block 8); a tile
//    may straddle a shard boundary or end inside a block. At its start the
//    CTA reads its columns' idx entries from device memory into a table of
//    dy columns in shared memory (a bad index clamped). A 4-stage cp.async
//    ring stages 16 (fp32) or 32 (bf16) contraction rows of x and of the
//    selected dy columns a stage, in 16-byte pieces where the bases, rows
//    and blocks allow (bf16 block 8 is one piece, fp32 block 8 two), else
//    by element loads, chosen from the arguments; rows past M, fan-in past
//    K and columns past C read zeros and are not stored. fp32 runs on the
//    CUDA cores, exact (no TF32: the f32 serving oracle and the f32 online
//    wave rely on it): a thread holds 8 x 8 outputs, reads its operands
//    from shared memory four at a time, and keeps each output one chain of
//    fused multiply-adds over m in ascending order, so the fp32 sums are
//    bit for bit those of the earlier one-block-a-CTA tile (`python -m
//    repro_torch.launch.dw_probe` checks). bf16 runs on the tensor cores:
//    ldmatrix .trans + mma.sync m16n8k16 (bf16 in, fp32 sums; bf16
//    products are exact in fp32), each warp 64 x 32 outputs; mma.sync,
//    not wgmma, because the operands are gathered and padded by the CTA
//    itself and the tiles are small (M = 16 in a wave). The tile goes out
//    through shared memory, a warp writing whole 512-byte runs of a compact
//    row. No atomics, no split of M: two calls are bitwise equal. At M = 16
//    (a wave) the fp32 output bounds it; at M = 4096 in fp32 the CUDA
//    cores' FMA stream does (the probe's `no_smem_reads` build).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// grid instance: packed column tiles, cp.async ring, fp32 FMAs or bf16
// mma.sync, the epilogue through shared memory
// ---------------------------------------------------------------------------

// A tile is TR fan-in rows by TC compact columns, computed by 2 TR
// threads, four CTAs an SM. (128-row tiles of 256 threads, two an SM, left
// small leaves' few tiles on part of the card and made a ragged last wave
// of large ones: on an H100, llama3-8b's fp32 wk took 0.386 ms against
// 0.233, w_gate 2.261 against 2.142; `dw_probe`'s rows128 build.)
constexpr int TR = 64;           // fan-in rows of a tile
constexpr int TC = 128;          // compact columns of a tile
constexpr int G_THREADS = 2 * TR;
constexpr int G_STAGES = 4;      // cp.async ring over the contraction
constexpr int G_LD = TC + 8;     // floats a staged output row (banks)

// The design's switches; `python -m repro_torch.launch.dw_probe` builds
// the source with each one undone.
constexpr bool kPackColumns = true;   // a tile spans selected blocks
constexpr bool kCpAsync = true;       // 16-byte cp.async pieces where aligned
constexpr bool kBf16Mma = true;       // bf16 on the tensor cores

template <typename T>
constexpr bool kIsBf16 = false;
template <>
constexpr bool kIsBf16<__nv_bfloat16> = true;

// How kThreads threads stage rows of a WIDTH-wide operand tile: as 16-byte
// pieces of V elements (kPieceRows rows a pass), or as elements
// (kElemRows rows a pass).
template <int WIDTH, int kThreads, int V>
struct StageMap {
  static constexpr int kPieceRows = kThreads / (WIDTH / V);
  static constexpr int kElemRows = kThreads / WIDTH;
  static_assert(kThreads % (WIDTH / V) == 0 && kThreads % WIDTH == 0,
                "every thread stages alike");
  static __device__ __forceinline__ int piece_row(int tid) {
    return tid / (WIDTH / V);
  }
  static __device__ __forceinline__ int piece_col(int tid) {
    return tid % (WIDTH / V) * V;
  }
  static __device__ __forceinline__ int elem_row(int tid) {
    return tid / WIDTH;
  }
  static __device__ __forceinline__ int elem_col(int tid) {
    return tid % WIDTH;
  }
};

// Contraction rows a stage and the row strides of the staged operands, in
// elements: fp32 rows are read whole by each warp (no padding needed);
// bf16 rows are padded by 16 bytes so that ldmatrix's 8 row addresses fall
// in 8 different bank groups. Dynamic shared memory holds the ring, which
// the staged output tile reuses, then the tile's dy column table.
template <typename T>
struct GridStage {
  static constexpr int kThreads = G_THREADS;
  static constexpr int kRows = kIsBf16<T> ? 32 : 16;
  static constexpr int kPad = kIsBf16<T> ? 8 : 0;
  static constexpr int kLdX = TR + kPad, kLdD = TC + kPad;
  static constexpr int kDyAt = kRows * kLdX;   // dy's offset in a stage
  static constexpr int kElems = kRows * (kLdX + kLdD);
  static constexpr int kRingBytes = G_STAGES * kElems * (int)sizeof(T);
  static constexpr int kTileBytes = TR * G_LD * 4;
  static constexpr int kColsAt =
      kRingBytes > kTileBytes ? kRingBytes : kTileBytes;
  static constexpr int kSmem = kColsAt + TC * 4;
  static constexpr int kVec = 16 / (int)sizeof(T);   // elements a piece
  using MapX = StageMap<TR, kThreads, kVec>;
  using MapD = StageMap<TC, kThreads, kVec>;
  static_assert(kRows % MapX::kPieceRows == 0 &&
                    kRows % MapD::kPieceRows == 0 &&
                    kRows % MapX::kElemRows == 0 &&
                    kRows % MapD::kElemRows == 0,
                "a stage is whole passes");
};

struct Geometry {
  int64_t M, K, N, C;           // C = n_shards * n_sel * block
  int n_sel, block, n_blocks;
  int tiles_per_block;          // column tiles a selected block takes
                                // (only without packing)
  int vec_x, vec_dy, vec_out;   // 16-byte pieces allowed
  int64_t x_stride, dy_stride, out_stride;   // per expert, in elements
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Four consecutive staged elements as fp32.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// Where a thread stages from, fixed for the whole contraction: `x` and
// `dy` point at its first piece or element (as vec_x / vec_dy say) in
// stage 0, null where its column lies past the tile's fan-in rows or
// compact columns. Computed once, so that no stage reads the column table
// (which the compiler cannot tell apart from the staged tiles) or
// multiplies 64-bit offsets anew.
template <typename T>
struct Pieces {
  const T* x;
  const T* dy;
};

// Stage rows [m0, m0 + kRows) of the tile's x rows and selected dy
// columns into xs / ds. Rows past M and columns past the tile read zeros.
// 16-byte cp.async pieces where the geometry allows them (`vec_*`; always
// where kAligned), else element loads through registers.
template <typename T, bool kAligned>
__device__ __forceinline__ void load_stage(T* xs, T* ds, const Pieces<T>& p,
                                           const T* x, const T* dy,
                                           const Geometry& g, int64_t m0) {
  using S = GridStage<T>;
  using MX = typename S::MapX;
  using MD = typename S::MapD;
  const int tid = threadIdx.x;
  if (kAligned || g.vec_x) {
    const int row = MX::piece_row(tid), col = MX::piece_col(tid);
#pragma unroll
    for (int u = 0; u < S::kRows / MX::kPieceRows; ++u) {
      const int r = row + u * MX::kPieceRows;
      const bool ok = p.x != nullptr && m0 + r < g.M;
      cp_async16(xs + r * S::kLdX + col,
                 ok ? p.x + (m0 + u * MX::kPieceRows) * g.K : x,
                 ok ? 16 : 0);
    }
  } else {
    const int row = MX::elem_row(tid), col = MX::elem_col(tid);
#pragma unroll
    for (int u = 0; u < S::kRows / MX::kElemRows; ++u) {
      const int r = row + u * MX::kElemRows;
      xs[r * S::kLdX + col] =
          p.x != nullptr && m0 + r < g.M
              ? p.x[(m0 + u * MX::kElemRows) * g.K] : zero_of<T>();
    }
  }
  if (kAligned || g.vec_dy) {
    const int row = MD::piece_row(tid), col = MD::piece_col(tid);
#pragma unroll
    for (int u = 0; u < S::kRows / MD::kPieceRows; ++u) {
      const int r = row + u * MD::kPieceRows;
      const bool ok = p.dy != nullptr && m0 + r < g.M;
      cp_async16(ds + r * S::kLdD + col,
                 ok ? p.dy + (m0 + u * MD::kPieceRows) * g.N : dy,
                 ok ? 16 : 0);
    }
  } else {
    const int row = MD::elem_row(tid), col = MD::elem_col(tid);
#pragma unroll
    for (int u = 0; u < S::kRows / MD::kElemRows; ++u) {
      const int r = row + u * MD::kElemRows;
      ds[r * S::kLdD + col] =
          p.dy != nullptr && m0 + r < g.M
              ? p.dy[(m0 + u * MD::kElemRows) * g.N] : zero_of<T>();
    }
  }
}

// CUDA cores: the warp (w / 2, w % 2) takes fan-in rows [32 (w / 2), +32)
// and columns [64 (w % 2), +64); lane (l / 8, l % 8) its rows
// 4 (l / 8) + {0..3} and 16 + 4 (l / 8) + {0..3}, columns 4 (l % 8) +
// {0..3} and 32 + 4 (l % 8) + {0..3}: 8 x 8 outputs read from shared
// memory four at a time. Each output is one chain of fused multiply-adds
// over m in ascending order (fp32: the sum the earlier one-block tile gave,
// bit for bit).
struct SimtLayout {
  int r0, c0;
  __device__ __forceinline__ SimtLayout(int warp, int lane)
      : r0(warp / 2 * 32 + lane / 8 * 4), c0(warp % 2 * 64 + lane % 8 * 4) {}
  __device__ __forceinline__ int row(int i) const {
    return r0 + (i < 4 ? i : 12 + i);
  }
};

template <typename T>
__device__ __forceinline__ void simt_stage(const T* xs, const T* ds,
                                           float (&acc)[64],
                                           const SimtLayout& l) {
  using S = GridStage<T>;
#pragma unroll
  for (int r = 0; r < S::kRows; ++r) {
    float a[8], b[8];
    load4(xs + r * S::kLdX + l.r0, a);
    load4(xs + r * S::kLdX + l.r0 + 16, a + 4);
    load4(ds + r * S::kLdD + l.c0, b);
    load4(ds + r * S::kLdD + l.c0 + 32, b + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);
  }
}

__device__ __forceinline__ void simt_store(const float (&acc)[64],
                                           float* staged,
                                           const SimtLayout& l) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = staged + l.row(i) * G_LD;
    *reinterpret_cast<float4*>(row + l.c0) =
        make_float4(acc[i * 8], acc[i * 8 + 1], acc[i * 8 + 2],
                    acc[i * 8 + 3]);
    *reinterpret_cast<float4*>(row + l.c0 + 32) =
        make_float4(acc[i * 8 + 4], acc[i * 8 + 5], acc[i * 8 + 6],
                    acc[i * 8 + 7]);
  }
}

// Tensor cores (bf16): the warp (w / 4, w % 4) takes fan-in rows
// [64 (w / 4), +64) and columns [32 (w % 4), +32): 4 x 4 products
// m16n8k16 a 16-row step. out = x^T dy, so both staged operands are
// transposed against mma's row.col: ldmatrix .trans reads them as they lie
// (xs [m][k] gives A = x^T, ds [m][c] gives B). acc[(mi * 4 + ni) * 4 + q]
// holds row 16 mi + lane / 4 (+ 8 for q >= 2), column 8 ni + 2 (lane % 4)
// (+ 1 for odd q) of the warp's block.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_stage(const __nv_bfloat16* xs,
                                          const __nv_bfloat16* ds,
                                          float (&acc)[64], int warp,
                                          int lane, int steps) {
  using S = GridStage<__nv_bfloat16>;
  const int wr = warp / 4 * 64, wc = warp % 4 * 32;
  // lane l addresses row l % 8 of 8 x 8 matrix l / 8
  const int q = lane / 8, i = lane % 8;
#pragma unroll
  for (int kk = 0; kk < S::kRows / 16; ++kk) {
    if (kk >= steps) break;   // rows past M: nothing to add
    const int mb = kk * 16;
    uint32_t a[4][4], b[2][4];
    // A's four matrices: (m, k) blocks (0, 0), (0, 8), (8, 0), (8, 8)
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldmatrix_x4_trans(a[mi], xs + (mb + q / 2 * 8 + i) * S::kLdX + wr +
                                   mi * 16 + q % 2 * 8);
    // B's: (m, c) blocks (0, 0), (8, 0), (0, 8), (8, 8) of 16 columns
#pragma unroll
    for (int p = 0; p < 2; ++p)
      ldmatrix_x4_trans(b[p], ds + (mb + q % 2 * 8 + i) * S::kLdD + wc +
                                  p * 16 + q / 2 * 8);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc + (mi * 4 + ni) * 4, a[mi], b[ni / 2][ni % 2 * 2],
                 b[ni / 2][ni % 2 * 2 + 1]);
  }
}

__device__ __forceinline__ void mma_store(const float (&acc)[64],
                                          float* staged, int warp,
                                          int lane) {
  const int wr = warp / 4 * 64, wc = warp % 4 * 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* d = acc + (mi * 4 + ni) * 4;
      float* p = staged + (wr + mi * 16 + lane / 4) * G_LD + wc + ni * 8 +
                 lane % 4 * 2;
      *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
      *reinterpret_cast<float2*>(p + 8 * G_LD) = make_float2(d[2], d[3]);
    }
}

// The CTA's tile of one expert's output (expert 0 for a single weight):
// fan-in rows [TR blockIdx.y, +TR) by compact columns [128 blockIdx.x,
// +128), across as many selected blocks as the columns span (packed), or
// a 128-column piece of one selected block (unpacked). kAligned: both
// operands stage as 16-byte pieces (the element loads are not compiled).
template <typename T, bool kAligned>
__device__ __forceinline__ void grid_tile(const T* __restrict__ x,
                                          const T* __restrict__ dy,
                                          const int* __restrict__ idx,
                                          float* __restrict__ out,
                                          const Geometry& g, int64_t expert) {
  using S = GridStage<T>;
  constexpr bool kMma = kIsBf16<T> && kBf16Mma;
  extern __shared__ uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* staged = reinterpret_cast<float*>(smem_raw);
  int* cols = reinterpret_cast<int*>(smem_raw + S::kColsAt);
  x += expert * g.x_stride;
  dy += expert * g.dy_stride;
  out += expert * g.out_stride;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  int64_t c0;
  int ncol;
  if (kPackColumns) {
    c0 = (int64_t)blockIdx.x * TC;
    ncol = g.C - c0 < TC ? (int)(g.C - c0) : TC;
  } else {
    const int ct = blockIdx.x % g.tiles_per_block;
    c0 = (int64_t)(blockIdx.x / g.tiles_per_block) * g.block +
         (int64_t)ct * TC;
    ncol = min(TC, g.block - ct * TC);
  }
  const int64_t k0 = (int64_t)blockIdx.y * TR;
  const int nk = g.K - k0 < TR ? (int)(g.K - k0) : TR;
  // each column's dy column, from idx in device memory: a new selection
  // needs no host sync and no rebuild
  for (int c = tid; c < TC; c += S::kThreads) {
    int col = -1;
    if (c < ncol) {
      const int64_t cc = c0 + c;
      const int sj = (int)(cc / g.block);
      int sel = idx[sj];
      // indices are trusted; the clamp only keeps a bad one inside the
      // tensor
      sel = min(max(sel, 0), g.n_blocks - 1);
      col = (int)(((int64_t)(sj / g.n_sel) * g.n_blocks + sel) * g.block +
                  cc % g.block);
    }
    cols[c] = col;
  }
  __syncthreads();
  using MX = typename S::MapX;
  using MD = typename S::MapD;
  Pieces<T> pc;
  {
    const bool vx = kAligned || g.vec_x, vdy = kAligned || g.vec_dy;
    const int xr = vx ? MX::piece_row(tid) : MX::elem_row(tid);
    const int xc = vx ? MX::piece_col(tid) : MX::elem_col(tid);
    const int dr = vdy ? MD::piece_row(tid) : MD::elem_row(tid);
    const int dc = cols[vdy ? MD::piece_col(tid) : MD::elem_col(tid)];
    pc.x = xc < nk ? x + xr * g.K + k0 + xc : nullptr;
    pc.dy = dc >= 0 ? dy + dr * g.N + dc : nullptr;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const SimtLayout lay(warp, lane);
  const int64_t steps = (g.M + S::kRows - 1) / S::kRows;
#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < steps)
      load_stage<T, kAligned>(ring + s * S::kElems,
                              ring + s * S::kElems + S::kDyAt, pc, x, dy, g,
                              (int64_t)s * S::kRows);
    cp_async_commit();
  }
  for (int64_t it = 0; it < steps; ++it) {
    cp_async_wait<G_STAGES - 2>();
    // stage `it` has landed, and every warp is done with stage it - 1,
    // whose slot the next load takes
    __syncthreads();
    const int64_t next = it + G_STAGES - 1;
    if (next < steps) {
      T* slot = ring + (next % G_STAGES) * S::kElems;
      load_stage<T, kAligned>(slot, slot + S::kDyAt, pc, x, dy, g,
                              next * S::kRows);
    }
    cp_async_commit();
    const T* xs = ring + (it % G_STAGES) * S::kElems;
    const T* ds = xs + S::kDyAt;
    if constexpr (kMma) {
      const int64_t left = g.M - it * S::kRows;   // rows of this stage
      mma_stage(xs, ds, acc, warp, lane,
                left < 32 ? (int)(left + 15) / 16 : 2);
    } else {
      simt_stage(xs, ds, acc, lay);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it holds the staged tile now

  if constexpr (kMma)
    mma_store(acc, staged, warp, lane);
  else
    simt_store(acc, staged, lay);
  __syncthreads();
  // a warp writes whole rows of the compact layout, 512 bytes at a time
  for (int r = warp; r < nk; r += S::kThreads / 32) {
    float* dst = out + (k0 + r) * g.C + c0;
    const float* src = staged + r * G_LD;
    const int c = lane * 4;
    if (g.vec_out && c + 4 <= ncol) {
      *reinterpret_cast<float4*>(dst + c) =
          *reinterpret_cast<const float4*>(src + c);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < ncol) dst[c + j] = src[c + j];
    }
  }
}

// ---------------------------------------------------------------------------
// pipelined instance: TMA ring + wgmma (bf16)
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int TILE = 128;                  // fan-in rows of a tile
constexpr int BOX = 64;                    // a TMA box: 64 elements x 64 rows
constexpr int STAGE_M = 64;                // contraction rows a stage
constexpr int BOX_BYTES = BOX * STAGE_M * 2;            // 8 KB of bf16
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int TMA_THREADS = CONSUMERS + 32;             // + the producer warp
constexpr int MAX_SPLITS = 4;              // CTAs a cluster

// The two tile shapes of the header: 128 fan-in rows by 128 * NH columns.
template <int NH>
struct TmaShape {
  static constexpr int kCols = 128 * NH;
  static constexpr int kStages = NH == 1 ? 3 : 4;
  static constexpr int kCtasPerSm = NH == 1 ? 2 : 1;
  static constexpr int kStageBytes = (2 + 2 * NH) * BOX_BYTES;  // x, dy boxes
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kLd = kCols + 8;    // floats a staged row (banks)
  static constexpr int kSmem = 1024 + kRingBytes + 2 * kStages * 8;
  static_assert(TILE * kLd * 4 <= kRingBytes, "the staged tile fits the ring");
};

struct TmaGeometry {
  int64_t K, C;                 // fan-in; compact columns n_shards*n_sel*block
  int64_t out_stride;           // K * C, per expert
  int n_sel, block, n_blocks;
  int row_tiles, col_tiles, splits, m_stages;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Wait for the phase of `parity` to complete. A wait that lasts ~8 s (a
// tensor map the hardware refused, a count that never arrives) traps: the
// launch then fails in the caller instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One 64 x 64 box of a 3-D tensor map (inner coordinate first) into shared
// memory; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int inner, int row,
                                         int expert) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(inner), "r"(row), "r"(expert)
      : "memory");
}

// wgmma shared-memory descriptor of an MN-major operand in the 128-byte
// swizzle: start address, leading byte offset (between 64-element atoms
// along M or N), stride byte offset (between groups of 8 contraction
// rows), layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr,
                                                  uint32_t lbo,
                                                  uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], A and B MN-major (both
// transposed), bf16 in, fp32 sums.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// d[64 x 256] += A[64 x 16] * B[16 x 256], as wgmma_m64n128k16: A is read
// once for all 256 columns.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// dy's column for compact column c (a multiple of 64: a box never spans two
// selected blocks, block being a multiple of 64).
__device__ __forceinline__ int dy_column(const int* __restrict__ idx,
                                         const TmaGeometry& g, int64_t c) {
  const int sj = (int)(c / g.block);
  const int s = sj / g.n_sel;
  int sel = idx[sj];
  // indices are trusted; the clamp only keeps a bad one inside the tensor
  sel = min(max(sel, 0), g.n_blocks - 1);
  return (int)(((int64_t)s * g.n_blocks + sel) * g.block + c % g.block);
}

// The CTA's tile: blockIdx.x = ((e*row_tiles + rt)*col_tiles + ct)*splits
// + q, so the CTAs of one cluster (q) share a tile and neighbouring tiles
// share x's rows in L2.
template <int NH>
__device__ __forceinline__ void tma_tile(const CUtensorMap* tx,
                                         const CUtensorMap* tdy,
                                         const int* __restrict__ idx,
                                         float* __restrict__ out,
                                         const TmaGeometry& g) {
  using S = TmaShape<NH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kRingBytes);
  uint64_t* empty = full + S::kStages;

  int64_t t = blockIdx.x / g.splits;
  const int q = (int)(blockIdx.x % g.splits);
  const int ct = (int)(t % g.col_tiles);
  t /= g.col_tiles;
  const int rt = (int)(t % g.row_tiles);
  const int e = (int)(t / g.row_tiles);
  const int k0 = rt * TILE;
  const int64_t c0 = (int64_t)ct * S::kCols;
  const int it_begin = (int)((int64_t)q * g.m_stages / g.splits);
  const int n_it = (int)((int64_t)(q + 1) * g.m_stages / g.splits) - it_begin;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* staged = reinterpret_cast<float*>(ring);
  if (warp == CONSUMERS / 32) {
    if (lane == 0) {
      // producer. Past the last fan-in row or compact column a box repeats
      // the tile's first one: those output rows and columns are not stored
      const int kx1 = k0 + BOX < g.K ? k0 + BOX : k0;
      int col[2 * NH];
#pragma unroll
      for (int h = 0; h < 2 * NH; ++h)
        col[h] = h == 0 || c0 + h * BOX < g.C
                     ? dy_column(idx, g, c0 + h * BOX) : col[0];
      for (int it = 0; it < n_it; ++it) {
        const int st = it % S::kStages;
        if (it >= S::kStages)
          mbar_wait(&empty[st], ((it / S::kStages) - 1) & 1);
        uint8_t* stage = ring + st * S::kStageBytes;
        const int m0 = (it_begin + it) * STAGE_M;
        mbar_expect_tx(&full[st], S::kStageBytes);
        tma_load(stage, tx, &full[st], k0, m0, e);
        tma_load(stage + BOX_BYTES, tx, &full[st], kx1, m0, e);
#pragma unroll
        for (int h = 0; h < 2 * NH; ++h)
          tma_load(stage + (2 + h) * BOX_BYTES, tdy, &full[st], col[h], m0,
                   e);
      }
    }
    __syncwarp();
  } else {
    // consumers: warpgroup wg takes fan-in rows [64 wg, 64 wg + 64) and
    // all the tile's columns, one m64n(128 NH)k16 product a 16-row step
    const int wg = threadIdx.x / 128;
    float acc[64 * NH];
#pragma unroll
    for (int i = 0; i < 64 * NH; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % S::kStages;
      mbar_wait(&full[st], (it / S::kStages) & 1);
      const uint32_t a0 =
          smem_u32(ring + st * S::kStageBytes + wg * BOX_BYTES);
      const uint32_t b0 = smem_u32(ring + st * S::kStageBytes + 2 * BOX_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STAGE_M / 16; ++kk) {
        // 16 contraction rows = two 8-row groups of 128 bytes each
        const uint64_t a = mn_major_desc(a0 + kk * 2048, BOX_BYTES, 1024);
        const uint64_t b = mn_major_desc(b0 + kk * 2048, BOX_BYTES, 1024);
        if constexpr (NH == 1)
          wgmma_m64n128k16(acc, a, b);
        else
          wgmma_m64n256k16(acc, a, b);
      }
      wgmma_commit();
      // the previous stage's products are done: hand its slot back
      wgmma_wait<1>();
      fence_acc(acc);
      if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S::kStages]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // both warpgroups are done reading the ring before it holds the tile
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    // accumulator layout of m64nN: row 16 w + lane/4 (+8), column
    // 8 c + 2 (lane%4) (+1)
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int c = 0; c < 16 * NH; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      *reinterpret_cast<float2*>(&staged[r0 * S::kLd + col]) =
          make_float2(acc[4 * c], acc[4 * c + 1]);
      *reinterpret_cast<float2*>(&staged[(r0 + 8) * S::kLd + col]) =
          make_float2(acc[4 * c + 2], acc[4 * c + 3]);
    }
  }

  // Every slice's partial tile is staged. CTA q of the cluster writes rows
  // q, q + splits, ... of the tile, each the sum of the slices' partials in
  // slice order; a warp writes one row of the compact layout, 512 bytes at
  // a time.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float* out_e = out + (int64_t)e * g.out_stride;
  for (int r = q + g.splits * warp; r < TILE;
       r += g.splits * (TMA_THREADS / 32)) {
    const int64_t k = k0 + r;
    if (k >= g.K) continue;
#pragma unroll
    for (int cc = 4 * lane; cc < S::kCols; cc += 128) {
      if (c0 + cc >= g.C) continue;
      float4* src = reinterpret_cast<float4*>(staged + r * S::kLd + cc);
      float4 sum = *cluster.map_shared_rank(src, 0);
      for (int p = 1; p < g.splits; ++p) {
        const float4 v = *cluster.map_shared_rank(src, p);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      *reinterpret_cast<float4*>(out_e + k * g.C + c0 + cc) = sum;
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

// Four kernels, two instances times two entry points: the batched ones
// take their expert from blockIdx.z (grid) or from blockIdx.x (pipelined;
// a dense weight is expert 0 of one), and have names of their own so that
// a profile tells the expert dW from a dense layer's.
#define DW_GRID_KERNEL(name, expert)                                         \
  template <typename T, bool kAligned>                               \
  __global__ void __launch_bounds__(G_THREADS, 512 / G_THREADS)             \
      name(const T* __restrict__ x, const T* __restrict__ dy,               \
           const int* __restrict__ idx, float* __restrict__ out,            \
           Geometry g) {                                                     \
    grid_tile<T, kAligned>(x, dy, idx, out, g, expert);                     \
  }
DW_GRID_KERNEL(dw_grid_kernel, 0)
DW_GRID_KERNEL(batched_dw_grid_kernel, (int64_t)blockIdx.z)
#undef DW_GRID_KERNEL

#define DW_TMA_KERNEL(name)                                                  \
  template <int NH>                                                          \
  __global__ void __launch_bounds__(TMA_THREADS, TmaShape<NH>::kCtasPerSm)  \
      name(const __grid_constant__ CUtensorMap tx,                           \
           const __grid_constant__ CUtensorMap tdy,                          \
           const int* __restrict__ idx, float* __restrict__ out,            \
           TmaGeometry g) {                                                  \
    tma_tile<NH>(&tx, &tdy, idx, out, g);                                    \
  }
DW_TMA_KERNEL(dw_tma_kernel)
DW_TMA_KERNEL(batched_dw_tma_kernel)
#undef DW_TMA_KERNEL

// blockIdx.x walks the column tiles, so neighbouring CTAs share x's rows
// in L2; blockIdx.y the fan-in tiles, blockIdx.z the expert.
template <typename T>
cudaError_t launch_grid(const void* x, const void* dy, const int* idx,
                        float* out, const Geometry& g, int experts,
                        bool batched, cudaStream_t stream) {
  const int64_t col_tiles =
      kPackColumns ? (g.C + TC - 1) / TC : g.C / g.block * g.tiles_per_block;
  const dim3 grid((unsigned)col_tiles, (unsigned)((g.K + TR - 1) / TR),
                  (unsigned)experts);
  const bool aligned = g.vec_x && g.vec_dy;
  void (*kernel)(const T*, const T*, const int*, float*, Geometry) =
      batched ? (aligned ? batched_dw_grid_kernel<T, true>
                         : batched_dw_grid_kernel<T, false>)
              : (aligned ? dw_grid_kernel<T, true> : dw_grid_kernel<T, false>);
  const int smem = GridStage<T>::kSmem;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid, G_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), idx, out, g);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor [experts, rows, inner] as a 3-D map of 64 x 64 boxes in
// the 128-byte swizzle; reads outside it fill zeros.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                int64_t inner, int64_t rows, int64_t experts) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)experts};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)(inner * rows) * 2};
  const cuuint32_t box[3] = {BOX, STAGE_M, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NH>
cudaError_t launch_tma_shape(const CUtensorMap& tx, const CUtensorMap& tdy,
                             const int* idx, float* out, TmaGeometry g,
                             int64_t e, int sms, bool batched,
                             cudaStream_t stream) {
  using S = TmaShape<NH>;
  g.col_tiles = (int)((g.C + S::kCols - 1) / S::kCols);
  // Split the contraction where the tiles are fewer than 2 x SMs. (Filling
  // the last wave of CTA slots by more slices measured slower: llama3-8b's
  // wq at 4 slices took 0.088 ms against 0.075 at 2.)
  const int64_t tiles = e * g.row_tiles * g.col_tiles;
  int64_t splits = (2 * sms + tiles - 1) / tiles;
  splits = splits < MAX_SPLITS ? splits : MAX_SPLITS;
  splits = splits < g.m_stages ? splits : g.m_stages;
  g.splits = (int)(splits > 1 ? splits : 1);

  void (*kernel)(const CUtensorMap, const CUtensorMap, const int*, float*,
                 TmaGeometry) = batched ? batched_dw_tma_kernel<NH>
                                        : dw_tma_kernel<NH>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * g.splits), 1, 1);
  cfg.blockDim = dim3(TMA_THREADS, 1, 1);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&tx, (void*)&tdy, (void*)&idx, &out, &g};
  rc = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                           args);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

cudaError_t launch_tma(const void* x, const void* dy, const int* idx,
                       float* out, int64_t e, int64_t m, int64_t k,
                       int64_t n, int n_shards, int n_sel, int block,
                       bool batched, cudaStream_t stream) {
  if (block % BOX != 0 || k % 8 != 0 || n % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return cudaErrorInvalidValue;
  if (e == 0 || k == 0 || n_sel == 0) return cudaSuccess;   // no output
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tx, tdy;
  if (!encode_map(encode, &tx, x, k, m, e) ||
      !encode_map(encode, &tdy, dy, n, m, e))
    return cudaErrorInvalidValue;

  TmaGeometry g;
  g.K = k;
  g.C = (int64_t)n_shards * n_sel * block;
  g.out_stride = k * g.C;
  g.n_sel = n_sel;
  g.block = block;
  g.n_blocks = (int)(n / ((int64_t)n_shards * block));
  g.row_tiles = (int)((k + TILE - 1) / TILE);
  g.m_stages = (int)((m + STAGE_M - 1) / STAGE_M);
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // 256-column tiles where the contraction is long and they still make two
  // waves of the card; 128 elsewhere
  const bool wide = g.C % 256 == 0 && m >= 1024 &&
                    e * g.row_tiles * (g.C / 256) >= 2 * sms;
  return wide ? launch_tma_shape<2>(tx, tdy, idx, out, g, e, sms, batched,
                                    stream)
              : launch_tma_shape<1>(tx, tdy, idx, out, g, e, sms, batched,
                                    stream);
}

int run(const void* x, const void* dy, const void* idx, void* out,
        bool batched, int64_t e, int64_t m, int64_t k, int64_t n,
        int n_shards, int n_sel, int block, int dtype, int pipelined,
        void* stream) {
  const int* ip = static_cast<const int*>(idx);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pipelined) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;   // bf16 only
    return (int)launch_tma(x, dy, ip, op, e, m, k, n, n_shards, n_sel, block,
                           batched, st);
  }
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (n > INT32_MAX) return (int)cudaErrorInvalidValue;   // int dy columns
  if (e == 0 || k == 0 || n_shards == 0 || n_sel == 0)
    return (int)cudaSuccess;   // no output
  // elements a 16-byte piece; the pieces need aligned bases, rows and
  // selected blocks
  const int64_t v = dtype == 0 ? 4 : 8;
  Geometry g;
  g.M = m;
  g.K = k;
  g.N = n;
  g.C = (int64_t)n_shards * n_sel * block;
  g.n_sel = n_sel;
  g.block = block;
  g.n_blocks = (int)(n / ((int64_t)n_shards * block));
  g.tiles_per_block = (block + TC - 1) / TC;
  g.vec_x = kCpAsync && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
            k % v == 0;
  g.vec_dy = kCpAsync && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
             n % v == 0 && block % v == 0;
  g.vec_out = g.C % 4 == 0 && (kPackColumns || block % 4 == 0) &&
              reinterpret_cast<uintptr_t>(out) % 16 == 0;
  g.x_stride = m * k;
  g.dy_stride = m * n;
  g.out_stride = k * g.C;
  const int experts = (int)e;
  if (dtype == 0)
    return (int)launch_grid<float>(x, dy, ip, op, g, experts, batched, st);
  if (dtype == 1)
    return (int)launch_grid<__nv_bfloat16>(x, dy, ip, op, g, experts,
                                           batched, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; pipelined: 1 = the TMA + wgmma instance (bf16
// only), 0 = the grid instance. Each returns the launch's CUDA error code.

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
// out [E, K, n_shards, n_sel, block]; E <= 65535 (the grid instance's z).
extern "C" int batched_dw_launch(const void* x, const void* dy,
                                 const void* idx, void* out, int64_t e,
                                 int64_t c, int64_t k, int64_t n,
                                 int n_shards, int n_sel, int block,
                                 int dtype, int pipelined, void* stream) {
  return run(x, dy, idx, out, true, e, c, k, n, n_shards, n_sel, block,
             dtype, pipelined, stream);
}
