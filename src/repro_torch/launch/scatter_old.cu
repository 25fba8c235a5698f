// The block scatter-update kernel as it was before the column-order walk:
// in place only, one thread a 16-byte piece of upd in upd's memory order,
// three 64-bit divisions a piece to find its destination, half-sector
// stores at the serving wave's block of 8 in bf16. Not built with the
// port: `python -m repro_torch.launch.scatter_probe` builds it on its own
// (entry `block_scatter_update_launch`, the earlier argument list without
// `out`) to time it beside the shipped kernel, alone and after a clone of
// the weight (the out-of-place function as the wave used to compute it).
//
// The rest of this file is the earlier source, unchanged.
//
// Block scatter-update for Hopper: overwrite the selected column blocks of
// a stacked weight, in place.
//
//   w[k, r, (s * n_blocks + idx[k, s, j]) * block + c] = cast(upd[k, r, s, j, c])
//
//   w    [K, R, N]                 fp32 or bf16, N = S * n_blocks * block
//   upd  [K, R, S, n_sel, block]   fp32, or w's type
//   idx  [K, S, n_sel]             int32, block ids local to each shard
//
// Replaces the TPU kernel `block_scatter_update_kernel` of the reference
// package (src/repro/kernels/scatter_blocks.py), which aliases w to its
// output: unselected blocks are never read or written. A stacked leaf with
// lead dims ([K, E, d, N]) arrives with them flattened into R by the
// wrapper. idx is read from device memory inside the kernel, so a new
// selection rebuilds nothing. An index outside [0, n_blocks) is skipped
// (the plain version raises on it); duplicates within a (k, s) leave
// either value, as the reference's selection never makes them.
//
// Rounding. fp32 -> bf16 is round-to-nearest-even (`__float2bfloat16_rn`),
// as `.astype` and `Tensor.to` do, and a NaN stores 0x7FC0 as `Tensor.to`
// does, so every stored value equals the plain version's (kernels/ref.py)
// bit for bit. Same-type copies move bits.
//
// Bound on an H100: memory. Each selected element is read once from upd
// and written once into w (4 + 2 bytes for fp32 upd into a bf16 weight);
// there is no arithmetic to speak of. Design: one thread per 16-byte piece
// of a selected block of one row. Threads run along upd's memory order, so
// neighbouring threads read neighbouring upd bytes; each writes one
// 16-byte vector into w. At the online wave's channel block of 8 in bf16
// that is one store per (row, block), which fills half of a 32-byte sector:
// the likely gap to the bound. Where a block or a base pointer is not
// 16-byte aligned, a scalar loop takes one element per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;   // 16 resident blocks on each of 132 SMs

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

struct Geometry {
  int64_t rows;      // K * R * S * n_sel: one (k, r, s, j) per "row"
  int64_t R;
  int64_t N;
  int S, n_sel, n_blocks, block;
};

// The destination of element c of upd row u = ((k * R + r) * S + s) * n_sel
// + j, or nullptr when its block index is out of range.
template <typename TW>
__device__ __forceinline__ TW* dest(TW* w, const int* idx, const Geometry& g,
                                    int64_t u) {
  const int j = (int)(u % g.n_sel);
  int64_t t = u / g.n_sel;
  const int s = (int)(t % g.S);
  t /= g.S;                                   // t = k * R + r
  const int64_t k = t / g.R;
  const int b = idx[(k * g.S + s) * g.n_sel + j];
  if (b < 0 || b >= g.n_blocks) return nullptr;
  return w + t * g.N + ((int64_t)s * g.n_blocks + b) * g.block;
}

// VEC_W weight elements (16 bytes) per thread; a block is `block / VEC_W`
// pieces. Requires 16-byte alignment of w, upd, N * sizeof(TW) and
// block * sizeof(TU).
template <typename TW, typename TU>
__global__ void __launch_bounds__(THREADS)
scatter_vec_kernel(TW* __restrict__ w, const TU* __restrict__ upd,
                   const int* __restrict__ idx, Geometry g) {
  constexpr int VEC_W = 16 / sizeof(TW);
  constexpr int LOADS = VEC_W * sizeof(TU) / 16;   // 16-byte loads a piece
  const int pieces = g.block / VEC_W;
  const int64_t n = g.rows * pieces;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const int64_t u = p / pieces;
    const int c = (int)(p % pieces) * VEC_W;
    TW* dst = dest(w, idx, g, u);
    if (dst == nullptr) continue;
    const uint4* src = reinterpret_cast<const uint4*>(upd + u * g.block + c);
    uint4 in[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) in[i] = src[i];
    const TU* e = reinterpret_cast<const TU*>(in);
    uint4 out;
    TW* o = reinterpret_cast<TW*>(&out);
#pragma unroll
    for (int i = 0; i < VEC_W; ++i) o[i] = cast<TW, TU>(e[i]);
    *reinterpret_cast<uint4*>(dst + c) = out;
  }
}

// One element per thread: any block size and alignment.
template <typename TW, typename TU>
__global__ void __launch_bounds__(THREADS)
scatter_scalar_kernel(TW* __restrict__ w, const TU* __restrict__ upd,
                      const int* __restrict__ idx, Geometry g) {
  const int64_t n = g.rows * g.block;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int64_t u = e / g.block;
    TW* dst = dest(w, idx, g, u);
    if (dst != nullptr) dst[e % g.block] = cast<TW, TU>(upd[e]);
  }
}

unsigned grid_for(int64_t work) {
  int64_t grid = (work + THREADS - 1) / THREADS;
  if (grid > MAX_BLOCKS) grid = MAX_BLOCKS;
  if (grid < 1) grid = 1;
  return (unsigned)grid;
}

template <typename TW, typename TU>
int launch(void* w, const void* upd, const int* idx, const Geometry& g,
           cudaStream_t stream) {
  constexpr int VEC_W = 16 / sizeof(TW);
  TW* tw = static_cast<TW*>(w);
  const TU* tu = static_cast<const TU*>(upd);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(upd)) &
       15) == 0 &&
      g.block % VEC_W == 0 && (g.N * (int64_t)sizeof(TW)) % 16 == 0;
  if (aligned) {
    scatter_vec_kernel<TW, TU><<<grid_for(g.rows * (g.block / VEC_W)),
                                 THREADS, 0, stream>>>(tw, tu, idx, g);
  } else {
    scatter_scalar_kernel<TW, TU><<<grid_for(g.rows * g.block), THREADS, 0,
                                    stream>>>(tw, tu, idx, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// w_dtype / upd_dtype: 0 = fp32, 1 = bf16 (upd is fp32 or w's type).
// Returns the CUDA error of the launch (0 = launched).
extern "C" int block_scatter_update_launch(void* w, const void* upd,
                                           const void* idx, int64_t K,
                                           int64_t R, int64_t N, int S,
                                           int n_sel, int block, int w_dtype,
                                           int upd_dtype, void* stream) {
  if (K < 0 || R < 0 || S <= 0 || n_sel < 0 || block <= 0 ||
      N % ((int64_t)S * block) != 0)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.rows = K * R * S * n_sel;
  g.R = R;
  g.N = N;
  g.S = S;
  g.n_sel = n_sel;
  g.n_blocks = (int)(N / ((int64_t)S * block));
  g.block = block;
  if (g.rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (w_dtype == 0 && upd_dtype == 0)
    return launch<float, float>(w, upd, ix, g, s);
  if (w_dtype == 1 && upd_dtype == 0)
    return launch<__nv_bfloat16, float>(w, upd, ix, g, s);
  if (w_dtype == 1 && upd_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(w, upd, ix, g, s);
  return (int)cudaErrorInvalidValue;
}
