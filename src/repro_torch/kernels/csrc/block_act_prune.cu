// Block activation pruning (ZeBRA, paper §III-A.2), forward and backward,
// for Hopper.
//
//   forward:   y  = x  * keep(x)
//   backward:  dx = dy * keep(y)
//
// over a contiguous tensor of n elements whose last dim C is a multiple of
// `block`: the flat array is a run of n / block consecutive blocks, none of
// which crosses a row. keep(a) is 1 for a block whose max |a| is at least
// the threshold, else 0. The max propagates NaN (as jnp.max and
// torch.amax do), so a block holding a NaN is pruned. fp32 or bf16.
//
// Replaces the TPU kernel `block_act_prune_kernel` of the reference package
// (src/repro/kernels/block_act_prune.py). The reference has no backward
// kernel: its gradient is what jax.grad takes through the jnp version,
// dy * keep. The backward reads its mask from the saved OUTPUT y: for a
// threshold > 0, max|y_blk| >= thr exactly when max|x_blk| >= thr (a kept
// block is unchanged, a pruned one is +-0 or NaN), and for a threshold
// <= 0 both masks are all ones. So the backward needs nothing beyond y,
// which the next convolution saves anyway.
//
// Rounding. The result is a multiplication by 0 or 1 in fp32 and a cast
// back, never a select: -0.0 and NaN come out as the reference's
// `xb * keep` gives them, and both entry points equal the plain versions
// (kernels/ref.py) bitwise. The wrapper passes the threshold rounded to
// the tensor's type, as the comparison with a Python float does on both
// frameworks.
//
// Bound on an H100: memory. Two bytes-per-element passes forward (read x,
// write y), three backward (read dy and y, write dx); a handful of
// operations per element. Design: a single pass, grid-stride. Where the
// pointers are 16-byte aligned and `block` divides a 16-byte vector (4
// fp32 or 8 bf16 values: block 1, 2, 4, and 8 for bf16), each thread loads
// and stores 16 bytes and its vector holds whole blocks; the blocks after
// the last whole vector are taken one by one in the same launch. Other
// blocks and alignments take the scalar loop, one block per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;   // 16 resident blocks on each of 132 SMs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// Running max of |v| that keeps a NaN once it has seen one.
__device__ __forceinline__ float absmax(float m, float v) {
  const float a = fabsf(v);
  return (a > m || a != a) ? a : m;
}

// out[0:len] = a[0:len] * keep(mask[0:len]) for one block of `len` values.
template <typename T>
__device__ __forceinline__ void prune_block(const T* a, const T* mask, T* out,
                                            int len, float thr) {
  float m = 0.0f;
  for (int j = 0; j < len; ++j) m = absmax(m, to_f32(mask[j]));
  const float keep = m >= thr ? 1.0f : 0.0f;
  for (int j = 0; j < len; ++j) out[j] = from_f32<T>(to_f32(a[j]) * keep);
}

// BLOCK > 0: the vector path for blocks of BLOCK values, n_vec 16-byte
// vectors first, then blocks [n_vec * VEC / BLOCK, n_blk) one by one.
// BLOCK == 0: the scalar loop over all n_blk blocks of `block` values.
template <typename T, int BLOCK>
__global__ void __launch_bounds__(THREADS)
prune_kernel(const T* __restrict__ a, const T* __restrict__ mask,
             T* __restrict__ out, int64_t n_vec, int64_t n_blk, int block,
             float thr) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t first = 0;
  if constexpr (BLOCK > 0) {
    static_assert(VEC % BLOCK == 0, "a vector must hold whole blocks");
    const bool same = a == mask;
    for (int64_t v = tid; v < n_vec; v += stride) {
      uint4 ra = reinterpret_cast<const uint4*>(a)[v];
      uint4 rm = same ? ra : reinterpret_cast<const uint4*>(mask)[v];
      uint4 ro;
      const T* ea = reinterpret_cast<const T*>(&ra);
      const T* em = reinterpret_cast<const T*>(&rm);
      T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int b0 = 0; b0 < VEC; b0 += BLOCK) {
        float m = 0.0f;
#pragma unroll
        for (int j = 0; j < BLOCK; ++j) m = absmax(m, to_f32(em[b0 + j]));
        const float keep = m >= thr ? 1.0f : 0.0f;
#pragma unroll
        for (int j = 0; j < BLOCK; ++j)
          eo[b0 + j] = from_f32<T>(to_f32(ea[b0 + j]) * keep);
      }
      reinterpret_cast<uint4*>(out)[v] = ro;
    }
    first = n_vec * (VEC / BLOCK);
    block = BLOCK;
  }
  for (int64_t i = first + tid; i < n_blk; i += stride) {
    const int64_t base = i * block;
    prune_block(a + base, mask + base, out + base, block, thr);
  }
}

template <typename T, int BLOCK>
void launch(const T* a, const T* mask, T* out, int64_t n, int block,
            float thr, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_VEC = BLOCK > 0 ? VEC / BLOCK : 1;   // blocks a vector
  const int64_t n_blk = n / block;
  const int64_t n_vec = BLOCK > 0 ? n / VEC : 0;
  // threads' worth of work: the vectors, then the blocks after them
  const int64_t work = n_vec + (n_blk - n_vec * PER_VEC);
  int64_t grid = (work + THREADS - 1) / THREADS;
  if (grid > MAX_BLOCKS) grid = MAX_BLOCKS;
  if (grid < 1) grid = 1;
  prune_kernel<T, BLOCK><<<(unsigned)grid, THREADS, 0, stream>>>(
      a, mask, out, n_vec, n_blk, block, thr);
}

template <typename T>
int dispatch(const void* a, const void* mask, void* out, int64_t n,
             int block, float thr, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* ta = static_cast<const T*>(a);
  const T* tm = static_cast<const T*>(mask);
  T* to = static_cast<T*>(out);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(mask) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (n == 0) return 0;
  bool vectorised = aligned;
  if (aligned && block == 1) {
    launch<T, 1>(ta, tm, to, n, block, thr, stream);
  } else if (aligned && block == 2) {
    launch<T, 2>(ta, tm, to, n, block, thr, stream);
  } else if (aligned && block == 4) {
    launch<T, 4>(ta, tm, to, n, block, thr, stream);
  } else {
    vectorised = false;
    if constexpr (VEC % 8 == 0) {
      if (aligned && block == 8) {
        launch<T, 8>(ta, tm, to, n, block, thr, stream);
        vectorised = true;
      }
    }
  }
  if (!vectorised) launch<T, 0>(ta, tm, to, n, block, thr, stream);
  return (int)cudaGetLastError();
}

int prune(const void* a, const void* mask, void* out, int64_t n, int block,
          float thr, int dtype, void* stream) {
  if (block <= 0 || n % block != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, mask, out, n, block, thr, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, mask, out, n, block, thr, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y = x * keep(x). n: elements; dtype 0 = fp32, 1 = bf16. Returns the CUDA
// error of the launch (0 = launched).
extern "C" int block_act_prune_fwd_launch(const void* x, void* y, int64_t n,
                                          int block, float threshold,
                                          int dtype, void* stream) {
  return prune(x, x, y, n, block, threshold, dtype, stream);
}

// dx = dy * keep(y), y the forward's output.
extern "C" int block_act_prune_bwd_launch(const void* dy, const void* y,
                                          void* dx, int64_t n, int block,
                                          float threshold, int dtype,
                                          void* stream) {
  return prune(dy, y, dx, n, block, threshold, dtype, stream);
}
