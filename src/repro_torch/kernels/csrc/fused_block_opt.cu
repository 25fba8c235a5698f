// Fused compact-path optimizer step on the selected blocks, for Hopper.
//
//   w:   [K, R, N]                       stacked weight, fp32 or bf16
//   g:   [K, R, n_shards, n_sel, block]  compact gradient, fp32 or bf16
//   idx: [K, n_shards, n_sel]            int32 selected blocks, shard-local
//   mu:  [K, R, N] fp32                  first moment (momentum, adamw)
//   nu:  [K, R, N] fp32                  second moment (adamw)
//   hyper: [2] fp32 on the device        learning rate, adamw step t
//
// In place, on the selected blocks only: gather, the SGD / momentum / AdamW
// rule in fp32, cast back, write back to w, mu and nu. Nothing outside the
// selected blocks is read or written.
//
// Replaces the TPU kernel `fused_block_opt_kernel` of the reference package
// (src/repro/kernels/fused_block_opt.py).
//
// Bound on an H100: a handful of operations per element against 2 reads and
// 1 write of w plus g, and 2 fp32 reads and writes for each moment: memory
// bound, by the bytes of the selected blocks over 3.35 TB/s. The design
// does what a memory-bound pass can: one pass, each byte read once, neighbour
// threads on neighbour columns of a selected block so the loads coalesce.
//
// Rounding. The rule must round as PyTorch's separate element-wise ops do
// (and as the reference's jnp ops do), so SGD is bitwise equal to the plain
// version. nvcc would contract `p - lr*g` and `momentum*mu + g` into FMAs,
// which round once where the plain version rounds twice: this file is built
// with -fmad=false. The order of operations is the reference's
// (`(lr*wd)*p`, `((1-b2)*g)*g`); 1-beta1 and 1-beta2 are formed on the host
// in double and cast to float, as JAX's weak types are; the cast back to
// bf16 rounds to nearest even. lr and t come from a device buffer, so a
// schedule needs no host sync and no rebuild.
//
// Grid: (row tiles, n_shards * n_sel, K). The wrapper passes no duplicate
// index within a shard (selection never makes one), so no two threads
// write one element.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false (see repro_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;      // elements per thread per grid pass

enum Kind { SGD = 0, MOMENTUM = 1, ADAMW = 2 };

struct Geometry {
  int64_t K, R, N;
  int n_shards, n_sel, block, n_blocks;
};

struct Hyper {
  float momentum, beta1, beta2, one_minus_b1, one_minus_b2, eps, wd;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TW, typename TG>
__global__ void __launch_bounds__(THREADS)
fused_block_opt_kernel(TW* __restrict__ w, const TG* __restrict__ g,
                       const int* __restrict__ idx, float* __restrict__ mu,
                       float* __restrict__ nu,
                       const float* __restrict__ hyper, Geometry geo,
                       int kind, Hyper h) {
  const int64_t kk = blockIdx.z;
  const int sj = blockIdx.y;                      // s * n_sel + j
  const int s = sj / geo.n_sel;
  int sel = idx[kk * geo.n_shards * geo.n_sel + sj];
  // indices are trusted; the clamp only keeps a bad one inside the tensor
  sel = min(max(sel, 0), geo.n_blocks - 1);
  const float lr = hyper[0];
  const float t = hyper[1];
  const int64_t col0 = ((int64_t)s * geo.n_blocks + sel) * geo.block;
  const int64_t elems = geo.R * geo.block;
  const int64_t g_row = (int64_t)geo.n_shards * geo.n_sel * geo.block;

  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < elems; e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = e / geo.block;
    const int64_t c = e % geo.block;
    const int64_t wo = (kk * geo.R + r) * geo.N + col0 + c;
    const int64_t go = (kk * geo.R + r) * g_row + (int64_t)sj * geo.block + c;
    const float p = load_f32(w + wo);
    const float gr = load_f32(g + go);
    float nw;
    if (kind == SGD) {
      nw = p - lr * gr;
      if (h.wd != 0.f) nw = nw - (lr * h.wd) * p;
    } else if (kind == MOMENTUM) {
      const float m = h.momentum * mu[wo] + gr;
      nw = p - lr * m;
      if (h.wd != 0.f) nw = nw - (lr * h.wd) * p;
      mu[wo] = m;
    } else {
      const float m = h.beta1 * mu[wo] + h.one_minus_b1 * gr;
      const float v = h.beta2 * nu[wo] + (h.one_minus_b2 * gr) * gr;
      const float m_hat = m / (1.f - powf(h.beta1, t));
      const float v_hat = v / (1.f - powf(h.beta2, t));
      nw = p - lr * (m_hat / (sqrtf(v_hat) + h.eps) + h.wd * p);
      mu[wo] = m;
      nu[wo] = v;
    }
    store_from_f32(w + wo, nw);
  }
}

template <typename TW, typename TG>
cudaError_t launch(void* w, const void* g, const int* idx, float* mu,
                   float* nu, const float* hyper, const Geometry& geo,
                   int kind, const Hyper& h, cudaStream_t stream) {
  const int64_t elems = geo.R * geo.block;
  int64_t tiles = (elems + (int64_t)THREADS * ITEMS - 1) /
                  ((int64_t)THREADS * ITEMS);
  if (tiles > 65535) tiles = 65535;
  const dim3 grid((unsigned)tiles, (unsigned)(geo.n_shards * geo.n_sel),
                  (unsigned)geo.K);
  fused_block_opt_kernel<TW, TG><<<grid, THREADS, 0, stream>>>(
      static_cast<TW*>(w), static_cast<const TG*>(g), idx, mu, nu, hyper,
      geo, kind, h);
  return cudaGetLastError();
}

}  // namespace

// w_dtype / g_dtype: 0 = fp32, 1 = bf16. kind: 0 sgd, 1 momentum, 2 adamw.
// Returns the launch's cudaGetLastError().
extern "C" int fused_block_opt_launch(
    void* w, const void* g, const void* idx, void* mu, void* nu,
    const void* hyper, int64_t k, int64_t r, int64_t n, int n_shards,
    int n_sel, int block, int w_dtype, int g_dtype, int kind, float momentum,
    float beta1, float beta2, float one_minus_b1, float one_minus_b2,
    float eps, float weight_decay, void* stream) {
  Geometry geo;
  geo.K = k;
  geo.R = r;
  geo.N = n;
  geo.n_shards = n_shards;
  geo.n_sel = n_sel;
  geo.block = block;
  geo.n_blocks = (int)(n / ((int64_t)n_shards * block));
  Hyper h{momentum, beta1, beta2, one_minus_b1, one_minus_b2, eps,
          weight_decay};
  const int* ip = static_cast<const int*>(idx);
  float* mp = static_cast<float*>(mu);
  float* np_ = static_cast<float*>(nu);
  const float* hp = static_cast<const float*>(hyper);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0 && g_dtype == 0)
    return (int)launch<float, float>(w, g, ip, mp, np_, hp, geo, kind, h, st);
  if (w_dtype == 0 && g_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(w, g, ip, mp, np_, hp, geo, kind,
                                             h, st);
  if (w_dtype == 1 && g_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(w, g, ip, mp, np_, hp, geo, kind,
                                             h, st);
  if (w_dtype == 1 && g_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(w, g, ip, mp, np_, hp,
                                                     geo, kind, h, st);
  return (int)cudaErrorInvalidValue;
}
