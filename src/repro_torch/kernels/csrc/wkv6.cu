// The RWKV-6 WKV recurrence for Hopper, forward and backward.
//
//   y_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,        S_0 = 0
//
// per batch row b and head h, with S a [D, D] fp32 state (key channel d by
// value channel e), w_t the per-channel decay in (0, 1) and u the head's
// bonus. Everything is fp32. The tensors keep the model's layout
// [B, T, H, D], contiguous: element (b, t, h, d) lies at
// ((b * T + t) * H + h) * D + d, so a head's row at step t is D
// consecutive floats and the kernels read it in place, with no transpose
// copy. u is [H, D]: one bonus per head, as the model has it.
//
// Replaces the TPU kernel `wkv6_chunk_kernel` of the reference package
// (src/repro/kernels/wkv6_chunk.py:80). That kernel is not carried over
// block by block:
// - it takes one u [D] for all of B*H and a [B*H, T, D] layout; the model's
//   u is per head, which is why the reference model never calls it. Here u
//   is indexed by head and the model's layout is read with strides;
// - it chunks time in log space, y ~ (r exp(cum_{t-1})) (k exp(-cum_u))^T,
//   and exp(-cum) overflows fp32 once the decays of a chunk multiply below
//   ~1e-38 (w near its 1e-12 clamp, which the data-dependent decay can
//   reach). These kernels step through time one step at a time and only
//   ever multiply by w, so a strong decay underflows to the right limit, 0;
// - it has no backward. The train path needs dr, dk, dv and dw (dw feeds
//   the decay LoRA and through it the layers before), and du: u is a
//   parameter of every trainable layer (it is not selectable, so it takes
//   the optimizer's dense rule, as in the reference's train step).
//
// Design (one CTA of D threads per (b, h): 160 CTAs at batch 4 x 40 heads).
//
// Forward (`wkv6_fwd_kernel`): thread e holds the column S[:, e] in
// registers. TC steps of r, k, v, w are staged in shared memory at a time
// (one coalesced D-float row per step and tensor); per step each thread
// reads r_t, k_t, w_t, u as broadcast float4s and does D fused
// multiply-adds for y_t[e] (four partial sums) and D for its column of S.
//
// Backward (`wkv6_bwd_kernel`, grid (B*H, 2)), with G_t = dL/dS_t:
//   G_{t-1} = r_t dy_t^T + diag(w_t) G_t,     G_T = 0
//   dr_t[d] = sum_e (u_d k_t[d] v_t[e] + S_{t-1}[d,e]) dy_t[e]
//   dk_t[d] = sum_e (u_d r_t[d] dy_t[e] + G_t[d,e]) v_t[e]
//   dv_t[e] = sum_d (u_d r_t[d] dy_t[e] + G_t[d,e]) k_t[d]
//   dw_t[d] = sum_e G_t[d,e] S_{t-1}[d,e]
//   du[d]   = sum_{b,t} r_t[d] k_t[d] (dy_t . v_t)
// dr, dk and dw reduce over e and dv over d, so two roles:
// - blockIdx.y == 0, thread d holds the row d of S and of G:
//   1. forward in time: dr_t and du, and S at every CK-th step written to
//      `ckpt` in device memory ([B*H, ceil(T/CK), D(e), D(d)]);
//   2. backward in time, CK steps at a time: the chunk's S_{t-1} rows are
//      recomputed forward from its checkpoint into shared memory
//      ([CK][D(e)][D(d)], conflict-free: each thread reads its own row),
//      then stepped through in reverse for dk_t and dw_t while G's row
//      runs back. Nothing divides by w: S_{t-1} is never recovered from S_t.
// - blockIdx.y == 1, thread e holds the column e of G: backward in time for
//   dv_t (this needs no S).
// du is written per (b, h) into `du_part` [B, H, D]; the wrapper sums over
// b, so no atomics and the result does not depend on the order of CTAs.
//
// Bound on an H100 at batch 4 x 1024 steps x 40 heads x 64 (fp32): the
// forward reads r, k, v, w (168 MB) and writes y (42 MB), 210 MB or
// 0.063 ms at 3.35 TB/s, and needs 5 operations per (b, t, h, d, e)
// (S: k v, w S and the add; y: r S), 3.4 GFLOP or 0.050 ms at 67 TFLOP/s:
// bytes bound it. The backward reads r, k, v, w, dy and writes dr, dk, dv,
// dw (377 MB, 0.113 ms) and needs 14 operations per element (S again 3,
// G 3, four contractions 2 each), 9.4 GFLOP or 0.140 ms: operations bound
// it. No single PyTorch call computes the recurrence, so there is no
// library yardstick. This first kernel is latency-bound (two warps a CTA,
// one step after another); tensor cores, TMA and a chunked form come later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;    // head size (rwkv6-3b's head_dim)
constexpr int TC = 32;   // forward: steps staged in shared memory at a time
constexpr int CK = 8;    // backward: steps between state checkpoints

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(D)
wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ y, int T,
                int H) {
  __shared__ __align__(16) float sr[TC][D];
  __shared__ __align__(16) float sk[TC][D];
  __shared__ __align__(16) float sw[TC][D];
  __shared__ float sv[TC][D];
  __shared__ __align__(16) float su[D];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, e = threadIdx.x;
  const int64_t ts = (int64_t)H * D;                     // stride of t
  const int64_t base = ((int64_t)b * T * H + h) * D + e;  // (b, 0, h, e)
  su[e] = u[h * D + e];
  float s[D];
#pragma unroll
  for (int j = 0; j < D; ++j) s[j] = 0.0f;
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int n = min(TC, T - t0);
    __syncthreads();                      // the last chunk's reads are done
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const int64_t off = base + (t0 + i) * ts;
      sr[i][e] = r[off];
      sk[i][e] = k[off];
      sv[i][e] = v[off];
      sw[i][e] = w[off];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float ve = sv[i][e];
      float y4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < D; j += 4) {
        const float4 r4 = ld4(&sr[i][j]), k4 = ld4(&sk[i][j]);
        const float4 w4 = ld4(&sw[i][j]), u4 = ld4(&su[j]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = kk[q] * ve;
          y4[q] += rr[q] * (uu[q] * x + s[j + q]);
          s[j + q] = s[j + q] * ww[q] + x;
        }
      }
      y[base + (t0 + i) * ts] = (y4[0] + y4[1]) + (y4[2] + y4[3]);
    }
  }
}

// Role 0 of the backward: thread d, rows of S and G (dr, du, dk, dw).
__device__ void bwd_rows(const float* __restrict__ r,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ dy, float* __restrict__ dr,
                         float* __restrict__ dk, float* __restrict__ dw,
                         float* __restrict__ du_part, float* __restrict__ ckpt,
                         float* __restrict__ sbuf, int T, int H) {
  __shared__ __align__(16) float sv[CK][D];
  __shared__ __align__(16) float sdy[CK][D];
  __shared__ float sr[CK][D], sk[CK][D], sw[CK][D];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, d = threadIdx.x;
  const int64_t ts = (int64_t)H * D;
  const int64_t base = ((int64_t)b * T * H + h) * D + d;
  const int nc = (T + CK - 1) / CK;
  float* ck = ckpt + (int64_t)bh * nc * D * D + d;       // [nc][e][d]
  const float ud = u[h * D + d];

  auto stage = [&](int t0, int n) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const int64_t off = base + (t0 + i) * ts;
      sv[i][d] = v[off];
      sdy[i][d] = dy[off];
      sr[i][d] = r[off];
      sk[i][d] = k[off];
      sw[i][d] = w[off];
    }
    __syncthreads();
  };

  // 1. forward in time: S[d, :] -> dr, du and the checkpoints
  float s[D];
#pragma unroll
  for (int j = 0; j < D; ++j) s[j] = 0.0f;
  float du_acc = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * CK, n = min(CK, T - t0);
#pragma unroll
    for (int j = 0; j < D; ++j) ck[((int64_t)c * D + j) * D] = s[j];
    stage(t0, n);
    for (int i = 0; i < n; ++i) {
      const float kd = sk[i][d], wd = sw[i][d];
      float gr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float gu[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < D; j += 4) {
        const float4 v4 = ld4(&sv[i][j]), g4 = ld4(&sdy[i][j]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
        const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = kd * vv[q];
          gr[q] += (ud * x + s[j + q]) * gg[q];
          gu[q] += x * gg[q];
          s[j + q] = s[j + q] * wd + x;
        }
      }
      dr[base + (t0 + i) * ts] = (gr[0] + gr[1]) + (gr[2] + gr[3]);
      du_acc += sr[i][d] * ((gu[0] + gu[1]) + (gu[2] + gu[3]));
    }
  }
  du_part[(int64_t)bh * D + d] = du_acc;

  // 2. backward in time: G[d, :] -> dk, dw, with each chunk's S_{t-1} rows
  // recomputed from its checkpoint into sbuf[i][e][d]
  float g[D];
#pragma unroll
  for (int j = 0; j < D; ++j) g[j] = 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CK, n = min(CK, T - t0);
    stage(t0, n);
#pragma unroll
    for (int j = 0; j < D; ++j) s[j] = ck[((int64_t)c * D + j) * D];
    for (int i = 0; i < n; ++i) {
      const float kd = sk[i][d], wd = sw[i][d];
#pragma unroll
      for (int j = 0; j < D; j += 4) {
        const float4 v4 = ld4(&sv[i][j]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sbuf[(i * D + j + q) * D + d] = s[j + q];
          s[j + q] = s[j + q] * wd + kd * vv[q];
        }
      }
    }
    for (int i = n - 1; i >= 0; --i) {
      const float rd = sr[i][d], wd = sw[i][d];
      float gk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float gw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < D; j += 4) {
        const float4 v4 = ld4(&sv[i][j]), g4 = ld4(&sdy[i][j]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
        const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = rd * gg[q];
          gk[q] += (ud * x + g[j + q]) * vv[q];
          gw[q] += g[j + q] * sbuf[(i * D + j + q) * D + d];
          g[j + q] = x + g[j + q] * wd;
        }
      }
      const int64_t off = base + (t0 + i) * ts;
      dk[off] = (gk[0] + gk[1]) + (gk[2] + gk[3]);
      dw[off] = (gw[0] + gw[1]) + (gw[2] + gw[3]);
    }
  }
}

// Role 1 of the backward: thread e, the column e of G (dv).
__device__ void bwd_cols(const float* __restrict__ r,
                         const float* __restrict__ k,
                         const float* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ dy, float* __restrict__ dv,
                         int T, int H) {
  __shared__ __align__(16) float sr[CK][D];
  __shared__ __align__(16) float sk[CK][D];
  __shared__ __align__(16) float sw[CK][D];
  __shared__ float sdy[CK][D];
  __shared__ __align__(16) float su[D];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, e = threadIdx.x;
  const int64_t ts = (int64_t)H * D;
  const int64_t base = ((int64_t)b * T * H + h) * D + e;
  const int nc = (T + CK - 1) / CK;
  su[e] = u[h * D + e];
  float g[D];
#pragma unroll
  for (int j = 0; j < D; ++j) g[j] = 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CK, n = min(CK, T - t0);
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const int64_t off = base + (t0 + i) * ts;
      sr[i][e] = r[off];
      sk[i][e] = k[off];
      sw[i][e] = w[off];
      sdy[i][e] = dy[off];
    }
    __syncthreads();
    for (int i = n - 1; i >= 0; --i) {
      const float dye = sdy[i][e];
      float gv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < D; j += 4) {
        const float4 r4 = ld4(&sr[i][j]), k4 = ld4(&sk[i][j]);
        const float4 w4 = ld4(&sw[i][j]), u4 = ld4(&su[j]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = dye * rr[q];
          gv[q] += (uu[q] * x + g[j + q]) * kk[q];
          g[j + q] = x + g[j + q] * ww[q];
        }
      }
      dv[base + (t0 + i) * ts] = (gv[0] + gv[1]) + (gv[2] + gv[3]);
    }
  }
}

__global__ void __launch_bounds__(D)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dy,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ du_part, float* __restrict__ ckpt, int T,
                int H) {
  extern __shared__ __align__(16) float sbuf[];   // [CK][D][D]
  if (blockIdx.y == 0)
    bwd_rows(r, k, v, w, u, dy, dr, dk, dw, du_part, ckpt, sbuf, T, H);
  else
    bwd_cols(r, k, w, u, dy, dv, T, H);
}

constexpr size_t BWD_SMEM = (size_t)CK * D * D * sizeof(float);  // sbuf

bool bad_shape(int B, int T, int H, int d) {
  return B <= 0 || T <= 0 || H <= 0 || d != D;
}

}  // namespace

// y [B, T, H, D] from r, k, v, w [B, T, H, D] and u [H, D], all fp32 and
// contiguous, D = 64. Returns the CUDA error of the launch (0 = launched).
extern "C" int wkv6_fwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* y, int B,
                               int T, int H, int d, void* stream) {
  if (bad_shape(B, T, H, d)) return (int)cudaErrorInvalidValue;
  wkv6_fwd_kernel<<<B * H, D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y), T, H);
  return (int)cudaGetLastError();
}

// The gradients dr, dk, dv, dw [B, T, H, D] and du_part [B, H, D] (du per
// batch row; du is its sum over B) from the forward's inputs and dy
// [B, T, H, D]. ckpt: scratch of wkv6_ckpt_floats(B, T, H) floats.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* dy,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du_part, void* ckpt, int B, int T, int H,
                               int d, void* stream) {
  if (bad_shape(B, T, H, d)) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;          // once per process
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  wkv6_bwd_kernel<<<dim3(B * H, 2), D, BWD_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(dy),
      static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dw),
      static_cast<float*>(du_part), static_cast<float*>(ckpt), T, H);
  return (int)cudaGetLastError();
}

// Floats of the backward's checkpoint scratch: S every CK steps.
extern "C" int64_t wkv6_ckpt_floats(int B, int T, int H) {
  return (int64_t)B * H * ((T + CK - 1) / CK) * D * D;
}
