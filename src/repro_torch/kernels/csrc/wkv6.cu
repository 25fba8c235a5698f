// The RWKV-6 WKV recurrence for Hopper, forward and backward, in chunks of
// time, in linear space.
//
//   y_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,        S_0 = s0 (0 in training)
//
// per batch row b and head h, with S a [D, D] fp32 state (key channel d by
// value channel e), w_t the per-channel decay in (0, 1) and u the head's
// bonus. Everything is fp32. The tensors keep the model's layout
// [B, T, H, D], contiguous: element (b, t, h, d) lies at
// ((b * T + t) * H + h) * D + d, so a head's row at step t is D
// consecutive floats (256 bytes) and the kernels copy it in place, with no
// transpose copy. u is [H, D]: one bonus per head, as the model has it.
//
// Replaces the TPU kernel `wkv6_chunk_kernel` of the reference package
// (src/repro/kernels/wkv6_chunk.py:80). That kernel chunks time in log
// space, y ~ (r exp(cum_{t-1})) (k exp(-cum_u))^T, and exp(-cum) overflows
// fp32 once the decays of a chunk multiply below ~1e-38 (w near its 1e-12
// clamp, which the data-dependent decay can reach). Here every decay factor
// is a product of w's built by running multiplication, never a quotient,
// an exp or a log, so a strong decay underflows to its limit, 0. For a
// chunk of steps t0 .. t0+C-1 and each channel d:
//   A_t = prod_{t0<=s<t} w_s,  B_t = prod_{t<s<=t0+C-1} w_s,
//   Pi  = the chunk's product, P(j, t) = prod_{j<s<t} w_s for j < t,
// P(j, t) built for a fixed j as t grows. The TPU kernel also takes one u
// for all heads (why the reference model never calls it) and has no
// backward; the train path needs dr, dk, dv, dw and du.
//
// Forward (`wkv6_fwd_chunk_kernel`, grid (D / E value slices, B*H), eight
// warps; E = 64, one CTA a head): with S_c the state before a chunk (S_0
// loaded from `s0` when one is given, for serving: a prefill chunk or a
// one-token decode step continues the slot's state),
//   att[t, j] = sum_d r_t k_j P(j, t)  (j < t),  att[t, t] = r_t . (u k_t),
//   y = (r A) S_c + att V,    S_{c+1} = diag(Pi) S_c + (k B)^T V.
// Only the state carries from chunk to chunk, so the CTA is a two-stage
// pipeline: while four "main" warps turn chunk j into y and S_{c+1} (the
// state in their `mma.sync` accumulators, warp i rows 16 i .. 16 i + 15),
// four "prep" warps derive from chunk j + 1 all that does not need the
// state (r A, k B, Pi, the scores, a copy of v) into the other of two
// slots, and the TMA copies chunk j + 2 into the other of two input
// buffers (one box of 16 steps x 64 floats a tensor, from a 4-D tensor map
// over [B, T, H, D] whose steps past T read as zeros; an mbarrier a
// buffer): one CTA barrier a chunk. After the last chunk the main warps
// store their accumulators, the state S_T, to `s_last` when one is given.
// The products run on the tensor cores as m16n8k8 TF32 with each operand
// split into a high and a low TF32 part (3xTF32: hi*hi + hi*lo + lo*hi,
// fp32 accumulators): plain TF32 keeps 10 bits and misses a 1e-4-of-max
// bound. The decays (running
// products over C steps) and the scores (per j a running product over t,
// summed over channels by lane shuffles) are fp32 FMAs.
//
// Backward, with G_t = dL/dS_t, G_{t-1} = r_t dy_t^T + diag(w_t) G_t:
//   dr_t[d] = sum_e (u_d k_t[d] v_t[e] + S_{t-1}[d,e]) dy_t[e]
//   dk_t[d] = sum_e (u_d r_t[d] dy_t[e] + G_t[d,e]) v_t[e]
//   dv_t[e] = sum_d (u_d r_t[d] dy_t[e] + G_t[d,e]) k_t[d]
//   dw_t[d] = sum_e G_t[d,e] S_{t-1}[d,e]
//   du[d]   = sum_{b,t} r_t[d] k_t[d] (dy_t . v_t)
// Two kernels:
// 1. `wkv6_bwd_scan_kernel`, grid (D / E, B*H, 2), the forward's pipeline:
//    z = 0 is the forward run backwards in time with r and k swapped and
//    dy for v, which is dv (G_t plays S_{t-1}), and writes G_c, the
//    gradient of the state after every chunk's last step; z = 1 walks the
//    forward without y and writes S_c, the state before every chunk. Both
//    into `ckpt`, [2][B*H][nc][D][D] (z = 0's half second).
// 2. `wkv6_bwd_chunk_kernel`, grid (nc, B*H), eight warps: every chunk on
//    its own, from S_c, G_c and its inputs. With alpha_j = P(j, t) k_j
//    (j < t), beta_s = P(t, s) r_s (s > t), the products SD = dy S_c^T,
//    GV = v G_c^T, VD[s, j] = dy_s . v_j (3xTF32) and SG = rowsum(S_c G_c):
//      dr_t = A_t SD_t + sum_j alpha_j VD[t, j] + u k_t VD[t, t]
//      dk_t = B_t GV_t + sum_s beta_s VD[s, t] + u r_t VD[t, t]
//      dw_t = A_t B_t SG + A_t sum_s beta_s SD_s + B_t sum_j alpha_j GV_j
//             + sum_s beta_s sum_j alpha_j VD[s, j]
//    which is rowsum(G_t * S_{t-1}) with S_{t-1} = A_t S_c + sum_j alpha_j
//    v_j and G_t = B_t G_c + sum_s beta_s dy_s expanded: dw is computed
//    directly, never as a cumulative sum divided by w. The sums over j and
//    s are recurrences over t per channel (one walk forward, one back), so
//    a chunk costs O(C^2) a channel. du is written per (b, h, chunk) into
//    `du_part` [B, H, nc, D] and summed by the wrapper in a fixed order: no
//    atomics, the result does not depend on the order of CTAs.
// Steps past T are zero-filled: k = v = r = dy = 0 add nothing. Their
// w = 0 is read as 1 where the decay products k B and Pi are formed, so
// the state after a partial last chunk is S_T (what `s_last` stores);
// everywhere else it only scales states that nothing reads.
//
// Bound on an H100 at batch 4 x 1024 steps x 40 heads x 64 (fp32): the
// forward reads r, k, v, w (168 MB) and writes y (42 MB), 210 MB or
// 0.063 ms at 3.35 TB/s, and needs 5 operations per (b, t, h, d, e)
// (S: k v, w S and the add; y: r S), 3.4 GFLOP or 0.050 ms at 67 TFLOP/s:
// bytes bound it. The backward reads r, k, v, w, dy and writes dr, dk, dv,
// dw (377 MB, 0.113 ms) and needs 14 operations per element (S again 3,
// G 3, four contractions 2 each), 9.4 GFLOP or 0.140 ms at fp32's rate:
// operations bound it at fp32's rate. No single PyTorch call computes the
// recurrence, so there is no library yardstick. What holds each kernel
// (clock64 stamps in one CTA, and `python -m repro_torch.launch.wkv_probe`)
// is in PERF.md: the forward is a chain of T / C dependent chunks a head,
// and the products of a chunk run on the tensor cores of a single SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/build.py).

#include <cuda.h>  // CUtensorMap and its enums only: no driver call is linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head size (rwkv6-3b's head_dim)
// Padded rows of tiles in shared memory. A fragment whose row index is
// mma.sync's group g (0..7) is conflict-free at a stride of 4 mod 32
// (DPG); one whose row index is q (0..3) at 8 mod 32 (DP).
constexpr int DP = D + 8;
constexpr int DPG = D + 4;
constexpr int FWD_C = 16;      // forward: steps a chunk
constexpr int FWD_E = 64;      // forward: value columns a CTA
constexpr int BWD_C = 16;      // backward: steps a chunk (both kernels)
constexpr int BWD_E = 64;      // backward scan: value columns a CTA
constexpr bool kPipe = true;   // scan: prep of chunk j + 1 under main of j
constexpr int kMma = 3;        // 3: 3xTF32 mma.sync; 1: plain TF32; 0: FMA
constexpr int SCAN_THREADS = 256;  // warps 0-3: prep; 4-7: main
constexpr int CHUNK_THREADS = 256;

// ---------------------------------------------------------------------------
// copies, barriers and the tensor-core step
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of `parity` to complete. A wait that lasts ~8 s (a
// count that never arrives) traps: the launch then fails in the caller
// instead of hanging the card.
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

// One box of a 4-D tensor map (inner coordinate first) into shared memory
// by the TMA; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(d), "r"(h), "r"(t), "r"(b)
      : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The lane's four accumulators of a 16 x 8 tile of C are C(g, 2q),
// C(g, 2q + 1), C(g + 8, 2q), C(g + 8, 2q + 1) with g = lane / 4,
// q = lane % 4 (mma.sync's layout). fma_step computes them with fp32 FMAs
// from whole rows of A and columns of B (kMma = 0, for the probe).
__device__ __forceinline__ void fma_step(float c[4], const float* a, int ai,
                                         int ak, const float* b, int bk,
                                         int bj, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float a0 = a[g * ai + k * ak], a1 = a[(g + 8) * ai + k * ak];
    const float b0 = b[k * bk + 2 * q * bj];
    const float b1 = b[k * bk + (2 * q + 1) * bj];
    c[0] = fmaf(a0, b0, c[0]);
    c[1] = fmaf(a0, b1, c[1]);
    c[2] = fmaf(a1, b0, c[2]);
    c[3] = fmaf(a1, b1, c[3]);
  }
}

// c[n] += A B_n for NN 16 x 8 tiles that share A, one step of depth 8, the
// operands in shared memory: A(i, k) = a[i * ai + k * ak] and
// B_n(k, j) = b[n * bn + k * bk + j * bj]. A's fragment is read and split
// into its high and low TF32 parts once for all NN tiles.
template <int NN>
__device__ __forceinline__ void mma_steps(float (*c)[4], const float* a,
                                          int ai, int ak, const float* b,
                                          int bn, int bk, int bj, int lane) {
  if constexpr (kMma == 0) {
#pragma unroll
    for (int n = 0; n < NN; ++n)
      fma_step(c[n], a, ai, ak, b + n * bn, bk, bj, lane);
  } else {
    const int g = lane >> 2, q = lane & 3;
    const float af[4] = {a[g * ai + q * ak], a[(g + 8) * ai + q * ak],
                         a[g * ai + (q + 4) * ak],
                         a[(g + 8) * ai + (q + 4) * ak]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = to_tf32(af[i]);
      al[i] = to_tf32(af[i] - __uint_as_float(ah[i]));
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float* bb = b + n * bn;
      const float bf[2] = {bb[q * bk + g * bj], bb[(q + 4) * bk + g * bj]};
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bh[i] = to_tf32(bf[i]);
        bl[i] = to_tf32(bf[i] - __uint_as_float(bh[i]));
      }
      if constexpr (kMma == 3) {
        mma_tf32(c[n], al, bh);
        mma_tf32(c[n], ah, bl);
      }
      mma_tf32(c[n], ah, bh);
    }
  }
}

// x[0..3] = p[4l .. 4l+3], x[4..7] = p[32+4l .. 32+4l+3]
__device__ __forceinline__ void ld8(float x[8], const float* p, int l) {
  const float4 a = *reinterpret_cast<const float4*>(p + 4 * l);
  const float4 b = *reinterpret_cast<const float4*>(p + 32 + 4 * l);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// One round of a sum over lanes that halves the values a lane holds: the
// lane whose `bit` is set keeps part[HALF ..] and sends part[.. HALF) to
// its partner, which keeps the lower half; each keeps the sum of its half.
template <int HALF, int BIT>
__device__ __forceinline__ void fold(float* part, int l) {
  const bool up = (l & BIT) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float mine = up ? part[HALF + i] : part[i];
    const float other = up ? part[i] : part[HALF + i];
    part[i] = mine + __shfl_xor_sync(0xffffffffu, other, BIT);
  }
}

__device__ __forceinline__ int64_t row_off(int b, int t, int h, int T,
                                           int H) {
  return (((int64_t)b * T + t) * H + h) * D;
}

// ---------------------------------------------------------------------------
// The scan: one (b, h) and E value columns, chunk after chunk
// ---------------------------------------------------------------------------

template <int C, int E>
struct ScanSmem {
  static constexpr int EP = E + 8, CP = C + 4;
  // the inputs of one chunk as the TMA writes them (dense [C][D] and
  // [C][E] boxes in time order), two buffers
  static constexpr int R = 0, K = R + C * D, W = K + C * D, V = W + C * D;
  static constexpr int BUF = V + C * E;
  // what prep derives from one chunk for main, two slots
  static constexpr int RA = 0, KB = RA + C * DPG, ATT = KB + C * DP;
  static constexpr int PI = ATT + C * CP, VV = PI + D, SLOT = VV + C * EP;
  // offsets from the base: buffers, slots, the state (two), u
  static constexpr int BUFS = 0, SLOTS = 2 * BUF, S = SLOTS + 2 * SLOT;
  static constexpr int U = S + 2 * D * EP, BARS = U + D;  // 2 x 8 bytes
  static constexpr int FLOATS = BARS + 4;
  static constexpr size_t BYTES = (size_t)FLOATS * sizeof(float);
  static_assert(BARS % 2 == 0 && BUF % 32 == 0 && SLOTS % 32 == 0,
                "mbarriers 8-byte, TMA boxes 128-byte aligned");
};

// The forward on one (b, h) and value columns e0 .. e0 + E - 1, with the
// roles of r, k, v taken by the tensor maps `rr`, `kk`, `vv` (boxes of
// C steps x D floats, v's of C x E). REV walks time backwards
// (chunks in reverse, each chunk's steps in reverse), chunks still aligned
// to t = 0. OUT writes the output (y, or dv when reversed); STATES writes
// the state before every chunk (in walking order) to `states`
// [B*H][nc][D][D].
//
// Two groups of four warps, software-pipelined over chunks: while "main"
// (warps 4-7) turns chunk j into y and the next state, "prep" (warps 0-3)
// derives from chunk j + 1 all that does not depend on the state (the
// decays, the scores, v) into the other of two slots, and every thread
// copies chunk j + 2 into the other of two input buffers. One barrier a
// chunk.
template <int C, int E, bool REV, bool OUT, bool STATES>
__device__ __forceinline__ void scan(const CUtensorMap* rr,
                                     const CUtensorMap* kk,
                                     const CUtensorMap* vv,
                                     const CUtensorMap* w,
                                     const float* __restrict__ u,
                                     float* __restrict__ out,
                                     float* __restrict__ states,
                                     const float* __restrict__ s0,
                                     float* __restrict__ s_last, int T,
                                     int H, float* sm) {
  using L = ScanSmem<C, E>;
  constexpr int NT = E / 8, PT = SCAN_THREADS / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int e0 = blockIdx.x * E, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nc = (T + C - 1) / C;
  const bool prep_warp = tid < PT;

  for (int i = tid; i < 2 * L::SLOT; i += SCAN_THREADS)
    sm[L::SLOTS + i] = 0.0f;
  // the state before the first chunk: s0's rows, value columns e0 ..
  // e0 + E - 1 (zero without s0), in shared memory for y and in the main
  // warps' accumulators below
  for (int i = tid; i < D * L::EP; i += SCAN_THREADS) {
    const int d = i / L::EP, e = i % L::EP;
    sm[L::S + i] = s0 != nullptr && e < E
                       ? s0[((int64_t)bh * D + d) * D + e0 + e]
                       : 0.0f;
  }
  if (tid < D) sm[L::U + tid] = u[h * D + tid];

  // step i of the j-th chunk walked -> its time
  auto time_of = [&](int j, int i) {
    return REV ? (nc - 1 - j) * C + (C - 1 - i) : j * C + i;
  };
  // chunk j -> input buffer j & 1: one thread asks the TMA for one box a
  // tensor; steps past T lie outside the maps and arrive as zeros. The
  // buffer's mbarrier completes when all the bytes have landed.
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int j) {
    if (tid != 0) return;
    float* base = sm + L::BUFS + (j & 1) * L::BUF;
    uint64_t* bar = &bars[j & 1];
    const int t0 = (REV ? nc - 1 - j : j) * C;
    mbar_expect_tx(bar, C * ((OUT ? 3 : 2) * D + E) * 4);
    if (OUT) tma_load(base + L::R, rr, bar, 0, h, t0, b);
    tma_load(base + L::K, kk, bar, 0, h, t0, b);
    tma_load(base + L::W, w, bar, 0, h, t0, b);
    tma_load(base + L::V, vv, bar, e0, h, t0, b);
  };
  // the wait for chunk j (its buffer's (j / 2)-th use), by every thread
  auto await = [&](int j) { mbar_wait(&bars[j & 1], (j >> 1) & 1); };

  // prep: chunk j's inputs -> slot j & 1 (threads 0 .. PT - 1). Values are
  // read into registers before anything is written: the compiler cannot
  // tell the slot from the input buffer, so a load after a store waits.
  auto prep = [&](int j) {
    const float* in = sm + L::BUFS + (j & 1) * L::BUF;
    const float *sr = in + L::R, *sk = in + L::K, *sw = in + L::W;
    // step i of the walk is the buffer's row i, or row C - 1 - i in REV
    auto row = [](int i) { return REV ? C - 1 - i : i; };
    float* sl = sm + L::SLOTS + (j & 1) * L::SLOT;
    // decays: r A (threads 0..63), k B and Pi (threads 64..127)
    if (tid < D) {
      if (OUT) {
        float rv[C], wv[C];
#pragma unroll
        for (int i = 0; i < C; ++i) {
          rv[i] = sr[row(i) * D + tid];
          wv[i] = sw[row(i) * D + tid];
        }
        float a = 1.0f;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          sl[L::RA + i * DPG + tid] = rv[i] * a;
          a *= wv[i];
        }
      }
    } else {
      const int d = tid - D;
      float kv[C], wv[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        kv[i] = sk[row(i) * D + d];
        wv[i] = time_of(j, i) < T ? sw[row(i) * D + d] : 1.0f;
      }
      float bb = 1.0f;
#pragma unroll
      for (int i = C - 1; i >= 0; --i) {
        sl[L::KB + i * DP + d] = kv[i] * bb;
        bb *= wv[i];
      }
      sl[L::PI + d] = bb;
    }
    {
      constexpr int NV = C * (E / 4) / PT;
      float4 vv4[NV];
#pragma unroll
      for (int x = 0; x < NV; ++x) {
        const int idx = tid + x * PT, i = idx / (E / 4);
        vv4[x] = *reinterpret_cast<const float4*>(
            in + L::V + row(i) * E + (idx % (E / 4)) * 4);
      }
#pragma unroll
      for (int x = 0; x < NV; ++x) {
        const int idx = tid + x * PT, i = idx / (E / 4);
        *reinterpret_cast<float4*>(sl + L::VV + i * L::EP +
                                   (idx % (E / 4)) * 4) = vv4[x];
      }
    }
    if (!OUT) return;
    // scores: (j, channel group) a thread, the group's channels 4l .. 4l+3
    // and 32+4l .. 32+4l+3 (float4 reads, one wavefront for eight lanes);
    // P(j, t) a running product from k_j as t grows. Warp w takes
    // j = w, w + 4, w + 8, ... (every warp one small j). The partial sums
    // stay in registers, selects and no branches, so the rows' loads run
    // ahead; they are reduced over the eight lanes of a j at the end,
    // halving the values at each of three shuffle rounds, which leaves lane
    // bits (b2, b1, b0) with t = C/2 b2 + C/4 b1 + C/8 b0 and the next
    // C/8 - 1 steps.
    const int l = tid & 7;
    float uu[8];
    ld8(uu, sm + L::U, l);
    for (int grp = tid >> 3; grp < C; grp += PT / 8) {
      const int jj = (grp & 3) * (C / 4) + (grp >> 2);
      float kp[8], part[C];
      ld8(kp, sk + row(jj) * D, l);
#pragma unroll
      for (int t = 0; t < C; ++t) {
        float rv[8], wv[8];
        ld8(rv, sr + row(t) * D, l);
        ld8(wv, sw + row(t) * D, l);
        const bool diag = t == jj, past = t > jj;
        float x = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          x += rv[c] * (diag ? uu[c] * kp[c] : kp[c]);
          kp[c] = past ? kp[c] * wv[c] : kp[c];
        }
        part[t] = t >= jj ? x : 0.0f;
      }
      fold<C / 2, 4>(part, l);
      fold<C / 4, 2>(part, l);
      fold<C / 8, 1>(part, l);
      const int tl = (C / 2) * ((l >> 2) & 1) + (C / 4) * ((l >> 1) & 1) +
                     (C / 8) * (l & 1);
#pragma unroll
      for (int i = 0; i < C / 8; ++i)
        sl[L::ATT + (tl + i) * L::CP + jj] = part[i];
    }
  };

  // main: y of chunk j and the state after it (warps 4-7; mw its index)
  const int mw = warp - PT / 32, d0 = mw * 16 + g;
  float acc[NT][4];                          // S rows 16 mw .. 16 mw + 15
  const float* s0_row = s0 != nullptr && !prep_warp
                            ? s0 + ((int64_t)bh * D + d0) * D + e0 + 2 * q
                            : nullptr;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 lo = s0_row != nullptr
                          ? *reinterpret_cast<const float2*>(s0_row + n * 8)
                          : make_float2(0.0f, 0.0f);
    const float2 hi = s0_row != nullptr
                          ? *reinterpret_cast<const float2*>(s0_row + 8 * D +
                                                             n * 8)
                          : make_float2(0.0f, 0.0f);
    acc[n][0] = lo.x;
    acc[n][1] = lo.y;
    acc[n][2] = hi.x;
    acc[n][3] = hi.y;
  }
  auto main_step = [&](int j) {
    const float* sl = sm + L::SLOTS + (j & 1) * L::SLOT;
    const float* s_in = sm + L::S + (j & 1) * D * L::EP;
    float* s_out = sm + L::S + ((j + 1) & 1) * D * L::EP;
    // y = (r A) S_c + att V, for each 16-row tile m the NY tiles of
    // columns n = mw, mw + 4, ... (one A fragment), two accumulators each
    // (even and odd steps)
    if (OUT) {
      constexpr int NY = NT / 4;
#pragma unroll
      for (int m = 0; m < C / 16; ++m) {
        float c0[NY][4], c1[NY][4];
#pragma unroll
        for (int n = 0; n < NY; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) c0[n][i] = c1[n][i] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks)
          mma_steps<NY>(ks & 1 ? c1 : c0, sl + L::RA + m * 16 * DPG + ks * 8,
                        DPG, 1, s_in + ks * 8 * L::EP + mw * 8, 32, L::EP, 1,
                        lane);
#pragma unroll
        for (int ks = 0; ks < C / 8; ++ks)
          mma_steps<NY>(ks & 1 ? c1 : c0,
                        sl + L::ATT + m * 16 * L::CP + ks * 8, L::CP, 1,
                        sl + L::VV + ks * 8 * L::EP + mw * 8, 32, L::EP, 1,
                        lane);
#pragma unroll
        for (int n = 0; n < NY; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = time_of(j, m * 16 + g + 8 * half);
            if (t < T)
              *reinterpret_cast<float2*>(out + row_off(b, t, h, T, H) + e0 +
                                         (mw + 4 * n) * 8 + 2 * q) =
                  make_float2(c0[n][2 * half] + c1[n][2 * half],
                              c0[n][2 * half + 1] + c1[n][2 * half + 1]);
          }
      }
    }
    // the state before this chunk, then S = diag(Pi) S + (k B)^T V
    if (STATES) {
      const int c = REV ? nc - 1 - j : j;
      float* st = states + ((int64_t)bh * nc + c) * D * D + e0;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(st + d0 * D + n * 8 + 2 * q) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(st + (d0 + 8) * D + n * 8 + 2 * q) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
    const float p0 = sl[L::PI + d0], p1 = sl[L::PI + d0 + 8];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= p0;
      acc[n][1] *= p0;
      acc[n][2] *= p1;
      acc[n][3] *= p1;
    }
#pragma unroll
    for (int ks = 0; ks < C / 8; ++ks)            // one A fragment a step
      mma_steps<NT>(acc, sl + L::KB + ks * 8 * DP + mw * 16, 1, DP,
                    sl + L::VV + ks * 8 * L::EP, 8, L::EP, 1, lane);
    if (OUT) {                                   // S_{c+1} for y next
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(s_out + d0 * L::EP + n * 8 + 2 * q) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(s_out + (d0 + 8) * L::EP + n * 8 +
                                   2 * q) = make_float2(acc[n][2], acc[n][3]);
      }
    }
  };

  load(0);
  if (nc > 1) load(1);
  await(0);
  if (nc > 1) await(1);
  __syncthreads();
  if (prep_warp) prep(0);
  __syncthreads();
  for (int j = 0; j < nc; ++j) {
    if (kPipe) {
      // buffer j & 1 is free (prep(j) is done): chunk j + 2 goes there
      if (j + 2 < nc) load(j + 2);
      if (prep_warp) {
        if (j + 1 < nc) prep(j + 1);
      } else {
        main_step(j);
      }
    } else {
      // the pipeline undone: main(j), then prep(j + 1), one after another
      if (!prep_warp) main_step(j);
      __syncthreads();
      if (j + 2 < nc) load(j + 2);
      if (prep_warp && j + 1 < nc) prep(j + 1);
    }
    if (j + 2 < nc) await(j + 2);
    __syncthreads();
  }
  // the state after the last step
  if (s_last != nullptr && !prep_warp) {
    float* st = s_last + ((int64_t)bh * D + d0) * D + e0 + 2 * q;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(st + n * 8) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(st + 8 * D + n * 8) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

__global__ void __launch_bounds__(SCAN_THREADS, 2)
wkv6_fwd_chunk_kernel(const __grid_constant__ CUtensorMap r,
                      const __grid_constant__ CUtensorMap k,
                      const __grid_constant__ CUtensorMap v,
                      const __grid_constant__ CUtensorMap w,
                      const float* __restrict__ u, float* __restrict__ y,
                      const float* __restrict__ s0,
                      float* __restrict__ s_last, int T, int H) {
  extern __shared__ __align__(128) float sm[];
  scan<FWD_C, FWD_E, false, true, false>(&r, &k, &v, &w, u, y, nullptr, s0,
                                         s_last, T, H, sm);
}

// z = 0: dv and G_c (the forward run backwards in time with r and k
// swapped and dy for v); z = 1: S_c (the forward without y). The heavier
// half first: CTAs start in the order of their index, and 2 x B*H of them
// may not all fit on the card at once.
__global__ void __launch_bounds__(SCAN_THREADS, 2)
wkv6_bwd_scan_kernel(const __grid_constant__ CUtensorMap r,
                     const __grid_constant__ CUtensorMap k,
                     const __grid_constant__ CUtensorMap v,
                     const __grid_constant__ CUtensorMap w,
                     const __grid_constant__ CUtensorMap dy,
                     const float* __restrict__ u, float* __restrict__ dv,
                     float* __restrict__ ckpt, int T, int H) {
  extern __shared__ __align__(128) float sm[];
  const int nc = (T + BWD_C - 1) / BWD_C;
  const int64_t half = (int64_t)gridDim.y * nc * D * D;
  if (blockIdx.z == 0)
    scan<BWD_C, BWD_E, true, true, true>(&k, &r, &dy, &w, u, dv, ckpt + half,
                                         nullptr, nullptr, T, H, sm);
  else
    scan<BWD_C, BWD_E, false, false, true>(nullptr, &k, &v, &w, u, nullptr,
                                           ckpt, nullptr, nullptr, T, H, sm);
}

// ---------------------------------------------------------------------------
// The backward's chunks: dr, dk, dw and du from S_c and G_c
// ---------------------------------------------------------------------------

template <int C>
struct ChunkSmem {
  static constexpr int CP = C + 4;
  static constexpr int R = 0, K = R + C * DPG, V = K + C * DPG;
  static constexpr int W = V + C * DPG;
  static constexpr int DY = W + C * DPG, S = DY + C * DPG, G = S + D * DPG;
  static constexpr int SD = G + D * DPG, GV = SD + C * DPG;
  static constexpr int VD = GV + C * DPG, VDT = VD + C * CP;
  static constexpr int SG = VDT + C * CP, U = SG + D;
  static constexpr int FLOATS = U + D;
  static constexpr size_t BYTES = (size_t)FLOATS * sizeof(float);
};

__global__ void __launch_bounds__(CHUNK_THREADS)
wkv6_bwd_chunk_kernel(const float* __restrict__ r,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ dy, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dw,
                      float* __restrict__ du_part,
                      const float* __restrict__ ckpt, int T, int H) {
  constexpr int C = BWD_C;
  constexpr int NP = CHUNK_THREADS / D, NS = C / NP;   // parts of a channel
  using L = ChunkSmem<C>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, t0 = c * C;
  const int64_t st = ((int64_t)bh * nc + c) * D * D;
  const int64_t half = (int64_t)gridDim.y * nc * D * D;

  for (int idx = tid; idx < C * (D / 4); idx += CHUNK_THREADS) {
    const int i = idx / (D / 4), c4 = (idx % (D / 4)) * 4;
    const bool ok = t0 + i < T;
    const int64_t off = row_off(b, ok ? t0 + i : 0, h, T, H) + c4;
    cp16(sm + L::R + i * DPG + c4, r + off, ok);
    cp16(sm + L::K + i * DPG + c4, k + off, ok);
    cp16(sm + L::V + i * DPG + c4, v + off, ok);
    cp16(sm + L::W + i * DPG + c4, w + off, ok);
    cp16(sm + L::DY + i * DPG + c4, dy + off, ok);
  }
  for (int idx = tid; idx < D * (D / 4); idx += CHUNK_THREADS) {
    const int d = idx / (D / 4), c4 = (idx % (D / 4)) * 4;
    cp16(sm + L::S + d * DPG + c4, ckpt + st + d * D + c4, true);
    cp16(sm + L::G + d * DPG + c4, ckpt + half + st + d * D + c4, true);
  }
  cp_commit();
  if (tid < D) sm[L::U + tid] = u[h * D + tid];
  cp_wait<0>();
  __syncthreads();

  // K = e throughout: SD[t][d] = dy_t . S_c[d, :] and GV[t][d] = v_t .
  // G_c[d, :] (M = t, N = d); VD[t][j] = dy_t . v_j and VDT[j][t], its
  // transpose (M = t or j, N = j or t)
  {
    constexpr int MT = C / 16, SDT = MT * (D / 8), VDTT = MT * (C / 8);
    for (int tile = warp; tile < 2 * SDT + 2 * VDTT;
         tile += CHUNK_THREADS / 32) {
      float acc[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
      float acc1[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
      const float *a, *bm;
      float* o;
      int ostride, bstride, m, n;
      if (tile < 2 * SDT) {
        const bool gv = tile >= SDT;
        const int x = gv ? tile - SDT : tile;
        m = x / (D / 8);
        n = x % (D / 8);
        a = sm + (gv ? L::V : L::DY);
        bm = sm + (gv ? L::G : L::S);
        o = sm + (gv ? L::GV : L::SD);
        ostride = DPG;
        bstride = DPG;
      } else {
        const bool tr = tile >= 2 * SDT + VDTT;
        const int x = tile - 2 * SDT - (tr ? VDTT : 0);
        m = x / (C / 8);
        n = x % (C / 8);
        a = sm + (tr ? L::V : L::DY);
        bm = sm + (tr ? L::DY : L::V);
        o = sm + (tr ? L::VDT : L::VD);
        ostride = L::CP;
        bstride = DPG;
      }
      // B(k = e, j) = bm[j][e]: the rows of S, G or of the chunk's inputs
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks)
        mma_steps<1>(ks & 1 ? acc1 : acc, a + m * 16 * DPG + ks * 8, DPG, 1,
                     bm + n * 8 * bstride + ks * 8, 0, 1, bstride, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[0][i] += acc1[0][i];
      const int g = lane >> 2, q = lane & 3;
      float* o0 = o + (m * 16 + g) * ostride + n * 8 + 2 * q;
      o0[0] = acc[0][0];
      o0[1] = acc[0][1];
      o0[8 * ostride] = acc[0][2];
      o0[8 * ostride + 1] = acc[0][3];
    }
  }
  // SG[d] = S_c[d, :] . G_c[d, :], one warp per eight rows
  for (int d = warp * 8; d < warp * 8 + 8; ++d) {
    float x = sm[L::S + d * DPG + lane] * sm[L::G + d * DPG + lane] +
              sm[L::S + d * DPG + lane + 32] * sm[L::G + d * DPG + lane + 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) sm[L::SG + d] = x;
  }
  __syncthreads();

  // Channel d, part p a thread (NP neighbouring lanes share d). Part p owns
  // the NS steps s0 .. s0 + NS - 1 as outputs, and those components of the
  // vectors z_t[s] = sum_{j<t} P(j, t) k_j VD[s][j] (forward in t) and
  // y_t[j] = sum_{s>t} P(t, s) r_s VD[s][j] (backward in t), since
  //   sum_j alpha_j VD[t, j] = z_t[t],  sum_s beta_s VD[s, t] = y_t[t],
  //   sum_s beta_s sum_j alpha_j VD[s, j] = sum_{s>t} P(t, s) r_s z_t[s].
  // The forward walk keeps z_t for the backward one; every recurrence only
  // multiplies by w.
  const int d = tid / NP, p = tid % NP, s0 = p * NS;
  const float* sr = sm + L::R;
  const float* sk = sm + L::K;
  const float* sw = sm + L::W;
  const float ud = sm[L::U + d], sg = sm[L::SG + d];
  // no branches in the walks (one block each, so the loads run ahead):
  // the own steps' values are picked with selects, kept in registers and
  // written at the end
  float zz[C][NS];              // z_t[s0 + i], for the backward walk
  float a_own[NS], x_own[NS];   // A_t and sum_j alpha_j GV_j at own steps
  float dr_o[NS], dk_o[NS], dw_o[NS];
  float du_acc = 0.0f;
  {
    float a = 1.0f, x = 0.0f, z[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) z[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float kt = sk[t * DPG + d], wt = sw[t * DPG + d];
      const float rt = sr[t * DPG + d], diag = sm[L::VD + t * L::CP + t];
      const float sdt = sm[L::SD + t * DPG + d];
      const float gvt = sm[L::GV + t * DPG + d];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const bool own = s0 + i == t;
        zz[t][i] = z[i];
        dr_o[i] = own ? a * sdt + z[i] + ud * kt * diag : dr_o[i];
        a_own[i] = own ? a : a_own[i];
        x_own[i] = own ? x : x_own[i];
        du_acc += own ? rt * kt * diag : 0.0f;
      }
      a *= wt;
      x = wt * x + kt * gvt;
#pragma unroll
      for (int i = 0; i < NS; ++i)             // VD[s0 + i][t]
        z[i] = wt * z[i] + kt * sm[L::VDT + t * L::CP + s0 + i];
    }
  }
  {
    float bb = 1.0f, m = 0.0f, y[NS], beta[NS], rs[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      y[i] = 0.0f;
      beta[i] = 0.0f;
      rs[i] = sr[(s0 + i) * DPG + d];
    }
#pragma unroll
    for (int t = C - 1; t >= 0; --t) {
      const float rt = sr[t * DPG + d], wt = sw[t * DPG + d];
      const float diag = sm[L::VD + t * L::CP + t];
      const float sdt = sm[L::SD + t * DPG + d];
      const float gvt = sm[L::GV + t * DPG + d];
      float t3 = 0.0f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        beta[i] = s0 + i == t + 1 ? rs[i] : beta[i];  // P(t, t + 1) = 1
        t3 += beta[i] * zz[t][i];
      }
#pragma unroll
      for (int o = 1; o < NP; o <<= 1)
        t3 += __shfl_xor_sync(0xffffffffu, t3, o);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const bool own = s0 + i == t;
        dk_o[i] = own ? bb * gvt + y[i] + ud * rt * diag : dk_o[i];
        dw_o[i] = own ? a_own[i] * bb * sg + a_own[i] * m + bb * x_own[i] + t3
                      : dw_o[i];
      }
      m = wt * m + rt * sdt;
#pragma unroll
      for (int i = 0; i < NS; ++i) {           // VD[t][s0 + i]
        y[i] = wt * y[i] + rt * sm[L::VD + t * L::CP + s0 + i];
        beta[i] *= wt;
      }
      bb *= wt;
    }
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (t0 + s0 + i < T) {
      const int64_t off = row_off(b, t0 + s0 + i, h, T, H) + d;
      dr[off] = dr_o[i];
      dk[off] = dk_o[i];
      dw[off] = dw_o[i];
    }
  }
#pragma unroll
  for (int o = 1; o < NP; o <<= 1)
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, o);
  if (p == 0) du_part[((int64_t)bh * nc + c) * D + d] = du_acc;
}

bool bad_shape(int B, int T, int H, int d) {
  return B <= 0 || T <= 0 || H <= 0 || d != D;
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

// An fp32 [B, T, H, D] tensor as a 4-D map (d, h, t, b) of boxes of
// `inner` floats by `steps` steps of one head; reads past T fill zeros.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                int B, int T, int H, int inner, int steps) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                 (cuuint64_t)T * H * D * 4};
  const cuuint32_t box[4] = {(cuuint32_t)inner, 1, (cuuint32_t)steps, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

constexpr size_t FWD_SMEM = ScanSmem<FWD_C, FWD_E>::BYTES;
constexpr size_t BWD_SCAN_SMEM = ScanSmem<BWD_C, BWD_E>::BYTES;
constexpr size_t BWD_CHUNK_SMEM = ChunkSmem<BWD_C>::BYTES;

static_assert(D % FWD_E == 0 && FWD_E % 8 == 0 && FWD_C % 16 == 0, "fwd");
static_assert(D % BWD_E == 0 && BWD_E % 8 == 0 && BWD_C % 16 == 0, "bwd");
static_assert(SCAN_THREADS == 4 * D && SCAN_THREADS / 32 == 2 * (D / 16) &&
                  FWD_E % 32 == 0 && BWD_E % 32 == 0,
              "scan");
static_assert(CHUNK_THREADS % D == 0 && CHUNK_THREADS / 32 * 8 == D &&
                  BWD_C % (CHUNK_THREADS / D) == 0,
              "chunk");

}  // namespace

// y [B, T, H, D] from r, k, v, w [B, T, H, D] and u [H, D], all fp32 and
// contiguous, D = 64. s0: the state before the first step, [B, H, D, D]
// (key channel by value channel), or null for zero; s_last: where the
// state after the last step goes, [B, H, D, D], or null. Returns the CUDA
// error of the launch (0 = launched).
extern "C" int wkv6_fwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* y,
                               const void* s0, void* s_last, int B, int T,
                               int H, int d, void* stream) {
  if (bad_shape(B, T, H, d)) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t err = allow_smem(wkv6_fwd_chunk_kernel, FWD_SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mr, mk, mv, mw;
  if (!encode_map(encode, &mr, r, B, T, H, D, FWD_C) ||
      !encode_map(encode, &mk, k, B, T, H, D, FWD_C) ||
      !encode_map(encode, &mv, v, B, T, H, FWD_E, FWD_C) ||
      !encode_map(encode, &mw, w, B, T, H, D, FWD_C))
    return (int)cudaErrorInvalidValue;
  wkv6_fwd_chunk_kernel<<<dim3(D / FWD_E, B * H), SCAN_THREADS, FWD_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      mr, mk, mv, mw, static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<const float*>(s0), static_cast<float*>(s_last), T, H);
  return (int)cudaGetLastError();
}

// The gradients dr, dk, dv, dw [B, T, H, D] and du_part [B, H, nc, D] (du
// per batch row and chunk, nc = wkv6_bwd_chunks(T); du is its sum over B
// and nc) from the forward's inputs and dy [B, T, H, D]. ckpt: scratch of
// wkv6_ckpt_floats(B, T, H) floats (the states S_c and G_c).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* dy,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du_part, void* ckpt, int B, int T, int H,
                               int d, void* stream) {
  if (bad_shape(B, T, H, d)) return (int)cudaErrorInvalidValue;
  static bool scan_set = false, chunk_set = false;
  cudaError_t err = allow_smem(wkv6_bwd_scan_kernel, BWD_SCAN_SMEM, scan_set);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(wkv6_bwd_chunk_kernel, BWD_CHUNK_SMEM, chunk_set);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fr = static_cast<const float*>(r),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fw = static_cast<const float*>(w),
              *fu = static_cast<const float*>(u),
              *fdy = static_cast<const float*>(dy);
  float* fck = static_cast<float*>(ckpt);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the boxes of the v role (v, and dy in the reversed walk) are E wide
  CUtensorMap mr, mk, mv, mw, mdy;
  if (!encode_map(encode, &mr, r, B, T, H, D, BWD_C) ||
      !encode_map(encode, &mk, k, B, T, H, D, BWD_C) ||
      !encode_map(encode, &mv, v, B, T, H, BWD_E, BWD_C) ||
      !encode_map(encode, &mw, w, B, T, H, D, BWD_C) ||
      !encode_map(encode, &mdy, dy, B, T, H, BWD_E, BWD_C))
    return (int)cudaErrorInvalidValue;
  wkv6_bwd_scan_kernel<<<dim3(D / BWD_E, B * H, 2), SCAN_THREADS,
                         BWD_SCAN_SMEM, s>>>(mr, mk, mv, mw, mdy, fu,
                                             static_cast<float*>(dv), fck, T,
                                             H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nc = (T + BWD_C - 1) / BWD_C;
  wkv6_bwd_chunk_kernel<<<dim3(nc, B * H), CHUNK_THREADS, BWD_CHUNK_SMEM,
                          s>>>(fr, fk, fv, fw, fu, fdy,
                               static_cast<float*>(dr),
                               static_cast<float*>(dk),
                               static_cast<float*>(dw),
                               static_cast<float*>(du_part), fck, T, H);
  return (int)cudaGetLastError();
}

// Chunks of the backward: du_part holds one row of D per (b, h, chunk).
extern "C" int wkv6_bwd_chunks(int T) { return (T + BWD_C - 1) / BWD_C; }

// Floats of the backward's scratch: S_c and G_c for every chunk.
extern "C" int64_t wkv6_ckpt_floats(int B, int T, int H) {
  return 2 * (int64_t)B * H * ((T + BWD_C - 1) / BWD_C) * D * D;
}
