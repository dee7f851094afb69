// Kimi Delta Attention's token mixer over packed prompts, from its projections to its
// gated output (ops/kda.py has the algorithm and its plain PyTorch version).
//
// One block of 512 threads a (prompt, head) walks the prompt's chunks of 64 tokens in
// order, its state S f32[128][128] in shared memory for the whole prompt (zero at the
// prompt's first token). A chunk:
//   (a) reads the projections of q, k, v (and of the three earlier tokens of the same
//       prompt) and applies the causal width-4 convolution and SiLU, normalizes q and k
//       (eps 1e-6, the 16 lanes of a token summing by shuffles), makes the log-decay
//       g = -exp(A_log) softplus(f + dt_bias) and beta = sigmoid(b); stores k, q
//       (transposed, [d][t]), g and v; rows past the prompt's end are zero (g 0, so the
//       decay stops at the last token);
//   (b) sums g along the chunk (G, one channel a thread);
//   (c) A = beta_t k_t.k_i exp(G_t - G_i) (i < t) and P = q_t.k_i exp(G_t - G_i) (i <= t)
//       over 4x4 tiles of the 16x16 blocks on and below the diagonal: a block below the
//       diagonal splits the decay at its rows' first token r, exp(G_t - G_r) exp(G_r - G_i),
//       both factors <= 1; a block on it takes the pairwise exp(G_t - G_i), i <= t;
//   (d) scales k and q in place: K~ = k exp(G), Q~ = q exp(G), K^ = k exp(G_n - G);
//   (e) W = beta (V - K~ S) and Q~ S (kept in registers);
//   (f) solves (I + A) U = W forward, four lanes a column;
//   (g) O = scale (Q~ S + P U), then per token the head's RMSNorm (a warp holds a row's
//       128 channels) times the norm's weight and sigmoid(gate), written out;
//   (h) S <- exp(G_n) S + K^T U.
// Every product is f32 outside the tensor cores. Built for sm_90a like the other
// sources; a plain C interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr int kD = 128;        // head width
constexpr int kC = 64;         // tokens a chunk
constexpr int kThreads = 512;
constexpr int kTS = kC + 1;    // row stride of the [d][t] tiles
constexpr int kSmemFloats = kD * kD + 3 * kD * kTS + kC * kD + 2 * kC * kC + kC + kD;
constexpr int kSmemBytes = kSmemFloats * 4;  // 231,680 of the 232,448 a block may have
constexpr int kTiles = 136;    // (c)'s 4x4 tiles: 96 below the diagonal blocks, 40 on them

static_assert(kThreads == 512 && kC == 64 && kD == 128, "the thread tiles below assume these");

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w; x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
  const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  x[0] = f0.x; x[1] = f0.y; x[2] = f1.x; x[3] = f1.y;
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + __expf(-x)); }
__device__ __forceinline__ float softplus(float x) { return x > 20.f ? x : log1pf(__expf(x)); }

// the causal width-4 convolution of 8 channels of token t (packed row `at`) and SiLU:
// sum over taps m of w[c][m] x[at - 3 + m], rows before the prompt's first (`lo`) zero
template <typename T>
__device__ __forceinline__ void conv_silu8(const T* __restrict__ x, const T* __restrict__ w, long long at,
                                          int lo, long long width, int c, float* y) {
  float taps[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) load4(w + static_cast<long long>(c + i) * 4, taps[i]);
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const long long src = at - 3 + m;
    if (src < lo) continue;
    float xv[8];
    load8(x + src * width + c, xv);
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = fmaf(taps[i][m], xv[i], y[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = y[i] * sigmoid(y[i]);
}

// q or k: each row scaled to unit L2 norm (eps 1e-6) over the 16 lanes of its token
__device__ __forceinline__ void l2norm8(float* y) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) ss = fmaf(y[i], y[i], ss);
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss + 1e-6f);
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] *= inv;
}

__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x[0], x[1]), __floats2bfloat162_rn(x[2], x[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// the 16x16 blocks below the diagonal, as (row block, column block)
__constant__ int kBelowT[6] = {1, 2, 2, 3, 3, 3};
__constant__ int kBelowI[6] = {0, 0, 1, 0, 1, 2};

// qp, kp, vp, fp, gate, out: [T, heads * 128]; bp: [T, heads]; wq, wk, wv: [heads * 128, 4];
// norm_w: [128]; a_log: f32 [heads]; dt_bias: f32 [heads * 128]; cu: the prompts' bounds
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) kda_layer_kernel(
    const T* __restrict__ qp, const T* __restrict__ kp, const T* __restrict__ vp,
    const T* __restrict__ wq, const T* __restrict__ wk, const T* __restrict__ wv,
    const T* __restrict__ fp, const float* __restrict__ a_log, const float* __restrict__ dt_bias,
    const T* __restrict__ bp, const T* __restrict__ gate, const T* __restrict__ norm_w,
    const int* __restrict__ cu, T* __restrict__ out, int heads, float scale, float eps) {
  extern __shared__ float smem[];
  float* S = smem;                // [kD][kD]: S[dk][dv]
  float* Kt = S + kD * kD;        // [kD][kTS]: k, then K^
  float* Qt = Kt + kD * kTS;      // [kD][kTS]: q, then Q~
  float* Gt = Qt + kD * kTS;      // [kD][kTS]: g, then G, then K~
  float* W = Gt + kD * kTS;       // [kC][kD]: v, then the right side, then U
  float* A = W + kC * kD;         // [kC][kC]
  float* P = A + kC * kC;         // [kC][kC]
  float* bet = P + kC * kC;       // [kC]
  float* gn = bet + kC;           // [kD]: G at the chunk's last row

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lo = cu[b], hi = cu[b + 1];
  const long long row = static_cast<long long>(heads) * kD;  // elements a token
  const float a_h = -__expf(a_log[h]);
  for (int e = tid; e < kD * kD; e += kThreads) S[e] = 0.f;

  // thread tiles of (e) and (g): 4 rows t x 4 columns j; of (h): 8 rows d x 4 columns j.
  // A warp shares its rows, so their loads are broadcasts.
  const int wy = tid / 32, jx = 4 * (tid % 32);
  const int t0 = 4 * wy, d0 = 8 * wy;

  for (int c0 = lo; c0 < hi; c0 += kC) {
    const int n = min(kC, hi - c0);
    __syncthreads();  // the last chunk's readers are done and S is whole
    // (a): 8 channels of one token a thread and pass
#pragma unroll
    for (int pass = 0; pass < kC * kD / 8 / kThreads; ++pass) {
      const int e = pass * kThreads + tid;
      const int t = e / (kD / 8), dd = 8 * (e % (kD / 8));
      float kv[8] = {}, qv[8] = {}, gv[8] = {}, vv[8] = {};
      const int c = h * kD + dd;
      if (t < n) {
        const long long at = c0 + t;
        conv_silu8(qp, wq, at, lo, row, c, qv);
        conv_silu8(kp, wk, at, lo, row, c, kv);
        conv_silu8(vp, wv, at, lo, row, c, vv);
        float fv[8], db[8];
        load8(fp + at * row + c, fv);
        load8(dt_bias + c, db);
#pragma unroll
        for (int x = 0; x < 8; ++x) gv[x] = a_h * softplus(fv[x] + db[x]);
      }
      l2norm8(qv);  // every lane of the warp takes part; a row past the end stays zero
      l2norm8(kv);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        Kt[(dd + x) * kTS + t] = kv[x];
        Qt[(dd + x) * kTS + t] = qv[x];
        Gt[(dd + x) * kTS + t] = gv[x];
        W[t * kD + dd + x] = vv[x];
      }
    }
    if (tid < kC) bet[tid] = tid < n ? sigmoid(to_f(bp[static_cast<long long>(c0 + tid) * heads + h])) : 0.f;
    __syncthreads();
    // (b)
    if (tid < kD) {
      float* gr = Gt + tid * kTS;
      float acc = 0.f;
      for (int t = 0; t < kC; ++t) {
        acc += gr[t];
        gr[t] = acc;
      }
      gn[tid] = acc;
    }
    __syncthreads();
    // (c): a tile a pair of lanes, each over half the channels, summed by a shuffle
    if (tid < 32 * ((2 * kTiles + 31) / 32)) {
      const int item = tid >> 1, half = tid & 1;
      const bool live = item < kTiles;
      int bt = 0, bi = 0, tt = 0, ti = 0;
      const bool below = item < 96;
      if (below) {
        bt = kBelowT[item / 16];
        bi = kBelowI[item / 16];
        tt = (item % 16) / 4;
        ti = item % 4;
      } else if (live) {
        const int m0 = item - 96;
        bt = bi = m0 / 10;
        int m = m0 % 10;
        while (m > tt) {
          m -= tt + 1;
          ++tt;
        }
        ti = m;
      }
      const int ta = 16 * bt + 4 * tt, ia = 16 * bi + 4 * ti, r = 16 * bt;
      float a_acc[4][4] = {}, p_acc[4][4] = {};
      if (live) {
        for (int d = half * (kD / 2); d < (half + 1) * (kD / 2); ++d) {
          const float* kr = Kt + d * kTS;
          const float* qr = Qt + d * kTS;
          const float* gr = Gt + d * kTS;
          float kt[4], qt[4], gt[4], ki[4], gi[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            kt[x] = kr[ta + x];
            qt[x] = qr[ta + x];
            gt[x] = gr[ta + x];
            ki[x] = kr[ia + x];
            gi[x] = gr[ia + x];
          }
          if (below) {
            const float g_r = gr[r];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const float et = __expf(gt[x] - g_r);
              kt[x] *= et;
              qt[x] *= et;
              ki[x] *= __expf(g_r - gi[x]);
            }
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int y = 0; y < 4; ++y) {
                a_acc[x][y] = fmaf(kt[x], ki[y], a_acc[x][y]);
                p_acc[x][y] = fmaf(qt[x], ki[y], p_acc[x][y]);
              }
          } else {
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int y = 0; y < 4; ++y) {
                if (ia + y <= ta + x) {
                  const float e = __expf(gt[x] - gi[y]) * ki[y];
                  a_acc[x][y] = fmaf(kt[x], e, a_acc[x][y]);
                  p_acc[x][y] = fmaf(qt[x], e, p_acc[x][y]);
                }
              }
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          a_acc[x][y] += __shfl_xor_sync(0xffffffffu, a_acc[x][y], 1);
          p_acc[x][y] += __shfl_xor_sync(0xffffffffu, p_acc[x][y], 1);
        }
      if (live && half == 0) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const int t = ta + x, i = ia + y;
            A[t * kC + i] = i < t ? bet[t] * a_acc[x][y] : 0.f;
            P[t * kC + i] = i <= t ? p_acc[x][y] : 0.f;
          }
      }
    }
    __syncthreads();
    // (d)
    for (int e = tid; e < kD * kC; e += kThreads) {
      const int d = e / kC, t = e % kC;
      const int at = d * kTS + t;
      const float gg = Gt[at], kv = Kt[at];
      const float eg = __expf(gg);
      Qt[at] *= eg;
      Gt[at] = kv * eg;
      Kt[at] = kv * __expf(gn[d] - gg);
    }
    __syncthreads();
    // (e)
    float acc_o[4][4] = {};
    {
      float acc_w[4][4] = {};
      for (int d = 0; d < kD; ++d) {
        float kk[4], qq[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          kk[x] = Gt[d * kTS + t0 + x];
          qq[x] = Qt[d * kTS + t0 + x];
        }
        const float4 s4 = *reinterpret_cast<const float4*>(S + d * kD + jx);
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            acc_w[x][y] = fmaf(kk[x], s[y], acc_w[x][y]);
            acc_o[x][y] = fmaf(qq[x], s[y], acc_o[x][y]);
          }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float* wp = W + (t0 + x) * kD + jx;
        const float4 w4 = *reinterpret_cast<const float4*>(wp);
        const float bt = bet[t0 + x];
        *reinterpret_cast<float4*>(wp) = make_float4(bt * (w4.x - acc_w[x][0]), bt * (w4.y - acc_w[x][1]),
                                                     bt * (w4.z - acc_w[x][2]), bt * (w4.w - acc_w[x][3]));
      }
    }
    __syncthreads();
    // (f): U row by row; the four lanes 4j..4j+3 share column j, each a quarter of the i
    {
      const int j = tid >> 2, quarter = tid & 3;
      for (int t = 1; t < n; ++t) {
        float s = 0.f;
        for (int i = quarter; i < t; i += 4) s = fmaf(A[t * kC + i], W[i * kD + j], s);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (quarter == 0) W[t * kD + j] -= s;
        __syncwarp();
      }
    }
    __syncthreads();
    // (g)
    {
      const int i_end = min(t0 + 4, n);
      for (int i = 0; i < i_end; ++i) {
        const float4 u4 = *reinterpret_cast<const float4*>(W + i * kD + jx);
        const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float p = P[(t0 + x) * kC + i];
#pragma unroll
          for (int y = 0; y < 4; ++y) acc_o[x][y] = fmaf(p, u[y], acc_o[x][y]);
        }
      }
      float nw[4];
      load4(norm_w + jx, nw);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float o[4], ss = 0.f;
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          o[y] = scale * acc_o[x][y];
          ss = fmaf(o[y], o[y], ss);
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        if (t0 + x >= n) continue;
        const float inv = rsqrtf(ss / kD + eps);
        const long long at = static_cast<long long>(c0 + t0 + x) * row + static_cast<long long>(h) * kD + jx;
        float gt[4];
        load4(gate + at, gt);
#pragma unroll
        for (int y = 0; y < 4; ++y) o[y] = o[y] * inv * nw[y] * sigmoid(gt[y]);
        store4(out + at, o);
      }
    }
    // (h): reads K^ and U, writes this thread's own 8x4 of S
    {
      float acc[8][4] = {};
      for (int t = 0; t < n; ++t) {
        const float4 u4 = *reinterpret_cast<const float4*>(W + t * kD + jx);
        const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const float kh = Kt[(d0 + x) * kTS + t];
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(kh, u[y], acc[x][y]);
        }
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const float decay = __expf(gn[d0 + x]);
        float* sp = S + (d0 + x) * kD + jx;
        const float4 s4 = *reinterpret_cast<const float4*>(sp);
        *reinterpret_cast<float4*>(sp) = make_float4(fmaf(decay, s4.x, acc[x][0]), fmaf(decay, s4.y, acc[x][1]),
                                                     fmaf(decay, s4.z, acc[x][2]), fmaf(decay, s4.w, acc[x][3]));
      }
    }
  }
}

template <typename T>
int launch(const void* qp, const void* kp, const void* vp, const void* wq, const void* wk, const void* wv,
           const void* fp, const void* a_log, const void* dt_bias, const void* bp, const void* gate,
           const void* norm_w, const void* cu, void* out, int b, int heads, float scale, float eps,
           void* stream) {
  static bool ready[per_device::kMaxDevices] = {};
  int dev = 0;
  if (const cudaError_t e = per_device::current(&dev); e != cudaSuccess) return static_cast<int>(e);
  if (!ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kda_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  if (b <= 0 || heads <= 0) return 0;
  kda_layer_kernel<T><<<dim3(b, heads), kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qp), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const T*>(wq), static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<const T*>(fp), static_cast<const float*>(a_log), static_cast<const float*>(dt_bias),
      static_cast<const T*>(bp), static_cast<const T*>(gate), static_cast<const T*>(norm_w),
      static_cast<const int*>(cu), static_cast<T*>(out), heads, scale, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the projections qp, kp, vp, fp, gate and out [T, heads * 128] of the entry's type, bp
// [T, heads]; the convolutions wq, wk, wv [heads * 128, 4] and norm_w [128] of the
// entry's type; a_log f32 [heads], dt_bias f32 [heads * 128]; cu i32 [b + 1], the
// prompts' bounds in the packed order.
int kda_layer_bf16(const void* qp, const void* kp, const void* vp, const void* wq, const void* wk,
                   const void* wv, const void* fp, const void* a_log, const void* dt_bias, const void* bp,
                   const void* gate, const void* norm_w, const void* cu, void* out, int b, int heads,
                   float scale, float eps, void* stream) {
  return launch<__nv_bfloat16>(qp, kp, vp, wq, wk, wv, fp, a_log, dt_bias, bp, gate, norm_w, cu, out, b,
                               heads, scale, eps, stream);
}

int kda_layer_f32(const void* qp, const void* kp, const void* vp, const void* wq, const void* wk,
                  const void* wv, const void* fp, const void* a_log, const void* dt_bias, const void* bp,
                  const void* gate, const void* norm_w, const void* cu, void* out, int b, int heads,
                  float scale, float eps, void* stream) {
  return launch<float>(qp, kp, vp, wq, wk, wv, fp, a_log, dt_bias, bp, gate, norm_w, cu, out, b, heads,
                       scale, eps, stream);
}

}  // extern "C"
