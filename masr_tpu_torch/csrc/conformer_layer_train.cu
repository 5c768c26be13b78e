// Conformer encoder layer for TRAINING on Hopper (sm_90a), f32: a forward
// with dropout at the layer's seven sites and a hand-written backward.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/conformer_layer_train.py:674
// (`fused_conformer_layer_train`: `_half1` :508 and `_half2` :584, four
// pallas_calls). The TPU split the layer into two halves with staged
// recompute to fit 16 MB of VMEM; device memory is not that scarce here, so
// the forward SAVES what the backward needs (LayerNorm statistics and
// outputs, FFN pre-activations and hidden rows, q/k/v, the attention
// probabilities before and after dropout, the pw1 output) and the backward
// recomputes nothing but the GLU rows and the dropout masks. About 50
// (B*T', D) f32 arrays plus 2 (h, B, T', T') per layer: 150 MB at B=8,
// T'=299.
//
// Two C entries, one ctypes call each per layer and direction:
//   masr_conformer_layer_train_forward   ~21 launches
//   masr_conformer_layer_train_backward  ~55 launches
// built from common.cuh's kernels and these:
//   gemm_kernel<.., TA, TB, Epi>  common.cuh's GEMM with A or B transposed
//                           (dX = dY.W^T, dW = A^T.dY, the latter split
//                           over K on few tiles), batched over (utterance,
//                           head) for attention, and this file's epilogue
//                           Epi: bias, SiLU (saving the pre-activation),
//                           x dSiLU(aux), dropout, row mask, scaled residual
//   layer_norm_kernel       common.cuh's, saving x-hat and 1/std;
//                           ln_bwd_kernel its backward
//   conv_module_kernel      common.cuh's GLU + depthwise conv + LN + SiLU,
//                           saving the LN's output, x-hat and 1/std
//   colsum_kernel           bias and LayerNorm parameter grads: column sums
//                           over all B*T' rows in a fixed order
//   att_softmax(_bwd)_kernel  masked softmax over the (B, T', T') chunk
//                           mask with attention-probability dropout
//   conv_*_kernel           the conv module's input grad, its depthwise
//                           weight grad and the causal-pad bias grad
// Parameter grads come from one product (split over K in a fixed order on
// few tiles) or one column sum over all B*T' rows: deterministic, no
// atomics.
//
// Dropout: common.cuh's dropout_mult hash of (seed[b], layer, site, b, row,
// col), so the backward regenerates the forward's masks and the plain twin
// (ops/cuda/conformer_layer_train.py) draws the same ones. Sites: 0 macaron
// hidden (t, f), 1 macaron out (t, d), 2 attention probs (h*T'+t1, t2),
// 3 attention out, 4 conv out, 5 FFN hidden, 6 FFN out.
//
// Semantics kept from the Pallas kernel: a (B, T', T') int8 attention mask
// (dynamic chunk + padding), a row with no visible key gives probability 0;
// rows t >= len are zeroed before pw1 and after pw2; causal conv pad rows
// carry GLU(pw1 bias), so their grad goes into pw1's bias.
//
// What bounds it on the H100: ~3x the forward's operations (13.3 GFLOP at
// B=8, T'=299), run on the f32 FMA pipes (67 TFLOP/s), so operations; this
// simple design runs far below that (the GEMMs of the serving kernel, small
// grids, column sums of one block per 32 columns). Left for later:
// tensor-core operands, fused flash-style attention that does not
// materialise (T', T').

#include "common.cuh"

// helpers returning cudaError_t: propagate the first launch error
#define TRY(call)                               \
  do {                                          \
    cudaError_t e_ = (call);                    \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)

namespace {

// ------------------------------------------------------------------------
// The products' epilogue (a functor for common.cuh's gemm_kernel) on
// element (m, n), row m = b T + t:
//   v = alpha acc + bias[n]; pre = v; v = act(v) (SiLU, or v dSiLU(aux));
//   v *= drop(b, t, n); v = 0 where t >= lens[b]; C = R + res_scale v
// R may alias C (in-place residual update).
// ------------------------------------------------------------------------
enum Act { kActNone = 0, kActSilu = 1, kActDsilu = 2 };

__device__ __forceinline__ float dsilu_f(float z) {
  const float s = sigmoid_f(z);
  return s * (1.f + z * (1.f - s));
}

// one dropout site; seeds == nullptr: no dropout
struct Drop {
  const int* seeds;
  int layer, site;
  unsigned thresh;
  float keep_scale;
};

__device__ __forceinline__ float drop_at(const Drop& d, int b, int row,
                                         int col) {
  return d.seeds ? dropout_mult(d.seeds[b], d.layer, d.site, b, row, col,
                                d.thresh, d.keep_scale)
                 : 1.f;
}

struct Epi {
  const float* bias = nullptr;
  float alpha = 1.f;
  const float* R = nullptr;  // may alias C
  float res_scale = 1.f;
  float* pre = nullptr;
  int act = kActNone;
  const float* aux = nullptr;  // kActDsilu: v *= dsilu(aux)
  Drop drop = {nullptr, 0, 0, 0u, 1.f};
  const int* lens = nullptr;
  int T = 1;

  struct Row {
    int b, t;
    bool ok;
  };
  __device__ __forceinline__ Row row(int m) const {
    const int b = m / T, t = m % T;
    return {b, t, lens == nullptr || t < lens[b]};
  }
  __device__ __forceinline__ void operator()(float* C, size_t o,
                                             const Row& r, int n,
                                             float acc) const {
    float v = alpha * acc + (bias ? bias[n] : 0.f);
    if (pre) pre[o] = v;
    if (act == kActSilu) v = silu_f(v);
    if (act == kActDsilu) v *= dsilu_f(aux[o]);
    v *= drop_at(drop, r.b, r.t, n);
    if (!r.ok) v = 0.f;
    C[o] = (R ? R[o] : 0.f) + res_scale * v;
  }
};

enum Site {
  kSiteMacaronHidden = 0,
  kSiteMacaronOut = 1,
  kSiteAttProb = 2,
  kSiteAttOut = 3,
  kSiteConvOut = 4,
  kSiteFfnHidden = 5,
  kSiteFfnOut = 6
};

// C (M, N) = A (M, K) . W (K, N)
cudaError_t mm_nn(const float* A, const float* W, float* C, int M, int N,
                  int K, const Epi& e, cudaStream_t st) {
  return gemm_launch<false, false>(A, W, C, M, N, K, K, N, N, e, st);
}

// C (M, N) = A (M, K) . W^T, W stored (N, K): the input grad dY . W^T of
// a product Y = X . W with W (in = N, out = K)
cudaError_t mm_nt(const float* A, const float* W, float* C, int M, int N,
                  int K, const Epi& e, cudaStream_t st) {
  return gemm_launch<false, true>(A, W, C, M, N, K, K, K, N, e, st);
}

// Weight grads C (M, N) = A^T . B over K = B*T' rows (A stored (K, M), B
// (K, N)). On few output tiles K is split into slices written to `part`
// and summed in slice order: as many blocks as two waves want, still
// deterministic.
int splitk_slices(int M, int N, int K) {
  const int tiles = ((M + 63) / 64) * ((N + 63) / 64);
  const int want = (2 * 132 + tiles - 1) / tiles, most = K / 256;
  return want < most ? (want > 1 ? want : 1) : (most > 1 ? most : 1);
}

__global__ void splitk_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ C, int slices,
                                  size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < slices; ++z) s += part[(size_t)z * n + i];
    C[i] = s;
  }
}

unsigned blocks_for(size_t n, int threads);

cudaError_t mm_tn(const float* A, const float* B, float* C, int M, int N,
                  int K, float* part, cudaStream_t st) {
  const int slices = splitk_slices(M, N, K);
  if (slices == 1)
    return gemm_launch<true, false>(A, B, C, M, N, K, M, N, N, Epi(), st);
  const int kc = ((K + slices - 1) / slices + 7) / 8 * 8;
  const int full = K / kc, rest = K - full * kc;
  Batch ba, bb, bc;
  ba.s1 = (long long)kc * M;
  bb.s1 = (long long)kc * N;
  bc.s1 = (long long)M * N;
  TRY((gemm_launch<true, false>(A, B, part, M, N, kc, M, N, N, Epi(), st,
                                full, ba, bb, bc)));
  if (rest)
    TRY((gemm_launch<true, false>(A + (size_t)full * kc * M,
                                  B + (size_t)full * kc * N,
                                  part + (size_t)full * M * N, M, N, rest, M,
                                  N, N, Epi(), st)));
  const size_t n = (size_t)M * N;
  splitk_sum_kernel<<<blocks_for(n, 256), 256, 0, st>>>(part, C,
                                                        full + (rest > 0), n);
  return cudaGetLastError();
}

unsigned blocks_for(size_t n, int threads) {
  const size_t b = (n + threads - 1) / threads;
  return (unsigned)(b < 8192 ? (b ? b : 1) : 8192);
}

// dx = base + rstd * (g - mean(g) - xhat * mean(g * xhat)), g = dy * gamma;
// rows t >= lens[b] add nothing. dx may alias base.
__global__ void ln_bwd_kernel(const float* __restrict__ dy,
                              const float* __restrict__ xhat,
                              const float* __restrict__ rstd,
                              const float* __restrict__ gamma,
                              const float* base, float* dx, int M, int D,
                              const int* __restrict__ lens, int T) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t o = (size_t)row * D;
  const bool ok = lens == nullptr || (row % T) < lens[row / T];
  float s1 = 0.f, s2 = 0.f;
  if (ok)
    for (int c = lane; c < D; c += 32) {
      const float g = dy[o + c] * gamma[c];
      s1 += g;
      s2 += g * xhat[o + c];
    }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  const float r = rstd[row];
  for (int c = lane; c < D; c += 32) {
    const float v =
        ok ? r * (dy[o + c] * gamma[c] - m1 - xhat[o + c] * m2) : 0.f;
    dx[o + c] = (base ? base[o + c] : 0.f) + v;
  }
}

// ------------------------------------------------------------------------
// Column sums: out[n] = sum over rows m (t = m % T < lens[m / T] when lens
// is set) of X[m, n] * (Y ? Y[m, n] : 1). One block per 32 columns, its
// warps stride the rows; partials are added in warp order, so the sum is
// the same from run to run.
// ------------------------------------------------------------------------
constexpr int kColWarps = 32;

__global__ void __launch_bounds__(kColWarps * 32)
    colsum_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                  float* __restrict__ out, int M, int N,
                  const int* __restrict__ lens, int T) {
  __shared__ float part[kColWarps][33];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (n < N)
    for (int m = warp; m < M; m += kColWarps) {
      if (lens && (m % T) >= lens[m / T]) continue;
      const size_t o = (size_t)m * N + n;
      s += Y ? X[o] * Y[o] : X[o];
    }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && n < N) {
    float t = 0.f;
    for (int w = 0; w < kColWarps; ++w) t += part[w][lane];
    out[n] = t;
  }
}

cudaError_t colsum(const float* X, const float* Y, float* out, int M, int N,
                   const int* lens, int T, cudaStream_t st) {
  colsum_kernel<<<(N + 31) / 32, kColWarps * 32, 0, st>>>(X, Y, out, M, N,
                                                          lens, T);
  return cudaGetLastError();
}

// dx = base + LN backward of dy, and the LN's (gamma, beta) grads into
// dlnw[idx]
cudaError_t ln_bwd(const float* dy, const float* xhat, const float* rstd,
                   const float* lnw, float* dlnw, int idx, const float* base,
                   float* dx, int M, int D, const int* lens, int T,
                   cudaStream_t st) {
  const size_t off = (size_t)idx * 2 * D;
  ln_bwd_kernel<<<(M + 7) / 8, 256, 0, st>>>(dy, xhat, rstd, lnw + off, base,
                                             dx, M, D, lens, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = colsum(dy, xhat, dlnw + off, M, D, lens, T, st);
  if (err != cudaSuccess) return err;
  return colsum(dy, nullptr, dlnw + off + D, M, D, lens, T, st);
}

// ------------------------------------------------------------------------
// Elementwise: y = scale * x * drop(b, t, n), rows t >= lens[b] -> 0;
// out = a + b.
// ------------------------------------------------------------------------
__global__ void scale_drop_kernel(const float* __restrict__ x,
                                  float* __restrict__ y, int M, int N,
                                  float scale, Drop d,
                                  const int* __restrict__ lens, int T) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / N), n = (int)(i % N), b = m / T, t = m % T;
    const bool ok = lens == nullptr || t < lens[b];
    y[i] = ok ? scale * x[i] * drop_at(d, b, t, n) : 0.f;
  }
}

cudaError_t scale_drop(const float* x, float* y, int M, int N, float scale,
                       const Drop& d, const int* lens, int T,
                       cudaStream_t st) {
  scale_drop_kernel<<<blocks_for((size_t)M * N, 256), 256, 0, st>>>(
      x, y, M, N, scale, d, lens, T);
  return cudaGetLastError();
}

__global__ void add_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           float* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = a[i] + b[i];
}

cudaError_t add(const float* a, const float* b, float* out, size_t n,
                cudaStream_t st) {
  add_kernel<<<blocks_for(n, 256), 256, 0, st>>>(a, b, out, n);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// Attention softmax over (h, B, T, T) score rows, one warp per row (h, b,
// t1), keys t2 with mask[b, t1, t2] != 0. P = probabilities (0 where
// masked; a row with no visible key is all 0), Pd = P * drop. S may alias
// P.
// ------------------------------------------------------------------------
__global__ void att_softmax_kernel(const float* S, float* P,
                                   float* __restrict__ Pd,
                                   const unsigned char* __restrict__ mask,
                                   int B, int H, int T, Drop d) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)H * B * T) return;
  const int t1 = (int)(row % T), b = (int)((row / T) % B);
  const int h = (int)(row / ((long long)B * T));
  const float* s = S + row * T;
  const unsigned char* mk = mask + ((size_t)b * T + t1) * T;
  float mx = -INFINITY;
  for (int c = lane; c < T; c += 32)
    if (mk[c]) mx = fmaxf(mx, s[c]);
  mx = warp_max(mx);
  float l = 0.f;
  for (int c = lane; c < T; c += 32)
    if (mk[c]) l += expf(s[c] - mx);
  l = warp_sum(l);
  for (int c = lane; c < T; c += 32) {
    const float p = mk[c] ? expf(s[c] - mx) / l : 0.f;
    P[row * T + c] = p;
    Pd[row * T + c] = p * drop_at(d, b, h * T + t1, c);
  }
}

// dP holds dPd = dO . V^T; becomes dS = P * (dpr - sum(dpr * P)) * scale
// with dpr = dPd * drop
__global__ void att_softmax_bwd_kernel(float* __restrict__ dP,
                                       const float* __restrict__ P, int B,
                                       int H, int T, Drop d, float scale) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)H * B * T) return;
  const int t1 = (int)(row % T), b = (int)((row / T) % B);
  const int h = (int)(row / ((long long)B * T));
  float* g = dP + row * T;
  const float* p = P + row * T;
  float s = 0.f;
  for (int c = lane; c < T; c += 32)
    s += g[c] * drop_at(d, b, h * T + t1, c) * p[c];
  s = warp_sum(s);
  for (int c = lane; c < T; c += 32)
    g[c] = p[c] * (g[c] * drop_at(d, b, h * T + t1, c) - s) * scale;
}

// ------------------------------------------------------------------------
// Conv module backward. The forward (common.cuh's conv_module_kernel) ran
// GLU of pw1's output g (B, T, 2D), then a depthwise conv over time: GLU
// row r of utterance b: r in [0, T) from g; r < 0 is the left pad,
// GLU(pw1 bias) when pad_bias (causal), else 0; r >= T is 0.
// ------------------------------------------------------------------------
__device__ __forceinline__ float glu_row(const float* __restrict__ g,
                                         const float* __restrict__ pw1b,
                                         int b, int r, int c, int T, int D,
                                         int pad_bias) {
  if (r >= 0 && r < T) {
    const float* gr = g + ((size_t)b * T + r) * 2 * D;
    return gr[c] * sigmoid_f(gr[D + c]);
  }
  return (pad_bias && r < 0) ? pw1b[c] * sigmoid_f(pw1b[D + c]) : 0.f;
}

// dg (B, T, 2D) from dc (B, T, D): du(t) = sum_i dc(t + left - i) dww[i]
// over outputs in [0, T), then through the GLU
__global__ void conv_dw_bwd_kernel(const float* __restrict__ dc,
                                   const float* __restrict__ g,
                                   const float* __restrict__ dww,
                                   float* __restrict__ dg, int B, int T,
                                   int D, int ksize, int left) {
  const size_t total = (size_t)B * T * D;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % D), t = (int)((i / D) % T);
    const int b = (int)(i / ((size_t)T * D));
    float du = 0.f;
    for (int j = 0; j < ksize; ++j) {
      const int tp = t + left - j;
      if (tp >= 0 && tp < T)
        du = fmaf(dc[((size_t)b * T + tp) * D + c], dww[j * D + c], du);
    }
    const size_t r = ((size_t)b * T + t) * 2 * D;
    const float ga = g[r + c], s = sigmoid_f(g[r + D + c]);
    dg[r + c] = du * s;
    dg[r + D + c] = du * ga * s * (1.f - s);
  }
}

// ddww[j, c] = sum over (b, t) of dc(b, t, c) * GLU row (t - left + j):
// one block per (32 channels, tap j), its warps stride the rows, partials
// added in warp order
__global__ void __launch_bounds__(kColWarps * 32)
    conv_dww_kernel(const float* __restrict__ dc,
                    const float* __restrict__ g,
                    const float* __restrict__ pw1b, float* __restrict__ ddww,
                    int B, int T, int D, int left, int pad_bias) {
  __shared__ float part[kColWarps][33];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.y, c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < D)
    for (int m = warp; m < B * T; m += kColWarps)
      s = fmaf(dc[(size_t)m * D + c],
               glu_row(g, pw1b, m / T, m % T - left + j, c, T, D, pad_bias),
               s);
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < D) {
    float t = 0.f;
    for (int w = 0; w < kColWarps; ++w) t += part[w][lane];
    ddww[(size_t)j * D + c] = t;
  }
}

// causal pad rows carry GLU(pw1 bias): pad row r in [0, left) (GLU row
// r - left) feeds outputs r - j for j <= r; its grad goes into pw1's bias
__global__ void conv_pad_grad_kernel(const float* __restrict__ dc,
                                     const float* __restrict__ dww,
                                     const float* __restrict__ pw1b,
                                     float* __restrict__ dpw1b, int B, int T,
                                     int D, int left) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  float du0 = 0.f;
  for (int b = 0; b < B; ++b)
    for (int r = 0; r < left; ++r)
      for (int j = 0; j <= r; ++j)
        if (r - j < T)
          du0 = fmaf(dc[((size_t)b * T + r - j) * D + c], dww[j * D + c],
                     du0);
  const float s0 = sigmoid_f(pw1b[D + c]);
  dpw1b[c] += du0 * s0;
  dpw1b[D + c] += du0 * pw1b[c] * s0 * (1.f - s0);
}

// ------------------------------------------------------------------------
// Saved activations, offsets in floats (M = B*T). The forward writes them,
// the backward reads them.
// ------------------------------------------------------------------------
struct Saved {
  size_t xhat[6], rstd[6], y[5], cn, z0, h0, z1, h1, qu, qv, k, v, o, g, P,
      Pd, xw, bias_uv, total;
};

Saved saved_layout(int B, int T, int D, int F, int H) {
  const size_t M = (size_t)B * T, MD = M * D, MF = M * F;
  const size_t PP = (size_t)H * B * T * T;
  Saved s;
  size_t off = 0;
  auto take = [&off](size_t n) {
    const size_t o = off;
    off += n;
    return o;
  };
  for (int i = 0; i < 6; ++i) {
    s.xhat[i] = take(MD);
    s.rstd[i] = take(M);
  }
  for (int i = 0; i < 5; ++i) s.y[i] = take(MD);
  s.cn = take(MD);
  s.z0 = take(MF);
  s.h0 = take(MF);
  s.z1 = take(MF);
  s.h1 = take(MF);
  s.qu = take(MD);
  s.qv = take(MD);
  s.k = take(MD);
  s.v = take(MD);
  s.o = take(MD);
  s.g = take(2 * MD);
  s.P = take(PP);
  s.Pd = take(PP);
  s.xw = take(MD);
  s.bias_uv = take(2 * (size_t)D);
  s.total = off;
  return s;
}

// backward scratch: dxw, t0..t5 (M, D), dh (M, F), dg (M, 2D), dP, and
// the split-K slices of the largest weight grad
struct Scratch {
  size_t dxw, t[6], dh, dg, dP, part, total;
};

Scratch scratch_layout(int B, int T, int D, int F, int H) {
  const size_t M = (size_t)B * T, MD = M * D;
  Scratch s;
  size_t off = 0;
  s.dxw = off;
  off += MD;
  for (int i = 0; i < 6; ++i) {
    s.t[i] = off;
    off += MD;
  }
  s.dh = off;
  off += M * F;
  s.dg = off;
  off += 2 * MD;
  s.dP = off;
  off += (size_t)H * B * T * T;
  s.part = off;
  const int Mr = B * T, shapes[4][2] = {{F, D}, {D, F}, {D, D}, {D, 2 * D}};
  size_t most = 0;
  for (const auto& mn : shapes) {
    const size_t n = (size_t)splitk_slices(mn[0], mn[1], Mr) * mn[0] * mn[1];
    most = n > most ? n : most;
  }
  off += most;
  s.total = off;
  return s;
}

Drop make_drop(const int* seeds, int layer, int site, unsigned thresh,
               float keep_scale) {
  Drop d = {nullptr, layer, site, thresh, keep_scale};
  if (thresh) d.seeds = seeds;
  return d;
}

// FFN forward: xw += scale * drop_out(SiLU-drop_h(a . w1 + b1) . w2 + b2),
// saving the pre-activation z and the dropped hidden rows h
cudaError_t ffn_fwd(float* xw, const float* a, float* z, float* h,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, int M, int D, int F, int T, float scale,
                    const Drop& dh, const Drop& dout, cudaStream_t st) {
  Epi e1;
  e1.bias = b1;
  e1.pre = z;
  e1.act = kActSilu;
  e1.drop = dh;
  e1.T = T;
  cudaError_t err = mm_nn(a, w1, h, M, F, D, e1, st);
  if (err != cudaSuccess) return err;
  Epi e2;
  e2.bias = b2;
  e2.R = xw;
  e2.res_scale = scale;
  e2.drop = dout;
  e2.T = T;
  return mm_nn(h, w2, xw, M, D, F, e2, st);
}

// FFN backward from the residual grad dxw: df = scale * dxw * drop_out,
// the grads of w1, b1, w2, b2, and da = the grad of the FFN's input a
cudaError_t ffn_bwd(const float* dxw, const float* a, const float* z,
                    const float* h, const float* w1, const float* w2,
                    float* dw1, float* db1, float* dw2, float* db2, float* df,
                    float* dz, float* da, float* part, int M, int D, int F,
                    int T, float scale, const Drop& dh, const Drop& dout,
                    cudaStream_t st) {
  TRY(scale_drop(dxw, df, M, D, scale, dout, nullptr, T, st));
  TRY(colsum(df, nullptr, db2, M, D, nullptr, T, st));
  TRY(mm_tn(h, df, dw2, F, D, M, part, st));
  Epi e;
  e.act = kActDsilu;
  e.aux = z;
  e.drop = dh;
  e.T = T;
  TRY(mm_nt(df, w2, dz, M, F, D, e, st));
  TRY(colsum(dz, nullptr, db1, M, F, nullptr, T, st));
  TRY(mm_tn(a, dz, dw1, D, F, M, part, st));
  return mm_nt(dz, w1, da, M, D, F, Epi(), st);
}

}  // namespace

extern "C" size_t masr_conformer_layer_train_saved_floats(int B, int T,
                                                          int D, int F,
                                                          int H) {
  return saved_layout(B, T, D, F, H).total;
}

extern "C" size_t masr_conformer_layer_train_scratch_floats(int B, int T,
                                                            int D, int F,
                                                            int H) {
  return scratch_layout(B, T, D, F, H).total;
}

// Packed weights as ops/cuda/conformer_layer.py pack_layer_params (f32,
// row-major, contiguous): lnw (6,2,D) ffw1 (2,D,F) ffb1 (2,F) ffw2 (2,F,D)
// vecb (8,D) attw (4,D,D) posb (2,D) pw1w (D,2D) pw1b (1,2D) pw2w (D,D)
// dww (k,D). mask (B,T,T) u8, seeds (B,) i32 (this layer's), lens (B,) i32,
// posp (T,D) = linear_pos(pos_emb). thresh / keep_scale: dropout at the
// six non-attention sites, att_*: at the attention probabilities (thresh 0
// = no dropout). saved: masr_conformer_layer_train_saved_floats floats.
extern "C" int masr_conformer_layer_train_forward(
    const float* x, const unsigned char* mask, const int* seeds,
    const int* lens, const float* posp, const float* lnw, const float* ffw1,
    const float* ffb1, const float* ffw2, const float* vecb,
    const float* attw, const float* posb, const float* pw1w,
    const float* pw1b, const float* pw2w, const float* dww, float* out,
    float* saved, int B, int T, int D, int F, int n_head, int ksize,
    int causal, int layer, unsigned thresh, float keep_scale,
    unsigned att_thresh, float att_keep_scale, float ff_scale, float eps,
    void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  const int dk = D / H;
  if (dk * H != D) return (int)cudaErrorInvalidValue;
  const Saved L = saved_layout(B, T, D, F, H);
  const size_t MD = (size_t)M * D, DD = (size_t)D * D, DF = (size_t)D * F;
  float* S = saved;
  float* xw = S + L.xw;
  auto drop = [&](int site) {
    return make_drop(seeds, layer, site, thresh, keep_scale);
  };

  MASR_CHECK(cudaMemcpyAsync(xw, x, MD * sizeof(float),
                             cudaMemcpyDeviceToDevice, st));
  // macaron FFN (x ff_scale)
  MASR_CHECK(layer_norm(xw, S + L.y[0], lnw, 0, M, D, eps, nullptr, T, st,
                        S + L.xhat[0], S + L.rstd[0]));
  MASR_CHECK(ffn_fwd(xw, S + L.y[0], S + L.z0, S + L.h0, ffw1, ffb1, ffw2,
                     vecb, M, D, F, T, ff_scale, drop(kSiteMacaronHidden),
                     drop(kSiteMacaronOut), st));

  // rel-pos MHSA: q+u and q+v as two products with summed biases
  MASR_CHECK(layer_norm(xw, S + L.y[1], lnw, 1, M, D, eps, nullptr, T, st,
                        S + L.xhat[1], S + L.rstd[1]));
  float* bias_u = S + L.bias_uv;
  float* bias_v = bias_u + D;
  MASR_CHECK(add(vecb + 2 * D, posb, bias_u, D, st));
  MASR_CHECK(add(vecb + 2 * D, posb + D, bias_v, D, st));
  const float* a1 = S + L.y[1];
  float *qu = S + L.qu, *qv = S + L.qv, *kk = S + L.k, *vv = S + L.v;
  Epi e;
  e.bias = bias_u;
  MASR_CHECK(mm_nn(a1, attw, qu, M, D, D, e, st));
  e.bias = bias_v;
  MASR_CHECK(mm_nn(a1, attw, qv, M, D, D, e, st));
  e.bias = vecb + 3 * D;
  MASR_CHECK(mm_nn(a1, attw + DD, kk, M, D, D, e, st));
  e.bias = vecb + 4 * D;
  MASR_CHECK(mm_nn(a1, attw + 2 * DD, vv, M, D, D, e, st));
  // scores (h, B, T, T): matrix z = b * H + h
  Batch bq, bs, bpos;
  bq.s1 = (long long)T * D;
  bq.s2 = dk;
  bq.div = H;
  bs.s1 = (long long)T * T;
  bs.s2 = (long long)B * T * T;
  bs.div = H;
  bpos.s1 = 0;
  bpos.s2 = dk;
  bpos.div = H;
  float *P = S + L.P, *Pd = S + L.Pd;
  Epi es;
  es.alpha = 1.f / sqrtf((float)dk);
  MASR_CHECK((gemm_launch<false, true>(qu, kk, P, T, T, dk, D, D, T, es, st,
                                       B * H, bq, bq, bs)));
  es.R = P;
  MASR_CHECK((gemm_launch<false, true>(qv, posp, P, T, T, dk, D, D, T, es,
                                       st, B * H, bq, bpos, bs)));
  const long long rows = (long long)H * B * T;
  att_softmax_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      P, P, Pd, mask, B, H, T,
      make_drop(seeds, layer, kSiteAttProb, att_thresh, att_keep_scale));
  MASR_CHECK(cudaGetLastError());
  float* O = S + L.o;
  MASR_CHECK((gemm_launch<false, false>(Pd, vv, O, T, dk, T, T, D, D, Epi(),
                                        st, B * H, bs, bq, bq)));
  Epi eo;
  eo.bias = vecb + 5 * D;
  eo.R = xw;
  eo.drop = drop(kSiteAttOut);
  eo.T = T;
  MASR_CHECK(mm_nn(O, attw + 3 * DD, xw, M, D, D, eo, st));

  // conv module: LN (rows >= len zeroed) -> pw1 -> GLU + depthwise -> LN ->
  // SiLU -> pw2 (rows >= len zeroed)
  MASR_CHECK(layer_norm(xw, S + L.y[2], lnw, 2, M, D, eps, lens, T, st,
                        S + L.xhat[2], S + L.rstd[2]));
  Epi eg;
  eg.bias = pw1b;
  MASR_CHECK(mm_nn(S + L.y[2], pw1w, S + L.g, M, 2 * D, D, eg, st));
  MASR_CHECK(conv_module(S + L.g, dww, vecb + 6 * D, pw1b, lnw + 3 * 2 * D,
                         S + L.y[3], B, T, T, D, ksize,
                         causal ? ksize - 1 : (ksize - 1) / 2, causal, eps,
                         st, S + L.cn, S + L.xhat[3], S + L.rstd[3]));
  Epi ec;
  ec.bias = vecb + 7 * D;
  ec.R = xw;
  ec.drop = drop(kSiteConvOut);
  ec.lens = lens;
  ec.T = T;
  MASR_CHECK(mm_nn(S + L.y[3], pw2w, xw, M, D, D, ec, st));

  // FFN (x ff_scale), final LN
  MASR_CHECK(layer_norm(xw, S + L.y[4], lnw, 4, M, D, eps, nullptr, T, st,
                        S + L.xhat[4], S + L.rstd[4]));
  MASR_CHECK(ffn_fwd(xw, S + L.y[4], S + L.z1, S + L.h1, ffw1 + DF, ffb1 + F,
                     ffw2 + DF, vecb + D, M, D, F, T, ff_scale,
                     drop(kSiteFfnHidden), drop(kSiteFfnOut), st));
  MASR_CHECK(layer_norm(xw, out, lnw, 5, M, D, eps, nullptr, T, st,
                        S + L.xhat[5], S + L.rstd[5]));
  return (int)cudaGetLastError();
}

// dy (B,T,D) -> dx (B,T,D), dposp (T,D) and the grads of the 11 packed
// arrays (same shapes, every element written). saved: the forward's;
// scratch: masr_conformer_layer_train_scratch_floats floats.
extern "C" int masr_conformer_layer_train_backward(
    const float* dy, const int* seeds, const int* lens, const float* posp,
    const float* lnw, const float* ffw1, const float* ffw2,
    const float* attw, const float* pw1w, const float* pw1b,
    const float* pw2w, const float* dww, const float* saved, float* scratch,
    float* dx, float* dposp, float* dlnw, float* dffw1, float* dffb1,
    float* dffw2, float* dvecb, float* dattw, float* dposb, float* dpw1w,
    float* dpw1b, float* dpw2w, float* ddww, int B, int T, int D, int F,
    int n_head, int ksize, int causal, int layer, unsigned thresh,
    float keep_scale, unsigned att_thresh, float att_keep_scale,
    float ff_scale, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  const int dk = D / H;
  if (dk * H != D) return (int)cudaErrorInvalidValue;
  const Saved L = saved_layout(B, T, D, F, H);
  const Scratch W = scratch_layout(B, T, D, F, H);
  const size_t MD = (size_t)M * D, DD = (size_t)D * D, DF = (size_t)D * F;
  const float* S = saved;
  float* dxw = scratch + W.dxw;
  float* t[6];
  for (int i = 0; i < 6; ++i) t[i] = scratch + W.t[i];
  float *dh = scratch + W.dh, *dg = scratch + W.dg, *dP = scratch + W.dP,
        *part = scratch + W.part;
  auto drop = [&](int site) {
    return make_drop(seeds, layer, site, thresh, keep_scale);
  };

  // final LN, FFN
  MASR_CHECK(ln_bwd(dy, S + L.xhat[5], S + L.rstd[5], lnw, dlnw, 5, nullptr,
                    dxw, M, D, nullptr, T, st));
  MASR_CHECK(ffn_bwd(dxw, S + L.y[4], S + L.z1, S + L.h1, ffw1 + DF,
                     ffw2 + DF, dffw1 + DF, dffb1 + F, dffw2 + DF, dvecb + D,
                     t[0], dh, t[1], part, M, D, F, T, ff_scale,
                     drop(kSiteFfnHidden), drop(kSiteFfnOut), st));
  MASR_CHECK(ln_bwd(t[1], S + L.xhat[4], S + L.rstd[4], lnw, dlnw, 4, dxw,
                    dxw, M, D, nullptr, T, st));

  // conv module
  MASR_CHECK(scale_drop(dxw, t[0], M, D, 1.f, drop(kSiteConvOut), lens, T,
                        st));
  MASR_CHECK(colsum(t[0], nullptr, dvecb + 7 * D, M, D, nullptr, T, st));
  MASR_CHECK(mm_tn(S + L.y[3], t[0], dpw2w, D, D, M, part, st));
  Epi ed;
  ed.act = kActDsilu;
  ed.aux = S + L.cn;
  MASR_CHECK(mm_nt(t[0], pw2w, t[1], M, D, D, ed, st));
  MASR_CHECK(ln_bwd(t[1], S + L.xhat[3], S + L.rstd[3], lnw, dlnw, 3,
                    nullptr, t[2], M, D, nullptr, T, st));
  MASR_CHECK(colsum(t[2], nullptr, dvecb + 6 * D, M, D, nullptr, T, st));
  const int left = causal ? ksize - 1 : (ksize - 1) / 2;
  conv_dww_kernel<<<dim3((D + 31) / 32, ksize), kColWarps * 32, 0, st>>>(
      t[2], S + L.g, pw1b, ddww, B, T, D, left, causal);
  MASR_CHECK(cudaGetLastError());
  conv_dw_bwd_kernel<<<blocks_for(MD, 256), 256, 0, st>>>(
      t[2], S + L.g, dww, dg, B, T, D, ksize, left);
  MASR_CHECK(cudaGetLastError());
  MASR_CHECK(colsum(dg, nullptr, dpw1b, M, 2 * D, nullptr, T, st));
  if (causal && left > 0) {
    conv_pad_grad_kernel<<<(D + 127) / 128, 128, 0, st>>>(
        t[2], dww, pw1b, dpw1b, B, T, D, left);
    MASR_CHECK(cudaGetLastError());
  }
  MASR_CHECK(mm_tn(S + L.y[2], dg, dpw1w, D, 2 * D, M, part, st));
  MASR_CHECK(mm_nt(dg, pw1w, t[3], M, D, 2 * D, Epi(), st));
  MASR_CHECK(ln_bwd(t[3], S + L.xhat[2], S + L.rstd[2], lnw, dlnw, 2, dxw,
                    dxw, M, D, lens, T, st));

  // attention
  Batch bq, bs, bpos;
  bq.s1 = (long long)T * D;
  bq.s2 = dk;
  bq.div = H;
  bs.s1 = (long long)T * T;
  bs.s2 = (long long)B * T * T;
  bs.div = H;
  bpos.s1 = 0;
  bpos.s2 = dk;
  bpos.div = H;
  const float *qu = S + L.qu, *qv = S + L.qv, *kk = S + L.k, *vv = S + L.v;
  float *datt = t[0], *dO = t[1], *dv = t[2], *tk = t[3], *tp = t[4],
        *dq = t[5];
  MASR_CHECK(scale_drop(dxw, datt, M, D, 1.f, drop(kSiteAttOut), nullptr, T,
                        st));
  MASR_CHECK(colsum(datt, nullptr, dvecb + 5 * D, M, D, nullptr, T, st));
  MASR_CHECK(mm_tn(S + L.o, datt, dattw + 3 * DD, D, D, M, part, st));
  MASR_CHECK(mm_nt(datt, attw + 3 * DD, dO, M, D, D, Epi(), st));
  MASR_CHECK((gemm_launch<false, true>(dO, vv, dP, T, T, dk, D, D, T, Epi(),
                                       st, B * H, bq, bq, bs)));
  MASR_CHECK((gemm_launch<true, false>(S + L.Pd, dO, dv, T, dk, T, T, D, D,
                                       Epi(), st, B * H, bs, bq, bq)));
  const long long rows = (long long)H * B * T;
  att_softmax_bwd_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      dP, S + L.P, B, H, T,
      make_drop(seeds, layer, kSiteAttProb, att_thresh, att_keep_scale),
      1.f / sqrtf((float)dk));
  MASR_CHECK(cudaGetLastError());
  MASR_CHECK((gemm_launch<false, false>(dP, kk, tk, T, dk, T, T, D, D, Epi(),
                                        st, B * H, bs, bq, bq)));
  MASR_CHECK((gemm_launch<false, false>(dP, posp, tp, T, dk, T, T, D, D,
                                        Epi(), st, B * H, bs, bpos, bq)));
  MASR_CHECK(add(tk, tp, dq, MD, st));
  MASR_CHECK(colsum(tk, nullptr, dposb, M, D, nullptr, T, st));
  MASR_CHECK(colsum(tp, nullptr, dposb + D, M, D, nullptr, T, st));
  float* dkk = t[0];  // datt is spent
  MASR_CHECK((gemm_launch<true, false>(dP, qu, dkk, T, dk, T, T, D, D, Epi(),
                                       st, B * H, bs, bq, bq)));
  // dposp[:, head h] = sum over b of dS[h, b]^T . (q+v)[b, :, head h]: one
  // product per head with K = B*T (dS is laid out (h, B, T, T))
  Batch bh_s, bh_q;
  bh_s.s1 = (long long)B * T * T;
  bh_q.s1 = dk;
  MASR_CHECK((gemm_launch<true, false>(dP, qv, dposp, T, dk, B * T, T, D, D,
                                       Epi(), st, H, bh_s, bh_q, bh_q)));
  MASR_CHECK(colsum(dq, nullptr, dvecb + 2 * D, M, D, nullptr, T, st));
  MASR_CHECK(colsum(dkk, nullptr, dvecb + 3 * D, M, D, nullptr, T, st));
  MASR_CHECK(colsum(dv, nullptr, dvecb + 4 * D, M, D, nullptr, T, st));
  const float* a1 = S + L.y[1];
  MASR_CHECK(mm_tn(a1, dq, dattw, D, D, M, part, st));
  MASR_CHECK(mm_tn(a1, dkk, dattw + DD, D, D, M, part, st));
  MASR_CHECK(mm_tn(a1, dv, dattw + 2 * DD, D, D, M, part, st));
  float* da1 = dO;  // dO is spent
  MASR_CHECK(mm_nt(dq, attw, da1, M, D, D, Epi(), st));
  Epi acc;
  acc.R = da1;
  MASR_CHECK(mm_nt(dkk, attw + DD, da1, M, D, D, acc, st));
  MASR_CHECK(mm_nt(dv, attw + 2 * DD, da1, M, D, D, acc, st));
  MASR_CHECK(ln_bwd(da1, S + L.xhat[1], S + L.rstd[1], lnw, dlnw, 1, dxw,
                    dxw, M, D, nullptr, T, st));

  // macaron FFN, its LN into dx
  MASR_CHECK(ffn_bwd(dxw, S + L.y[0], S + L.z0, S + L.h0, ffw1, ffw2, dffw1,
                     dffb1, dffw2, dvecb, t[0], dh, t[1], part, M, D, F,
                     T, ff_scale, drop(kSiteMacaronHidden),
                     drop(kSiteMacaronOut), st));
  MASR_CHECK(ln_bwd(t[1], S + L.xhat[0], S + L.rstd[0], lnw, dlnw, 0, dxw,
                    dx, M, D, nullptr, T, st));
  return (int)cudaGetLastError();
}
