// Training blocks shared by the layer kernels' forwards and hand-written
// backwards (conformer_layer_train.cu, squeezeformer_layer_train.cu), for
// Hopper (sm_90a), on top of common.cuh. The product blocks are templates
// on the products' operand type OT: float (the f32 layers, 3xTF32) or
// bf16_t (the bf16 mode of masr_tpu's compute dtype bf16: every product's
// operands rounded to bf16 where gemm_tc_kernel reads its fragments, f32
// sums). Arrays stay f32 in memory either way (bf16 weights are widened
// once per call by the layer's C entry), and the elementwise work, the
// epilogue Epi, LayerNorm, the softmax and the column sums stay f32:
//
//   Epi, Drop              the products' epilogue functor for common.cuh's
//                          gemm_tc_kernel on element (m, n): bias, SiLU
//                          (saving the pre-activation), x dSiLU(aux),
//                          dropout, row mask, scaled residual
//   mm_nn, mm_nt, mm_tn    C = A.W, C = A.W^T (input grads), C = A^T.B
//                          (weight grads, split over K on few output tiles
//                          and summed in slice order: splitk_sum_kernel)
// Every product here (mm_*, and att_fwd / att_bwd's batched score
// products) runs common.cuh's tensor-core loop gemm_tc_kernel (3xTF32
// mma.sync, f32 accuracy), for both training layers (rows 3 and 7 of
// PERF.md's kernel table); the serving kernels' products run serving.cuh's
// gemm_sk_kernel, the same 3xTF32 pieces with pre-split weights.
//   colsum                 bias and LayerNorm parameter grads: column sums
//                          over the rows, in a fixed order
//   ln_bwd                 LayerNorm backward from the saved x-hat and
//                          1/std: input grad and (gamma, beta) grads
//   scale_drop, add        elementwise
//   ffn_fwd, ffn_bwd       one FFN, w_1 -> SiLU -> w_2, with dropout at its
//                          hidden rows and its output
//   att_fwd, att_bwd       rel-pos MHSA over a (B, T', T') int8 mask, with
//                          dropout at the probabilities
//                          (att_softmax(_bwd)_kernel) and at the output
//   Wide, Dims             the bf16 mode's f32 copies of the bf16 weights
//                          and posp (a layout), a layer's dims and rates
//   conv_fwd, conv_bwd     the conv module from its pw1 input: pw1,
//                          common.cuh's GLU + depthwise + LN + SiLU, pw2
//                          with the row mask and dropout; backward through
//                          the depthwise conv (conv_dw_bwd_kernel,
//                          conv_dww_kernel) and the causal pad rows, which
//                          carry GLU(pw1 bias) (conv_pad_grad_kernel)
// Parameter grads come from one product (split over K in a fixed order on
// few tiles) or one column sum over all B*T' rows: deterministic, no
// atomics. Every launcher returns cudaGetLastError() (0 on success); TRY
// returns the first error.
#pragma once

#include "common.cuh"

// helpers returning cudaError_t: propagate the first launch error
#define TRY(call)                               \
  do {                                          \
    cudaError_t e_ = (call);                    \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)

namespace {

// ------------------------------------------------------------------------
// The products' epilogue (a functor for common.cuh's gemm_tc_kernel) on
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

Drop make_drop(const int* seeds, int layer, int site, unsigned thresh,
               float keep_scale) {
  Drop d = {nullptr, layer, site, thresh, keep_scale};
  if (thresh) d.seeds = seeds;
  return d;
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

  // per output row: its utterance b, time t, whether t < lens[b], and its
  // dropout row hash (the column's is taken per element)
  struct Row {
    int b, t;
    bool ok;
    unsigned hash;
  };
  __device__ __forceinline__ Row row(int m) const {
    const int b = m / T, t = m % T;
    return {b, t, lens == nullptr || t < lens[b],
            drop.seeds ? dropout_row_hash(drop.seeds[b], drop.layer,
                                          drop.site, b, t)
                       : 0u};
  }
  __device__ __forceinline__ void operator()(float* C, size_t o,
                                             const Row& r, int n,
                                             float acc) const {
    float v = alpha * acc + (bias ? bias[n] : 0.f);
    if (pre) pre[o] = v;
    if (act == kActSilu) {
      v = silu_f(v);
    } else if (act == kActDsilu) {
      v *= dsilu_f(aux[o]);
    }
    if (drop.seeds) v *= dropout_col(r.hash, n, drop.thresh, drop.keep_scale);
    if (!r.ok) v = 0.f;
    C[o] = (R ? R[o] : 0.f) + res_scale * v;
  }
};

// C (M, N) = A (M, K) . W (K, N)
template <class OT>
cudaError_t mm_nn(const float* A, const float* W, float* C, int M, int N,
                  int K, const Epi& e, cudaStream_t st) {
  return gemm_tc_launch<false, false, OT>(A, W, C, M, N, K, K, N, N, e, st);
}

// C (M, N) = A (M, K) . W^T, W stored (N, K): the input grad dY . W^T of
// a product Y = X . W with W (in = N, out = K)
template <class OT>
cudaError_t mm_nt(const float* A, const float* W, float* C, int M, int N,
                  int K, const Epi& e, cudaStream_t st) {
  return gemm_tc_launch<false, true, OT>(A, W, C, M, N, K, K, K, N, e, st);
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

// floats of `part` for the weight grads of a layer with M = B*T' rows:
// the largest of its (F, D), (D, F), (D, D), (D, 2D) products
size_t splitk_part_floats(int M, int D, int F) {
  const int shapes[4][2] = {{F, D}, {D, F}, {D, D}, {D, 2 * D}};
  size_t most = 0;
  for (const auto& mn : shapes) {
    const size_t n = (size_t)splitk_slices(mn[0], mn[1], M) * mn[0] * mn[1];
    most = n > most ? n : most;
  }
  return most;
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

unsigned blocks_for(size_t n, int threads) {
  const size_t b = (n + threads - 1) / threads;
  return (unsigned)(b < 8192 ? (b ? b : 1) : 8192);
}

template <class OT>
cudaError_t mm_tn(const float* A, const float* B, float* C, int M, int N,
                  int K, float* part, cudaStream_t st) {
  const int slices = splitk_slices(M, N, K);
  if (slices == 1)
    return gemm_tc_launch<true, false, OT>(A, B, C, M, N, K, M, N, N, Epi(),
                                           st);
  const int kc = ((K + slices - 1) / slices + 7) / 8 * 8;
  const int full = K / kc, rest = K - full * kc;
  Batch ba, bb, bc;
  ba.s1 = (long long)kc * M;
  bb.s1 = (long long)kc * N;
  bc.s1 = (long long)M * N;
  TRY((gemm_tc_launch<true, false, OT>(A, B, part, M, N, kc, M, N, N, Epi(),
                                       st, full, ba, bb, bc)));
  if (rest)
    TRY((gemm_tc_launch<true, false, OT>(A + (size_t)full * kc * M,
                                     B + (size_t)full * kc * N,
                                     part + (size_t)full * M * N, M, N, rest, M,
                                     N, N, Epi(), st)));
  const size_t n = (size_t)M * N;
  splitk_sum_kernel<<<blocks_for(n, 256), 256, 0, st>>>(part, C,
                                                        full + (rest > 0), n);
  return cudaGetLastError();
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
// dlnw[idx] (lnw, dlnw: packed (., 2, D) scales and shifts)
cudaError_t ln_bwd(const float* dy, const float* xhat, const float* rstd,
                   const float* lnw, float* dlnw, int idx, const float* base,
                   float* dx, int M, int D, const int* lens, int T,
                   cudaStream_t st) {
  const size_t off = (size_t)idx * 2 * D;
  ln_bwd_kernel<<<(M + 7) / 8, 256, 0, st>>>(dy, xhat, rstd, lnw + off, base,
                                             dx, M, D, lens, T);
  TRY(cudaGetLastError());
  TRY(colsum(dy, xhat, dlnw + off, M, D, lens, T, st));
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
// FFN. Forward: C = R + scale * drop_out(drop_h(SiLU(a . w1 + b1)) . w2 +
// b2), saving the pre-activation z and the dropped hidden rows h (M, F);
// R may alias C. Backward from the residual grad dxw: df = scale * dxw *
// drop_out, the grads of w1, b1, w2, b2, and da = base + the grad of a
// (base may be nullptr).
// ------------------------------------------------------------------------
template <class OT>
cudaError_t ffn_fwd(const float* R, float* C, const float* a, float* z,
                    float* h, const float* w1, const float* b1,
                    const float* w2, const float* b2, int M, int D, int F,
                    int T, float scale, const Drop& dh, const Drop& dout,
                    cudaStream_t st) {
  Epi e1;
  e1.bias = b1;
  e1.pre = z;
  e1.act = kActSilu;
  e1.drop = dh;
  e1.T = T;
  TRY(mm_nn<OT>(a, w1, h, M, F, D, e1, st));
  Epi e2;
  e2.bias = b2;
  e2.R = R;
  e2.res_scale = scale;
  e2.drop = dout;
  e2.T = T;
  return mm_nn<OT>(h, w2, C, M, D, F, e2, st);
}

template <class OT>
cudaError_t ffn_bwd(const float* dxw, const float* a, const float* z,
                    const float* h, const float* w1, const float* w2,
                    float* dw1, float* db1, float* dw2, float* db2, float* df,
                    float* dz, const float* base, float* da, float* part,
                    int M, int D, int F, int T, float scale, const Drop& dh,
                    const Drop& dout, cudaStream_t st) {
  TRY(scale_drop(dxw, df, M, D, scale, dout, nullptr, T, st));
  TRY(colsum(df, nullptr, db2, M, D, nullptr, T, st));
  TRY(mm_tn<OT>(h, df, dw2, F, D, M, part, st));
  Epi e;
  e.act = kActDsilu;
  e.aux = z;
  e.drop = dh;
  e.T = T;
  TRY(mm_nt<OT>(df, w2, dz, M, F, D, e, st));
  TRY(colsum(dz, nullptr, db1, M, F, nullptr, T, st));
  TRY(mm_tn<OT>(a, dz, dw1, D, F, M, part, st));
  Epi ea;
  ea.R = base;
  return mm_nt<OT>(dz, w1, da, M, D, F, ea, st);
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
// Rel-pos MHSA of a training layer. Forward: a (M, D) -> C = R +
// drop_out(O . Wo + bo), O = heads of Pd . V, Pd = drop_prob(P), P the
// masked softmax of [q+u | q+v] . [k | posp]^T / sqrt(d_k); attw (4, D, D)
// q, k, v, out; bias (4, D) their biases; posb (2, D) pos_bias_u,
// pos_bias_v; posp (T, D); mask (B, T, T) u8. R may alias C. The forward
// saves q+u, q+v, k, v, O, P and Pd (AttBufs; bias_uv: 2D floats of
// scratch); the backward, from dres (the grad of C), writes the grads of
// attw, bias, posb and posp and da = base + the grad of a (base may be
// nullptr), with six (M, D) scratch arrays t (da may alias t[1]), dP (H,
// B, T, T) and split-K slices part.
// ------------------------------------------------------------------------
struct AttBufs {
  float *qu, *qv, *k, *v, *o, *P, *Pd, *bias_uv;
};

// score matrix z = b * H + h of the (h, B, T, T) layout; q-like (B, T, D)
// and posp (T, D) head slices
struct AttBatches {
  Batch q, s, pos;
  AttBatches(int B, int T, int D, int H) {
    const int dk = D / H;
    q.s1 = (long long)T * D;
    q.s2 = dk;
    q.div = H;
    s.s1 = (long long)T * T;
    s.s2 = (long long)B * T * T;
    s.div = H;
    pos.s1 = 0;
    pos.s2 = dk;
    pos.div = H;
  }
};

template <class OT>
cudaError_t att_fwd(const float* a, const float* attw, const float* bias,
                    const float* posb, const float* posp,
                    const unsigned char* mask, const AttBufs& s,
                    const float* R, float* C, const Drop& dprob,
                    const Drop& dout, int B, int T, int D, int H,
                    cudaStream_t st) {
  const int M = B * T, dk = D / H;
  const size_t DD = (size_t)D * D;
  // q+u and q+v as two products with summed biases
  TRY(add(bias, posb, s.bias_uv, D, st));
  TRY(add(bias, posb + D, s.bias_uv + D, D, st));
  Epi e;
  e.bias = s.bias_uv;
  TRY(mm_nn<OT>(a, attw, s.qu, M, D, D, e, st));
  e.bias = s.bias_uv + D;
  TRY(mm_nn<OT>(a, attw, s.qv, M, D, D, e, st));
  e.bias = bias + D;
  TRY(mm_nn<OT>(a, attw + DD, s.k, M, D, D, e, st));
  e.bias = bias + 2 * D;
  TRY(mm_nn<OT>(a, attw + 2 * DD, s.v, M, D, D, e, st));
  const AttBatches bt(B, T, D, H);
  Epi es;
  es.alpha = 1.f / sqrtf((float)dk);
  TRY((gemm_tc_launch<false, true, OT>(s.qu, s.k, s.P, T, T, dk, D, D, T, es,
                                       st, B * H, bt.q, bt.q, bt.s)));
  es.R = s.P;
  TRY((gemm_tc_launch<false, true, OT>(s.qv, posp, s.P, T, T, dk, D, D, T, es,
                                       st, B * H, bt.q, bt.pos, bt.s)));
  const long long rows = (long long)H * B * T;
  att_softmax_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      s.P, s.P, s.Pd, mask, B, H, T, dprob);
  TRY(cudaGetLastError());
  TRY((gemm_tc_launch<false, false, OT>(s.Pd, s.v, s.o, T, dk, T, T, D, D,
                                        Epi(), st, B * H, bt.s, bt.q, bt.q)));
  Epi eo;
  eo.bias = bias + 3 * D;
  eo.R = R;
  eo.drop = dout;
  eo.T = T;
  return mm_nn<OT>(s.o, attw + 3 * DD, C, M, D, D, eo, st);
}

// out (M, D) = k + posp[row % T]: the keys plus their positions, the right
// operand of dq in the bf16 mode
__global__ void add_pos_kernel(const float* __restrict__ k,
                               const float* __restrict__ posp,
                               float* __restrict__ out, int T, int D,
                               size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = k[i] + posp[(i / D) % T * D + i % D];
}

template <class OT>
cudaError_t att_bwd(const float* dres, const float* a, const float* attw,
                    const float* posp, const AttBufs& s, const Drop& dprob,
                    const Drop& dout, float* dattw, float* dbias,
                    float* dposb, float* dposp, const float* base, float* da,
                    float* const* t, float* dP, float* part, int B, int T,
                    int D, int H, cudaStream_t st) {
  const int M = B * T, dk = D / H;
  const size_t MD = (size_t)M * D, DD = (size_t)D * D;
  const AttBatches bt(B, T, D, H);
  float *datt = t[0], *dO = t[1], *dv = t[2], *tk = t[3], *tp = t[4],
        *dq = t[5];
  TRY(scale_drop(dres, datt, M, D, 1.f, dout, nullptr, T, st));
  TRY(colsum(datt, nullptr, dbias + 3 * D, M, D, nullptr, T, st));
  TRY(mm_tn<OT>(s.o, datt, dattw + 3 * DD, D, D, M, part, st));
  TRY(mm_nt<OT>(datt, attw + 3 * DD, dO, M, D, D, Epi(), st));
  TRY((gemm_tc_launch<false, true, OT>(dO, s.v, dP, T, T, dk, D, D, T, Epi(),
                                       st, B * H, bt.q, bt.q, bt.s)));
  TRY((gemm_tc_launch<true, false, OT>(s.Pd, dO, dv, T, dk, T, T, D, D, Epi(),
                                       st, B * H, bt.s, bt.q, bt.q)));
  const long long rows = (long long)H * B * T;
  att_softmax_bwd_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      dP, s.P, B, H, T, dprob, 1.f / sqrtf((float)dk));
  TRY(cudaGetLastError());
  TRY((gemm_tc_launch<false, false, OT>(dP, s.k, tk, T, dk, T, T, D, D, Epi(),
                                        st, B * H, bt.s, bt.q, bt.q)));
  TRY((gemm_tc_launch<false, false, OT>(dP, posp, tp, T, dk, T, T, D, D,
                                        Epi(), st, B * H, bt.s, bt.pos,
                                        bt.q)));
  TRY(colsum(tk, nullptr, dposb, M, D, nullptr, T, st));
  TRY(colsum(tp, nullptr, dposb + D, M, D, nullptr, T, st));
  if constexpr (is_bf16<OT>) {
    // dq = dS . bf16(k + p), as masr_tpu's kernel rounds the sum (its
    // _mm(dS, kh + ph, cdt)), not k and p apart
    add_pos_kernel<<<blocks_for(MD, 256), 256, 0, st>>>(s.k, posp, tk, T, D,
                                                        MD);
    TRY(cudaGetLastError());
    TRY((gemm_tc_launch<false, false, OT>(dP, tk, dq, T, dk, T, T, D, D,
                                          Epi(), st, B * H, bt.s, bt.q,
                                          bt.q)));
  } else {
    TRY(add(tk, tp, dq, MD, st));
  }
  float* dkk = t[0];  // datt is spent
  TRY((gemm_tc_launch<true, false, OT>(dP, s.qu, dkk, T, dk, T, T, D, D,
                                       Epi(), st, B * H, bt.s, bt.q, bt.q)));
  // dposp[:, head h] = sum over b of dS[h, b]^T . (q+v)[b, :, head h]: one
  // product per head with K = B*T (dS is laid out (h, B, T, T))
  Batch bh_s, bh_q;
  bh_s.s1 = (long long)B * T * T;
  bh_q.s1 = dk;
  TRY((gemm_tc_launch<true, false, OT>(dP, s.qv, dposp, T, dk, B * T, T, D,
                                       D, Epi(), st, H, bh_s, bh_q, bh_q)));
  TRY(colsum(dq, nullptr, dbias, M, D, nullptr, T, st));
  TRY(colsum(dkk, nullptr, dbias + D, M, D, nullptr, T, st));
  TRY(colsum(dv, nullptr, dbias + 2 * D, M, D, nullptr, T, st));
  TRY(mm_tn<OT>(a, dq, dattw, D, D, M, part, st));
  TRY(mm_tn<OT>(a, dkk, dattw + DD, D, D, M, part, st));
  TRY(mm_tn<OT>(a, dv, dattw + 2 * DD, D, D, M, part, st));
  Epi e0;
  e0.R = base;
  TRY(mm_nt<OT>(dq, attw, da, M, D, D, e0, st));
  Epi acc;
  acc.R = da;
  TRY(mm_nt<OT>(dkk, attw + DD, da, M, D, D, acc, st));
  return mm_nt<OT>(dv, attw + 2 * DD, da, M, D, D, acc, st);
}

// ------------------------------------------------------------------------
// Conv module backward helpers. The forward (common.cuh's
// conv_module_kernel) ran GLU of pw1's output g (B, T, 2D), then a
// depthwise conv over time: GLU row r of utterance b: r in [0, T) from g;
// r < 0 is the left pad, GLU(pw1 bias) when pad_bias (causal), else 0;
// r >= T is 0.
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
// The conv module of a training layer from its pw1 input a (M, D), whose
// rows t >= len the caller has zeroed. Forward: C = R + drop(rows t < len
// of SiLU(LN(depthwise(GLU(a . pw1w + pw1b)) + dwb)) . pw2w + pw2b), norm
// (2, D) the LN's scale and shift, eps its epsilon; R may alias C. The
// forward saves (ConvBufs) pw1's output g (M, 2D), the LN's output before
// SiLU, its x-hat and 1/std, and the SiLU output y. The backward, from
// dres (the grad of C), writes the grads of pw2w, pw2b, norm, dwb, dww,
// pw1b and pw1w, and da = the grad of a in EVERY row (the caller masks),
// with three (M, D) scratch arrays t, dg (M, 2D) and split-K slices part.
// ------------------------------------------------------------------------
struct ConvBufs {
  float *g, *cn, *xhat, *rstd, *y;
};

template <class OT>
cudaError_t conv_fwd(const float* a, const float* pw1w, const float* pw1b,
                     const float* dww, const float* dwb, const float* norm,
                     const float* pw2w, const float* pw2b, const ConvBufs& s,
                     const float* R, float* C, const int* lens, const Drop& d,
                     int B, int T, int D, int ksize, int causal, float eps,
                     cudaStream_t st) {
  const int M = B * T;
  Epi eg;
  eg.bias = pw1b;
  TRY(mm_nn<OT>(a, pw1w, s.g, M, 2 * D, D, eg, st));
  TRY(conv_module(s.g, dww, dwb, pw1b, norm, s.y, B, T, T, D, ksize,
                  causal ? ksize - 1 : (ksize - 1) / 2, causal, eps, st,
                  s.cn, s.xhat, s.rstd));
  Epi ec;
  ec.bias = pw2b;
  ec.R = R;
  ec.drop = d;
  ec.lens = lens;
  ec.T = T;
  return mm_nn<OT>(s.y, pw2w, C, M, D, D, ec, st);
}

template <class OT>
cudaError_t conv_bwd(const float* dres, const float* a, const ConvBufs& s,
                     const float* pw1w, const float* pw1b, const float* dww,
                     const float* norm, const float* pw2w, const int* lens,
                     const Drop& d, float* dpw2w, float* dpw2b,
                     float* dnorm, float* ddwb, float* ddww, float* dpw1b,
                     float* dpw1w, float* da, float* const* t, float* dg,
                     float* part, int B, int T, int D, int ksize, int causal,
                     cudaStream_t st) {
  const int M = B * T;
  const size_t MD = (size_t)M * D;
  TRY(scale_drop(dres, t[0], M, D, 1.f, d, lens, T, st));
  TRY(colsum(t[0], nullptr, dpw2b, M, D, nullptr, T, st));
  TRY(mm_tn<OT>(s.y, t[0], dpw2w, D, D, M, part, st));
  Epi ed;
  ed.act = kActDsilu;
  ed.aux = s.cn;
  TRY(mm_nt<OT>(t[0], pw2w, t[1], M, D, D, ed, st));
  TRY(ln_bwd(t[1], s.xhat, s.rstd, norm, dnorm, 0, nullptr, t[2], M, D,
             nullptr, T, st));
  TRY(colsum(t[2], nullptr, ddwb, M, D, nullptr, T, st));
  const int left = causal ? ksize - 1 : (ksize - 1) / 2;
  conv_dww_kernel<<<dim3((D + 31) / 32, ksize), kColWarps * 32, 0, st>>>(
      t[2], s.g, pw1b, ddww, B, T, D, left, causal);
  TRY(cudaGetLastError());
  conv_dw_bwd_kernel<<<blocks_for(MD, 256), 256, 0, st>>>(t[2], s.g, dww, dg,
                                                          B, T, D, ksize,
                                                          left);
  TRY(cudaGetLastError());
  TRY(colsum(dg, nullptr, dpw1b, M, 2 * D, nullptr, T, st));
  if (causal && left > 0) {
    conv_pad_grad_kernel<<<(D + 127) / 128, 128, 0, st>>>(t[2], dww, pw1b,
                                                          dpw1b, B, T, D,
                                                          left);
    TRY(cudaGetLastError());
  }
  TRY(mm_tn<OT>(a, dg, dpw1w, D, 2 * D, M, part, st));
  return mm_nt<OT>(dg, pw1w, da, M, D, 2 * D, Epi(), st);
}

// ------------------------------------------------------------------------
// What the bf16 mode of a training layer adds to its f32 layouts: the f32
// copies of its five bf16 product weights and of posp (widened once by the
// forward into `saved`; the backward's f32 grads of the same arrays in
// scratch before their rounding), laid out by `take`.
// ------------------------------------------------------------------------
struct Wide {
  size_t ffw1, ffw2, attw, pw1w, pw2w, posp;
};

template <class Take>
Wide wide_layout(Take& take, int T, int D, int F) {
  const size_t DF = (size_t)D * F, DD = (size_t)D * D;
  Wide w;
  w.ffw1 = take(2 * DF);
  w.ffw2 = take(2 * DF);
  w.attw = take(4 * DD);
  w.pw1w = take(2 * DD);
  w.pw2w = take(DD);
  w.posp = take((size_t)T * D);
  return w;
}

// a training layer's shape, causality, dropout hash key and rates
struct Dims {
  int B, T, D, F, H, ksize, causal, layer;
  unsigned thresh, att_thresh;
  float keep_scale, att_keep_scale;
};

Dims make_dims(int B, int T, int D, int F, int n_head, int ksize, int causal,
               int layer, unsigned thresh, float keep_scale,
               unsigned att_thresh, float att_keep_scale) {
  return {B, T, D, F, n_head, ksize, causal, layer, thresh, att_thresh,
          keep_scale, att_keep_scale};
}

}  // namespace
