// CTC loss for Hopper (sm_90a), f32: per-sequence negative log-likelihood
// and its gradient wrt the logits.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/ctc_loss.py:158
// (`ctc_loss_pallas`, entry `ctc_loss` :283; pallas_calls :212 alpha and
// :254 beta/occupancy). Same semantics as optax.ctc_loss: blank-interleaved
// label states s = 0 .. 2L (even: blank, odd: label (s-1)/2), the skip
// s-2 -> s allowed into a label that differs from the label before it,
// right-padded logits and labels, frames t >= tlen frozen. -1e30 stands
// for -inf (as the Pallas kernel), so no (-inf) - (-inf) NaN arises; an
// infeasible alignment gives a loss near 1e30, not NaN.
//
// The TPU kernel held states in one 128-lane tile (S <= 128, labels <= 63)
// and sent longer batches to optax. Here a block walks the states of one
// sequence with as many threads as needed (strided past 1024), so every S
// runs this kernel. Four kernels, two C entries:
//   forward:  ctc_lse_gather_kernel  one block per (b, t): log-sum-exp over
//                                    V and the S state log-probs
//             ctc_alpha_kernel       one block per sequence: the alpha
//                                    recursion over t with two rows in
//                                    shared memory, (T, S) alphas stored
//   backward: ctc_beta_kernel        one block per sequence: the beta
//                                    recursion and the occupancies gamma
//             ctc_grad_kernel        one block per (b, t): g * (softmax *
//                                    sum(gamma) - scatter(gamma)) in a
//                                    shared-memory row of V floats
// The recursions run in f64 (alphas and log Z stored as f64): in f32 the
// log-space sums over T' frames, |log Z| ~ 3e3 at the flagship's loss
// shape, round to ~1e-3 in the occupancies, 18x the plain twin's autograd
// error (measured on the H100); in f64 that rounding is gone and the
// recursions, latency-bound, cost about the same.
//
// What bounds it on the H100: bytes (the (B, T, V) logits read, the grads
// written); the two recursions are T dependent steps each and are bound by
// their latency at small B.

#include "common.cuh"

namespace {

constexpr float kNeg = -1.0e30f;
constexpr double kNegD = -1.0e30;

__device__ __forceinline__ double logaddexp3(double a, double b, double c) {
  const double m = fmax(fmax(a, b), c);
  return m + log(exp(a - m) + exp(b - m) + exp(c - m));
}

__device__ __forceinline__ float block_reduce(float v, float* red, bool max) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = max ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x / 32;
  float r = max ? -INFINITY : 0.f;
  for (int w = 0; w < nw; ++w) r = max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__device__ __forceinline__ int state_token(const int* lab, int s, int blank) {
  return (s & 1) ? lab[(s - 1) / 2] : blank;
}

// lse[b, t] = log sum_v exp(logits); lp[b, t, s] = logits[state s] - lse
// for s < 2 * label_len + 1, kNeg past it
__global__ void ctc_lse_gather_kernel(const float* __restrict__ logits,
                                      const int* __restrict__ labels,
                                      const int* __restrict__ label_lens,
                                      float* __restrict__ lse,
                                      float* __restrict__ lp, int T, int V,
                                      int L, int S, int blank) {
  __shared__ float red[32];
  const int row = blockIdx.x, b = row / T;
  const float* x = logits + (size_t)row * V;
  float mx = -INFINITY;
  for (int v = threadIdx.x; v < V; v += blockDim.x) mx = fmaxf(mx, x[v]);
  mx = block_reduce(mx, red, true);
  float s = 0.f;
  for (int v = threadIdx.x; v < V; v += blockDim.x) s += expf(x[v] - mx);
  s = block_reduce(s, red, false);
  const float l = mx + logf(s);
  if (threadIdx.x == 0) lse[row] = l;
  const int n = 2 * label_lens[b] + 1;
  const int* lab = labels + (size_t)b * L;
  for (int st = threadIdx.x; st < S; st += blockDim.x)
    lp[(size_t)row * S + st] =
        st < n ? x[state_token(lab, st, blank)] - l : kNeg;
}

// skip into state s allowed: s odd, s >= 3, label differs from the one
// before, s a state of this sequence (0 / kNeg additive)
__device__ __forceinline__ double skip_add(const int* lab, int s, int n) {
  return ((s & 1) && s >= 3 && s < n && lab[(s - 1) / 2] != lab[(s - 3) / 2])
             ? 0.0
             : kNegD;
}

// alphas (B, T, S): alpha after frame t (emission included), frozen for
// t >= tlen; logz[b] = logaddexp(alpha[T-1, n-1], alpha[T-1, n-2]) and
// nll[b] = -logz[b]
__global__ void ctc_alpha_kernel(const float* __restrict__ lp,
                                 const int* __restrict__ labels,
                                 const int* __restrict__ label_lens,
                                 const int* __restrict__ logit_lens,
                                 double* __restrict__ alphas,
                                 double* __restrict__ logz,
                                 float* __restrict__ nll, int T, int L,
                                 int S) {
  extern __shared__ double smd[];
  double* prev = smd;
  double* cur = smd + S;
  const int b = blockIdx.x, n = 2 * label_lens[b] + 1, tlen = logit_lens[b];
  const int* lab = labels + (size_t)b * L;
  const float* lpb = lp + (size_t)b * T * S;
  double* ab = alphas + (size_t)b * T * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const double a = (double)lpb[s] + (s < 2 ? 0.0 : kNegD);
    prev[s] = a;
    ab[s] = a;
  }
  for (int t = 1; t < T; ++t) {
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      double a = prev[s];
      if (t < tlen) {
        const double a1 = s >= 1 ? prev[s - 1] : kNegD;
        const double a2 =
            (s >= 2 ? prev[s - 2] : kNegD) + skip_add(lab, s, n);
        a = logaddexp3(prev[s], a1, a2) + (double)lpb[(size_t)t * S + s];
      }
      cur[s] = a;
      ab[(size_t)t * S + s] = a;
    }
    __syncthreads();
    double* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const double a1 = prev[n - 1], a2 = n >= 2 ? prev[n - 2] : kNegD;
    const double lz = fmax(a1, a2) + log1p(exp(-fabs(a1 - a2)));
    logz[b] = lz;
    nll[b] = (float)-lz;
  }
}

// beta recursion from the terminal states backwards; gamma (B, T, S) =
// exp(clip(alpha + beta - logz, kNeg, 0)), 0 in frames t >= tlen
__global__ void ctc_beta_kernel(const float* __restrict__ lp,
                                const int* __restrict__ labels,
                                const int* __restrict__ label_lens,
                                const int* __restrict__ logit_lens,
                                const double* __restrict__ alphas,
                                const double* __restrict__ logz,
                                float* __restrict__ gamma, int T, int L,
                                int S) {
  extern __shared__ double smd[];
  double* beta = smd;
  double* contrib = smd + S;
  const int b = blockIdx.x, n = 2 * label_lens[b] + 1, tlen = logit_lens[b];
  const int* lab = labels + (size_t)b * L;
  const float* lpb = lp + (size_t)b * T * S;
  const double* ab = alphas + (size_t)b * T * S;
  float* gb = gamma + (size_t)b * T * S;
  const double lz = logz[b];
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const double term = (s == n - 1 || (s == n - 2 && n >= 2)) ? 0.0 : kNegD;
    const double be = tlen - 1 == T - 1 ? term : kNegD;
    beta[s] = be;
    gb[(size_t)(T - 1) * S + s] = (float)exp(
        fmin(fmax(ab[(size_t)(T - 1) * S + s] + be - lz, kNegD), 0.0));
  }
  for (int t = T - 2; t >= 0; --t) {
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      contrib[s] = beta[s] + (double)lpb[(size_t)(t + 1) * S + s];
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const double term =
          (s == n - 1 || (s == n - 2 && n >= 2)) ? 0.0 : kNegD;
      const double b1 = s + 1 < S ? contrib[s + 1] : kNegD;
      const double b2 =
          s + 2 < S ? contrib[s + 2] + skip_add(lab, s + 2, n) : kNegD;
      double be = kNegD;
      if (t == tlen - 1)
        be = term;
      else if (t < tlen - 1)
        be = logaddexp3(contrib[s], b1, b2);
      beta[s] = be;
      gb[(size_t)t * S + s] = (float)exp(
          fmin(fmax(ab[(size_t)t * S + s] + be - lz, kNegD), 0.0));
    }
  }
}

// grad[b, t, v] = g[b] * (exp(logit - lse) * sum_s gamma - sum over states
// s with token v of gamma), states summed in order s = 0, 1, ...
__global__ void ctc_grad_kernel(const float* __restrict__ logits,
                                const float* __restrict__ lse,
                                const float* __restrict__ gamma,
                                const int* __restrict__ labels,
                                const int* __restrict__ label_lens,
                                const float* __restrict__ gout,
                                float* __restrict__ grad, int T, int V, int L,
                                int S, int blank) {
  extern __shared__ float rowbuf[];
  __shared__ float red[32];
  const int row = blockIdx.x, b = row / T;
  const int n = 2 * label_lens[b] + 1;
  const float* gr = gamma + (size_t)row * S;
  float occ = 0.f;
  for (int s = threadIdx.x; s < n; s += blockDim.x) occ += gr[s];
  occ = block_reduce(occ, red, false);
  const float* x = logits + (size_t)row * V;
  const float l = lse[row];
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    rowbuf[v] = expf(x[v] - l) * occ;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int* lab = labels + (size_t)b * L;
    for (int s = 0; s < n; ++s) rowbuf[state_token(lab, s, blank)] -= gr[s];
  }
  __syncthreads();
  const float g = gout[b];
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    grad[(size_t)row * V + v] = g * rowbuf[v];
}

int state_threads(int S) {
  const int t = ((S + 31) / 32) * 32;
  return t < 1024 ? t : 1024;
}

}  // namespace

// logits (B,T,V) f32; labels (B,L) i32 with ids in [0, V) in the first
// label_lens[b] columns; logit_lens, label_lens (B,) i32; S = 2L+1.
// Writes nll (B,), and for the backward lse (B,T), lp (B,T,S), alphas
// (B,T,S) f64, logz (B,) f64.
extern "C" int masr_ctc_forward(const float* logits, const int* labels,
                                const int* logit_lens, const int* label_lens,
                                float* nll, float* lse, float* lp,
                                double* alphas, double* logz, int B, int T,
                                int V, int L, int blank, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  ctc_lse_gather_kernel<<<B * T, 256, 0, st>>>(logits, labels, label_lens,
                                               lse, lp, T, V, L, S, blank);
  MASR_CHECK(cudaGetLastError());
  const size_t smem = 2 * sizeof(double) * (size_t)S;
  MASR_CHECK(cudaFuncSetAttribute(ctc_alpha_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem));
  ctc_alpha_kernel<<<B, state_threads(S), smem, st>>>(
      lp, labels, label_lens, logit_lens, alphas, logz, nll, T, L, S);
  return (int)cudaGetLastError();
}

// gout (B,) incoming grad of nll; writes grad (B,T,V) and gamma (B,T,S)
extern "C" int masr_ctc_backward(const float* logits, const int* labels,
                                 const int* logit_lens,
                                 const int* label_lens, const float* lse,
                                 const float* lp, const double* alphas,
                                 const double* logz, const float* gout,
                                 float* gamma, float* grad, int B, int T,
                                 int V, int L, int blank, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  const size_t smem = 2 * sizeof(double) * (size_t)S;
  MASR_CHECK(cudaFuncSetAttribute(ctc_beta_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem));
  ctc_beta_kernel<<<B, state_threads(S), smem, st>>>(
      lp, labels, label_lens, logit_lens, alphas, logz, gamma, T, L, S);
  MASR_CHECK(cudaGetLastError());
  const size_t row_smem = sizeof(float) * (size_t)V;
  MASR_CHECK(cudaFuncSetAttribute(ctc_grad_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)row_smem));
  ctc_grad_kernel<<<B * T, 256, row_smem, st>>>(logits, lse, gamma, labels,
                                                label_lens, gout, grad, T, V,
                                                L, S, blank);
  return (int)cudaGetLastError();
}
