// CTC loss for Hopper (sm_90a): per-sequence negative log-likelihood and
// its gradient wrt the logits.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/ctc_loss.py:158
// (`ctc_loss_pallas`, entry `ctc_loss` :283; pallas_calls :212 alpha and
// :254 beta/occupancy). Same semantics as optax.ctc_loss: blank-interleaved
// label states s = 0 .. 2L (even: blank, odd: label (s-1)/2), the skip
// s-2 -> s allowed into a label that differs from the label before it,
// right-padded logits and labels, frames t >= tlen frozen. -1e30 stands
// for -inf (as the Pallas kernel), so no (-inf) - (-inf) NaN arises; an
// infeasible alignment gives a loss near 1e30, not NaN, and occupancies
// exp(clip(alpha + beta - log Z, -1e30, 0)) as the Pallas kernel's.
//
// Three kernels, two C entries:
//   forward:  ctc_gather_kernel  one block per (b, t): log-sum-exp over V in
//                                one read of the row (online max and sum),
//                                the S state log-probs in log2 units; when
//                                a grad is wanted, B more blocks, first in
//                                the grid, build each sequence's token-group
//                                table beside the rows
//             ctc_chain_kernel   one block per chain: blocks 0..B-1 run the
//                                alpha recursion of sequence b, blocks
//                                B..2B-1 (only when a grad is wanted) its
//                                beta recursion, at the same time
//   backward: ctc_grad_kernel    one block per (b, t): the occupancies from
//                                alpha + beta - log Z, the row's softmax from
//                                the forward's lse, one read of the logits
//                                and one write of the grads, the scatter by
//                                token group
//
// The chains. Each is one warp where S <= 256 (32 lanes x K <= 8
// consecutive states in registers; S = 161 gives K = 6) and up to 8 warps
// of K = 8 where S <= 2048; the s-1 / s-2 (beta: s+1 / s+2) neighbours
// cross lanes by shuffles and warps through a double-buffered shared row
// with one block barrier a frame (a block holds one chain, so its barrier
// spans that chain's warps only). Past 2048 states a block of 1024
// threads walks the states strided and reads the previous frame's row back
// from device memory (ctc_wide_kernel): any S runs. The per-state
// log-probabilities of the next 8 frames are loaded into registers ahead
// of the chain, so no load from device memory sits between two frames.
//
// The arithmetic. The recursions run in f32 in log2 units, each value
// relative to a per-chain offset that is summed in f64: at step k the
// values are shifted by r_k = M_{k-2} - r_{k-1} (M_j the max over states
// of the stored values of step j), so the offset o_k = o_{k-1} + r_k is the
// true max of step k-2 and the stored values stay within a few tens of 0,
// where an f32 ulp is ~4e-6 (the f32 recursions of the first port, at
// |log Z| ~ 3e3, rounded ~1e-3 into the occupancies). The max of step k-1
// is reduced while step k computes, off the chain. Each state takes
// hi + log2(1 + 2^(lo1-hi) + 2^(lo2-hi)): two ex2.approx and one
// lg2.approx. Stored: alpha and beta (B, T, S) f32 and one f64 offset per
// (b, t) each; log Z in f64. ops/cuda/ctc_loss.py `ctc_scheme_mirror`
// repeats this scheme in PyTorch for the CPU tests.
//
// The scatter. Each sequence's table groups its states by token in s
// order (blank: the even states; each label token: its odd states); one
// thread sums a group's occupancies in s order and writes that token's
// grad, with no float atomics, so the bits depend on neither the run nor
// the batch.
//
// What bounds it on the H100: bytes (the (B, T, V) logits read twice, once
// per pass, and the grads written once); the chains are T' dependent steps
// bound by their latency, run side by side on 2B SMs.

#include "common.cuh"

namespace {

constexpr float kNeg2 = -1.4426950408889634e30f;  // -1e30 in log2 units
constexpr float kLog2e = 1.4426950408889634f;
constexpr double kLn2 = 0.6931471805599453;
constexpr int kMaxK = 8;        // states per lane
constexpr int kMaxWarps = 8;    // warps of a register chain
constexpr int kAhead = 8;       // frames of log-probs loaded ahead
constexpr int kRowThreads = 256;
constexpr int kWideThreads = 1024;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log2(2^a + 2^b + 2^c): the largest term is exactly 1
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float lo1 = fminf(a, b), hi1 = fmaxf(a, b);
  const float hi = fmaxf(hi1, c), lo2 = fminf(hi1, c);
  return hi + lg2(1.f + ex2(lo1 - hi) + ex2(lo2 - hi));
}

// label i of a sequence, a negative id read as 0 (as the plain twin's clamp)
__device__ __forceinline__ int label_at(const int* lab, int i) {
  return max(lab[i], 0);
}

__device__ __forceinline__ int state_token(const int* lab, int s, int blank) {
  return (s & 1) ? label_at(lab, (s - 1) / 2) : blank;
}

// skip s-2 -> s allowed: s odd, s >= 3, a state of this sequence, its label
// differs from the one before (0 / kNeg2 additive)
__device__ __forceinline__ float skip_add(const int* lab, int s, int n) {
  return ((s & 1) && s >= 3 && s < n &&
          label_at(lab, (s - 1) / 2) != label_at(lab, (s - 3) / 2))
             ? 0.f
             : kNeg2;
}

// online log-sum-exp pair (m, s): s = sum exp(x - m)
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * expf(m - mx)) +
      (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mx));
  m = mx;
}

__device__ __forceinline__ void lse_add(float& m, float& s, float x) {
  if (x > m) {
    s = (m == -INFINITY ? 0.f : s * expf(m - x)) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

// Scratch, carved from one allocation (f64 arrays first):
struct Scratch {
  double* off_a;   // (B, T) alpha offsets, log2 units
  double* off_b;   // (B, T) beta offsets
  double* logz;    // (B,) log2 Z
  float* lse;      // (B, T) natural log-sum-exp of each logits row
  float* lp;       // (B, T, ldp) state log-probs, log2 units, kNeg2 past n
  float* alpha;    // (B, T, S) relative to off_a
  float* beta;     // (B, T, S) relative to off_b
  int* order;      // (B, S) states grouped by token, s order in a group
  int* gbeg;       // (B, S + 1) start of each group in order
  int* ngroups;    // (B,)
  int* first;      // (B, S) build scratch: first state of s's token
  int ldp;         // row stride of lp: every state a register chain reads
};

// the register chains' shape for S states: W warps of 32 lanes x K
// states; W = 0 past kMaxWarps warps (the strided kernel)
inline void chain_shape(int S, int* W, int* K) {
  *W = S <= 32 * kMaxK ? 1 : (S + 32 * kMaxK - 1) / (32 * kMaxK);
  *K = *W == 1 ? (S + 31) / 32 : kMaxK;
  if (*W > kMaxWarps) *W = 0;
}

// lp's row stride: a lane reads K + 2 states from s0 (the beta chain's
// s + 1, s + 2), so a register chain's rows hold 32 W K + 2
inline int lp_stride(int S) {
  int W, K;
  chain_shape(S, &W, &K);
  return W ? 32 * W * K + 2 : S;
}

inline size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

// → bytes of the scratch; fills *sc from base unless sc is null
inline size_t carve(char* base, int B, int T, int S, Scratch* sc) {
  size_t o = 0;
  const int ldp = lp_stride(S);
  const size_t bt = (size_t)B * T, bts = bt * S, bs = (size_t)B * S;
  auto take = [&](size_t bytes) {
    char* p = base + o;
    o = align_up(o + bytes);
    return p;
  };
  char* p;
  p = take(8 * bt);
  if (sc) sc->off_a = (double*)p;
  p = take(8 * bt);
  if (sc) sc->off_b = (double*)p;
  p = take(8 * (size_t)B);
  if (sc) sc->logz = (double*)p;
  p = take(4 * bt);
  if (sc) sc->lse = (float*)p;
  p = take(4 * bt * ldp);
  if (sc) {
    sc->lp = (float*)p;
    sc->ldp = ldp;
  }
  p = take(4 * bts);
  if (sc) sc->alpha = (float*)p;
  p = take(4 * bts);
  if (sc) sc->beta = (float*)p;
  p = take(4 * bs);
  if (sc) sc->order = (int*)p;
  p = take(4 * (bs + B));
  if (sc) sc->gbeg = (int*)p;
  p = take(4 * (size_t)B);
  if (sc) sc->ngroups = (int*)p;
  p = take(4 * bs);
  if (sc) sc->first = (int*)p;
  return o;
}

// -------------------------------------------------------------------------
// forward 1: lse, state log-probs, token-group tables
// -------------------------------------------------------------------------

// table of sequence b: order = the states s < n sorted by (first state of
// their token, s); gbeg[g] = where group g starts, groups in order of their
// first state; ngroups. O(n^2 / threads), once per call.
__device__ void build_groups(const int* lab, int n, int blank, int* first,
                             int* order, int* gbeg, int* ngroups) {
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int tok = state_token(lab, s, blank);
    int f = s;
    for (int q = 0; q < s; ++q)
      if (state_token(lab, q, blank) == tok) {
        f = q;
        break;
      }
    first[s] = f;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int f = first[s];
    int pos = 0, g = 0;
    for (int q = 0; q < n; ++q) {
      const int fq = first[q];
      pos += fq < f || (fq == f && q < s);
      g += q < s && fq == q;
    }
    order[pos] = s;
    if (f == s) gbeg[g] = pos;
  }
  if (threadIdx.x == 0) {
    int G = 0;
    for (int q = 0; q < n; ++q) G += first[q] == q;
    gbeg[G] = n;
    *ngroups = G;
  }
}

__global__ void __launch_bounds__(kRowThreads)
    ctc_gather_kernel(const float* __restrict__ logits,
                      const int* __restrict__ labels,
                      const int* __restrict__ label_lens, Scratch sc, int B,
                      int T, int V, int L, int S, int blank, int vec,
                      int need_grad) {
  __shared__ float red_m[kRowThreads / 32], red_s[kRowThreads / 32];
  if (need_grad && blockIdx.x < B) {
    // blocks 0..B-1: the group tables, in the first wave
    const int b = blockIdx.x;
    build_groups(labels + (size_t)b * L, 2 * label_lens[b] + 1, blank,
                 sc.first + (size_t)b * S, sc.order + (size_t)b * S,
                 sc.gbeg + (size_t)b * (S + 1), sc.ngroups + b);
    return;
  }
  const int row = blockIdx.x - (need_grad ? B : 0), b = row / T;
  const float* x = logits + (size_t)row * V;
  float m = -INFINITY, s = 0.f;
  if (vec) {
    const float4* x4 = (const float4*)x;
    for (int i = threadIdx.x; i < V / 4; i += blockDim.x) {
      const float4 q = x4[i];
      const float mq = fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w));
      if (mq > m) {
        s = m == -INFINITY ? 0.f : s * expf(m - mq);
        m = mq;
      }
      s += (expf(q.x - m) + expf(q.y - m)) + (expf(q.z - m) + expf(q.w - m));
    }
  } else {
    for (int v = threadIdx.x; v < V; v += blockDim.x) lse_add(m, s, x[v]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, o);
    const float s2 = __shfl_xor_sync(kFull, s, o);
    lse_merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w)
    lse_merge(m, s, red_m[w], red_s[w]);
  const float l = m + logf(s);
  if (threadIdx.x == 0) sc.lse[row] = l;
  const int n = 2 * label_lens[b] + 1;
  const int* lab = labels + (size_t)b * L;
  float* lp = sc.lp + (size_t)row * sc.ldp;
  for (int st = threadIdx.x; st < sc.ldp; st += blockDim.x)
    lp[st] = st < n ? (x[state_token(lab, st, blank)] - l) * kLog2e : kNeg2;
}

// -------------------------------------------------------------------------
// forward 2: the chains
// -------------------------------------------------------------------------

// frames of the chain: alpha runs t = 0 .. te-1 with te = clamp(tlen, 1,
// T); beta runs t = tb-1 .. 0 with tb = tlen where 1 <= tlen <= T, else
// not at all (the Pallas kernel's occupancies are then 0)
__device__ __forceinline__ int alpha_frames(int tlen, int T) {
  return min(max(tlen, 1), T);
}

__device__ __forceinline__ int beta_frames(int tlen, int T) {
  return (tlen >= 1 && tlen <= T) ? tlen : 0;
}

// log2 Z of sequence b from the stored alpha row of its last frame
__device__ void finish_logz(const Scratch& sc, float* nll, int b, int T,
                            int S, int n, int te) {
  if (threadIdx.x != 0) return;
  const float* a = sc.alpha + ((size_t)b * T + te - 1) * S;
  const double a1 = a[n - 1], a2 = n >= 2 ? a[n - 2] : (double)kNeg2;
  const double hi = fmax(a1, a2), lo = fmin(a1, a2);
  const double lz = sc.off_a[(size_t)b * T + te - 1] + hi +
                    log2(1.0 + exp2(lo - hi));
  sc.logz[b] = lz;
  nll[b] = (float)(-lz * kLn2);
}

struct Bound {
  float lo0, lo1, hi0, hi1, pmax;
};

// one chain held in registers: W = blockDim.x / 32 warps, lane l of warp w
// holds states s0 = (32 w + l) K .. s0 + K - 1. The steps run in groups of
// kAhead with no branch inside a group: a step past the chain's end
// computes and is dropped, so the log-prob loads of a step, issued kAhead
// steps ahead from clamped in-bounds addresses of the padded lp rows, are
// waited on only where they are used.
template <int K, bool kBeta>
__device__ void chain_regs(const Scratch& sc, const int* __restrict__ lab,
                           float* nll, int b, int n, int frames, int T,
                           int S) {
  constexpr int E = kBeta ? K + 2 : K;  // log-probs a lane reads a frame
  __shared__ Bound bnd[2][kMaxWarps];
  const int W = blockDim.x / 32, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  const int s0 = (warp * 32 + lane) * K;
  const float* lpb = sc.lp + (size_t)b * T * sc.ldp;
  float* out = (kBeta ? sc.beta : sc.alpha) + (size_t)b * T * S;
  double* off = (kBeta ? sc.off_b : sc.off_a) + (size_t)b * T;
  // alpha: step k makes frame k from the log-probs of frame k;
  // beta: step k makes frame frames-1-k from those of frame frames-k
  auto frame_of = [&](int k) { return kBeta ? frames - 1 - k : k; };
  auto lp_frame = [&](int k) {
    return kBeta ? max(frames - k, 0) : min(k, T - 1);
  };

  float skip[K];  // additive skip into s (alpha) or into s + 2 (beta)
  float v[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = s0 + i;
    skip[i] = skip_add(lab, kBeta ? s + 2 : s, n);
    if constexpr (kBeta)
      v[i] = (s == n - 1 || (s == n - 2 && n >= 2)) ? 0.f : kNeg2;
    else
      v[i] = s < 2 ? lpb[s] : kNeg2;
    if (s < S) out[(size_t)frame_of(0) * S + s] = v[i];
  }
  if (threadIdx.x == 0) off[frame_of(0)] = 0.0;

  float pre[kAhead][E];
  auto load = [&](float* dst, int k) {
    const float* row = lpb + (size_t)lp_frame(k) * sc.ldp + s0;
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i] = __ldg(row + i);
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j) load(pre[j], 1 + j);

  auto publish = [&](int par, float pm) {
    if (lane == 0) {
      bnd[par][warp].lo0 = v[0];
      bnd[par][warp].lo1 = K >= 2 ? v[K >= 2 ? 1 : 0] : kNeg2;
      bnd[par][warp].pmax = pm;
    }
    if (lane == 31) {
      bnd[par][warp].hi0 = K >= 2 ? v[K >= 2 ? K - 2 : 0] : kNeg2;
      bnd[par][warp].hi1 = v[K - 1];
    }
  };
  if (W > 1) {
    publish(0, kNeg2);
    __syncthreads();
  }

  double o = 0.0;
  float r_prev = 0.f, m_prev = 0.f;  // r_{k-1}, M_{k-2}
  for (int k0 = 1; k0 < frames; k0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int k = k0 + j;
      const bool act = k < frames;
      const float r = k >= 2 ? m_prev - r_prev : 0.f;
      // M_{k-1}: this warp's part, reduced while the step computes
      float pm = v[0];
#pragma unroll
      for (int i = 1; i < K; ++i) pm = fmaxf(pm, v[i]);
      pm = warp_max(pm);
      const int par = (k - 1) & 1;
      float ext[K + 2], nv[K];
      if constexpr (!kBeta) {
        // ext[0] = v(s0-2), ext[1] = v(s0-1), ext[2 + i] = v(s0+i)
        float p1 = __shfl_up_sync(kFull, v[K - 1], 1);
        float p2 = K >= 2 ? __shfl_up_sync(kFull, v[K >= 2 ? K - 2 : 0], 1)
                          : __shfl_up_sync(kFull, v[0], 2);
        if (lane == 0) {
          p1 = warp > 0 ? bnd[par][warp - 1].hi1 : kNeg2;
          p2 = warp > 0 ? bnd[par][warp - 1].hi0 : kNeg2;
        }
        if (K == 1 && lane == 1) p2 = kNeg2;  // K = 1 runs one warp
        ext[0] = s0 >= 2 ? p2 : kNeg2;
        ext[1] = s0 >= 1 ? p1 : kNeg2;
#pragma unroll
        for (int i = 0; i < K; ++i) ext[2 + i] = v[i];
#pragma unroll
        for (int i = 0; i < K; ++i)
          nv[i] = lse3(ext[2 + i], ext[1 + i], ext[i] + skip[i]) +
                  pre[j][i] - r;
      } else {
        // ext[i] = z(s0+i) = v + lp, i < K + 2
        float n1 = __shfl_down_sync(kFull, v[0], 1);
        float n2 = K >= 2 ? __shfl_down_sync(kFull, v[K >= 2 ? 1 : 0], 1)
                          : __shfl_down_sync(kFull, v[0], 2);
        if (lane == 31) {
          n1 = warp + 1 < W ? bnd[par][warp + 1].lo0 : kNeg2;
          n2 = warp + 1 < W ? bnd[par][warp + 1].lo1 : kNeg2;
        }
#pragma unroll
        for (int i = 0; i < K; ++i) ext[i] = v[i] + pre[j][i];
        ext[K] = (s0 + K < S ? n1 : kNeg2) + pre[j][K];
        ext[K + 1] = (s0 + K + 1 < S ? n2 : kNeg2) + pre[j][K + 1];
#pragma unroll
        for (int i = 0; i < K; ++i)
          nv[i] = lse3(ext[i], ext[i + 1], ext[i + 2] + skip[i]) - r;
      }
      const int f = frame_of(k);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        v[i] = act ? nv[i] : v[i];
        if (act && s0 + i < S) out[(size_t)f * S + s0 + i] = v[i];
      }
      if (act) {
        o += (double)r;
        if (threadIdx.x == 0) off[f] = o;
      }
      if (W > 1) {
        publish(k & 1, pm);
        __syncthreads();
        pm = bnd[k & 1][0].pmax;
        for (int w = 1; w < W; ++w) pm = fmaxf(pm, bnd[k & 1][w].pmax);
      }
      m_prev = act ? pm : m_prev;
      r_prev = act ? r : r_prev;
      load(pre[j], k + kAhead);
    }
  }
  if constexpr (!kBeta) {
    __syncthreads();
    finish_logz(sc, nll, b, T, S, n, frames);
  }
}

template <int K>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ctc_chain_kernel(const int* __restrict__ labels,
                     const int* __restrict__ label_lens,
                     const int* __restrict__ logit_lens, Scratch sc,
                     float* __restrict__ nll, int B, int T, int L, int S) {
  const bool beta = blockIdx.x >= B;
  const int b = beta ? blockIdx.x - B : blockIdx.x;
  const int n = 2 * label_lens[b] + 1, tlen = logit_lens[b];
  const int* lab = labels + (size_t)b * L;
  if (beta) {
    const int frames = beta_frames(tlen, T);
    if (frames > 0) chain_regs<K, true>(sc, lab, nll, b, n, frames, T, S);
  } else {
    chain_regs<K, false>(sc, lab, nll, b, n, alpha_frames(tlen, T), T, S);
  }
}

// past 2048 states: kWideThreads threads strided over the states, the
// previous frame's row read back from device memory; same arithmetic
__global__ void __launch_bounds__(kWideThreads)
    ctc_wide_kernel(const int* __restrict__ labels,
                    const int* __restrict__ label_lens,
                    const int* __restrict__ logit_lens, Scratch sc,
                    float* __restrict__ nll, int B, int T, int L, int S) {
  __shared__ float red[2][kWideThreads / 32];
  const bool beta = blockIdx.x >= B;
  const int b = beta ? blockIdx.x - B : blockIdx.x;
  const int n = 2 * label_lens[b] + 1, tlen = logit_lens[b];
  const int* lab = labels + (size_t)b * L;
  const int frames = beta ? beta_frames(tlen, T) : alpha_frames(tlen, T);
  if (frames == 0) return;
  const float* lpb = sc.lp + (size_t)b * T * sc.ldp;
  float* out = (beta ? sc.beta : sc.alpha) + (size_t)b * T * S;
  double* off = (beta ? sc.off_b : sc.off_a) + (size_t)b * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  const int f0 = beta ? frames - 1 : 0;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    out[(size_t)f0 * S + s] =
        beta ? ((s == n - 1 || (s == n - 2 && n >= 2)) ? 0.f : kNeg2)
             : (s < 2 ? lpb[s] : kNeg2);
  if (threadIdx.x == 0) off[f0] = 0.0;
  __syncthreads();
  double o = 0.0;
  float r_prev = 0.f, m_prev = 0.f;
  for (int k = 1; k < frames; ++k) {
    const float r = k >= 2 ? m_prev - r_prev : 0.f;
    const int f = beta ? frames - 1 - k : k, fp = beta ? f + 1 : f - 1;
    const float* prev = out + (size_t)fp * S;
    const float* lp = lpb + (size_t)(beta ? fp : f) * sc.ldp;
    float pm = kNeg2;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float p0 = prev[s];
      pm = fmaxf(pm, p0);
      float nv;
      if (!beta) {
        const float p1 = s >= 1 ? prev[s - 1] : kNeg2;
        const float p2 = s >= 2 ? prev[s - 2] : kNeg2;
        nv = lse3(p0, p1, p2 + skip_add(lab, s, n)) + lp[s] - r;
      } else {
        const float z0 = p0 + lp[s];
        const float z1 = s + 1 < S ? prev[s + 1] + lp[s + 1] : 2 * kNeg2;
        const float z2 = s + 2 < S ? prev[s + 2] + lp[s + 2] : 2 * kNeg2;
        nv = lse3(z0, z1, z2 + skip_add(lab, s + 2, n)) - r;
      }
      out[(size_t)f * S + s] = nv;
    }
    pm = warp_max(pm);
    if (lane == 0) red[k & 1][warp] = pm;
    o += (double)r;
    if (threadIdx.x == 0) off[f] = o;
    __syncthreads();
    pm = red[k & 1][0];
    for (int w = 1; w < nw; ++w) pm = fmaxf(pm, red[k & 1][w]);
    m_prev = pm;
    r_prev = r;
  }
  if (!beta) finish_logz(sc, nll, b, T, S, n, frames);
}

// -------------------------------------------------------------------------
// backward: occupancies, softmax row, grouped scatter
// -------------------------------------------------------------------------

// occupancy of state s in row (b, t): 2^min(alpha + beta + c, 0)
__device__ __forceinline__ float occupancy(const float* a, const float* be,
                                           int s, float c) {
  return ex2(fminf(a[s] + be[s] + c, 0.f));
}

__global__ void __launch_bounds__(kRowThreads)
    ctc_grad_kernel(const float* __restrict__ logits,
                    const int* __restrict__ labels,
                    const int* __restrict__ label_lens,
                    const int* __restrict__ logit_lens, Scratch sc,
                    const float* __restrict__ gout, float* __restrict__ grad,
                    int T, int V, int L, int S, int blank, int vec) {
  __shared__ float red[kRowThreads / 32];
  const int row = blockIdx.x, b = row / T, t = row % T;
  float* gr = grad + (size_t)row * V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (t >= beta_frames(logit_lens[b], T)) {
    for (int v = threadIdx.x; v < V; v += blockDim.x) gr[v] = 0.f;
    return;
  }
  const int n = 2 * label_lens[b] + 1;
  const float* a = sc.alpha + (size_t)row * S;
  const float* be = sc.beta + (size_t)row * S;
  const float c = (float)(sc.off_a[row] + sc.off_b[row] - sc.logz[b]);
  float occ = 0.f;
  for (int s = threadIdx.x; s < n; s += blockDim.x)
    occ += occupancy(a, be, s, c);
  occ = warp_sum(occ);
  if (lane == 0) red[warp] = occ;
  __syncthreads();
  occ = red[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w) occ += red[w];
  const float* x = logits + (size_t)row * V;
  const float l = sc.lse[row], g = gout[b];
  if (vec) {
    const float4* x4 = (const float4*)x;
    float4* g4 = (float4*)gr;
    for (int i = threadIdx.x; i < V / 4; i += blockDim.x) {
      const float4 q = x4[i];
      g4[i] = make_float4(
          g * (expf(q.x - l) * occ), g * (expf(q.y - l) * occ),
          g * (expf(q.z - l) * occ), g * (expf(q.w - l) * occ));
    }
  } else {
    for (int v = threadIdx.x; v < V; v += blockDim.x)
      gr[v] = g * (expf(x[v] - l) * occ);
  }
  __syncthreads();  // the dense row lands before the groups' columns
  const int* order = sc.order + (size_t)b * S;
  const int* gbeg = sc.gbeg + (size_t)b * (S + 1);
  const int G = sc.ngroups[b];
  const int* lab = labels + (size_t)b * L;
  for (int gi = threadIdx.x; gi < G; gi += blockDim.x) {
    const int j0 = gbeg[gi], j1 = gbeg[gi + 1];
    float sum = 0.f;
    for (int j = j0; j < j1; ++j) sum += occupancy(a, be, order[j], c);
    const int tok = state_token(lab, order[j0], blank);
    gr[tok] = g * (expf(x[tok] - l) * occ - sum);
  }
}

int chain_launch(int K, int blocks, int threads, cudaStream_t st,
                 const int* labels, const int* label_lens,
                 const int* logit_lens, const Scratch& sc, float* nll, int B,
                 int T, int L, int S) {
#define MASR_CTC_CHAIN(KK)                                                  \
  case KK:                                                                  \
    ctc_chain_kernel<KK><<<blocks, threads, 0, st>>>(                       \
        labels, label_lens, logit_lens, sc, nll, B, T, L, S);               \
    break;
  switch (K) {
    MASR_CTC_CHAIN(1)
    MASR_CTC_CHAIN(2)
    MASR_CTC_CHAIN(3)
    MASR_CTC_CHAIN(4)
    MASR_CTC_CHAIN(5)
    MASR_CTC_CHAIN(6)
    MASR_CTC_CHAIN(7)
    MASR_CTC_CHAIN(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MASR_CTC_CHAIN
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of scratch the two entries share for (B, T, S = 2L + 1)
extern "C" long long masr_ctc_scratch_bytes(int B, int T, int L) {
  return (long long)carve(nullptr, B, T, 2 * L + 1, nullptr);
}

// logits (B,T,V) f32; labels (B,L) i32 with ids in [0, V) in the first
// label_lens[b] columns (a negative id reads as 0); logit_lens, label_lens
// (B,) i32; S = 2L+1; scratch of masr_ctc_scratch_bytes. Writes nll (B,);
// with need_grad also the betas and the token-group tables the backward
// reads.
extern "C" int masr_ctc_forward(const float* logits, const int* labels,
                                const int* logit_lens, const int* label_lens,
                                float* nll, void* scratch, int B, int T,
                                int V, int L, int blank, int need_grad,
                                void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  Scratch sc;
  carve((char*)scratch, B, T, S, &sc);
  const int vec = V % 4 == 0 && ((size_t)logits & 15) == 0;
  ctc_gather_kernel<<<B * T + (need_grad ? B : 0), kRowThreads, 0, st>>>(
      logits, labels, label_lens, sc, B, T, V, L, S, blank, vec, need_grad);
  MASR_CHECK(cudaGetLastError());
  const int blocks = need_grad ? 2 * B : B;
  int W, K;
  chain_shape(S, &W, &K);
  if (W)
    return chain_launch(K, blocks, 32 * W, st, labels, label_lens,
                        logit_lens, sc, nll, B, T, L, S);
  ctc_wide_kernel<<<blocks, kWideThreads, 0, st>>>(
      labels, label_lens, logit_lens, sc, nll, B, T, L, S);
  return (int)cudaGetLastError();
}

// gout (B,) incoming grad of nll; scratch as the forward with need_grad
// left it; writes grad (B,T,V)
extern "C" int masr_ctc_backward(const float* logits, const int* labels,
                                 const int* logit_lens,
                                 const int* label_lens, void* scratch,
                                 const float* gout, float* grad, int B, int T,
                                 int V, int L, int blank, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int S = 2 * L + 1;
  if (B == 0 || T == 0) return (int)cudaGetLastError();
  Scratch sc;
  carve((char*)scratch, B, T, S, &sc);
  const int vec = V % 4 == 0 && ((size_t)logits & 15) == 0 &&
                  ((size_t)grad & 15) == 0;
  ctc_grad_kernel<<<B * T, kRowThreads, 0, st>>>(
      logits, labels, label_lens, logit_lens, sc, gout, grad, T, V, L, S,
      blank, vec);
  return (int)cudaGetLastError();
}
