// CTC loss for Hopper (sm_90a): per-sequence negative log-likelihood and
// its gradient wrt the logits.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/ctc_loss.py:158
// (`ctc_loss_pallas`, entry `ctc_loss` :283; pallas_calls :212 alpha and
// :254 beta/occupancy). Same semantics as optax.ctc_loss, masr_tpu's CPU
// route: blank-interleaved label states s = 0 .. 2L (even: blank, odd:
// label (s-1)/2), right-padded logits and labels, frames t >= tlen
// frozen. optax's log_epsilon = -1e5 stands for log 0 in its initial rows
// (every state but s = 0 starts at -1e5) and in the skip s-2 -> s into a
// label equal to the one before it; -1e30 (kNeg2) bars the rest. An
// alignment that needs more frames than it has is so finite: 1e5 + the
// cost of its paths with one -1e5 step (one step off the start reaches
// any state, so no path needs two). Each state carries a class, the least
// number of -1e5 steps of the paths into it, beside its log-prob, the sum
// over those paths only: a term of a higher class than the least of a
// state's three drops out (it weighs exp(-1e5) less), and 1e5 x the
// class of log Z is added to the NLL once, in f64, so the paths' costs
// keep their precision. A state's occupancy counts where its alpha and
// beta classes add up to log Z's. tlen = 0 reads the rows before frame 0:
// NLL 0 for an empty label, 1e5 - ln 2 otherwise, no grad.
//
// Only such rows carry the classes. A row whose frames fit its labels
// (min(tlen, T) >= L + the number of labels equal to the one before, tlen
// >= 1: a path with no -1e5 step exists) has log Z of class 0, and there
// the classes only drop terms of class 1, which weigh 2^-1e5 = 0 beside
// any of class 0: its chains run without them, -1e30 standing for every
// -1e5 (`skip_add`, the initial rows' s >= 2), as before optax's
// semantics were followed. The choice is per row and so per block, from
// the labels, before the chain.
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
//                                alpha + beta - log Z and the classes, the
//                                row's softmax from
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
// values are shifted by r_k = M_{k-2} - r_{k-1} (M_j the max of the stored
// values of step j over its live states, below), so the offset o_k =
// o_{k-1} + r_k is the true max of step k-2 and the stored values that
// count stay within a few tens of 0, where an f32 ulp is ~4e-6 (the f32
// recursions of the first port, at |log Z| ~ 3e3, rounded ~1e-3 into the
// occupancies). The max of step k-1 is reduced while step k computes, off
// the chain.
//
// Live states. In a row without classes, M_j is taken over the states
// that can still reach a final state by the last frame (alpha) or that the
// start reaches by their frame (beta) only: `live_steps` gives each state
// the last step at which it is live, from a prefix sum of the label
// repeats. A dead state feeds only dead states and a live one is fed only
// by live ones (barred skips add -1e30), so the dead states' values,
// however high they drift above the offset, touch no live value, no
// occupancy and no log Z. Taking the max over every state instead lets the
// dead ones set the offset: on a forced alignment (as many frames as the
// labels and the blanks between equal neighbours need, so the one path
// that reaches the end is the slowest of all) the slower paths pile up
// hundreds of log2 units above the surviving one, whose values then round
// at an ulp of ~6e-5, three times a frame, for 1650 frames (the grad landed
// 8e-4 from the f64 twin's on the card at S = 2201; the CPU mirror, 1.9e-4
// there and 1.6e-3 at S = 2001). With the live max they stay near 0 and
// the error is that of any row (mirror: 5e-6 and 1.2e-5). A compensated
// (hi, lo) pair or f64 per state would fix the same drift at two to many
// times the chain's ALU work on every row; the live max costs one compare
// a state in a reduction that is off the chain, and where the max already
// sat on a live state (every frame of chip_smoke's batch) the bits do not
// move. Rows with classes keep the max over every state: their
// least-class paths leave the start at any state, so no band of few states
// carries them.
//
// Each state takes hi + log2(1 + 2^(lo1-hi) + 2^(lo2-hi)): two ex2.approx
// and one lg2.approx, of the terms of the least class. Stored: alpha and beta
// (B, T, S) f32, their classes (B, T, S) u8 (rows that need them) and one
// f64 offset per (b, t) each; log Z in f64 and its class. ops/cuda/ctc_loss.py `ctc_scheme_mirror`
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
constexpr float kLog2of3 = 1.5849625007211562f;
constexpr double kLn2 = 0.6931471805599453;
constexpr double kPenalty = 1.0e5;  // -log_epsilon of optax.ctc_loss
constexpr float kDead = 2.f;        // the class of a state no path reaches
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

// lse3 of the terms of the least class of three (class, value) terms;
// *cm the least class, at most kDead
__device__ __forceinline__ float lse3c(float a, float ca, float b, float cb,
                                      float c, float cc, float* cm) {
  const float m = fminf(fminf(ca, cb), cc);
  *cm = fminf(m, kDead);
  return lse3(ca == m ? a : kNeg2, cb == m ? b : kNeg2, cc == m ? c : kNeg2);
}

// label i of a sequence, a negative id read as 0 (as the plain twin's clamp)
__device__ __forceinline__ int label_at(const int* lab, int i) {
  return max(lab[i], 0);
}

__device__ __forceinline__ int state_token(const int* lab, int s, int blank) {
  return (s & 1) ? label_at(lab, (s - 1) / 2) : blank;
}

// skip s-2 -> s of a row without classes: 0 into a label that differs
// from the one before it, else kNeg2 (s even, s < 3, past the sequence,
// the same label)
__device__ __forceinline__ float skip_add(const int* lab, int s, int n) {
  return ((s & 1) && s >= 3 && s < n &&
          label_at(lab, (s - 1) / 2) != label_at(lab, (s - 3) / 2))
             ? 0.f
             : kNeg2;
}

// the -1e5 steps of the skip s-2 -> s: 0 into a label that differs from
// the one before, 1 into the same label, kDead where there is no skip (s
// even, s < 3, past the sequence)
__device__ __forceinline__ float skip_class(const int* lab, int s, int n) {
  if (!((s & 1) && s >= 3 && s < n)) return kDead;
  return label_at(lab, (s - 1) / 2) == label_at(lab, (s - 3) / 2) ? 1.f
                                                                   : 0.f;
}

// state s at frame 0, one step from optax's initial rows (s = 0 at class 0,
// every other state at class 1, log-prob 0): s = 0, 1 at class 0, a blank
// from two class-1 terms, a label from three (two past a repeat); *c its
// class; lp0 its log-prob at frame 0
__device__ __forceinline__ float alpha_start(const int* lab, int s, int n,
                                             float lp0, float* c) {
  if (s >= n) {
    *c = kDead;
    return kNeg2;
  }
  *c = s >= 2 ? 1.f : 0.f;
  if (s < 2) return lp0;
  if (!(s & 1)) return 1.f + lp0;
  return (skip_class(lab, s, n) == 0.f ? kLog2of3 : 1.f) + lp0;
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
  unsigned char* cls_a;  // (B, T, S) class of each alpha
  unsigned char* cls_b;  // (B, T, S) class of each beta
  int* kz;         // (B,) class of log Z
  int* order;      // (B, S) states grouped by token, s order in a group
  int* gbeg;       // (B, S + 1) start of each group in order
  int* ngroups;    // (B,)
  int* first;      // (B, S) build scratch: first state of s's token
  int* live;       // (2B, S) last live step of each state, a chain a row
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
  p = take(bts);
  if (sc) sc->cls_a = (unsigned char*)p;
  p = take(bts);
  if (sc) sc->cls_b = (unsigned char*)p;
  p = take(4 * (size_t)B);
  if (sc) sc->kz = (int*)p;
  p = take(4 * bs);
  if (sc) sc->order = (int*)p;
  p = take(4 * (bs + B));
  if (sc) sc->gbeg = (int*)p;
  p = take(4 * (size_t)B);
  if (sc) sc->ngroups = (int*)p;
  p = take(4 * bs);
  if (sc) sc->first = (int*)p;
  p = take(8 * bs);
  if (sc) sc->live = (int*)p;
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

// whether sequence b needs the classes: no frame, or fewer frames than
// its labels and the blanks between equal neighbours take (every path then
// has a -1e5 step); *reps the labels equal to the one before. Every thread
// of the block calls it.
__device__ bool needs_classes(const int* lab, int nlab, int tlen, int T,
                              int* reps) {
  __shared__ int repeats;
  if (threadIdx.x == 0) repeats = 0;
  __syncthreads();
  int r = 0;
  for (int i = 1 + threadIdx.x; i < nlab; i += blockDim.x)
    r += label_at(lab, i) == label_at(lab, i - 1);
  if (r) atomicAdd(&repeats, r);
  __syncthreads();
  *reps = repeats;
  return tlen <= 0 || min(tlen, T) < nlab + repeats;
}

// last[s], s < S: the last step of a class-free chain of `frames` steps at
// which state s is live, -1 past the sequence (ops/cuda/ctc_loss.py
// `live_steps`). With R_i the labels equal to the one before among labels
// 1 .. i (a block scan), label i is first reached at frame i + R_i and the
// blank before it at i + R_i - [label i repeats] (beta: live while its
// frame is at least that); from label i the last label is
// nlab - 1 - i + R - R_i steps away and from the blank before it one more
// (alpha: live while its frame plus that is at most frames - 1). Every
// thread of the block calls it; R the row's repeats.
__device__ void live_steps(const int* lab, int nlab, int R, int frames,
                           bool beta, int S, int* last) {
  __shared__ int wsum[32], carry;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) carry = 0;
  for (int s = threadIdx.x; s < S; s += blockDim.x) last[s] = -1;
  __syncthreads();
  for (int base = 0; base < nlab; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int rep =
        i >= 1 && i < nlab && label_at(lab, i) == label_at(lab, i - 1);
    int x = rep;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    int pre = x + carry;
    for (int w = 0; w < warp; ++w) pre += wsum[w];
    if (i < nlab) {
      const int d_lab = beta ? i + pre : nlab - 1 - i + R - pre;
      const int d_blank = beta ? d_lab - rep : d_lab + 1;
      last[2 * i + 1] = frames - 1 - d_lab;
      last[2 * i] = frames - 1 - d_blank;
    }
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = pre;
    __syncthreads();
  }
  if (threadIdx.x == 0) last[2 * nlab] = frames - 1 - (beta ? nlab + R : 0);
  __syncthreads();
}

// log2 Z of sequence b and its class from the stored alpha row of its
// last frame, or (no frame) from the rows before frame 0. kz[b] = -1
// marks a row whose chains ran without classes (class 0).
__device__ void finish_logz(const Scratch& sc, float* nll, int b, int T,
                            int S, int n, int te, bool cls, bool no_frame) {
  if (threadIdx.x != 0) return;
  int kz = 0;
  double lz;
  if (no_frame) {
    kz = n >= 2;
    lz = n >= 2 ? 1.0 : 0.0;
  } else {
    const size_t row = ((size_t)b * T + te - 1) * S;
    const float* a = sc.alpha + row;
    double a1 = a[n - 1], a2 = n >= 2 ? a[n - 2] : (double)kNeg2;
    if (cls) {
      const unsigned char* ca = sc.cls_a + row;
      const int c1 = ca[n - 1], c2 = n >= 2 ? ca[n - 2] : (int)kDead;
      kz = min(c1, c2);
      if (c1 != kz) a1 = kNeg2;
      if (c2 != kz) a2 = kNeg2;
    }
    const double hi = fmax(a1, a2), lo = fmin(a1, a2);
    lz = sc.off_a[(size_t)b * T + te - 1] + hi + log2(1.0 + exp2(lo - hi));
  }
  sc.logz[b] = lz;
  sc.kz[b] = cls ? kz : -1;
  nll[b] = (float)(kz * kPenalty - lz * kLn2);
}

struct Bound {
  float lo0, lo1, hi0, hi1, pmax;
  float clo0, clo1, chi0, chi1;  // their classes
};

// one chain held in registers: W = blockDim.x / 32 warps, lane l of warp w
// holds states s0 = (32 w + l) K .. s0 + K - 1. The steps run in groups of
// kAhead with no branch inside a group: a step past the chain's end
// computes and is dropped, so the log-prob loads of a step, issued kAhead
// steps ahead from clamped in-bounds addresses of the padded lp rows, are
// waited on only where they are used. kCls: each state carries its class
// (a row that needs_classes); else -1e30 bars every -1e5 step and the max
// of a step is over its live states (`last`, from live_steps).
template <int K, bool kBeta, bool kCls>
__device__ void chain_regs(const Scratch& sc, const int* __restrict__ lab,
                           const int* last, float* nll, int b, int n,
                           int frames, int T, int S, bool no_frame) {
  constexpr int E = kBeta ? K + 2 : K;  // log-probs a lane reads a frame
  __shared__ Bound bnd[2][kMaxWarps];
  const int W = blockDim.x / 32, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  const int s0 = (warp * 32 + lane) * K;
  const float* lpb = sc.lp + (size_t)b * T * sc.ldp;
  float* out = (kBeta ? sc.beta : sc.alpha) + (size_t)b * T * S;
  unsigned char* cout = (kBeta ? sc.cls_b : sc.cls_a) + (size_t)b * T * S;
  double* off = (kBeta ? sc.off_b : sc.off_a) + (size_t)b * T;
  // alpha: step k makes frame k from the log-probs of frame k;
  // beta: step k makes frame frames-1-k from those of frame frames-k
  auto frame_of = [&](int k) { return kBeta ? frames - 1 - k : k; };
  auto lp_frame = [&](int k) {
    return kBeta ? max(frames - k, 0) : min(k, T - 1);
  };

  // the skip into s (alpha) or into s + 2 (beta): the class it adds
  // (kCls), else 0 / kNeg2 added to its term
  float skip[K];
  float v[K], c[K];
  int kl[K];  // the last step at which state s0 + i is live
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = s0 + i;
    kl[i] = !kCls && s < S ? last[s] : -1;
    skip[i] = kCls ? skip_class(lab, kBeta ? s + 2 : s, n)
                   : skip_add(lab, kBeta ? s + 2 : s, n);
    if constexpr (kBeta) {
      const bool term = s == n - 1 || (s == n - 2 && n >= 2);
      v[i] = term ? 0.f : kNeg2;
      c[i] = term ? 0.f : kDead;
    } else if constexpr (kCls) {
      v[i] = alpha_start(lab, s, n, s < n ? lpb[s] : kNeg2, &c[i]);
    } else {
      v[i] = s < 2 ? lpb[s] : kNeg2;
      c[i] = 0.f;
    }
    if (s < S) {
      out[(size_t)frame_of(0) * S + s] = v[i];
      if constexpr (kCls)
        cout[(size_t)frame_of(0) * S + s] = (unsigned char)c[i];
    }
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
      if constexpr (kCls) {
        bnd[par][warp].clo0 = c[0];
        bnd[par][warp].clo1 = K >= 2 ? c[K >= 2 ? 1 : 0] : kDead;
      }
      bnd[par][warp].pmax = pm;
    }
    if (lane == 31) {
      bnd[par][warp].hi0 = K >= 2 ? v[K >= 2 ? K - 2 : 0] : kNeg2;
      bnd[par][warp].hi1 = v[K - 1];
      if constexpr (kCls) {
        bnd[par][warp].chi0 = K >= 2 ? c[K >= 2 ? K - 2 : 0] : kDead;
        bnd[par][warp].chi1 = c[K - 1];
      }
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
      float pm = kCls || k - 1 <= kl[0] ? v[0] : kNeg2;
#pragma unroll
      for (int i = 1; i < K; ++i)
        pm = fmaxf(pm, kCls || k - 1 <= kl[i] ? v[i] : kNeg2);
      pm = warp_max(pm);
      const int par = (k - 1) & 1;
      float ext[K + 2], ec[K + 2], nv[K], nc[K];
      if constexpr (!kBeta) {
        // ext[0] = v(s0-2), ext[1] = v(s0-1), ext[2 + i] = v(s0+i)
        float p1 = __shfl_up_sync(kFull, v[K - 1], 1);
        float p2 = K >= 2 ? __shfl_up_sync(kFull, v[K >= 2 ? K - 2 : 0], 1)
                          : __shfl_up_sync(kFull, v[0], 2);
        float q1 = kDead, q2 = kDead;
        if constexpr (kCls) {
          q1 = __shfl_up_sync(kFull, c[K - 1], 1);
          q2 = K >= 2 ? __shfl_up_sync(kFull, c[K >= 2 ? K - 2 : 0], 1)
                      : __shfl_up_sync(kFull, c[0], 2);
        }
        if (lane == 0) {
          p1 = warp > 0 ? bnd[par][warp - 1].hi1 : kNeg2;
          p2 = warp > 0 ? bnd[par][warp - 1].hi0 : kNeg2;
          if constexpr (kCls) {
            q1 = warp > 0 ? bnd[par][warp - 1].chi1 : kDead;
            q2 = warp > 0 ? bnd[par][warp - 1].chi0 : kDead;
          }
        }
        if (K == 1 && lane == 1) {  // K = 1 runs one warp
          p2 = kNeg2;
          q2 = kDead;
        }
        ext[0] = s0 >= 2 ? p2 : kNeg2;
        ext[1] = s0 >= 1 ? p1 : kNeg2;
        ec[0] = s0 >= 2 ? q2 : kDead;
        ec[1] = s0 >= 1 ? q1 : kDead;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          ext[2 + i] = v[i];
          ec[2 + i] = c[i];
        }
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if constexpr (kCls) {
            float cm;
            const float x = lse3c(ext[2 + i], ec[2 + i], ext[1 + i],
                                  ec[1 + i], ext[i], ec[i] + skip[i], &cm);
            const bool live = s0 + i < n && cm < kDead;
            nv[i] = live ? x + pre[j][i] - r : kNeg2;
            nc[i] = live ? cm : kDead;
          } else {
            nv[i] = lse3(ext[2 + i], ext[1 + i], ext[i] + skip[i]) +
                    pre[j][i] - r;
          }
        }
      } else {
        // ext[i] = z(s0+i) = v + lp, i < K + 2
        float n1 = __shfl_down_sync(kFull, v[0], 1);
        float n2 = K >= 2 ? __shfl_down_sync(kFull, v[K >= 2 ? 1 : 0], 1)
                          : __shfl_down_sync(kFull, v[0], 2);
        float m1 = kDead, m2 = kDead;
        if constexpr (kCls) {
          m1 = __shfl_down_sync(kFull, c[0], 1);
          m2 = K >= 2 ? __shfl_down_sync(kFull, c[K >= 2 ? 1 : 0], 1)
                      : __shfl_down_sync(kFull, c[0], 2);
        }
        if (lane == 31) {
          n1 = warp + 1 < W ? bnd[par][warp + 1].lo0 : kNeg2;
          n2 = warp + 1 < W ? bnd[par][warp + 1].lo1 : kNeg2;
          if constexpr (kCls) {
            m1 = warp + 1 < W ? bnd[par][warp + 1].clo0 : kDead;
            m2 = warp + 1 < W ? bnd[par][warp + 1].clo1 : kDead;
          }
        }
#pragma unroll
        for (int i = 0; i < K; ++i) {
          ext[i] = v[i] + pre[j][i];
          ec[i] = c[i];
        }
        ext[K] = (s0 + K < S ? n1 : kNeg2) + pre[j][K];
        ext[K + 1] = (s0 + K + 1 < S ? n2 : kNeg2) + pre[j][K + 1];
        ec[K] = s0 + K < S ? m1 : kDead;
        ec[K + 1] = s0 + K + 1 < S ? m2 : kDead;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if constexpr (kCls) {
            float cm;
            const float x = lse3c(ext[i], ec[i], ext[i + 1], ec[i + 1],
                                  ext[i + 2], ec[i + 2] + skip[i], &cm);
            const bool live = s0 + i < n && cm < kDead;
            nv[i] = live ? x - r : kNeg2;
            nc[i] = live ? cm : kDead;
          } else {
            nv[i] = lse3(ext[i], ext[i + 1], ext[i + 2] + skip[i]) - r;
          }
        }
      }
      const int f = frame_of(k);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        v[i] = act ? nv[i] : v[i];
        if constexpr (kCls) c[i] = act ? nc[i] : c[i];
        if (act && s0 + i < S) {
          out[(size_t)f * S + s0 + i] = v[i];
          if constexpr (kCls)
            cout[(size_t)f * S + s0 + i] = (unsigned char)c[i];
        }
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
    finish_logz(sc, nll, b, T, S, n, frames, kCls, no_frame);
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
  int R;
  const bool cls = needs_classes(lab, label_lens[b], tlen, T, &R);
  const int frames = beta ? beta_frames(tlen, T) : alpha_frames(tlen, T);
  if (frames == 0) return;
  int* last = sc.live + (size_t)blockIdx.x * S;
  if (!cls) live_steps(lab, label_lens[b], R, frames, beta, S, last);
  if (beta) {
    if (cls)
      chain_regs<K, true, true>(sc, lab, last, nll, b, n, frames, T, S,
                                false);
    else
      chain_regs<K, true, false>(sc, lab, last, nll, b, n, frames, T, S,
                                 false);
  } else {
    if (cls)
      chain_regs<K, false, true>(sc, lab, last, nll, b, n, frames, T, S,
                                 tlen <= 0);
    else
      chain_regs<K, false, false>(sc, lab, last, nll, b, n, frames, T, S,
                                  false);
  }
}

// past 2048 states: kWideThreads threads strided over the states, the
// previous frame's row read back from device memory; same arithmetic, the
// classes or the live max as the row needs them
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
  int R;
  const bool cls = needs_classes(lab, label_lens[b], tlen, T, &R);
  const int frames = beta ? beta_frames(tlen, T) : alpha_frames(tlen, T);
  if (frames == 0) return;
  int* last = sc.live + (size_t)blockIdx.x * S;
  if (!cls) live_steps(lab, label_lens[b], R, frames, beta, S, last);
  const float* lpb = sc.lp + (size_t)b * T * sc.ldp;
  float* out = (beta ? sc.beta : sc.alpha) + (size_t)b * T * S;
  unsigned char* cout = (beta ? sc.cls_b : sc.cls_a) + (size_t)b * T * S;
  double* off = (beta ? sc.off_b : sc.off_a) + (size_t)b * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  const int f0 = beta ? frames - 1 : 0;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float c, v;
    if (beta) {
      const bool term = s == n - 1 || (s == n - 2 && n >= 2);
      v = term ? 0.f : kNeg2;
      c = term ? 0.f : kDead;
    } else if (cls) {
      v = alpha_start(lab, s, n, s < n ? lpb[s] : kNeg2, &c);
    } else {
      v = s < 2 ? lpb[s] : kNeg2;
    }
    out[(size_t)f0 * S + s] = v;
    if (cls) cout[(size_t)f0 * S + s] = (unsigned char)c;
  }
  if (threadIdx.x == 0) off[f0] = 0.0;
  __syncthreads();
  double o = 0.0;
  float r_prev = 0.f, m_prev = 0.f;
  for (int k = 1; k < frames; ++k) {
    const float r = k >= 2 ? m_prev - r_prev : 0.f;
    const int f = beta ? frames - 1 - k : k, fp = beta ? f + 1 : f - 1;
    const float* prev = out + (size_t)fp * S;
    const unsigned char* cprev = cout + (size_t)fp * S;
    const float* lp = lpb + (size_t)(beta ? fp : f) * sc.ldp;
    float pm = kNeg2;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float p0 = prev[s];
      if (cls || k - 1 <= last[s]) pm = fmaxf(pm, p0);
      float nv, cm = 0.f;
      if (!beta) {
        const float p1 = s >= 1 ? prev[s - 1] : kNeg2;
        const float p2 = s >= 2 ? prev[s - 2] : kNeg2;
        if (cls) {
          const float c1 = s >= 1 ? (float)cprev[s - 1] : kDead;
          const float c2 = s >= 2 ? (float)cprev[s - 2] : kDead;
          nv = lse3c(p0, (float)cprev[s], p1, c1, p2,
                     c2 + skip_class(lab, s, n), &cm);
        } else {
          nv = lse3(p0, p1, p2 + skip_add(lab, s, n));
        }
        nv += lp[s] - r;
      } else {
        const float z0 = p0 + lp[s];
        const float z1 = s + 1 < S ? prev[s + 1] + lp[s + 1] : 2 * kNeg2;
        const float z2 = s + 2 < S ? prev[s + 2] + lp[s + 2] : 2 * kNeg2;
        if (cls) {
          const float c1 = s + 1 < S ? (float)cprev[s + 1] : kDead;
          const float c2 = s + 2 < S ? (float)cprev[s + 2] : kDead;
          nv = lse3c(z0, (float)cprev[s], z1, c1, z2,
                     c2 + skip_class(lab, s + 2, n), &cm);
        } else {
          nv = lse3(z0, z1, z2 + skip_add(lab, s + 2, n));
        }
        nv -= r;
      }
      if (cls) {
        const bool live = s < n && cm < kDead;
        out[(size_t)f * S + s] = live ? nv : kNeg2;
        cout[(size_t)f * S + s] = (unsigned char)(live ? cm : kDead);
      } else {
        out[(size_t)f * S + s] = nv;
      }
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
  if (!beta) finish_logz(sc, nll, b, T, S, n, frames, cls, tlen <= 0);
}

// -------------------------------------------------------------------------
// backward: occupancies, softmax row, grouped scatter
// -------------------------------------------------------------------------

// occupancy of state s in row (b, t): 2^min(alpha + beta + c, 0) where
// the classes of alpha and beta add up to log Z's (kz < 0: a row without
// classes), else 0
__device__ __forceinline__ float occupancy(const float* a, const float* be,
                                           const unsigned char* ca,
                                           const unsigned char* cb, int s,
                                           float c, int kz) {
  return kz < 0 || ca[s] + cb[s] == kz ? ex2(fminf(a[s] + be[s] + c, 0.f))
                                       : 0.f;
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
  const unsigned char* ca = sc.cls_a + (size_t)row * S;
  const unsigned char* cb = sc.cls_b + (size_t)row * S;
  const int kz = sc.kz[b];
  const float c = (float)(sc.off_a[row] + sc.off_b[row] - sc.logz[b]);
  float occ = 0.f;
  for (int s = threadIdx.x; s < n; s += blockDim.x)
    occ += occupancy(a, be, ca, cb, s, c, kz);
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
    for (int j = j0; j < j1; ++j)
      sum += occupancy(a, be, ca, cb, order[j], c, kz);
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
