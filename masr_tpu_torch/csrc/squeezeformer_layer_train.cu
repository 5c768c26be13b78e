// Squeezeformer encoder layer for TRAINING on Hopper (sm_90a), f32, with
// the layer_norm conv module: a forward with dropout at the layer's seven
// sites and a hand-written backward.
//
// Replaces the TPU kernel
// masr_tpu/ops/pallas/squeezeformer_layer_train.py:608
// (`fused_squeezeformer_layer_train`: `_sq_half1` :434 and `_sq_half2`
// :512, four pallas_calls). The post-norm layer, LN_i with eps 1e-6:
//
//   x1 = LN1(x  + drop(MHSA(ada0 x)))     rel-pos, (B, T', T') chunk mask
//   x2 = LN2(x1 + drop(FFN1(ada1 x1)))    D -> F -> D, SiLU
//   x3 = LN3(x2 + drop(Conv(ada2 x2)))    GLU -> depthwise(k) -> LN (its own
//                                         affine, eps 1e-5) -> SiLU -> pw2
//   y  = LN4(x3 + drop(FFN2(ada3 x3)))
//
// The TPU split the layer into two halves with staged recompute to fit 16
// MB of VMEM; here, as in conformer_layer_train.cu, the forward SAVES what
// the backward needs (the five LayerNorms' x-hat and 1/std, x1..x3, the
// conv input, the FFN pre-activations and hidden rows, q/k/v, the
// attention probabilities before and after dropout, the pw1 output, the
// conv LN's output) and the backward recomputes nothing but the GLU rows
// and the dropout masks: about 45 (B*T', D) f32 arrays plus 2 (h, B, T',
// T') per layer, 145 MB at B=8, T'=299. No FFN is run again.
//
// AdaptiveScale. ada0, ada1 and ada3 are folded into the q/k/v and w_1
// weights and biases (ops/cuda/squeezeformer_layer.py pack_sq_layer_params,
// the serving kernel's pack): (x s + t) W + b = x (diag(s) W) + (t W + b).
// The training layer builds that pack with grad enabled, so autograd turns
// this kernel's grads of the folded arrays into the grads of s and t. ada2
// cannot be folded: rows t >= len are zeroed AFTER it, so it stays a
// masked affine (common.cuh's ada_rows) whose grads are column sums over
// the valid rows (sum da x2, sum da). This design, rather than the TPU
// kernel's four separate `adaw` affines, lets one pack and one set of
// blocks serve both Squeezeformer layer kernels and the Conformer's: the
// attention and FFN blocks take folded weights unchanged.
//
// Two C entries, one ctypes call each per layer and direction:
//   masr_sq_layer_train_forward   ~22 launches
//   masr_sq_layer_train_backward  ~60 launches
// built from common.cuh's LayerNorm and ada_rows and training.cuh's blocks
// (att_fwd / att_bwd, ffn_fwd / ffn_bwd, conv_fwd / conv_bwd, ln_bwd,
// colsum, the products with their epilogue), plus ada_bwd_kernel below.
// Each residual sum x + drop(sub) is written by its sublayer's last
// product (epilogue R = x) into one scratch array, which the next
// LayerNorm reads. Parameter grads come from one product (split over K in
// a fixed order on few tiles) or one column sum over all B*T' rows:
// deterministic, no atomics.
//
// Dropout: common.cuh's dropout_mult hash of (seed[b], layer, site, b, row,
// col), so the backward regenerates the forward's masks and the plain twin
// (ops/cuda/squeezeformer_layer_train.py) draws the same ones. Sites, as
// the Conformer's with FFN1 in the macaron FFN's place: 0 FFN1 hidden
// (t, f), 1 FFN1 out (t, d), 2 attention probs (h*T'+t1, t2), 3 attention
// out, 4 conv out, 5 FFN2 hidden, 6 FFN2 out.
//
// Semantics kept from the Pallas kernel: a (B, T', T') int8 attention mask
// (dynamic chunk + padding), a row with no visible key gives probability 0
// (at half rate, chunk_masks[:, ::2, ::2] with an odd T' gives such rows);
// rows t >= len enter pw1 as zeros after ada2 (no ada2 grad from them) and
// add nothing after pw2; causal conv pad rows carry GLU(pw1 bias), so their
// grad goes into pw1's bias; the four post-norm LayerNorms run on every
// row, padded ones included.
//
// What bounds it on the H100: ~3x the forward's operations (13.4 GFLOP at
// B=8, T'=299 full rate: the eight products, 90% of them; 6.4 GFLOP at
// T'=150), so operations: 0.35 ms at f32's 67 TFLOP/s, 0.14 ms at
// 3xTF32's 165 (a third of TF32's 495). Every product runs training.cuh's
// tensor-core loop (common.cuh's gemm_tc_kernel, 3xTF32, f32 accuracy),
// shared with conformer_layer_train.cu. Left for later: wgmma / TMA
// products, a fused flash-style attention that does not materialise (T',
// T'), fewer launches (the host leaves the card idle most of a step),
// conv_pad_grad_kernel's serial loop.

#include "training.cuh"

namespace {

enum Site {
  kSiteFfn1Hidden = 0,
  kSiteFfn1Out = 1,
  kSiteAttProb = 2,
  kSiteAttOut = 3,
  kSiteConvOut = 4,
  kSiteFfn2Hidden = 5,
  kSiteFfn2Out = 6
};

// dx (M, D) = base + da * ada[0] in rows t = row % T < lens[row / T], base
// alone past an utterance's length: the grad through ada2's masked affine
__global__ void ada_bwd_kernel(const float* __restrict__ base,
                               const float* __restrict__ da,
                               const float* __restrict__ ada,
                               float* __restrict__ dx,
                               const int* __restrict__ lens, int T, int D,
                               size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / D;
    const int c = (int)(i % D);
    dx[i] = base[i] +
            ((int)(row % T) < lens[row / T] ? da[i] * ada[c] : 0.f);
  }
}

// ------------------------------------------------------------------------
// Saved activations, offsets in floats (M = B*T). The forward writes them,
// the backward reads them. xhat / rstd 0..3: LN1..LN4, 4: the conv LN.
// ------------------------------------------------------------------------
struct Saved {
  size_t xhat[5], rstd[5], x1, x2, x3, a2, g, cn, y3, z0, h0, z1, h1, qu, qv,
      k, v, o, P, Pd, sum, bias_uv, total;
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
  for (int i = 0; i < 5; ++i) {
    s.xhat[i] = take(MD);
    s.rstd[i] = take(M);
  }
  s.x1 = take(MD);
  s.x2 = take(MD);
  s.x3 = take(MD);
  s.a2 = take(MD);
  s.g = take(2 * MD);
  s.cn = take(MD);
  s.y3 = take(MD);
  s.z0 = take(MF);
  s.h0 = take(MF);
  s.z1 = take(MF);
  s.h1 = take(MF);
  s.qu = take(MD);
  s.qv = take(MD);
  s.k = take(MD);
  s.v = take(MD);
  s.o = take(MD);
  s.P = take(PP);
  s.Pd = take(PP);
  s.sum = take(MD);
  s.bias_uv = take(2 * (size_t)D);
  s.total = off;
  return s;
}

// backward scratch: the residual grads r0, r1 and t0..t5 (M, D), dh (M, F),
// dg (M, 2D), dP (h, B, T, T), and the split-K slices of the largest
// weight grad
struct Scratch {
  size_t r[2], t[6], dh, dg, dP, part, total;
};

Scratch scratch_layout(int B, int T, int D, int F, int H) {
  const size_t M = (size_t)B * T, MD = M * D;
  Scratch s;
  size_t off = 0;
  for (int i = 0; i < 2; ++i) {
    s.r[i] = off;
    off += MD;
  }
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
  off += splitk_part_floats(B * T, D, F);
  s.total = off;
  return s;
}

AttBufs att_bufs(float* S, const Saved& L) {
  return {S + L.qu, S + L.qv, S + L.k, S + L.v, S + L.o, S + L.P, S + L.Pd,
          S + L.bias_uv};
}

ConvBufs conv_bufs(float* S, const Saved& L) {
  return {S + L.g, S + L.cn, S + L.xhat[4], S + L.rstd[4], S + L.y3};
}

}  // namespace

extern "C" size_t masr_sq_layer_train_saved_floats(int B, int T, int D,
                                                   int F, int H) {
  return saved_layout(B, T, D, F, H).total;
}

extern "C" size_t masr_sq_layer_train_scratch_floats(int B, int T, int D,
                                                     int F, int H) {
  return scratch_layout(B, T, D, F, H).total;
}

// Packed weights as ops/cuda/squeezeformer_layer.py pack_sq_layer_params of
// a layer_norm conv layer (f32, row-major, contiguous): lnw (4,2,D) LN1..LN4;
// ada (2,D) ada2; cnw (2,D) the conv LN; attw (4,D,D) q,k,v (ada0 folded),
// out; vecb (8,D) q,k,v,out biases, FFN1 and FFN2 w_2 biases, depthwise
// bias, pw2 bias; posb (2,D); ffw1 (2,D,F), ffb1 (2,F) (ada1, ada3
// folded); ffw2 (2,F,D); pw1w (D,2D) pw1b (1,2D) pw2w (D,D) dww (k,D).
// mask (B,T,T) u8, seeds (B,) i32 (this layer's), lens (B,) i32, posp (T,D)
// = linear_pos(pos_emb). thresh / keep_scale: dropout at the six
// non-attention sites, att_*: at the attention probabilities (thresh 0 =
// no dropout). eps: the layer LNs'; conv_eps: the conv LN's. saved:
// masr_sq_layer_train_saved_floats floats.
extern "C" int masr_sq_layer_train_forward(
    const float* x, const unsigned char* mask, const int* seeds,
    const int* lens, const float* posp, const float* lnw, const float* ada,
    const float* cnw, const float* attw, const float* vecb,
    const float* posb, const float* ffw1, const float* ffb1,
    const float* ffw2, const float* pw1w, const float* pw1b,
    const float* pw2w, const float* dww, float* out, float* saved, int B,
    int T, int D, int F, int n_head, int ksize, int causal, int layer,
    unsigned thresh, float keep_scale, unsigned att_thresh,
    float att_keep_scale, float eps, float conv_eps, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  if ((D / H) * H != D || (!causal && ksize % 2 == 0))
    return (int)cudaErrorInvalidValue;
  const Saved L = saved_layout(B, T, D, F, H);
  const size_t MD = (size_t)M * D, DF = (size_t)D * F;
  float* S = saved;
  float* sum = S + L.sum;
  auto drop = [&](int site) {
    return make_drop(seeds, layer, site, thresh, keep_scale);
  };

  // x1 = LN1(x + drop(MHSA(x))), ada0 folded into q/k/v
  MASR_CHECK(att_fwd(x, attw, vecb, posb, posp, mask, att_bufs(S, L), x, sum,
                     make_drop(seeds, layer, kSiteAttProb, att_thresh,
                               att_keep_scale),
                     drop(kSiteAttOut), B, T, D, H, st));
  MASR_CHECK(layer_norm(sum, S + L.x1, lnw, 0, M, D, eps, nullptr, T, st,
                        S + L.xhat[0], S + L.rstd[0]));
  // x2 = LN2(x1 + drop(FFN1(x1))), ada1 folded into w_1
  MASR_CHECK(ffn_fwd(S + L.x1, sum, S + L.x1, S + L.z0, S + L.h0, ffw1, ffb1,
                     ffw2, vecb + 4 * D, M, D, F, T, 1.f,
                     drop(kSiteFfn1Hidden), drop(kSiteFfn1Out), st));
  MASR_CHECK(layer_norm(sum, S + L.x2, lnw, 1, M, D, eps, nullptr, T, st,
                        S + L.xhat[1], S + L.rstd[1]));
  // x3 = LN3(x2 + drop(Conv(ada2 x2))), the conv input's rows >= len zero
  MASR_CHECK(ada_rows(S + L.x2, S + L.a2, ada, lens, T, D, (long long)MD,
                      st));
  MASR_CHECK(conv_fwd(S + L.a2, pw1w, pw1b, dww, vecb + 6 * D, cnw, pw2w,
                      vecb + 7 * D, conv_bufs(S, L), S + L.x2, sum, lens,
                      drop(kSiteConvOut), B, T, D, ksize, causal, conv_eps,
                      st));
  MASR_CHECK(layer_norm(sum, S + L.x3, lnw, 2, M, D, eps, nullptr, T, st,
                        S + L.xhat[2], S + L.rstd[2]));
  // y = LN4(x3 + drop(FFN2(x3))), ada3 folded into w_1
  MASR_CHECK(ffn_fwd(S + L.x3, sum, S + L.x3, S + L.z1, S + L.h1, ffw1 + DF,
                     ffb1 + F, ffw2 + DF, vecb + 5 * D, M, D, F, T, 1.f,
                     drop(kSiteFfn2Hidden), drop(kSiteFfn2Out), st));
  MASR_CHECK(layer_norm(sum, out, lnw, 3, M, D, eps, nullptr, T, st,
                        S + L.xhat[3], S + L.rstd[3]));
  return (int)cudaGetLastError();
}

// dy (B,T,D) -> dx (B,T,D), dposp (T,D) and the grads of the 13 packed
// arrays (same shapes, every element written). x: the forward's input;
// saved: the forward's; scratch: masr_sq_layer_train_scratch_floats
// floats.
extern "C" int masr_sq_layer_train_backward(
    const float* dy, const float* x, const int* seeds, const int* lens,
    const float* posp, const float* lnw, const float* ada, const float* cnw,
    const float* attw, const float* ffw1, const float* ffw2,
    const float* pw1w, const float* pw1b, const float* pw2w,
    const float* dww, float* saved, float* scratch, float* dx, float* dposp,
    float* dlnw, float* dada, float* dcnw, float* dattw, float* dvecb,
    float* dposb, float* dffw1, float* dffb1, float* dffw2, float* dpw1w,
    float* dpw1b, float* dpw2w, float* ddww, int B, int T, int D, int F,
    int n_head, int ksize, int causal, int layer, unsigned thresh,
    float keep_scale, unsigned att_thresh, float att_keep_scale,
    void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  if ((D / H) * H != D || (!causal && ksize % 2 == 0))
    return (int)cudaErrorInvalidValue;
  const Saved L = saved_layout(B, T, D, F, H);
  const Scratch W = scratch_layout(B, T, D, F, H);
  const size_t MD = (size_t)M * D, DF = (size_t)D * F;
  float* S = saved;
  float *r0 = scratch + W.r[0], *r1 = scratch + W.r[1];
  float* t[6];
  for (int i = 0; i < 6; ++i) t[i] = scratch + W.t[i];
  float *dh = scratch + W.dh, *dg = scratch + W.dg, *dP = scratch + W.dP,
        *part = scratch + W.part;
  auto drop = [&](int site) {
    return make_drop(seeds, layer, site, thresh, keep_scale);
  };

  // LN4, FFN2: r0 = ds4, r1 = dx3 = ds4 + FFN2's input grad
  MASR_CHECK(ln_bwd(dy, S + L.xhat[3], S + L.rstd[3], lnw, dlnw, 3, nullptr,
                    r0, M, D, nullptr, T, st));
  MASR_CHECK(ffn_bwd(r0, S + L.x3, S + L.z1, S + L.h1, ffw1 + DF, ffw2 + DF,
                     dffw1 + DF, dffb1 + F, dffw2 + DF, dvecb + 5 * D, t[0],
                     dh, r0, r1, part, M, D, F, T, 1.f,
                     drop(kSiteFfn2Hidden), drop(kSiteFfn2Out), st));

  // LN3, conv module: r0 = ds3, t[3] = the grad of the conv input, r1 =
  // dx2 = ds3 + its grad through ada2 in the valid rows
  MASR_CHECK(ln_bwd(r1, S + L.xhat[2], S + L.rstd[2], lnw, dlnw, 2, nullptr,
                    r0, M, D, nullptr, T, st));
  MASR_CHECK(conv_bwd(r0, S + L.a2, conv_bufs(S, L), pw1w, pw1b, dww, cnw,
                      pw2w, lens, drop(kSiteConvOut), dpw2w, dvecb + 7 * D,
                      dcnw, dvecb + 6 * D, ddww, dpw1b, dpw1w, t[3], t, dg,
                      part, B, T, D, ksize, causal, st));
  MASR_CHECK(colsum(t[3], S + L.x2, dada, M, D, lens, T, st));
  MASR_CHECK(colsum(t[3], nullptr, dada + D, M, D, lens, T, st));
  ada_bwd_kernel<<<blocks_for(MD, 256), 256, 0, st>>>(r0, t[3], ada, r1,
                                                      lens, T, D, MD);
  MASR_CHECK(cudaGetLastError());

  // LN2, FFN1: r0 = ds2, r1 = dx1
  MASR_CHECK(ln_bwd(r1, S + L.xhat[1], S + L.rstd[1], lnw, dlnw, 1, nullptr,
                    r0, M, D, nullptr, T, st));
  MASR_CHECK(ffn_bwd(r0, S + L.x1, S + L.z0, S + L.h0, ffw1, ffw2, dffw1,
                     dffb1, dffw2, dvecb + 4 * D, t[0], dh, r0, r1, part, M,
                     D, F, T, 1.f, drop(kSiteFfn1Hidden),
                     drop(kSiteFfn1Out), st));

  // LN1, attention: r0 = ds1, dx = ds1 + the attention's input grad
  MASR_CHECK(ln_bwd(r1, S + L.xhat[0], S + L.rstd[0], lnw, dlnw, 0, nullptr,
                    r0, M, D, nullptr, T, st));
  MASR_CHECK(att_bwd(r0, x, attw, posp, att_bufs(S, L),
                     make_drop(seeds, layer, kSiteAttProb, att_thresh,
                               att_keep_scale),
                     drop(kSiteAttOut), dattw, dvecb, dposb, dposp, r0, dx, t,
                     dP, part, B, T, D, H, st));
  return (int)cudaGetLastError();
}
