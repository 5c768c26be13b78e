// Conformer encoder layer for TRAINING on Hopper (sm_90a), f32 or bf16: a
// forward with dropout at the layer's seven sites and a hand-written
// backward.
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
// Two C entries per operand mode, one ctypes call each per layer and
// direction:
//   masr_conformer_layer_train_forward(_bf16)   ~21 launches (~25 in bf16)
//   masr_conformer_layer_train_backward(_bf16)  ~55 launches (~61 in bf16)
// The bf16 mode is the Pallas kernel's at compute dtype bf16 (`cdt =
// x_ref.dtype`, :171, :197, :362, :393): x, posp, the output and the five
// product weights (ffw1, ffw2, attw, pw1w, pw2w) are bf16, the LN, bias,
// depthwise and position-bias rows f32. It runs train_wgmma.cuh's blocks:
// every product of bf16 operands in device memory (TMA tiles, wgmma, f32
// sums); the weights are read as the pack holds them, and each activation
// that a product reads is written as bf16 by the kernel that makes it
// (rounding on write, where the f32 mode's tiles would round on read), so
// `saved` keeps the product operands as bf16 and an f32 copy only where
// an f32 reader needs one. The forward copies the bf16 weights and posp
// into `saved` (the backward's C entry takes no weight pointers). Rounded
// to bf16 where masr_tpu's kernel stores x's dtype:
//   - x2 = x1 + att, the input of the second half (its :598 returns it as
//     x.dtype), by the attention's output product;
//   - x4, the final LN's input, which half 2 saves as x.dtype (:386): the
//     output is LN(x4) of the unrounded rows, rounded once to bf16, and the
//     saved x-hat and 1/std, which the backward reads, are of bf16(x4);
//   - the grad of x2 on the way back (half 2's dx is x.dtype) and dx;
//   - the grads of the five bf16 weights and of posp, which masr_tpu casts
//     to the pack's dtype (:575, :654): each summed in f32 over every row
//     and rounded once; the f32 arrays' grads stay f32.
// dq rounds k + posp as one operand (masr_tpu's _mm(dS, kh + ph, cdt)).
// built from common.cuh's LayerNorm and training.cuh's blocks: the
// products (common.cuh's tensor-core GEMM gemm_tc_kernel, 3xTF32 mma.sync
// through a cp.async ring, with training.cuh's epilogue Epi: bias,
// SiLU saving the pre-activation, x dSiLU(aux), dropout, row mask, scaled
// residual; weight grads split over K on few tiles), ffn_fwd / ffn_bwd,
// att_fwd / att_bwd (masked softmax over the (B, T', T') chunk mask with
// attention-probability dropout), conv_fwd / conv_bwd (common.cuh's GLU +
// depthwise conv + LN + SiLU, saving the LN's output, x-hat and 1/std),
// ln_bwd, and the column sums of the bias and LayerNorm grads. Parameter
// grads come from one product (split over K in a fixed order on few tiles)
// or one column sum over all B*T' rows: deterministic, no atomics.
//
// Dropout: common.cuh's dropout_mult hash of (seed[b], layer, site, row0 +
// b, row, col), row0 the global batch row of utterance 0 (so a row draws
// the same mask whichever data-parallel rank runs it), so the backward
// regenerates the forward's masks and the plain twin
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
// B=8, T'=299), so operations: 0.35 ms at f32's 67 TFLOP/s, 0.14 ms at
// 3xTF32's 165 (a third of TF32's 495), 0.024 ms in bf16 at 989. The f32
// products, ~91% of the work, run on the tensor cores in 3xTF32 (f32
// accuracy: one TF32 product would miss the layer's tolerances,
// tests/test_torch_tf32.py), the bf16 mode's on wgmma; the rest (column
// sums of one block per 32 columns, the softmax over materialised (T', T')
// scores, elementwise passes) on the FMA pipes. Left for later: wgmma
// products in the f32 route (TF32 wgmma takes only K-major operands from
// shared memory, so the transposed operands of mm_nn / mm_tn would need a
// transposing pass), fused flash-style attention that does not
// materialise (T', T').

#include "training.cuh"

namespace {

enum Site {
  kSiteMacaronHidden = 0,
  kSiteMacaronOut = 1,
  kSiteAttProb = 2,
  kSiteAttOut = 3,
  kSiteConvOut = 4,
  kSiteFfnHidden = 5,
  kSiteFfnOut = 6
};

// ------------------------------------------------------------------------
// Saved activations of the f32 mode, offsets in floats (M = B*T). The
// forward writes them, the backward reads them.
// ------------------------------------------------------------------------
struct Saved {
  size_t xhat[6], rstd[6], y[5], cn, z0, h0, z1, h1, qu, qv, k, v, o, g, P,
      Pd, xw, bias_uv;
  size_t total;
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
  size_t dxw, t[6], dh, dg, dP, part;
  size_t total;
};

Scratch scratch_layout(int B, int T, int D, int F, int H) {
  const size_t M = (size_t)B * T, MD = M * D;
  Scratch s;
  size_t off = 0;
  auto take = [&off](size_t n) {
    const size_t o = off;
    off += n;
    return o;
  };
  s.dxw = take(MD);
  for (int i = 0; i < 6; ++i) s.t[i] = take(MD);
  s.dh = take(M * F);
  s.dg = take(2 * MD);
  s.dP = take((size_t)H * B * T * T);
  s.part = take(splitk_part_floats(B * T, D, F));
  s.total = off;
  return s;
}

AttBufs att_bufs(float* S, const Saved& L) {
  return {S + L.qu, S + L.qv, S + L.k, S + L.v, S + L.o, S + L.P, S + L.Pd,
          S + L.bias_uv};
}

ConvBufs conv_bufs(float* S, const Saved& L) {
  return {S + L.g, S + L.cn, S + L.xhat[3], S + L.rstd[3], S + L.y[3]};
}

// the layer's arrays as the blocks read them (f32), and its grads
struct Weights {
  const float *posp, *lnw, *ffw1, *ffb1, *ffw2, *vecb, *attw, *posb, *pw1w,
      *pw1b, *pw2w, *dww;
};

struct Grads {
  float *dposp, *dlnw, *dffw1, *dffb1, *dffw2, *dvecb, *dattw, *dposb,
      *dpw1w, *dpw1b, *dpw2w, *ddww;
};


// The forward from the input rows in S + L.xw (f32; the residual stream,
// overwritten) into out, saving what the backward reads.
cudaError_t forward_rows(float* S, const Saved& L, const unsigned char* mask,
                         const int* seeds, const int* lens, const Weights& w,
                         float* out, const Dims& d, float ff_scale, float eps,
                         cudaStream_t st) {
  const int B = d.B, T = d.T, D = d.D, F = d.F, H = d.H, M = B * T;
  const size_t DF = (size_t)D * F;
  float* xw = S + L.xw;
  auto drop = [&](int site) {
    return make_drop(seeds, d.layer, site, d.thresh, d.keep_scale,
                     d.row0);
  };

  // macaron FFN (x ff_scale)
  TRY(layer_norm(xw, S + L.y[0], w.lnw, 0, M, D, eps, nullptr, T, st,
                 S + L.xhat[0], S + L.rstd[0]));
  TRY(ffn_fwd(xw, xw, S + L.y[0], S + L.z0, S + L.h0, w.ffw1, w.ffb1,
              w.ffw2, w.vecb, M, D, F, T, ff_scale,
              drop(kSiteMacaronHidden), drop(kSiteMacaronOut), st));

  // rel-pos MHSA
  TRY(layer_norm(xw, S + L.y[1], w.lnw, 1, M, D, eps, nullptr, T, st,
                 S + L.xhat[1], S + L.rstd[1]));
  TRY(att_fwd(S + L.y[1], w.attw, w.vecb + 2 * D, w.posb, w.posp, mask,
              att_bufs(S, L), xw, xw,
              make_drop(seeds, d.layer, kSiteAttProb, d.att_thresh,
                        d.att_keep_scale, d.row0),
              drop(kSiteAttOut), B, T, D, H, st));

  // conv module: LN (rows >= len zeroed) -> pw1 -> GLU + depthwise -> LN ->
  // SiLU -> pw2 (rows >= len zeroed)
  TRY(layer_norm(xw, S + L.y[2], w.lnw, 2, M, D, eps, lens, T, st,
                 S + L.xhat[2], S + L.rstd[2]));
  TRY(conv_fwd(S + L.y[2], w.pw1w, w.pw1b, w.dww, w.vecb + 6 * D,
               w.lnw + 3 * 2 * D, w.pw2w, w.vecb + 7 * D, conv_bufs(S, L),
               xw, xw, lens, drop(kSiteConvOut), B, T, D, d.ksize, d.causal,
               eps, st));

  // FFN (x ff_scale), final LN
  TRY(layer_norm(xw, S + L.y[4], w.lnw, 4, M, D, eps, nullptr, T, st,
                 S + L.xhat[4], S + L.rstd[4]));
  TRY(ffn_fwd(xw, xw, S + L.y[4], S + L.z1, S + L.h1, w.ffw1 + DF,
              w.ffb1 + F, w.ffw2 + DF, w.vecb + D, M, D, F, T, ff_scale,
              drop(kSiteFfnHidden), drop(kSiteFfnOut), st));
  return layer_norm(xw, out, w.lnw, 5, M, D, eps, nullptr, T, st,
                    S + L.xhat[5], S + L.rstd[5]);
}

// The backward from dy (f32 rows) into dx (f32 rows) and the grads (every
// element written).
cudaError_t backward_rows(const float* dy, float* S, const Saved& L,
                          float* scratch, const Scratch& W, const int* seeds,
                          const int* lens, const Weights& w, const Grads& g,
                          float* dx, const Dims& d, float ff_scale,
                          cudaStream_t st) {
  const int B = d.B, T = d.T, D = d.D, F = d.F, H = d.H, M = B * T;
  const size_t DF = (size_t)D * F;
  float* dxw = scratch + W.dxw;
  float* t[6];
  for (int i = 0; i < 6; ++i) t[i] = scratch + W.t[i];
  float *dh = scratch + W.dh, *dg = scratch + W.dg, *dP = scratch + W.dP,
        *part = scratch + W.part;
  auto drop = [&](int site) {
    return make_drop(seeds, d.layer, site, d.thresh, d.keep_scale,
                     d.row0);
  };

  // final LN, FFN
  TRY(ln_bwd(dy, S + L.xhat[5], S + L.rstd[5], w.lnw, g.dlnw, 5, nullptr,
             dxw, M, D, nullptr, T, st));
  TRY(ffn_bwd(dxw, S + L.y[4], S + L.z1, S + L.h1, w.ffw1 + DF, w.ffw2 + DF,
              g.dffw1 + DF, g.dffb1 + F, g.dffw2 + DF, g.dvecb + D, t[0], dh,
              nullptr, t[1], part, M, D, F, T, ff_scale,
              drop(kSiteFfnHidden), drop(kSiteFfnOut), st));
  TRY(ln_bwd(t[1], S + L.xhat[4], S + L.rstd[4], w.lnw, g.dlnw, 4, dxw, dxw,
             M, D, nullptr, T, st));

  // conv module, its input LN
  TRY(conv_bwd(dxw, S + L.y[2], conv_bufs(S, L), w.pw1w, w.pw1b, w.dww,
               w.lnw + 3 * 2 * D, w.pw2w, lens, drop(kSiteConvOut), g.dpw2w,
               g.dvecb + 7 * D, g.dlnw + 3 * 2 * D, g.dvecb + 6 * D, g.ddww,
               g.dpw1b, g.dpw1w, t[3], t, dg, part, B, T, D, d.ksize,
               d.causal, st));
  TRY(ln_bwd(t[3], S + L.xhat[2], S + L.rstd[2], w.lnw, g.dlnw, 2, dxw, dxw,
             M, D, lens, T, st));

  // attention (its input grad into t[1]), its LN
  TRY(att_bwd(dxw, S + L.y[1], w.attw, w.posp, att_bufs(S, L),
              make_drop(seeds, d.layer, kSiteAttProb, d.att_thresh,
                        d.att_keep_scale, d.row0),
              drop(kSiteAttOut), g.dattw, g.dvecb + 2 * D, g.dposb, g.dposp,
              nullptr, t[1], t, dP, part, B, T, D, H, st));
  TRY(ln_bwd(t[1], S + L.xhat[1], S + L.rstd[1], w.lnw, g.dlnw, 1, dxw, dxw,
             M, D, nullptr, T, st));

  // macaron FFN, its LN into dx
  TRY(ffn_bwd(dxw, S + L.y[0], S + L.z0, S + L.h0, w.ffw1, w.ffw2, g.dffw1,
              g.dffb1, g.dffw2, g.dvecb, t[0], dh, nullptr, t[1], part, M, D,
              F, T, ff_scale, drop(kSiteMacaronHidden),
              drop(kSiteMacaronOut), st));
  return ln_bwd(t[1], S + L.xhat[0], S + L.rstd[0], w.lnw, g.dlnw, 0, dxw,
                dx, M, D, nullptr, T, st);
}

// ------------------------------------------------------------------------
// The bf16 mode (train_wgmma.cuh's blocks). saved: the f32 rows that an
// f32 reader needs (LN statistics, the FFN pre-activations, k, the scores
// P, pw1's output, the conv LN's output, the residual stream), the product
// operands as bf16 (the LNs' outputs y0, y1, y2, y4, the FFNs' hidden
// rows, q+u, q+v, k, v, O, Pd, the conv module's SiLU output) and the
// bf16 weights and posp for the backward. scratch: dy, the residual grad,
// two (M, D) f32 arrays, the split-K slices and one region that each
// block's temporaries take in turn (BlockTmp).
// ------------------------------------------------------------------------
struct SavedBf {
  size_t xhat[6], rstd[6], cn, z0, z1, g, xw;   // f32
  size_t y[5], h0, h1;                          // bf16
  size_t qu, qv, kb, v, o, Pd, k, P;   // the attention's
  WeightsBf w;
  size_t total;
};

SavedBf saved_layout_bf(int B, int T, int D, int F, int H) {
  const size_t M = (size_t)B * T, MD = M * D, MF = M * F;
  SavedBf s;
  Layout l;
  for (int i = 0; i < 6; ++i) {
    s.xhat[i] = l.f32(MD);
    s.rstd[i] = l.f32(M);
  }
  s.cn = l.f32(MD);
  s.z0 = l.f32(MF);
  s.z1 = l.f32(MF);
  s.g = l.f32(2 * MD);
  s.xw = l.f32(MD);
  for (int i = 0; i < 5; ++i) s.y[i] = l.bf16(MD);
  s.h0 = l.bf16(MF);
  s.h1 = l.bf16(MF);
  att_saved_bf(l, &s.qu, &s.qv, &s.kb, &s.v, &s.o, &s.Pd, &s.k, &s.P, B,
               T, D, H);
  s.w = weights_bf(l, T, D, F);
  s.total = l.off;
  return s;
}

struct ScratchBf {
  size_t dyw, dxw, t0, t1;
  ReduceL red;
  BlockTmp b;
  size_t total;
};

ScratchBf scratch_layout_bf(int B, int T, int D, int F, int H) {
  const size_t MD = (size_t)B * T * D;
  ScratchBf s;
  Layout l;
  s.dyw = l.f32(MD);
  s.dxw = l.f32(MD);
  s.t0 = l.f32(MD);
  s.t1 = l.f32(MD);
  s.red = reduce_layout(l, B, T, D, F, H);
  s.b = block_tmp(l, B, T, D, F, H);
  s.total = l.off;
  return s;
}

AttBufsBf att_bufs_bf(float* S, const SavedBf& L) {
  return {at<bf16_t>(S, L.qu), at<bf16_t>(S, L.qv), at<bf16_t>(S, L.kb),
          at<bf16_t>(S, L.v),  at<bf16_t>(S, L.o),  at<bf16_t>(S, L.Pd),
          S + L.k,             S + L.P};
}

ConvBufsBf conv_bufs_bf(float* S, const SavedBf& L) {
  return {S + L.g, S + L.cn, S + L.xhat[3], S + L.rstd[3],
          at<bf16_t>(S, L.y[3])};
}

// the bf16 mode's arrays: the five product weights and posp bf16, the
// rest f32
struct WeightsB {
  const bf16_t *posp, *ffw1, *ffw2, *attw, *pw1w, *pw2w;
  const float *lnw, *ffb1, *vecb, *posb, *pw1b, *dww;
};

struct GradsB {
  bf16_t *dposp, *dffw1, *dffw2, *dattw, *dpw1w, *dpw2w;
  float *dlnw, *dffb1, *dvecb, *dposb, *dpw1b, *ddww;
};

// The bf16 forward from x (bf16) into out (bf16), as forward_rows with x2
// and x4 rounded to bf16 where masr_tpu's kernel stores them in x's dtype
// (the header): x2 by the attention's output product, out = bf16(LN(x4))
// of the unrounded x4 and the saved final LN statistics of the rounded one.
cudaError_t forward_rows_bf(const bf16_t* x, float* S, const SavedBf& L,
                            const unsigned char* mask, const int* seeds,
                            const int* lens, const WeightsB& w, bf16_t* out,
                            const Dims& d, float ff_scale, float eps,
                            cudaStream_t st) {
  const int B = d.B, T = d.T, D = d.D, F = d.F, H = d.H, M = B * T;
  const size_t MD = (size_t)M * D, DF = (size_t)D * F;
  float* xw = S + L.xw;
  auto y = [&](int i) { return at<bf16_t>(S, L.y[i]); };
  auto drop = [&](int site) {
    return make_drop(seeds, d.layer, site, d.thresh, d.keep_scale,
                     d.row0);
  };
  TRY(convert(x, xw, (long long)MD, st));
  TRY(save_weights_bf(S, L.w, w.ffw1, w.ffw2, w.attw, w.pw1w, w.pw2w,
                      w.posp, T, D, F, st));

  TRY(layer_norm(xw, y(0), w.lnw, 0, M, D, eps, nullptr, T, st,
                 S + L.xhat[0], S + L.rstd[0]));
  TRY(ffn_fwd_bf(xw, xw, y(0), S + L.z0, at<bf16_t>(S, L.h0), w.ffw1,
                 w.ffb1, w.ffw2, w.vecb, M, D, F, T, ff_scale,
                 drop(kSiteMacaronHidden), drop(kSiteMacaronOut), st));

  TRY(layer_norm(xw, y(1), w.lnw, 1, M, D, eps, nullptr, T, st,
                 S + L.xhat[1], S + L.rstd[1]));
  TRY(att_fwd_bf(y(1), w.attw, w.vecb + 2 * D, w.posb, w.posp, mask,
                 att_bufs_bf(S, L), xw, xw, true,
                 make_drop(seeds, d.layer, kSiteAttProb, d.att_thresh,
                           d.att_keep_scale, d.row0),
                 drop(kSiteAttOut), B, T, D, H, st));   // x2 rounded

  TRY(layer_norm(xw, y(2), w.lnw, 2, M, D, eps, lens, T, st, S + L.xhat[2],
                 S + L.rstd[2]));
  TRY(conv_fwd_bf(y(2), w.pw1w, w.pw1b, w.dww, w.vecb + 6 * D,
                  w.lnw + 3 * 2 * D, w.pw2w, w.vecb + 7 * D,
                  conv_bufs_bf(S, L), xw, xw, lens, drop(kSiteConvOut), B, T,
                  D, d.ksize, d.causal, eps, st));

  TRY(layer_norm(xw, y(4), w.lnw, 4, M, D, eps, nullptr, T, st,
                 S + L.xhat[4], S + L.rstd[4]));
  TRY(ffn_fwd_bf(xw, xw, y(4), S + L.z1, at<bf16_t>(S, L.h1), w.ffw1 + DF,
                 w.ffb1 + F, w.ffw2 + DF, w.vecb + D, M, D, F, T, ff_scale,
                 drop(kSiteFfnHidden), drop(kSiteFfnOut), st));
  TRY(layer_norm(xw, out, w.lnw, 5, M, D, eps, nullptr, T, st));
  TRY(round_bf16(xw, (long long)MD, st));   // x4 as saved
  return layer_norm<float>(xw, nullptr, w.lnw, 5, M, D, eps, nullptr, T, st,
                           S + L.xhat[5], S + L.rstd[5]);
}

// The bf16 backward from dy (bf16) into dx (bf16) and the grads (the five
// weights' and posp's bf16, each rounded once from its f32 sum); the grad
// of x2 rounded to bf16 between the halves.
cudaError_t backward_rows_bf(const bf16_t* dy, float* S, const SavedBf& L,
                             float* G, const ScratchBf& W, const int* seeds,
                             const int* lens, const WeightsB& w,
                             const GradsB& g, bf16_t* dx, const Dims& d,
                             float ff_scale, cudaStream_t st) {
  const int B = d.B, T = d.T, D = d.D, F = d.F, H = d.H, M = B * T;
  const size_t MD = (size_t)M * D, DF = (size_t)D * F;
  float *dyw = G + W.dyw, *dxw = G + W.dxw, *t0 = G + W.t0, *t1 = G + W.t1;
  const BlockTmp& b = W.b;
  const Reduce rd = reduce_at(G, W.red);
  auto y = [&](int i) { return at<const bf16_t>(S, L.y[i]); };
  auto drop = [&](int site) {
    return make_drop(seeds, d.layer, site, d.thresh, d.keep_scale,
                     d.row0);
  };
  TRY(reduce_reset(G, W.red, st));
  TRY(convert(dy, dyw, (long long)MD, st));

  // final LN, FFN
  TRY(ln_bwd_bf(dyw, S + L.xhat[5], S + L.rstd[5], w.lnw, g.dlnw, 5, nullptr,
                dxw, M, D, nullptr, T, rd, st));
  TRY(ffn_bwd_bf(dxw, y(4), S + L.z1, at<bf16_t>(S, L.h1), w.ffw1 + DF,
                 w.ffw2 + DF, g.dffw1 + DF, g.dffb1 + F, g.dffw2 + DF,
                 g.dvecb + D, ffn_tmp(G, b), nullptr, t1, rd, M, D, F,
                 T, ff_scale, drop(kSiteFfnHidden), drop(kSiteFfnOut), st));
  TRY(ln_bwd_bf(t1, S + L.xhat[4], S + L.rstd[4], w.lnw, g.dlnw, 4, dxw, dxw,
                M, D, nullptr, T, rd, st));

  // conv module, its input LN; dx2 rounded
  float* tc[3] = {t0, t1, G + b.cv_t2};
  TRY(conv_bwd_bf(dxw, y(2), conv_bufs_bf(S, L), w.pw1w, w.pw1b, w.dww,
                  w.lnw + 3 * 2 * D, w.pw2w, lens, drop(kSiteConvOut),
                  g.dpw2w, g.dvecb + 7 * D, g.dlnw + 3 * 2 * D,
                  g.dvecb + 6 * D, g.ddww, g.dpw1b, g.dpw1w, G + b.cv_da, tc,
                  G + b.cv_dg, at<bf16_t>(G, b.cv_t0b),
                  at<bf16_t>(G, b.cv_dgb), rd, B, T, D, d.ksize,
                  d.causal, st));
  TRY(ln_bwd_bf(G + b.cv_da, S + L.xhat[2], S + L.rstd[2], w.lnw, g.dlnw, 2,
                dxw, dxw, M, D, lens, T, rd, st));
  TRY(round_bf16(dxw, (long long)MD, st));

  // attention (its input grad into t1), its LN
  float* ta[6] = {t0, t1, G + b.at_t[0], G + b.at_t[1], G + b.at_t[2],
                  G + b.at_t[3]};
  TRY(att_bwd_bf(dxw, y(1), w.attw, w.posp, att_bufs_bf(S, L),
                 make_drop(seeds, d.layer, kSiteAttProb, d.att_thresh,
                           d.att_keep_scale, d.row0),
                 drop(kSiteAttOut), g.dattw, g.dvecb + 2 * D, g.dposb,
                 g.dposp, nullptr, t1, ta, G + b.at_dP, att_tmp(G, b), rd, B,
                 T, D, H, st));
  TRY(ln_bwd_bf(t1, S + L.xhat[1], S + L.rstd[1], w.lnw, g.dlnw, 1, dxw, dxw,
                M, D, nullptr, T, rd, st));

  // macaron FFN, its LN into dx
  TRY(ffn_bwd_bf(dxw, y(0), S + L.z0, at<bf16_t>(S, L.h0), w.ffw1, w.ffw2,
                 g.dffw1, g.dffb1, g.dffw2, g.dvecb, ffn_tmp(G, b), nullptr,
                 t1, rd, M, D, F, T, ff_scale,
                 drop(kSiteMacaronHidden), drop(kSiteMacaronOut), st));
  TRY(ln_bwd_bf(t1, S + L.xhat[0], S + L.rstd[0], w.lnw, g.dlnw, 0, dxw, dxw,
                M, D, nullptr, T, rd, st));
  return convert(dxw, dx, (long long)MD, st);
}

}  // namespace

extern "C" size_t masr_conformer_layer_train_saved_floats(int B, int T,
                                                          int D, int F,
                                                          int H, int bf) {
  return bf ? saved_layout_bf(B, T, D, F, H).total
            : saved_layout(B, T, D, F, H).total;
}

extern "C" size_t masr_conformer_layer_train_scratch_floats(int B, int T,
                                                            int D, int F,
                                                            int H, int bf) {
  return bf ? scratch_layout_bf(B, T, D, F, H).total
            : scratch_layout(B, T, D, F, H).total;
}

// Packed weights as ops/cuda/conformer_layer.py pack_layer_params (f32,
// row-major, contiguous): lnw (6,2,D) ffw1 (2,D,F) ffb1 (2,F) ffw2 (2,F,D)
// vecb (8,D) attw (4,D,D) posb (2,D) pw1w (D,2D) pw1b (1,2D) pw2w (D,D)
// dww (k,D). mask (B,T,T) u8, seeds (B,) i32 (this layer's), lens (B,) i32,
// posp (T,D) = linear_pos(pos_emb). thresh / keep_scale: dropout at the
// six non-attention sites, att_*: at the attention probabilities (thresh 0
// = no dropout). saved: masr_conformer_layer_train_saved_floats(.., 0)
// floats.
extern "C" int masr_conformer_layer_train_forward(
    const float* x, const unsigned char* mask, const int* seeds,
    const int* lens, const float* posp, const float* lnw, const float* ffw1,
    const float* ffb1, const float* ffw2, const float* vecb,
    const float* attw, const float* posb, const float* pw1w,
    const float* pw1b, const float* pw2w, const float* dww, float* out,
    float* saved, int B, int T, int D, int F, int n_head, int ksize,
    int causal, int layer, int row0, unsigned thresh, float keep_scale,
    unsigned att_thresh, float att_keep_scale, float ff_scale, float eps,
    void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  if ((D / H) * H != D) return (int)cudaErrorInvalidValue;
  const Saved L = saved_layout(B, T, D, F, H);
  MASR_CHECK(cudaMemcpyAsync(saved + L.xw, x, (size_t)M * D * sizeof(float),
                             cudaMemcpyDeviceToDevice, st));
  const Weights w = {posp, lnw,  ffw1, ffb1, ffw2, vecb,
                     attw, posb, pw1w, pw1b, pw2w, dww};
  MASR_CHECK(forward_rows(
      saved, L, mask, seeds, lens, w, out,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      ff_scale, eps, st));
  return (int)cudaGetLastError();
}

// The bf16 mode (the header): x, posp, out and ffw1, ffw2, attw, pw1w,
// pw2w bf16, the other arrays f32, as the f32 entry (any D, n_head and F
// it takes). saved:
// masr_conformer_layer_train_saved_floats(.., 1) floats.
extern "C" int masr_conformer_layer_train_forward_bf16(
    const bf16_t* x, const unsigned char* mask, const int* seeds,
    const int* lens, const bf16_t* posp, const float* lnw,
    const bf16_t* ffw1, const float* ffb1, const bf16_t* ffw2,
    const float* vecb, const bf16_t* attw, const float* posb,
    const bf16_t* pw1w, const float* pw1b, const bf16_t* pw2w,
    const float* dww, bf16_t* out, float* saved, int B, int T, int D, int F,
    int n_head, int ksize, int causal, int layer, int row0, unsigned thresh,
    float keep_scale, unsigned att_thresh, float att_keep_scale,
    float ff_scale, float eps, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  if ((D / H) * H != D) return (int)cudaErrorInvalidValue;
  const WeightsB w = {posp, ffw1, ffw2, attw, pw1w, pw2w,
                      lnw,  ffb1, vecb, posb, pw1b, dww};
  MASR_CHECK(forward_rows_bf(
      x, saved, saved_layout_bf(B, T, D, F, H), mask, seeds, lens, w, out,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      ff_scale, eps, st));
  return (int)cudaGetLastError();
}

// dy (B,T,D) -> dx (B,T,D), dposp (T,D) and the grads of the 11 packed
// arrays (same shapes, every element written). saved: the forward's;
// scratch: masr_conformer_layer_train_scratch_floats(.., 0) floats.
extern "C" int masr_conformer_layer_train_backward(
    const float* dy, const int* seeds, const int* lens, const float* posp,
    const float* lnw, const float* ffw1, const float* ffw2,
    const float* attw, const float* pw1w, const float* pw1b,
    const float* pw2w, const float* dww, float* saved, float* scratch,
    float* dx, float* dposp, float* dlnw, float* dffw1, float* dffb1,
    float* dffw2, float* dvecb, float* dattw, float* dposb, float* dpw1w,
    float* dpw1b, float* dpw2w, float* ddww, int B, int T, int D, int F,
    int n_head, int ksize, int causal, int layer, int row0, unsigned thresh,
    float keep_scale, unsigned att_thresh, float att_keep_scale,
    float ff_scale, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  if ((D / H) * H != D) return (int)cudaErrorInvalidValue;
  const Weights w = {posp,    lnw,  ffw1, nullptr, ffw2, nullptr,
                     attw,    nullptr, pw1w, pw1b, pw2w, dww};
  const Grads g = {dposp, dlnw,  dffw1, dffb1, dffw2, dvecb,
                   dattw, dposb, dpw1w, dpw1b, dpw2w, ddww};
  MASR_CHECK(backward_rows(
      dy, saved, saved_layout(B, T, D, F, H), scratch,
      scratch_layout(B, T, D, F, H), seeds, lens, w, g, dx,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      ff_scale, st));
  return (int)cudaGetLastError();
}

// The bf16 mode's backward: dy, dx, dposp and the grads of ffw1, ffw2,
// attw, pw1w, pw2w bf16 (each rounded once from its f32 sum), the other
// grads f32. The product weights and posp are read from `saved` (the
// forward copied them); lnw, pw1b and dww are the f32 arrays. scratch:
// masr_conformer_layer_train_scratch_floats(.., 1) floats.
extern "C" int masr_conformer_layer_train_backward_bf16(
    const bf16_t* dy, const int* seeds, const int* lens, const float* lnw,
    const float* pw1b, const float* dww, float* saved, float* scratch,
    bf16_t* dx, bf16_t* dposp, float* dlnw, bf16_t* dffw1, float* dffb1,
    bf16_t* dffw2, float* dvecb, bf16_t* dattw, float* dposb, bf16_t* dpw1w,
    float* dpw1b, bf16_t* dpw2w, float* ddww, int B, int T, int D, int F,
    int n_head, int ksize, int causal, int layer, int row0, unsigned thresh,
    float keep_scale, unsigned att_thresh, float att_keep_scale,
    float ff_scale, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  if ((D / H) * H != D) return (int)cudaErrorInvalidValue;
  const SavedBf L = saved_layout_bf(B, T, D, F, H);
  float* S = saved;
  const WeightsB w = {at<bf16_t>(S, L.w.posp), at<bf16_t>(S, L.w.ffw1),
                      at<bf16_t>(S, L.w.ffw2), at<bf16_t>(S, L.w.attw),
                      at<bf16_t>(S, L.w.pw1w), at<bf16_t>(S, L.w.pw2w),
                      lnw,                     nullptr,
                      nullptr,                 nullptr,
                      pw1b,                    dww};
  const GradsB g = {dposp, dffw1, dffw2, dattw, dpw1w, dpw2w,
                    dlnw,  dffb1, dvecb, dposb, dpw1b, ddww};
  MASR_CHECK(backward_rows_bf(
      dy, S, L, scratch, scratch_layout_bf(B, T, D, F, H), seeds, lens, w, g,
      dx,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      ff_scale, st));
  return (int)cudaGetLastError();
}

// The bf16 mode's product alone (the card tests, the benchmark): C (f32)
// and / or Cb (bf16) = the epilogue of op(A) (M, K) . op(B) (K, N) for
// `batch` matrices, as train_wgmma.cuh's tw_mm runs it; split: the weight
// grads' path instead (ta 1, tb 0, no epilogue: split over K by tw_tn_kc
// into part, masr_train_product_part_floats floats, summed in slice
// order into C or Cb). Geometry (host
// arrays): ga, gb {ld, s1, s2, div} of the stored A and B (ta: A stored
// (K, M), tb: B stored (N, K)), gc {ldc, s1, s2, div} of C. Epilogue as training.cuh's Epi: bias, alpha, R (may
// alias C), res_scale, pre, act (0 none, 1 SiLU, 2 x dSiLU(aux)), the
// dropout hash (seeds nullptr: none), lens / T (row mask), round_c.
extern "C" size_t masr_train_product_part_floats(int M, int N, int K,
                                                 int batch,
                                                 const long long* gc) {
  return tw_part_floats(M, N, K, batch, gc[0],
                        Batch{gc[1], gc[2], (int)gc[3]});
}

extern "C" int masr_train_product_bf16(
    const bf16_t* A, const long long* ga, int ta, const bf16_t* Bm,
    const long long* gb, int tb, float* C, bf16_t* Cb, const long long* gc,
    int M, int N, int K, int batch, int split, float* part,
    const float* bias, float alpha, const float* R, float res_scale,
    float* pre, int act, const float* aux, const int* seeds, int layer,
    int site, unsigned thresh, float keep_scale, int row0, const int* lens,
    int T, int round_c, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const BMat a{A, ga[0], Batch{ga[1], ga[2], (int)ga[3]}};
  const BMat b{Bm, gb[0], Batch{gb[1], gb[2], (int)gb[3]}};
  const Batch bc{gc[1], gc[2], (int)gc[3]};
  if (split) {
    if (!ta || tb || (C != nullptr) == (Cb != nullptr))
      return (int)cudaErrorInvalidValue;
    const Reduce rd = {part, nullptr, nullptr};
    if (Cb) return (int)tw_mm_tn(a, b, Cb, M, N, K, batch, gc[0], bc, rd, st);
    return (int)tw_mm_tn(a, b, C, M, N, K, batch, gc[0], bc, rd, st);
  }
  BEpi e;
  e.bias = bias;
  e.alpha = alpha;
  e.R = R;
  e.res_scale = res_scale;
  e.pre = pre;
  e.act = act;
  e.aux = aux;
  e.drop = make_drop(seeds, layer, site, thresh, keep_scale, row0);
  e.lens = lens;
  e.T = T;
  e.C = C;
  e.Cb = Cb;
  e.round_c = round_c != 0;
  const long long ldc = gc[0];
  if (ta && tb) return (int)tw_mm<true, true>(a, b, M, N, K, batch, ldc, bc, e, st);
  if (ta) return (int)tw_mm<true, false>(a, b, M, N, K, batch, ldc, bc, e, st);
  if (tb) return (int)tw_mm<false, true>(a, b, M, N, K, batch, ldc, bc, e, st);
  return (int)tw_mm<false, false>(a, b, M, N, K, batch, ldc, bc, e, st);
}
