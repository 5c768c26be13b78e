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
//   masr_conformer_layer_train_forward(_bf16)   ~21 launches (+8 in bf16)
//   masr_conformer_layer_train_backward(_bf16)  ~55 launches (+9 in bf16)
// The bf16 mode is the Pallas kernel's at compute dtype bf16 (`cdt =
// x_ref.dtype`, :171, :197, :362, :393): x, posp, the output and the five
// product weights (ffw1, ffw2, attw, pw1w, pw2w) are bf16, the LN, bias,
// depthwise and position-bias rows f32; the forward widens the bf16
// weights and posp once into f32 arrays of `saved`, which the backward
// reads too, and every product runs the same blocks with OT = bf16_t
// (operands rounded to bf16 as the tensor cores read them, f32 sums).
// Activations stay f32 inside, except where masr_tpu's kernel stores them
// in x's dtype, which the bf16 entries round to bf16:
//   - x2 = x1 + att, the input of the second half (its :598 returns it as
//     x.dtype), before the conv module reads it;
//   - x4, the final LN's input, which half 2 saves as x.dtype (:386): the
//     output is LN(x4) of the unrounded rows, rounded once to bf16, and the
//     saved x-hat and 1/std, which the backward reads, are of bf16(x4);
//   - the grad of x2 on the way back (half 2's dx is x.dtype) and dx;
//   - the grads of the five bf16 weights and of posp, which masr_tpu casts
//     to the pack's dtype (:575, :654): each summed in f32 over every row
//     and rounded once; the f32 arrays' grads stay f32.
// dq rounds k + posp as one operand (masr_tpu's _mm(dS, kh + ph, cdt)).
// The bf16 mode saves no memory: `saved` keeps the f32 layout (about 150
// MB at B=8, T'=299) plus the widened weights (10.5 MB) and one output row
// block.
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
// 3xTF32's 165 (a third of TF32's 495). The products, ~91% of the work, run
// on the tensor cores in 3xTF32 (f32 accuracy: one TF32 product would miss
// the layer's tolerances, tests/test_torch_tf32.py); the rest (column sums
// of one block per 32 columns, the softmax over materialised (T', T')
// scores, elementwise passes) on the FMA pipes. Left for later: wgmma /
// TMA products (TF32 wgmma takes only K-major operands from shared memory,
// so the transposed operands of mm_nn / mm_tn would need a transposing
// pass), fused flash-style attention that does not materialise (T', T').

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
// Saved activations, offsets in floats (M = B*T). The forward writes them,
// the backward reads them. bf16 mode (bf): also the f32 output rows before
// their rounding and the widened product weights and posp (Wide).
// ------------------------------------------------------------------------
struct Saved {
  size_t xhat[6], rstd[6], y[5], cn, z0, h0, z1, h1, qu, qv, k, v, o, g, P,
      Pd, xw, bias_uv, yout;
  Wide w;
  size_t total;
};

Saved saved_layout(int B, int T, int D, int F, int H, bool bf) {
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
  s.yout = bf ? take(MD) : 0;
  s.w = bf ? wide_layout(take, T, D, F) : Wide{};
  s.total = off;
  return s;
}

// backward scratch: dxw, t0..t5 (M, D), dh (M, F), dg (M, 2D), dP, and
// the split-K slices of the largest weight grad; bf16 mode: also dy and
// dx as f32 rows and the f32 grads of the bf16 arrays (Wide's layout)
struct Scratch {
  size_t dxw, t[6], dh, dg, dP, part, dyw, dxf;
  Wide gw;
  size_t total;
};

Scratch scratch_layout(int B, int T, int D, int F, int H, bool bf) {
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
  s.dyw = bf ? take(MD) : 0;
  s.dxf = bf ? take(MD) : 0;
  s.gw = bf ? wide_layout(take, T, D, F) : Wide{};
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
// overwritten) into out, saving what the backward reads. OT bf16_t: x2 and
// x4 rounded to bf16 where masr_tpu's kernel stores them in x's dtype (the
// header), out = bf16(LN(x4)) of the unrounded x4 and the saved final LN
// statistics of the rounded one.
template <class OT>
cudaError_t forward_rows(float* S, const Saved& L, const unsigned char* mask,
                         const int* seeds, const int* lens, const Weights& w,
                         OT* out, const Dims& d, float ff_scale, float eps,
                         cudaStream_t st) {
  const int B = d.B, T = d.T, D = d.D, F = d.F, H = d.H, M = B * T;
  const size_t MD = (size_t)M * D, DF = (size_t)D * F;
  float* xw = S + L.xw;
  auto drop = [&](int site) {
    return make_drop(seeds, d.layer, site, d.thresh, d.keep_scale,
                     d.row0);
  };

  // macaron FFN (x ff_scale)
  TRY(layer_norm(xw, S + L.y[0], w.lnw, 0, M, D, eps, nullptr, T, st,
                 S + L.xhat[0], S + L.rstd[0]));
  TRY(ffn_fwd<OT>(xw, xw, S + L.y[0], S + L.z0, S + L.h0, w.ffw1, w.ffb1,
                  w.ffw2, w.vecb, M, D, F, T, ff_scale,
                  drop(kSiteMacaronHidden), drop(kSiteMacaronOut), st));

  // rel-pos MHSA
  TRY(layer_norm(xw, S + L.y[1], w.lnw, 1, M, D, eps, nullptr, T, st,
                 S + L.xhat[1], S + L.rstd[1]));
  TRY(att_fwd<OT>(S + L.y[1], w.attw, w.vecb + 2 * D, w.posb, w.posp, mask,
                  att_bufs(S, L), xw, xw,
                  make_drop(seeds, d.layer, kSiteAttProb, d.att_thresh,
                            d.att_keep_scale, d.row0),
                  drop(kSiteAttOut), B, T, D, H, st));
  if (is_bf16<OT>) TRY(round_bf16(xw, (long long)MD, st));   // x2

  // conv module: LN (rows >= len zeroed) -> pw1 -> GLU + depthwise -> LN ->
  // SiLU -> pw2 (rows >= len zeroed)
  TRY(layer_norm(xw, S + L.y[2], w.lnw, 2, M, D, eps, lens, T, st,
                 S + L.xhat[2], S + L.rstd[2]));
  TRY(conv_fwd<OT>(S + L.y[2], w.pw1w, w.pw1b, w.dww, w.vecb + 6 * D,
                   w.lnw + 3 * 2 * D, w.pw2w, w.vecb + 7 * D,
                   conv_bufs(S, L), xw, xw, lens, drop(kSiteConvOut), B, T,
                   D, d.ksize, d.causal, eps, st));

  // FFN (x ff_scale), final LN
  TRY(layer_norm(xw, S + L.y[4], w.lnw, 4, M, D, eps, nullptr, T, st,
                 S + L.xhat[4], S + L.rstd[4]));
  TRY(ffn_fwd<OT>(xw, xw, S + L.y[4], S + L.z1, S + L.h1, w.ffw1 + DF,
                  w.ffb1 + F, w.ffw2 + DF, w.vecb + D, M, D, F, T, ff_scale,
                  drop(kSiteFfnHidden), drop(kSiteFfnOut), st));
  if constexpr (!is_bf16<OT>) {
    return layer_norm(xw, out, w.lnw, 5, M, D, eps, nullptr, T, st,
                      S + L.xhat[5], S + L.rstd[5]);
  } else {
    TRY(layer_norm(xw, S + L.yout, w.lnw, 5, M, D, eps, nullptr, T, st));
    TRY(convert(S + L.yout, out, (long long)MD, st));
    TRY(round_bf16(xw, (long long)MD, st));   // x4 as saved
    return layer_norm(xw, S + L.yout, w.lnw, 5, M, D, eps, nullptr, T, st,
                      S + L.xhat[5], S + L.rstd[5]);
  }
}

// The backward from dy (f32 rows) into dx (f32 rows) and the grads (every
// element written). OT bf16_t: the grad of x2 rounded to bf16 between the
// halves.
template <class OT>
cudaError_t backward_rows(const float* dy, float* S, const Saved& L,
                          float* scratch, const Scratch& W, const int* seeds,
                          const int* lens, const Weights& w, const Grads& g,
                          float* dx, const Dims& d, float ff_scale,
                          cudaStream_t st) {
  const int B = d.B, T = d.T, D = d.D, F = d.F, H = d.H, M = B * T;
  const size_t MD = (size_t)M * D, DF = (size_t)D * F;
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
  TRY(ffn_bwd<OT>(dxw, S + L.y[4], S + L.z1, S + L.h1, w.ffw1 + DF,
                  w.ffw2 + DF, g.dffw1 + DF, g.dffb1 + F, g.dffw2 + DF,
                  g.dvecb + D, t[0], dh, nullptr, t[1], part, M, D, F, T,
                  ff_scale, drop(kSiteFfnHidden), drop(kSiteFfnOut), st));
  TRY(ln_bwd(t[1], S + L.xhat[4], S + L.rstd[4], w.lnw, g.dlnw, 4, dxw, dxw,
             M, D, nullptr, T, st));

  // conv module, its input LN
  TRY(conv_bwd<OT>(dxw, S + L.y[2], conv_bufs(S, L), w.pw1w, w.pw1b, w.dww,
                   w.lnw + 3 * 2 * D, w.pw2w, lens, drop(kSiteConvOut),
                   g.dpw2w, g.dvecb + 7 * D, g.dlnw + 3 * 2 * D,
                   g.dvecb + 6 * D, g.ddww, g.dpw1b, g.dpw1w, t[3], t, dg,
                   part, B, T, D, d.ksize, d.causal, st));
  TRY(ln_bwd(t[3], S + L.xhat[2], S + L.rstd[2], w.lnw, g.dlnw, 2, dxw, dxw,
             M, D, lens, T, st));
  if (is_bf16<OT>) TRY(round_bf16(dxw, (long long)MD, st));   // dx2

  // attention (its input grad into t[1]), its LN
  TRY(att_bwd<OT>(dxw, S + L.y[1], w.attw, w.posp, att_bufs(S, L),
                  make_drop(seeds, d.layer, kSiteAttProb, d.att_thresh,
                            d.att_keep_scale, d.row0),
                  drop(kSiteAttOut), g.dattw, g.dvecb + 2 * D, g.dposb,
                  g.dposp, nullptr, t[1], t, dP, part, B, T, D, H, st));
  TRY(ln_bwd(t[1], S + L.xhat[1], S + L.rstd[1], w.lnw, g.dlnw, 1, dxw, dxw,
             M, D, nullptr, T, st));

  // macaron FFN, its LN into dx
  TRY(ffn_bwd<OT>(dxw, S + L.y[0], S + L.z0, S + L.h0, w.ffw1, w.ffw2,
                  g.dffw1, g.dffb1, g.dffw2, g.dvecb, t[0], dh, nullptr,
                  t[1], part, M, D, F, T, ff_scale,
                  drop(kSiteMacaronHidden), drop(kSiteMacaronOut), st));
  return ln_bwd(t[1], S + L.xhat[0], S + L.rstd[0], w.lnw, g.dlnw, 0, dxw,
                dx, M, D, nullptr, T, st);
}

}  // namespace

extern "C" size_t masr_conformer_layer_train_saved_floats(int B, int T,
                                                          int D, int F,
                                                          int H, int bf) {
  return saved_layout(B, T, D, F, H, bf != 0).total;
}

extern "C" size_t masr_conformer_layer_train_scratch_floats(int B, int T,
                                                            int D, int F,
                                                            int H, int bf) {
  return scratch_layout(B, T, D, F, H, bf != 0).total;
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
  const Saved L = saved_layout(B, T, D, F, H, false);
  MASR_CHECK(cudaMemcpyAsync(saved + L.xw, x, (size_t)M * D * sizeof(float),
                             cudaMemcpyDeviceToDevice, st));
  const Weights w = {posp, lnw,  ffw1, ffb1, ffw2, vecb,
                     attw, posb, pw1w, pw1b, pw2w, dww};
  MASR_CHECK(forward_rows<float>(
      saved, L, mask, seeds, lens, w, out,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      ff_scale, eps, st));
  return (int)cudaGetLastError();
}

// The bf16 mode (the header): x, posp, out and ffw1, ffw2, attw, pw1w,
// pw2w bf16, the other arrays f32, as the f32 entry. saved:
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
  const Saved L = saved_layout(B, T, D, F, H, true);
  const size_t MD = (size_t)M * D, DF = (size_t)D * F, DD = (size_t)D * D;
  float* S = saved;
  MASR_CHECK(convert(x, S + L.xw, (long long)MD, st));
  MASR_CHECK(convert(ffw1, S + L.w.ffw1, (long long)(2 * DF), st));
  MASR_CHECK(convert(ffw2, S + L.w.ffw2, (long long)(2 * DF), st));
  MASR_CHECK(convert(attw, S + L.w.attw, (long long)(4 * DD), st));
  MASR_CHECK(convert(pw1w, S + L.w.pw1w, (long long)(2 * DD), st));
  MASR_CHECK(convert(pw2w, S + L.w.pw2w, (long long)DD, st));
  MASR_CHECK(convert(posp, S + L.w.posp, (long long)T * D, st));
  const Weights w = {S + L.w.posp, lnw,          S + L.w.ffw1, ffb1,
                     S + L.w.ffw2, vecb,         S + L.w.attw, posb,
                     S + L.w.pw1w, pw1b,         S + L.w.pw2w, dww};
  MASR_CHECK(forward_rows<bf16_t>(
      S, L, mask, seeds, lens, w, out,
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
  MASR_CHECK(backward_rows<float>(
      dy, saved, saved_layout(B, T, D, F, H, false), scratch,
      scratch_layout(B, T, D, F, H, false), seeds, lens, w, g, dx,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      ff_scale, st));
  return (int)cudaGetLastError();
}

// The bf16 mode's backward: dy, dx, dposp and the grads of ffw1, ffw2,
// attw, pw1w, pw2w bf16 (each rounded once from its f32 sum), the other
// grads f32. The product weights and posp are read from `saved` (the
// forward widened them); lnw, pw1b and dww are the f32 arrays. scratch:
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
  const Saved L = saved_layout(B, T, D, F, H, true);
  const Scratch W = scratch_layout(B, T, D, F, H, true);
  const size_t MD = (size_t)M * D, DF = (size_t)D * F, DD = (size_t)D * D;
  float *S = saved, *G = scratch;
  MASR_CHECK(convert(dy, G + W.dyw, (long long)MD, st));
  const Weights w = {S + L.w.posp, lnw,     S + L.w.ffw1, nullptr,
                     S + L.w.ffw2, nullptr, S + L.w.attw, nullptr,
                     S + L.w.pw1w, pw1b,    S + L.w.pw2w, dww};
  const Grads g = {G + W.gw.posp, dlnw,  G + W.gw.ffw1, dffb1,
                   G + W.gw.ffw2, dvecb, G + W.gw.attw, dposb,
                   G + W.gw.pw1w, dpw1b, G + W.gw.pw2w, ddww};
  MASR_CHECK(backward_rows<bf16_t>(
      G + W.dyw, S, L, scratch, W, seeds, lens, w, g, G + W.dxf,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      ff_scale, st));
  MASR_CHECK(convert(G + W.dxf, dx, (long long)MD, st));
  MASR_CHECK(convert(G + W.gw.posp, dposp, (long long)T * D, st));
  MASR_CHECK(convert(G + W.gw.ffw1, dffw1, (long long)(2 * DF), st));
  MASR_CHECK(convert(G + W.gw.ffw2, dffw2, (long long)(2 * DF), st));
  MASR_CHECK(convert(G + W.gw.attw, dattw, (long long)(4 * DD), st));
  MASR_CHECK(convert(G + W.gw.pw1w, dpw1w, (long long)(2 * DD), st));
  MASR_CHECK(convert(G + W.gw.pw2w, dpw2w, (long long)DD, st));
  return (int)cudaGetLastError();
}
