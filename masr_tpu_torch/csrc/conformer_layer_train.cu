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
  off += splitk_part_floats(B * T, D, F);
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
  const size_t MD = (size_t)M * D, DF = (size_t)D * F;
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
  MASR_CHECK(ffn_fwd(xw, xw, S + L.y[0], S + L.z0, S + L.h0, ffw1, ffb1,
                     ffw2, vecb, M, D, F, T, ff_scale,
                     drop(kSiteMacaronHidden), drop(kSiteMacaronOut), st));

  // rel-pos MHSA
  MASR_CHECK(layer_norm(xw, S + L.y[1], lnw, 1, M, D, eps, nullptr, T, st,
                        S + L.xhat[1], S + L.rstd[1]));
  MASR_CHECK(att_fwd(S + L.y[1], attw, vecb + 2 * D, posb, posp, mask,
                     att_bufs(S, L), xw, xw,
                     make_drop(seeds, layer, kSiteAttProb, att_thresh,
                               att_keep_scale),
                     drop(kSiteAttOut), B, T, D, H, st));

  // conv module: LN (rows >= len zeroed) -> pw1 -> GLU + depthwise -> LN ->
  // SiLU -> pw2 (rows >= len zeroed)
  MASR_CHECK(layer_norm(xw, S + L.y[2], lnw, 2, M, D, eps, lens, T, st,
                        S + L.xhat[2], S + L.rstd[2]));
  MASR_CHECK(conv_fwd(S + L.y[2], pw1w, pw1b, dww, vecb + 6 * D,
                      lnw + 3 * 2 * D, pw2w, vecb + 7 * D, conv_bufs(S, L),
                      xw, xw, lens, drop(kSiteConvOut), B, T, D, ksize,
                      causal, eps, st));

  // FFN (x ff_scale), final LN
  MASR_CHECK(layer_norm(xw, S + L.y[4], lnw, 4, M, D, eps, nullptr, T, st,
                        S + L.xhat[4], S + L.rstd[4]));
  MASR_CHECK(ffn_fwd(xw, xw, S + L.y[4], S + L.z1, S + L.h1, ffw1 + DF,
                     ffb1 + F, ffw2 + DF, vecb + D, M, D, F, T, ff_scale,
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
    const float* pw2w, const float* dww, float* saved, float* scratch,
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
  const size_t DF = (size_t)D * F;
  float* S = saved;
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
                     t[0], dh, nullptr, t[1], part, M, D, F, T, ff_scale,
                     drop(kSiteFfnHidden), drop(kSiteFfnOut), st));
  MASR_CHECK(ln_bwd(t[1], S + L.xhat[4], S + L.rstd[4], lnw, dlnw, 4, dxw,
                    dxw, M, D, nullptr, T, st));

  // conv module, its input LN
  MASR_CHECK(conv_bwd(dxw, S + L.y[2], conv_bufs(S, L), pw1w, pw1b, dww,
                      lnw + 3 * 2 * D, pw2w, lens, drop(kSiteConvOut), dpw2w,
                      dvecb + 7 * D, dlnw + 3 * 2 * D, dvecb + 6 * D, ddww,
                      dpw1b, dpw1w, t[3], t, dg, part, B, T, D, ksize,
                      causal, st));
  MASR_CHECK(ln_bwd(t[3], S + L.xhat[2], S + L.rstd[2], lnw, dlnw, 2, dxw,
                    dxw, M, D, lens, T, st));

  // attention (its input grad into t[1]), its LN
  MASR_CHECK(att_bwd(dxw, S + L.y[1], attw, posp, att_bufs(S, L),
                     make_drop(seeds, layer, kSiteAttProb, att_thresh,
                               att_keep_scale),
                     drop(kSiteAttOut), dattw, dvecb + 2 * D, dposb, dposp,
                     nullptr, t[1], t, dP, part, B, T, D, H, st));
  MASR_CHECK(ln_bwd(t[1], S + L.xhat[1], S + L.rstd[1], lnw, dlnw, 1, dxw,
                    dxw, M, D, nullptr, T, st));

  // macaron FFN, its LN into dx
  MASR_CHECK(ffn_bwd(dxw, S + L.y[0], S + L.z0, S + L.h0, ffw1, ffw2, dffw1,
                     dffb1, dffw2, dvecb, t[0], dh, nullptr, t[1], part, M, D,
                     F, T, ff_scale, drop(kSiteMacaronHidden),
                     drop(kSiteMacaronOut), st));
  MASR_CHECK(ln_bwd(t[1], S + L.xhat[0], S + L.rstd[0], lnw, dlnw, 0, dxw,
                    dx, M, D, nullptr, T, st));
  return (int)cudaGetLastError();
}
