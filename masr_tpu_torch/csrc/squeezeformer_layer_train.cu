// Squeezeformer encoder layer for TRAINING on Hopper (sm_90a), f32 or bf16,
// with the layer_norm conv module: a forward with dropout at the layer's
// seven sites and a hand-written backward.
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
// Two C entries per operand mode, one ctypes call each per layer and
// direction:
//   masr_sq_layer_train_forward(_bf16)   ~22 launches (~30 in bf16)
//   masr_sq_layer_train_backward(_bf16)  ~60 launches (~76 in bf16)
// The bf16 mode is the Pallas kernel's at compute dtype bf16 (`cdt =
// x_ref.dtype`, :115, :145, :297, :327): x, posp, the output and the five
// product weights bf16, the other rows f32. The adaptive scales are NOT
// folded there: masr_tpu applies each (`_ada`, :50) in f32 before the
// product rounds its operand, so a fold would move that rounding. The
// bf16 mode takes the unfolded pack (ada (4, 2, D), as the bf16 serving
// kernel's), applies ada0..ada3 with ada_rows straight into bf16 product
// operands, and computes their grads itself (column sums of the input
// grad times the scaled rows, and through the scale into the residual
// grad), as the Pallas backward returns dadaw. Its products are
// train_wgmma.cuh's (bf16 operands in device memory, TMA tiles, wgmma),
// as row 3's bf16 mode; the forward copies the bf16 weights and posp into
// `saved` for the backward. Rounded to bf16 where masr_tpu's kernel
// stores x's dtype:
//   - x2, the input of the second half (:448), and s2 = x1 + FFN1, which
//     half 1 saves as x.dtype (:448): x2 = bf16(LN2(s2)) of the unrounded
//     s2, the saved LN2 x-hat and 1/std of bf16(s2);
//   - s4 = x3 + FFN2 the same way (:526) for the output and LN4;
//   - the grad of x2 on the way back (:503) and dx (:585);
//   - the grads of the five bf16 weights and of posp, each summed in f32
//     and rounded once; the f32 arrays' grads (dada included) stay f32.
// built from common.cuh's LayerNorm and ada_rows and training.cuh's blocks
// (att_fwd / att_bwd, ffn_fwd / ffn_bwd, conv_fwd / conv_bwd, ln_bwd,
// colsum, the products with their epilogue), plus ada_bwd_kernel below.
// Each residual sum x + drop(sub) is written by its sublayer's last
// product (epilogue R = x) into one scratch array, which the next
// LayerNorm reads. Parameter grads come from one product (split over K in
// a fixed order on few tiles) or one column sum over all B*T' rows:
// deterministic, no atomics.
//
// Dropout: common.cuh's dropout_mult hash of (seed[b], layer, site, row0 +
// b, row, col), row0 the global batch row of utterance 0 (so a row draws
// the same mask whichever data-parallel rank runs it), so the backward
// regenerates the forward's masks and the plain twin
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
// 3xTF32's 165 (a third of TF32's 495), 0.024 ms in bf16 at 989. The f32
// products run training.cuh's tensor-core loop (common.cuh's
// gemm_tc_kernel, 3xTF32, f32 accuracy), the bf16 mode's train_wgmma.cuh's
// wgmma product, both shared with conformer_layer_train.cu. Left for
// later: a fused flash-style attention that does not materialise (T',
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

// dx (M, D) = base + da * ada[0] in rows t = row % T < lens[row / T] (every
// row when lens is nullptr), base alone past an utterance's length: the
// grad through an adaptive scale
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
    const bool ok = lens == nullptr || (int)(row % T) < lens[row / T];
    dx[i] = base[i] + (ok ? da[i] * ada[c] : 0.f);
  }
}

// dx = base + da * ada's scale and the grads of (scale, shift) from the
// scaled rows' input x, over the rows of lens (all when nullptr)
cudaError_t ada_bwd(const float* base, const float* da, const float* x,
                    const float* ada, float* dada, float* dx, int M, int D,
                    const int* lens, int T, cudaStream_t st) {
  TRY(colsum(da, x, dada, M, D, lens, T, st));
  TRY(colsum(da, nullptr, dada + D, M, D, lens, T, st));
  const size_t n = (size_t)M * D;
  ada_bwd_kernel<<<blocks_for(n, 256), 256, 0, st>>>(base, da, ada, dx, lens,
                                                     T, D, n);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// Saved activations of the f32 mode, offsets in floats (M = B*T). The
// forward writes them, the backward reads them. xhat / rstd 0..3:
// LN1..LN4, 4: the conv LN.
// ------------------------------------------------------------------------
struct Saved {
  size_t xhat[5], rstd[5], x1, x2, x3, a2, g, cn, y3, z0, h0, z1, h1, qu, qv,
      k, v, o, P, Pd, sum, bias_uv;
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
  size_t r[2], t[6], dh, dg, dP, part;
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
  for (int i = 0; i < 2; ++i) s.r[i] = take(MD);
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
  return {S + L.g, S + L.cn, S + L.xhat[4], S + L.rstd[4], S + L.y3};
}


// the f32 mode's arrays (ada: (2, D) the conv module's scale and shift,
// the others folded), and its grads
struct Weights {
  const float *posp, *lnw, *ada, *cnw, *attw, *vecb, *posb, *ffw1, *ffb1,
      *ffw2, *pw1w, *pw1b, *pw2w, *dww;
};

struct Grads {
  float *dposp, *dlnw, *dada, *dcnw, *dattw, *dvecb, *dposb, *dffw1, *dffb1,
      *dffw2, *dpw1w, *dpw1b, *dpw2w, *ddww;
};

// The forward from x0 (f32 rows) into out, saving what the backward reads.
cudaError_t forward_rows(const float* x0, float* S, const Saved& L,
                         const unsigned char* mask, const int* seeds,
                         const int* lens, const Weights& w, float* out,
                         const Dims& d, float eps, float conv_eps,
                         cudaStream_t st) {
  const int B = d.B, T = d.T, D = d.D, F = d.F, H = d.H, M = B * T;
  const size_t MD = (size_t)M * D, DF = (size_t)D * F;
  float* sum = S + L.sum;
  auto drop = [&](int site) {
    return make_drop(seeds, d.layer, site, d.thresh, d.keep_scale,
                     d.row0);
  };

  // x1 = LN1(x + drop(MHSA(ada0 x))), ada0 folded into q/k/v
  TRY(att_fwd(x0, w.attw, w.vecb, w.posb, w.posp, mask, att_bufs(S, L), x0,
              sum,
              make_drop(seeds, d.layer, kSiteAttProb, d.att_thresh,
                        d.att_keep_scale, d.row0),
              drop(kSiteAttOut), B, T, D, H, st));
  TRY(layer_norm(sum, S + L.x1, w.lnw, 0, M, D, eps, nullptr, T, st,
                 S + L.xhat[0], S + L.rstd[0]));
  // x2 = LN2(x1 + drop(FFN1(ada1 x1))), ada1 folded into w_1
  TRY(ffn_fwd(S + L.x1, sum, S + L.x1, S + L.z0, S + L.h0, w.ffw1, w.ffb1,
              w.ffw2, w.vecb + 4 * D, M, D, F, T, 1.f, drop(kSiteFfn1Hidden),
              drop(kSiteFfn1Out), st));
  TRY(layer_norm(sum, S + L.x2, w.lnw, 1, M, D, eps, nullptr, T, st,
                 S + L.xhat[1], S + L.rstd[1]));
  // x3 = LN3(x2 + drop(Conv(ada2 x2))), the conv input's rows >= len zero
  TRY(ada_rows(S + L.x2, S + L.a2, w.ada, lens, T, D, (long long)MD, st));
  TRY(conv_fwd(S + L.a2, w.pw1w, w.pw1b, w.dww, w.vecb + 6 * D, w.cnw,
               w.pw2w, w.vecb + 7 * D, conv_bufs(S, L), S + L.x2, sum, lens,
               drop(kSiteConvOut), B, T, D, d.ksize, d.causal, conv_eps,
               st));
  TRY(layer_norm(sum, S + L.x3, w.lnw, 2, M, D, eps, nullptr, T, st,
                 S + L.xhat[2], S + L.rstd[2]));
  // y = LN4(x3 + drop(FFN2(ada3 x3))), ada3 folded into w_1
  TRY(ffn_fwd(S + L.x3, sum, S + L.x3, S + L.z1, S + L.h1, w.ffw1 + DF,
              w.ffb1 + F, w.ffw2 + DF, w.vecb + 5 * D, M, D, F, T, 1.f,
              drop(kSiteFfn2Hidden), drop(kSiteFfn2Out), st));
  return layer_norm(sum, out, w.lnw, 3, M, D, eps, nullptr, T, st,
                    S + L.xhat[3], S + L.rstd[3]);
}

// The backward from dy (f32 rows) into dx (f32 rows) and the grads (every
// element written). x0: the forward's input rows (f32).
cudaError_t backward_rows(const float* dy, const float* x0, float* S,
                          const Saved& L, float* scratch, const Scratch& W,
                          const int* seeds, const int* lens,
                          const Weights& w, const Grads& g, float* dx,
                          const Dims& d, cudaStream_t st) {
  const int B = d.B, T = d.T, D = d.D, F = d.F, H = d.H, M = B * T;
  const size_t DF = (size_t)D * F;
  float *r0 = scratch + W.r[0], *r1 = scratch + W.r[1];
  float* t[6];
  for (int i = 0; i < 6; ++i) t[i] = scratch + W.t[i];
  float *dh = scratch + W.dh, *dg = scratch + W.dg, *dP = scratch + W.dP,
        *part = scratch + W.part;
  auto drop = [&](int site) {
    return make_drop(seeds, d.layer, site, d.thresh, d.keep_scale,
                     d.row0);
  };

  // LN4, FFN2: r0 = ds4, r1 = dx3 = ds4 + FFN2's input grad
  TRY(ln_bwd(dy, S + L.xhat[3], S + L.rstd[3], w.lnw, g.dlnw, 3, nullptr, r0,
             M, D, nullptr, T, st));
  TRY(ffn_bwd(r0, S + L.x3, S + L.z1, S + L.h1, w.ffw1 + DF, w.ffw2 + DF,
              g.dffw1 + DF, g.dffb1 + F, g.dffw2 + DF, g.dvecb + 5 * D, t[0],
              dh, r0, r1, part, M, D, F, T, 1.f, drop(kSiteFfn2Hidden),
              drop(kSiteFfn2Out), st));

  // LN3, conv module: r0 = ds3, t[3] = the grad of the conv input, r1 =
  // dx2 = ds3 + its grad through ada2 in the valid rows
  TRY(ln_bwd(r1, S + L.xhat[2], S + L.rstd[2], w.lnw, g.dlnw, 2, nullptr, r0,
             M, D, nullptr, T, st));
  TRY(conv_bwd(r0, S + L.a2, conv_bufs(S, L), w.pw1w, w.pw1b, w.dww, w.cnw,
               w.pw2w, lens, drop(kSiteConvOut), g.dpw2w, g.dvecb + 7 * D,
               g.dcnw, g.dvecb + 6 * D, g.ddww, g.dpw1b, g.dpw1w, t[3], t, dg,
               part, B, T, D, d.ksize, d.causal, st));
  TRY(ada_bwd(r0, t[3], S + L.x2, w.ada, g.dada, r1, M, D, lens, T, st));

  // LN2, FFN1: r0 = ds2, r1 = dx1
  TRY(ln_bwd(r1, S + L.xhat[1], S + L.rstd[1], w.lnw, g.dlnw, 1, nullptr, r0,
             M, D, nullptr, T, st));
  TRY(ffn_bwd(r0, S + L.x1, S + L.z0, S + L.h0, w.ffw1, w.ffw2, g.dffw1,
              g.dffb1, g.dffw2, g.dvecb + 4 * D, t[0], dh, r0, r1, part, M, D,
              F, T, 1.f, drop(kSiteFfn1Hidden), drop(kSiteFfn1Out), st));

  // LN1, attention: r0 = ds1, dx = ds1 + the attention's input grad
  TRY(ln_bwd(r1, S + L.xhat[0], S + L.rstd[0], w.lnw, g.dlnw, 0, nullptr, r0,
             M, D, nullptr, T, st));
  TRY(att_bwd(r0, x0, w.attw, w.posp, att_bufs(S, L),
              make_drop(seeds, d.layer, kSiteAttProb, d.att_thresh,
                        d.att_keep_scale, d.row0),
              drop(kSiteAttOut), g.dattw, g.dvecb, g.dposb, g.dposp, r0, dx,
              t, dP, part, B, T, D, H, st));
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// The bf16 mode (train_wgmma.cuh's blocks). saved: the f32 rows that an
// f32 reader needs (LN statistics, x as f32, x1..x3, the FFN
// pre-activations, k, the scores P, pw1's output, the conv LN's output,
// the residual sums), the product operands as bf16 (the adaptive scales'
// rows xa, a1, a2, a3, the FFNs' hidden rows, q+u, q+v, k, v, O, Pd, the
// conv module's SiLU output) and the bf16 weights and posp for the
// backward. scratch: dy, the residual grads r0 and r1, two (M, D) f32
// arrays, the split-K slices and the blocks' temporaries (BlockTmp).
// ------------------------------------------------------------------------
struct SavedBf {
  size_t xhat[5], rstd[5], x0, x1, x2, x3, g, cn, z0, z1, sum;   // f32
  size_t xa, a1, a2, a3, y3, h0, h1;                           // bf16
  size_t qu, qv, kb, v, o, Pd, k, P;   // the attention's
  WeightsBf w;
  size_t total;
};

SavedBf saved_layout_bf(int B, int T, int D, int F, int H) {
  const size_t M = (size_t)B * T, MD = M * D, MF = M * F;
  SavedBf s;
  Layout l;
  for (int i = 0; i < 5; ++i) {
    s.xhat[i] = l.f32(MD);
    s.rstd[i] = l.f32(M);
  }
  s.x0 = l.f32(MD);
  s.x1 = l.f32(MD);
  s.x2 = l.f32(MD);
  s.x3 = l.f32(MD);
  s.g = l.f32(2 * MD);
  s.cn = l.f32(MD);
  s.z0 = l.f32(MF);
  s.z1 = l.f32(MF);
  s.sum = l.f32(MD);
  s.xa = l.bf16(MD);
  s.a1 = l.bf16(MD);
  s.a2 = l.bf16(MD);
  s.a3 = l.bf16(MD);
  s.y3 = l.bf16(MD);
  s.h0 = l.bf16(MF);
  s.h1 = l.bf16(MF);
  att_saved_bf(l, &s.qu, &s.qv, &s.kb, &s.v, &s.o, &s.Pd, &s.k, &s.P, B,
               T, D, H);
  s.w = weights_bf(l, T, D, F);
  s.total = l.off;
  return s;
}

struct ScratchBf {
  size_t dyw, r0, r1, t0, t1;
  ReduceL red;
  BlockTmp b;
  size_t total;
};

ScratchBf scratch_layout_bf(int B, int T, int D, int F, int H) {
  const size_t MD = (size_t)B * T * D;
  ScratchBf s;
  Layout l;
  s.dyw = l.f32(MD);
  s.r0 = l.f32(MD);
  s.r1 = l.f32(MD);
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
  return {S + L.g, S + L.cn, S + L.xhat[4], S + L.rstd[4],
          at<bf16_t>(S, L.y3)};
}

// the bf16 mode's arrays: the five product weights and posp bf16, the
// rest f32; ada (4, 2, D) the four adaptive scales, unfolded
struct WeightsB {
  const bf16_t *posp, *attw, *ffw1, *ffw2, *pw1w, *pw2w;
  const float *lnw, *ada, *cnw, *vecb, *posb, *ffb1, *pw1b, *dww;
};

struct GradsB {
  bf16_t *dposp, *dattw, *dffw1, *dffw2, *dpw1w, *dpw2w;
  float *dlnw, *dada, *dcnw, *dvecb, *dposb, *dffb1, *dpw1b, *ddww;
};

// LN idx of the post-norm sum into y, as masr_tpu's half saves it in x's
// dtype: y from the unrounded sum, rounded to bf16 (y bf16, or f32 rounded
// in place); the saved statistics of the sum rounded to bf16
template <class Y>
cudaError_t post_norm_bf(float* S, const SavedBf& L, const float* lnw,
                         int idx, float* sum, Y* y, int M, int D, float eps,
                         int T, cudaStream_t st) {
  const long long MD = (long long)M * D;
  TRY(layer_norm(sum, y, lnw, idx, M, D, eps, nullptr, T, st));
  if constexpr (!is_bf16<Y>) TRY(round_bf16(y, MD, st));
  TRY(round_bf16(sum, MD, st));
  return layer_norm<float>(sum, nullptr, lnw, idx, M, D, eps, nullptr, T,
                           st, S + L.xhat[idx], S + L.rstd[idx]);
}

// The bf16 forward from x (bf16) into out (bf16): the adaptive scales
// applied by ada_rows into bf16 product operands; x2 and the output
// rounded as masr_tpu stores them (the header).
cudaError_t forward_rows_bf(const bf16_t* x, float* S, const SavedBf& L,
                            const unsigned char* mask, const int* seeds,
                            const int* lens, const WeightsB& w, bf16_t* out,
                            const Dims& d, float eps, float conv_eps,
                            cudaStream_t st) {
  const int B = d.B, T = d.T, D = d.D, F = d.F, H = d.H, M = B * T;
  const long long MD = (long long)M * D;
  const size_t DF = (size_t)D * F;
  float *sum = S + L.sum, *x0 = S + L.x0;
  auto drop = [&](int site) {
    return make_drop(seeds, d.layer, site, d.thresh, d.keep_scale,
                     d.row0);
  };
  auto ada = [&](int i) { return w.ada + (size_t)i * 2 * D; };
  auto rows = [&](size_t off) { return at<bf16_t>(S, off); };
  TRY(convert(x, x0, MD, st));
  TRY(save_weights_bf(S, L.w, w.ffw1, w.ffw2, w.attw, w.pw1w, w.pw2w,
                      w.posp, T, D, F, st));

  // x1 = LN1(x + drop(MHSA(ada0 x)))
  TRY(ada_rows(x0, rows(L.xa), ada(0), nullptr, T, D, MD, st));
  TRY(att_fwd_bf(rows(L.xa), w.attw, w.vecb, w.posb, w.posp, mask,
                 att_bufs_bf(S, L), x0, sum, false,
                 make_drop(seeds, d.layer, kSiteAttProb, d.att_thresh,
                           d.att_keep_scale, d.row0),
                 drop(kSiteAttOut), B, T, D, H, st));
  TRY(layer_norm(sum, S + L.x1, w.lnw, 0, M, D, eps, nullptr, T, st,
                 S + L.xhat[0], S + L.rstd[0]));
  // x2 = LN2(x1 + drop(FFN1(ada1 x1)))
  TRY(ada_rows(S + L.x1, rows(L.a1), ada(1), nullptr, T, D, MD, st));
  TRY(ffn_fwd_bf(S + L.x1, sum, rows(L.a1), S + L.z0, rows(L.h0), w.ffw1,
                 w.ffb1, w.ffw2, w.vecb + 4 * D, M, D, F, T, 1.f,
                 drop(kSiteFfn1Hidden), drop(kSiteFfn1Out), st));
  TRY(post_norm_bf(S, L, w.lnw, 1, sum, S + L.x2, M, D, eps, T, st));
  // x3 = LN3(x2 + drop(Conv(ada2 x2))), the conv input's rows >= len zero
  TRY(ada_rows(S + L.x2, rows(L.a2), ada(2), lens, T, D, MD, st));
  TRY(conv_fwd_bf(rows(L.a2), w.pw1w, w.pw1b, w.dww, w.vecb + 6 * D, w.cnw,
                  w.pw2w, w.vecb + 7 * D, conv_bufs_bf(S, L), S + L.x2, sum,
                  lens, drop(kSiteConvOut), B, T, D, d.ksize, d.causal,
                  conv_eps, st));
  TRY(layer_norm(sum, S + L.x3, w.lnw, 2, M, D, eps, nullptr, T, st,
                 S + L.xhat[2], S + L.rstd[2]));
  // y = LN4(x3 + drop(FFN2(ada3 x3)))
  TRY(ada_rows(S + L.x3, rows(L.a3), ada(3), nullptr, T, D, MD, st));
  TRY(ffn_fwd_bf(S + L.x3, sum, rows(L.a3), S + L.z1, rows(L.h1),
                 w.ffw1 + DF, w.ffb1 + F, w.ffw2 + DF, w.vecb + 5 * D, M, D,
                 F, T, 1.f, drop(kSiteFfn2Hidden), drop(kSiteFfn2Out), st));
  return post_norm_bf(S, L, w.lnw, 3, sum, out, M, D, eps, T, st);
}

// The bf16 backward from dy (bf16) into dx (bf16) and the grads: through
// each adaptive scale into the residual grad (ada_bwd), the grad of x2
// rounded to bf16 between the halves.
cudaError_t backward_rows_bf(const bf16_t* dy, float* S, const SavedBf& L,
                             float* G, const ScratchBf& W, const int* seeds,
                             const int* lens, const WeightsB& w,
                             const GradsB& g, bf16_t* dx, const Dims& d,
                             cudaStream_t st) {
  const int B = d.B, T = d.T, D = d.D, F = d.F, H = d.H, M = B * T;
  const size_t MD = (size_t)M * D, DF = (size_t)D * F;
  float *dyw = G + W.dyw, *r0 = G + W.r0, *r1 = G + W.r1, *t0 = G + W.t0,
        *t1 = G + W.t1;
  const BlockTmp& b = W.b;
  const Reduce rd = reduce_at(G, W.red);
  auto drop = [&](int site) {
    return make_drop(seeds, d.layer, site, d.thresh, d.keep_scale,
                     d.row0);
  };
  auto rows = [&](size_t off) { return at<const bf16_t>(S, off); };
  // dx_out = base + da * ada i's scale in the rows of lens, and ada i's
  // grads from the rows it scaled, x
  auto ada_grad = [&](const float* base, const float* da, const float* x,
                      int i, float* dx_out, const int* ln) {
    const float* ada = w.ada + (size_t)i * 2 * D;
    float* dada = g.dada + (size_t)i * 2 * D;
    TRY(colsum_bf(da, x, dada, dada + D, M, D, ln, T, rd, st));
    ada_bwd_kernel<<<blocks_for(MD, 256), 256, 0, st>>>(base, da, ada, dx_out,
                                                       ln, T, D, MD);
    return cudaGetLastError();
  };
  TRY(reduce_reset(G, W.red, st));
  TRY(convert(dy, dyw, (long long)MD, st));

  // LN4, FFN2 (its input grad into t1): r0 = ds4, r1 = dx3
  TRY(ln_bwd_bf(dyw, S + L.xhat[3], S + L.rstd[3], w.lnw, g.dlnw, 3, nullptr,
                r0, M, D, nullptr, T, rd, st));
  TRY(ffn_bwd_bf(r0, rows(L.a3), S + L.z1, rows(L.h1), w.ffw1 + DF,
                 w.ffw2 + DF, g.dffw1 + DF, g.dffb1 + F, g.dffw2 + DF,
                 g.dvecb + 5 * D, ffn_tmp(G, b), nullptr, t1, rd, M, D,
                 F, T, 1.f, drop(kSiteFfn2Hidden), drop(kSiteFfn2Out), st));
  TRY(ada_grad(r0, t1, S + L.x3, 3, r1, nullptr));

  // LN3, conv module: r0 = ds3, r1 = dx2 (rounded)
  TRY(ln_bwd_bf(r1, S + L.xhat[2], S + L.rstd[2], w.lnw, g.dlnw, 2, nullptr,
                r0, M, D, nullptr, T, rd, st));
  float* tc[3] = {t0, t1, G + b.cv_t2};
  TRY(conv_bwd_bf(r0, rows(L.a2), conv_bufs_bf(S, L), w.pw1w, w.pw1b, w.dww,
                  w.cnw, w.pw2w, lens, drop(kSiteConvOut), g.dpw2w,
                  g.dvecb + 7 * D, g.dcnw, g.dvecb + 6 * D, g.ddww, g.dpw1b,
                  g.dpw1w, G + b.cv_da, tc, G + b.cv_dg,
                  at<bf16_t>(G, b.cv_t0b), at<bf16_t>(G, b.cv_dgb), rd,
                  B, T, D, d.ksize, d.causal, st));
  TRY(ada_grad(r0, G + b.cv_da, S + L.x2, 2, r1, lens));
  TRY(round_bf16(r1, (long long)MD, st));

  // LN2, FFN1: r0 = ds2, r1 = dx1
  TRY(ln_bwd_bf(r1, S + L.xhat[1], S + L.rstd[1], w.lnw, g.dlnw, 1, nullptr,
                r0, M, D, nullptr, T, rd, st));
  TRY(ffn_bwd_bf(r0, rows(L.a1), S + L.z0, rows(L.h0), w.ffw1, w.ffw2,
                 g.dffw1, g.dffb1, g.dffw2, g.dvecb + 4 * D, ffn_tmp(G, b),
                 nullptr, t1, rd, M, D, F, T, 1.f,
                 drop(kSiteFfn1Hidden), drop(kSiteFfn1Out), st));
  TRY(ada_grad(r0, t1, S + L.x1, 1, r1, nullptr));

  // LN1, attention (its input grad into t1): dx = ds1 + that grad through
  // ada0
  TRY(ln_bwd_bf(r1, S + L.xhat[0], S + L.rstd[0], w.lnw, g.dlnw, 0, nullptr,
                r0, M, D, nullptr, T, rd, st));
  float* ta[6] = {t0, t1, G + b.at_t[0], G + b.at_t[1], G + b.at_t[2],
                  G + b.at_t[3]};
  TRY(att_bwd_bf(r0, rows(L.xa), w.attw, w.posp, att_bufs_bf(S, L),
                 make_drop(seeds, d.layer, kSiteAttProb, d.att_thresh,
                           d.att_keep_scale, d.row0),
                 drop(kSiteAttOut), g.dattw, g.dvecb, g.dposb, g.dposp,
                 nullptr, t1, ta, G + b.at_dP, att_tmp(G, b), rd, B, T,
                 D, H, st));
  TRY(ada_grad(r0, t1, S + L.x0, 0, r1, nullptr));
  return convert(r1, dx, (long long)MD, st);
}

}  // namespace

extern "C" size_t masr_sq_layer_train_saved_floats(int B, int T, int D,
                                                   int F, int H, int bf) {
  return bf ? saved_layout_bf(B, T, D, F, H).total
            : saved_layout(B, T, D, F, H).total;
}

extern "C" size_t masr_sq_layer_train_scratch_floats(int B, int T, int D,
                                                     int F, int H, int bf) {
  return bf ? scratch_layout_bf(B, T, D, F, H).total
            : scratch_layout(B, T, D, F, H).total;
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
// masr_sq_layer_train_saved_floats(.., 0) floats.
extern "C" int masr_sq_layer_train_forward(
    const float* x, const unsigned char* mask, const int* seeds,
    const int* lens, const float* posp, const float* lnw, const float* ada,
    const float* cnw, const float* attw, const float* vecb,
    const float* posb, const float* ffw1, const float* ffb1,
    const float* ffw2, const float* pw1w, const float* pw1b,
    const float* pw2w, const float* dww, float* out, float* saved, int B,
    int T, int D, int F, int n_head, int ksize, int causal, int layer, int row0,
    unsigned thresh, float keep_scale, unsigned att_thresh,
    float att_keep_scale, float eps, float conv_eps, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  if ((D / H) * H != D || (!causal && ksize % 2 == 0))
    return (int)cudaErrorInvalidValue;
  const Weights w = {posp, lnw,  ada,  cnw,  attw, vecb, posb,
                     ffw1, ffb1, ffw2, pw1w, pw1b, pw2w, dww};
  MASR_CHECK(forward_rows(
      x, saved, saved_layout(B, T, D, F, H), mask, seeds, lens, w, out,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      eps, conv_eps, st));
  return (int)cudaGetLastError();
}

// The bf16 mode (the header): x, posp, out and attw, ffw1, ffw2, pw1w,
// pw2w bf16; ada (4,2,D), the four adaptive scales unfolded (the pack of
// pack_sq_layer_params(layer, torch.bfloat16)), attw and ffw1 unscaled;
// the other arrays f32, as the f32 entry (any D, n_head and F it takes).
// saved:
// masr_sq_layer_train_saved_floats(.., 1) floats.
extern "C" int masr_sq_layer_train_forward_bf16(
    const bf16_t* x, const unsigned char* mask, const int* seeds,
    const int* lens, const bf16_t* posp, const float* lnw, const float* ada,
    const float* cnw, const bf16_t* attw, const float* vecb,
    const float* posb, const bf16_t* ffw1, const float* ffb1,
    const bf16_t* ffw2, const bf16_t* pw1w, const float* pw1b,
    const bf16_t* pw2w, const float* dww, bf16_t* out, float* saved, int B,
    int T, int D, int F, int n_head, int ksize, int causal, int layer, int row0,
    unsigned thresh, float keep_scale, unsigned att_thresh,
    float att_keep_scale, float eps, float conv_eps, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  if ((D / H) * H != D || (!causal && ksize % 2 == 0))
    return (int)cudaErrorInvalidValue;
  const WeightsB w = {posp, attw, ffw1, ffw2, pw1w, pw2w, lnw,
                      ada,  cnw,  vecb, posb, ffb1, pw1b, dww};
  MASR_CHECK(forward_rows_bf(
      x, saved, saved_layout_bf(B, T, D, F, H), mask, seeds, lens, w, out,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      eps, conv_eps, st));
  return (int)cudaGetLastError();
}

// dy (B,T,D) -> dx (B,T,D), dposp (T,D) and the grads of the 13 packed
// arrays (same shapes, every element written). x: the forward's input;
// saved: the forward's; scratch: masr_sq_layer_train_scratch_floats(.., 0)
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
    int n_head, int ksize, int causal, int layer, int row0, unsigned thresh,
    float keep_scale, unsigned att_thresh, float att_keep_scale,
    void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  if ((D / H) * H != D || (!causal && ksize % 2 == 0))
    return (int)cudaErrorInvalidValue;
  const Weights w = {posp, lnw,     ada,  cnw,  attw, nullptr, nullptr,
                     ffw1, nullptr, ffw2, pw1w, pw1b, pw2w,    dww};
  const Grads g = {dposp, dlnw,  dada,  dcnw,  dattw, dvecb, dposb,
                   dffw1, dffb1, dffw2, dpw1w, dpw1b, dpw2w, ddww};
  MASR_CHECK(backward_rows(
      dy, x, saved, saved_layout(B, T, D, F, H), scratch,
      scratch_layout(B, T, D, F, H), seeds, lens, w, g, dx,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      st));
  return (int)cudaGetLastError();
}

// The bf16 mode's backward: dy, dx, dposp and the grads of attw, ffw1,
// ffw2, pw1w, pw2w bf16 (each rounded once from its f32 sum), dada (4,2,D)
// and the other grads f32. The product weights, posp and x are read from
// `saved` (the forward copied them); lnw, ada, cnw, pw1b and dww are the
// f32 arrays. scratch: masr_sq_layer_train_scratch_floats(.., 1) floats.
extern "C" int masr_sq_layer_train_backward_bf16(
    const bf16_t* dy, const int* seeds, const int* lens, const float* lnw,
    const float* ada, const float* cnw, const float* pw1b, const float* dww,
    float* saved, float* scratch, bf16_t* dx, bf16_t* dposp, float* dlnw,
    float* dada, float* dcnw, bf16_t* dattw, float* dvecb, float* dposb,
    bf16_t* dffw1, float* dffb1, bf16_t* dffw2, bf16_t* dpw1w, float* dpw1b,
    bf16_t* dpw2w, float* ddww, int B, int T, int D, int F, int n_head,
    int ksize, int causal, int layer, int row0, unsigned thresh,
    float keep_scale, unsigned att_thresh, float att_keep_scale,
    void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int M = B * T, H = n_head;
  if (M == 0) return (int)cudaGetLastError();
  if ((D / H) * H != D || (!causal && ksize % 2 == 0))
    return (int)cudaErrorInvalidValue;
  const SavedBf L = saved_layout_bf(B, T, D, F, H);
  float* S = saved;
  const WeightsB w = {at<bf16_t>(S, L.w.posp), at<bf16_t>(S, L.w.attw),
                      at<bf16_t>(S, L.w.ffw1), at<bf16_t>(S, L.w.ffw2),
                      at<bf16_t>(S, L.w.pw1w), at<bf16_t>(S, L.w.pw2w),
                      lnw,                     ada,
                      cnw,                     nullptr,
                      nullptr,                 nullptr,
                      pw1b,                    dww};
  const GradsB g = {dposp, dattw, dffw1, dffw2, dpw1w, dpw2w, dlnw,
                    dada,  dcnw,  dvecb, dposb, dffb1, dpw1b, ddww};
  MASR_CHECK(backward_rows_bf(
      dy, S, L, scratch, scratch_layout_bf(B, T, D, F, H), seeds, lens, w, g,
      dx,
      make_dims(B, T, D, F, H, ksize, causal, layer, row0, thresh,
                keep_scale, att_thresh, att_keep_scale),
      st));
  return (int)cudaGetLastError();
}
