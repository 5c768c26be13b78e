// Full-context Squeezeformer encoder layer for Hopper (sm_90a), forward
// only, f32 or (its bf16 mode, below) bf16.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/squeezeformer_layer.py:166
// (`fused_squeezeformer_layer`, one pallas_call per layer that keeps the
// whole post-norm layer in VMEM). It computes what that kernel's `_kernel`
// computes, each sublayer as x = LN_i(x + sub(x)):
//
//   x = LN1(x + MHSA(ada0 x))      rel-pos attention over the valid keys
//   x = LN2(x + FFN1(ada1 x))      D -> F -> D, SiLU
//   x = LN3(x + Conv(ada2 x))      GLU -> depthwise(k) -> norm -> SiLU -> pw
//   x = LN4(x + FFN2(ada3 x))
//
// `masr_sq_layer_forward` launches, in order on the caller's stream (17
// launches), the serving kernels' blocks (common.cuh, serving.cuh,
// flash_attention.cuh): a memset of the split products' tile counters, the
// q/k/v product (one of N = 3D), the tensor-core flash attention with the
// key-length mask, the out product with the residual in its epilogue,
// layer_norm_kernel, the FFN products (SiLU and residual epilogues),
// common.cuh's ada_rows, pw1, conv_module_kernel with the folded BatchNorm
// affine or the LN, pw2 with the row-masked residual. Every product is
// serving.cuh's gemm_sk (3xTF32 tensor cores, weights from the serving
// tensor-core pack, the FFN w_2 split into parts fixed by K).
//
// The adaptive scales ada0, ada1 and ada3 are folded into the q/k/v and
// w_1 weights and biases at pack time (ops/cuda/squeezeformer_layer.py
// pack_sq_layer_params), before the tensor-core pack splits them into TF32
// halves: (x s + t) W + b = x (diag(s) W) + (t W + b).
// ada2 is not: rows t >= len are zeroed AFTER it (the conv input of a
// padded row is 0, not ada2's shift), which ada_rows does. The
// conv-module BatchNorm is folded to a per-channel affine from its running
// statistics, exact in eval.
//
// Semantics kept exactly from the Pallas kernel:
//   - causal conv: the k-1 left pad rows carry GLU(pw1 bias); non-causal
//     pads zeros;
//   - rows t in [len, T) enter pw1 as zeros and add nothing after pw2;
//   - attention keys col >= len are masked; a row with len == 0 gives 0.
//
// What bounds it on the H100: the same as the Conformer layer
// (conformer_layer.cu), with which it shares every kernel but one: at the
// flagship shapes (D=256, F=2048, B*T' ~ 2.4k rows at full rate, half that
// at half rate) ~90% of the operations are the eight products. On the f32
// FMA pipes they took ~1.9 ms (full rate) and ~1.4 ms (half rate) a layer;
// on the tensor cores in 3xTF32 the bound is ~0.08 ms of operations, and
// what holds the products below it is the loop's issue and latency, not
// the tensor cores. The half-rate layers fill the SMs worse (~1200 rows:
// 19 row tiles), which the split of the FFN w_2's K = 2048 offsets. Left
// for later: wgmma with TMA, a LayerNorm folded into the next product.
//
// The bf16 mode (`masr_sq_layer_forward_bf16`; the Pallas kernel's `cdt =
// x_ref.dtype`, masr_tpu/ops/pallas/squeezeformer_layer.py:46): x, out and
// pos_p are bf16 and the products' weights one bf16 array each; LN, bias,
// adaptive-scale and folded-BatchNorm rows stay f32, and so do the
// activations inside the layer, as row 1's bf16 mode (conformer_layer.cu):
// x is widened first, the final LN's rows rounded last, every product
// rounds its activation operand to bf16 as its fragments are read
// (mma.sync m16n8k16, f32 sums), the attention rounds [q+u | q+v], [k | p],
// P and v. The adaptive scales are not folded here: ada0, ada1 and ada3 are
// applied to the f32 rows by ada_rows (no row mask) before the q/k/v and
// FFN w_1 products round them, as the Pallas kernel rounds ada(x) at its
// .astype(cdt) (:60, :99); a fold would round x and diag(s) W instead.
// That is 3 launches more than f32 (and the widening and rounding
// converts): 22. Its bound: a layer's operations over the bf16 dense rate
// (989 TFLOP/s), 13.4 GFLOP at the flagship's B=8, T'=299, ~13.5 us.
//
// Plain C interface, loaded with ctypes. Every entry returns the first
// CUDA error of a launch, 0 on success.

#include "serving.cuh"

// Weights: the serving pack (ops/cuda/squeezeformer_layer.py
// pack_sq_layer_params; f32, row-major, contiguous) for what is not a
// product:
//   lnw (4,2,D) LN1..LN4; ada (2,D) the conv module's adaptive scale (the
//   bf16 mode: (4,2,D), the attention's, FFN1's, the conv module's and
//   FFN2's, none folded);
//   cnw (2,D) the conv norm (LN scale/shift, or the folded BatchNorm);
//   vecb (8,D) q,k,v,out biases (ada0 folded in f32), FFN1 and FFN2 w_2
//   biases, depthwise bias, pw2 bias; posb (2,D); ffb1 (2,F) (ada1, ada3
//   folded in f32); pw1b (1,2D) dww (k,D)
// and the serving tensor-core pack (ops/cuda/chunk_layer.py pack_chunk_tc)
// for the products, each weight as its TF32 halves (.., 2, K, N):
//   tc_ffw1 (2,2,D,F) tc_ffw2 (2,2,F,D) tc_qkv (2,D,3D) tc_out (2,D,D)
//   tc_pw1 (2,D,2D) tc_pw2 (2,D,D)
// (the bf16 mode: one bf16 array each, tc_ffw1 (2,D,F) tc_ffw2 (2,F,D)
// tc_qkv (D,3D) tc_out (D,D) tc_pw1 (D,2D) tc_pw2 (D,D)).
// plans: (parts, part) of each product (serving.cuh ChunkProduct order),
// from ops/cuda/conformer_layer.py full_plan(K). x, out: (B, T, D); lens
// (B,) int32; pos_p (T, D) = linear_pos(pos_emb). workspace: M*(2D +
// max(F, 4D)) floats, M = B*T (the bf16 mode: M*(3D + max(F, 4D)));
// partials / counters: the split products' scratch (serving.cuh SplitK).
// The layer for both modes: TW the products' weight type (f32 halves or
// bf16), TX the type of x, out and pos_p; a bf16 x is widened into the
// workspace's last M*D floats first.
template <class TW, class TX>
int sq_layer_run(
    const TX* x_in, const int* lens, const TX* pos_p, const float* lnw,
    const float* ada, const float* cnw, const float* vecb, const float* posb,
    const float* ffb1, const float* pw1b, const float* dww,
    const TW* tc_ffw1, const TW* tc_ffw2, const TW* tc_qkv,
    const TW* tc_out, const TW* tc_pw1, const TW* tc_pw2, const int* plans,
    TX* out, float* workspace, float* partials, long long n_partials,
    unsigned* counters, int n_counters, int B, int T, int D, int F,
    int n_head, int ksize, int causal, int conv_ln, float eps,
    float conv_eps, cudaStream_t stream) {
  constexpr bool BF = is_bf16<TX>;
  const int M = B * T;
  if (M == 0) return (int)cudaGetLastError();
  const int dk = D / n_head;
  if (dk * n_head != D || dk > 128 || (!causal && ksize % 2 == 0))
    return (int)cudaErrorInvalidValue;
  const int D3 = 3 * D;
  const size_t MD = (size_t)M * D;
  SplitPlan plan[kChunkProducts];
  for (int i = 0; i < kChunkProducts; ++i)
    plan[i] = SplitPlan{plans[2 * i], plans[2 * i + 1]};
  const SplitK sk{partials, n_partials, counters, n_counters};
  float* xa = workspace;          // residual sums (M, D)
  float* xb = xa + MD;            // LN outputs (M, D)
  float* big = xb + MD;           // (M, max(F, 4D))
  float *h = big, *qkv = big, *att = big + 3 * MD, *gx = big,
        *y = big + 2 * MD;        // qkv: (M, 3D)
  // x as f32: the input itself, or (bf16) its widened copy, which also
  // takes the final LN's rows before they are rounded into out
  float* xio = big + (size_t)M * (F > 4 * D ? F : 4 * D);
  const float* x = reinterpret_cast<const float*>(x_in);
  if constexpr (BF) {
    MASR_CHECK(convert(x_in, xio, (long long)MD, stream));
    x = xio;
  }
  // the bf16 mode's unfolded adaptive scale i on every row of src, into xa
  // (free at each of its three uses); f32 reads src itself
  auto scaled = [&](const float* src, int i, const float** dst) {
    *dst = src;
    if constexpr (BF) {
      *dst = xa;
      return ada_rows(src, xa, ada + 2 * (size_t)D * i, nullptr, T, D,
                      (long long)MD, stream);
    }
    return cudaGetLastError();
  };
  const float* a_in;

  MASR_CHECK(cudaMemsetAsync(counters, 0, sizeof(unsigned) * n_counters,
                             stream));
  // x = LN1(x + MHSA(ada0 x)), ada0 folded into q/k/v in f32
  MASR_CHECK(scaled(x, 0, &a_in));
  MASR_CHECK(gemm_sk<kBias>(a_in, tc_weight(tc_qkv, D, D3), vecb, qkv,
                            nullptr, M, D3, D, D, D3, 1.f, plan[kQkv], sk,
                            stream));
  MASR_CHECK(length_attention(qkv, pos_p, posb, lens, att, B, T, D, n_head,
                              stream));
  MASR_CHECK(gemm_sk<kResidual>(att, tc_weight(tc_out, D, D), vecb + 3 * D,
                                xa, x, M, D, D, D, D, 1.f, plan[kOut], sk,
                                stream));
  MASR_CHECK(layer_norm(xa, xb, lnw, 0, M, D, eps, nullptr, 1, stream));
  // x = LN2(x + FFN1(ada1 x)), ada1 folded into w_1 in f32
  MASR_CHECK(scaled(xb, 1, &a_in));
  MASR_CHECK(ffn_sk(a_in, h, xa, xb, tc_weight(tc_ffw1, D, F, 0), ffb1,
                    tc_weight(tc_ffw2, F, D, 0), vecb + 4 * D, M, D, F, 1.f,
                    plan, sk, stream));
  MASR_CHECK(layer_norm(xa, xb, lnw, 1, M, D, eps, nullptr, 1, stream));
  // x = LN3(x + Conv(ada2 x)): masked ada rows -> pw1 -> GLU / depthwise /
  // norm / SiLU -> pw2 with the row-masked residual
  MASR_CHECK(ada_rows(xb, xa, BF ? ada + 4 * (size_t)D : ada, lens, T, D,
                      (long long)MD, stream));
  MASR_CHECK(gemm_sk<kBias>(xa, tc_weight(tc_pw1, D, 2 * D), pw1b, gx,
                            nullptr, M, 2 * D, D, D, 2 * D, 1.f, plan[kPw1],
                            sk, stream));
  MASR_CHECK(conv_module(gx, dww, vecb + 6 * D, pw1b, cnw, y, B, T, T, D,
                         ksize, causal ? ksize - 1 : (ksize - 1) / 2, causal,
                         conv_eps, stream, nullptr, nullptr, nullptr,
                         conv_ln != 0));
  MASR_CHECK(gemm_sk<kRowMaskResidual>(y, tc_weight(tc_pw2, D, D),
                                       vecb + 7 * D, xa, xb, M, D, D, D, D,
                                       1.f, plan[kPw2], sk, stream, lens, T));
  MASR_CHECK(layer_norm(xa, xb, lnw, 2, M, D, eps, nullptr, 1, stream));
  // x = LN4(x + FFN2(ada3 x)), ada3 folded into w_1 in f32
  MASR_CHECK(scaled(xb, 3, &a_in));
  MASR_CHECK(ffn_sk(a_in, h, xa, xb, tc_weight(tc_ffw1, D, F, 1), ffb1 + F,
                    tc_weight(tc_ffw2, F, D, 1), vecb + 5 * D, M, D, F, 1.f,
                    plan, sk, stream));
  if constexpr (BF) {
    MASR_CHECK(layer_norm(xa, xio, lnw, 3, M, D, eps, nullptr, 1, stream));
    MASR_CHECK(convert(static_cast<const float*>(xio), out, (long long)MD,
                       stream));
  } else {
    MASR_CHECK(layer_norm(xa, out, lnw, 3, M, D, eps, nullptr, 1, stream));
  }
  return (int)cudaGetLastError();
}

extern "C" int masr_sq_layer_forward(
    const float* x, const int* lens, const float* pos_p, const float* lnw,
    const float* ada, const float* cnw, const float* vecb, const float* posb,
    const float* ffb1, const float* pw1b, const float* dww,
    const float* tc_ffw1, const float* tc_ffw2, const float* tc_qkv,
    const float* tc_out, const float* tc_pw1, const float* tc_pw2,
    const int* plans, float* out, float* workspace, float* partials,
    long long n_partials, unsigned* counters, int n_counters, int B, int T,
    int D, int F, int n_head, int ksize, int causal, int conv_ln, float eps,
    float conv_eps, void* stream_ptr) {
  return sq_layer_run(x, lens, pos_p, lnw, ada, cnw, vecb, posb, ffb1, pw1b,
                      dww, tc_ffw1, tc_ffw2, tc_qkv, tc_out, tc_pw1, tc_pw2,
                      plans, out, workspace, partials, n_partials, counters,
                      n_counters, B, T, D, F, n_head, ksize, causal, conv_ln,
                      eps, conv_eps, (cudaStream_t)stream_ptr);
}

// The bf16 mode: x, pos_p, out bf16, ada (4,2,D) and the products' weights
// tc_* one bf16 array each (see above); the rest as masr_sq_layer_forward's.
extern "C" int masr_sq_layer_forward_bf16(
    const bf16_t* x, const int* lens, const bf16_t* pos_p, const float* lnw,
    const float* ada, const float* cnw, const float* vecb, const float* posb,
    const float* ffb1, const float* pw1b, const float* dww,
    const bf16_t* tc_ffw1, const bf16_t* tc_ffw2, const bf16_t* tc_qkv,
    const bf16_t* tc_out, const bf16_t* tc_pw1, const bf16_t* tc_pw2,
    const int* plans, bf16_t* out, float* workspace, float* partials,
    long long n_partials, unsigned* counters, int n_counters, int B, int T,
    int D, int F, int n_head, int ksize, int causal, int conv_ln, float eps,
    float conv_eps, void* stream_ptr) {
  return sq_layer_run(x, lens, pos_p, lnw, ada, cnw, vecb, posb, ffb1, pw1b,
                      dww, tc_ffw1, tc_ffw2, tc_qkv, tc_out, tc_pw1, tc_pw2,
                      plans, out, workspace, partials, n_partials, counters,
                      n_counters, B, T, D, F, n_head, ksize, causal, conv_ln,
                      eps, conv_eps, (cudaStream_t)stream_ptr);
}
