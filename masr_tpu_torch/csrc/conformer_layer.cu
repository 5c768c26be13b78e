// Full-context Conformer encoder layer for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/conformer_layer.py:188
// (`fused_conformer_layer`, one pallas_call per layer that keeps the whole
// layer in VMEM). On the H100 one block cannot hold a layer, so the layer is
// split into five kinds of kernels, all launched in order on the caller's
// stream by `masr_conformer_layer_forward` (17 launches):
//
//   1. cudaMemsetAsync         the split products' tile counters
//   2. layer_norm_kernel       one warp per row, f32 statistics, optional
//                              zeroing of rows t >= len (the conv input xm)
//   3. gemm_sk_kernel          Y = A.W + b on the tensor cores in 3xTF32,
//                              weights from the serving tensor-core pack,
//                              with a fused epilogue: plain, SiLU, scaled
//                              residual x + s*y, row-masked residual; q/k/v
//                              one product of N = 3D; the FFN w_2 (K = F)
//                              split into parts of K fixed by K alone
//   4. flash_kernel            rel-pos attention over the valid keys, tensor
//                              cores, one block per (utterance, head,
//                              64-query tile), key tiles past the length
//                              skipped (flash_attention.cuh's key-length
//                              mask), reading q, k, v from the q/k/v rows
//   5. conv_module_kernel      GLU -> depthwise conv over time -> LN -> SiLU
// Kinds 2 and 5 live in common.cuh, 3 and the attention's launch in
// serving.cuh, 4 in flash_attention.cuh, shared with the other kernels.
// The macaron FFN reads its residual from x (no copy).
//
// What bounds it on the H100: at the flagship shapes (D=256, F=2048,
// B*T' ~ 2.4k rows) about 90% of the operations are the eight products.
// They ran on the f32 FMA pipes at 5-12 TFLOP/s (~1.87 ms a layer); they
// now run on the tensor cores, where 3xTF32's three TF32 products per
// product peak at 165 TFLOP/s, so the bound is ~0.08 ms of operations. What
// holds the products below it is the loop's issue and latency (each warp's
// fragment reads, the activations' splits into TF32 halves, the 3-deep
// mma chains; see common.cuh's gemm_tc_kernel), not the tensor cores. The
// activations make ~15 round trips through device memory per layer
// (L2-resident at these sizes). Left for later: wgmma with TMA-fed
// pipelines for the products and the attention, a LayerNorm folded into
// the next product, fewer launches.
//
// Semantics kept exactly from the Pallas kernel:
//   - causal conv: the k-1 left pad rows carry GLU(pw1 bias), because the
//     flax module pads before pointwise_conv1; non-causal pads zeros.
//   - rows t in [len, T) are zeroed before pw1, so they carry GLU(pw1 bias).
//   - attention keys col >= len are masked; a row with len == 0 gives 0.
//
// The bf16 mode (`masr_conformer_layer_forward_bf16`; masr_tpu's
// compute dtype bf16, `cdt = x_ref.dtype` in the Pallas kernel): x, out and
// pos_p are bf16 and the products' weights one bf16 array each; LN and bias
// rows stay f32, and so do the activations inside the layer. x is widened
// to f32 first (a convert launch) and the final LN's rows are rounded to
// bf16 last; every product rounds its activation operand to bf16 as its
// fragments are read (the Pallas kernel's .astype(cdt) before each
// matmul) and runs mma.sync m16n8k16 bf16 with f32 accumulation; the
// attention rounds [q+u | q+v], [k | p], P and v (flash_attention.cuh).
// The bound: a layer's operations over the bf16 dense rate (989 TFLOP/s),
// six times 3xTF32's 165.
//
// Plain C interface, loaded with ctypes. Every entry returns
// cudaGetLastError() (or the first error of a launch), 0 on success.

#include "serving.cuh"

// Weights: the serving pack (masr_tpu/ops/pallas/conformer_layer.py:250
// pack_layer_params; f32, row-major, contiguous) for what is not a product:
//   lnw (6,2,D) ffb1 (2,F) vecb (8,D) posb (2,D) pw1b (1,2D) dww (k,D)
// and the serving tensor-core pack (ops/cuda/chunk_layer.py pack_chunk_tc)
// for the products, each weight as its TF32 halves (.., 2, K, N):
//   tc_ffw1 (2,2,D,F) tc_ffw2 (2,2,F,D) tc_qkv (2,D,3D) = [W_q | W_k | W_v]
//   tc_out (2,D,D) tc_pw1 (2,D,2D) tc_pw2 (2,D,D)
// plans: host (parts, part) of each product (ChunkProduct order), from
// ops/cuda/conformer_layer.py full_plan(K). x, out: (B, T, D); lens (B,)
// int32; pos_p (T, D) = linear_pos(pos_emb). workspace: M*(2D + max(F,
// 4D)) floats, M = B*T; partials / counters: the split products' scratch
// (serving.cuh SplitK), n_partials floats and n_counters counters.
// The layer for both modes: TW the products' weight type (f32 halves or
// bf16), TX the type of x, out and pos_p; a bf16 x is widened into the
// workspace's last M*D floats first.
template <class TW, class TX>
int conformer_layer_run(
    const TX* x_in, const int* lens, const TX* pos_p, const float* lnw,
    const float* ffb1, const float* vecb, const float* posb,
    const float* pw1b, const float* dww, const TW* tc_ffw1,
    const TW* tc_ffw2, const TW* tc_qkv, const TW* tc_out,
    const TW* tc_pw1, const TW* tc_pw2, const int* plans, TX* out,
    float* workspace, float* partials, long long n_partials,
    unsigned* counters, int n_counters, int B, int T, int D, int F,
    int n_head, int ksize, int causal, float ff_scale, float eps,
    cudaStream_t stream) {
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
  float* xw = workspace;          // residual stream (M, D)
  float* xn = xw + MD;            // normed rows (M, D)
  float* big = xn + MD;           // (M, max(F, 4D))
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

  MASR_CHECK(cudaMemsetAsync(counters, 0, sizeof(unsigned) * n_counters,
                             stream));
  // macaron FFN (x ff_scale): xw = x + ff_scale FFN(LN(x))
  MASR_CHECK(layer_norm(x, xn, lnw, 0, M, D, eps, nullptr, 1, stream));
  MASR_CHECK(ffn_sk(xn, h, xw, x, tc_weight(tc_ffw1, D, F, 0), ffb1,
                    tc_weight(tc_ffw2, F, D, 0), vecb, M, D, F, ff_scale,
                    plan, sk, stream));
  // rel-pos MHSA: q, k, v from one product
  MASR_CHECK(layer_norm(xw, xn, lnw, 1, M, D, eps, nullptr, 1, stream));
  MASR_CHECK(gemm_sk<kBias>(xn, tc_weight(tc_qkv, D, D3), vecb + 2 * D, qkv,
                            nullptr, M, D3, D, D, D3, 1.f, plan[kQkv], sk,
                            stream));
  MASR_CHECK(length_attention(qkv, pos_p, posb, lens, att, B, T, D, n_head,
                              stream));
  MASR_CHECK(gemm_sk<kResidual>(att, tc_weight(tc_out, D, D), vecb + 5 * D,
                                xw, xw, M, D, D, D, D, 1.f, plan[kOut], sk,
                                stream));
  // conv module: masked LN -> pw1 -> GLU/depthwise/LN/SiLU -> pw2
  MASR_CHECK(layer_norm(xw, xn, lnw, 2, M, D, eps, lens, T, stream));
  MASR_CHECK(gemm_sk<kBias>(xn, tc_weight(tc_pw1, D, 2 * D), pw1b, gx,
                            nullptr, M, 2 * D, D, D, 2 * D, 1.f, plan[kPw1],
                            sk, stream));
  MASR_CHECK(conv_module(gx, dww, vecb + 6 * D, pw1b, lnw + 3 * 2 * (size_t)D,
                         y, B, T, T, D, ksize,
                         causal ? ksize - 1 : (ksize - 1) / 2, causal, eps,
                         stream));
  MASR_CHECK(gemm_sk<kRowMaskResidual>(y, tc_weight(tc_pw2, D, D),
                                       vecb + 7 * D, xw, xw, M, D, D, D, D,
                                       1.f, plan[kPw2], sk, stream, lens, T));
  // final FFN (x ff_scale) + final LN
  MASR_CHECK(layer_norm(xw, xn, lnw, 4, M, D, eps, nullptr, 1, stream));
  MASR_CHECK(ffn_sk(xn, h, xw, xw, tc_weight(tc_ffw1, D, F, 1), ffb1 + F,
                    tc_weight(tc_ffw2, F, D, 1), vecb + D, M, D, F, ff_scale,
                    plan, sk, stream));
  if constexpr (BF) {
    MASR_CHECK(layer_norm(xw, xio, lnw, 5, M, D, eps, nullptr, 1, stream));
    MASR_CHECK(convert(static_cast<const float*>(xio), out, (long long)MD,
                       stream));
  } else {
    MASR_CHECK(layer_norm(xw, out, lnw, 5, M, D, eps, nullptr, 1, stream));
  }
  return (int)cudaGetLastError();
}

extern "C" int masr_conformer_layer_forward(
    const float* x, const int* lens, const float* pos_p, const float* lnw,
    const float* ffb1, const float* vecb, const float* posb,
    const float* pw1b, const float* dww, const float* tc_ffw1,
    const float* tc_ffw2, const float* tc_qkv, const float* tc_out,
    const float* tc_pw1, const float* tc_pw2, const int* plans, float* out,
    float* workspace, float* partials, long long n_partials,
    unsigned* counters, int n_counters, int B, int T, int D, int F,
    int n_head, int ksize, int causal, float ff_scale, float eps,
    void* stream_ptr) {
  return conformer_layer_run(
      x, lens, pos_p, lnw, ffb1, vecb, posb, pw1b, dww, tc_ffw1, tc_ffw2,
      tc_qkv, tc_out, tc_pw1, tc_pw2, plans, out, workspace, partials,
      n_partials, counters, n_counters, B, T, D, F, n_head, ksize, causal,
      ff_scale, eps, (cudaStream_t)stream_ptr);
}

// The bf16 mode: x, pos_p, out (bf16) and the products' weights tc_* one
// bf16 array each (ops/cuda/chunk_layer.py pack_chunk_tc of a bf16 pack):
//   tc_ffw1 (2,D,F) tc_ffw2 (2,F,D) tc_qkv (D,3D) tc_out (D,D) tc_pw1
//   (D,2D) tc_pw2 (D,D)
// the rest as masr_conformer_layer_forward's; workspace M*(3D + max(F,
// 4D)) floats.
extern "C" int masr_conformer_layer_forward_bf16(
    const bf16_t* x, const int* lens, const bf16_t* pos_p, const float* lnw,
    const float* ffb1, const float* vecb, const float* posb,
    const float* pw1b, const float* dww, const bf16_t* tc_ffw1,
    const bf16_t* tc_ffw2, const bf16_t* tc_qkv, const bf16_t* tc_out,
    const bf16_t* tc_pw1, const bf16_t* tc_pw2, const int* plans,
    bf16_t* out, float* workspace, float* partials, long long n_partials,
    unsigned* counters, int n_counters, int B, int T, int D, int F,
    int n_head, int ksize, int causal, float ff_scale, float eps,
    void* stream_ptr) {
  return conformer_layer_run(
      x, lens, pos_p, lnw, ffb1, vecb, posb, pw1b, dww, tc_ffw1, tc_ffw2,
      tc_qkv, tc_out, tc_pw1, tc_pw2, plans, out, workspace, partials,
      n_partials, counters, n_counters, B, T, D, F, n_head, ksize, causal,
      ff_scale, eps, (cudaStream_t)stream_ptr);
}
