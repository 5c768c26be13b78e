// Streaming chunk step of a Conformer encoder layer over B slots, for Hopper
// (sm_90a), forward only, f32 or (its bf16 mode, below) bf16.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/chunk_layer.py:412
// (`fused_chunk_layer`, one pallas_call per layer that keeps a block of
// slots in VMEM). Per slot s it computes exactly what that kernel's `_kernel`
// computes: macaron FFN (x0.5) -> LN -> q/k/v -> rel-pos attention of the c
// chunk rows over L = C + c keys [att cache || chunk] -> out projection ->
// causal conv over [cnn cache || LN(x)] -> FFN (x0.5) -> final LN, and the
// updated caches. `masr_chunk_layer_forward` launches, in order on the
// caller's stream (19 launches; 21 before the tensor-core redesign, which
// made q/k/v one product and read the macaron FFN's residual from x in
// place of a copy):
//
//   1. cudaMemsetAsync           the split products' tile counters
//   2. layer_norm / gemm_sk<EPI> macaron FFN (serving.cuh), residual x
//   3. layer_norm / gemm_sk      q/k/v as one product of N = 3D
//   4. chunk_attention_kernel    one block per (slot, head, 16 query rows),
//                                tensor cores, keys read from the ring in
//                                chronological order (serving.cuh)
//   5. kv_write_kernel           the c fresh K/V rows into the ring
//   6. gemm_sk<kResidual>        out projection + residual
//   7. conv_input_kernel         [cnn cache || LN(x)] -> (B, k-1+c, D)
//   8. cnn_write_kernel          its last k-1 rows into the cnn cache
//   9. gemm_sk / conv_module_kernel  pw1 -> GLU -> VALID depthwise -> LN ->
//                                SiLU (common.cuh) -> pw2 + residual
//  10. layer_norm / gemm_sk      FFN, final LN
//
// State layout (free of the TPU's: no mirror copy, no 128-lane padding, no
// 8-row alignment):
//   - att cache: a single-copy ring per layer, (B, h, C, 2 d_k), K in
//     columns [0, d_k), V in [d_k, 2 d_k). Chronological row j (0 = oldest)
//     of slot s lives at physical row (wptr[s] + j) mod C; cache key j is
//     valid iff j >= C - cache_len[s]. Fresh row i (0 <= i < c) goes to
//     (wptr + i) mod C, which keeps that rule for wptr' = wptr + c: the
//     caller advances wptr. When c > C only the last C fresh rows stay.
//   - cnn cache: (B, k-1, D) LayerNorm rows before pointwise_conv1; zero
//     rows give GLU(pw1 bias), as the full-context causal pad does.
//   - positions: one (rows, D) array of linear_pos(sinusoid) rows and a
//     per-slot start row: slot s reads rows [start[s], start[s] + L). The
//     position-table route passes the per-layer table and the clamped
//     offsets; the exact route passes (B*L, D) rows and starts s*L.
//   - slots with active[s] == 0 are computed but their caches are left
//     untouched: the engine needs no masked merge.
//   - n_sub > 1 (multi-chunk tick): query rows of sub-chunk i see cache
//     keys j >= i*c/n_sub and chunk keys of sub-chunks <= i, exactly n_sub
//     sequential steps (masr_tpu's _sub_chunk_mask_parts).
//
// Read before write: the ring rows a tick overwrites are the oldest ones,
// which this tick's attention still reads, so the K/V write is its own
// launch after the attention kernel (stream order). The cnn cache is
// copied into the conv input buffer before its rows are replaced, so
// c < k-1 is safe too. Kinds 4, 5, 7 and 8 and the products live in
// serving.cuh, shared with chunk_layer_sq.cu (whose half-rate layers read a
// ring whose rows are stored twice: rep = 2 there, 1 here).
//
// What bounds it on the H100: at the engine's shape (B=32 slots, c=16,
// C=256, D=256, F=2048) a layer call is ~2.95 GFLOP (73% FFN) against ~39
// MB of bytes (weights 10.2, cache 16.8, position windows 8.9): on the
// tensor cores in 3xTF32 (three TF32 products per product) ~18 us of
// operations, ~12 us of bytes. At B=1 (predict_stream) ~92 MFLOP against
// ~11 MB of weights: bound by bytes, ~3.3 us. The first version ran its
// products as f32 FMA on 8-32 blocks of the 132 SMs (1.6 ms at B=32, 1.1
// at B=1). Every product now runs serving.cuh's gemm_sk_kernel: 3xTF32
// mma.sync, weights split into TF32 halves once (the serving tensor-core
// pack), K split into parts fixed by N and K (so a slot's bits do not
// depend on the batch) to fill the SMs at one slot and at 32, and the
// attention runs both its products on the tensor cores too; the conv
// module takes blocks of 4 rows (common.cuh), 4 per slot. What is left at
// B=32 (~0.23 ms of device time on the H100): the products at 14-24
// TFLOP/s of counted work, ~69%; the attention ~13%; the conv module ~8%;
// the LayerNorms ~6%. At B=1 the host sets the pace (0.14-0.24 ms of
// Python, checks and 19 launches against ~0.14 ms of device time). Later:
// fewer launches (CUDA graphs), wgmma.
//
// The bf16 mode (`masr_chunk_layer_forward_bf16`; the Pallas kernel's
// `cdt = x_ref.dtype`, masr_tpu/ops/pallas/chunk_layer.py:95): x, out, the
// position rows and both caches are bf16, and the products' weights one
// bf16 array each; LN and bias rows and the activations inside the layer
// stay f32. x is widened first and the final LN's rows rounded last; the
// products round their activation operand to bf16 (mma.sync m16n8k16,
// f32 accumulation); the attention rounds [q+bu | q+bv], [k | p], P and v
// and reads the bf16 ring as it is; the fresh K/V rows are rounded into
// the ring (kv_write_kernel) and the conv input's last k-1 rows into the
// cnn cache (cnn_write_kernel), where masr_tpu casts them to the cache
// dtype (chunk_layer.py:282, :294). Inactive slots' caches are not
// written, as in f32.
//
// Plain C interface, loaded with ctypes. The entry returns the first CUDA
// error of a launch, 0 on success.

#include "serving.cuh"

// Weights: the serving pack (masr_tpu/ops/pallas/conformer_layer.py:250
// pack_layer_params; f32, row-major, contiguous) for what is not a product:
//   lnw (6,2,D) ffb1 (2,F) vecb (8,D) posb (2,D) pw1b (1,2D) dww (k,D)
// and the serving tensor-core pack (ops/cuda/chunk_layer.py pack_chunk_tc)
// for the products, each weight as its TF32 halves (.., 2, K, N):
//   tc_ffw1 (2,2,D,F) tc_ffw2 (2,2,F,D) tc_qkv (2,D,3D) = [W_q | W_k | W_v]
//   tc_out (2,D,D) tc_pw1 (2,D,2D) tc_pw2 (2,D,D)
// plans: host (parts, part) of each product (ChunkProduct order), from
// split_plan(N, K). x, out: (B, c, D); pos: (rows, D); pos_starts,
// cache_lens, wptrs, active: (B,) int32; att_cache (B, h, C, 2 d_k) and
// cnn_cache (B, k-1, D) are updated in place for active slots.
// workspace: M*(3D + max(F, 4D)) + B*(k-1+c)*3D floats, M = B*c;
// partials / counters: the split products' scratch (serving.cuh SplitK),
// n_partials floats and n_counters counters.
// The step for both modes: TW the products' weight type (f32 halves or
// bf16), TS the type of x, out, pos and the caches; a bf16 x is widened
// into the workspace's last M*D floats first.
template <class TW, class TS>
int chunk_layer_run(
    const TS* x_in, const TS* pos, const int* pos_starts, TS* att_cache,
    TS* cnn_cache, const int* cache_lens, const int* wptrs,
    const int* active, const float* lnw, const float* ffb1,
    const float* vecb, const float* posb, const float* pw1b,
    const float* dww, const TW* tc_ffw1, const TW* tc_ffw2,
    const TW* tc_qkv, const TW* tc_out, const TW* tc_pw1, const TW* tc_pw2,
    const int* plans, TS* out, float* workspace, float* partials,
    long long n_partials, unsigned* counters, int n_counters, int B, int c,
    int C, int D, int F, int n_head, int ksize, int n_sub, float ff_scale,
    float eps, cudaStream_t stream) {
  constexpr bool BF = is_bf16<TS>;
  const int M = B * c;
  if (M == 0) return (int)cudaGetLastError();
  const int dk = D / n_head;
  if (dk * n_head != D || dk > 128 || ksize < 2 || n_sub < 1 ||
      c % n_sub != 0 || C < 0 || (n_sub > 1 && c > C))
    return (int)cudaErrorInvalidValue;
  const int K1 = ksize - 1, W = K1 + c, D3 = 3 * D;
  const size_t MD = (size_t)M * D;
  SplitPlan plan[kChunkProducts];
  for (int i = 0; i < kChunkProducts; ++i)
    plan[i] = SplitPlan{plans[2 * i], plans[2 * i + 1]};
  const SplitK sk{partials, n_partials, counters, n_counters};
  float* xw = workspace;                      // residual stream (M, D)
  float* xn = xw + MD;                        // normed rows (M, D)
  float* big = xn + MD;                       // (M, max(F, 4D))
  float* cin = big + (size_t)M * (F > 4 * D ? F : 4 * D);  // (B, W, D)
  float* gx = cin + (size_t)B * W * D;        // (B, W, 2D)
  float* y = gx + (size_t)B * W * 2 * D;      // (M, D)
  float *h = big, *qkv = big, *att = big + 3 * MD;   // qkv: (M, 3D)
  // x as f32: the input itself, or (bf16) its widened copy, which also
  // takes the final LN's rows before they are rounded into out
  float* xio = y + MD;
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
  // rel-pos MHSA over [ring cache || chunk]; q, k, v from one product
  MASR_CHECK(layer_norm(xw, xn, lnw, 1, M, D, eps, nullptr, 1, stream));
  MASR_CHECK(gemm_sk<kBias>(xn, tc_weight(tc_qkv, D, D3), vecb + 2 * D, qkv,
                            nullptr, M, D3, D, D, D3, 1.f, plan[kQkv], sk,
                            stream));
  const float *q = qkv, *k = qkv + D, *v = qkv + 2 * D;
  MASR_CHECK(chunk_attention(q, k, v, static_cast<const TS*>(att_cache), pos,
                             pos_starts, posb, cache_lens, wptrs, att, B, c,
                             C, 1, D, D3, n_head, c / n_sub, stream));
  // every read of the ring is done (stream order): write the fresh rows
  MASR_CHECK(kv_write(k, v, att_cache, wptrs, active, B, c, C, 1, D, D3,
                      n_head, stream));
  MASR_CHECK(gemm_sk<kResidual>(att, tc_weight(tc_out, D, D), vecb + 5 * D,
                                xw, xw, M, D, D, D, D, 1.f, plan[kOut], sk,
                                stream));
  // conv module over [cnn cache || LN(x)]: pw1 -> GLU -> VALID depthwise
  // -> LN -> SiLU -> pw2
  MASR_CHECK(layer_norm(xw, xn, lnw, 2, M, D, eps, nullptr, 1, stream));
  MASR_CHECK(conv_input(xn, nullptr, cin, cnn_cache, active, B, c, K1, D,
                        stream));
  MASR_CHECK(gemm_sk<kBias>(cin, tc_weight(tc_pw1, D, 2 * D), pw1b, gx,
                            nullptr, B * W, 2 * D, D, D, 2 * D, 1.f,
                            plan[kPw1], sk, stream));
  MASR_CHECK(conv_module(gx, dww, vecb + 6 * D, pw1b, lnw + 3 * 2 * (size_t)D,
                         y, B, W, c, D, ksize, 0, 0, eps, stream, nullptr,
                         nullptr, nullptr, true, kConvRowsChunk));
  MASR_CHECK(gemm_sk<kResidual>(y, tc_weight(tc_pw2, D, D), vecb + 7 * D, xw,
                                xw, M, D, D, D, D, 1.f, plan[kPw2], sk,
                                stream));
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

extern "C" int masr_chunk_layer_forward(
    const float* x, const float* pos, const int* pos_starts,
    float* att_cache, float* cnn_cache, const int* cache_lens,
    const int* wptrs, const int* active, const float* lnw, const float* ffb1,
    const float* vecb, const float* posb, const float* pw1b,
    const float* dww, const float* tc_ffw1, const float* tc_ffw2,
    const float* tc_qkv, const float* tc_out, const float* tc_pw1,
    const float* tc_pw2, const int* plans, float* out, float* workspace,
    float* partials, long long n_partials, unsigned* counters,
    int n_counters, int B, int c, int C, int D, int F, int n_head, int ksize,
    int n_sub, float ff_scale, float eps, void* stream_ptr) {
  return chunk_layer_run(
      x, pos, pos_starts, att_cache, cnn_cache, cache_lens, wptrs, active,
      lnw, ffb1, vecb, posb, pw1b, dww, tc_ffw1, tc_ffw2, tc_qkv, tc_out,
      tc_pw1, tc_pw2, plans, out, workspace, partials, n_partials, counters,
      n_counters, B, c, C, D, F, n_head, ksize, n_sub, ff_scale, eps,
      (cudaStream_t)stream_ptr);
}

// The bf16 mode: x, pos, att_cache, cnn_cache, out bf16 and the products'
// weights tc_* one bf16 array each (ops/cuda/chunk_layer.py pack_chunk_tc
// of a bf16 pack): tc_ffw1 (2,D,F) tc_ffw2 (2,F,D) tc_qkv (D,3D) tc_out
// (D,D) tc_pw1 (D,2D) tc_pw2 (D,D); the rest as masr_chunk_layer_forward's;
// workspace M*(4D + max(F, 4D)) + B*(k-1+c)*3D floats.
extern "C" int masr_chunk_layer_forward_bf16(
    const bf16_t* x, const bf16_t* pos, const int* pos_starts,
    bf16_t* att_cache, bf16_t* cnn_cache, const int* cache_lens,
    const int* wptrs, const int* active, const float* lnw, const float* ffb1,
    const float* vecb, const float* posb, const float* pw1b,
    const float* dww, const bf16_t* tc_ffw1, const bf16_t* tc_ffw2,
    const bf16_t* tc_qkv, const bf16_t* tc_out, const bf16_t* tc_pw1,
    const bf16_t* tc_pw2, const int* plans, bf16_t* out, float* workspace,
    float* partials, long long n_partials, unsigned* counters,
    int n_counters, int B, int c, int C, int D, int F, int n_head, int ksize,
    int n_sub, float ff_scale, float eps, void* stream_ptr) {
  return chunk_layer_run(
      x, pos, pos_starts, att_cache, cnn_cache, cache_lens, wptrs, active,
      lnw, ffb1, vecb, posb, pw1b, dww, tc_ffw1, tc_ffw2, tc_qkv, tc_out,
      tc_pw1, tc_pw2, plans, out, workspace, partials, n_partials, counters,
      n_counters, B, c, C, D, F, n_head, ksize, n_sub, ff_scale, eps,
      (cudaStream_t)stream_ptr);
}

// One serving product alone, in the bf16 mode: out (M, N) bf16 = x (M, K)
// bf16 . w (K, N) bf16 with f32 sums, rounded once to bf16; no bias (the
// caller adds it in bf16, flax's order). Every bf16 Linear and pointwise
// conv of the port runs here (models/layers.py half_product), the
// Conformer's subsampling output product (masr_tpu/models/subsampling.py
// :69, K = 4864 at the flagship's widths) first: not through cuBLAS, whose
// algorithm, and so the order of its sums, follows M: one bf16 rounding
// apart in ~1e-4 of the outputs flips near ties twelve layers later. With
// gemm_sk and the caller's plan (split_plan(N, K), never M) an output row's
// bits are the same whatever M is, so a stream's window gives alone the
// bits it gives in the engine's batch. x is widened into the workspace
// (exact), the sums land there in f32 and are rounded into out: 4 launches.
// plan: host (parts, part); zero_bias: N zero floats (the kBias epilogue's
// row); workspace: M*K + M*N floats; partials / counters as the layer's.
extern "C" int masr_serving_product_bf16(
    const bf16_t* x, const bf16_t* w, const float* zero_bias,
    const int* plan, bf16_t* out, float* workspace, float* partials,
    long long n_partials, unsigned* counters, int n_counters, int M, int N,
    int K, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float* xf = workspace;
  float* y = workspace + (size_t)M * K;
  const SplitK sk{partials, n_partials, counters, n_counters};
  if (n_counters > 0)
    MASR_CHECK(cudaMemsetAsync(counters, 0, sizeof(unsigned) * n_counters,
                               stream));
  MASR_CHECK(convert(x, xf, (long long)M * K, stream));
  MASR_CHECK(gemm_sk<kBias>(xf, BfWeight{w}, zero_bias, y, nullptr, M, N, K,
                            K, N, 1.f, SplitPlan{plan[0], plan[1]}, sk,
                            stream));
  MASR_CHECK(convert(static_cast<const float*>(y), out, (long long)M * N,
                     stream));
  return (int)cudaGetLastError();
}
