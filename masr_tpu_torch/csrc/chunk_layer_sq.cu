// Streaming chunk step of a Squeezeformer encoder layer over B slots, for
// Hopper (sm_90a), forward only, f32 or (its bf16 mode, below) bf16.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/chunk_layer_sq.py:181
// (`fused_chunk_layer_sq`, one pallas_call per layer over a block of slots
// in VMEM). Per slot it computes what that kernel's `_kernel` computes, the
// post-norm block with the caches:
//
//   x = LN1(x + MHSA(ada0 x))   the c chunk rows over L = C + c keys
//                               [att cache || chunk], per-slot cache_len
//                               and positions, n_sub block-causal ticks
//   x = LN2(x + FFN1(ada1 x))
//   x = LN3(x + Conv(ada2 x))   causal conv over [cnn cache || ada2 x]
//   x = LN4(x + FFN2(ada3 x))
//
// and the updated caches. `masr_chunk_layer_sq_forward` launches, in order
// on the caller's stream (18 launches; 19 before the tensor-core redesign),
// the blocks it shares with the Conformer chunk kernel (chunk_layer.cu;
// common.cuh, serving.cuh): the split products' counters (a memset), the
// q/k/v product (one of N = 3D), chunk_attention_kernel, kv_write_kernel
// (after every read of the ring), the out product with the residual,
// layer_norm_kernel, the FFN products, conv_input_kernel with ada2 (the cnn
// cache holds post-ada rows, as SqueezeformerConvModule applies ada before
// ConvolutionModule takes the cache), cnn_write_kernel, pw1,
// conv_module_kernel (VALID depthwise, the folded BatchNorm affine or the
// LN), pw2 with the residual. Every product is serving.cuh's gemm_sk
// (3xTF32 tensor cores, split-K fixed by N and K). ada0, ada1, ada3 come
// folded into the weights (see squeezeformer_layer.cu).
//
// State layout: the Conformer chunk kernel's single-copy att ring with
// per-slot write pointers (chunk_layer.cu), which also serves the
// half-rate layers between the time reduction and the recover step. Such
// a layer runs at (c/2, C/2) on the same (B, H, C, 2 d_k) array as the
// full-rate layers: its logical ring row p is stored twice, in memory rows
// 2p and 2p + 1 (rep = 2, serving.cuh), as masr_tpu stores its half-rate
// cache repeated at full resolution; it reads rows 2p + 1 (masr_tpu's
// stride-2 slice 1::2) and writes both. The encoder passes it cache_len / 2
// and wptr / 2: with an even chunk and an even C every wptr is even, so
// chronological row j of the full ring sits at a physical row of the same
// parity, and the odd rows are a C/2 ring with pointer wptr / 2. Inactive
// slots are computed but their caches stay untouched.
//
// What bounds it on the H100: as the Conformer chunk kernel. At the
// engine's shape (B=32 slots, c=16, C=256, D=256, F=2048) a full-rate call
// is ~3.1 GFLOP (FFN three quarters of it) against ~40 MB of bytes
// (weights ~10 MB, cache rows, position windows): ~19 us of 3xTF32
// operations on the tensor cores; a half-rate call (c=8, C=128) has half
// the rows. At B=1 (predict_stream) it is bound by the ~10 MB of weights,
// ~3 us. Its products and attention run on the tensor cores as
// chunk_layer.cu's (the first version's f32 FMA products took 1.7 / 1.5
// ms at B=32); what is left is as there, with a larger conv module (k =
// 31: ~12% of the device time at B=32), and at B=1 the host's launches.
//
// The bf16 mode (`masr_chunk_layer_sq_forward_bf16`; the Pallas kernel's
// `cdt = x_ref.dtype`, masr_tpu/ops/pallas/chunk_layer_sq.py:49): x, out,
// the position rows and both caches are bf16, the products' weights one
// bf16 array each, the LN, bias, adaptive-scale and folded-BatchNorm rows
// and the activations inside the layer f32, as row 2's bf16 mode
// (chunk_layer.cu) with row 6's unfolded adaptive scales
// (squeezeformer_layer.cu): ada0, ada1 and ada3 applied to the f32 rows
// (ada_rows) before the q/k/v and FFN w_1 products round them (:63, :111),
// ada2 by conv_input as in f32. The attention reads the bf16 ring and
// position rows as they are; kv_write_kernel rounds each fresh K/V row to
// bf16 once and writes that value to every copy (rep = 2: rows 2p and
// 2p + 1 bitwise equal), where masr_tpu casts its new rows to the cache
// dtype (:136-140); cnn_write_kernel rounds the new cnn cache rows (:156).
// Inactive slots' caches are not written, as in f32. 23 launches (f32:
// 18). Its bound: the bf16 bytes (each weight, cache row and position row
// read once, each output and new cache row written once) over 3.35 TB/s,
// or its operations over 989 TFLOP/s, whichever is larger.
//
// Plain C interface, loaded with ctypes. Every entry returns the first
// CUDA error of a launch, 0 on success.

#include "serving.cuh"

// Weights: the serving pack (ops/cuda/squeezeformer_layer.py
// pack_sq_layer_params, see squeezeformer_layer.cu) for what is not a
// product: lnw, ada, cnw, vecb, posb, ffb1, pw1b, dww; and the serving
// tensor-core pack (ops/cuda/chunk_layer.py pack_chunk_tc) for the
// products, as chunk_layer.cu. plans: host (parts, part) per product
// (ChunkProduct order). x, out: (B, c, D); pos: (rows, D); pos_starts,
// cache_lens, wptrs, active: (B,) int32, cache_lens and wptrs at the
// layer's rate; att_cache (B, h, C*rep, 2 d_k), C the layer's ring rows;
// cnn_cache (B, k-1, D); both updated in place for active slots.
// workspace: M*(3D + max(F, 4D)) + B*(k-1+c)*3D floats, M = B*c (the bf16
// mode: M*D more); partials / counters: the split products' scratch
// (serving.cuh SplitK).
// The step for both modes: TW the products' weight type (f32 halves or
// bf16), TS the type of x, out, pos and the caches; a bf16 x is widened
// into the workspace's last M*D floats first.
template <class TW, class TS>
int chunk_layer_sq_run(
    const TS* x_in, const TS* pos, const int* pos_starts, TS* att_cache,
    TS* cnn_cache, const int* cache_lens, const int* wptrs,
    const int* active, const float* lnw, const float* ada, const float* cnw,
    const float* vecb, const float* posb, const float* ffb1,
    const float* pw1b, const float* dww, const TW* tc_ffw1,
    const TW* tc_ffw2, const TW* tc_qkv, const TW* tc_out, const TW* tc_pw1,
    const TW* tc_pw2, const int* plans, TS* out, float* workspace,
    float* partials, long long n_partials, unsigned* counters,
    int n_counters, int B, int c, int C, int rep, int D, int F, int n_head,
    int ksize, int n_sub, int conv_ln, float eps, float conv_eps,
    cudaStream_t stream) {
  constexpr bool BF = is_bf16<TS>;
  const int M = B * c;
  if (M == 0) return (int)cudaGetLastError();
  const int dk = D / n_head;
  if (dk * n_head != D || dk > 128 || ksize < 2 || n_sub < 1 ||
      c % n_sub != 0 || C < 0 || rep < 1 || (n_sub > 1 && c > C))
    return (int)cudaErrorInvalidValue;
  const int K1 = ksize - 1, W = K1 + c, D3 = 3 * D;
  const size_t MD = (size_t)M * D;
  SplitPlan plan[kChunkProducts];
  for (int i = 0; i < kChunkProducts; ++i)
    plan[i] = SplitPlan{plans[2 * i], plans[2 * i + 1]};
  const SplitK sk{partials, n_partials, counters, n_counters};
  float* xa = workspace;                      // residual sums (M, D)
  float* xb = xa + MD;                        // LN outputs (M, D)
  float* big = xb + MD;                       // (M, max(F, 4D))
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
  // the bf16 mode's unfolded adaptive scale i on every row of src, into xa
  // (free at each of its three uses); f32 reads src itself
  auto scaled = [&](const float* src, int i, const float** dst) {
    *dst = src;
    if constexpr (BF) {
      *dst = xa;
      return ada_rows(src, xa, ada + 2 * (size_t)D * i, nullptr, c, D,
                      (long long)MD, stream);
    }
    return cudaGetLastError();
  };
  const float* a_in;

  MASR_CHECK(cudaMemsetAsync(counters, 0, sizeof(unsigned) * n_counters,
                             stream));
  // x = LN1(x + MHSA(ada0 x)) over [ring cache || chunk]; q, k, v from one
  // product
  MASR_CHECK(scaled(x, 0, &a_in));
  MASR_CHECK(gemm_sk<kBias>(a_in, tc_weight(tc_qkv, D, D3), vecb, qkv,
                            nullptr, M, D3, D, D, D3, 1.f, plan[kQkv], sk,
                            stream));
  const float *q = qkv, *k = qkv + D, *v = qkv + 2 * D;
  MASR_CHECK(chunk_attention(q, k, v, static_cast<const TS*>(att_cache), pos,
                             pos_starts, posb, cache_lens, wptrs, att, B, c,
                             C, rep, D, D3, n_head, c / n_sub, stream));
  // every read of the ring is done (stream order): write the fresh rows
  MASR_CHECK(kv_write(k, v, att_cache, wptrs, active, B, c, C, rep, D, D3,
                      n_head, stream));
  MASR_CHECK(gemm_sk<kResidual>(att, tc_weight(tc_out, D, D), vecb + 3 * D,
                                xa, x, M, D, D, D, D, 1.f, plan[kOut], sk,
                                stream));
  MASR_CHECK(layer_norm(xa, xb, lnw, 0, M, D, eps, nullptr, 1, stream));
  // x = LN2(x + FFN1(ada1 x))
  MASR_CHECK(scaled(xb, 1, &a_in));
  MASR_CHECK(ffn_sk(a_in, h, xa, xb, tc_weight(tc_ffw1, D, F, 0), ffb1,
                    tc_weight(tc_ffw2, F, D, 0), vecb + 4 * D, M, D, F, 1.f,
                    plan, sk, stream));
  MASR_CHECK(layer_norm(xa, xb, lnw, 1, M, D, eps, nullptr, 1, stream));
  // x = LN3(x + Conv(ada2 x)) over [cnn cache || ada2 x]: pw1 -> GLU ->
  // VALID depthwise -> norm -> SiLU -> pw2
  MASR_CHECK(conv_input(xb, BF ? ada + 4 * (size_t)D : ada, cin, cnn_cache,
                        active, B, c, K1, D, stream));
  MASR_CHECK(gemm_sk<kBias>(cin, tc_weight(tc_pw1, D, 2 * D), pw1b, gx,
                            nullptr, B * W, 2 * D, D, D, 2 * D, 1.f,
                            plan[kPw1], sk, stream));
  MASR_CHECK(conv_module(gx, dww, vecb + 6 * D, pw1b, cnw, y, B, W, c, D,
                         ksize, 0, 0, conv_eps, stream, nullptr, nullptr,
                         nullptr, conv_ln != 0, kConvRowsChunk));
  MASR_CHECK(gemm_sk<kResidual>(y, tc_weight(tc_pw2, D, D), vecb + 7 * D, xa,
                                xb, M, D, D, D, D, 1.f, plan[kPw2], sk,
                                stream));
  MASR_CHECK(layer_norm(xa, xb, lnw, 2, M, D, eps, nullptr, 1, stream));
  // x = LN4(x + FFN2(ada3 x))
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

extern "C" int masr_chunk_layer_sq_forward(
    const float* x, const float* pos, const int* pos_starts,
    float* att_cache, float* cnn_cache, const int* cache_lens,
    const int* wptrs, const int* active, const float* lnw, const float* ada,
    const float* cnw, const float* vecb, const float* posb,
    const float* ffb1, const float* pw1b, const float* dww,
    const float* tc_ffw1, const float* tc_ffw2, const float* tc_qkv,
    const float* tc_out, const float* tc_pw1, const float* tc_pw2,
    const int* plans, float* out, float* workspace, float* partials,
    long long n_partials, unsigned* counters, int n_counters, int B, int c,
    int C, int rep, int D, int F, int n_head, int ksize, int n_sub,
    int conv_ln, float eps, float conv_eps, void* stream_ptr) {
  return chunk_layer_sq_run(
      x, pos, pos_starts, att_cache, cnn_cache, cache_lens, wptrs, active,
      lnw, ada, cnw, vecb, posb, ffb1, pw1b, dww, tc_ffw1, tc_ffw2, tc_qkv,
      tc_out, tc_pw1, tc_pw2, plans, out, workspace, partials, n_partials,
      counters, n_counters, B, c, C, rep, D, F, n_head, ksize, n_sub,
      conv_ln, eps, conv_eps, (cudaStream_t)stream_ptr);
}

// The bf16 mode: x, pos, att_cache, cnn_cache, out bf16, ada (4,2,D) and
// the products' weights tc_* one bf16 array each (squeezeformer_layer.cu);
// the rest as masr_chunk_layer_sq_forward's.
extern "C" int masr_chunk_layer_sq_forward_bf16(
    const bf16_t* x, const bf16_t* pos, const int* pos_starts,
    bf16_t* att_cache, bf16_t* cnn_cache, const int* cache_lens,
    const int* wptrs, const int* active, const float* lnw, const float* ada,
    const float* cnw, const float* vecb, const float* posb,
    const float* ffb1, const float* pw1b, const float* dww,
    const bf16_t* tc_ffw1, const bf16_t* tc_ffw2, const bf16_t* tc_qkv,
    const bf16_t* tc_out, const bf16_t* tc_pw1, const bf16_t* tc_pw2,
    const int* plans, bf16_t* out, float* workspace, float* partials,
    long long n_partials, unsigned* counters, int n_counters, int B, int c,
    int C, int rep, int D, int F, int n_head, int ksize, int n_sub,
    int conv_ln, float eps, float conv_eps, void* stream_ptr) {
  return chunk_layer_sq_run(
      x, pos, pos_starts, att_cache, cnn_cache, cache_lens, wptrs, active,
      lnw, ada, cnw, vecb, posb, ffb1, pw1b, dww, tc_ffw1, tc_ffw2, tc_qkv,
      tc_out, tc_pw1, tc_pw2, plans, out, workspace, partials, n_partials,
      counters, n_counters, B, c, C, rep, D, F, n_head, ksize, n_sub,
      conv_ln, eps, conv_eps, (cudaStream_t)stream_ptr);
}
