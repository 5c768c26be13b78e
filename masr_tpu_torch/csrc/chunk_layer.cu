// Streaming chunk step of a Conformer encoder layer over B slots, for Hopper
// (sm_90a), forward only, f32.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/chunk_layer.py:412
// (`fused_chunk_layer`, one pallas_call per layer that keeps a block of
// slots in VMEM). Per slot s it computes exactly what that kernel's `_kernel`
// computes: macaron FFN (x0.5) -> LN -> q/k/v -> rel-pos attention of the c
// chunk rows over L = C + c keys [att cache || chunk] -> out projection ->
// causal conv over [cnn cache || LN(x)] -> FFN (x0.5) -> final LN, and the
// updated caches. `masr_chunk_layer_forward` launches, in order on the
// caller's stream:
//
//   1. cudaMemcpyAsync           x into the residual buffer
//   2. layer_norm / gemm<EPI>    macaron FFN, q/k/v (common.cuh)
//   3. chunk_attention_kernel    one block per (slot, head, 16 query rows);
//                                online softmax over 32-key tiles, keys
//                                read from the ring in chronological order
//   4. kv_write_kernel           the c fresh K/V rows into the ring
//   5. gemm<kResidual>           out projection + residual
//   6. conv_input_kernel         [cnn cache || LN(x)] -> (B, k-1+c, D)
//   7. cnn_write_kernel          its last k-1 rows into the cnn cache
//   8. gemm / conv_module_kernel pw1 -> GLU -> VALID depthwise -> LN -> SiLU
//                                -> pw2 + residual (common.cuh)
//   9. layer_norm / gemm<EPI>    FFN, final LN
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
// c < k-1 is safe too. Kinds 3, 4, 6 and 7 live in serving.cuh, shared
// with chunk_layer_sq.cu (whose half-rate layers read a ring whose rows are
// stored twice: rep = 2 there, 1 here).
//
// What bounds it on the H100: at the engine's shape (B=32 slots, c=16,
// C=256, D=256, F=2048) a layer call is ~2.95 GFLOP (73% FFN) against ~39
// MB of bytes (weights 10.2, cache 16.8, position windows 8.9): bound by
// operations, ~44 us at the f32 rate outside the tensor cores. At B=1
// (predict_stream) it is ~92 MFLOP against ~11 MB of weights: bound by
// bytes, ~3.3 us. This first version is right and simple, not fast: the
// GEMMs run f32 FMA from shared memory on 64x64 tiles, and at M = B*c =
// 512 (or 16) rows they fill 8-32 blocks of the 132 SMs. What later work
// should do about that: split-K or narrower tiles for small M, bf16/TF32
// operands on wgmma, and fusing the small launches.
//
// Plain C interface, loaded with ctypes. The entry returns the first CUDA
// error of a launch, 0 on success.

#include "serving.cuh"

// Packed weights as masr_tpu/ops/pallas/conformer_layer.py:250
// pack_layer_params (all f32, row-major, contiguous):
//   lnw (6,2,D) ffw1 (2,D,F) ffb1 (2,F) ffw2 (2,F,D) vecb (8,D) attw (4,D,D)
//   posb (2,D) pw1w (D,2D) pw1b (1,2D) pw2w (D,D) dww (k,D)
// x, out: (B, c, D); pos: (rows, D); pos_starts, cache_lens, wptrs,
// active: (B,) int32; att_cache (B, h, C, 2 d_k) and cnn_cache (B, k-1, D)
// are updated in place for active slots.
// workspace: M*(3D + max(F, 4D)) + B*(k-1+c)*3D floats, M = B*c.
extern "C" int masr_chunk_layer_forward(
    const float* x, const float* pos, const int* pos_starts,
    float* att_cache, float* cnn_cache, const int* cache_lens,
    const int* wptrs, const int* active, const float* lnw,
    const float* ffw1, const float* ffb1, const float* ffw2,
    const float* vecb, const float* attw, const float* posb,
    const float* pw1w, const float* pw1b, const float* pw2w,
    const float* dww, float* out, float* workspace, int B, int c, int C,
    int D, int F, int n_head, int ksize, int n_sub, float ff_scale,
    float eps, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = B * c;
  if (M == 0) return (int)cudaGetLastError();
  const int dk = D / n_head;
  if (dk * n_head != D || dk > 128 || ksize < 2 || n_sub < 1 ||
      c % n_sub != 0 || C < 0 || (n_sub > 1 && c > C))
    return (int)cudaErrorInvalidValue;
  const int K1 = ksize - 1, W = K1 + c;
  const size_t MD = (size_t)M * D;
  float* xw = workspace;                      // residual stream (M, D)
  float* xn = xw + MD;                        // normed rows (M, D)
  float* big = xn + MD;                       // (M, max(F, 4D))
  float* cin = big + (size_t)M * (F > 4 * D ? F : 4 * D);  // (B, W, D)
  float* gx = cin + (size_t)B * W * D;        // (B, W, 2D)
  float* y = gx + (size_t)B * W * 2 * D;      // (M, D)
  float *h = big, *q = big, *k = big + MD, *v = big + 2 * MD,
        *att = big + 3 * MD;

  MASR_CHECK(cudaMemcpyAsync(xw, x, MD * sizeof(float),
                             cudaMemcpyDeviceToDevice, stream));
  // macaron FFN (x ff_scale)
  MASR_CHECK(ffn_residual(xw, xn, h, lnw, 0, ffw1, ffb1, ffw2, vecb, M, D, F,
                          ff_scale, eps, stream));
  // rel-pos MHSA over [ring cache || chunk]
  MASR_CHECK(layer_norm(xw, xn, lnw, 1, M, D, eps, nullptr, 1, stream));
  MASR_CHECK(gemm<kBias>(xn, attw, vecb + 2 * D, q, nullptr, M, D, D, 1.f,
                         nullptr, 1, stream));
  MASR_CHECK(gemm<kBias>(xn, attw + (size_t)D * D, vecb + 3 * D, k, nullptr,
                         M, D, D, 1.f, nullptr, 1, stream));
  MASR_CHECK(gemm<kBias>(xn, attw + 2 * (size_t)D * D, vecb + 4 * D, v,
                         nullptr, M, D, D, 1.f, nullptr, 1, stream));
  const int sub_c = c / n_sub;
  MASR_CHECK(chunk_attention(q, k, v, att_cache, pos, pos_starts, posb,
                             cache_lens, wptrs, att, B, c, C, 1, D, n_head,
                             sub_c, stream));
  // every read of the ring is done (stream order): write the fresh rows
  MASR_CHECK(kv_write(k, v, att_cache, wptrs, active, B, c, C, 1, D, n_head,
                      stream));
  MASR_CHECK(gemm<kResidual>(att, attw + 3 * (size_t)D * D, vecb + 5 * D, xw,
                             xw, M, D, D, 1.f, nullptr, 1, stream));
  // conv module over [cnn cache || LN(x)]: pw1 -> GLU -> VALID depthwise
  // -> LN -> SiLU -> pw2
  MASR_CHECK(layer_norm(xw, xn, lnw, 2, M, D, eps, nullptr, 1, stream));
  MASR_CHECK(conv_input(xn, nullptr, cin, cnn_cache, active, B, c, K1, D,
                        stream));
  MASR_CHECK(gemm<kBias>(cin, pw1w, pw1b, gx, nullptr, B * W, 2 * D, D, 1.f,
                         nullptr, 1, stream));
  MASR_CHECK(conv_module(gx, dww, vecb + 6 * D, pw1b, lnw + 3 * 2 * (size_t)D,
                         y, B, W, c, D, ksize, 0, 0, eps, stream));
  MASR_CHECK(gemm<kResidual>(y, pw2w, vecb + 7 * D, xw, xw, M, D, D, 1.f,
                             nullptr, 1, stream));
  // final FFN (x ff_scale) + final LN
  MASR_CHECK(ffn_residual(xw, xn, h, lnw, 4, ffw1 + (size_t)D * F, ffb1 + F,
                          ffw2 + (size_t)F * D, vecb + D, M, D, F, ff_scale,
                          eps, stream));
  MASR_CHECK(layer_norm(xw, out, lnw, 5, M, D, eps, nullptr, 1, stream));
  return (int)cudaGetLastError();
}
