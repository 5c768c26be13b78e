// Masked rel-pos flash attention for Hopper (sm_90a), forward only, f32.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/attention.py:122
// (`rel_pos_flash_attention`, one pallas_call over (B, H, q tiles, k tiles)
// with VMEM scratch for the online softmax):
//
//   out = softmax(mask(([q+bu | q+bv] . [k | p]^T) * scale)) . v
//
// with a (B, T, T) mask (True = attend): a static- or dynamic-chunk mask with
// padding, or a broadcast full-context one. The work is serving.cuh's
// attention_kernel<NDK, true>, the block the serving layers' attention runs
// on, with the mask read per (utterance, query row, key): one block per
// (utterance, head, 32 query rows), 4 warps of 8 rows, 32-key tiles, the
// [q+bu | q+bv] rows staged in shared memory, the scores (never written to
// device memory) and an online softmax in registers, d_k <= 128 in
// ceil(d_k / 32) registers per lane and row. The TPU's tile picks
// (`_pick_blocks`: bq up to 256, bk up to 512, 128-lane scratch) are not
// kept.
//
// Semantics kept from the Pallas kernel: masked scores take no part (their
// probabilities are exactly 0), and a query row that sees no key gives 0.
// A key tile that the mask hides from all 32 rows of a block is skipped, as
// read from the mask: a static chunk of 16 with every left chunk hides about
// half the (query, key) pairs.
//
// What bounds it on the H100: the two products run on the f32 FMA pipes from
// shared memory (about 6 d_k operations per visible pair), so it is bound by
// operations; the mask adds one byte per (row, key) read, shared by the H
// heads through L2. What this simple design leaves for later: tensor-core
// (TF32 / bf16) products, larger query tiles, and skipping at warp
// granularity without reading the mask bytes of hidden tiles.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError() (0 on
// success).

#include "serving.cuh"

// q, k, v, out: (B, H, T, d_k) views with unit column stride; pos_p: an
// (H, T, d_k) view; posb: (2, H d_k) contiguous = pos_bias_u, pos_bias_v;
// mask: a (B, T, T) byte view (nonzero = attend). strides: 17 element
// strides, q (b, h, t), k (b, h, t), v (b, h, t), out (b, h, t),
// pos_p (h, t), mask (b, t, key).
extern "C" int masr_rel_pos_attention(const float* q, const float* k,
                                      const float* v, const float* pos_p,
                                      const float* posb,
                                      const unsigned char* mask,
                                      const long long* strides, float* out,
                                      int B, int H, int T, int dk, float scale,
                                      void* stream_ptr) {
  if (B == 0 || H == 0 || T == 0) return (int)cudaGetLastError();
  if (dk < 1 || dk > 128) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const AttView w{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],
                  s[6],  s[7],  s[8],  s[9],  s[10], s[11],
                  s[12], s[13], s[14], s[15], s[16]};
  return (int)masked_attention(q, k, v, pos_p, posb, mask, w, out, B, T, H,
                               dk, scale, (cudaStream_t)stream_ptr);
}
