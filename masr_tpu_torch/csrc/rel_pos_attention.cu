// Masked rel-pos flash attention for Hopper (sm_90a), forward only, f32
// operands, products on the tensor cores in 3xTF32 (and a bf16 mode,
// below).
//
// Replaces the TPU kernel masr_tpu/ops/pallas/attention.py:122
// (`rel_pos_flash_attention`, one pallas_call over (B, H, q tiles, k tiles)
// with VMEM scratch for the online softmax):
//
//   out = softmax(mask(([q+bu | q+bv] . [k | p]^T) * scale)) . v
//
// with a (B, T, T) mask (nonzero = attend): a static- or dynamic-chunk mask
// with padding, or a broadcast full-context one. Masked scores take no part
// (their probabilities are exactly 0) and a query row that sees no key
// gives 0, as the Pallas kernel's MASK_VALUE / zeroed-probability / l_inv
// semantics.
//
// Two kernels, one C call:
//   tile_map_kernel   reads the mask once and reduces it to a (B, nt, nt)
//                     map of 64 x 64 tiles, nt = ceil(T / 64): hidden (no
//                     visible pair), full (every pair inside [0, T) seen),
//                     partial. The mask is shared by the H heads; it is read
//                     here and on partial tiles only.
//   flash_kernel<NDK, kByteMask>  the tensor-core flash attention of
//                     flash_attention.cuh (shared with the full-context
//                     serving layers, rows 1 and 6, which give it a
//                     key-length mask): one block per (64 query rows, head,
//                     utterance), hidden key tiles skipped unread, mask
//                     bytes read on partial tiles only, S and P.V in 3xTF32
//                     mma.sync with the online softmax in registers. Its
//                     header says what bounds it on the H100.
//
// Operands through element strides (unit column stride): q, k, v, out
// (B, H, T, d_k) views, e.g. (B, T, D) rows with head h in columns
// [h d_k, (h+1) d_k); pos_p (H, T, d_k); posb (2, H d_k) = pos_bias_u,
// pos_bias_v; the mask through its (b, t, key) strides, so a broadcast
// `expand` or a [::2, ::2] view is never taken for a dense one. d_k <= 128.
//
// The bf16 mode (`masr_rel_pos_attention_bf16`; the Pallas kernel takes
// its operands in k.dtype, masr_tpu/ops/pallas/attention.py:73-74, :97):
// q, k, v, p, posb and out bf16, [q+bu | q+bv], [k | p], P and v rounded to
// bf16 at the products (mma.sync m16n8k16 bf16, f32 accumulation), the
// softmax f32 (flash_attention.cuh). Its bound: the operations over the
// bf16 dense rate, or the bf16 bytes of q, k, v, p, the mask and out.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError() (0 on
// success).

#include "flash_attention.cuh"

namespace {

// ------------------------------------------------------------------------
// The tile map: one block per (key tile, query tile, utterance).
// ------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
    tile_map_kernel(const unsigned char* __restrict__ mask, FlashView w,
                    unsigned char* __restrict__ map, int T, int nt) {
  const int kt = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kFlashTile, k0 = kt * kFlashTile;
  const int nq = min(kFlashTile, T - q0), nk = min(kFlashTile, T - k0);
  const unsigned char* m = mask + b * w.mb + q0 * w.mq + k0 * w.mk;
  bool any = false, all = true;
  for (int i = threadIdx.x; i < nq * nk; i += blockDim.x) {
    const bool seen = m[(i / nk) * w.mq + (i % nk) * w.mk] != 0;
    any = any || seen;
    all = all && seen;
  }
  any = __syncthreads_or(any);
  all = __syncthreads_and(all);
  if (threadIdx.x == 0)
    map[((size_t)b * nt + qt) * nt + kt] =
        any ? (all ? kTileFull : kTilePartial) : kTileHidden;
}

}  // namespace

// q, k, v, out: (B, H, T, d_k) views with unit column stride; pos_p: an
// (H, T, d_k) view; posb: (2, H d_k) contiguous = pos_bias_u, pos_bias_v;
// mask: a (B, T, T) byte view (nonzero = attend); tile_map: (B, nt, nt)
// bytes of scratch, nt = ceil(T / 64). strides: 17 element strides, q (b,
// h, t), k (b, h, t), v (b, h, t), out (b, h, t), pos_p (h, t), mask (b, t,
// key).
// Both modes: E the type of q, k, v, pos_p, posb and out (f32, or bf16)
template <class E>
int rel_pos_attention_run(const E* q, const E* k, const E* v,
                          const E* pos_p, const E* posb,
                          const unsigned char* mask, const long long* strides,
                          unsigned char* tile_map, E* out, int B, int H,
                          int T, int dk, float scale, cudaStream_t st) {
  if (B == 0 || H == 0 || T == 0) return (int)cudaGetLastError();
  if (dk < 1 || dk > 128) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const FlashView w{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],
                    s[6],  s[7],  s[8],  s[9],  s[10], s[11],
                    s[12], s[13], s[14], s[15], s[16]};
  const int nt = (T + kFlashTile - 1) / kFlashTile;
  tile_map_kernel<<<dim3(nt, nt, B), 256, 0, st>>>(mask, w, tile_map, T, nt);
  MASR_CHECK(cudaGetLastError());
  // 16-byte copies of k, p and v rows where every base and stride allows
  // (strides of 4 floats, or of 8 bf16 for the bf16 mode's plain loads)
  bool vec = true;
  for (const void* p : {(const void*)k, (const void*)v, (const void*)pos_p})
    vec = vec && reinterpret_cast<size_t>(p) % 16 == 0;
  const int kvp[] = {3, 4, 5, 6, 7, 8, 12, 13};   // k, v, pos_p strides
  for (int i : kvp) vec = vec && s[i] % (is_bf16<E> ? 8 : 4) == 0;
  return (int)flash_attention<kByteMask>(q, k, v, pos_p, posb, mask,
                                         tile_map, nullptr, w, out, B, H, T,
                                         dk, scale, vec, st);
}

extern "C" int masr_rel_pos_attention(const float* q, const float* k,
                                      const float* v, const float* pos_p,
                                      const float* posb,
                                      const unsigned char* mask,
                                      const long long* strides,
                                      unsigned char* tile_map, float* out,
                                      int B, int H, int T, int dk, float scale,
                                      void* stream_ptr) {
  return rel_pos_attention_run(q, k, v, pos_p, posb, mask, strides, tile_map,
                               out, B, H, T, dk, scale,
                               (cudaStream_t)stream_ptr);
}

// The bf16 mode: q, k, v, pos_p, posb and out bf16, the rest as above
extern "C" int masr_rel_pos_attention_bf16(
    const bf16_t* q, const bf16_t* k, const bf16_t* v, const bf16_t* pos_p,
    const bf16_t* posb, const unsigned char* mask, const long long* strides,
    unsigned char* tile_map, bf16_t* out, int B, int H, int T, int dk,
    float scale, void* stream_ptr) {
  return rel_pos_attention_run(q, k, v, pos_p, posb, mask, strides, tile_map,
                               out, B, H, T, dk, scale,
                               (cudaStream_t)stream_ptr);
}
