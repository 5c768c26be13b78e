// The rel-pos flash attention on the tensor cores, shared by the masked
// attention kernel (rel_pos_attention.cu, row 5 of PERF.md's kernel table)
// and the full-context serving layers (conformer_layer.cu and
// squeezeformer_layer.cu through serving.cuh, rows 1 and 6), for Hopper
// (sm_90a), f32 operands:
//
//   out = softmax(mask(([q+bu | q+bv] . [k | p]^T) * scale)) . v
//
// no rel_shift (as the reference). Masked scores take no part (their
// probabilities are exactly 0) and a query row that sees no key gives 0,
// as the Pallas kernels' MASK_VALUE / zeroed-probability / l_inv semantics.
//
// flash_kernel<NDK, MASK>: one block per (64 query rows, head, utterance),
// 4 warps of 16 rows. [q+bu | q+bv] is staged once in shared memory; the
// block walks the 64-key tiles of its row, skips hidden tiles without
// reading their keys, and brings [k | p] and v of each visible tile in with
// cp.async (16-byte copies where the views allow, 4-byte otherwise) into
// one buffer: 85 KB at d_k 64, so two blocks share an SM and one computes
// while the other copies (on the H100 that beat a 2-3 stage ring at one
// block an SM, and [q+bu | q+bv] in registers, which spilled). S = Q.K^T and
// P.V are m16n8k8 mma.sync products in 3xTF32 (common.cuh: big and small
// TF32 halves, f32 accumulation, f32 accuracy); the online softmax stays in
// registers, row max and sum over the four lanes of a quad. P goes from the
// accumulator layout to the A operand without a shuffle: key 2t and 2t+1 of
// a lane play k-columns t and t+4, and v's rows are read in the same order.
// Query tiles run longest first (a causal-like mask gives the last rows the
// most keys).
//
// The mask kind is a template parameter: a tile of 64 x 64 (query, key)
// pairs is hidden (no pair seen: skipped), full (every pair inside [0, T)
// seen: no per-pair test) or partial (each pair tested).
//   kByteMask    row 5: a (B, T, T) byte mask read through its strides and
//                the (B, nt, nt) map of its tiles (rel_pos_attention.cu's
//                tile_map_kernel computes it); mask bytes are read on
//                partial tiles only.
//   kLengthMask  rows 1 and 6: keys col < lens[b] are seen by every query
//                row of utterance b (padded query rows t >= len included,
//                as the Pallas layer kernels compute them). A tile is
//                hidden if its first key is >= len, full if its last key
//                is < len, partial otherwise: computed in the kernel from
//                lens, no pre-pass.
//
// Operands through element strides (unit column stride): q, k, v, out
// (B, H, T, d_k) views, e.g. (B, T, D) rows (or the q/k/v product's (B, T,
// 3D) rows) with head h in columns [h d_k, (h+1) d_k); pos_p (H, T, d_k);
// posb (2, H d_k) = pos_bias_u, pos_bias_v. d_k <= 128, held as NDK = 32,
// 64, 96 or 128 columns (zero-padded).
//
// What bounds it on the H100: operations over the visible (query, key)
// pairs, 6 d_k per pair and head ([q+u | q+v].[k | p] and P.V). In f32 on
// the FMA pipes that is 67 TFLOP/s; on the tensor cores each product is
// three TF32 products (495 TFLOP/s dense), so 3xTF32's effective peak is
// 495 / 3 = 165 TFLOP/s, and whole 64 x 64 tiles are computed where the
// mask is partial. The design keeps the work on the tensor cores, reads
// each visible tile's keys once per (block, head), skips hidden tiles
// outright and keeps the scores out of device memory; the splits into TF32
// halves and the softmax's exponentials run beside the products on the
// other pipes. Left for later: wgmma / TMA (TF32 wgmma takes only K-major
// operands in shared memory, which v of P.V is not).
//
// The bf16 mode (masr_tpu's compute dtype bf16: the Pallas kernels take
// their products' operands in the input's dtype, masr_tpu/ops/pallas/
// attention.py:73-74, :97, conformer_layer.py:50): the template's TP,
// the type of pos_p, is bf16. Tiles are staged as f32 in shared memory
// as before (bf16 arrays widened exactly on load); [q+u | q+v], [k | p]
// and v are rounded to bf16 as their fragments are read, and so is each
// key tile's P = exp(S - m) (unnormalised, as row 5's Pallas kernel
// rounds it); both products are mma.sync m16n8k16 bf16 with f32
// accumulation, the softmax stays f32. TQ, the type of q, k, v, posb and
// out: bf16 for row 5 (its Pallas kernel reads and writes the compute
// dtype), f32 for rows 1 and 6 (the layer's q/k/v product rows and its
// f32 attention rows). Bound in bf16: the operations over the bf16 dense
// rate (989 TFLOP/s), or the bytes of q, k, v, p and out.
#pragma once

#include "common.cuh"

namespace {

constexpr int kFlashTile = 64;   // query rows per block, keys per tile
constexpr int kFlashThreads = 128;   // 4 warps of 16 query rows
// map values (as ops/cuda/rel_pos_attention.py's HIDDEN, FULL, PARTIAL)
constexpr unsigned char kTileHidden = 0, kTileFull = 1, kTilePartial = 2;

struct FlashView {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;  // b, h, t
  long long ph, pt;                                          // pos_p
  long long mb, mq, mk;                                      // byte mask
};

// The mask kinds (a template parameter of the kernel, so each is compiled
// on its own: row 5's path is the code it had before rows 1 and 6 shared
// it, its pointers __restrict__ kernel parameters)
enum FlashMask { kByteMask = 0, kLengthMask = 1 };

// a key tile's kind under the key-length mask: keys [0, len) seen
__device__ __forceinline__ unsigned char length_tile(int kt, int len, int T) {
  const int k0 = kt * kFlashTile;
  if (k0 >= len) return kTileHidden;
  return min(k0 + kFlashTile, T) <= len ? kTileFull : kTilePartial;
}

template <int NDK>
struct FlashCfg {
  // row strides = 4 mod 32 floats: fragment reads hit 32 distinct banks
  static constexpr int SK = 2 * NDK + 4;   // [k | p] and [q+u | q+v] rows
  static constexpr int SV = NDK + 4;       // v rows
  static constexpr int K_FLOATS = kFlashTile * SK;
  // [q+u | q+v], [k | p], v
  static constexpr size_t SMEM =
      sizeof(float) * (2 * K_FLOATS + (size_t)kFlashTile * SV);
};

// mask, map: kByteMask's bytes and tile map; lens: kLengthMask's lengths
// (the other kind's pointers are unread)
template <int NDK, int MASK, class TQ = float, class TP = float>
__global__ void __launch_bounds__(kFlashThreads)
    flash_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                 const TQ* __restrict__ v, const TP* __restrict__ pos_p,
                 const TQ* __restrict__ posb,
                 const unsigned char* __restrict__ mask,
                 const unsigned char* __restrict__ map,
                 const int* __restrict__ lens, FlashView w,
                 TQ* __restrict__ out, int T, int dk, float scale,
                 bool vec) {
  constexpr bool BF = is_bf16<TP>;
  using Cfg = FlashCfg<NDK>;
  constexpr int KS = 2 * NDK / 8;   // k-steps of S = Q.K^T
  constexpr int NO = NDK / 8;       // n-tiles of the output
  constexpr int SK = Cfg::SK, SV = Cfg::SV;
  extern __shared__ float smem[];
  float* qs = smem;                       // [q+u | q+v]
  float* ks = qs + Cfg::K_FLOATS;         // [k | p] of the key tile
  float* vs = ks + Cfg::K_FLOATS;         // v of the key tile
  const int nt = (T + kFlashTile - 1) / kFlashTile;
  const int qt = nt - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kFlashTile, D = gridDim.y * dk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wr = warp * 16;
  const TQ* qh = q + b * w.qb + h * w.qh;
  const TQ* kh = k + b * w.kb + h * w.kh;
  const TQ* vh = v + b * w.vb + h * w.vh;
  const TP* ph = pos_p + h * w.ph;
  const unsigned char* mb = mask + b * w.mb;
  const unsigned char* mrow = map + ((size_t)b * nt + qt) * nt;
  const int len = MASK == kLengthMask ? min(max(lens[b], 0), T) : T;

  // [q+bu | q+bv], each half NDK wide (zeros past d_k and past T)
  for (int i = tid; i < kFlashTile * 2 * NDK; i += kFlashThreads) {
    const int r = i / (2 * NDK), e = i % (2 * NDK), half = e / NDK;
    const int d = e % NDK, tq = q0 + r;
    float val = 0.f;
    if (tq < T && d < dk)
      val = to_f32(qh[tq * w.qt + d]) + to_f32(posb[half * D + h * dk + d]);
    qs[r * SK + e] = val;
  }

  float o[NO][4], m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  for (int kt = 0; kt < nt; ++kt) {
    if ((MASK == kByteMask ? mrow[kt] : length_tile(kt, len, T)) ==
        kTileHidden)
      continue;   // block-uniform
    const int k0 = kt * kFlashTile;
    load_tile_as_f32<kFlashTile, NDK, SK, kFlashThreads>(
        ks, kh, w.kt, k0, T, 0, dk, vec, tid);
    load_tile_as_f32<kFlashTile, NDK, SK, kFlashThreads>(
        ks + NDK, ph, w.pt, k0, T, 0, dk, vec, tid);
    load_tile_as_f32<kFlashTile, NDK, SV, kFlashThreads>(
        vs, vh, w.vt, k0, T, 0, dk, vec, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();   // the tile (and, first, [q+u | q+v]) landed

    // S (16 rows x 64 keys per warp) = [q+u | q+v] . [k | p]^T
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    if constexpr (BF) {
      // k16 steps over [q+u | q+v] . [k | p]^T, operands rounded to bf16
#pragma unroll
      for (int st = 0; st < 2 * NDK / 16; ++st) {
        unsigned af[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* a =
              qs + (wr + g + (i & 1) * 8) * SK + st * 16 + 2 * t + (i >> 1) * 8;
          af[i] = pack_bf16(a[0], a[1]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* kr = ks + (j * 8 + g) * SK + st * 16 + 2 * t;
          mma_bf16(s[j], af, pack_bf16(kr[0], kr[1]),
                   pack_bf16(kr[8], kr[9]));
        }
      }
    } else {
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      unsigned ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(qs[(wr + g + (i & 1) * 8) * SK + st * 8 + t + (i >> 1) * 4],
                   ab[i], as[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        unsigned bb[2], bs[2];
        const float* kr = ks + (j * 8 + g) * SK + st * 8 + t;
        split_tf32(kr[0], bb[0], bs[0]);
        split_tf32(kr[4], bb[1], bs[1]);
        mma_3xtf32(s[j], ab, as, bb, bs);
      }
    }
    }

    // mask, online softmax; lane holds rows wr+g (i < 2) and wr+g+8 (i >= 2)
    // of q0, keys k0 + 8j + 2t + (i & 1)
    const bool partial = (MASK == kByteMask ? mrow[kt]
                                            : length_tile(kt, len, T)) ==
                         kTilePartial;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + wr + g + (i >> 1) * 8;
        const int key = k0 + j * 8 + 2 * t + (i & 1);
        bool seen = key < T;
        if (partial)
          seen = seen && (MASK == kByteMask
                              ? row < T && mb[row * w.mq + key * w.mk] != 0
                              : key < len);
        s[j][i] = seen ? s[j][i] * scale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    float mu[2], alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float mn = fmaxf(m_r[r], mx[r]);
      mu[r] = mn == -INFINITY ? 0.f : mn;   // no key seen yet: all p = 0
      alpha[r] = expf(m_r[r] - mu[r]);
      m_r[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = expf(s[j][i] - mu[i >> 1]);
        ls[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(kFull, ls[r], 1);
      ls[r] += __shfl_xor_sync(kFull, ls[r], 2);
      l_r[r] = l_r[r] * alpha[r] + ls[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];

    if constexpr (BF) {
      // O += P . V in k16 steps of 16 keys: the accumulators of key tiles
      // 2kk and 2kk + 1 are the A fragment as they lie, rounded to bf16
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned af[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const float* vr = vs + (kk * 16 + 2 * t) * SV + g;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          mma_bf16(o[n], af, pack_bf16(vr[n * 8], vr[SV + n * 8]),
                   pack_bf16(vr[8 * SV + n * 8], vr[9 * SV + n * 8]));
      }
    } else {
    // O += P . V: keys 8kk + 2t and + 1 are A's columns t and t + 4
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      unsigned ab[4], as[4];
      split_tf32(s[kk][0], ab[0], as[0]);
      split_tf32(s[kk][2], ab[1], as[1]);
      split_tf32(s[kk][1], ab[2], as[2]);
      split_tf32(s[kk][3], ab[3], as[3]);
      const float* vr = vs + (kk * 8 + 2 * t) * SV + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        unsigned bb[2], bs[2];
        split_tf32(vr[n * 8], bb[0], bs[0]);
        split_tf32(vr[SV + n * 8], bb[1], bs[1]);
        mma_3xtf32(o[n], ab, as, bb, bs);
      }
    }
    }
    __syncthreads();   // the buffer is reloaded next
  }

  TQ* oh = out + b * w.ob + h * w.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    if (row >= T) continue;
    const float inv = l_r[r] > 0.f ? 1.f / l_r[r] : 0.f;   // no key: 0
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t + c;
        if (d < dk) store_as(oh + row * w.ot + d, o[n][r * 2 + c] * inv);
      }
  }
}

template <int NDK, int MASK, class TQ, class TP>
cudaError_t flash_launch(const TQ* q, const TQ* k, const TQ* v,
                         const TP* pos_p, const TQ* posb,
                         const unsigned char* mask, const unsigned char* map,
                         const int* lens, const FlashView& w, TQ* out,
                         int B, int H, int T, int dk, float scale, bool vec,
                         cudaStream_t st) {
  const size_t smem = FlashCfg<NDK>::SMEM;
  auto kernel = flash_kernel<NDK, MASK, TQ, TP>;
  static bool sized = false;   // one attribute call per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((T + kFlashTile - 1) / kFlashTile, H, B);
  kernel<<<grid, kFlashThreads, smem, st>>>(
      q, k, v, pos_p, posb, mask, map, lens, w, out, T, dk, scale, vec);
  return cudaGetLastError();
}

// the attention for d_k in [1, 128]; vec: 16-byte copies of k, p and v rows
// (every base and row, head and utterance stride a multiple of 4 floats)
template <int MASK, class TQ, class TP>
cudaError_t flash_attention(const TQ* q, const TQ* k, const TQ* v,
                            const TP* pos_p, const TQ* posb,
                            const unsigned char* mask,
                            const unsigned char* map, const int* lens,
                            const FlashView& w, TQ* out, int B, int H,
                            int T, int dk, float scale, bool vec,
                            cudaStream_t st) {
  switch ((dk + 31) / 32) {
    case 1:
      return flash_launch<32, MASK>(q, k, v, pos_p, posb, mask, map, lens, w,
                                    out, B, H, T, dk, scale, vec, st);
    case 2:
      return flash_launch<64, MASK>(q, k, v, pos_p, posb, mask, map, lens, w,
                                    out, B, H, T, dk, scale, vec, st);
    case 3:
      return flash_launch<96, MASK>(q, k, v, pos_p, posb, mask, map, lens, w,
                                    out, B, H, T, dk, scale, vec, st);
    default:
      return flash_launch<128, MASK>(q, k, v, pos_p, posb, mask, map, lens,
                                     w, out, B, H, T, dk, scale, vec, st);
  }
}

}  // namespace
