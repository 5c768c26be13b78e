// Masked rel-pos flash attention for Hopper (sm_90a), forward only, f32
// operands, products on the tensor cores in 3xTF32.
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
//   flash_kernel<NDK> one block per (64 query rows, head, utterance), 4
//                     warps of 16 rows. [q+bu | q+bv] is staged once in
//                     shared memory; the block walks its row of the map,
//                     skips hidden key tiles without reading their keys or
//                     mask bytes, and brings [k | p] and v of each visible
//                     64-key tile in with cp.async (16-byte copies where
//                     the views allow, 4-byte otherwise) into one buffer:
//                     85 KB at d_k 64, so two blocks share an SM and one
//                     computes while the other copies (on the H100 that
//                     beat a 2-3 stage ring at one block an SM, and
//                     [q+bu | q+bv] in registers, which spilled). S = Q.K^T
//                     and P.V are m16n8k8 mma.sync products in 3xTF32
//                     (common.cuh: big and small TF32 halves, f32
//                     accumulation, f32 accuracy); the online softmax
//                     stays in registers, row max and sum over the four
//                     lanes of a quad. P goes from the accumulator layout
//                     to the A operand without a shuffle: key 2t and 2t+1
//                     of a lane play k-columns t and t+4, and v's rows are
//                     read in the same order. Query tiles run longest
//                     first (a causal-like mask gives the last rows the
//                     most keys).
//
// Operands through element strides (unit column stride): q, k, v, out
// (B, H, T, d_k) views, e.g. (B, T, D) rows with head h in columns
// [h d_k, (h+1) d_k); pos_p (H, T, d_k); posb (2, H d_k) = pos_bias_u,
// pos_bias_v; the mask through its (b, t, key) strides, so a broadcast
// `expand` or a [::2, ::2] view is never taken for a dense one. d_k <= 128,
// held as NDK = 32, 64, 96 or 128 columns (zero-padded).
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
// Plain C interface, loaded with ctypes; returns cudaGetLastError() (0 on
// success).

#include "common.cuh"

namespace {

constexpr int kFlashTile = 64;   // query rows per block, keys per tile
constexpr int kFlashThreads = 128;   // 4 warps of 16 query rows
// map values (as ops/cuda/rel_pos_attention.py's HIDDEN, FULL, PARTIAL)
constexpr unsigned char kTileHidden = 0, kTileFull = 1, kTilePartial = 2;

struct FlashView {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;  // b, h, t
  long long ph, pt;                                          // pos_p
  long long mb, mq, mk;                                      // mask
};

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

// ------------------------------------------------------------------------
// The attention.
// ------------------------------------------------------------------------
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

template <int NDK>
__global__ void __launch_bounds__(kFlashThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ pos_p,
                 const float* __restrict__ posb,
                 const unsigned char* __restrict__ mask,
                 const unsigned char* __restrict__ map, FlashView w,
                 float* __restrict__ out, int T, int dk, float scale,
                 bool vec) {
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
  const float* qh = q + b * w.qb + h * w.qh;
  const float* kh = k + b * w.kb + h * w.kh;
  const float* vh = v + b * w.vb + h * w.vh;
  const float* ph = pos_p + h * w.ph;
  const unsigned char* mb = mask + b * w.mb;
  const unsigned char* mrow = map + ((size_t)b * nt + qt) * nt;

  // [q+bu | q+bv], each half NDK wide (zeros past d_k and past T)
  for (int i = tid; i < kFlashTile * 2 * NDK; i += kFlashThreads) {
    const int r = i / (2 * NDK), e = i % (2 * NDK), half = e / NDK;
    const int d = e % NDK, tq = q0 + r;
    float val = 0.f;
    if (tq < T && d < dk)
      val = qh[tq * w.qt + d] + posb[half * D + h * dk + d];
    qs[r * SK + e] = val;
  }

  float o[NO][4], m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  for (int kt = 0; kt < nt; ++kt) {
    if (mrow[kt] == kTileHidden) continue;   // block-uniform
    const int k0 = kt * kFlashTile;
    load_tile_async<kFlashTile, NDK, SK, kFlashThreads>(
        ks, kh, w.kt, k0, T, 0, dk, vec, tid);
    load_tile_async<kFlashTile, NDK, SK, kFlashThreads>(
        ks + NDK, ph, w.pt, k0, T, 0, dk, vec, tid);
    load_tile_async<kFlashTile, NDK, SV, kFlashThreads>(
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

    // mask, online softmax; lane holds rows wr+g (i < 2) and wr+g+8 (i >= 2)
    // of q0, keys k0 + 8j + 2t + (i & 1)
    const bool partial = mrow[kt] == kTilePartial;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + wr + g + (i >> 1) * 8;
        const int key = k0 + j * 8 + 2 * t + (i & 1);
        bool seen = key < T;
        if (partial)
          seen = seen && row < T && mb[row * w.mq + key * w.mk] != 0;
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
    __syncthreads();   // the buffer is reloaded next
  }

  float* oh = out + b * w.ob + h * w.oh;
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
        if (d < dk) oh[row * w.ot + d] = o[n][r * 2 + c] * inv;
      }
  }
}

template <int NDK>
cudaError_t flash_launch(const float* q, const float* k, const float* v,
                         const float* pos_p, const float* posb,
                         const unsigned char* mask, const unsigned char* map,
                         const FlashView& w, float* out, int B, int H, int T,
                         int dk, float scale, bool vec, cudaStream_t st) {
  const size_t smem = FlashCfg<NDK>::SMEM;
  static bool sized = false;   // one attribute call per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<NDK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((T + kFlashTile - 1) / kFlashTile, H, B);
  flash_kernel<NDK><<<grid, kFlashThreads, smem, st>>>(
      q, k, v, pos_p, posb, mask, map, w, out, T, dk, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, H, T, d_k) views with unit column stride; pos_p: an
// (H, T, d_k) view; posb: (2, H d_k) contiguous = pos_bias_u, pos_bias_v;
// mask: a (B, T, T) byte view (nonzero = attend); tile_map: (B, nt, nt)
// bytes of scratch, nt = ceil(T / 64). strides: 17 element strides, q (b,
// h, t), k (b, h, t), v (b, h, t), out (b, h, t), pos_p (h, t), mask (b, t,
// key).
extern "C" int masr_rel_pos_attention(const float* q, const float* k,
                                      const float* v, const float* pos_p,
                                      const float* posb,
                                      const unsigned char* mask,
                                      const long long* strides,
                                      unsigned char* tile_map, float* out,
                                      int B, int H, int T, int dk, float scale,
                                      void* stream_ptr) {
  if (B == 0 || H == 0 || T == 0) return (int)cudaGetLastError();
  if (dk < 1 || dk > 128) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const FlashView w{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],
                    s[6],  s[7],  s[8],  s[9],  s[10], s[11],
                    s[12], s[13], s[14], s[15], s[16]};
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int nt = (T + kFlashTile - 1) / kFlashTile;
  tile_map_kernel<<<dim3(nt, nt, B), 256, 0, st>>>(mask, w, tile_map, T, nt);
  MASR_CHECK(cudaGetLastError());
  // 16-byte copies of k, p and v rows where every base and stride allows
  bool vec = on16(k) && on16(v) && on16(pos_p);
  const int kvp[] = {3, 4, 5, 6, 7, 8, 12, 13};   // k, v, pos_p strides
  for (int i : kvp) vec = vec && s[i] % 4 == 0;
  switch ((dk + 31) / 32) {
    case 1:
      return (int)flash_launch<32>(q, k, v, pos_p, posb, mask, tile_map, w,
                                   out, B, H, T, dk, scale, vec, st);
    case 2:
      return (int)flash_launch<64>(q, k, v, pos_p, posb, mask, tile_map, w,
                                   out, B, H, T, dk, scale, vec, st);
    case 3:
      return (int)flash_launch<96>(q, k, v, pos_p, posb, mask, tile_map, w,
                                   out, B, H, T, dk, scale, vec, st);
    default:
      return (int)flash_launch<128>(q, k, v, pos_p, posb, mask, tile_map, w,
                                    out, B, H, T, dk, scale, vec, st);
  }
}
