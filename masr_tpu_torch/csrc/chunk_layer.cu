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
// c < k-1 is safe too.
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

#include "common.cuh"

namespace {

constexpr int kChunkRows = 16;   // query rows per block
constexpr int kChunkKeys = 32;   // keys per tile (one per lane)
constexpr int kChunkWarps = 4;
constexpr int kChunkRowsPerWarp = kChunkRows / kChunkWarps;

// ------------------------------------------------------------------------
// 3. Rel-pos attention of the chunk over [ring cache || chunk]:
//      s = ([q+bu | q+bv] . [k | p]^T) / sqrt(d_k)
//    q, k, v, out: (B*c, D), head h in columns [h d_k, (h+1) d_k);
//    ring: (B, H, C, 2 d_k); pos rows start[s] + j, j < L; posb (2, D).
//    Masked probabilities are exactly 0; a key tile that no row of a warp
//    may see is skipped, so a fully masked cache (cache_len = 0) takes its
//    sums from the chunk keys alone.
// ------------------------------------------------------------------------
template <int NDK>
__global__ void __launch_bounds__(kChunkWarps * 32)
    chunk_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ ring_all,
                           const float* __restrict__ pos,
                           const int* __restrict__ pos_starts,
                           const float* __restrict__ posb,
                           const int* __restrict__ cache_lens,
                           const int* __restrict__ wptrs,
                           float* __restrict__ out, int c, int C, int D,
                           int dk, int sub_c, float scale) {
  extern __shared__ float smem[];
  const int e2 = 2 * dk, ks = e2 + 1;        // +1: conflict-free key rows
  float* Qs = smem;                          // kChunkRows x e2
  float* Ks = Qs + kChunkRows * e2;          // kChunkKeys x ks
  float* Vs = Ks + kChunkKeys * ks;          // kChunkKeys x dk
  const int s = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kChunkRows;
  const int H = gridDim.y;
  const int clen = min(max(cache_lens[s], 0), C);
  const int wp = C > 0 ? ((wptrs[s] % C) + C) % C : 0;
  const size_t rbase = (size_t)s * c * D + (size_t)h * dk;   // chunk row 0
  const float* ring = ring_all + ((size_t)s * H + h) * C * e2;
  const float* prow = pos + (size_t)pos_starts[s] * D + (size_t)h * dk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kChunkRows * e2; i += blockDim.x) {
    const int r = i / e2, e = i % e2, t = i0 + r;
    float val = 0.f;
    if (t < c) {
      const int half = e < dk ? 0 : 1, d = e - half * dk;
      val = q[rbase + (size_t)t * D + d] + posb[half * D + h * dk + d];
    }
    Qs[i] = val;
  }

  // per row: first visible cache key and end of the visible chunk keys
  int min_key[kChunkRowsPerWarp], key_lim[kChunkRowsPerWarp];
  float m[kChunkRowsPerWarp], l[kChunkRowsPerWarp];
  float acc[kChunkRowsPerWarp][NDK];
#pragma unroll
  for (int r = 0; r < kChunkRowsPerWarp; ++r) {
    const int t = i0 + warp * kChunkRowsPerWarp + r;
    const int sub = t / sub_c;
    min_key[r] = max(C - clen, sub * sub_c);
    key_lim[r] = t < c ? C + (sub + 1) * sub_c : 0;   // rows past c: none
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NDK; ++i) acc[r][i] = 0.f;
  }
  const float* qw = Qs + warp * kChunkRowsPerWarp * e2;
  // keys any row of the block may see: [C - clen, key_end)
  const int t_last = min(i0 + kChunkRows, c) - 1;
  const int key_end = C + min(c, (t_last / sub_c + 1) * sub_c);
  const int key_first = C - clen;

  for (int k0 = key_first / kChunkKeys * kChunkKeys; k0 < key_end;
       k0 += kChunkKeys) {
    __syncthreads();  // Qs written / previous tile consumed
    for (int i = threadIdx.x; i < kChunkKeys * e2; i += blockDim.x) {
      const int r = i / e2, e = i % e2, j = k0 + r;
      float val = 0.f;
      if (j >= key_first && j < key_end) {
        if (e >= dk)
          val = prow[(size_t)j * D + (e - dk)];
        else if (j < C)
          val = ring[(size_t)((wp + j) % C) * e2 + e];
        else
          val = k[rbase + (size_t)(j - C) * D + e];
      }
      Ks[r * ks + e] = val;
    }
    for (int i = threadIdx.x; i < kChunkKeys * dk; i += blockDim.x) {
      const int r = i / dk, d = i % dk, j = k0 + r;
      float val = 0.f;
      if (j >= key_first && j < key_end)
        val = j < C ? ring[(size_t)((wp + j) % C) * e2 + dk + d]
                    : v[rbase + (size_t)(j - C) * D + d];
      Vs[i] = val;
    }
    __syncthreads();

    float sc[kChunkRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kChunkRowsPerWarp; ++r) sc[r] = 0.f;
    const float* kr = Ks + lane * ks;
    for (int e = 0; e < e2; ++e) {
      const float kv = kr[e];
#pragma unroll
      for (int r = 0; r < kChunkRowsPerWarp; ++r)
        sc[r] = fmaf(qw[r * e2 + e], kv, sc[r]);
    }
    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < kChunkRowsPerWarp; ++r) {
      const bool valid = j < C ? j >= min_key[r] : j < key_lim[r];
      const float sr = valid ? sc[r] * scale : -INFINITY;
      const float tile_max = warp_max(sr);
      if (tile_max == -INFINITY) continue;   // warp-uniform: no key here
      const float mn = fmaxf(m[r], tile_max);
      const float p = valid ? expf(sr - mn) : 0.f;
      const float alpha = expf(m[r] - mn);
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < NDK; ++i) acc[r][i] *= alpha;
      for (int jj = 0; jj < kChunkKeys; ++jj) {
        const float pj = __shfl_sync(kFull, p, jj);
#pragma unroll
        for (int i = 0; i < NDK; ++i) {
          const int d = lane + 32 * i;
          if (d < dk) acc[r][i] = fmaf(pj, Vs[jj * dk + d], acc[r][i]);
        }
      }
      m[r] = mn;
    }
  }

#pragma unroll
  for (int r = 0; r < kChunkRowsPerWarp; ++r) {
    const int t = i0 + warp * kChunkRowsPerWarp + r;
    if (t >= c) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int i = 0; i < NDK; ++i) {
      const int d = lane + 32 * i;
      if (d < dk) out[rbase + (size_t)t * D + d] = acc[r][i] * inv;
    }
  }
}

template <int NDK>
cudaError_t chunk_attention(const float* q, const float* k, const float* v,
                            const float* ring, const float* pos,
                            const int* pos_starts, const float* posb,
                            const int* cache_lens, const int* wptrs,
                            float* out, int B, int c, int C, int D, int H,
                            int sub_c, cudaStream_t stream) {
  const int dk = D / H;
  const size_t smem =
      sizeof(float) * (kChunkRows * 2 * dk + kChunkKeys * (2 * dk + 1) +
                       kChunkKeys * dk);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_attention_kernel<NDK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((c + kChunkRows - 1) / kChunkRows, H, B);
  chunk_attention_kernel<NDK><<<grid, kChunkWarps * 32, smem, stream>>>(
      q, k, v, ring, pos, pos_starts, posb, cache_lens, wptrs, out, c, C, D,
      dk, sub_c, 1.f / sqrtf((float)dk));
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// 4. Fresh K/V rows into the ring: one block per (chunk row, head, slot).
//    Inactive slots are skipped; rows that fall out of a C-row window
//    (c > C) are not written.
// ------------------------------------------------------------------------
__global__ void kv_write_kernel(const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ ring_all,
                                const int* __restrict__ wptrs,
                                const int* __restrict__ active, int c, int C,
                                int D, int dk) {
  const int i = blockIdx.x, h = blockIdx.y, s = blockIdx.z, H = gridDim.y;
  if (!active[s] || i < c - C) return;
  const int e2 = 2 * dk;
  const int wp = ((wptrs[s] % C) + C) % C;
  float* dst = ring_all + (((size_t)s * H + h) * C + (wp + i) % C) * e2;
  const size_t src = ((size_t)s * c + i) * D + (size_t)h * dk;
  for (int e = threadIdx.x; e < e2; e += blockDim.x)
    dst[e] = e < dk ? k[src + e] : v[src + e - dk];
}

// ------------------------------------------------------------------------
// 6. Conv input: cin (B, W = k-1+c, D) = [cnn cache || xn] per slot.
// 7. New cnn cache: the last k-1 rows of cin, active slots only.
// ------------------------------------------------------------------------
__global__ void conv_input_kernel(const float* __restrict__ cnn_cache,
                                  const float* __restrict__ xn,
                                  float* __restrict__ cin, int c, int K1,
                                  int D) {
  const int r = blockIdx.x, s = blockIdx.y, W = K1 + c;
  const float* src = r < K1 ? cnn_cache + ((size_t)s * K1 + r) * D
                            : xn + ((size_t)s * c + (r - K1)) * D;
  float* dst = cin + ((size_t)s * W + r) * D;
  for (int col = threadIdx.x; col < D; col += blockDim.x) dst[col] = src[col];
}

__global__ void cnn_write_kernel(const float* __restrict__ cin,
                                 float* __restrict__ cnn_cache,
                                 const int* __restrict__ active, int c,
                                 int K1, int D) {
  const int r = blockIdx.x, s = blockIdx.y, W = K1 + c;
  if (!active[s]) return;
  const float* src = cin + ((size_t)s * W + c + r) * D;
  float* dst = cnn_cache + ((size_t)s * K1 + r) * D;
  for (int col = threadIdx.x; col < D; col += blockDim.x) dst[col] = src[col];
}

}  // namespace

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
  switch ((dk + 31) / 32) {
    case 1:
      MASR_CHECK(chunk_attention<1>(q, k, v, att_cache, pos, pos_starts, posb,
                                    cache_lens, wptrs, att, B, c, C, D,
                                    n_head, sub_c, stream));
      break;
    case 2:
      MASR_CHECK(chunk_attention<2>(q, k, v, att_cache, pos, pos_starts, posb,
                                    cache_lens, wptrs, att, B, c, C, D,
                                    n_head, sub_c, stream));
      break;
    case 3:
      MASR_CHECK(chunk_attention<3>(q, k, v, att_cache, pos, pos_starts, posb,
                                    cache_lens, wptrs, att, B, c, C, D,
                                    n_head, sub_c, stream));
      break;
    default:
      MASR_CHECK(chunk_attention<4>(q, k, v, att_cache, pos, pos_starts, posb,
                                    cache_lens, wptrs, att, B, c, C, D,
                                    n_head, sub_c, stream));
  }
  // every read of the ring is done (stream order): write the fresh rows
  if (C > 0) {
    kv_write_kernel<<<dim3(c, n_head, B), 128, 0, stream>>>(
        k, v, att_cache, wptrs, active, c, C, D, dk);
    MASR_CHECK(cudaGetLastError());
  }
  MASR_CHECK(gemm<kResidual>(att, attw + 3 * (size_t)D * D, vecb + 5 * D, xw,
                             xw, M, D, D, 1.f, nullptr, 1, stream));
  // conv module over [cnn cache || LN(x)]: pw1 -> GLU -> VALID depthwise
  // -> LN -> SiLU -> pw2
  MASR_CHECK(layer_norm(xw, xn, lnw, 2, M, D, eps, nullptr, 1, stream));
  conv_input_kernel<<<dim3(W, B), 256, 0, stream>>>(cnn_cache, xn, cin, c, K1,
                                                    D);
  MASR_CHECK(cudaGetLastError());
  cnn_write_kernel<<<dim3(K1, B), 256, 0, stream>>>(cin, cnn_cache, active, c,
                                                    K1, D);
  MASR_CHECK(cudaGetLastError());
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
