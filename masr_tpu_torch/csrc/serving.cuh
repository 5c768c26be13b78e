// Blocks shared by the serving layer kernels (conformer_layer.cu,
// squeezeformer_layer.cu: full context; chunk_layer.cu, chunk_layer_sq.cu:
// streaming chunk steps), rows 1, 6, 2 and 8 of PERF.md's kernel table, for
// Hopper (sm_90a), f32 on the FMA pipes (their products run common.cuh's
// gemm_kernel):
//
//   attention_kernel<NDK>        rel-pos attention over the valid keys of
//                                an utterance (full context)
//   chunk_attention_kernel<NDK>  rel-pos attention of a chunk over
//                                [att-cache ring || chunk] per slot
//   kv_write_kernel              the fresh K/V rows into the ring
//   conv_input_kernel            [cnn cache || conv-module input rows]
//   cnn_write_kernel             the new cnn cache rows
//
// Ring layout (see chunk_layer.cu): a layer's att cache is a ring of C
// logical rows per (slot, head), chronological row j at logical row
// (wptr + j) mod C. Logical row p lives in memory rows p*rep ..
// p*rep + rep - 1 of a (B, H, C*rep, 2 d_k) array: rep = 1 for a layer at
// the cache's own rate, rep = 2 for a Squeezeformer layer at half rate,
// whose rows are stored twice at full resolution (masr_tpu's repeat of the
// half-rate cache). Reads take the last copy (masr_tpu reads rows 1::2),
// writes fill every copy.
#pragma once

#include "common.cuh"

namespace {

// ------------------------------------------------------------------------
// Full-context rel-pos attention (no rel_shift, as the reference):
//   s = ([q+bu | q+bv] . [k | p]^T) * scale
// online softmax over 32-key tiles. One block = 4 warps = 32 query rows of
// one (utterance, head); each warp owns 8 rows, each lane one key of the
// tile for the scores and d = lane + 32 i of the output. A row sees the
// keys col < lens[b]; a row whose utterance has len == 0 gives 0.
// Operands through AttView's element strides (unit column stride): q, k, v,
// out (B, H, T, d_k) views, e.g. (B, T, D) with head h in columns
// [h d_k, (h+1) d_k); pos_p (H, T, d_k); posb (2, H d_k) = pos_bias_u,
// pos_bias_v.
// ------------------------------------------------------------------------
constexpr int kAttRows = 32;     // query rows per block
constexpr int kAttKeys = 32;     // keys per tile (one per lane)
constexpr int kAttWarps = 4;
constexpr int kAttRowsPerWarp = kAttRows / kAttWarps;

struct AttView {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;  // b, h, t
  long long ph, pt;                                          // pos_p
};

// the serving layers' (B, T, D) layout, heads in columns, pos_p (T, D)
AttView heads_in_columns(int T, int D, int dk) {
  const long long bt = (long long)T * D;
  return AttView{bt, dk, D, bt, dk, D, bt, dk, D, bt, dk, D, dk, D};
}

template <int NDK>
__global__ void __launch_bounds__(kAttWarps * 32)
    attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ pos_p,
                     const float* __restrict__ posb,
                     const int* __restrict__ lens, AttView w,
                     float* __restrict__ out, int T, int dk, float scale) {
  extern __shared__ float smem[];
  const int e2 = 2 * dk, ks = e2 + 1;        // +1: conflict-free key rows
  float* Qs = smem;                          // kAttRows x e2
  float* Ks = Qs + kAttRows * e2;            // kAttKeys x ks
  float* Vs = Ks + kAttKeys * ks;            // kAttKeys x dk
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kAttRows;
  const int D = gridDim.y * dk;
  // keys [0, len) are seen (as the plain twin's t < len)
  const int len = min(lens[b], T);
  const float* qh = q + b * w.qb + h * w.qh;
  const float* kh = k + b * w.kb + h * w.kh;
  const float* vh = v + b * w.vb + h * w.vh;
  const float* ph = pos_p + h * w.ph;
  float* oh = out + b * w.ob + h * w.oh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kAttRows * e2; i += blockDim.x) {
    const int r = i / e2, e = i % e2, t = t0 + r;
    float val = 0.f;
    if (t < T) {
      const int half = e < dk ? 0 : 1, d = e - half * dk;
      val = qh[t * w.qt + d] + posb[half * D + h * dk + d];
    }
    Qs[i] = val;
  }

  float m[kAttRowsPerWarp], l[kAttRowsPerWarp], acc[kAttRowsPerWarp][NDK];
#pragma unroll
  for (int r = 0; r < kAttRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NDK; ++i) acc[r][i] = 0.f;
  }
  const float* qw = Qs + warp * kAttRowsPerWarp * e2;

  for (int k0 = 0; k0 < len; k0 += kAttKeys) {
    __syncthreads();  // Qs written / previous tile consumed
    for (int i = threadIdx.x; i < kAttKeys * e2; i += blockDim.x) {
      const int r = i / e2, e = i % e2, key = k0 + r;
      float val = 0.f;
      if (key < len)
        val = e < dk ? kh[key * w.kt + e] : ph[key * w.pt + (e - dk)];
      Ks[r * ks + e] = val;
    }
    for (int i = threadIdx.x; i < kAttKeys * dk; i += blockDim.x) {
      const int r = i / dk, d = i % dk, key = k0 + r;
      Vs[i] = key < len ? vh[key * w.vt + d] : 0.f;
    }
    __syncthreads();

    float s[kAttRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kAttRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * ks;
    for (int e = 0; e < e2; ++e) {
      const float kv = kr[e];
#pragma unroll
      for (int r = 0; r < kAttRowsPerWarp; ++r)
        s[r] = fmaf(qw[r * e2 + e], kv, s[r]);
    }
    const bool in_len = k0 + lane < len;
#pragma unroll
    for (int r = 0; r < kAttRowsPerWarp; ++r) {
      const float sr = in_len ? s[r] * scale : -INFINITY;
      // key k0 < len is valid, so the tile max is finite
      const float tile_max = warp_max(sr);
      const float mn = fmaxf(m[r], tile_max);
      const float p = in_len ? expf(sr - mn) : 0.f;
      const float alpha = expf(m[r] - mn);
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < NDK; ++i) acc[r][i] *= alpha;
      for (int j = 0; j < kAttKeys; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int i = 0; i < NDK; ++i) {
          const int d = lane + 32 * i;
          if (d < dk) acc[r][i] = fmaf(pj, Vs[j * dk + d], acc[r][i]);
        }
      }
      m[r] = mn;
    }
  }

#pragma unroll
  for (int r = 0; r < kAttRowsPerWarp; ++r) {
    const int t = t0 + warp * kAttRowsPerWarp + r;
    if (t >= T) continue;
    // len == 0 -> 0
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int i = 0; i < NDK; ++i) {
      const int d = lane + 32 * i;
      if (d < dk) oh[t * w.ot + d] = acc[r][i] * inv;
    }
  }
}

template <int NDK>
cudaError_t attention_launch(const float* q, const float* k, const float* v,
                             const float* pos_p, const float* posb,
                             const int* lens, const AttView& w, float* out,
                             int B, int T, int H, int dk, float scale,
                             cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kAttRows * 2 * dk + kAttKeys * (2 * dk + 1) +
                       kAttKeys * dk);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<NDK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kAttRows - 1) / kAttRows, H, B);
  attention_kernel<NDK><<<grid, kAttWarps * 32, smem, stream>>>(
      q, k, v, pos_p, posb, lens, w, out, T, dk, scale);
  return cudaGetLastError();
}

// the serving layers' attention: (B, T, D) operands, keys col < lens[b],
// scale 1 / sqrt(d_k); d_k up to 128, in registers of ceil(d_k / 32) per
// lane and row
cudaError_t attention(const float* q, const float* k, const float* v,
                      const float* pos_p, const float* posb, const int* lens,
                      float* out, int B, int T, int D, int H,
                      cudaStream_t stream) {
  const int dk = D / H;
  const AttView w = heads_in_columns(T, D, dk);
  const float scale = 1.f / sqrtf((float)dk);
  switch ((dk + 31) / 32) {
    case 1:
      return attention_launch<1>(q, k, v, pos_p, posb, lens, w, out, B, T, H,
                                 dk, scale, stream);
    case 2:
      return attention_launch<2>(q, k, v, pos_p, posb, lens, w, out, B, T, H,
                                 dk, scale, stream);
    case 3:
      return attention_launch<3>(q, k, v, pos_p, posb, lens, w, out, B, T, H,
                                 dk, scale, stream);
    default:
      return attention_launch<4>(q, k, v, pos_p, posb, lens, w, out, B, T, H,
                                 dk, scale, stream);
  }
}

// ------------------------------------------------------------------------
// Rel-pos attention of the chunk over [ring cache || chunk]:
//   s = ([q+bu | q+bv] . [k | p]^T) / sqrt(d_k)
// q, k, v, out: (B*c, D), head h in columns [h d_k, (h+1) d_k);
// ring: (B, H, C*rep, 2 d_k) (the header's layout); pos rows start[s] + j,
// j < L = C + c; posb (2, D). One block per (slot, head, 16 query rows);
// online softmax over 32-key tiles, keys read from the ring in
// chronological order. Cache key j is valid iff j >= C - cache_len[s] and,
// with n_sub sub-chunks of sub_c rows, j >= i*sub_c for query rows of
// sub-chunk i, which see the chunk keys of sub-chunks <= i. Masked
// probabilities are exactly 0; a key tile that no row of a warp may see is
// skipped, so a fully masked cache (cache_len = 0) takes its sums from the
// chunk keys alone.
// ------------------------------------------------------------------------
constexpr int kChunkRows = 16;   // query rows per block
constexpr int kChunkKeys = 32;   // keys per tile (one per lane)
constexpr int kChunkWarps = 4;
constexpr int kChunkRowsPerWarp = kChunkRows / kChunkWarps;

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
                           float* __restrict__ out, int c, int C, int rep,
                           int D, int dk, int sub_c, float scale) {
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
  // logical ring row p: memory row p*rep + rep - 1 (the last copy)
  const float* ring =
      ring_all + (((size_t)s * H + h) * C * rep + (rep - 1)) * e2;
  const size_t rstride = (size_t)rep * e2;
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
          val = ring[(size_t)((wp + j) % C) * rstride + e];
        else
          val = k[rbase + (size_t)(j - C) * D + e];
      }
      Ks[r * ks + e] = val;
    }
    for (int i = threadIdx.x; i < kChunkKeys * dk; i += blockDim.x) {
      const int r = i / dk, d = i % dk, j = k0 + r;
      float val = 0.f;
      if (j >= key_first && j < key_end)
        val = j < C ? ring[(size_t)((wp + j) % C) * rstride + dk + d]
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
cudaError_t chunk_attention_launch(const float* q, const float* k,
                                   const float* v, const float* ring,
                                   const float* pos, const int* pos_starts,
                                   const float* posb, const int* cache_lens,
                                   const int* wptrs, float* out, int B, int c,
                                   int C, int rep, int D, int H, int sub_c,
                                   cudaStream_t stream) {
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
      q, k, v, ring, pos, pos_starts, posb, cache_lens, wptrs, out, c, C, rep,
      D, dk, sub_c, 1.f / sqrtf((float)dk));
  return cudaGetLastError();
}

cudaError_t chunk_attention(const float* q, const float* k, const float* v,
                            const float* ring, const float* pos,
                            const int* pos_starts, const float* posb,
                            const int* cache_lens, const int* wptrs,
                            float* out, int B, int c, int C, int rep, int D,
                            int H, int sub_c, cudaStream_t stream) {
  switch ((D / H + 31) / 32) {
    case 1:
      return chunk_attention_launch<1>(q, k, v, ring, pos, pos_starts, posb,
                                       cache_lens, wptrs, out, B, c, C, rep,
                                       D, H, sub_c, stream);
    case 2:
      return chunk_attention_launch<2>(q, k, v, ring, pos, pos_starts, posb,
                                       cache_lens, wptrs, out, B, c, C, rep,
                                       D, H, sub_c, stream);
    case 3:
      return chunk_attention_launch<3>(q, k, v, ring, pos, pos_starts, posb,
                                       cache_lens, wptrs, out, B, c, C, rep,
                                       D, H, sub_c, stream);
    default:
      return chunk_attention_launch<4>(q, k, v, ring, pos, pos_starts, posb,
                                       cache_lens, wptrs, out, B, c, C, rep,
                                       D, H, sub_c, stream);
  }
}

// ------------------------------------------------------------------------
// Fresh K/V rows into the ring: one block per (chunk row, head, slot).
// Fresh row i goes to logical row (wptr + i) mod C, every copy of it.
// Inactive slots are skipped; rows that fall out of a C-row window (c > C)
// are not written. Launched after every read of the ring (stream order):
// the rows a step overwrites are the oldest ones, which its attention
// still reads.
// ------------------------------------------------------------------------
__global__ void kv_write_kernel(const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ ring_all,
                                const int* __restrict__ wptrs,
                                const int* __restrict__ active, int c, int C,
                                int rep, int D, int dk) {
  const int i = blockIdx.x, h = blockIdx.y, s = blockIdx.z, H = gridDim.y;
  if (!active[s] || i < c - C) return;
  const int e2 = 2 * dk;
  const int wp = ((wptrs[s] % C) + C) % C;
  float* dst = ring_all +
               (((size_t)s * H + h) * C + (wp + i) % C) * (size_t)rep * e2;
  const size_t src = ((size_t)s * c + i) * D + (size_t)h * dk;
  for (int e = threadIdx.x; e < rep * e2; e += blockDim.x) {
    const int f = e % e2;
    dst[e] = f < dk ? k[src + f] : v[src + f - dk];
  }
}

cudaError_t kv_write(const float* k, const float* v, float* ring,
                     const int* wptrs, const int* active, int B, int c, int C,
                     int rep, int D, int H, cudaStream_t stream) {
  if (C <= 0) return cudaGetLastError();
  kv_write_kernel<<<dim3(c, H, B), 128, 0, stream>>>(k, v, ring, wptrs,
                                                     active, c, C, rep, D,
                                                     D / H);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// Conv input: cin (B, W = k-1+c, D) = [cnn cache || rows] per slot, the
// rows (B*c, D) taken through the per-channel affine ada (2, D) = scale,
// shift when ada is given (the Squeezeformer's AdaptiveScale: its cache
// holds post-ada rows). New cnn cache: the last k-1 rows of cin, active
// slots only.
// ------------------------------------------------------------------------
__global__ void conv_input_kernel(const float* __restrict__ cnn_cache,
                                  const float* __restrict__ xn,
                                  const float* __restrict__ ada,
                                  float* __restrict__ cin, int c, int K1,
                                  int D) {
  const int r = blockIdx.x, s = blockIdx.y, W = K1 + c;
  const bool cached = r < K1;
  const float* src = cached ? cnn_cache + ((size_t)s * K1 + r) * D
                            : xn + ((size_t)s * c + (r - K1)) * D;
  float* dst = cin + ((size_t)s * W + r) * D;
  for (int col = threadIdx.x; col < D; col += blockDim.x)
    dst[col] = cached || ada == nullptr ? src[col]
                                        : src[col] * ada[col] + ada[D + col];
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

// cin = [cnn cache || ada(rows)], then the cache takes cin's last k-1 rows
// (its copy in cin is made first, so c < k-1 is safe)
cudaError_t conv_input(const float* rows, const float* ada, float* cin,
                       float* cnn_cache, const int* active, int B, int c,
                       int K1, int D, cudaStream_t stream) {
  conv_input_kernel<<<dim3(K1 + c, B), 256, 0, stream>>>(cnn_cache, rows, ada,
                                                         cin, c, K1, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cnn_write_kernel<<<dim3(K1, B), 256, 0, stream>>>(cin, cnn_cache, active, c,
                                                    K1, D);
  return cudaGetLastError();
}

}  // namespace
