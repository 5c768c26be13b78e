// Blocks shared by the serving layer kernels (conformer_layer.cu,
// squeezeformer_layer.cu: full context; chunk_layer.cu, chunk_layer_sq.cu:
// streaming chunk steps), rows 1, 6, 2 and 8 of PERF.md's kernel table, for
// Hopper (sm_90a), f32. All four run their products and attention on the
// tensor cores in 3xTF32 (common.cuh's split_tf32, mma_3xtf32 and
// load_tile_async):
//
//   length_attention             rows 1 and 6: rel-pos attention over the
//                                valid keys of an utterance, through
//                                flash_attention.cuh's flash kernel with a
//                                key-length mask
//   chunk_attention_kernel<NDK>  rel-pos attention of a chunk over
//                                [att-cache ring || chunk] per slot
//   kv_write_kernel              the fresh K/V rows into the ring
//   conv_input_kernel            [cnn cache || conv-module input rows]
//   cnn_write_kernel             the new cnn cache rows
//   gemm_sk_kernel<..., E>       every serving product: weights from the
//                                serving tensor-core pack (TF32 halves),
//                                K split by a plan of K (and N) alone, the
//                                parts added in a fixed order
//
// What bounded the serving rows and what the design does about it: their
// products were f32 FMA loops (5-12 TFLOP/s), on 8-32 blocks for the chunk
// steps (N = 256 at 32 slots) or 4 (one slot), with the FFN w_2's K = 2048
// serial in each block. The split of K fills the SMs at one slot and at
// 32, and the full-context layers' w_2 at 1200-2400 rows, without tying a
// row's sums to the batch, and the tensor cores take the operations; the
// attention, ~17% of a chunk layer, went to the tensor cores with it. See
// each layer's source for what is left (wgmma / TMA, the launches).
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

#include "flash_attention.cuh"

namespace {

// ------------------------------------------------------------------------
// Full-context rel-pos attention of rows 1 and 6 (no rel_shift, as the
// reference): flash_attention.cuh's tensor-core flash kernel with the
// key-length mask. Every query row of utterance b (padded rows t >= len
// too) sees the keys col < lens[b]; an utterance with len == 0 gives 0.
// q, k, v: the q/k/v product's (B, T, 3D) rows, head h in columns
// [h d_k, (h+1) d_k) of each third; pos_p (T, D); posb (2, D); out (B, T,
// D). d_k up to 128.
// ------------------------------------------------------------------------
cudaError_t length_attention(const float* qkv, const float* pos_p,
                             const float* posb, const int* lens, float* out,
                             int B, int T, int D, int H,
                             cudaStream_t stream) {
  const int dk = D / H;
  const long long D3 = 3LL * D, bq = (long long)T * D3,
                  bo = (long long)T * D;
  const FlashView w{bq, dk, D3, bq, dk, D3, bq, dk, D3, bo, dk, D,
                    dk, D,  0,  0,  0};
  const float *q = qkv, *k = qkv + D, *v = qkv + 2 * D;
  // 16-byte copies of k, p and v rows: bases and strides of 4 floats
  const bool vec = on16(k) && on16(v) && on16(pos_p) && D % 4 == 0 &&
                   dk % 4 == 0;
  return flash_attention<kLengthMask>(q, k, v, pos_p, posb, nullptr, nullptr,
                                      lens, w, out, B, H, T, dk,
                                      1.f / sqrtf((float)dk), vec, stream);
}

// ------------------------------------------------------------------------
// Rel-pos attention of the chunk over [ring cache || chunk]:
//   s = ([q+bu | q+bv] . [k | p]^T) / sqrt(d_k)
// q, k, v: (B*c, ldq) rows (the q/k/v product's [q | k | v] rows, ldq =
// 3D), out: (B*c, D); head h in columns [h d_k, (h+1) d_k) of each;
// ring: (B, H, C*rep, 2 d_k) (the header's layout); pos rows start[s] + j,
// j < L = C + c; posb (2, D). Cache key j is valid iff j >= C -
// cache_len[s] and, with n_sub sub-chunks of sub_c rows, j >= i*sub_c for
// query rows of sub-chunk i, which see the chunk keys of sub-chunks <= i.
// Masked probabilities are exactly 0; a row that sees no key gives 0.
//
// One block per (slot, head, 16 query rows): the rows are one m16 tile.
// The block's visible keys, in tiles of 16, are dealt to its 4 warps in
// turn (warp w takes tiles w, w + 4, ...); each warp brings its tiles
// ([k | p] rows and v rows, read from the ring in chronological order)
// into its own 2-stage cp.async ring, and runs both products on the
// tensor cores in 3xTF32 mma.sync m16n8k8 with its own online softmax:
// S = Q'.[k | p]^T for 16 rows x 16 keys, then P.V, with P's accumulator
// fragments taken as the A operand without shuffles (a lane's keys 2t,
// 2t + 1 play k-columns t, t + 4; v's rows are read in that order). The
// 4 warps' (max, sum, output) are merged in a fixed order at the end, so a
// slot's bits do not depend on the other slots.
// ------------------------------------------------------------------------
constexpr int kChunkRows = 16;   // query rows per block: one m16 tile
constexpr int kChunkKeys = 16;   // keys per warp tile: two n8 tiles
constexpr int kChunkWarps = 4;

// shared-memory strides (floats): [k | p] rows of E8 = 2 d_k rounded up to
// 8, + 4 (fragment reads hit 32 banks); v rows of 32 NDK + 4
__host__ __device__ inline int chunk_sx(int dk) {
  return (2 * dk + 7) / 8 * 8 + 4;
}

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
                           int D, int ldq, int dk, int sub_c, float scale,
                           bool vec) {
  constexpr int NT8 = 4 * NDK, SV = 32 * NDK + 4, SO = 32 * NDK + 4;
  extern __shared__ float smem[];
  const int SX = chunk_sx(dk), E8 = SX - 4;
  const int STAGE = kChunkKeys * (SX + SV);
  const int s = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kChunkRows;
  const int H = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int clen = min(max(cache_lens[s], 0), C);
  const int wp = C > 0 ? ((wptrs[s] % C) + C) % C : 0;
  const size_t rbase = (size_t)s * c * D + (size_t)h * dk;   // out row 0
  const size_t qbase = (size_t)s * c * ldq + (size_t)h * dk;  // q, k, v
  // logical ring row p: memory row p*rep + rep - 1 (the last copy)
  const float* ring =
      ring_all + (((size_t)s * H + h) * C * rep + (rep - 1)) * 2 * dk;
  const size_t rstride = (size_t)rep * 2 * dk;
  const float* prow = pos + (size_t)pos_starts[s] * D + (size_t)h * dk;
  float* Qs = smem;                                  // 16 x SX
  float* wbuf = Qs + kChunkRows * SX + warp * 2 * STAGE;   // this warp's

  // Q' = [q + bu | q + bv], zero past c and in the pad columns; the pad
  // columns of this warp's stages are zeroed once (copies skip them)
  for (int i = tid; i < kChunkRows * SX; i += blockDim.x) {
    const int r = i / SX, e = i % SX, tq = i0 + r;
    float val = 0.f;
    if (tq < c && e < 2 * dk) {
      const int half = e < dk ? 0 : 1, d = e - half * dk;
      val = q[qbase + (size_t)tq * ldq + d] + posb[half * D + h * dk + d];
    }
    Qs[i] = val;
  }
  for (int i = lane; i < 2 * kChunkKeys; i += 32) {
    float* xr = wbuf + (i / kChunkKeys) * STAGE + (i % kChunkKeys) * SX;
    float* vr = wbuf + (i / kChunkKeys) * STAGE + kChunkKeys * SX +
                (i % kChunkKeys) * SV;
    for (int e = 2 * dk; e < SX; ++e) xr[e] = 0.f;
    for (int e = dk; e < SV; ++e) vr[e] = 0.f;
  }

  // keys any row of the block may see: [key_first, key_end)
  const int t_last = min(i0 + kChunkRows, c) - 1;
  const int key_end = C + min(c, (t_last / sub_c + 1) * sub_c);
  const int key_first = C - clen;
  const int k_lo = key_first / kChunkKeys * kChunkKeys;
  const int n_tiles = (key_end - k_lo + kChunkKeys - 1) / kChunkKeys;
  const int n_mine = n_tiles > warp ? (n_tiles - warp + kChunkWarps - 1) /
                                          kChunkWarps
                                    : 0;

  // this warp's tile i (keys j0 .. j0 + 15) into stage st: lane l copies
  // key l % 16, every second 16-byte (or 4-byte) piece of its k, p and v
  // rows from piece l / 16, so each lane finds its key's rows once
  const int kr = lane % kChunkKeys, half = lane / kChunkKeys;
  auto load = [&](int st, int i) {
    const int j = k_lo + (warp + i * kChunkWarps) * kChunkKeys + kr;
    float* xs = wbuf + st * STAGE + kr * SX;
    float* vs = wbuf + st * STAGE + kChunkKeys * SX + kr * SV;
    const bool ok = j >= key_first && j < key_end;
    const float *kx = q, *vx = q, *px = q;
    if (ok) {
      if (j < C) {
        kx = ring + (size_t)((wp + j) % C) * rstride;
        vx = kx + dk;
      } else {
        kx = k + qbase + (size_t)(j - C) * ldq;
        vx = v + qbase + (size_t)(j - C) * ldq;
      }
      px = prow + (size_t)j * D;
    }
    const int w = vec ? 4 : 1;
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const float* src = part == 0 ? kx : part == 1 ? px : vx;
      float* dst = part == 2 ? vs : xs + part * dk;
      for (int col = half * w; col < dk; col += 2 * w) {
        if (vec)
          cp_async16(dst + col, ok ? src + col : q, ok ? 16 : 0);
        else
          cp_async4(dst + col, ok ? src + col : q, ok ? 4 : 0);
      }
    }
  };

  // rows g and g + 8 of the tile: first visible cache key, end of the
  // visible chunk keys (rows past c see none)
  int min_key[2], key_lim[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int tq = i0 + g + rr * 8, sub = tq / sub_c;
    min_key[rr] = max(C - clen, sub * sub_c);
    key_lim[rr] = tq < c ? C + (sub + 1) * sub_c : 0;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NT8][4];
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;

  __syncthreads();   // Qs and the pad columns written
  if (n_mine > 0) load(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_mine; ++it) {
    if (it + 1 < n_mine) load((it + 1) & 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();      // tile it landed for every lane
    const float* xs = wbuf + (it & 1) * STAGE;
    const float* vs = xs + kChunkKeys * SX;
    const int j0 = k_lo + (warp + it * kChunkWarps) * kChunkKeys;

    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nt][r] = 0.f;
    for (int kk = 0; kk < E8; kk += 8) {
      unsigned ab[4], as_[4];
#pragma unroll
      for (int qd = 0; qd < 4; ++qd)
        split_tf32(Qs[(g + (qd & 1) * 8) * SX + kk + t + (qd >> 1) * 4],
                   ab[qd], as_[qd]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        unsigned bb[2], bs[2];
        const float* xr = xs + (nt * 8 + g) * SX + kk + t;
        split_tf32(xr[0], bb[0], bs[0]);
        split_tf32(xr[4], bb[1], bs[1]);
        mma_3xtf32(sc[nt], ab, as_, bb, bs);
      }
    }

    // online softmax per row (a quad of lanes holds a row's 16 keys)
    float p[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + nt * 8 + 2 * t + e;
          const bool ok = j < C ? j >= min_key[rr] : j < key_lim[rr];
          const float val = ok ? sc[nt][rr * 2 + e] * scale : -INFINITY;
          sc[nt][rr * 2 + e] = val;
          mx = fmaxf(mx, val);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float mn = fmaxf(m[rr], mx);
      float alpha = 1.f, sum = 0.f;
      if (mn != -INFINITY) {   // else nothing visible yet: p = 0
        alpha = expf(m[rr] - mn);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = expf(sc[nt][rr * 2 + e] - mn);
            p[nt][rr * 2 + e] = pe;
            sum += pe;
          }
        m[rr] = mn;
      } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) p[nt][rr * 2] = p[nt][rr * 2 + 1] = 0.f;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      l[rr] = l[rr] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        o[j][rr * 2] *= alpha;
        o[j][rr * 2 + 1] *= alpha;
      }
    }

    // O += P.V: key tile nt is one k8 step, keys 2t, 2t + 1 as k-columns
    // t, t + 4
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      unsigned ab[4], as_[4];
      split_tf32(p[nt][0], ab[0], as_[0]);   // (g, key 2t)
      split_tf32(p[nt][2], ab[1], as_[1]);   // (g + 8, key 2t)
      split_tf32(p[nt][1], ab[2], as_[2]);   // (g, key 2t + 1)
      split_tf32(p[nt][3], ab[3], as_[3]);   // (g + 8, key 2t + 1)
      const float* v0 = vs + (nt * 8 + 2 * t) * SV + g;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        unsigned bb[2], bs[2];
        split_tf32(v0[j * 8], bb[0], bs[0]);
        split_tf32(v0[SV + j * 8], bb[1], bs[1]);
        mma_3xtf32(o[j], ab, as_, bb, bs);
      }
    }
    __syncwarp();      // stage it & 1 consumed before its reload
  }
  cp_async_wait<0>();
  __syncthreads();     // every warp is done with its stages

  // merge the warps in the order 0..3: rows' max, sums and outputs
  float* Os = smem + kChunkRows * SX;            // 4 x 16 x SO
  float* Ms = Os + kChunkWarps * kChunkRows * SO;   // 4 x 16
  float* Ls = Ms + kChunkWarps * kChunkRows;        // 4 x 16
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = warp * kChunkRows + g + rr * 8;
#pragma unroll
    for (int j = 0; j < NT8; ++j)
      *reinterpret_cast<float2*>(Os + row * SO + j * 8 + 2 * t) =
          make_float2(o[j][rr * 2], o[j][rr * 2 + 1]);
    if (t == 0) {
      Ms[row] = m[rr];
      Ls[row] = l[rr];
    }
  }
  __syncthreads();
  for (int i = tid; i < kChunkRows * dk; i += blockDim.x) {
    const int r = i / dk, d = i % dk, tq = i0 + r;
    if (tq >= c) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kChunkWarps; ++w)
      mx = fmaxf(mx, Ms[w * kChunkRows + r]);
    float acc = 0.f, sum = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kChunkWarps; ++w) {
        const float mw = Ms[w * kChunkRows + r];
        const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
        acc += f * Os[(w * kChunkRows + r) * SO + d];
        sum += f * Ls[w * kChunkRows + r];
      }
    }
    out[rbase + (size_t)tq * D + d] = sum > 0.f ? acc / sum : 0.f;
  }
}

template <int NDK>
cudaError_t chunk_attention_launch(const float* q, const float* k,
                                   const float* v, const float* ring,
                                   const float* pos, const int* pos_starts,
                                   const float* posb, const int* cache_lens,
                                   const int* wptrs, float* out, int B, int c,
                                   int C, int rep, int D, int ldq, int H,
                                   int sub_c, cudaStream_t stream) {
  const int dk = D / H, SX = chunk_sx(dk), SV = 32 * NDK + 4;
  const size_t smem =
      sizeof(float) * (kChunkRows * SX +
                       (size_t)kChunkWarps * 2 * kChunkKeys * (SX + SV));
  static_assert(kChunkWarps * kChunkRows * (32 * NDK + 4) +
                        2 * kChunkWarps * kChunkRows <=
                    kChunkWarps * 2 * kChunkKeys * (32 * NDK + 4),
                "the merge fits in the stages");
  static size_t sized = 0;   // attribute set for the largest smem so far
  if (smem > sized) {
    cudaError_t err = cudaFuncSetAttribute(
        chunk_attention_kernel<NDK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = smem;
  }
  // 16-byte copies: every row start a multiple of 4 floats
  const bool vec = dk % 4 == 0 && D % 4 == 0 && ldq % 4 == 0 && on16(q) &&
                   on16(k) && on16(v) && on16(ring) && on16(pos);
  dim3 grid((c + kChunkRows - 1) / kChunkRows, H, B);
  chunk_attention_kernel<NDK><<<grid, kChunkWarps * 32, smem, stream>>>(
      q, k, v, ring, pos, pos_starts, posb, cache_lens, wptrs, out, c, C, rep,
      D, ldq, dk, sub_c, 1.f / sqrtf((float)dk), vec);
  return cudaGetLastError();
}

cudaError_t chunk_attention(const float* q, const float* k, const float* v,
                            const float* ring, const float* pos,
                            const int* pos_starts, const float* posb,
                            const int* cache_lens, const int* wptrs,
                            float* out, int B, int c, int C, int rep, int D,
                            int ldq, int H, int sub_c, cudaStream_t stream) {
  switch ((D / H + 31) / 32) {
    case 1:
      return chunk_attention_launch<1>(q, k, v, ring, pos, pos_starts, posb,
                                       cache_lens, wptrs, out, B, c, C, rep,
                                       D, ldq, H, sub_c, stream);
    case 2:
      return chunk_attention_launch<2>(q, k, v, ring, pos, pos_starts, posb,
                                       cache_lens, wptrs, out, B, c, C, rep,
                                       D, ldq, H, sub_c, stream);
    case 3:
      return chunk_attention_launch<3>(q, k, v, ring, pos, pos_starts, posb,
                                       cache_lens, wptrs, out, B, c, C, rep,
                                       D, ldq, H, sub_c, stream);
    default:
      return chunk_attention_launch<4>(q, k, v, ring, pos, pos_starts, posb,
                                       cache_lens, wptrs, out, B, c, C, rep,
                                       D, ldq, H, sub_c, stream);
  }
}

// ------------------------------------------------------------------------
// Fresh K/V rows into the ring: one block per (chunk row, head, slot); k,
// v rows of ldq floats (the q/k/v product's rows).
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
                                int rep, int ldq, int dk) {
  const int i = blockIdx.x, h = blockIdx.y, s = blockIdx.z, H = gridDim.y;
  if (!active[s] || i < c - C) return;
  const int e2 = 2 * dk;
  const int wp = ((wptrs[s] % C) + C) % C;
  float* dst = ring_all +
               (((size_t)s * H + h) * C + (wp + i) % C) * (size_t)rep * e2;
  const size_t src = ((size_t)s * c + i) * ldq + (size_t)h * dk;
  for (int e = threadIdx.x; e < rep * e2; e += blockDim.x) {
    const int f = e % e2;
    dst[e] = f < dk ? k[src + f] : v[src + f - dk];
  }
}

cudaError_t kv_write(const float* k, const float* v, float* ring,
                     const int* wptrs, const int* active, int B, int c, int C,
                     int rep, int D, int ldq, int H, cudaStream_t stream) {
  if (C <= 0) return cudaGetLastError();
  kv_write_kernel<<<dim3(c, H, B), 128, 0, stream>>>(k, v, ring, wptrs,
                                                     active, c, C, rep, ldq,
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

// ------------------------------------------------------------------------
// gemm_sk: the serving layers' products (rows 1, 2, 6 and 8) on the
// tensor cores,
//   C (M, N) = E(A (M, K; row stride lda) . W (K, N))
// in 3xTF32 mma.sync m16n8k8 with f32 accumulators (common.cuh's pieces),
// K split into p.parts parts of p.part (a multiple of the 32-deep k-tile):
// part s sums k in [s part, min((s + 1) part, K)) through a 3-stage
// cp.async ring, blockIdx.z = s. W comes from the serving tensor-core
// pack (ops/cuda/chunk_layer.py pack_chunk_tc): already split into its
// TF32 big and small halves, so the loop splits only A, and reads the
// halves' bits straight from shared memory.
//
// With one part the block applies the epilogue itself. With more, each
// block stores its part's sums to the partials (parts, M, N) and counts
// in on its output tile's counter; the block that arrives last adds the
// parts in the fixed order s = 0, 1, ..., parts - 1 (reading them from L2)
// and applies the epilogue once, then zeroes the counter for the next
// product. No float atomics. The plan comes from the wrapper (the chunk
// steps' split_plan(N, K), the full-context layers' full_plan(K)), never
// from M, and the tile (16 x 8, 32 x 32 or 64 x 64) only decides
// which block computes an element: each output element is the same
// sequence of m16n8k8 products over the same k whatever M is, and sits at
// row m % 16 and column n % 8 of its fragment either way. So a slot's (an
// utterance's) bits do not depend on how many share the call.
// ------------------------------------------------------------------------
struct TcWeight {        // a (K, N) row-major weight as its TF32 halves
  const float* big;
  const float* small;
};

struct SplitPlan {       // K = parts x part (the last part may be short)
  int parts, part;
};

struct SplitK {          // the wrapper's scratch for split products
  float* partials;       // parts x M x N floats of the largest product
  long long n_partials;
  unsigned* counters;    // one per output tile, zero between products
  int n_counters;
};

template <int BM, int BN, int WM, int WN>
struct SkTile {
  static_assert(BN % 32 == 0 || BN <= 16, "B rows hit 32 banks");
  static constexpr int NT = (BM / WM) * (BN / WN) * 32;
  static constexpr int SA = kTcBK + 4;    // A rows: k along the row
  // B rows: n along the row, a stride of 8 or 24 mod 32 floats
  static constexpr int SB = BN % 32 == 0 ? BN + 8 : 24;
  static constexpr int A_FLOATS = BM * SA, B_FLOATS = kTcBK * SB;
  static constexpr int STAGE = A_FLOATS + 2 * B_FLOATS;   // A, big, small
  static constexpr size_t SMEM = sizeof(float) * kTcStages * STAGE;
};

template <int BM, int BN, int WM, int WN, class E>
__global__ void __launch_bounds__(SkTile<BM, BN, WM, WN>::NT)
    gemm_sk_kernel(const float* __restrict__ A, TcWeight W, float* C, int M,
                   int N, int K, int lda, int ldc, int part,
                   float* __restrict__ partials,
                   unsigned* __restrict__ counters, E e, bool va, bool vb,
                   bool vp) {
  using L = SkTile<BM, BN, WM, WN>;
  constexpr int WX = BN / WN, NT = L::NT, MT = WM / 16, NT8 = WN / 8;
  extern __shared__ float smem[];
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / WX) * WM, wn = (warp % WX) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int s = blockIdx.z, S = gridDim.z;
  const int k_begin = s * part, k_end = min(K, k_begin + part);

  auto load = [&](int stage, int k0) {
    float* as = smem + stage * L::STAGE;
    float* bb = as + L::A_FLOATS;
    load_tile_async<BM, kTcBK, L::SA, NT>(as, A, lda, m0, M, k0, k_end, va,
                                           tid);
    load_tile_async<kTcBK, BN, L::SB, NT>(bb, W.big, N, k0, k_end, n0, N, vb,
                                           tid);
    load_tile_async<kTcBK, BN, L::SB, NT>(bb + L::B_FLOATS, W.small, N, k0,
                                           k_end, n0, N, vb, tid);
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int KT = (k_end - k_begin + kTcBK - 1) / kTcBK;
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < KT) load(st, k_begin + st * kTcBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();   // tile kt landed; the stage reloaded below is spent
    const int next = kt + kTcStages - 1;
    if (next < KT) load(next % kTcStages, k_begin + next * kTcBK);
    cp_async_commit();
    const float* as = smem + (kt % kTcStages) * L::STAGE;
    const float* bb = as + L::A_FLOATS;
    const float* bs = bb + L::B_FLOATS;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 8) {
      unsigned ab[MT][4], asm_[MT][4], wb[NT8][2], wsm[NT8][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + i * 16 + g;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_tf32(as[(r + (q & 1) * 8) * L::SA + kk + t + (q >> 1) * 4],
                     ab[i][q], asm_[i][q]);
      }
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int c = wn + j * 8 + g;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int o = (kk + t + q * 4) * L::SB + c;
          wb[j][q] = __float_as_uint(bb[o]);
          wsm[j][q] = __float_as_uint(bs[o]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT8; ++j)
          mma_3xtf32(acc[i][j], ab[i], asm_[i], wb[j], wsm[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring

  // the block's sums through shared memory (as gemm_tc_kernel), then whole
  // rows per warp, consecutive columns per lane: coalesced
  constexpr int SC = BN + 8, NW = NT / 32;
  static_assert(BM * SC <= kTcStages * L::STAGE, "epilogue tile fits");
  float* ct = smem;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
        *reinterpret_cast<float2*>(
            ct + (wm + i * 16 + g + h * 8) * SC + wn + j * 8 + 2 * t) =
            make_float2(acc[i][j][h * 2], acc[i][j][h * 2 + 1]);
  __syncthreads();
  if (S == 1) {
    for (int rr = warp; rr < BM; rr += NW) {
      const int m = m0 + rr;
      if (m >= M) break;
      const auto r = e.row(m);
      for (int c = lane; c < BN; c += 32) {
        const int n = n0 + c;
        if (n < N) e(C, (size_t)m * ldc + n, r, n, ct[rr * SC + c]);
      }
    }
    return;
  }
  // 4 columns a thread (16-byte copies where vp: N % 4 == 0, partials
  // aligned), consecutive threads along a row
  constexpr int C4 = BN / 4;
  const size_t MN = (size_t)M * N;
  for (int i = tid; i < BM * C4; i += NT) {
    const int rr = i / C4, cc = (i % C4) * 4, m = m0 + rr, n = n0 + cc;
    if (m >= M || n >= N) continue;
    const float* src = ct + rr * SC + cc;
    float* dst = partials + s * MN + (size_t)m * N + n;
    if (vp)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else
      for (int u = 0; u < 4 && n + u < N; ++u) dst[u] = src[u];
  }
  __threadfence();   // this part's sums are visible before it counts in
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(counters + tile, 1u) == (unsigned)(S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < BM * C4; i += NT) {
    const int rr = i / C4, cc = (i % C4) * 4, m = m0 + rr, n = n0 + cc;
    if (m >= M || n >= N) continue;
    const auto r = e.row(m);
    const float* p = partials + (size_t)m * N + n;
    const size_t o = (size_t)m * ldc + n;
    if (vp) {
      float4 v = __ldcg(reinterpret_cast<const float4*>(p));
#pragma unroll 4
      for (int q = 1; q < S; ++q) {
        const float4 w = __ldcg(reinterpret_cast<const float4*>(p + q * MN));
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      e(C, o, r, n, v.x);
      e(C, o + 1, r, n + 1, v.y);
      e(C, o + 2, r, n + 2, v.z);
      e(C, o + 3, r, n + 3, v.w);
    } else {
      for (int u = 0; u < 4 && n + u < N; ++u) {
        float v = __ldcg(p + u);
        for (int q = 1; q < S; ++q) v += __ldcg(p + u + q * MN);
        e(C, o + u, r, n + u, v);
      }
    }
  }
  if (tid == 0) counters[tile] = 0u;
}

template <int BM, int BN, int WM, int WN, class E>
cudaError_t gemm_sk_run(const float* A, const TcWeight& W, float* C, int M,
                        int N, int K, int lda, int ldc, const SplitPlan& p,
                        const SplitK& sk, const E& e, cudaStream_t stream) {
  using L = SkTile<BM, BN, WM, WN>;
  auto kernel = gemm_sk_kernel<BM, BN, WM, WN, E>;
  static bool sized = false;   // one attribute call per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, p.parts);
  if (p.parts > 1 && ((long long)p.parts * M * N > sk.n_partials ||
                      (long long)grid.x * grid.y > sk.n_counters))
    return cudaErrorInvalidValue;   // the wrapper sized its scratch smaller
  const bool vb = on16(W.big) && on16(W.small) && N % 4 == 0;
  kernel<<<grid, L::NT, L::SMEM, stream>>>(
      A, W, C, M, N, K, lda, ldc, p.part, sk.partials, sk.counters, e,
      on16(A) && lda % 4 == 0, vb, N % 4 == 0 && on16(sk.partials));
  return cudaGetLastError();
}

// The tile: 64 x 64 (4 warps of 32 x 32) where such tiles give ~100
// blocks with the plan's parts (the engine's 32 slots at full rate, the
// full-context layers), else 32 x 32 (4 warps of 16 x 16: the engine's
// half-rate layers, the full-context half-rate layers' N = 256 products),
// else 16 x 8 (one warp: predict_stream's one slot of 16 rows). A 64 x 128
// tile (4 warps of 32 x 64, one block an SM) for the full-context layers'
// wide products (q/k/v, FFN w_1) was slower on the H100
// (bench/full_context_probe.py). lens, T: the rows kRowMaskResidual keeps
// (t = m % T < lens[m / T]); unread by the other epilogues.
template <int EPI>
cudaError_t gemm_sk(const float* A, const TcWeight& W, const float* bias,
                    float* C, const float* R, int M, int N, int K, int lda,
                    int ldc, float scale, const SplitPlan& p,
                    const SplitK& sk, cudaStream_t stream,
                    const int* lens = nullptr, int T = 1) {
  if (M <= 0 || N <= 0) return cudaGetLastError();
  if (p.parts < 1 || p.part <= 0 || p.part % kTcBK ||
      (long long)p.parts * p.part < K ||
      (long long)(p.parts - 1) * p.part >= K ||
      (EPI == kRowMaskResidual && (lens == nullptr || T < 1)))
    return cudaErrorInvalidValue;   // not a plan of K, or no row lengths
  const ServeEpi<EPI> e{bias, R, scale, lens, T};
  if ((long)((M + 63) / 64) * ((N + 63) / 64) * p.parts >= 96)
    return gemm_sk_run<64, 64, 32, 32>(A, W, C, M, N, K, lda, ldc, p, sk, e,
                                       stream);
  if ((long)((M + 31) / 32) * ((N + 31) / 32) * p.parts >= 96)
    return gemm_sk_run<32, 32, 16, 16>(A, W, C, M, N, K, lda, ldc, p, sk, e,
                                       stream);
  return gemm_sk_run<16, 8, 16, 8>(A, W, C, M, N, K, lda, ldc, p, sk, e,
                                   stream);
}

// The serving layers' products, in the order of the wrappers' plans
// (ops/cuda/chunk_layer.py CHUNK_PRODUCTS): FFN w_1 (N = F, K = D), FFN w_2
// (D, F), q/k/v (3D, D), out (D, D), pw1 (2D, D), pw2 (D, D)
enum ChunkProduct { kW1 = 0, kW2, kQkv, kOut, kPw1, kPw2, kChunkProducts };

// the weight of product i of a (.., 2, K, N) half-stacked array: index i of
// its leading dimension, big then small
inline TcWeight tc_weight(const float* w, int K, int N, int i = 0) {
  const size_t kn = (size_t)K * N;
  return TcWeight{w + 2 * kn * i, w + 2 * kn * i + kn};
}

// FFN on normed rows xn: dst = R + scale * (SiLU(xn . w1 + b1) . w2 + b2),
// h (M, F) scratch; dst may be R
cudaError_t ffn_sk(const float* xn, float* h, float* dst, const float* R,
                   const TcWeight& w1, const float* b1, const TcWeight& w2,
                   const float* b2, int M, int D, int F, float scale,
                   const SplitPlan* plans, const SplitK& sk,
                   cudaStream_t stream) {
  cudaError_t err = gemm_sk<kSilu>(xn, w1, b1, h, nullptr, M, F, D, D, F, 1.f,
                                   plans[kW1], sk, stream);
  if (err != cudaSuccess) return err;
  return gemm_sk<kResidual>(h, w2, b2, dst, R, M, D, F, F, D, scale,
                            plans[kW2], sk, stream);
}

}  // namespace
