// Row 5's bf16 mode redesigned for Hopper (sm_90a): the masked rel-pos
// flash attention of rel_pos_attention.cu with bf16 operands,
//
//   out = softmax(mask(([q+bu | q+bv] . [k | p]^T) * scale)) . v
//
// computing what flash_attention.cuh's bf16 mode computed (and
// masr_tpu/ops/pallas/attention.py:122 in its compute dtype, :73-74, :97):
// [q+bu | q+bv] summed in f32 and rounded to bf16; [k | p] and v bf16 as
// they are stored; S and P.V with f32 accumulation; the softmax f32; each
// key tile's P = exp(S - m) rounded to bf16 unnormalised, its f32 sum
// kept; masked pairs with probability exactly 0 and a row that sees no key
// 0; the byte mask through its strides with tile_map_kernel's 64 x 64 map
// (hidden tiles skipped unread, mask bytes read on partial tiles only).
//
// What bounds it on the H100: the operations over the visible (query, key)
// pairs, 6 d_k per pair and head, over the bf16 dense rate (989 TFLOP/s),
// or the bf16 bytes of q, k, v, p and out and the mask's, whichever is
// larger (operations at chip_smoke's B=8, T'=1500, static-16 shape). The
// mode it replaces widened every bf16 tile to f32 in shared memory (85 KB
// a block at d_k 64), re-packed each fragment to bf16 on every read and
// ran mma.sync m16n8k16, synchronous copies between the tiles. Here:
//
//   - bf16 tiles. Each visible key tile's [k | p] (64 keys x 2 NDK) and v
//     (64 x NDK) sit in shared memory as bf16, in the 128-byte swizzled
//     layout that both TMA and wgmma read: rows of 64 bf16 (128 bytes),
//     16-byte chunk c of row r at chunk c ^ (r % 8), 1024-byte aligned
//     atoms of 8 rows; a column block of 64 is one TMA box. NDK = 64 or
//     128 (d_k <= 64 or <= 128): the boxes past d_k (and rows past T)
//     land as zeros from TMA's out-of-bounds fill.
//   - asynchronous copies. TMA (cp.async.bulk.tensor) over tensor maps of
//     the strided (B, H, T, d_k) views of k and v and the (H, T, d_k) view
//     of p, into a ring of kWgStages stages behind mbarriers: `full` (the
//     producer's expect_tx, the copies' bytes) and `empty` (one arrival
//     per consumer warp when its products have read the stage). A producer
//     warp walks the tile map and keeps the next visible tile loading while
//     the consumers compute this one; hidden tiles are never fetched.
//   - wgmma for both products, one consumer warpgroup of 64 query rows.
//     S = [q+u | q+v] . [k | p]^T: m64n64k16 with both operands K-major
//     in shared memory: [q+u | q+v] (64 x 2 NDK bf16) is summed, rounded
//     and stored once a block by the consumers in the tiles' swizzled
//     layout, then read by every key tile's 2 NDK / 16 steps (8 at d_k 64;
//     the descriptors move 32 bytes a step inside a swizzle atom, 8 KB a
//     64-column block). O += P . v: m64nNDKk16 with P the A operand from
//     registers (the S accumulator after the softmax, rounded to bf16 in
//     place: the accumulator layout is A's fragment layout, no shuffle)
//     and v the B operand MN-major (transposed by the instruction), 4
//     steps of 16 keys (2 KB apart). [q+u | q+v] held as register
//     fragments for the whole walk, the first version, gave S the wrong
//     q+v half from the second key tile on at NDK = 64 (not at 128) on the
//     H100: a long-lived register A operand is left to ptxas, so it lives
//     in shared memory as the key tiles do; P's fragments live from their
//     rounding to the products' wait only.
//
// Why one consumer warpgroup and a producer warp (160 threads): the walk
// over a query tile's visible key tiles is serial (the online softmax
// between the two products), so one block overlaps a tile's copies with
// the previous tile's products and nothing more; the softmax of one block
// then runs beside another block's products. Three such blocks fit an SM
// at d_k 64 (128 registers a thread; shared memory 16 KB of [q+u | q+v]
// and 2 x 24 KB of ring), where a block of two consumer warpgroups (128
// query rows) would halve the key tiles' L2 reads but fetch the union of
// both halves' visible tiles and leave half as many blocks to balance a
// causal-like mask. setmaxnreg needs a whole producer warpgroup, so the
// producer warp keeps the consumers' register count. The TMA, mbarrier and
// wgmma pieces are hopper.cuh's, shared with the training layers' bf16
// products (train_wgmma.cuh).
#pragma once

#include "flash_attention.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWgStages = 2;
constexpr int kWgThreads = 160;     // a consumer warpgroup + a producer warp

template <int NDK>
struct WgCfg {
  static_assert(NDK == 64 || NDK == 128, "NDK 64 or 128");
  static constexpr int KB = 2 * NDK / kWgBox;   // [k | p] column blocks
  static constexpr int VB = NDK / kWgBox;       // v column blocks
  static constexpr int QBYTES = KB * kWgBoxBytes;   // [q+u | q+v]
  static constexpr int STAGE = (KB + VB) * kWgBoxBytes;
  // [q+u | q+v] and the ring, plus slack to align them to 1024 bytes
  static constexpr size_t SMEM = QBYTES + (size_t)kWgStages * STAGE + 1024;
};

// d (64 x 64 f32, the accumulator layout) += a (64 x 16 bf16 in
// registers) . B (16 x 64 bf16 in shared memory, descriptor b); TB:
// B MN-major (1) or K-major (0); scale_d 0 ignores d's old value
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
}

// d (64 x 128 f32, the accumulator layout) += a (64 x 16 bf16 in
// registers) . B (16 x 128 bf16 in shared memory, descriptor b); TB:
// B MN-major (1) or K-major (0); scale_d 0 ignores d's old value
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
}


template <int NDK>
__device__ __forceinline__ void wgmma_pv(float (&d)[NDK / 2],
                                         const unsigned (&a)[4], uint64_t b) {
  if constexpr (NDK == 64)
    wgmma_m64n64k16<1>(d, a, b, 1);
  else
    wgmma_m64n128k16<1>(d, a, b, 1);
}

// the tensor maps of the three TMA-loaded operands
struct WgMaps {
  CUtensorMap k, p, v;
};

// One block per (64 query rows, head, utterance): warps 0-3 the consumer
// warpgroup, warp 4 the producer. q, posb, mask, map, w, out, T, dk, scale
// as flash_kernel's (row 5's byte mask).
template <int NDK>
__global__ void __launch_bounds__(kWgThreads)
    flash_wgmma_kernel(const __grid_constant__ WgMaps maps,
                       const bf16_t* __restrict__ q,
                       const bf16_t* __restrict__ posb,
                       const unsigned char* __restrict__ mask,
                       const unsigned char* __restrict__ map, FlashView w,
                       bf16_t* __restrict__ out, int T, int dk, float scale) {
  using Cfg = WgCfg<NDK>;
  constexpr int KS = 2 * NDK / 16;   // k16 steps of S
  constexpr int NO = NDK / 2;        // O accumulators a thread
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t full[kWgStages], empty[kWgStages];
  unsigned char* qs =
      wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* ring = qs + Cfg::QBYTES;
  const int nt = (T + kFlashTile - 1) / kFlashTile;
  const int qt = nt - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kFlashTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned char* mrow = map + ((size_t)b * nt + qt) * nt;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // the producer: one lane walks the map and loads each visible tile
    if (lane != 0) return;
    int i = 0;
    for (int kt = 0; kt < nt; ++kt) {
      if (mrow[kt] == kTileHidden) continue;
      const int s = i % kWgStages, round = i / kWgStages;
      ++i;
      mbar_wait(&empty[s], (round & 1) ^ 1);
      mbar_expect_tx(&full[s], Cfg::STAGE);
      unsigned char* st = ring + s * Cfg::STAGE;
      const int k0 = kt * kFlashTile;
#pragma unroll
      for (int c = 0; c < Cfg::VB; ++c) {
        tma_load_4d(st + c * kWgBoxBytes, &maps.k, &full[s], c * kWgBox, k0,
                    h, b);
        tma_load_3d(st + (Cfg::VB + c) * kWgBoxBytes, &maps.p, &full[s],
                    c * kWgBox, k0, h);
        tma_load_4d(st + (Cfg::KB + c) * kWgBoxBytes, &maps.v, &full[s],
                    c * kWgBox, k0, h, b);
      }
    }
    return;
  }

  // the consumers: warp w holds query rows q0 + 16 w + g and + 8
  const int g = lane / 4, t = lane % 4, wr = warp * 16;
  const int D = gridDim.y * dk;
  const bf16_t* qh = q + b * w.qb + h * w.qh;
  const unsigned char* mb = mask + b * w.mb;
  // [q+bu | q+bv] rounded to bf16 into shared memory, in the layout of
  // the key tiles (64-column blocks, 16-byte chunk c of row r at c ^ (r %
  // 8)): S's A operand, K-major. 8 columns (one chunk) a store.
  for (int i = tid; i < kFlashTile * 2 * NDK / 8; i += 128) {
    const int r = i / (2 * NDK / 8), col = (i % (2 * NDK / 8)) * 8;
    const int half = col / NDK, d0 = col % NDK, row = q0 + r;
    unsigned u[4] = {0u, 0u, 0u, 0u};
    if (row < T) {
      const bf16_t* qr = qh + row * w.qt;
      const bf16_t* br = posb + half * D + h * dk;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 2 * e;
        u[e] = pack_bf16(d < dk ? to_f32(qr[d]) + to_f32(br[d]) : 0.f,
                         d + 1 < dk ? to_f32(qr[d + 1]) + to_f32(br[d + 1])
                                    : 0.f);
      }
    }
    const int chunk = (col % kWgBox) / 8;
    *reinterpret_cast<uint4*>(qs + (col / kWgBox) * kWgBoxBytes + r * 128 +
                              ((chunk ^ (r % 8)) * 16)) =
        make_uint4(u[0], u[1], u[2], u[3]);
  }
  // the generic stores before the products' asynchronous reads, then every
  // consumer's rows in place
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, 128;" ::: "memory");
  const uint32_t qbase = smem_u32(qs);

  float o[NO], sc[32], m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < NO; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = 0.f;

  int i = 0;
  for (int kt = 0; kt < nt; ++kt) {
    const unsigned char kind = mrow[kt];
    if (kind == kTileHidden) continue;   // block-uniform
    const int s = i % kWgStages, round = i / kWgStages;
    ++i;
    const int k0 = kt * kFlashTile;
    const uint32_t kbase = smem_u32(ring + s * Cfg::STAGE);
    const uint32_t vbase = kbase + Cfg::KB * kWgBoxBytes;
    mbar_wait(&full[s], round & 1);

    // S (64 rows x 64 keys) = [q+u | q+v] . [k | p]^T
    wg_touch(sc);
    wg_fence();
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      const uint32_t off = (st / 4) * kWgBoxBytes + (st % 4) * 32;
      wgmma_ss64<0, 0>(sc, wg_desc(qbase + off, 0, 1024),
                         wg_desc(kbase + off, 0, 1024), st > 0);
    }
    wg_commit();
    wg_wait0();
    wg_touch(sc);

    // mask, online softmax; sc[4 j + i] holds row q0 + wr + g + (i >> 1) 8,
    // key k0 + 8 j + 2 t + (i & 1)
    const bool partial = kind == kTilePartial;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + wr + g + (e >> 1) * 8;
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        bool seen = key < T;
        if (partial)
          seen = seen && row < T && mb[row * w.mq + key * w.mk] != 0;
        float& x = sc[4 * j + e];
        x = seen ? x * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
    for (int e = 0; e < 32; ++e) {
      sc[e] = expf(sc[e] - mu[(e >> 1) & 1]);
      ls[(e >> 1) & 1] += sc[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(kFull, ls[r], 1);
      ls[r] += __shfl_xor_sync(kFull, ls[r], 2);
      l_r[r] = l_r[r] * alpha[r] + ls[r];
    }
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] *= alpha[(e >> 1) & 1];

    // O += P . v in k16 steps of 16 keys: S's n8 blocks 2 kk and 2 kk + 1
    // are the A fragment as they lie, rounded to bf16 (held until the
    // products' wait: wgmma reads them asynchronously)
    unsigned pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    wg_touch(pa);
    wg_touch(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<NDK>(o, pa[kk], wg_desc(vbase + kk * 2048, kWgBoxBytes, 1024));
    wg_commit();
    wg_wait0();
    wg_touch(o);
    wg_touch(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with s
  }

  bf16_t* oh = out + b * w.ob + h * w.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    if (row >= T) continue;
    const float inv = l_r[r] > 0.f ? 1.f / l_r[r] : 0.f;   // no key: 0
#pragma unroll
    for (int n = 0; n < NDK / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t + c;
        if (d < dk) store_as(oh + row * w.ot + d, o[4 * n + 2 * r + c] * inv);
      }
  }
}

template <int NDK>
cudaError_t flash_wgmma_launch(const WgMaps& maps, const bf16_t* q,
                               const bf16_t* posb, const unsigned char* mask,
                               const unsigned char* map, const FlashView& w,
                               bf16_t* out, int B, int H, int T, int dk,
                               float scale, cudaStream_t st) {
  const size_t smem = WgCfg<NDK>::SMEM;
  auto kernel = flash_wgmma_kernel<NDK>;
  static bool sized = false;   // one attribute call per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((T + kFlashTile - 1) / kFlashTile, H, B);
  kernel<<<grid, kWgThreads, smem, st>>>(maps, q, posb, mask, map, w, out, T,
                                         dk, scale);
  return cudaGetLastError();
}

// The bf16 attention for d_k in [1, 128]: k, v (B, H, T, d_k) and pos_p
// (H, T, d_k) views with unit column stride, 16-byte aligned bases and
// every stride of an extent above 1 a multiple of 8 elements (TMA's);
// cudaErrorInvalidValue otherwise.
cudaError_t flash_attention_wgmma(const bf16_t* q, const bf16_t* k,
                                  const bf16_t* v, const bf16_t* pos_p,
                                  const bf16_t* posb,
                                  const unsigned char* mask,
                                  const unsigned char* map,
                                  const FlashView& w, bf16_t* out, int B,
                                  int H, int T, int dk, float scale,
                                  cudaStream_t st) {
  WgMaps maps;
  const long long e4[4] = {dk, T, H, B}, e3[3] = {dk, T, H};
  const long long sk[4] = {1, w.kt, w.kh, w.kb};
  const long long sv[4] = {1, w.vt, w.vh, w.vb};
  const long long sp[3] = {1, w.pt, w.ph};
  if (!make_map(&maps.k, k, 4, e4, sk) || !make_map(&maps.v, v, 4, e4, sv) ||
      !make_map(&maps.p, pos_p, 3, e3, sp))
    return cudaErrorInvalidValue;
  if (dk <= 64)
    return flash_wgmma_launch<64>(maps, q, posb, mask, map, w, out, B, H, T,
                                  dk, scale, st);
  return flash_wgmma_launch<128>(maps, q, posb, mask, map, w, out, B, H, T,
                                 dk, scale, st);
}

}  // namespace
