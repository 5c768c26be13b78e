// The bf16 mode of the training layers (rows 3 and 7 of PERF.md's kernel
// table: conformer_layer_train.cu, squeezeformer_layer_train.cu) for
// Hopper (sm_90a), included through training.cuh. It computes what
// masr_tpu's `_mm` / `_mm_nt` / `_mm_tn` compute at cdt = bf16
// (masr_tpu/ops/pallas/conformer_layer_train.py:79-95): both operands of
// every product rounded to bf16 (RN), the sums f32.
//
//   tw_gemm_kernel         C = E(op(A) . op(B)) of bf16 operands in device
//                          memory, f32 sums, batched, either operand
//                          transposed, split over K where asked
//   BEpi, PartEpi          its epilogues: training.cuh's Epi element for
//                          element, writing f32 and / or a bf16 copy; a
//                          split-K slice's plain f32 sums
//   mm_nn_bf, mm_nt_bf, mm_tn_bf, tw_mm, tw_mm_tn   the products as the
//                          blocks call them; weight grads split over K,
//                          summed in slice order into their bf16 arrays
//   colsum_bf, ln_bwd_bf, scale_drop_sum_bf   column sums (bias and
//                          LayerNorm grads) over 16 row slices, added in
//                          slice order; scale_drop fused with its sum
//   ffn_*_bf, att_*_bf, conv_*_bf   the f32 blocks' bf16 mode: every
//                          product operand is written as bf16 by the
//                          kernel that makes it (a product's epilogue, a
//                          LayerNorm, the softmax, the conv module,
//                          scale_drop_bf, conv_dw_bwd_kernel, add_pos_bf,
//                          ada_rows), rounded once as masr_tpu's cast
//                          rounds it; an f32 copy only where an f32
//                          reader needs it (a column sum, the softmax, the
//                          dSiLU, dq's k + posp)
//
// The product (what bounds it on the H100: the bf16 tensor cores, 989
// TFLOP/s dense, at the layers' ~23.6 GFLOP a fwd + bwd ~0.024 ms; the
// products are small, M = B*T' = 2392 rows, N mostly D = 256, so tiles
// and latency rather than the rate set their time). The design:
//   - bf16 operands in memory: the weights as the pack holds them, the
//     activations as their writers round them, never widened.
//   - TMA tiles. One producer warp walks the k tiles of a block (64 deep)
//     and loads A's 64 x 64 box and B's BN / 64 boxes into a ring of
//     kTwStages stages of 128-byte swizzled shared memory behind `full`
//     (expect_tx) and `empty` (one arrival per consumer warp) mbarriers
//     (hopper.cuh). Every operand is one 4-dim tensor map (inner, rows,
//     two batch dims), so strided head views, shared operands (posp) and
//     batches of (T', T') score rows need no copy; ragged M, N and K edges
//     land as TMA's out-of-bounds zeros. Rows whose stride is not a
//     multiple of 16 bytes (the (B h, T', T') probabilities and dS at T' =
//     299, 150, 45) are written by the softmax kernels with rows of
//     pad8(T') bf16. An operand that TMA cannot read even so (a head width
//     D / h, a width D or F, or a weight's offset not a multiple of 8
//     elements: d_k = 36 at D = 144, h = 4) is loaded by the producer
//     warp's 32 lanes into the same swizzled stages, zeros out of bounds
//     (tw_load_box; slower, the same bits).
//   - wgmma m64nBNk16 bf16 x bf16 + f32 from one consumer warpgroup, both
//     operands from shared memory, K-major or MN-major (the transpose
//     bits): mm_nn's weight, mm_tn's two activations and the attention's
//     v, k, posp and q operands are MN-major and read as they lie.
//     Accumulators in registers (BN / 2 a thread).
//   - the tile plan (tw_bn, tw_kc, ring_stages): 64 x 128 tiles where N >
//     64 and they fill the 132 SMs, else 64 x 64; a ring of 2 to 4 stages
//     by K (more blocks an SM for short K); the weight grads (K = B*T')
//     split over K into slices of a multiple of 64 rows for two waves of
//     blocks, the slices' f32 sums added in slice order (deterministic).
//   - one tile's products in flight while the next tile's are issued.
//   - the epilogue through shared memory (coalesced stores, the row's
//     dropout hash and mask once a row, each group of rows' loads before
//     its stores), Epi's arithmetic element for element, the bf16 copy
//     rounded from the same f32 value.
// Bits: the same operands as the f32 tiles rounded at fragment reads gave
// (rounding on write = rounding on read), the sums in the same k order in
// 16-deep tensor-core steps; the split-K slices of the weight grads and
// dposp differ from gemm_tc's, so those grads' bits move (within the
// bf16 gates).
#pragma once

#include "hopper.cuh"
#include "training.cuh"

namespace {

constexpr int kTwStages = 4;
constexpr int kTwThreads = 160;   // one consumer warpgroup + a producer warp
constexpr int kTwBM = 64, kTwBK = 64;
constexpr int kTwBlocks = 4;      // blocks an SM the registers leave room for

// a bf16 operand: a row-major matrix, rows `ld` elements apart, batch
// matrix z at batch_off(b, z) elements
struct BMat {
  const bf16_t* p;
  long long ld;
  Batch b;
};

// how a block finds its batch's tensor-map coordinates: dim 2 is z % div
// (use2), dim 3 z / div (use3); an unused dim has extent 1. p: nullptr
// where TMA reads the operand, else the operand that the producer's lanes
// load (inner x rows elements, rows ld apart, matrix z at batch_off(b, z))
struct TwOperand {
  int div, use2, use3;
  const bf16_t* p;
  long long ld, inner, rows;
  Batch b;
};

struct TwMaps {
  CUtensorMap a, b;
};

// The reductions' scratch: the products' split-K slices, the column sums'
// slices, and the counters by which the last block of a column group finds
// itself (zero between launches: each last block sets its counter back).
struct Reduce {
  float* part;      // split-K slices
  float* cs;        // colsum_bf's slices
  unsigned* cols;   // colsum_bf's column groups
};

struct TwArgs {
  TwOperand oa, ob;
  int M, N, K, kc, batch, stages;
  long long ldc;     // C's rows
  Batch bc;          // C's batch matrices
  long long part;    // elements between split-K slices' outputs
};

// the ring holds 2 to kTwStages stages (ring_stages), and the epilogue
// tile after the last product
template <int BN>
struct TwCfg {
  static constexpr int A_BYTES = kTwBM * kTwBK * 2;
  static constexpr int STAGE = A_BYTES + BN * kTwBK * 2;
  static constexpr int SC = BN + 8;   // the epilogue tile's rows (floats)
  static_assert(kTwBM * SC * 4 <= 2 * STAGE, "epilogue tile fits");
  static size_t smem(int stages) { return (size_t)stages * STAGE + 1024; }
};

// Stages of a block's ring: every k tile in flight at once up to 4 (3 for
// 64 x 128 tiles of 4 to 7 k tiles: three blocks an SM, not two), at
// least 2 (the epilogue tile)
inline int ring_stages(int k_tiles, int bn) {
  const int most = bn == 128 && k_tiles < 8 ? 3 : kTwStages;
  return k_tiles < 2 ? 2 : (k_tiles < most ? k_tiles : most);
}

// The epilogue of a whole product, training.cuh's Epi element for element
// (the same arithmetic in the same order), into C (f32) and / or Cb (bf16,
// RN), both at offset o; bias2: a second bias added to the first (q+u:
// bias + pos_bias_u, summed as the f32 route sums them); Cb2: a second bf16
// output of the same product with bias + bias2b and no other step (q+v);
// round_c: C holds the value rounded to bf16 (masr_tpu stores it in x's
// dtype); csum (one matrix, no split): each 64-row tile's column sums of
// the value, csum[tile][n], summed over its rows in order (an f32 array
// whose only reader was a column sum need not be written). R may alias C:
// the kernel loads a group's R and aux (load) before it stores any of them
// (store).
struct BEpi : Epi {
  float* C = nullptr;
  bf16_t* Cb = nullptr;
  const float* bias2 = nullptr;
  bf16_t* Cb2 = nullptr;
  const float* bias2b = nullptr;
  bool round_c = false;
  float* csum = nullptr;
  struct In {
    float r, aux;
  };
  struct Col {
    float bias, bias_b;
  };
  // column n's biases (taken once a column, not once an element)
  __device__ __forceinline__ Col col(int n) const {
    return {bias ? (bias2 ? bias[n] + bias2[n] : bias[n]) : 0.f,
            Cb2 ? bias[n] + bias2b[n] : 0.f};
  }
  __device__ __forceinline__ In load(size_t o) const {
    return {R ? R[o] : 0.f, act == kActDsilu ? aux[o] : 0.f};
  }
  __device__ __forceinline__ float store(size_t o, const Row& r,
                                         const Col& c, int n, float acc,
                                         const In& in) const {
    float v = alpha * acc + c.bias;
    if (pre) pre[o] = v;
    if (act == kActSilu) {
      v = silu_f(v);
    } else if (act == kActDsilu) {
      v *= dsilu_f(in.aux);
    }
    if (drop.seeds) v *= dropout_col(r.hash, n, drop.thresh, drop.keep_scale);
    if (!r.ok) v = 0.f;
    v = (R ? in.r : 0.f) + res_scale * v;
    if (round_c) v = to_f32(bf16_rn(v));
    if (C) C[o] = v;
    if (Cb) Cb[o] = bf16_rn(v);
    if (Cb2) Cb2[o] = bf16_rn(alpha * acc + c.bias_b);
    return v;
  }
};

// a split-K slice's sums, as they are, into its part of C
struct PartEpi {
  float* C;
  float* csum = nullptr;   // unused: a slice's sums are not the values
  struct Row {};
  struct In {};
  struct Col {};
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ Col col(int) const { return {}; }
  __device__ __forceinline__ In load(size_t) const { return {}; }
  __device__ __forceinline__ float store(size_t o, const Row&, const Col&,
                                         int, float acc, const In&) const {
    C[o] = acc;
    return acc;
  }
};

// One 64 x 64 box of an operand that TMA cannot read (op.p; matrix zb,
// inner coordinates x0.., rows y0..) into dst as TMA's 128-byte swizzle
// lays it out (hopper.cuh), zeros out of bounds: the producer warp's lanes
// take two neighbouring elements of each row (a warp reads a row's 128
// bytes at once), element by element, so any stride and base will do
__device__ __forceinline__ void tw_load_box(unsigned char* dst,
                                            const TwOperand& op, int zb,
                                            long long x0, long long y0,
                                            int lane) {
  const bf16_t* src = op.p + batch_off(op.b, zb);
  const long long x = x0 + 2 * lane;
  const int chunk = lane / 4, within = lane % 4 * 4;
#pragma unroll 8
  for (int r = 0; r < kWgBox; ++r) {
    const long long y = y0 + r;
    unsigned v = 0;
    if (y < op.rows) {
      const bf16_t* row = src + y * op.ld;
      if (x < op.inner) v = row[x];
      if (x + 1 < op.inner) v |= (unsigned)row[x + 1] << 16;
    }
    *reinterpret_cast<unsigned*>(dst + r * 128 + ((chunk ^ (r & 7)) << 4) +
                                 within) = v;
  }
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void tw_mma(float (&d)[BN / 2], uint64_t a,
                                       uint64_t b) {
  if constexpr (BN == 64)
    wgmma_ss64<TA, TB>(d, a, b, 1);
  else
    wgmma_ss128<TA, TB>(d, a, b, 1);
}

// One block per (64 rows, BN columns, batch matrix and K slice): warps 0-3
// the consumer warpgroup, warp 4 the producer. TA: A stored (K, M) (read
// MN-major), else (M, K); TB: B stored (N, K) (K-major), else (K, N).
// blockIdx.z = slice * batch + z; slice s sums k in [s kc, s kc + kc).
template <int BN, bool TA, bool TB, class E>
__global__ void __launch_bounds__(kTwThreads, kTwBlocks)
    tw_gemm_kernel(const __grid_constant__ TwMaps maps, const TwArgs g,
                   const E e) {
  using Cfg = TwCfg<BN>;
  extern __shared__ unsigned char tw_smem[];
  __shared__ __align__(8) uint64_t full[kTwStages], empty[kTwStages];
  unsigned char* ring =
      tw_smem + ((1024 - (smem_u32(tw_smem) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kTwBM;
  const int zb = blockIdx.z % g.batch, zs = blockIdx.z / g.batch;
  const int k0 = zs * g.kc, k1 = min(g.K, k0 + g.kc);
  const int nk = (k1 - k0 + kTwBK - 1) / kTwBK;
  const bool la = g.oa.p != nullptr, lb = g.ob.p != nullptr;
  if (tid == 4 * 32) {   // the producer's maps, fetched while the
    if (!la) tma_prefetch(&maps.a);   // barriers are set up
    if (!lb) tma_prefetch(&maps.b);
  }
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // the producer: one lane issues each k tile's TMA boxes; an operand
    // that TMA cannot read is loaded by all 32 lanes (tw_load_box), whose
    // stores are fenced for wgmma before lane 0's arrival on `full`
    if (!la && !lb && lane != 0) return;
    const int tx =
        (la ? 0 : Cfg::A_BYTES) + (lb ? 0 : Cfg::STAGE - Cfg::A_BYTES);
    const int a2 = g.oa.use2 ? zb % g.oa.div : 0;
    const int a3 = g.oa.use3 ? zb / g.oa.div : 0;
    const int b2 = g.ob.use2 ? zb % g.ob.div : 0;
    const int b3 = g.ob.use3 ? zb / g.ob.div : 0;
    for (int i = 0; i < nk; ++i) {
      const int s = i % g.stages, round = i / g.stages;
      mbar_wait(&empty[s], (round & 1) ^ 1);
      unsigned char* st = ring + s * Cfg::STAGE;
      const int k = k0 + i * kTwBK;
      if (la) tw_load_box(st, g.oa, zb, TA ? m0 : k, TA ? k : m0, lane);
      if (lb)
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tw_load_box(st + Cfg::A_BYTES + j * kWgBoxBytes, g.ob, zb,
                      TB ? k : n0 + 64 * j, TB ? n0 + 64 * j : k, lane);
      if (la || lb) {
        fence_proxy_async();
        __syncwarp();
      }
      if (lane != 0) continue;
      if (tx == 0) {
        mbar_arrive(&full[s]);
        continue;
      }
      mbar_expect_tx(&full[s], tx);
      if (!la) {
        if (TA)
          tma_load_4d(st, &maps.a, &full[s], m0, k, a2, a3);
        else
          tma_load_4d(st, &maps.a, &full[s], k, m0, a2, a3);
      }
      if (!lb)
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          unsigned char* bs = st + Cfg::A_BYTES + j * kWgBoxBytes;
          if (TB)
            tma_load_4d(bs, &maps.b, &full[s], k, n0 + 64 * j, b2, b3);
          else
            tma_load_4d(bs, &maps.b, &full[s], n0 + 64 * j, k, b2, b3);
        }
    }
    return;
  }

  // the consumers: 4 k16 steps a tile; a K-major operand steps 32 bytes
  // inside its rows, an MN-major one 16 rows (2048 bytes). One tile's
  // products stay in flight while the next tile's are issued (they chain
  // on the same accumulators, which the instruction orders); a stage is
  // released once the products that read it are done.
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % g.stages, round = i / g.stages;
    const uint32_t abase = smem_u32(ring + s * Cfg::STAGE);
    const uint32_t bbase = abase + Cfg::A_BYTES;
    mbar_wait(&full[s], round & 1);
    wg_touch(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTwBK / 16; ++kk) {
      const uint64_t da = TA ? wg_desc(abase + kk * 2048, kWgBoxBytes, 1024)
                             : wg_desc(abase + kk * 32, 0, 1024);
      const uint64_t db = TB ? wg_desc(bbase + kk * 32, 0, 1024)
                             : wg_desc(bbase + kk * 2048, kWgBoxBytes, 1024);
      tw_mma<BN, TA ? 1 : 0, TB ? 0 : 1>(acc, da, db);
    }
    wg_commit();
    wg_wait1();   // tile i - 1's products are done with their stage
    wg_touch(acc);
    __syncwarp();
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % g.stages]);
  }
  wg_wait0();
  wg_touch(acc);

  // Epilogue through shared memory (the ring, every tile consumed): the
  // accumulators (acc[4 j + e]: row 16 w + g + 8 (e >> 1), column 8 j + 2 t
  // + (e & 1)) into a 64 x BN tile, then each warp takes whole rows, its
  // lanes consecutive columns (coalesced), kTwRows rows at a time: every
  // load of the group before any store, so the loads of a group overlap
  // (R may alias C, which would order each load after the last store).
  asm volatile("bar.sync 1, 128;" ::: "memory");
  float* ct = reinterpret_cast<float*>(ring);
  const int gq = lane / 4, tq = lane % 4, wr = warp * 16;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(ct + (wr + gq + 8 * h) * Cfg::SC + 8 * j +
                                 2 * tq) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  asm volatile("bar.sync 1, 128;" ::: "memory");
  const size_t co = (size_t)batch_off(g.bc, zb) + (size_t)zs * g.part;
  constexpr int CW = BN / 32;   // columns a lane
  constexpr int kTwRows = 8 / CW;   // rows a warp's group takes
  typename E::Col cv[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j)
    cv[j] = e.col(min(n0 + lane + 32 * j, g.N - 1));
  float cs[CW] = {};   // the column sums of this thread's rows (csum)
  for (int r0 = warp; r0 < kTwBM; r0 += 4 * kTwRows) {
    typename E::In in[kTwRows][CW];
    typename E::Row row[kTwRows];
    size_t ob[kTwRows];   // row m's element n0 + lane
#pragma unroll
    for (int q = 0; q < kTwRows; ++q) {
      const int m = m0 + r0 + 4 * q;
      if (m >= g.M) continue;
      row[q] = e.row(m);
      ob[q] = co + (size_t)m * g.ldc + n0 + lane;
#pragma unroll
      for (int j = 0; j < CW; ++j)
        if (n0 + lane + 32 * j < g.N) in[q][j] = e.load(ob[q] + 32 * j);
    }
#pragma unroll
    for (int q = 0; q < kTwRows; ++q) {
      if (m0 + r0 + 4 * q >= g.M) continue;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int n = n0 + lane + 32 * j;
        if (n < g.N)
          cs[j] += e.store(ob[q] + 32 * j, row[q], cv[j], n,
                           ct[(r0 + 4 * q) * Cfg::SC + lane + 32 * j],
                           in[q][j]);
      }
    }
  }
  if (e.csum) {
    // the 4 warps' sums of each column added in warp order
    asm volatile("bar.sync 1, 128;" ::: "memory");
#pragma unroll
    for (int j = 0; j < CW; ++j) ct[warp * BN + lane + 32 * j] = cs[j];
    asm volatile("bar.sync 1, 128;" ::: "memory");
    if (warp == 0)
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int n = n0 + lane + 32 * j;
        if (n >= g.N) continue;
        float t = 0.f;
        for (int w = 0; w < 4; ++w) t += ct[w * BN + lane + 32 * j];
        e.csum[(size_t)blockIdx.y * g.N + n] = t;
      }
  }
}

// operand x's tensor map: dims (inner, rows, batch dim 2, batch dim 3),
// strides (1, ld, b.s2, b.s1) elements. Where TMA cannot read x (its base
// not 16-byte aligned, a stride it steps not a multiple of 8 elements), op
// takes x for the producer's lanes instead (TwOperand::p). False only
// where the map's encoding fails.
inline bool tw_map(CUtensorMap* m, TwOperand* op, const BMat& x,
                   long long inner, long long rows, int batch) {
  const int div = x.b.div > 0 ? x.b.div : 1;
  op->div = div;
  op->use2 = x.b.s2 != 0 && div > 1;
  op->use3 = x.b.s1 != 0 && batch / div > 1;
  op->p = nullptr;
  if (reinterpret_cast<size_t>(x.p) % 16 == 0 &&
      (rows == 1 || x.ld % 8 == 0) && (!op->use2 || x.b.s2 % 8 == 0) &&
      (!op->use3 || x.b.s1 % 8 == 0)) {
    const long long ext[4] = {inner, rows, op->use2 ? div : 1,
                              op->use3 ? batch / div : 1};
    const long long str[4] = {1, x.ld, x.b.s2, x.b.s1};
    return make_map(m, x.p, 4, ext, str);
  }
  op->p = x.p;
  op->ld = x.ld;
  op->inner = inner;
  op->rows = rows;
  op->b = x.b;
  op->b.div = div;
  return true;
}

// 64 x 128 tiles where N > 64 and they fill the 132 SMs, else 64 x 64
inline int tw_bn(int M, int N, int batch) {
  const long big = (long)((M + 63) / 64) * ((N + 127) / 128) * batch;
  return N > 64 && big >= 132 ? 128 : 64;
}

// rows of K a split-K slice sums (a multiple of 64): enough slices for
// about two waves of `tiles` blocks, none under 256 rows
inline int tw_kc(long tiles, int K) {
  const long want = (2 * 132 + tiles - 1) / tiles, most = K / 256;
  const long slices = want < most ? want : (most > 1 ? most : 1);
  const long per = (K + slices - 1) / (slices > 1 ? slices : 1);
  return (int)((per + kTwBK - 1) / kTwBK * kTwBK);
}

template <int BN, bool TA, bool TB, class E>
cudaError_t tw_run(const TwMaps& maps, TwArgs g, const E& e, int slices,
                   cudaStream_t st) {
  auto kernel = tw_gemm_kernel<BN, TA, TB, E>;
  static bool sized = false;   // one attribute call per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TwCfg<BN>::smem(kTwStages));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  g.stages = ring_stages((g.kc + kTwBK - 1) / kTwBK, BN);
  const size_t smem = TwCfg<BN>::smem(g.stages);
  dim3 grid((g.N + BN - 1) / BN, (g.M + kTwBM - 1) / kTwBM,
            g.batch * slices);
  kernel<<<grid, kTwThreads, smem, st>>>(maps, g, e);
  return cudaGetLastError();
}

// C = E(op(A) (M, K) . op(B) (K, N)) for `batch` matrices (C's rows ldc
// apart, matrix z at batch_off(bc, z)); kc > 0: slices of kc rows of K
// (a multiple of 64) into outputs `part` elements apart (E a PartEpi)
template <bool TA, bool TB, class E>
cudaError_t tw_mm(const BMat& A, const BMat& B, int M, int N, int K,
                  int batch, long long ldc, const Batch& bc, const E& e,
                  cudaStream_t st, int kc = 0, long long part = 0) {
  if (M <= 0 || N <= 0 || K <= 0 || batch <= 0) return cudaGetLastError();
  TwMaps maps = {};
  TwArgs g;
  if (!tw_map(&maps.a, &g.oa, A, TA ? M : K, TA ? K : M, batch) ||
      !tw_map(&maps.b, &g.ob, B, TB ? K : N, TB ? N : K, batch))
    return cudaErrorInvalidValue;
  g.M = M;
  g.N = N;
  g.K = K;
  g.kc = kc > 0 ? kc : K;
  g.batch = batch;
  g.ldc = ldc;
  g.bc = bc;
  g.part = part;
  const int slices = (K + g.kc - 1) / g.kc;
  if (tw_bn(M, N, batch) == 128)
    return tw_run<128, TA, TB>(maps, g, e, slices, st);
  return tw_run<64, TA, TB>(maps, g, e, slices, st);
}

// the split-K plan of tw_mm_tn: rows a slice sums (K: one slice)
inline int tw_tn_kc(int M, int N, int K, int batch) {
  const int bn = tw_bn(M, N, batch);
  return tw_kc((long)((M + 63) / 64) * ((N + bn - 1) / bn) * batch, K);
}

// elements of C's batch matrices, which tile [0, region) (the layouts of
// the weight grads and dposp)
inline long long tw_region(int M, int N, int batch, long long ldc,
                           const Batch& bc) {
  return (long long)(batch - 1) / bc.div * bc.s1 +
         (long long)((batch - 1) % bc.div) * bc.s2 + (M - 1) * ldc + N;
}

// floats of `part` that tw_mm_tn takes for this shape (0: one slice)
inline size_t tw_part_floats(int M, int N, int K, int batch, long long ldc,
                             const Batch& bc) {
  const int kc = tw_tn_kc(M, N, K, batch), slices = (K + kc - 1) / kc;
  return slices > 1 ? (size_t)slices * tw_region(M, N, batch, ldc, bc) : 0;
}

// C[i] (OT: f32, or bf16 rounded once from the f32 sum) = the sum of the
// split-K slices' part[z n + i] in slice order
template <class OT>
__global__ void tw_sum_kernel(const float* __restrict__ part,
                              OT* __restrict__ C, int slices, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < slices; ++z) s += part[(size_t)z * n + i];
    store_as(C + i, s);
  }
}

// C (OT: float, or bf16 rounded once from the f32 sum) = A^T . B over K
// rows (A stored (K, M), B (K, N)), for `batch` matrices: split over K by
// tw_tn_kc into rd.part, the slices summed in slice order
template <class OT>
cudaError_t tw_mm_tn(const BMat& A, const BMat& B, OT* C, int M, int N, int K,
                     int batch, long long ldc, const Batch& bc,
                     const Reduce& rd, cudaStream_t st) {
  const int kc = tw_tn_kc(M, N, K, batch), slices = (K + kc - 1) / kc;
  if (slices == 1) {
    BEpi e;
    if constexpr (is_bf16<OT>)
      e.Cb = C;
    else
      e.C = C;
    return tw_mm<true, false>(A, B, M, N, K, batch, ldc, bc, e, st);
  }
  const long long region = tw_region(M, N, batch, ldc, bc);
  TRY((tw_mm<true, false>(A, B, M, N, K, batch, ldc, bc, PartEpi{rd.part},
                          st, kc, region)));
  tw_sum_kernel<OT><<<blocks_for((size_t)region, 256), 256, 0, st>>>(
      rd.part, C, slices, (size_t)region);
  return cudaGetLastError();
}

// C (M, N) = E(A (M, K) . W (K, N)), row-major
cudaError_t mm_nn_bf(const bf16_t* A, const bf16_t* W, int M, int N, int K,
                     const BEpi& e, cudaStream_t st) {
  return tw_mm<false, false>(BMat{A, K}, BMat{W, N}, M, N, K, 1, N, Batch(),
                             e, st);
}

// C (M, N) = E(A (M, K) . W^T), W stored (N, K)
cudaError_t mm_nt_bf(const bf16_t* A, const bf16_t* W, int M, int N, int K,
                     const BEpi& e, cudaStream_t st) {
  return tw_mm<false, true>(BMat{A, K}, BMat{W, K}, M, N, K, 1, N, Batch(),
                            e, st);
}

// a weight's grad C (M, N) bf16 = A^T . B over K = B*T' rows (A stored (K,
// M), B (K, N))
cudaError_t mm_tn_bf(const bf16_t* A, const bf16_t* B, bf16_t* C, int M,
                     int N, int K, const Reduce& rd, cudaStream_t st) {
  return tw_mm_tn(BMat{A, M}, BMat{B, N}, C, M, N, K, 1, N, Batch(), rd, st);
}

// floats of `part` for the bf16 mode's weight grads of a layer with M =
// B*T rows: the largest of its (F, D), (D, F), (D, D), (D, 2D) products and
// dposp's (per head, K = B*T)
size_t tw_part_floats_layer(int B, int T, int D, int F, int H) {
  const int M = B * T, shapes[4][2] = {{F, D}, {D, F}, {D, D}, {D, 2 * D}};
  size_t most = 0;
  for (const auto& mn : shapes) {
    const size_t n = tw_part_floats(mn[0], mn[1], M, 1, mn[1], Batch());
    most = n > most ? n : most;
  }
  Batch heads;
  heads.s1 = D / H;
  const size_t n = tw_part_floats(T, D / H, M, H, D, heads);
  return n > most ? n : most;
}

// ------------------------------------------------------------------------
// Elementwise pieces of the bf16 mode
// ------------------------------------------------------------------------
// Column sums of the bf16 mode, spread over the SMs and deterministic
// (training.cuh's colsum takes one block per 32 columns: 8 blocks at N =
// 256): block (x, z) sums rows [z rs, z rs + rs) of columns [32 x, 32 x +
// 32) (8 warps striding the rows, added in warp order) into rd.cs; the
// last block of a column group to finish (rd.cols, set back to 0) adds the
// slices in slice order. out0[n] = the sum of X Y (Y nullptr: of X), out1
// (nullptr: none) the sum of X, over rows t < lens[b] (lens nullptr: every
// row). kDrop (scale_drop's rows, whose only f32 reader was their column
// sum): X is scale * x * drop(b, t, n), 0 in rows t >= lens[b], written as
// bf16 into xb, out0 its column sums.
constexpr int kCsSlices = 16, kCsWarps = 8;

template <bool kDrop>
__global__ void __launch_bounds__(kCsWarps * 32)
    colsum_bf_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                     float* __restrict__ out0, float* __restrict__ out1,
                     int M, int N, int rs, const int* __restrict__ lens,
                     int T, float scale, Drop d, bf16_t* __restrict__ xb,
                     Reduce rd) {
  __shared__ float p[2][kCsWarps][33];
  __shared__ unsigned prev;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * 32 + lane, z = blockIdx.y, S = gridDim.y;
  const int r1 = min(M, z * rs + rs);
  float s0 = 0.f, s1 = 0.f;
  if (n < N)
    for (int m = z * rs + warp; m < r1; m += kCsWarps) {
      const int b = m / T, t = m % T;
      const bool ok = lens == nullptr || t < lens[b];
      const size_t o = (size_t)m * N + n;
      if constexpr (kDrop) {
        const float x = ok ? scale * X[o] * drop_at(d, b, t, n) : 0.f;
        xb[o] = bf16_rn(x);
        s0 += x;
      } else if (ok) {
        s0 += Y ? X[o] * Y[o] : X[o];
        s1 += X[o];
      }
    }
  p[0][warp][lane] = s0;
  p[1][warp][lane] = s1;
  __syncthreads();
  if (warp != 0) return;
  float t0 = 0.f, t1 = 0.f;
  for (int w = 0; w < kCsWarps; ++w) {
    t0 += p[0][w][lane];
    t1 += p[1][w][lane];
  }
  float* part = rd.cs + (size_t)z * 2 * N;
  if (n < N) {
    part[n] = t0;
    part[N + n] = t1;
  }
  __threadfence();
  __syncwarp();   // every lane's slice stored and fenced before the count
  if (lane == 0) prev = atomicAdd(rd.cols + blockIdx.x, 1u);
  __syncwarp();
  if (prev != (unsigned)S - 1) return;   // not the group's last slice
  __threadfence();
  if (n < N) {
    float u0 = 0.f, u1 = 0.f;
    for (int q = 0; q < S; ++q) {
      u0 += __ldcg(rd.cs + (size_t)q * 2 * N + n);
      u1 += __ldcg(rd.cs + (size_t)q * 2 * N + N + n);
    }
    out0[n] = u0;
    if (out1) out1[n] = u1;
  }
  if (lane == 0) rd.cols[blockIdx.x] = 0;
}

template <bool kDrop>
cudaError_t colsum_bf_launch(const float* X, const float* Y, float* out0,
                             float* out1, int M, int N, const int* lens,
                             int T, float scale, const Drop& d, bf16_t* xb,
                             const Reduce& rd, cudaStream_t st) {
  const int rs = (M + kCsSlices - 1) / kCsSlices;
  colsum_bf_kernel<kDrop>
      <<<dim3((N + 31) / 32, (M + rs - 1) / rs), kCsWarps * 32, 0, st>>>(
          X, Y, out0, out1, M, N, rs, lens, T, scale, d, xb, rd);
  return cudaGetLastError();
}

// out0 = column sums of X * Y (Y nullptr: of X), out1 those of X
cudaError_t colsum_bf(const float* X, const float* Y, float* out0,
                      float* out1, int M, int N, const int* lens, int T,
                      const Reduce& rd, cudaStream_t st) {
  return colsum_bf_launch<false>(X, Y, out0, out1, M, N, lens, T, 1.f,
                                 Drop{}, nullptr, rd, st);
}

// xb = bf16(scale * x * drop), rows t >= lens[b] zero, and its column sums
cudaError_t scale_drop_sum_bf(const float* x, bf16_t* xb, float* sum, int M,
                              int N, float scale, const Drop& d,
                              const int* lens, int T, const Reduce& rd,
                              cudaStream_t st) {
  return colsum_bf_launch<true>(x, nullptr, sum, nullptr, M, N, lens, T,
                                scale, d, xb, rd, st);
}

// out[n] = the sum over tiles of csum[tile][n], in tile order (a product's
// column sums from its epilogue, BEpi::csum)
__global__ void tile_sum_kernel(const float* __restrict__ csum,
                                float* __restrict__ out, int tiles, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += csum[(size_t)t * N + n];
  out[n] = s;
}

cudaError_t tile_sum(const float* csum, float* out, int M, int N,
                     cudaStream_t st) {
  tile_sum_kernel<<<(N + 127) / 128, 128, 0, st>>>(csum, out,
                                                   (M + kTwBM - 1) / kTwBM,
                                                   N);
  return cudaGetLastError();
}

// ln_bwd with colsum_bf's column sums for (gamma, beta)
cudaError_t ln_bwd_bf(const float* dy, const float* xhat, const float* rstd,
                      const float* lnw, float* dlnw, int idx,
                      const float* base, float* dx, int M, int D,
                      const int* lens, int T, const Reduce& rd,
                      cudaStream_t st) {
  const size_t off = (size_t)idx * 2 * D;
  ln_bwd_kernel<<<(M + 7) / 8, 256, 0, st>>>(dy, xhat, rstd, lnw + off, base,
                                             dx, M, D, lens, T);
  TRY(cudaGetLastError());
  return colsum_bf(dy, xhat, dlnw + off, dlnw + off + D, M, D, lens, T, rd,
                   st);
}

// conv_pad_grad_kernel's sum spread over the warps of a block of 32
// channels (warp w takes utterances w, w + 8, ...; partials added in warp
// order)
__global__ void __launch_bounds__(kCsWarps * 32)
    conv_pad_grad_bf_kernel(const float* __restrict__ dc,
                            const float* __restrict__ dww,
                            const float* __restrict__ pw1b,
                            float* __restrict__ dpw1b, int B, int T, int D,
                            int left) {
  __shared__ float p[kCsWarps][33];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float du0 = 0.f;
  if (c < D)
    for (int b = warp; b < B; b += kCsWarps)
      for (int r = 0; r < left; ++r)
        for (int j = 0; j <= r; ++j)
          if (r - j < T)
            du0 = fmaf(dc[((size_t)b * T + r - j) * D + c], dww[j * D + c],
                       du0);
  p[warp][lane] = du0;
  __syncthreads();
  if (warp != 0 || c >= D) return;
  float s = 0.f;
  for (int w = 0; w < kCsWarps; ++w) s += p[w][lane];
  const float s0 = sigmoid_f(pw1b[D + c]);
  dpw1b[c] += s * s0;
  dpw1b[D + c] += s * pw1b[c] * s0 * (1.f - s0);
}

// out (M, D) = bf16(k + posp[row % T]): dq's right operand, the sum of the
// f32 keys and the bf16 positions rounded as one operand (masr_tpu's
// _mm(dS, kh + ph, cdt))
__global__ void add_pos_bf_kernel(const float* __restrict__ k,
                                  const bf16_t* __restrict__ posp,
                                  bf16_t* __restrict__ out, int T, int D,
                                  size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = bf16_rn(k[i] + to_f32(posp[(i / D) % T * D + i % D]));
}

// rows of the bf16 (h, B, T, T) probabilities and dS: T padded to 8
// elements, so every row starts 16-byte aligned for TMA
inline int pad8(int T) { return (T + 7) / 8 * 8; }

// ------------------------------------------------------------------------
// FFN (training.cuh's ffn_fwd / ffn_bwd) with bf16 operands. Forward: h =
// bf16(drop_h(SiLU(a . w1 + b1))) (z the f32 pre-activation), C = R +
// scale * drop_out(h . w2 + b2) (f32). Backward from dxw: df = scale *
// dxw * drop_out (bf16 into tmp.dfb, its column sums db2), the bf16 grads
// of w1 and w2, the f32 grads of b1 and b2 (db1 from dz's product, its
// tiles' column sums: dz is written as bf16 only) and da = base + the
// grad of a (f32).
// ------------------------------------------------------------------------
struct FfnTmp {
  bf16_t *dzb, *dfb;
};

cudaError_t ffn_fwd_bf(const float* R, float* C, const bf16_t* a, float* z,
                       bf16_t* h, const bf16_t* w1, const float* b1,
                       const bf16_t* w2, const float* b2, int M, int D, int F,
                       int T, float scale, const Drop& dh, const Drop& dout,
                       cudaStream_t st) {
  BEpi e1;
  e1.bias = b1;
  e1.pre = z;
  e1.act = kActSilu;
  e1.drop = dh;
  e1.T = T;
  e1.Cb = h;
  TRY(mm_nn_bf(a, w1, M, F, D, e1, st));
  BEpi e2;
  e2.bias = b2;
  e2.R = R;
  e2.res_scale = scale;
  e2.drop = dout;
  e2.T = T;
  e2.C = C;
  return mm_nn_bf(h, w2, M, D, F, e2, st);
}

cudaError_t ffn_bwd_bf(const float* dxw, const bf16_t* a, const float* z,
                       const bf16_t* h, const bf16_t* w1, const bf16_t* w2,
                       bf16_t* dw1, float* db1, bf16_t* dw2, float* db2,
                       const FfnTmp& tmp, const float* base, float* da,
                       const Reduce& rd, int M, int D, int F,
                       int T, float scale, const Drop& dh, const Drop& dout,
                       cudaStream_t st) {
  TRY(scale_drop_sum_bf(dxw, tmp.dfb, db2, M, D, scale, dout, nullptr, T, rd,
                        st));
  TRY(mm_tn_bf(h, tmp.dfb, dw2, F, D, M, rd, st));
  BEpi e;
  e.act = kActDsilu;
  e.aux = z;
  e.drop = dh;
  e.T = T;
  e.Cb = tmp.dzb;
  e.csum = rd.cs;
  TRY(mm_nt_bf(tmp.dfb, w2, M, F, D, e, st));
  TRY(tile_sum(rd.cs, db1, M, F, st));
  TRY(mm_tn_bf(a, tmp.dzb, dw1, D, F, M, rd, st));
  BEpi ea;
  ea.R = base;
  ea.C = da;
  return mm_nt_bf(tmp.dzb, w1, M, D, F, ea, st);
}

// ------------------------------------------------------------------------
// Rel-pos MHSA (training.cuh's att_fwd / att_bwd) with bf16 operands. The
// forward saves q+u, q+v, bf16(k), v, O and Pd as bf16 (Pd's rows pad8(T)
// apart), k and P f32 (dq's k + posp and the softmax backward read them).
// The backward's f32 arrays t[0], t[2..5] (M, D) are t[0] dk, t[2] dv,
// t[3] dS.k, t[4] dS.posp, t[5] dq; da may be t[1]; its bf16 arrays are
// AttTmp's.
// ------------------------------------------------------------------------
struct AttBufsBf {
  bf16_t *qu, *qv, *kb, *v, *o, *Pd;
  float *k, *P;
};

struct AttTmp {
  bf16_t *datt, *dO, *dv, *dS, *kp, *dq, *dk;
};

// the batched products' matrices, z = b H + h: q-like (B, T, D) head
// slices, posp (T, D) head slices, the f32 scores (T apart) and the bf16
// rows (Tp apart) of the (h, B, T, T) layout
struct AttBatchesBf {
  Batch q, pos, s, sp;
  AttBatchesBf(int B, int T, int D, int H) {
    const int dk = D / H, Tp = pad8(T);
    q.s1 = (long long)T * D;
    q.s2 = dk;
    q.div = H;
    pos.s1 = 0;
    pos.s2 = dk;
    pos.div = H;
    s.s1 = (long long)T * T;
    s.s2 = (long long)B * T * T;
    s.div = H;
    sp.s1 = (long long)T * Tp;
    sp.s2 = (long long)B * T * Tp;
    sp.div = H;
  }
};

// round_c: C rounded to bf16 values (masr_tpu's x2 = x1 + att in x's
// dtype)
cudaError_t att_fwd_bf(const bf16_t* a, const bf16_t* attw, const float* bias,
                       const float* posb, const bf16_t* posp,
                       const unsigned char* mask, const AttBufsBf& s,
                       const float* R, float* C, bool round_c,
                       const Drop& dprob, const Drop& dout, int B, int T,
                       int D, int H, cudaStream_t st) {
  const int M = B * T, dk = D / H, Tp = pad8(T), BH = B * H;
  const size_t DD = (size_t)D * D;
  BEpi e;   // q+u and q+v: one q product, the position biases added
  e.bias = bias;
  e.bias2 = posb;
  e.Cb = s.qu;
  e.bias2b = posb + D;
  e.Cb2 = s.qv;
  TRY(mm_nn_bf(a, attw, M, D, D, e, st));
  e.bias = bias + D;
  e.bias2 = nullptr;
  e.Cb2 = nullptr;
  e.C = s.k;
  e.Cb = s.kb;
  TRY(mm_nn_bf(a, attw + DD, M, D, D, e, st));
  e.bias = bias + 2 * D;
  e.C = nullptr;
  e.Cb = s.v;
  TRY(mm_nn_bf(a, attw + 2 * DD, M, D, D, e, st));
  const AttBatchesBf bt(B, T, D, H);
  BEpi es;
  es.alpha = 1.f / sqrtf((float)dk);
  es.C = s.P;
  TRY((tw_mm<false, true>(BMat{s.qu, D, bt.q}, BMat{s.kb, D, bt.q}, T, T, dk,
                          BH, T, bt.s, es, st)));
  es.R = s.P;
  TRY((tw_mm<false, true>(BMat{s.qv, D, bt.q}, BMat{posp, D, bt.pos}, T, T,
                          dk, BH, T, bt.s, es, st)));
  const long long rows = (long long)H * B * T;
  att_softmax_kernel<bf16_t><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      s.P, s.P, s.Pd, Tp, mask, B, H, T, dprob);
  TRY(cudaGetLastError());
  BEpi eo0;
  eo0.Cb = s.o;
  TRY((tw_mm<false, false>(BMat{s.Pd, Tp, bt.sp}, BMat{s.v, D, bt.q}, T, dk,
                           T, BH, D, bt.q, eo0, st)));
  BEpi eo;
  eo.bias = bias + 3 * D;
  eo.R = R;
  eo.drop = dout;
  eo.T = T;
  eo.C = C;
  eo.round_c = round_c;
  return mm_nn_bf(s.o, attw + 3 * DD, M, D, D, eo, st);
}

cudaError_t att_bwd_bf(const float* dres, const bf16_t* a,
                       const bf16_t* attw, const bf16_t* posp,
                       const AttBufsBf& s, const Drop& dprob,
                       const Drop& dout, bf16_t* dattw, float* dbias,
                       float* dposb, bf16_t* dposp, const float* base,
                       float* da, float* const* t, float* dP,
                       const AttTmp& b, const Reduce& rd,
                       int B, int T, int D, int H, cudaStream_t st) {
  const int M = B * T, dk = D / H, Tp = pad8(T), BH = B * H;
  const size_t MD = (size_t)M * D, DD = (size_t)D * D;
  const AttBatchesBf bt(B, T, D, H);
  TRY(scale_drop_sum_bf(dres, b.datt, dbias + 3 * D, M, D, 1.f, dout,
                        nullptr, T, rd, st));
  TRY(mm_tn_bf(s.o, b.datt, dattw + 3 * DD, D, D, M, rd, st));
  BEpi eO;
  eO.Cb = b.dO;
  TRY(mm_nt_bf(b.datt, attw + 3 * DD, M, D, D, eO, st));
  BEpi eP;
  eP.C = dP;
  TRY((tw_mm<false, true>(BMat{b.dO, D, bt.q}, BMat{s.v, D, bt.q}, T, T, dk,
                          BH, T, bt.s, eP, st)));
  BEpi ev;
  ev.C = t[2];
  ev.Cb = b.dv;
  TRY((tw_mm<true, false>(BMat{s.Pd, Tp, bt.sp}, BMat{b.dO, D, bt.q}, T, dk,
                          T, BH, D, bt.q, ev, st)));
  const long long rows = (long long)H * B * T;
  att_softmax_bwd_kernel<bf16_t><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      dP, b.dS, Tp, s.P, B, H, T, dprob, 1.f / sqrtf((float)dk));
  TRY(cudaGetLastError());
  BEpi ek;
  ek.C = t[3];
  TRY((tw_mm<false, false>(BMat{b.dS, Tp, bt.sp}, BMat{s.kb, D, bt.q}, T, dk,
                           T, BH, D, bt.q, ek, st)));
  BEpi ep;
  ep.C = t[4];
  TRY((tw_mm<false, false>(BMat{b.dS, Tp, bt.sp}, BMat{posp, D, bt.pos}, T,
                           dk, T, BH, D, bt.q, ep, st)));
  TRY(colsum_bf(t[3], nullptr, dposb, nullptr, M, D, nullptr, T, rd, st));
  TRY(colsum_bf(t[4], nullptr, dposb + D, nullptr, M, D, nullptr, T, rd,
                st));
  add_pos_bf_kernel<<<blocks_for(MD, 256), 256, 0, st>>>(s.k, posp, b.kp, T,
                                                         D, MD);
  TRY(cudaGetLastError());
  BEpi eq;
  eq.C = t[5];
  eq.Cb = b.dq;
  TRY((tw_mm<false, false>(BMat{b.dS, Tp, bt.sp}, BMat{b.kp, D, bt.q}, T, dk,
                           T, BH, D, bt.q, eq, st)));
  BEpi ekk;
  ekk.C = t[0];
  ekk.Cb = b.dk;
  TRY((tw_mm<true, false>(BMat{b.dS, Tp, bt.sp}, BMat{s.qu, D, bt.q}, T, dk,
                          T, BH, D, bt.q, ekk, st)));
  // dposp[:, head h] = sum over b of dS[h, b]^T . (q+v)[b, :, head h]: one
  // product per head with K = B*T (dS is laid out (h, B, T, Tp))
  Batch bh_s, bh_q;
  bh_s.s1 = (long long)B * T * Tp;
  bh_q.s1 = dk;
  TRY(tw_mm_tn(BMat{b.dS, Tp, bh_s}, BMat{s.qv, D, bh_q}, dposp, T, dk,
               B * T, H, D, bh_q, rd, st));
  TRY(colsum_bf(t[5], nullptr, dbias, nullptr, M, D, nullptr, T, rd, st));
  TRY(colsum_bf(t[0], nullptr, dbias + D, nullptr, M, D, nullptr, T, rd,
                st));
  TRY(colsum_bf(t[2], nullptr, dbias + 2 * D, nullptr, M, D, nullptr, T, rd,
                st));
  TRY(mm_tn_bf(a, b.dq, dattw, D, D, M, rd, st));
  TRY(mm_tn_bf(a, b.dk, dattw + DD, D, D, M, rd, st));
  TRY(mm_tn_bf(a, b.dv, dattw + 2 * DD, D, D, M, rd, st));
  BEpi e0;
  e0.R = base;
  e0.C = da;
  TRY(mm_nt_bf(b.dq, attw, M, D, D, e0, st));
  BEpi acc;
  acc.R = da;
  acc.C = da;
  TRY(mm_nt_bf(b.dk, attw + DD, M, D, D, acc, st));
  return mm_nt_bf(b.dv, attw + 2 * DD, M, D, D, acc, st);
}

// ------------------------------------------------------------------------
// The conv module (training.cuh's conv_fwd / conv_bwd) with bf16
// operands: the forward saves pw1's output g (f32), the LN's output before
// SiLU, its x-hat and 1/std (f32) and the SiLU output y (bf16, pw2's
// operand). The backward's f32 arrays t[1..2] (M, D), dg (M, 2D) and bf16
// t0b (M, D), dgb (M, 2D); da (f32) the grad of a in every row.
// ------------------------------------------------------------------------
struct ConvBufsBf {
  float *g, *cn, *xhat, *rstd;
  bf16_t* y;
};

cudaError_t conv_fwd_bf(const bf16_t* a, const bf16_t* pw1w,
                        const float* pw1b, const float* dww, const float* dwb,
                        const float* norm, const bf16_t* pw2w,
                        const float* pw2b, const ConvBufsBf& s, const float* R,
                        float* C, const int* lens, const Drop& d, int B, int T,
                        int D, int ksize, int causal, float eps,
                        cudaStream_t st) {
  const int M = B * T;
  BEpi eg;
  eg.bias = pw1b;
  eg.C = s.g;
  TRY(mm_nn_bf(a, pw1w, M, 2 * D, D, eg, st));
  TRY(conv_module(s.g, dww, dwb, pw1b, norm, s.y, B, T, T, D, ksize,
                  causal ? ksize - 1 : (ksize - 1) / 2, causal, eps, st,
                  s.cn, s.xhat, s.rstd));
  BEpi ec;
  ec.bias = pw2b;
  ec.R = R;
  ec.drop = d;
  ec.lens = lens;
  ec.T = T;
  ec.C = C;
  return mm_nn_bf(s.y, pw2w, M, D, D, ec, st);
}

cudaError_t conv_bwd_bf(const float* dres, const bf16_t* a,
                        const ConvBufsBf& s, const bf16_t* pw1w,
                        const float* pw1b, const float* dww,
                        const float* norm, const bf16_t* pw2w,
                        const int* lens, const Drop& d, bf16_t* dpw2w,
                        float* dpw2b, float* dnorm, float* ddwb, float* ddww,
                        float* dpw1b, bf16_t* dpw1w, float* da,
                        float* const* t, float* dg, bf16_t* t0b, bf16_t* dgb,
                        const Reduce& rd, int B, int T, int D,
                        int ksize, int causal, cudaStream_t st) {
  const int M = B * T;
  const size_t MD = (size_t)M * D;
  TRY(scale_drop_sum_bf(dres, t0b, dpw2b, M, D, 1.f, d, lens, T, rd, st));
  TRY(mm_tn_bf(s.y, t0b, dpw2w, D, D, M, rd, st));
  BEpi ed;
  ed.act = kActDsilu;
  ed.aux = s.cn;
  ed.C = t[1];
  TRY(mm_nt_bf(t0b, pw2w, M, D, D, ed, st));
  TRY(ln_bwd_bf(t[1], s.xhat, s.rstd, norm, dnorm, 0, nullptr, t[2], M, D,
                nullptr, T, rd, st));
  TRY(colsum_bf(t[2], nullptr, ddwb, nullptr, M, D, nullptr, T, rd, st));
  const int left = causal ? ksize - 1 : (ksize - 1) / 2;
  conv_dww_kernel<<<dim3((D + 31) / 32, ksize), kColWarps * 32, 0, st>>>(
      t[2], s.g, pw1b, ddww, B, T, D, left, causal);
  TRY(cudaGetLastError());
  conv_dw_bwd_kernel<<<blocks_for(MD, 256), 256, 0, st>>>(
      t[2], s.g, dww, dg, dgb, B, T, D, ksize, left);
  TRY(cudaGetLastError());
  TRY(colsum_bf(dg, nullptr, dpw1b, nullptr, M, 2 * D, nullptr, T, rd, st));
  if (causal && left > 0) {
    conv_pad_grad_bf_kernel<<<(D + 31) / 32, kCsWarps * 32, 0, st>>>(
        t[2], dww, pw1b, dpw1b, B, T, D, left);
    TRY(cudaGetLastError());
  }
  TRY(mm_tn_bf(a, dgb, dpw1w, D, 2 * D, M, rd, st));
  BEpi ea;
  ea.C = da;
  return mm_nt_bf(dgb, pw1w, M, D, 2 * D, ea, st);
}

// ------------------------------------------------------------------------
// Layouts of the bf16 mode: offsets in floats, every array 256-byte
// aligned, a bf16 array of n elements taking n / 2 floats.
// ------------------------------------------------------------------------
struct Layout {
  size_t off = 0;
  size_t f32(size_t n) {
    const size_t o = off;
    off += (n + 63) / 64 * 64;
    return o;
  }
  size_t bf16(size_t n) { return f32((n + 1) / 2); }
};

// the array of type T at a layout's offset
template <class T>
T* at(float* base, size_t off) {
  return reinterpret_cast<T*>(base + off);
}

// the five bf16 product weights and posp, copied by the forward into
// `saved` for the backward (whose C entry takes no weight pointers)
struct WeightsBf {
  size_t ffw1, ffw2, attw, pw1w, pw2w, posp;
};

inline WeightsBf weights_bf(Layout& l, int T, int D, int F) {
  const size_t DF = (size_t)D * F, DD = (size_t)D * D;
  WeightsBf w;
  w.ffw1 = l.bf16(2 * DF);
  w.ffw2 = l.bf16(2 * DF);
  w.attw = l.bf16(4 * DD);
  w.pw1w = l.bf16(2 * DD);
  w.pw2w = l.bf16(DD);
  w.posp = l.bf16((size_t)T * D);
  return w;
}

// the attention's saved arrays
inline void att_saved_bf(Layout& l, size_t* qu, size_t* qv, size_t* kb,
                         size_t* v, size_t* o, size_t* Pd, size_t* k,
                         size_t* P, int B, int T, int D, int H) {
  const size_t MD = (size_t)B * T * D;
  *qu = l.bf16(MD);
  *qv = l.bf16(MD);
  *kb = l.bf16(MD);
  *v = l.bf16(MD);
  *o = l.bf16(MD);
  *Pd = l.bf16((size_t)H * B * T * pad8(T));
  *k = l.f32(MD);
  *P = l.f32((size_t)H * B * T * T);
}

// the reductions' scratch of a layer's backward (Reduce): the split-K
// slices of the largest weight grad, colsum_bf's slices for rows of up to
// max(F, 2D) columns (or dz's tiles' column sums), then their counters
// (ncnt, zeroed once a call)
struct ReduceL {
  size_t part, cs, cnt, ncnt;
};

inline ReduceL reduce_layout(Layout& l, int B, int T, int D, int F, int H) {
  const int N = F > 2 * D ? F : 2 * D;
  ReduceL r;
  r.part = l.f32(tw_part_floats_layer(B, T, D, F, H));
  const size_t tiles = (size_t)(B * T + kTwBM - 1) / kTwBM * F;
  const size_t slices = (size_t)kCsSlices * 2 * N;
  r.cs = l.f32(slices > tiles ? slices : tiles);
  r.ncnt = (N + 31) / 32;
  r.cnt = l.f32(r.ncnt);
  return r;
}

inline Reduce reduce_at(float* G, const ReduceL& r) {
  return {G + r.part, G + r.cs, at<unsigned>(G, r.cnt)};
}

inline cudaError_t reduce_reset(float* G, const ReduceL& r,
                                cudaStream_t st) {
  return cudaMemsetAsync(G + r.cnt, 0, r.ncnt * sizeof(unsigned), st);
}

// The backward scratch's region that the FFN, conv and attention blocks
// take in turn (each block's temporaries from the same base), after the
// persistent arrays. Offsets relative to `base`.
struct BlockTmp {
  size_t base;
  size_t ffn_dzb, ffn_dfb;
  size_t cv_t2, cv_da, cv_dg, cv_t0b, cv_dgb;
  size_t at_t[4], at_dP, at_datt, at_dO, at_dv, at_dS, at_kp, at_dq, at_dk;
};

inline BlockTmp block_tmp(Layout& l, int B, int T, int D, int F, int H) {
  const size_t M = (size_t)B * T, MD = M * D;
  BlockTmp b;
  b.base = l.off;
  Layout f{b.base}, c{b.base}, a{b.base};
  b.ffn_dzb = f.bf16(M * F);
  b.ffn_dfb = f.bf16(MD);
  b.cv_t2 = c.f32(MD);
  b.cv_da = c.f32(MD);
  b.cv_dg = c.f32(2 * MD);
  b.cv_t0b = c.bf16(MD);
  b.cv_dgb = c.bf16(2 * MD);
  for (int i = 0; i < 4; ++i) b.at_t[i] = a.f32(MD);
  b.at_dP = a.f32((size_t)H * B * T * T);
  b.at_datt = a.bf16(MD);
  b.at_dO = a.bf16(MD);
  b.at_dv = a.bf16(MD);
  b.at_dS = a.bf16((size_t)H * B * T * pad8(T));
  b.at_kp = a.bf16(MD);
  b.at_dq = a.bf16(MD);
  b.at_dk = a.bf16(MD);
  l.off = f.off > c.off ? f.off : c.off;
  l.off = a.off > l.off ? a.off : l.off;
  return b;
}

// the backward's block temporaries in scratch G, with the persistent
// f32 arrays t0 (df, datt, the conv's t0) and t1 (a block's input grad)
inline FfnTmp ffn_tmp(float* G, const BlockTmp& b) {
  return {at<bf16_t>(G, b.ffn_dzb), at<bf16_t>(G, b.ffn_dfb)};
}

inline AttTmp att_tmp(float* G, const BlockTmp& b) {
  return {at<bf16_t>(G, b.at_datt), at<bf16_t>(G, b.at_dO),
          at<bf16_t>(G, b.at_dv),   at<bf16_t>(G, b.at_dS),
          at<bf16_t>(G, b.at_kp),   at<bf16_t>(G, b.at_dq),
          at<bf16_t>(G, b.at_dk)};
}

// the five bf16 product weights and posp copied into saved (the layout's
// WeightsBf, 256-byte aligned) by one launch: 16 bytes a thread where an
// array's base is 16-byte aligned and its length a multiple of 8
// elements, else one element a thread
struct WeightCopies {
  const bf16_t* src[6];
  bf16_t* dst[6];
  size_t n[6];   // elements
};

__global__ void copy_weights_kernel(WeightCopies c) {
  const size_t i0 = blockIdx.x * (size_t)blockDim.x + threadIdx.x,
               step = (size_t)gridDim.x * blockDim.x;
  for (int a = 0; a < 6; ++a) {
    if (reinterpret_cast<size_t>(c.src[a]) % 16 == 0 && c.n[a] % 8 == 0) {
      const uint4* s = reinterpret_cast<const uint4*>(c.src[a]);
      uint4* d = reinterpret_cast<uint4*>(c.dst[a]);
      for (size_t i = i0; i < c.n[a] / 8; i += step) d[i] = s[i];
    } else {
      for (size_t i = i0; i < c.n[a]; i += step) c.dst[a][i] = c.src[a][i];
    }
  }
}

cudaError_t save_weights_bf(float* S, const WeightsBf& w, const bf16_t* ffw1,
                            const bf16_t* ffw2, const bf16_t* attw,
                            const bf16_t* pw1w, const bf16_t* pw2w,
                            const bf16_t* posp, int T, int D, int F,
                            cudaStream_t st) {
  const size_t DF = (size_t)D * F, DD = (size_t)D * D;
  const bf16_t* src[6] = {ffw1, ffw2, attw, pw1w, pw2w, posp};
  const size_t off[6] = {w.ffw1, w.ffw2, w.attw, w.pw1w, w.pw2w, w.posp};
  const size_t n[6] = {2 * DF, 2 * DF, 4 * DD, 2 * DD, DD, (size_t)T * D};
  WeightCopies c;
  for (int a = 0; a < 6; ++a) {
    c.src[a] = src[a];
    c.dst[a] = at<bf16_t>(S, off[a]);
    c.n[a] = n[a];
  }
  copy_weights_kernel<<<blocks_for(c.n[0] / 8 + 1, 256), 256, 0, st>>>(c);
  return cudaGetLastError();
}

}  // namespace
