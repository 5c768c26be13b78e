// Building blocks shared by the port's kernels (conformer_layer.cu,
// chunk_layer.cu, squeezeformer_layer.cu, chunk_layer_sq.cu and, through
// training.cuh, conformer_layer_train.cu and squeezeformer_layer_train.cu;
// ctc_loss.cu takes the warp reductions), for Hopper (sm_90a), f32 (and
// the bf16 pieces of the serving rows' bf16 mode):
//
//   warp_sum, warp_max     warp reductions
//   dropout_mult           the counter-based dropout hash of the training
//                          kernel (mirrored by ops/dropout_hash.py)
//   layer_norm_kernel      one warp per row, f32 statistics, optional
//                          zeroing of rows t >= len, optional saved x-hat
//                          and 1/std for a backward
//   split_tf32, mma_3xtf32, cp_async*  tensor-core and async-copy pieces:
//                          3xTF32 products (f32 accuracy on the TF32 tensor
//                          cores) and cp.async copies with zero fill; with
//                          the epilogue functor ServeEpi (plain, SiLU,
//                          scaled residual, row-masked residual) they make
//                          serving.cuh's gemm_sk, the serving layers'
//                          products (rows 1, 2, 6 and 8 of PERF.md's kernel
//                          table), and flash_attention.cuh's flash kernel
//   gemm_tc_kernel<.., TA, TB, E>  C = E(op(A).op(B)) on the tensor
//                          cores (a 3-stage cp.async ring of f32 tiles,
//                          3xTF32 mma.sync), either operand transposed,
//                          batched, with a compile-time epilogue functor
//                          E: every product of the f32 training layers
//                          (rows 3 and 7, through training.cuh)
//   conv_module_kernel<kLN, ROWS>  GLU -> depthwise conv over time -> LN
//                          (or a folded BatchNorm affine) -> SiLU, optional
//                          saves for a backward
//   ada_rows_kernel        the Squeezeformer conv module's masked adaptive
//                          scale
//   bf16 pieces            the bf16 operand mode of the serving rows 1, 2
//                          and 5 (masr_tpu's compute dtype bf16): bf16 in
//                          memory as raw 16-bit words (`bf16_t`), mma_bf16
//                          (mma.sync m16n8k16 bf16 x bf16 + f32),
//                          operands rounded to nearest even where they
//                          enter a product, convert_kernel between f32 and
//                          bf16 rows
//
// Each GEMM sums over K in the same order (k = 0, 1, ...) whatever tile it
// picks, so a row's result does not depend on how many rows share the
// call: one stream and a batch of slots give the same bits (serving.cuh's
// gemm_sk splits K by a plan fixed by N and K, to the same end).
//
// Every launcher returns cudaGetLastError() (0 on success).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float silu_f(float v) { return v * sigmoid_f(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ------------------------------------------------------------------------
// Counter-based dropout. The keep decision of element (row, col) of
// dropout site `site` (0..15) of utterance b (< 65536) in layer `layer`
// (< 4096) is a pure function of those and the utterance's seed, so a
// forward kernel, its backward and the plain PyTorch twin
// (masr_tpu_torch/ops/dropout_hash.py, 16-bit limbs) draw the same mask.
// mix32 is the "lowbias32" integer finaliser.
// ------------------------------------------------------------------------
__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// keep if hash >= thresh (= rate * 2^32); kept elements scale by
// keep_scale = 1 / (1 - rate), both computed by the caller. The hash of a
// row (dropout_row_hash) can be taken once for all its columns.
__device__ __forceinline__ unsigned dropout_row_hash(int seed, int layer,
                                                     int site, int b,
                                                     int row) {
  const unsigned h = mix32((unsigned)seed ^
                           mix32(((unsigned)layer << 20) |
                                 ((unsigned)site << 16) | (unsigned)b));
  return mix32(h ^ (unsigned)row);
}

__device__ __forceinline__ float dropout_col(unsigned row_hash, int col,
                                             unsigned thresh,
                                             float keep_scale) {
  return mix32(row_hash ^ (unsigned)col) >= thresh ? keep_scale : 0.f;
}

__device__ __forceinline__ float dropout_mult(int seed, int layer, int site,
                                              int b, int row, int col,
                                              unsigned thresh,
                                              float keep_scale) {
  return dropout_col(dropout_row_hash(seed, layer, site, b, row), col,
                     thresh, keep_scale);
}

// ------------------------------------------------------------------------
// bf16 operands (the serving rows' bf16 mode). A bf16 value in memory is
// its raw 16-bit word (bf16_t); f32 -> bf16 rounds to nearest even, as
// torch's .to(torch.bfloat16) and XLA's astype do, so a kernel rounds an
// operand where masr_tpu's Pallas kernel casts it to the compute dtype.
// mma_bf16 is one mma.sync m16n8k16 bf16 product with f32 accumulation;
// fragments (g = lane / 4, t = lane % 4), each 32-bit register two bf16,
// the lower k in the low half: A (16 x 16, row major) a0 (g, 2t..2t+1),
// a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); B (16 x 8,
// k x n) b0 (2t..2t+1, g), b1 (2t + 8.., g); C as m16n8k8's.
// ------------------------------------------------------------------------
typedef unsigned short bf16_t;

template <class T>
constexpr bool is_bf16 = std::is_same<T, bf16_t>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16_t x) {
  return __uint_as_float((unsigned)x << 16);
}

__device__ __forceinline__ bf16_t bf16_rn(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// store v as T: f32 as it is, bf16 rounded to nearest even
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16_t* p, float v) {
  *p = bf16_rn(v);
}

// ------------------------------------------------------------------------
// LayerNorm over the last dim, one warp per row. With `lens` set, rows
// whose time index t = row % T is >= lens[row / T] are written as zeros.
// For a backward, xhat = (x - mean) / std and rstd = 1 / std are saved
// when given (zeros in the zeroed rows). Y: the output's type (float, or
// bf16_t rounded to nearest even); y nullptr: statistics only.
// ------------------------------------------------------------------------
template <class Y>
__global__ void layer_norm_kernel(const float* __restrict__ x,
                                  Y* __restrict__ y,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta, int M, int D,
                                  float eps, const int* __restrict__ lens,
                                  int T, float* __restrict__ xhat,
                                  float* __restrict__ rstd) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  Y* yr = y ? y + (size_t)row * D : nullptr;
  float* hr = xhat ? xhat + (size_t)row * D : nullptr;
  if (lens != nullptr && (row % T) >= lens[row / T]) {
    for (int c = lane; c < D; c += 32) {
      if (yr) store_as(yr + c, 0.f);
      if (hr) hr[c] = 0.f;
    }
    if (rstd && lane == 0) rstd[row] = 0.f;
    return;
  }
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += xr[c];
  const float mu = warp_sum(s) / D;
  float s2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = xr[c] - mu;
    s2 += d * d;
  }
  const float r = rsqrtf(warp_sum(s2) / D + eps);
  if (rstd && lane == 0) rstd[row] = r;
  for (int c = lane; c < D; c += 32) {
    const float h = (xr[c] - mu) * r;
    if (hr) hr[c] = h;
    if (yr) store_as(yr + c, h * gamma[c] + beta[c]);
  }
}

// ------------------------------------------------------------------------
// Batched products: matrix z of a batch (blockIdx.z) starts (z / div) s1 +
// (z % div) s2 floats into its array.
// ------------------------------------------------------------------------
struct Batch {
  long long s1 = 0, s2 = 0;
  int div = 1;
};

__device__ __forceinline__ long long batch_off(const Batch& b, int z) {
  return (long long)(z / b.div) * b.s1 + (long long)(z % b.div) * b.s2;
}

// ------------------------------------------------------------------------
// 3xTF32 on the tensor cores. An f32 x splits into big = tf32(x) and small
// = tf32(x - big) (round to nearest, away from zero on ties, as cvt.rna);
// a.b ~ small_a.big_b + big_a.small_b + big_a.big_b, each an mma.sync
// m16n8k8 TF32 product with f32 accumulation. The dropped small.small term
// and the rounding of the small halves leave about f32's error (the plain
// twin masr_tpu_torch/ops/cuda/tf32.py and tests/test_torch_tf32.py
// measure it); one TF32 product alone keeps ~3 decimal digits.
//
// m16n8k8 fragments (g = lane / 4, t = lane % 4): A (16 x 8, row major)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8,
// k x n) b0 (t, g), b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1),
// c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// ------------------------------------------------------------------------
__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: (ab, as) the A fragment's big and small halves,
// (bb, bs) the B fragment's; the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ab)[4],
                                           const unsigned (&as)[4],
                                           const unsigned (&bb)[2],
                                           const unsigned (&bs)[2]) {
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

// 8 bf16 at a 16-byte-aligned p → 8 f32 (exact), element 0 first
__device__ __forceinline__ void bf16x8_to_f32(const bf16_t* p, float4& lo,
                                              float4& hi) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  lo = make_float4(__uint_as_float(u.x << 16),
                   __uint_as_float(u.x & 0xffff0000u),
                   __uint_as_float(u.y << 16),
                   __uint_as_float(u.y & 0xffff0000u));
  hi = make_float4(__uint_as_float(u.z << 16),
                   __uint_as_float(u.z & 0xffff0000u),
                   __uint_as_float(u.w << 16),
                   __uint_as_float(u.w & 0xffff0000u));
}

// two f32 rounded to bf16, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)bf16_rn(lo) | ((unsigned)bf16_rn(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[i] = in[i] as TO, n elements (f32 <-> bf16 rows at a bf16 layer's
// entry and exit)
template <class TI, class TO>
__global__ void convert_kernel(const TI* __restrict__ in,
                               TO* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    store_as(out + i, to_f32(in[i]));
}

template <class TI, class TO>
cudaError_t convert(const TI* in, TO* out, long long n, cudaStream_t stream) {
  if (n <= 0) return cudaGetLastError();
  const long long blocks = (n + 255) / 256;
  convert_kernel<TI, TO><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                           stream>>>(in, out, n);
  return cudaGetLastError();
}

// x[i] rounded to bf16 in place, kept as f32 (the bf16 training mode's
// activations that masr_tpu's kernel stores in the compute dtype)
__global__ void round_bf16_kernel(float* __restrict__ x, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    x[i] = to_f32(bf16_rn(x[i]));
}

cudaError_t round_bf16(float* x, long long n, cudaStream_t stream) {
  if (n <= 0) return cudaGetLastError();
  const long long blocks = (n + 255) / 256;
  round_bf16_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      x, n);
  return cudaGetLastError();
}

// cp.async: copy `bytes` (<= the copy's size) from global memory and fill
// the rest of the 16 (or 4) bytes of shared memory with zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major
// matrix g (leading dimension ld; rows < rmax, columns < cmax exist) into
// shared memory rows of SS floats, zeros outside. vec: 16-byte copies (g,
// ld and c0 multiples of 4 floats), else 4-byte ones. NT threads.
template <int ROWS, int COLS, int SS, int NT>
__device__ __forceinline__ void load_tile_async(float* s, const float* g,
                                                long long ld, int r0,
                                                int rmax, int c0, int cmax,
                                                bool vec, int tid) {
  constexpr int CH = COLS / 4;
  static_assert(COLS % 4 == 0 && (ROWS * CH) % NT == 0, "tile vs threads");
  if (vec) {
#pragma unroll
    for (int it = 0; it < ROWS * CH / NT; ++it) {
      const int i = tid + it * NT;
      const int r = i / CH, c = (i % CH) * 4, gr = r0 + r, gc = c0 + c;
      const int n = gr < rmax ? min(max(cmax - gc, 0), 4) : 0;
      cp_async16(s + r * SS + c, n > 0 ? g + gr * ld + gc : g, 4 * n);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < ROWS * COLS / NT; ++it) {
      const int i = tid + it * NT;
      const int r = i / COLS, c = i % COLS, gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rmax && gc < cmax;
      cp_async4(s + r * SS + c, ok ? g + gr * ld + gc : g, ok ? 4 : 0);
    }
  }
}

// The tile of load_tile_async from an array of T: f32 through
// load_tile_async; bf16 read by plain loads and widened to f32 in shared
// memory (exact), zeros outside: 16-byte loads of 8 values where vec (g,
// ld and c0 multiples of 8 values; shared rows of SS floats, SS a
// multiple of 4), else one value a load. The bf16 path stores
// synchronously: the caller's __syncthreads (or __syncwarp) before the
// tile's use orders it.
template <int ROWS, int COLS, int SS, int NT, class T>
__device__ __forceinline__ void load_tile_as_f32(float* s, const T* g,
                                                 long long ld, int r0,
                                                 int rmax, int c0, int cmax,
                                                 bool vec, int tid) {
  if constexpr (!is_bf16<T>) {
    load_tile_async<ROWS, COLS, SS, NT>(s, g, ld, r0, rmax, c0, cmax, vec,
                                         tid);
  } else if (vec && COLS % 8 == 0) {
    constexpr int CH = COLS / 8;
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8, gr = r0 + r, gc = c0 + c;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (gr < rmax && gc + 8 <= cmax) {
        bf16x8_to_f32(g + gr * ld + gc, lo, hi);
      } else if (gr < rmax) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = gc + e < cmax ? to_f32(g[gr * ld + gc + e]) : 0.f;
        lo = make_float4(v[0], v[1], v[2], v[3]);
        hi = make_float4(v[4], v[5], v[6], v[7]);
      }
      *reinterpret_cast<float4*>(s + r * SS + c) = lo;
      *reinterpret_cast<float4*>(s + r * SS + c + 4) = hi;
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS, gr = r0 + r, gc = c0 + c;
      s[r * SS + c] =
          gr < rmax && gc < cmax ? to_f32(g[gr * ld + gc]) : 0.f;
    }
  }
}

// Copy rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major bf16
// matrix g (leading dimension ld; rows < rmax, columns < cmax exist) into
// shared memory rows of SS bf16, zeros outside. vec: 16-byte cp.async
// copies of 8 values (g, ld and c0 multiples of 8 values), else plain
// loads. NT threads.
template <int ROWS, int COLS, int SS, int NT>
__device__ __forceinline__ void load_tile_bf16(bf16_t* s, const bf16_t* g,
                                               long long ld, int r0,
                                               int rmax, int c0, int cmax,
                                               bool vec, int tid) {
  static_assert(COLS % 8 == 0 && SS % 8 == 0, "16-byte rows");
  if (vec) {
    constexpr int CH = COLS / 8;
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8, gr = r0 + r, gc = c0 + c;
      const int n = gr < rmax ? min(max(cmax - gc, 0), 8) : 0;
      const unsigned d = (unsigned)__cvta_generic_to_shared(s + r * SS + c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                   "l"(n > 0 ? g + gr * ld + gc : g), "r"(2 * n));
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS, gr = r0 + r, gc = c0 + c;
      s[r * SS + c] = gr < rmax && gc < cmax ? g[gr * ld + gc] : (bf16_t)0;
    }
  }
}

// ------------------------------------------------------------------------
// gemm_tc_kernel: C = E(op(A) (M, K) . op(B) (K, N)), row-major f32,
// optionally batched (Batch): op(A)(m, k) = TA ? A[k lda + m] : A[m lda +
// k], op(B)(k, n) = TB ? B[n ldb + k] : B[k ldb + n]. The epilogue is a
// compile-time functor E: r = e.row(m) once per output row, then e(C, o,
// r, n, acc) stores element (m, n) at C[o], o counted from C's start (batch
// offset included), so arrays laid out like C share it; an epilogue may
// read R = C (in-place residual update: each element is read and written
// by the same thread). Ragged edges are zero-filled on load and masked on
// store. BM x BN block tile of
// (BM / WM) x (BN / WN) warps, each a WM x WN warp tile of m16n8k8 3xTF32
// products, f32 accumulators in registers; BK = 32 deep through a 3-stage
// cp.async ring. Tiles sit in shared memory as they sit in device memory
// (so the copies are contiguous), rows padded by 4 floats where k runs
// along the row and by 8 where it runs down the column: either way a
// fragment read hits 32 distinct banks. Operands split into big and small
// halves as fragments are read. va / vb: 16-byte copies for A / B (base,
// leading dimension and batch strides multiples of 4 floats), else 4-byte
// ones (e.g. the attention scores' rows of T' = 299 floats). The
// epilogue goes through shared memory so that its stores are coalesced.
// What bounds it on the H100 at the training layers' shapes (K = 64 to
// 2392, grids of 150-600 blocks): not the tensor cores (a third of TF32's
// 495 TFLOP/s for 3xTF32) but the issue and latency of each warp's
// fragment reads, splits and copies, and of the per-element epilogue
// (SiLU, the dropout hash), with 4 warps a block and 1-3 blocks an SM;
// taking the products out of a clock64-timed copy changed its loop time
// little. (The bf16 mode's products are train_wgmma.cuh's: TMA and
// wgmma on bf16 tiles.)
// ------------------------------------------------------------------------
constexpr int kTcBK = 32, kTcStages = 3;

template <int BM, int BN, bool TA, bool TB>
struct TcTile {
  static constexpr int SA = TA ? BM + 8 : kTcBK + 4;  // A row stride
  static constexpr int SB = TB ? kTcBK + 4 : BN + 8;  // B row stride
  static constexpr int A_FLOATS = TA ? kTcBK * SA : BM * SA;
  static constexpr int B_FLOATS = TB ? BN * SB : kTcBK * SB;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr size_t SMEM = sizeof(float) * kTcStages * STAGE;
};

template <int BM, int BN, int WM, int WN, bool TA, bool TB, class E>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
    gemm_tc_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                   float* C, int M, int N, int K, int lda, int ldb, int ldc,
                   Batch ba, Batch bb, Batch bc, E e, bool va, bool vb) {
  using L = TcTile<BM, BN, TA, TB>;
  constexpr int WX = BN / WN, NT = (BM / WM) * WX * 32;
  constexpr int MT = WM / 16, NT8 = WN / 8;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / WX) * WM, wn = (warp % WX) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  A += batch_off(ba, z);
  Bm += batch_off(bb, z);
  const size_t co = (size_t)batch_off(bc, z);

  auto load = [&](int stage, int k0) {
    float* as = smem + stage * L::STAGE;
    float* bs = as + L::A_FLOATS;
    if (TA)   // A stored (K, M): rows k, columns m
      load_tile_async<kTcBK, BM, L::SA, NT>(as, A, lda, k0, K, m0, M, va,
                                             tid);
    else
      load_tile_async<BM, kTcBK, L::SA, NT>(as, A, lda, m0, M, k0, K, va,
                                             tid);
    if (TB)   // B stored (N, K): rows n, columns k
      load_tile_async<BN, kTcBK, L::SB, NT>(bs, Bm, ldb, n0, N, k0, K, vb,
                                             tid);
    else
      load_tile_async<kTcBK, BN, L::SB, NT>(bs, Bm, ldb, k0, K, n0, N, vb,
                                             tid);
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int KT = (K + kTcBK - 1) / kTcBK;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < KT) load(s, s * kTcBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();   // tile kt landed; the stage reloaded below is spent
    const int next = kt + kTcStages - 1;
    if (next < KT) load(next % kTcStages, next * kTcBK);
    cp_async_commit();
    const float* as = smem + (kt % kTcStages) * L::STAGE;
    const float* bs = as + L::A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 8) {
      unsigned ab[MT][4], asm_[MT][4], bb[NT8][2], bsm[NT8][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + i * 16 + g;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rr = r + (q & 1) * 8, kc = kk + t + (q >> 1) * 4;
          split_tf32(TA ? as[kc * L::SA + rr] : as[rr * L::SA + kc],
                     ab[i][q], asm_[i][q]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int c = wn + j * 8 + g;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kr = kk + t + q * 4;
          split_tf32(TB ? bs[c * L::SB + kr] : bs[kr * L::SB + c], bb[j][q],
                     bsm[j][q]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT8; ++j)
          mma_3xtf32(acc[i][j], ab[i], asm_[i], bb[j], bsm[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring

  // Epilogue through shared memory: the accumulators go to a BM x BN tile
  // (rows of BN + 8 floats: the float2 writes hit distinct banks), then
  // each warp takes whole rows, its lanes consecutive columns, so the
  // stores are coalesced and e.row runs once per row.
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
  for (int rr = warp; rr < BM; rr += NW) {
    const int m = m0 + rr;
    if (m >= M) break;
    const auto r = e.row(m);
#pragma unroll
    for (int c = lane; c < BN; c += 32) {
      const int n = n0 + c;
      if (n < N) e(C, co + (size_t)m * ldc + n, r, n, ct[rr * SC + c]);
    }
  }
}

inline bool on16(const float* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

// 16-byte copies of an operand: its base, leading dimension and batch
// strides all multiples of 4 floats
inline bool aligned16(const float* p, int ld, const Batch& b) {
  return on16(p) && ld % 4 == 0 && b.s1 % 4 == 0 && b.s2 % 4 == 0;
}

template <int BM, int BN, int WM, int WN, bool TA, bool TB, class E>
cudaError_t gemm_tc_run(const float* A, const float* B, float* C, int M,
                        int N, int K, int lda, int ldb, int ldc, const E& e,
                        cudaStream_t stream, int batch, Batch ba, Batch bb,
                        Batch bc) {
  auto kernel = gemm_tc_kernel<BM, BN, WM, WN, TA, TB, E>;
  const size_t smem = TcTile<BM, BN, TA, TB>::SMEM;
  static bool sized = false;   // one attribute call per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  kernel<<<grid, (BM / WM) * (BN / WN) * 32, smem, stream>>>(
      A, B, C, M, N, K, lda, ldb, ldc, ba, bb, bc, e, aligned16(A, lda, ba),
      aligned16(B, ldb, bb));
  return cudaGetLastError();
}

// The training layers' products on the tensor cores: 64 x 128 tiles (4 warps of
// 32 x 64) where N > 64 and they fill the 132 SMs, 64 x 64 (4 warps of
// 32 x 32) otherwise. (On the H100, at the training layer's shapes, 64 x 128 beat
// 128 x 128 with 8 warps of 64 x 32 or 4 of 64 x 64, and 128 x 64.)
template <bool TA, bool TB, class E>
cudaError_t gemm_tc_launch(const float* A, const float* B, float* C, int M,
                           int N, int K, int lda, int ldb, int ldc,
                           const E& e, cudaStream_t stream, int batch = 1,
                           Batch ba = Batch(), Batch bb = Batch(),
                           Batch bc = Batch()) {
  if (M <= 0 || N <= 0 || batch <= 0) return cudaGetLastError();
  const long big_tiles = (long)((M + 63) / 64) * ((N + 127) / 128) * batch;
  if (N > 64 && big_tiles >= 132)
    return gemm_tc_run<64, 128, 32, 64, TA, TB>(A, B, C, M, N, K, lda,
                                                    ldb, ldc, e, stream, batch,
                                                    ba, bb, bc);
  return gemm_tc_run<64, 64, 32, 32, TA, TB>(A, B, C, M, N, K, lda, ldb,
                                                 ldc, e, stream, batch, ba, bb,
                                                 bc);
}

// The serving kernels' epilogues on v = acc + bias[n]: plain, SiLU, scaled
// residual R + scale v, and the residual with rows t = m % T >= lens[m / T]
// adding nothing.
enum Epilogue { kBias = 0, kSilu = 1, kResidual = 2, kRowMaskResidual = 3 };

template <int EPI>
struct ServeEpi {
  const float* bias;
  const float* R;
  float scale;
  const int* lens;
  int T;
  __device__ __forceinline__ bool row(int m) const {
    return EPI != kRowMaskResidual || (m % T) < lens[m / T];
  }
  __device__ __forceinline__ void operator()(float* C, size_t o, bool row_ok,
                                             int n, float acc) const {
    const float v = acc + bias[n];
    if (EPI == kBias) C[o] = v;
    if (EPI == kSilu) C[o] = silu_f(v);
    if (EPI == kResidual) C[o] = R[o] + scale * v;
    if (EPI == kRowMaskResidual) C[o] = R[o] + (row_ok ? v : 0.f);
  }
};

// ------------------------------------------------------------------------
// Conv module middle: g (B, T_in, 2D) = pw1 output ->
//   u = GLU(g) -> depthwise conv over time (+ bias) -> norm -> SiLU ->
//   y (B, T_out, D), where output row t reads u rows t - left .. t - left
//   + k - 1. The norm is a compile-time choice: LN (kLN, gamma/beta its
//   scale and shift) or the per-channel affine gamma * v + beta that a
//   BatchNorm folds to in serving. One block per (ROWS output rows,
//   utterance): 16, or 4 for the chunk steps (rows 2 and 8), whose 16 rows
//   a slot would give one block. The block stages the (ROWS + k - 1) rows
//   of u it needs in smem; out-of-range rows are the conv padding: GLU(pw1
//   bias) before row 0 when `pad_bias`, zeros otherwise. For a backward
//   the LN's output before SiLU (`pre`), its x-hat and 1/std are saved
//   when given.
// ------------------------------------------------------------------------
constexpr int kConvRows = 16;
constexpr int kConvThreads = 256;

template <bool kLN, int ROWS = kConvRows, class Y = float>
__global__ void __launch_bounds__(kConvThreads)
    conv_module_kernel(const float* __restrict__ g,
                       const float* __restrict__ dww,
                       const float* __restrict__ dwb,
                       const float* __restrict__ pw1b,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, Y* __restrict__ y,
                       int T_in, int T_out, int D, int ksize, int left,
                       int pad_bias, float eps, float* __restrict__ pre,
                       float* __restrict__ xhat, float* __restrict__ rstd) {
  extern __shared__ float smem[];
  const int W = ROWS + ksize - 1;
  float* us = smem;              // W x D
  float* cs = us + W * D;        // ROWS x D
  const int b = blockIdx.y, t0 = blockIdx.x * ROWS;

  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int r = i / D, c = i % D, t = t0 - left + r;
    float val = 0.f;
    if (t >= 0 && t < T_in) {
      const float* gr = g + ((size_t)b * T_in + t) * 2 * D;
      val = gr[c] * sigmoid_f(gr[D + c]);
    } else if (pad_bias && t < 0) {
      val = pw1b[c] * sigmoid_f(pw1b[D + c]);
    }
    us[i] = val;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    float acc = 0.f;
    for (int j = 0; j < ksize; ++j)
      acc = fmaf(us[(r + j) * D + c], dww[j * D + c], acc);
    cs[i] = acc + dwb[c];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += blockDim.x / 32) {
    const int t = t0 + r;
    if (t >= T_out) continue;
    const float* xr = cs + r * D;
    const size_t row = (size_t)b * T_out + t, o = row * D;
    if constexpr (kLN) {
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s += xr[c];
      const float mu = warp_sum(s) / D;
      float s2 = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float d = xr[c] - mu;
        s2 += d * d;
      }
      const float rs = rsqrtf(warp_sum(s2) / D + eps);
      if (rstd && lane == 0) rstd[row] = rs;
      for (int c = lane; c < D; c += 32) {
        const float h = (xr[c] - mu) * rs, v = h * gamma[c] + beta[c];
        if (xhat) xhat[o + c] = h;
        if (pre) pre[o + c] = v;
        store_as(y + o + c, silu_f(v));
      }
    } else {
      for (int c = lane; c < D; c += 32)
        store_as(y + o + c, silu_f(xr[c] * gamma[c] + beta[c]));
    }
  }
}

// norm: (2, D) scale and shift, of the LN (use_ln) or of the folded
// per-channel affine (!use_ln); pre, xhat, rstd: optional saves for a
// backward of the LN variant (nullptr: not saved); rows: output rows per
// block, kConvRows or kConvRowsChunk (the same bits either way); y: f32,
// or bf16 rounded to nearest even
constexpr int kConvRowsChunk = 4;

template <class Y>
cudaError_t conv_module(const float* g, const float* dww, const float* dwb,
                        const float* pw1b, const float* norm, Y* y, int B,
                        int T_in, int T_out, int D, int ksize, int left,
                        int pad_bias, float eps, cudaStream_t stream,
                        float* pre = nullptr, float* xhat = nullptr,
                        float* rstd = nullptr, bool use_ln = true,
                        int rows = kConvRows) {
  const bool chunk = rows == kConvRowsChunk;
  if (!chunk) rows = kConvRows;
  const size_t smem = sizeof(float) * (size_t)(2 * rows + ksize - 1) * D;
  auto kernel =
      use_ln ? (chunk ? conv_module_kernel<true, kConvRowsChunk, Y>
                      : conv_module_kernel<true, kConvRows, Y>)
             : (chunk ? conv_module_kernel<false, kConvRowsChunk, Y>
                      : conv_module_kernel<false, kConvRows, Y>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_out + rows - 1) / rows, B);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      g, dww, dwb, pw1b, norm, norm + D, y, T_in, T_out, D, ksize, left,
      pad_bias, eps, pre, xhat, rstd);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// The Squeezeformer conv module's adaptive scale: y (M, D) = x * ada[0] +
// ada[1] in rows t = row % T < lens[row / T], 0 in the rows past an
// utterance's length (its padded rows enter pw1 as zeros). lens nullptr:
// every row (the bf16 mode's adaptive scales of the attention and the FFNs,
// which the f32 mode folds into their weights). Y: y's type (float, or
// bf16_t rounded to nearest even).
// ------------------------------------------------------------------------
template <class Y>
__global__ void ada_rows_kernel(const float* __restrict__ x,
                                Y* __restrict__ y,
                                const float* __restrict__ ada,
                                const int* __restrict__ lens, int T, int D,
                                long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / D;
    const int c = (int)(i % D);
    store_as(y + i, lens == nullptr || (row % T) < lens[row / T]
                        ? x[i] * ada[c] + ada[D + c]
                        : 0.f);
  }
}

template <class Y>
cudaError_t ada_rows(const float* x, Y* y, const float* ada,
                     const int* lens, int T, int D, long long n,
                     cudaStream_t stream) {
  ada_rows_kernel<Y><<<(int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096),
                    256, 0, stream>>>(x, y, ada, lens, T, D, n);
  return cudaGetLastError();
}

// LayerNorm idx of the packed (6, 2, D) scales and shifts into y (f32, or
// bf16 rounded to nearest even; nullptr: not written); xhat, rstd:
// optional saves for a backward
template <class Y>
cudaError_t layer_norm(const float* x, Y* y, const float* lnw, int idx,
                       int M, int D, float eps, const int* lens, int T,
                       cudaStream_t stream, float* xhat = nullptr,
                       float* rstd = nullptr) {
  const int rows_per_block = 8;
  const float* gamma = lnw + (size_t)idx * 2 * D;
  layer_norm_kernel<Y><<<(M + rows_per_block - 1) / rows_per_block,
                      rows_per_block * 32, 0, stream>>>(
      x, y, gamma, gamma + D, M, D, eps, lens, T, xhat, rstd);
  return cudaGetLastError();
}

}  // namespace

#define MASR_CHECK(call)                  \
  do {                                    \
    cudaError_t e_ = (call);              \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
