// Building blocks shared by the port's kernels (conformer_layer.cu,
// chunk_layer.cu, squeezeformer_layer.cu, chunk_layer_sq.cu and, through
// training.cuh, conformer_layer_train.cu and squeezeformer_layer_train.cu;
// ctc_loss.cu takes the warp reductions), for Hopper (sm_90a), f32:
//
//   warp_sum, warp_max     warp reductions
//   dropout_mult           the counter-based dropout hash of the training
//                          kernel (mirrored by ops/dropout_hash.py)
//   layer_norm_kernel      one warp per row, f32 statistics, optional
//                          zeroing of rows t >= len, optional saved x-hat
//                          and 1/std for a backward
//   gemm_kernel<.., TA, TB, E>  C = E(op(A).op(B)), shared-memory tiled
//                          f32 FMA main loop, either operand transposed,
//                          batched, with a compile-time epilogue functor E
//                          (the serving kernels' ServeEpi: plain, SiLU,
//                          scaled residual, row-masked residual; the
//                          training kernel's own)
//   conv_module_kernel<kLN>  GLU -> depthwise conv over time -> LN (or a
//                          folded BatchNorm affine) -> SiLU, optional saves
//                          for a backward
//   ada_rows_kernel        the Squeezeformer conv module's masked adaptive
//                          scale
//
// The GEMM sums over K in the same order (k = 0, 1, ...) whatever tile it
// picks, so a row's result does not depend on how many rows share the
// call: one stream and a batch of slots give the same bits.
//
// Every launcher returns cudaGetLastError() (0 on success).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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
// keep_scale = 1 / (1 - rate), both computed by the caller
__device__ __forceinline__ float dropout_mult(int seed, int layer, int site,
                                              int b, int row, int col,
                                              unsigned thresh,
                                              float keep_scale) {
  unsigned h = mix32((unsigned)seed ^
                     mix32(((unsigned)layer << 20) | ((unsigned)site << 16) |
                           (unsigned)b));
  h = mix32(h ^ (unsigned)row);
  h = mix32(h ^ (unsigned)col);
  return h >= thresh ? keep_scale : 0.f;
}

// ------------------------------------------------------------------------
// LayerNorm over the last dim, one warp per row. With `lens` set, rows
// whose time index t = row % T is >= lens[row / T] are written as zeros.
// For a backward, xhat = (x - mean) / std and rstd = 1 / std are saved
// when given (zeros in the zeroed rows).
// ------------------------------------------------------------------------
__global__ void layer_norm_kernel(const float* __restrict__ x,
                                  float* __restrict__ y,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta, int M, int D,
                                  float eps, const int* __restrict__ lens,
                                  int T, float* __restrict__ xhat,
                                  float* __restrict__ rstd) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  float* yr = y + (size_t)row * D;
  float* hr = xhat ? xhat + (size_t)row * D : nullptr;
  if (lens != nullptr && (row % T) >= lens[row / T]) {
    for (int c = lane; c < D; c += 32) {
      yr[c] = 0.f;
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
    yr[c] = h * gamma[c] + beta[c];
  }
}

// ------------------------------------------------------------------------
// C = epi(op(A) (M, K) . op(B) (K, N)), row-major f32, optionally batched:
// op(A)(m, k) = TA ? A[k lda + m] : A[m lda + k], op(B)(k, n) = TB ?
// B[n ldb + k] : B[k ldb + n]; matrix z of a batch (blockIdx.z) starts
// (z / div) s1 + (z % div) s2 floats into its array. BM x BN block tile,
// BK = 8 deep, each thread a TM x TN micro-tile whose rows/cols are
// strided by the thread grid (conflict-free smem reads, coalesced stores).
// Ragged edges are zero-filled on load, masked on store.
//
// The epilogue is a compile-time functor E: r = e.row(m) once per output
// row, then e(C, o, r, n, acc) stores element (m, n) at C[o], o counted
// from C's start (batch offset included), so arrays laid out like C share
// it. An epilogue may read R = C (in-place residual update): each element
// is read and written by the same thread.
// ------------------------------------------------------------------------
struct Batch {
  long long s1 = 0, s2 = 0;
  int div = 1;
};

__device__ __forceinline__ long long batch_off(const Batch& b, int z) {
  return (long long)(z / b.div) * b.s1 + (long long)(z % b.div) * b.s2;
}

template <int BM, int BN, int TM, int TN, bool TA, bool TB, class E>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    gemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                float* C, int M, int N, int K, int lda, int ldb, int ldc,
                Batch ba, Batch bb, Batch bc, E e) {
  constexpr int BK = 8;
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + (TB ? 4 : 0)];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  A += batch_off(ba, z);
  Bm += batch_off(bb, z);
  const size_t co = (size_t)batch_off(bc, z);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = TA ? i % BM : i / BK, c = TA ? i / BM : i % BK;
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.f;
      if (gm < M && gk < K)
        v = TA ? A[(size_t)gk * lda + gm] : A[(size_t)gm * lda + gk];
      As[c][r] = v;
    }
#pragma unroll
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = TB ? i % BK : i / BN, c = TB ? i / BK : i % BN;
      const int gk = k0 + r, gn = n0 + c;
      float v = 0.f;
      if (gk < K && gn < N)
        v = TB ? Bm[(size_t)gn * ldb + gk] : Bm[(size_t)gk * ldb + gn];
      Bs[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= M) continue;
    const auto r = e.row(m);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= N) continue;
      e(C, co + (size_t)m * ldc + n, r, n, acc[i][j]);
    }
  }
}

template <bool TA, bool TB, class E>
cudaError_t gemm_launch(const float* A, const float* B, float* C, int M,
                        int N, int K, int lda, int ldb, int ldc, const E& e,
                        cudaStream_t stream, int batch = 1,
                        Batch ba = Batch(), Batch bb = Batch(),
                        Batch bc = Batch()) {
  if (M <= 0 || N <= 0 || batch <= 0) return cudaGetLastError();
  // big tiles once they fill the 132 SMs, small ones otherwise
  const long big_tiles = (long)((M + 127) / 128) * ((N + 127) / 128) * batch;
  if (big_tiles >= 132) {
    dim3 grid((N + 127) / 128, (M + 127) / 128, batch);
    gemm_kernel<128, 128, 8, 8, TA, TB, E><<<grid, 256, 0, stream>>>(
        A, B, C, M, N, K, lda, ldb, ldc, ba, bb, bc, e);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64, batch);
    gemm_kernel<64, 64, 4, 4, TA, TB, E><<<grid, 256, 0, stream>>>(
        A, B, C, M, N, K, lda, ldb, ldc, ba, bb, bc, e);
  }
  return cudaGetLastError();
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

// C (M, N) = epilogue(A (M, K) . W (K, N) + bias (N))
template <int EPI>
cudaError_t gemm(const float* A, const float* W, const float* bias, float* C,
                 const float* R, int M, int N, int K, float scale,
                 const int* lens, int T, cudaStream_t stream) {
  return gemm_launch<false, false>(A, W, C, M, N, K, K, N, N,
                                   ServeEpi<EPI>{bias, R, scale, lens, T},
                                   stream);
}

// ------------------------------------------------------------------------
// Conv module middle: g (B, T_in, 2D) = pw1 output ->
//   u = GLU(g) -> depthwise conv over time (+ bias) -> norm -> SiLU ->
//   y (B, T_out, D), where output row t reads u rows t - left .. t - left
//   + k - 1. The norm is a compile-time choice: LN (kLN, gamma/beta its
//   scale and shift) or the per-channel affine gamma * v + beta that a
//   BatchNorm folds to in serving. One block per (16 output rows,
//   utterance). The block stages the (16 + k - 1) rows of u it needs in
//   smem; out-of-range rows are the conv padding: GLU(pw1 bias) before
//   row 0 when `pad_bias`, zeros otherwise. For a backward the LN's output
//   before SiLU (`pre`), its x-hat and 1/std are saved when given.
// ------------------------------------------------------------------------
constexpr int kConvRows = 16;
constexpr int kConvThreads = 256;

template <bool kLN>
__global__ void __launch_bounds__(kConvThreads)
    conv_module_kernel(const float* __restrict__ g,
                       const float* __restrict__ dww,
                       const float* __restrict__ dwb,
                       const float* __restrict__ pw1b,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ y,
                       int T_in, int T_out, int D, int ksize, int left,
                       int pad_bias, float eps, float* __restrict__ pre,
                       float* __restrict__ xhat, float* __restrict__ rstd) {
  extern __shared__ float smem[];
  const int W = kConvRows + ksize - 1;
  float* us = smem;              // W x D
  float* cs = us + W * D;        // kConvRows x D
  const int b = blockIdx.y, t0 = blockIdx.x * kConvRows;

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
  for (int i = threadIdx.x; i < kConvRows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    float acc = 0.f;
    for (int j = 0; j < ksize; ++j)
      acc = fmaf(us[(r + j) * D + c], dww[j * D + c], acc);
    cs[i] = acc + dwb[c];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kConvRows; r += blockDim.x / 32) {
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
        y[o + c] = silu_f(v);
      }
    } else {
      for (int c = lane; c < D; c += 32)
        y[o + c] = silu_f(xr[c] * gamma[c] + beta[c]);
    }
  }
}

// norm: (2, D) scale and shift, of the LN (use_ln) or of the folded
// per-channel affine (!use_ln); pre, xhat, rstd: optional saves for a
// backward of the LN variant (nullptr: not saved)
cudaError_t conv_module(const float* g, const float* dww, const float* dwb,
                        const float* pw1b, const float* norm, float* y, int B,
                        int T_in, int T_out, int D, int ksize, int left,
                        int pad_bias, float eps, cudaStream_t stream,
                        float* pre = nullptr, float* xhat = nullptr,
                        float* rstd = nullptr, bool use_ln = true) {
  const size_t smem = sizeof(float) * (size_t)(2 * kConvRows + ksize - 1) * D;
  auto kernel = use_ln ? conv_module_kernel<true>
                           : conv_module_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_out + kConvRows - 1) / kConvRows, B);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      g, dww, dwb, pw1b, norm, norm + D, y, T_in, T_out, D, ksize, left,
      pad_bias, eps, pre, xhat, rstd);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// The Squeezeformer conv module's adaptive scale: y (M, D) = x * ada[0] +
// ada[1] in rows t = row % T < lens[row / T], 0 in the rows past an
// utterance's length (its padded rows enter pw1 as zeros).
// ------------------------------------------------------------------------
__global__ void ada_rows_kernel(const float* __restrict__ x,
                                float* __restrict__ y,
                                const float* __restrict__ ada,
                                const int* __restrict__ lens, int T, int D,
                                long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / D;
    const int c = (int)(i % D);
    y[i] = (row % T) < lens[row / T] ? x[i] * ada[c] + ada[D + c] : 0.f;
  }
}

cudaError_t ada_rows(const float* x, float* y, const float* ada,
                     const int* lens, int T, int D, long long n,
                     cudaStream_t stream) {
  ada_rows_kernel<<<(int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096),
                    256, 0, stream>>>(x, y, ada, lens, T, D, n);
  return cudaGetLastError();
}

// LayerNorm idx of the packed (6, 2, D) scales and shifts; xhat, rstd:
// optional saves for a backward
cudaError_t layer_norm(const float* x, float* y, const float* lnw, int idx,
                       int M, int D, float eps, const int* lens, int T,
                       cudaStream_t stream, float* xhat = nullptr,
                       float* rstd = nullptr) {
  const int rows_per_block = 8;
  const float* gamma = lnw + (size_t)idx * 2 * D;
  layer_norm_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                      rows_per_block * 32, 0, stream>>>(
      x, y, gamma, gamma + D, M, D, eps, lens, T, xhat, rstd);
  return cudaGetLastError();
}

// macaron / final FFN: xw += scale * (SiLU(LN(xw) . w1 + b1) . w2 + b2)
cudaError_t ffn_residual(float* xw, float* xn, float* h, const float* lnw,
                         int ln_idx, const float* w1, const float* b1,
                         const float* w2, const float* b2, int M, int D,
                         int F, float scale, float eps, cudaStream_t stream) {
  cudaError_t err = layer_norm(xw, xn, lnw, ln_idx, M, D, eps, nullptr, 1,
                               stream);
  if (err != cudaSuccess) return err;
  err = gemm<kSilu>(xn, w1, b1, h, nullptr, M, F, D, 1.f, nullptr, 1, stream);
  if (err != cudaSuccess) return err;
  return gemm<kResidual>(h, w2, b2, xw, xw, M, D, F, scale, nullptr, 1,
                         stream);
}

}  // namespace

#define MASR_CHECK(call)                  \
  do {                                    \
    cudaError_t e_ = (call);              \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
