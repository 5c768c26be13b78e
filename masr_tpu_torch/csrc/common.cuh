// Building blocks shared by the port's Conformer layer kernels
// (conformer_layer.cu, chunk_layer.cu), for Hopper (sm_90a), f32:
//
//   layer_norm_kernel      one warp per row, f32 statistics, optional
//                          zeroing of rows t >= len
//   gemm_kernel<EPI>       Y = A.W + b, shared-memory tiled f32 FMA main
//                          loop, fused epilogue (plain, SiLU, scaled
//                          residual, row-masked residual)
//   conv_module_kernel     GLU -> depthwise conv over time -> LN -> SiLU
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
// LayerNorm over the last dim, one warp per row. With `lens` set, rows
// whose time index t = row % T is >= lens[row / T] are written as zeros.
// ------------------------------------------------------------------------
__global__ void layer_norm_kernel(const float* __restrict__ x,
                                  float* __restrict__ y,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta, int M, int D,
                                  float eps, const int* __restrict__ lens,
                                  int T) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  float* yr = y + (size_t)row * D;
  if (lens != nullptr && (row % T) >= lens[row / T]) {
    for (int c = lane; c < D; c += 32) yr[c] = 0.f;
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
  const float rstd = rsqrtf(warp_sum(s2) / D + eps);
  for (int c = lane; c < D; c += 32)
    yr[c] = (xr[c] - mu) * rstd * gamma[c] + beta[c];
}

// ------------------------------------------------------------------------
// C = epilogue(A (M,K) . W (K,N) + bias (N)), all row-major f32.
// BM x BN block tile, BK = 8 deep, each thread a TM x TN micro-tile whose
// rows/cols are strided by the thread grid (conflict-free smem reads,
// coalesced stores). Ragged edges are zero-filled on load, masked on
// store. C may alias R (in-place residual update): each element is read
// and written by the same thread.
// ------------------------------------------------------------------------
enum Epilogue { kBias = 0, kSilu = 1, kResidual = 2, kRowMaskResidual = 3 };

template <int BM, int BN, int TM, int TN, int EPI>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, float* C, const float* R,
                int M, int N, int K, float scale,
                const int* __restrict__ lens, int T) {
  constexpr int BK = 8;
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN, gk = k0 + r, gn = n0 + c;
      Ws[r][c] = (gk < K && gn < N) ? W[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = Ws[kk][tx + j * TX];
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
    bool row_ok = true;
    if (EPI == kRowMaskResidual) row_ok = (m % T) < lens[m / T];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      const float v = acc[i][j] + bias[n];
      if (EPI == kBias) C[o] = v;
      if (EPI == kSilu) C[o] = silu_f(v);
      if (EPI == kResidual) C[o] = R[o] + scale * v;
      if (EPI == kRowMaskResidual) C[o] = R[o] + (row_ok ? v : 0.f);
    }
  }
}

template <int EPI>
cudaError_t gemm(const float* A, const float* W, const float* bias, float* C,
                 const float* R, int M, int N, int K, float scale,
                 const int* lens, int T, cudaStream_t stream) {
  // big tiles once they fill the 132 SMs, small ones otherwise
  const long big_tiles = (long)((M + 127) / 128) * ((N + 127) / 128);
  if (big_tiles >= 132) {
    dim3 grid((N + 127) / 128, (M + 127) / 128);
    gemm_kernel<128, 128, 8, 8, EPI><<<grid, 256, 0, stream>>>(
        A, W, bias, C, R, M, N, K, scale, lens, T);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    gemm_kernel<64, 64, 4, 4, EPI><<<grid, 256, 0, stream>>>(
        A, W, bias, C, R, M, N, K, scale, lens, T);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// Conv module middle: g (B, T_in, 2D) = pw1 output ->
//   u = GLU(g) -> depthwise conv over time (+ bias) -> LN -> SiLU ->
//   y (B, T_out, D), where output row t reads u rows t - left .. t - left
//   + k - 1. One block per (16 output rows, utterance). The block stages
//   the (16 + k - 1) rows of u it needs in smem; out-of-range rows are the
//   conv padding: GLU(pw1 bias) before row 0 when `pad_bias`, zeros
//   otherwise.
// ------------------------------------------------------------------------
constexpr int kConvRows = 16;
constexpr int kConvThreads = 256;

__global__ void __launch_bounds__(kConvThreads)
    conv_module_kernel(const float* __restrict__ g,
                       const float* __restrict__ dww,
                       const float* __restrict__ dwb,
                       const float* __restrict__ pw1b,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ y,
                       int T_in, int T_out, int D, int ksize, int left,
                       int pad_bias, float eps) {
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
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += xr[c];
    const float mu = warp_sum(s) / D;
    float s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = xr[c] - mu;
      s2 += d * d;
    }
    const float rstd = rsqrtf(warp_sum(s2) / D + eps);
    float* yr = y + ((size_t)b * T_out + t) * D;
    for (int c = lane; c < D; c += 32)
      yr[c] = silu_f((xr[c] - mu) * rstd * gamma[c] + beta[c]);
  }
}

cudaError_t conv_module(const float* g, const float* dww, const float* dwb,
                        const float* pw1b, const float* ln, float* y, int B,
                        int T_in, int T_out, int D, int ksize, int left,
                        int pad_bias, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * kConvRows + ksize - 1) * D;
  cudaError_t err = cudaFuncSetAttribute(
      conv_module_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_out + kConvRows - 1) / kConvRows, B);
  conv_module_kernel<<<grid, kConvThreads, smem, stream>>>(
      g, dww, dwb, pw1b, ln, ln + D, y, T_in, T_out, D, ksize, left,
      pad_bias, eps);
  return cudaGetLastError();
}

// LayerNorm idx of the packed (6, 2, D) scales and shifts
cudaError_t layer_norm(const float* x, float* y, const float* lnw, int idx,
                       int M, int D, float eps, const int* lens, int T,
                       cudaStream_t stream) {
  const int rows_per_block = 8;
  const float* gamma = lnw + (size_t)idx * 2 * D;
  layer_norm_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                      rows_per_block * 32, 0, stream>>>(
      x, y, gamma, gamma + D, M, D, eps, lens, T);
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
