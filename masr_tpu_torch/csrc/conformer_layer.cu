// Full-context Conformer encoder layer for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/conformer_layer.py:188
// (`fused_conformer_layer`, one pallas_call per layer that keeps the whole
// layer in VMEM). On the H100 one block cannot hold a layer, so the layer is
// split into five kinds of kernels, all launched in order on the caller's
// stream by `masr_conformer_layer_forward`:
//
//   1. layer_norm_kernel       one warp per row, f32 statistics, optional
//                              zeroing of rows t >= len (the conv input xm)
//   2. gemm_kernel<EPI>        Y = A.W + b with a shared-memory tiled f32 FMA
//                              main loop and a fused epilogue: plain, SiLU,
//                              scaled residual x + s*y, row-masked residual
//   3. attention_kernel<NDK>   rel-pos attention, one block per (utterance,
//                              head, 32-query tile); online softmax over
//                              32-key tiles, so any T runs in fixed smem
//   4. conv_module_kernel      GLU -> depthwise conv over time -> LN -> SiLU
//   5. cudaMemcpyAsync         x into the residual buffer
// Kinds 1, 2 and 4 live in common.cuh, shared with chunk_layer.cu.
//
// What bounds it on the H100: at the flagship shapes (D=256, F=2048,
// B*T' ~ 2.4k rows) about 90% of the operations are the eight products;
// they run on the f32 FMA pipes (67 TFLOP/s peak), not the tensor cores,
// so the layer is bound by operations: FMA throughput and the shared-memory
// loads of the GEMM main loop (PERF.md: 5-12 TFLOP/s measured; the FFN
// w_2 products, N=256 by K=2048, fill barely one wave of 64x64 tiles and
// take half the layer). The activations make ~15 round trips through
// device memory per layer (L2-resident at these sizes), cheap next to the
// products. What this simple design leaves for later: bf16/TF32 operands
// on wgmma with TMA-fed pipelines, split-K or smaller tiles for small-N
// products, a fused q/k/v product, vectorised 16-byte loads, and keeping
// the FFN hidden tile on chip.
//
// Semantics kept exactly from the Pallas kernel:
//   - causal conv: the k-1 left pad rows carry GLU(pw1 bias), because the
//     flax module pads before pointwise_conv1; non-causal pads zeros.
//   - rows t in [len, T) are zeroed before pw1, so they carry GLU(pw1 bias).
//   - attention keys col >= len are masked; a row with len == 0 gives 0.
//
// Plain C interface, loaded with ctypes. Every entry returns
// cudaGetLastError() (or the first error of a launch), 0 on success.

#include "common.cuh"

namespace {

// ------------------------------------------------------------------------
// 3. Rel-pos attention (no rel_shift, as the reference):
//      s = ([q+bu | q+bv] . [k | p]^T) / sqrt(d_k),  keys col < len only,
//    online softmax over 32-key tiles. One block = 4 warps = 32 query rows
//    of one (utterance, head); each warp owns 8 rows, each lane one key of
//    the tile for the scores and d = lane + 32 i of the output.
//    q, k, v, out: (B, T, D) with head h in columns [h d_k, (h+1) d_k);
//    pos_p: (T, D); posb: (2, D) = pos_bias_u, pos_bias_v.
// ------------------------------------------------------------------------
constexpr int kAttRows = 32;     // query rows per block
constexpr int kAttKeys = 32;     // keys per tile (one per lane)
constexpr int kAttWarps = 4;
constexpr int kAttRowsPerWarp = kAttRows / kAttWarps;

template <int NDK>
__global__ void __launch_bounds__(kAttWarps * 32)
    attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ pos_p,
                     const float* __restrict__ posb,
                     const int* __restrict__ lens, float* __restrict__ out,
                     int T, int D, int dk, float scale) {
  extern __shared__ float smem[];
  const int e2 = 2 * dk, ks = e2 + 1;        // +1: conflict-free key rows
  float* Qs = smem;                          // kAttRows x e2
  float* Ks = Qs + kAttRows * e2;            // kAttKeys x ks
  float* Vs = Ks + kAttKeys * ks;            // kAttKeys x dk
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kAttRows;
  const int len = min(lens[b], T);          // as the plain twin's t < len
  const size_t base = (size_t)b * T * D + (size_t)h * dk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kAttRows * e2; i += blockDim.x) {
    const int r = i / e2, e = i % e2, t = t0 + r;
    float val = 0.f;
    if (t < T) {
      const int half = e < dk ? 0 : 1, d = e - half * dk;
      val = q[base + (size_t)t * D + d] + posb[half * D + h * dk + d];
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
        val = e < dk ? k[base + (size_t)key * D + e]
                     : pos_p[(size_t)key * D + h * dk + (e - dk)];
      Ks[r * ks + e] = val;
    }
    for (int i = threadIdx.x; i < kAttKeys * dk; i += blockDim.x) {
      const int r = i / dk, d = i % dk, key = k0 + r;
      Vs[i] = key < len ? v[base + (size_t)key * D + d] : 0.f;
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
    const bool valid = k0 + lane < len;
#pragma unroll
    for (int r = 0; r < kAttRowsPerWarp; ++r) {
      const float sr = valid ? s[r] * scale : -INFINITY;
      // key k0 < len is valid, so the tile max is finite
      const float mn = fmaxf(m[r], warp_max(sr));
      const float p = valid ? expf(sr - mn) : 0.f;
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
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;   // len == 0 -> 0
#pragma unroll
    for (int i = 0; i < NDK; ++i) {
      const int d = lane + 32 * i;
      if (d < dk) out[base + (size_t)t * D + d] = acc[r][i] * inv;
    }
  }
}

template <int NDK>
cudaError_t attention(const float* q, const float* k, const float* v,
                      const float* pos_p, const float* posb, const int* lens,
                      float* out, int B, int T, int D, int H,
                      cudaStream_t stream) {
  const int dk = D / H;
  const size_t smem =
      sizeof(float) * (kAttRows * 2 * dk + kAttKeys * (2 * dk + 1) +
                       kAttKeys * dk);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<NDK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kAttRows - 1) / kAttRows, H, B);
  attention_kernel<NDK><<<grid, kAttWarps * 32, smem, stream>>>(
      q, k, v, pos_p, posb, lens, out, T, D, dk, 1.f / sqrtf((float)dk));
  return cudaGetLastError();
}

}  // namespace

// Packed weights as masr_tpu/ops/pallas/conformer_layer.py:250
// pack_layer_params (all f32, row-major, contiguous):
//   lnw (6,2,D) ffw1 (2,D,F) ffb1 (2,F) ffw2 (2,F,D) vecb (8,D) attw (4,D,D)
//   posb (2,D) pw1w (D,2D) pw1b (1,2D) pw2w (D,D) dww (k,D)
// workspace: D*M*2 + M*max(F, 4D) floats, M = B*T.
extern "C" int masr_conformer_layer_forward(
    const float* x, const int* lens, const float* pos_p, const float* lnw,
    const float* ffw1, const float* ffb1, const float* ffw2,
    const float* vecb, const float* attw, const float* posb,
    const float* pw1w, const float* pw1b, const float* pw2w,
    const float* dww, float* out, float* workspace, int B, int T, int D,
    int F, int n_head, int ksize, int causal, float ff_scale, float eps,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = B * T;
  if (M == 0) return (int)cudaGetLastError();
  const int dk = D / n_head;
  if (dk * n_head != D || dk > 128) return (int)cudaErrorInvalidValue;
  const size_t MD = (size_t)M * D;
  float* xw = workspace;          // residual stream (M, D)
  float* xn = xw + MD;            // normed rows (M, D)
  float* big = xn + MD;           // (M, max(F, 4D))
  float *h = big, *q = big, *k = big + MD, *v = big + 2 * MD,
        *att = big + 3 * MD, *gx = big, *y = big + 2 * MD;

  MASR_CHECK(cudaMemcpyAsync(xw, x, MD * sizeof(float),
                             cudaMemcpyDeviceToDevice, stream));
  // macaron FFN (x ff_scale)
  MASR_CHECK(ffn_residual(xw, xn, h, lnw, 0, ffw1, ffb1, ffw2, vecb, M, D, F,
                          ff_scale, eps, stream));
  // rel-pos MHSA
  MASR_CHECK(layer_norm(xw, xn, lnw, 1, M, D, eps, nullptr, T, stream));
  MASR_CHECK(gemm<kBias>(xn, attw, vecb + 2 * D, q, nullptr, M, D, D, 1.f,
                         nullptr, T, stream));
  MASR_CHECK(gemm<kBias>(xn, attw + (size_t)D * D, vecb + 3 * D, k, nullptr,
                         M, D, D, 1.f, nullptr, T, stream));
  MASR_CHECK(gemm<kBias>(xn, attw + 2 * (size_t)D * D, vecb + 4 * D, v,
                         nullptr, M, D, D, 1.f, nullptr, T, stream));
  switch ((dk + 31) / 32) {
    case 1:
      MASR_CHECK(attention<1>(q, k, v, pos_p, posb, lens, att, B, T, D,
                              n_head, stream));
      break;
    case 2:
      MASR_CHECK(attention<2>(q, k, v, pos_p, posb, lens, att, B, T, D,
                              n_head, stream));
      break;
    case 3:
      MASR_CHECK(attention<3>(q, k, v, pos_p, posb, lens, att, B, T, D,
                              n_head, stream));
      break;
    default:
      MASR_CHECK(attention<4>(q, k, v, pos_p, posb, lens, att, B, T, D,
                              n_head, stream));
  }
  MASR_CHECK(gemm<kResidual>(att, attw + 3 * (size_t)D * D, vecb + 5 * D, xw,
                             xw, M, D, D, 1.f, nullptr, T, stream));
  // conv module: masked LN -> pw1 -> GLU/depthwise/LN/SiLU -> pw2
  MASR_CHECK(layer_norm(xw, xn, lnw, 2, M, D, eps, lens, T, stream));
  MASR_CHECK(gemm<kBias>(xn, pw1w, pw1b, gx, nullptr, M, 2 * D, D, 1.f,
                         nullptr, T, stream));
  MASR_CHECK(conv_module(gx, dww, vecb + 6 * D, pw1b, lnw + 3 * 2 * (size_t)D,
                         y, B, T, T, D, ksize,
                         causal ? ksize - 1 : (ksize - 1) / 2, causal, eps,
                         stream));
  MASR_CHECK(gemm<kRowMaskResidual>(y, pw2w, vecb + 7 * D, xw, xw, M, D, D,
                                    1.f, lens, T, stream));
  // final FFN (x ff_scale) + final LN
  MASR_CHECK(ffn_residual(xw, xn, h, lnw, 4, ffw1 + (size_t)D * F, ffb1 + F,
                          ffw2 + (size_t)F * D, vecb + D, M, D, F, ff_scale,
                          eps, stream));
  MASR_CHECK(layer_norm(xw, out, lnw, 5, M, D, eps, nullptr, T, stream));
  return (int)cudaGetLastError();
}
