// Full-context Squeezeformer encoder layer for Hopper (sm_90a), forward
// only, f32.
//
// Replaces the TPU kernel masr_tpu/ops/pallas/squeezeformer_layer.py:166
// (`fused_squeezeformer_layer`, one pallas_call per layer that keeps the
// whole post-norm layer in VMEM). It computes what that kernel's `_kernel`
// computes, each sublayer as x = LN_i(x + sub(x)):
//
//   x = LN1(x + MHSA(ada0 x))      rel-pos attention over the valid keys
//   x = LN2(x + FFN1(ada1 x))      D -> F -> D, SiLU
//   x = LN3(x + Conv(ada2 x))      GLU -> depthwise(k) -> norm -> SiLU -> pw
//   x = LN4(x + FFN2(ada3 x))
//
// `masr_sq_layer_forward` launches, in order on the caller's stream, the
// serving kernels' blocks (common.cuh, serving.cuh): q/k/v products,
// attention_kernel, the out product with the residual in its epilogue,
// layer_norm_kernel, the FFN products (SiLU and residual epilogues),
// ada_rows_kernel (below), pw1, conv_module_kernel with the folded
// BatchNorm affine or the LN, pw2 with the row-masked residual.
//
// The adaptive scales ada0, ada1 and ada3 are folded into the q/k/v and
// w_1 weights and biases at pack time (ops/cuda/squeezeformer_layer.py
// pack_sq_layer_params): (x s + t) W + b = x (diag(s) W) + (t W + b).
// ada2 is not: rows t >= len are zeroed AFTER it (the conv input of a
// padded row is 0, not ada2's shift), which ada_rows_kernel does. The
// conv-module BatchNorm is folded to a per-channel affine from its running
// statistics, exact in eval.
//
// Semantics kept exactly from the Pallas kernel:
//   - causal conv: the k-1 left pad rows carry GLU(pw1 bias); non-causal
//     pads zeros;
//   - rows t in [len, T) enter pw1 as zeros and add nothing after pw2;
//   - attention keys col >= len are masked; a row with len == 0 gives 0.
//
// What bounds it on the H100: the same as the Conformer layer
// (conformer_layer.cu), with which it shares every kernel but one: at the
// flagship shapes (D=256, F=2048, B*T' ~ 2.4k rows at full rate, half that
// at half rate) ~90% of the operations are the eight products, run on the
// f32 FMA pipes from shared-memory tiles: bound by operations (FMA and the
// GEMM main loop's shared-memory loads), ~0.2 ms at the f32 peak against a
// measured ~1.9 ms for the Conformer layer. What this simple design leaves
// for later: bf16/TF32 operands on wgmma with TMA-fed pipelines, split-K
// or smaller tiles for the N=256, K=2048 products, a fused q/k/v product.
//
// Plain C interface, loaded with ctypes. The entry returns the first CUDA
// error of a launch, 0 on success.

#include "serving.cuh"

namespace {

// y (M, D) = x * ada[0] + ada[1] in rows t = row % T < lens[row / T], 0 in
// the rows past an utterance's length
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

}  // namespace

// Packed weights as ops/cuda/squeezeformer_layer.py pack_sq_layer_params
// (all f32, row-major, contiguous):
//   lnw (4,2,D) LN1..LN4; ada (2,D) the conv module's adaptive scale;
//   cnw (2,D) the conv norm (LN scale/shift, or the folded BatchNorm);
//   attw (4,D,D) q,k,v (ada0 folded), out; vecb (8,D) q,k,v,out biases,
//   FFN1 and FFN2 w_2 biases, depthwise bias, pw2 bias; posb (2,D);
//   ffw1 (2,D,F), ffb1 (2,F) (ada1, ada3 folded); ffw2 (2,F,D);
//   pw1w (D,2D) pw1b (1,2D) pw2w (D,D) dww (k,D)
// x, out: (B, T, D); lens (B,) int32; pos_p (T, D) = linear_pos(pos_emb).
// workspace: M*(2D + max(F, 4D)) floats, M = B*T.
extern "C" int masr_sq_layer_forward(
    const float* x, const int* lens, const float* pos_p, const float* lnw,
    const float* ada, const float* cnw, const float* attw, const float* vecb,
    const float* posb, const float* ffw1, const float* ffb1,
    const float* ffw2, const float* pw1w, const float* pw1b,
    const float* pw2w, const float* dww, float* out, float* workspace, int B,
    int T, int D, int F, int n_head, int ksize, int causal, int conv_ln,
    float eps, float conv_eps, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = B * T;
  if (M == 0) return (int)cudaGetLastError();
  const int dk = D / n_head;
  if (dk * n_head != D || dk > 128 || (!causal && ksize % 2 == 0))
    return (int)cudaErrorInvalidValue;
  const size_t MD = (size_t)M * D, DD = (size_t)D * D;
  float* xa = workspace;          // residual sums (M, D)
  float* xb = xa + MD;            // LN outputs (M, D)
  float* big = xb + MD;           // (M, max(F, 4D))
  float *h = big, *q = big, *k = big + MD, *v = big + 2 * MD,
        *att = big + 3 * MD, *gx = big, *y = big + 2 * MD;

  // x = LN1(x + MHSA(ada0 x)), ada0 folded into q/k/v
  MASR_CHECK(gemm<kBias>(x, attw, vecb, q, nullptr, M, D, D, 1.f, nullptr, T,
                         stream));
  MASR_CHECK(gemm<kBias>(x, attw + DD, vecb + D, k, nullptr, M, D, D, 1.f,
                         nullptr, T, stream));
  MASR_CHECK(gemm<kBias>(x, attw + 2 * DD, vecb + 2 * D, v, nullptr, M, D, D,
                         1.f, nullptr, T, stream));
  MASR_CHECK(attention(q, k, v, pos_p, posb, lens, att, B, T, D, n_head,
                       stream));
  MASR_CHECK(gemm<kResidual>(att, attw + 3 * DD, vecb + 3 * D, xa, x, M, D, D,
                             1.f, nullptr, T, stream));
  MASR_CHECK(layer_norm(xa, xb, lnw, 0, M, D, eps, nullptr, T, stream));
  // x = LN2(x + FFN1(ada1 x)), ada1 folded into w_1
  MASR_CHECK(gemm<kSilu>(xb, ffw1, ffb1, h, nullptr, M, F, D, 1.f, nullptr,
                         T, stream));
  MASR_CHECK(gemm<kResidual>(h, ffw2, vecb + 4 * D, xa, xb, M, D, F, 1.f,
                             nullptr, T, stream));
  MASR_CHECK(layer_norm(xa, xb, lnw, 1, M, D, eps, nullptr, T, stream));
  // x = LN3(x + Conv(ada2 x)): masked ada rows -> pw1 -> GLU / depthwise /
  // norm / SiLU -> pw2 with the row-masked residual
  const long long n = (long long)MD;
  ada_rows_kernel<<<(int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096),
                    256, 0, stream>>>(xb, xa, ada, lens, T, D, n);
  MASR_CHECK(cudaGetLastError());
  MASR_CHECK(gemm<kBias>(xa, pw1w, pw1b, gx, nullptr, M, 2 * D, D, 1.f,
                         nullptr, T, stream));
  MASR_CHECK(conv_module(gx, dww, vecb + 6 * D, pw1b, cnw, y, B, T, T, D,
                         ksize, causal ? ksize - 1 : (ksize - 1) / 2, causal,
                         conv_eps, stream, nullptr, nullptr, nullptr,
                         conv_ln != 0));
  MASR_CHECK(gemm<kRowMaskResidual>(y, pw2w, vecb + 7 * D, xa, xb, M, D, D,
                                    1.f, lens, T, stream));
  MASR_CHECK(layer_norm(xa, xb, lnw, 2, M, D, eps, nullptr, T, stream));
  // x = LN4(x + FFN2(ada3 x)), ada3 folded into w_1
  MASR_CHECK(gemm<kSilu>(xb, ffw1 + (size_t)D * F, ffb1 + F, h, nullptr, M, F,
                         D, 1.f, nullptr, T, stream));
  MASR_CHECK(gemm<kResidual>(h, ffw2 + (size_t)F * D, vecb + 5 * D, xa, xb, M,
                             D, F, 1.f, nullptr, T, stream));
  MASR_CHECK(layer_norm(xa, out, lnw, 3, M, D, eps, nullptr, T, stream));
  return (int)cudaGetLastError();
}
