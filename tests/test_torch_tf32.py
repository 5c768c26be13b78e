"""Why the tensor-core kernels compute in 3xTF32 (CPU).

The training layers' products (csrc/common.cuh `gemm_tc_kernel`), the
serving layers' products (csrc/serving.cuh `gemm_sk_kernel`) and the flash
attention (csrc/flash_attention.cuh) run on the TF32 tensor cores.
Their card checks hold them to KERNEL_ATOL = 2e-4 (output max abs err) and
GRAD_RTOL = 1e-4 (grad max abs err over the grad's largest magnitude),
chip_smoke.py. The plain twins of masr_tpu_torch/ops/cuda/tf32.py repeat
the arithmetic here, against f64, at flagship product shapes with seeded
data of the layers' scale (measured on this suite's seeds):

  product (M x N over K)                     1xTF32        3xTF32
  FFN w_1: (2392 x 2048 over 256), abs      9.0e-4 (fail)  2.4e-6
  weight grad (2048 x 256 over 2392), rel   2.7e-4 (fail)  4.2e-7
  attention tile: 64 x 64 scores over 128,
    64-key P.V, output abs                  6.7e-4 (fail)  9.5e-7
  chunk step's FFN w_2: (512 x 256 over
    2048), split_plan's 16 parts, abs       4.7e-4 (fail)  3.9e-7
  full-context layers (M = 2392), in full_plan's parts, abs:
    FFN w_1 (2048 over 256)                 8.7e-4 (fail)  2.0e-6
    FFN w_2 (256 over 2048), 4 parts        5.8e-4 (fail)  6.6e-7
    q/k/v (768 over 256)                    8.9e-4 (fail)  2.0e-6

One TF32 product keeps ~3 decimal digits and misses both tolerances; three
(big and small halves) stay within f32's own error (f32 products give
2.4e-6, 3.8e-7 and 1.2e-6; 2.2e-6, 8.6e-7 and 2.0e-6 for the full-context
products).
"""
import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401

from masr_tpu_torch.ops.cuda.chunk_layer import split_plan
from masr_tpu_torch.ops.cuda.conformer_layer import full_plan
from masr_tpu_torch.ops.cuda.tf32 import (mm_1xtf32_plain, mm_3xtf32_plain,
                                          mm_3xtf32_splitk_plain, split_tf32,
                                          tf32_round)

KERNEL_ATOL = 2e-4
GRAD_RTOL = 1e-4


def test_tf32_round_bits():
    """10 mantissa bits, round to nearest, ties away from zero; inf kept;
    the halves add back to x within TF32's rounding of the remainder."""
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -11 + 2 ** -20,
                      1 + 3 * 2 ** -11, -(1 + 2 ** -11), 3.14159265,
                      float("inf"), -float("inf"), 0.0], dtype=torch.float32)
    want = [1.0, 1 + 2 ** -10, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10),
            3.140625, float("inf"), -float("inf"), 0.0]
    assert tf32_round(x).tolist() == want
    r = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(
        np.float32))
    bits = tf32_round(r).view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)
    rel = ((tf32_round(r) - r).abs() / r.abs()).max().item()
    assert rel <= 2 ** -11
    big, small = split_tf32(r)
    assert ((big + small).double() - r.double()).abs().max().item() <= \
        2 ** -22 * r.abs().max().item()


def _errors(a, b, ref):
    return [(fn(a, b).double() - ref).abs().max().item()
            for fn in (mm_1xtf32_plain, mm_3xtf32_plain)]


def test_3xtf32_holds_the_training_tolerances():
    """Row 3's FFN product (2392 x 256) . (256 x 2048): LayerNorm-scale rows
    and a w_1 of torch's Linear init, against KERNEL_ATOL; its weight grad
    h^T . df (2048 x 256 over K = B*T' = 2392), against GRAD_RTOL. 1xTF32
    misses each."""
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.randn(2392, 256).astype(np.float32))
    w = torch.from_numpy(rs.uniform(-1 / 16, 1 / 16, (256, 2048)).astype(
        np.float32))
    one, three = _errors(a, w, a.double() @ w.double())
    assert three <= KERNEL_ATOL / 10 and one > KERNEL_ATOL, (one, three)
    h = torch.nn.functional.silu(torch.from_numpy(
        rs.randn(2392, 2048).astype(np.float32)))
    df = torch.from_numpy(rs.randn(2392, 256).astype(np.float32))
    ref = h.double().T @ df.double()
    scale = ref.abs().max().item()
    one, three = (e / scale for e in _errors(h.T, df, ref))
    assert three <= GRAD_RTOL / 10 and one > GRAD_RTOL, (one, three)


def test_3xtf32_holds_the_attention_tolerance():
    """Row 5's tile: [q+u | q+v] (64 x 128) . [k | p]^T scores at scale
    1/8 (d_k 64), their softmax, and P . v over 64 keys, with q, k, v, p of
    unit scale as chip_smoke's inputs, each product in 1x or 3xTF32 against
    f64: the output within KERNEL_ATOL only in 3xTF32."""
    rs = np.random.RandomState(1)
    q, k = (torch.from_numpy(rs.randn(64, 128).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rs.randn(64, 64).astype(np.float32))
    ref = torch.softmax((q.double() @ k.double().T) / 8, -1) @ v.double()
    errs = []
    for mm in (mm_1xtf32_plain, mm_3xtf32_plain):
        p = torch.softmax(mm(q, k.T) / 8, -1)
        errs.append((mm(p, v).double() - ref).abs().max().item())
    one, three = errs
    assert three <= KERNEL_ATOL / 10 and one > KERNEL_ATOL, (one, three)


def test_3xtf32_split_k_holds_the_chunk_tolerance():
    """The chunk step's FFN w_2 at the engine's shape: SiLU rows (512 x
    2048) . a w_2 of torch's Linear init (2048 x 256), in split_plan(256,
    2048)'s parts (3xTF32 each, added in order) as the chunk kernels run
    it, within KERNEL_ATOL of f64 by a factor of 10 and no worse than the
    unsplit 3xTF32 product by more than f32's rounding of the sum; one
    TF32 product misses KERNEL_ATOL."""
    rs = np.random.RandomState(2)
    h = torch.nn.functional.silu(torch.from_numpy(
        rs.randn(512, 2048).astype(np.float32)))
    w = torch.from_numpy(rs.uniform(-2048 ** -0.5, 2048 ** -0.5,
                                    (2048, 256)).astype(np.float32))
    ref = h.double() @ w.double()
    plan = split_plan(256, 2048)
    assert plan[0] > 1
    split = (mm_3xtf32_splitk_plain(h, w, plan).double()
             - ref).abs().max().item()
    one, three = _errors(h, w, ref)
    assert split <= KERNEL_ATOL / 10 and one > KERNEL_ATOL, (one, split)
    assert split <= three + 1e-6, (split, three)


# the full-context layers' products at the flagship's B=8, T'=299 (M =
# 2392 rows): (N, K) and whether the rows are SiLU outputs (w_2's input)
FULL_PRODUCTS = {"ffn_w1": (2048, 256, False), "ffn_w2": (256, 2048, True),
                 "qkv": (768, 256, False)}


@pytest.mark.parametrize("name", sorted(FULL_PRODUCTS))
def test_3xtf32_full_context_products(name):
    """Rows 1 and 6's products at the flagship shape, M = 2392 rows of the
    layers' scale (LayerNorm outputs, or SiLU rows for w_2) . a weight of
    torch's Linear init, in full_plan(K)'s parts (3xTF32 each, added in
    order) as the full-context kernels run them: within KERNEL_ATOL of f64
    by a factor of 10; one TF32 product misses KERNEL_ATOL."""
    N, K, silu = FULL_PRODUCTS[name]
    rs = np.random.RandomState(3 + N + K)
    a = torch.from_numpy(rs.randn(2392, K).astype(np.float32))
    if silu:
        a = torch.nn.functional.silu(a)
    w = torch.from_numpy(rs.uniform(-K ** -0.5, K ** -0.5,
                                    (K, N)).astype(np.float32))
    ref = a.double() @ w.double()
    plan = full_plan(K)
    assert plan[0] == (4 if K == 2048 else 1)
    split = (mm_3xtf32_splitk_plain(a, w, plan).double()
             - ref).abs().max().item()
    one = (mm_1xtf32_plain(a, w).double() - ref).abs().max().item()
    assert split <= KERNEL_ATOL / 10 and one > KERNEL_ATOL, (one, split)
