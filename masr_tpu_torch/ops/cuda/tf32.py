"""Plain twins of the kernels' tensor-core arithmetic: TF32 rounding and the
3xTF32 product (csrc/common.cuh's `split_tf32` / `mma_3xtf32`).

TF32 keeps f32's 8-bit exponent and 10 of its 23 mantissa bits. The
training-layer products (csrc/common.cuh's `gemm_tc_kernel`), the flash
attention (csrc/rel_pos_attention.cu) and the chunk steps' products and
attention (csrc/serving.cuh's `gemm_sk_kernel`, `chunk_attention_kernel`)
split each f32 operand into big = tf32(x) and small = tf32(x - big) and sum
small_a.big_b + big_a.small_b + big_a.big_b with f32 accumulation: about
f32's accuracy at three tensor-core products per product. These functions
repeat that on any device so that a test can measure the error of 1xTF32
and 3xTF32 against f64 (tests/test_torch_tf32.py); on the main path only
`split_tf32` runs, once per weight, in the chunk kernels' tensor-core pack
(chunk_layer.py pack_chunk_tc).
"""
import torch


def tf32_round(x):
    """f32 → the nearest TF32 value (10 mantissa bits; ties away from zero,
    as `cvt.rna.tf32.f32`), still stored as f32."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round takes f32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    out = sign | torch.where(mag >= 0x7F800000,
                             torch.full_like(mag, 0x7F800000), mag)
    out = torch.where((bits & 0x7FFFFFFF) > 0x7F800000, bits, out)   # NaN
    return (out - ((out & 0x80000000) << 1)).to(torch.int32).view(
        torch.float32).reshape(x.shape)


def split_tf32(x):
    """f32 x → (big, small) TF32 halves, big = tf32(x), small = tf32(x -
    big)."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def mm_1xtf32_plain(a, b):
    """a @ b with each operand rounded to TF32 once, f32 accumulation."""
    return tf32_round(a) @ tf32_round(b)


def mm_3xtf32_plain(a, b):
    """a @ b as the kernels compute it: small_a.big_b + big_a.small_b +
    big_a.big_b over TF32 halves, f32 accumulation."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm_3xtf32_splitk_plain(a, b, plan):
    """a @ b as the chunk kernels compute it (csrc/serving.cuh gemm_sk): K
    cut by plan = (parts, part) (chunk_layer.py split_plan), each part's
    3xTF32 product summed on its own, the parts added in the order s = 0,
    1, ..."""
    parts, part = plan
    out = mm_3xtf32_plain(a[:, :part], b[:part])
    for s in range(1, parts):
        lo, hi = s * part, min((s + 1) * part, a.shape[1])
        out = out + mm_3xtf32_plain(a[:, lo:hi], b[lo:hi])
    return out
