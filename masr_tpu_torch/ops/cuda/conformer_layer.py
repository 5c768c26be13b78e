"""Full-context Conformer encoder layer: the Hopper kernel and its plain twin.

Port of masr_tpu/ops/pallas/conformer_layer.py (`fused_conformer_layer`,
`pack_layer_params`). The CUDA source is masr_tpu_torch/csrc/
conformer_layer.cu; its header says how the layer is split into kernels,
what bounds it on the H100 and what is left for later.

`fused_conformer_layer` launches the kernel for a CUDA tensor and takes the
plain PyTorch version, `fused_conformer_layer_plain`, only for a CPU tensor.
It counts its kernel launches in `fused_conformer_layer.launches`, one per
layer call, and those of its bf16 mode in `.bf16_launches` as well.
Operands are f32, or bf16: the bf16 mode of masr_tpu's kernel
(`cdt = x_ref.dtype`, masr_tpu/ops/pallas/conformer_layer.py:50), where x,
pos_p and the output are bf16, the pack's product weights are bf16 (LN and
bias rows f32, `pack_layer_params(layer, torch.bfloat16)`), the activations
stay f32 inside, every product rounds its activation operand to bf16 and
sums in f32, and the attention rounds [q+u | q+v], [k | p], the
probabilities and v. Mixed or other dtypes raise.

The kernel's products run on the tensor cores in 3xTF32 (csrc/serving.cuh
`gemm_sk_kernel`), their weights from the serving tensor-core pack of the
chunk kernels (chunk_layer.py `pack_chunk_tc`, cached per layer by
`chunk_packed_params()`; a pack without it gets it built for the call),
with K split by `full_plan(K)`, a function of K alone: an utterance's bits
do not depend on what else shares the batch. Its attention is the flash
kernel of rel_pos_attention.cu (csrc/flash_attention.cuh) with a key-length
mask. The Squeezeformer layer kernel (squeezeformer_layer.py) shares all of
this.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from masr_tpu_torch.ops.cuda.chunk_layer import (CHUNK_KEYS, CHUNK_PRODUCTS,
                                                 K_TILE, TC_KEYS,
                                                 check_chunk_tc,
                                                 check_serving_dtypes,
                                                 chunk_entry,
                                                 launch_tc_kernel,
                                                 operand_mm,
                                                 with_chunk_tc)
from masr_tpu_torch.ops.cuda.rel_pos_attention import (
    MASK_VALUE, rel_pos_attention_plain as masked_attention_plain)

PACKED_KEYS = ("lnw", "ffw1", "ffb1", "ffw2", "vecb", "attw", "posb",
               "pw1w", "pw1b", "pw2w", "dww")


def pack_layer_params(layer, dtype=torch.float32):
    """One ConformerEncoderLayer (masr_tpu_torch.models.conformer) → the
    kernel's stacked arrays, in the layout of the JAX `pack_layer_params`:
    matmul weights as (in, out), in dtype (the compute dtype); LN and bias
    rows f32."""
    att, conv = layer.self_attn, layer.conv_module
    ffm, ff = layer.feed_forward_macaron, layer.feed_forward

    def ln(m):
        return torch.stack([m.weight, m.bias])

    D = layer.size
    packed = {
        "lnw": torch.stack([ln(layer.norm_ff_macaron), ln(layer.norm_mha),
                            ln(layer.norm_conv), ln(conv.norm),
                            ln(layer.norm_ff), ln(layer.norm_final)]),
        "ffw1": torch.stack([ffm.w_1.weight.t(), ff.w_1.weight.t()]),
        "ffb1": torch.stack([ffm.w_1.bias, ff.w_1.bias]),
        "ffw2": torch.stack([ffm.w_2.weight.t(), ff.w_2.weight.t()]),
        "vecb": torch.stack([ffm.w_2.bias, ff.w_2.bias, att.linear_q.bias,
                             att.linear_k.bias, att.linear_v.bias,
                             att.linear_out.bias, conv.depthwise_conv.bias,
                             conv.pointwise_conv2.bias]),
        "attw": torch.stack([att.linear_q.weight.t(), att.linear_k.weight.t(),
                             att.linear_v.weight.t(),
                             att.linear_out.weight.t()]),
        "posb": torch.stack([att.pos_bias_u.reshape(-1),
                             att.pos_bias_v.reshape(-1)]),
        "pw1w": conv.pointwise_conv1.weight[:, :, 0].t().contiguous(),
        "pw1b": conv.pointwise_conv1.bias[None, :],
        "pw2w": conv.pointwise_conv2.weight[:, :, 0].t().contiguous(),
        # torch depthwise Conv1d weight (D, 1, k) → (k, D)
        "dww": conv.depthwise_conv.weight.reshape(D, -1).t().contiguous(),
    }
    if dtype != torch.float32:
        for name in ("ffw1", "ffw2", "attw", "pw1w", "pw2w"):
            packed[name] = packed[name].to(dtype)
    return packed


def rel_pos_attention_plain(q, k, v, pos_p, posb, valid, n_head,
                            cdt=torch.float32):
    """Full-context rel-pos attention, AC + BD as one 2·d_k contraction
    (no rel_shift, as the reference). q, k, v: (B, T, D) f32, heads along
    columns; pos_p: (T, D) linear_pos(pos_emb); posb: (2, D) pos_bias_u,
    pos_bias_v; valid: (B, T) bool, the keys each utterance may see (a row
    that sees none gives 0). cdt: the products' operand dtype (bf16: the
    operands and the normalised probabilities rounded to bf16, as
    masr_tpu's layer kernel). → (B, T, D) f32."""
    B, T, D = q.shape
    d_k = D // n_head
    q, k, v = (t.view(B, T, n_head, d_k).transpose(1, 2) for t in (q, k, v))
    att = masked_attention_plain(
        q, k, v, pos_p.float().view(T, n_head, d_k).transpose(0, 1),
        posb[0].view(n_head, d_k), posb[1].view(n_head, d_k),
        valid[:, None, :].expand(B, T, T), cdt=cdt, round_normalised=True)
    return att.transpose(1, 2).reshape(B, T, D)


def glu_depthwise_plain(gx, pw1b, dww, causal):
    """Conv-module middle of the full-context layers: GLU of the
    pointwise_conv1 output gx (B, T, 2D), then the depthwise conv over time
    without its bias, dww (k, D). The causal pad rows carry GLU(pw1 bias)
    (flax pads x before pointwise_conv1); non-causal pads zeros inside the
    depthwise conv. → (B, T, D)."""
    B, T, D = gx.shape[0], gx.shape[1], gx.shape[2] // 2
    ksize = dww.shape[0]
    u = gx[..., :D] * torch.sigmoid(gx[..., D:])
    if causal:
        pad_row = pw1b[:D] * torch.sigmoid(pw1b[D:])
        left, right = ksize - 1, 0
    else:
        pad_row = torch.zeros_like(pw1b[:D])
        left = right = (ksize - 1) // 2
    upad = torch.cat([pad_row.expand(B, left, D), u,
                      pad_row.expand(B, right, D)], dim=1)
    acc = torch.zeros_like(u)
    for i in range(ksize):
        acc = acc + upad[:, i:i + T] * dww[i]
    return acc


def fused_conformer_layer_plain(x, lens, pos_p, packed, *, n_head, ksize,
                                causal, ff_scale=0.5, eps=1e-5):
    """Plain PyTorch version of the kernel, same arguments.
    x: (B, T, D) f32 or bf16; lens: (B,) valid lengths; pos_p: (T, D)
    linear_pos(pos_emb), heads along columns; packed: `pack_layer_params`
    in x's dtype. In the bf16 mode the activations stay f32 inside and
    operands round to bf16 at each product (operand_mm). → (B, T, D) in
    x's dtype."""
    B, T, D = x.shape
    lnw, vecb, attw = packed["lnw"], packed["vecb"], packed["attw"]
    cdt, x = x.dtype, x.float()
    mm = operand_mm

    def layer_norm(v, i):
        return F.layer_norm(v, (D,), lnw[i, 0], lnw[i, 1], eps)

    def ffn(v, i):
        h = F.silu(mm(v, packed["ffw1"][i]) + packed["ffb1"][i])
        return mm(h, packed["ffw2"][i]) + vecb[i]

    t_idx = torch.arange(T, device=x.device)
    valid = t_idx[None, :] < lens.to(x.device)[:, None]            # (B, T)
    row_ok = valid[:, :, None]

    x = x + ff_scale * ffn(layer_norm(x, 0), 0)

    # rel-pos MHSA
    xn = layer_norm(x, 1)
    att = rel_pos_attention_plain(
        *(mm(xn, attw[i]) + vecb[2 + i] for i in range(3)), pos_p,
        packed["posb"], valid, n_head, cdt)
    x = x + mm(att, attw[3]) + vecb[5]

    # conv module
    xm = torch.where(row_ok, layer_norm(x, 2), 0.0)
    acc = glu_depthwise_plain(mm(xm, packed["pw1w"]) + packed["pw1b"][0],
                              packed["pw1b"][0], packed["dww"], causal)
    y = mm(F.silu(layer_norm(acc + vecb[6], 3)), packed["pw2w"]) + vecb[7]
    x = x + torch.where(row_ok, y, 0.0)

    x = x + ff_scale * ffn(layer_norm(x, 4), 1)
    return layer_norm(x, 5).to(cdt)


FULL_PART = 512     # the full-context products' largest part of K


def full_plan(K):
    """How the full-context layer kernels split the K of a product: (parts,
    part) as chunk_layer.py split_plan gives it, parts of at most FULL_PART
    (a multiple of K_TILE), so only the FFN w_2 (K = F = 2048 at the
    flagship) is split, in 4. A function of K alone, never of the rows M =
    B·T', so each output element is summed in the same order at any batch:
    one utterance alone gives the bits of its slice of a batch."""
    k_tiles = -(-K // K_TILE)
    parts = -(-k_tiles // (FULL_PART // K_TILE))
    part = -(-k_tiles // parts) * K_TILE
    return -(-K // part), part


@functools.lru_cache(maxsize=64)
def full_plans(M, D, F_):
    """The full-context layer kernels' plans for a call over M = B·T' rows
    (serving.cuh ChunkProduct order, as a ctypes int array of (parts, part)
    pairs), and the floats of the split products' partial sums and the
    counters of their output tiles (16 x 8, the smallest tile) that the call
    needs. Cached per shape."""
    plans, n_partials, n_counters = (), 0, 0
    for _, nk in CHUNK_PRODUCTS:
        N, K = nk(D, F_)
        parts, part = full_plan(K)
        plans += (parts, part)
        if parts > 1:
            n_partials = max(n_partials, parts * M * N)
            n_counters = max(n_counters, -(-M // 16) * -(-N // 8))
    return (ctypes.c_int * len(plans))(*plans), n_partials, n_counters


def check_operands(tensors, want, device, dtype=torch.float32):
    """Raise unless every tensor of {name: tensor} is of dtype (unless None:
    the caller's rule), contiguous and on device, and has the shape
    want[name] where want names one."""
    for name, t in tensors.items():
        if t.device != device or dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: the kernel takes {dtype} on {device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {want[name]}")


def check_layer_args(x, lens, pos_p, n_head, ksize, causal):
    """Raise unless the full-context layer kernels take these arguments:
    lens (B,) int32 on x's device, pos_p (T, D), d_k = D / n_head up to
    128, an odd conv kernel when not causal."""
    B, T, D = x.shape
    if tuple(pos_p.shape) != (T, D):
        raise ValueError(f"pos_p: shape {tuple(pos_p.shape)}, "
                         f"expected {(T, D)}")
    if lens.dtype != torch.int32 or lens.device != x.device or \
            tuple(lens.shape) != (B,) or not lens.is_contiguous():
        raise ValueError("lens must be (B,) contiguous int32 on the device "
                         "of x")
    if D % n_head or D // n_head > 128:
        raise ValueError(f"d_model {D} with {n_head} heads: the kernel "
                         "takes d_k = D / heads up to 128")
    if not causal and ksize % 2 == 0:
        raise ValueError("non-causal conv needs an odd kernel size")


def check_packed(x, lens, pos_p, packed, n_head, ksize, causal):
    """Raise unless the kernels take these arguments with packed, the
    serving pack (pack_layer_params) in full: the training-layer kernel
    reads every array of it. Its dtype rule is the serving kernels'
    (chunk_layer.py check_serving_dtypes): x, pos_p and the products'
    weights all f32 or all bf16, the LN and bias rows f32. → the dtype."""
    B, T, D = x.shape
    F_ = packed["ffw1"].shape[2]
    dtype = check_serving_dtypes({"x": x, "pos_p": pos_p}, packed)
    check_operands({"x": x, "pos_p": pos_p,
                    **{k: packed[k] for k in PACKED_KEYS}},
                   {"lnw": (6, 2, D), "ffw1": (2, D, F_), "ffb1": (2, F_),
                    "ffw2": (2, F_, D), "vecb": (8, D), "attw": (4, D, D),
                    "posb": (2, D), "pw1w": (D, 2 * D), "pw1b": (1, 2 * D),
                    "pw2w": (D, D), "dww": (ksize, D)}, x.device, None)
    check_layer_args(x, lens, pos_p, n_head, ksize, causal)
    return dtype


def fused_conformer_layer(x, lens, pos_p, packed, *, n_head, ksize, causal,
                          ff_scale=0.5, eps=1e-5):
    """The whole full-context layer (arguments as the plain version; packed
    may also hold the serving tensor-core pack, chunk_packed_params). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (its
    bf16 mode for bf16 operands) or raises. → (B, T, D) in x's dtype."""
    dtype = check_serving_dtypes({"x": x, "pos_p": pos_p}, packed)
    if x.device.type == "cpu":
        return fused_conformer_layer_plain(
            x, lens, pos_p, packed, n_head=n_head, ksize=ksize,
            causal=causal, ff_scale=ff_scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B, T, D = x.shape
    packed = with_chunk_tc(packed)
    F_ = packed["ffb1"].shape[1]
    check_operands({k: packed[k] for k in CHUNK_KEYS},
                   {"lnw": (6, 2, D), "ffb1": (2, F_), "vecb": (8, D),
                    "posb": (2, D), "pw1b": (1, 2 * D), "dww": (ksize, D)},
                   x.device)
    check_operands({"x": x, "pos_p": pos_p}, {}, x.device, None)
    check_chunk_tc(packed, D, F_, x.device, dtype)
    check_layer_args(x, lens, pos_p, n_head, ksize, causal)
    bf16 = dtype == torch.bfloat16
    fn = chunk_entry("conformer_layer", "masr_conformer_layer_forward"
                     + ("_bf16" if bf16 else ""),
                     3 + len(CHUNK_KEYS) + len(TC_KEYS), 7, 2)
    out = torch.empty_like(x)
    M = B * T
    err = launch_tc_kernel(
        fn, (x.data_ptr(), lens.data_ptr(), pos_p.data_ptr()),
        (B, T, D, F_, n_head, ksize, int(bool(causal)), float(ff_scale),
         float(eps)), packed, CHUNK_KEYS, full_plans(M, D, F_),
        M * ((3 if bf16 else 2) * D + max(F_, 4 * D)), out)
    if err != 0:
        raise RuntimeError(f"conformer_layer kernel failed: CUDA error {err}")
    fused_conformer_layer.launches += 1
    if dtype == torch.bfloat16:
        fused_conformer_layer.bf16_launches += 1
    return out


fused_conformer_layer.launches = 0
fused_conformer_layer.bf16_launches = 0   # the launches of its bf16 mode
